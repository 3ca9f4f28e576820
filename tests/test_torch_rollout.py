"""The port's blue-green rollout (veles_tpu_torch/rollout.py and its
seams in serving.py) on the CPU against the JAX package.

``routes_green`` is equal for 1000 tenant strings at every fraction (the
same crc32 hash point in both packages), the configuration's validation
texts are equal, and the rollback predicate's verdicts, states and
ledger-visible notes are equal on the scripted feeds of the JAX
package's tests/test_deploy.py:165-320 (explicit clocks, no history).
The detector-owned deploy rules fire into an isolated metric history
and the incident names the leading series.

The port-only end-to-end tests drive a toy GenerateAPI (embed 16, vocab
29, 2 slots) on the dense slab at ``int8-kv`` over HTTP: a clean rollout
promotes with every blue stream bit-equal to a run with no deploy and
every green stream equal to a decoder's on the new weights; a green
ramp rolls back with nothing shed and an incident led by
``veles_ctrl_deploy_ttft_ms``."""

import json
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy
import pytest
import torch

from veles_tpu import rollout as jroll
from veles_tpu.observe import history as jhistory
from veles_tpu_torch import rollout as troll
from veles_tpu_torch.core.config import root as troot
from veles_tpu_torch.observe import history as history_mod
from veles_tpu_torch.observe import servescope as servescope_mod
from veles_tpu_torch.observe.history import (IncidentRecorder,
                                             MetricHistory,
                                             load_incident,
                                             set_metric_history,
                                             stop_history_sampler)
from veles_tpu_torch.observe.reqledger import RequestLedger
from veles_tpu_torch.parallel import transformer_step as tts
from veles_tpu_torch.serving import ContinuousDecoder, GenerateAPI
from veles_tpu_torch.serving_chaos import (ServingChaosConfig,
                                           ServingChaosMonkey)

torch.set_num_threads(1)

HEADS, EMBED, VOCAB, BLOCKS = 4, 16, 29, 2
PACKAGES = {"jax": jroll, "torch": troll}
TENANTS = ["tenant-%d" % i for i in range(1000)]


@pytest.fixture(autouse=True)
def no_history(monkeypatch, tmp_path):
    """Both packages' process histories detached, so the predicate units
    neither read nor write ambient detector state; black boxes in tmp."""
    monkeypatch.setattr(history_mod, "_history", None)
    monkeypatch.setattr(history_mod, "_history_built", True)
    monkeypatch.setattr(jhistory, "_history", None)
    monkeypatch.setattr(jhistory, "_history_built", True)
    monkeypatch.setattr(troot.common.dirs, "run", str(tmp_path / "run"))
    yield
    stop_history_sampler()


def point(tenant):
    return (zlib.crc32(tenant.encode()) % 10000) / 10000.0


# -- routing and configuration -----------------------------------------------

@pytest.mark.parametrize("steps", [(0.1, 1.0), (0.01, 0.3, 0.6),
                                   (0.5,), (1.0,)])
def test_routes_green_matches_jax(steps):
    routes = {}
    for name, module in PACKAGES.items():
        rollout = module.BlueGreenRollout("v2", config=module.RolloutConfig(
            steps=steps))
        routes[name] = []
        for index in range(len(rollout.config.steps)):
            rollout.step_index = index
            routes[name].append([rollout.routes_green(t) for t in TENANTS])
        for state in ("promote_ready", "rolling_back"):
            rollout.state = state
            routes[name].append([rollout.routes_green(t) for t in TENANTS])
    assert routes["torch"] == routes["jax"]
    # the cut line is the tenant's hash point, and raising the fraction
    # only adds tenants
    first = routes["torch"][0]
    assert first == [point(t) < steps[0] for t in TENANTS]
    ladder = routes["torch"][:-2]
    for low, high in zip(ladder, ladder[1:]):
        assert all(h or not lo for lo, h in zip(low, high))
    assert all(routes["torch"][-2]) and not any(routes["torch"][-1])


def test_config_defaults_match_jax():
    assert vars(troll.RolloutConfig()) == vars(jroll.RolloutConfig())
    assert vars(troll.RolloutConfig(steps="0.2+0.5")) \
        == vars(jroll.RolloutConfig(steps="0.2+0.5"))
    assert troll.RolloutConfig.KEYS == jroll.RolloutConfig.KEYS
    assert (troll.BURN_SERIES, troll.TTFT_SERIES, troll.SWAP_SERIES) \
        == (jroll.BURN_SERIES, jroll.TTFT_SERIES, jroll.SWAP_SERIES)


@pytest.mark.parametrize("kwargs", [
    {"steps": ()}, {"steps": (0.0, 1.0)}, {"steps": (0.5, 0.2)},
    {"steps": (1.5,)}, {"hold_s": -1}, {"cooldown_s": -1},
    {"window_s": 0}, {"min_requests": 0}, {"burn_ratio": 0.5},
    {"ttft_ratio": 0.9}, {"burn_floor": 0}, {"ttft_floor_s": 0},
    {"blue_burn_veto": 0}, {"breach_for": 0}, {"interval_s": 0}])
def test_validation_texts_match_jax(kwargs):
    messages = {}
    for name, module in PACKAGES.items():
        with pytest.raises(ValueError) as err:
            module.RolloutConfig(flag="--rollout", **kwargs)
        messages[name] = str(err.value)
    assert messages["torch"] == messages["jax"]


def test_from_config_reads_root_common_serve_rollout(monkeypatch):
    node = troot.common.serve.rollout
    saved = node.__content__()
    try:
        node.update({"steps": "0.25+1.0", "hold_s": 3, "min_requests": 2})
        config = troll.RolloutConfig.from_config()
        assert config.steps == (0.25, 1.0)
        assert config.hold_s == 3.0 and config.min_requests == 2
    finally:
        troot.common.serve.update({"rollout": saved})
        for key in ("steps", "hold_s", "min_requests"):
            if key not in saved:
                delattr(node, key)


# -- the rollback predicate (tests/test_deploy.py:165-320) -------------------

class RecordingGovernor:
    def __init__(self):
        self.notes = []

    def note_deploy(self, action, api, reason="", **attrs):
        self.notes.append((action, reason, attrs))


class FakeApi:
    slo = None

    def __init__(self):
        self.governor = RecordingGovernor()


def _observe(rollout, api):
    return {"state": rollout.state, "step": rollout.step_index,
            "breaches": rollout._breaches,
            "suppressed": rollout.suppressed_total,
            "reason": rollout.reason, "fraction": rollout.fraction,
            "snapshot": rollout.snapshot(),
            "notes": list(api.governor.notes)}


def zero_green_traffic(module):
    rollout = module.BlueGreenRollout("v2", config=module.RolloutConfig(
        steps=(0.1, 1.0), hold_s=100.0, cooldown_s=100.0, window_s=60.0,
        min_requests=4, interval_s=0.01))
    api = FakeApi()
    rollout._breaches = 1
    for _ in range(10):
        rollout.note_resolved("blue", True, now=99.0)
    rollout.note_resolved("green", False, now=99.0)
    rollout.tick(api, now=100.0)
    return [_observe(rollout, api)]


def blue_baseline_burning(module):
    rollout = module.BlueGreenRollout("v2", config=module.RolloutConfig(
        steps=(0.1, 1.0), hold_s=100.0, cooldown_s=1.0, window_s=60.0,
        min_requests=2, burn_ratio=2.0, burn_floor=0.01,
        blue_burn_veto=5.0, breach_for=1, interval_s=0.01))
    api = FakeApi()
    for _ in range(10):
        rollout.note_resolved("green", False, now=100.0)
    for i in range(10):
        rollout.note_resolved("blue", i % 2 == 0, now=100.0)
    out = []
    for now in (100.5, 100.6, 102.0):
        rollout.tick(api, now=now)
        out.append(_observe(rollout, api))
    return out


def breach_streak(module):
    rollout = module.BlueGreenRollout("v2", config=module.RolloutConfig(
        steps=(0.1, 1.0), hold_s=100.0, cooldown_s=0.1, window_s=60.0,
        min_requests=2, burn_ratio=2.0, burn_floor=0.01,
        blue_burn_veto=1000.0, breach_for=2, interval_s=0.01))
    api = FakeApi()
    for _ in range(10):
        rollout.note_resolved("green", False, now=100.0)
        rollout.note_resolved("blue", True, now=100.0)
    out = []
    for now in (100.5, 100.6):
        rollout.tick(api, now=now)
        out.append(_observe(rollout, api))
    rollout.finish_rollback(api)
    out.append(_observe(rollout, api))
    return out


def ttft_breach(module):
    rollout = module.BlueGreenRollout("v2", config=module.RolloutConfig(
        steps=(0.1, 1.0), hold_s=100.0, cooldown_s=0.1, window_s=60.0,
        min_requests=2, ttft_ratio=1.5, breach_for=1, interval_s=0.01))
    api = FakeApi()
    for i in range(4):
        rollout.note_resolved("green", True, now=100.0)
        rollout.note_resolved("blue", True, now=100.0)
        rollout.note_ttft("green", 0.2 + 0.01 * i, now=100.0)
        rollout.note_ttft("blue", 0.05, now=100.0)
    rollout.tick(api, now=100.5)
    return [_observe(rollout, api)]


def dwell_hysteresis(module):
    rollout = module.BlueGreenRollout("v2", config=module.RolloutConfig(
        steps=(0.1, 0.5, 1.0), hold_s=10.0, cooldown_s=10.0,
        window_s=60.0, min_requests=2, interval_s=0.01))
    api = FakeApi()

    def feed(now):
        for _ in range(6):
            rollout.note_resolved("green", True, now=now)
            rollout.note_resolved("blue", True, now=now)
    out = []
    feed(100.0)
    for now in (100.0, 101.0, 104.0, 109.0):
        rollout.tick(api, now=now)
        out.append(_observe(rollout, api))
    feed(110.0)
    for now in (110.5, 111.0):
        rollout.tick(api, now=now)
        out.append(_observe(rollout, api))
    feed(121.0)
    for now in (121.0, 132.0):
        rollout.tick(api, now=now)
        out.append(_observe(rollout, api))
    rollout.finish_promote(api)
    out.append(_observe(rollout, api))
    return out


def abort_and_rate_limit(module):
    rollout = module.BlueGreenRollout("v2", config=module.RolloutConfig(
        interval_s=5.0))
    api = FakeApi()
    rollout.start(api)
    rollout.tick(api, now=1.0)
    rollout.tick(api, now=2.0)        # inside the interval: no pass
    out = [_observe(rollout, api)]
    rollout.abort("blue breaker tripped", api=api)
    rollout.tick(api, now=10.0)       # terminal: no pass
    out.append(_observe(rollout, api))
    return out


@pytest.mark.parametrize("scenario", [
    zero_green_traffic, blue_baseline_burning, breach_streak,
    ttft_breach, dwell_hysteresis, abort_and_rate_limit],
    ids=lambda f: f.__name__)
def test_predicate_matches_jax(scenario):
    ours, theirs = scenario(troll), scenario(jroll)
    # the start note's clock is the rollout's own
    for states in (ours, theirs):
        for state in states:
            state["snapshot"].pop("started_at", None)
    assert ours == theirs
    if scenario is breach_streak:
        assert [s["state"] for s in ours] == ["shifting", "rolling_back",
                                              "rolled_back"]
    if scenario is dwell_hysteresis:
        assert [s["step"] for s in ours] == [0, 0, 0, 0, 1, 1, 2, 2, 2]
        assert ours[-2]["state"] == "promote_ready"
        assert ours[-1]["state"] == "promoted"


def test_rollback_fires_the_detector_owned_rule(tmp_path):
    """With a history attached a ttft rollback records the control
    series, fires ``deploy_green_ttft`` and writes an incident led by
    ``veles_ctrl_deploy_ttft_ms``; the terminal state clears the
    rules."""
    history = MetricHistory(interval_s=30, incidents=IncidentRecorder(
        cooldown_s=0.0, directory=str(tmp_path)))
    set_metric_history(history)
    rollout = troll.BlueGreenRollout("v2", config=troll.RolloutConfig(
        steps=(0.1, 1.0), min_requests=2, ttft_ratio=1.5, breach_for=1,
        interval_s=0.01))
    api = FakeApi()
    for _ in range(4):
        rollout.note_resolved("green", True, now=100.0)
        rollout.note_resolved("blue", True, now=100.0)
        rollout.note_ttft("green", 0.3, now=100.0)
        rollout.note_ttft("blue", 0.05, now=100.0)
    rollout.tick(api, now=100.5)
    assert rollout.state == "rolling_back"
    rules = {rule.name: rule for rule in history.rules}
    assert rules["deploy_green_ttft"].fired_total == 1
    assert rules["deploy_green_ttft"].external
    assert history.get(troll.TTFT_SERIES, {"version": "green"}) \
        is not None
    (path,) = [p for p in tmp_path.iterdir()
               if "deploy_green_ttft" in p.name]
    doc = load_incident(str(path))
    assert doc["leading_indicator"]["series"] == troll.TTFT_SERIES
    rollout.finish_rollback(api)
    assert rules["deploy_green_ttft"].breach_since is None


def test_swap_failure_books_the_probe_rule(tmp_path):
    history = MetricHistory(interval_s=30, incidents=IncidentRecorder(
        cooldown_s=0.0, directory=str(tmp_path)))
    set_metric_history(history)
    path = troll.note_swap_failure("non-finite weights", version="v9",
                                   now=5.0)
    assert path is not None
    doc = load_incident(path)
    assert doc["leading_indicator"]["series"] == troll.SWAP_SERIES
    set_metric_history(None)
    assert troll.note_swap_failure("again") is None


# -- the port's front, end to end --------------------------------------------

@pytest.fixture(scope="module")
def model():
    rng = numpy.random.RandomState(0)
    params = tts.init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                         device="cpu")
    table = torch.from_numpy(rng.randn(VOCAB, EMBED).astype(
        numpy.float32) * 0.3)
    params2 = tts.init_transformer_params(numpy.random.RandomState(7),
                                          BLOCKS, EMBED, HEADS, VOCAB,
                                          device="cpu")
    return params, table, params2


GREEN = next(t for t in TENANTS if point(t) < 0.3)
BLUE = next(t for t in TENANTS if point(t) >= 0.3)
ARGS = dict(slots=2, max_len=64, n_tokens=5, quantize="int8-kv")


def _api(model, **kw):
    params, table, _ = model
    return GenerateAPI(params, table, HEADS, chunk=2, ledger=RequestLedger(),
                       device="cpu", **dict(ARGS, **kw))


def _stream(params, table, prompt):
    decoder = ContinuousDecoder(params, table, HEADS, device="cpu", **ARGS)
    rid = decoder.submit(prompt)
    decoder.run_until_drained(chunk=2)
    return decoder.results[rid]


def post(url, tokens, tenant):
    req = urllib.request.Request(url, data=json.dumps(
        {"tokens": tokens}).encode(), headers={"X-Veles-Tenant": tenant})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())["tokens"]
    except urllib.error.HTTPError as err:
        return err.code, None


CONFIG = dict(steps=(0.3, 1.0), hold_s=0.3, cooldown_s=0.3, window_s=5.0,
              min_requests=2, interval_s=0.05)


def test_clean_rollout_promotes(model):
    params, table, params2 = model
    blue_want = _stream(params, table, [1, 2, 3])
    green_want = _stream(params2, table, [4, 5])
    api = _api(model).start()
    url = "http://127.0.0.1:%d/generate" % api.port
    codes, blue, green = [], [], []
    try:
        # a ratio no CPU hiccup reaches: the clean green must promote
        rollout = api.begin_rollout(params2, version="v2", config=(
            troll.RolloutConfig(ttft_ratio=10.0, **CONFIG)))
        health = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/healthz" % api.port).read())
        assert health["rollout"]["state"] == "shifting"
        assert api.request_swap(params2)["error"].startswith("refused")
        deadline = time.monotonic() + 30
        while rollout.state != "promoted" and time.monotonic() < deadline:
            routed_blue = not rollout.routes_green(BLUE)
            code, tokens = post(url, [1, 2, 3], BLUE)
            codes.append(code)
            if routed_blue and not rollout.routes_green(BLUE):
                blue.append(tokens)
            code, tokens = post(url, [4, 5], GREEN)
            codes.append(code)
            green.append(tokens)
        assert rollout.state == "promoted"
        assert api.version == "v2" and api.decoder.rollout_role is None
        code, tokens = post(url, [4, 5], BLUE)
        assert code == 200 and tokens == green_want
        assert "rollout" in json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/healthz" % api.port).read())
    finally:
        api.stop()
    assert set(codes) == {200}
    assert blue and all(tokens == blue_want for tokens in blue)
    assert green and all(tokens == green_want for tokens in green)
    assert api.health.counter("promotes") == 1
    assert api._param_stash[0] is params


def test_green_ramp_rolls_back_naming_the_ttft_series(model, tmp_path,
                                                      monkeypatch):
    params, table, params2 = model
    history = MetricHistory(interval_s=30, incidents=IncidentRecorder(
        cooldown_s=0.0, directory=str(tmp_path)))
    set_metric_history(history)
    # the waste autopsy's own rules must not lead the incident
    monkeypatch.setattr(servescope_mod, "MIN_EVAL_TOKENS", 1 << 62)
    monkey = ServingChaosMonkey(ServingChaosConfig(
        deploy_green_ramp_ms=300.0, deploy_green_ramp_steps=2))
    api = _api(model, chaos=monkey).start()
    url = "http://127.0.0.1:%d/generate" % api.port
    blue_want = _stream(params, table, [1, 2, 3])
    codes = []
    try:
        rollout = api.begin_rollout(params2, version="bad", config=(
            troll.RolloutConfig(ttft_ratio=1.5, **CONFIG)))
        deadline = time.monotonic() + 30
        # one at a time: blue's requests alone, green's two stalled
        # passes each
        while rollout.state != "rolled_back" \
                and time.monotonic() < deadline:
            codes.append(post(url, [1, 2, 3], BLUE))
            codes.append(post(url, [4, 5], GREEN))
        assert rollout.state == "rolled_back"
        code, tokens = post(url, [1, 2, 3], GREEN)
        assert code == 200 and tokens == blue_want
    finally:
        api.stop()
    assert all(code == 200 for code, _ in codes)
    assert api.health.counter("shed") == 0
    assert api.health.counter("rollbacks") == 1
    assert monkey.counters["green_ramp_stalls"] >= 1
    assert "ttft" in rollout.reason
    incidents = [p for p in tmp_path.iterdir()
                 if "deploy_green_ttft" in p.name]
    assert incidents
    doc = load_incident(str(incidents[0]))
    assert doc["leading_indicator"]["series"] \
        == "veles_ctrl_deploy_ttft_ms"


def test_a_poisoned_green_is_refused(model):
    params, table, params2 = model
    bad = dict(params2)
    bad["head"] = torch.full_like(params2["head"], float("nan"))
    api = _api(model).start()
    try:
        with pytest.raises(RuntimeError, match="non-finite"):
            api.begin_rollout(bad, version="nan")
        assert api._green is None and api._rollout is None
        assert api.health.counter("rollout_failures") == 1
        url = "http://127.0.0.1:%d/generate" % api.port
        assert post(url, [1, 2, 3], GREEN) == (
            200, _stream(params, table, [1, 2, 3]))
    finally:
        api.stop()


def test_a_blue_trip_aborts_the_rollout(model):
    params, table, params2 = model
    api = _api(model, rebuild_backoff=0.01).start()
    try:
        rollout = api.begin_rollout(params2, version="v2",
                                    config=troll.RolloutConfig(**CONFIG))
        api.request_trip("drill")
        deadline = time.monotonic() + 20
        while api.health.counter("rebuilds") < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert rollout.state == "rolled_back"
        assert "breaker" in rollout.reason
        assert api._green is None
        assert api.health.counter("rollout_aborts") == 1
    finally:
        api.stop()
