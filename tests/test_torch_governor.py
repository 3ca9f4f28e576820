"""The port's serving governor (veles_tpu_torch/observe/governor.py and
its seams in serving.py) on the CPU against the JAX package.

The control law runs in both packages on stub fronts with an injected
clock and the same burn and pool sequences (the JAX package's
tests/test_governor.py idiom): transitions (action, tier, level, burn,
reason, decision instant), counters, the admission limit, the Retry-After
price, snapshots, the ``veles_governor_*`` exposition and the autopsy's
actuation lines must be equal, and so must every config validation
text. The wall-clock ``t`` of a transition is left out: it is the only
field that is not a function of the inputs.

The port-only end-to-end tests drive a toy GenerateAPI (embed 16, vocab
29, 2 slots, paged) over HTTP: a held latency ramp demotes to int8 and
clearing it promotes back, with transitions pinned to [demote, promote],
no 5xx, and every greedy stream equal to a fixed-tier decoder's at the
tier that admitted it; a pool flood halves the admission limit with a
priced Retry-After; a compile storm trips the breaker and the front
heals with the same stream; a swap whose probe fails keeps the old
decoder serving. Cooldowns are fractions of a second."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu.observe import governor as jgov
from veles_tpu.observe.metrics import MetricsRegistry as JaxRegistry
from veles_tpu_torch.core.config import root as troot
from veles_tpu_torch.observe import governor as tgov
from veles_tpu_torch.observe import history as history_mod
from veles_tpu_torch.observe.history import (MetricHistory,
                                             stop_history_sampler)
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.observe.reqledger import RequestLedger
from veles_tpu_torch.observe.slo import SLOEngine
from veles_tpu_torch.observe.xla_stats import get_compile_tracker
from veles_tpu_torch.parallel import transformer_step as tts
from veles_tpu_torch.serving import (ContinuousDecoder, GenerateAPI,
                                     ServingHealth)
from veles_tpu_torch.serving_chaos import (ServingChaosConfig,
                                           ServingChaosMonkey)

torch.set_num_threads(1)

HEADS, EMBED, VOCAB, BLOCKS = 4, 16, 29, 2
PACKAGES = {"jax": jgov, "torch": tgov}


@pytest.fixture(autouse=True)
def quiet_planes(monkeypatch, tmp_path):
    """A lazily sampling process history, black boxes and incidents in
    tmp, and no sampler left behind."""
    monkeypatch.setattr(history_mod, "_history",
                        MetricHistory(interval_s=30))
    monkeypatch.setattr(history_mod, "_history_built", True)
    monkeypatch.setattr(troot.common.dirs, "run", str(tmp_path / "run"))
    yield
    stop_history_sampler()


# -- stubs of the control-law tests (tests/test_governor.py:95-130) ---------

class StubSLO:
    def __init__(self, burns):
        self.burns = list(burns)

    def summary(self):
        burn = self.burns.pop(0) if self.burns else 0.0
        if burn is None:
            return None
        return {"burn_rate": burn, "objective": "ttft_p95_ms",
                "window": "2s"}


class VersionedSLO(StubSLO):
    """The surface burn from the green-ramp profile, the per-version
    slices telling the attribution story."""

    def __init__(self, burns, green_burns, blue_burns):
        super().__init__(burns)
        self.green = list(green_burns)
        self.blue = list(blue_burns)

    def version_burn(self, version, now=None):
        series = self.green if version == "green" else self.blue
        burn = series.pop(0) if series else 0.0
        if burn is None:
            return None
        return {"version": version, "burn_rate": burn}


class StubDecoder:
    def __init__(self, pool=None, quantize=None):
        self.pool = pool
        self.quantize = quantize
        self.aot = None


class StubApi:
    def __init__(self, burns, pool=None, max_queue=64):
        self.slo = StubSLO(burns)
        self.decoder = StubDecoder(pool=pool)
        self.max_queue = max_queue
        self._base_tier = "bf16"
        self.tier_requests = []
        self.trip_requests = []

    def request_tier(self, tier):
        self.tier_requests.append(tier)
        # the driver's swap, so reconciliation settles
        self.decoder.quantize = None if tier == "bf16" else tier

    def request_trip(self, reason):
        self.trip_requests.append(reason)


class ShiftingRollout:
    state = "shifting"


class PromotedRollout:
    state = "promoted"


class PressuredPool:
    def __init__(self, used=10, reserved=95, price=30.0):
        self.used, self.reserved, self.price = used, reserved, price
        self.needs = []

    def snapshot(self):
        return {"pages_total": 100, "pages_used": self.used,
                "reserved_pages": self.reserved}

    def retry_after(self, need, fallback=1.0):
        self.needs.append(need)
        return self.price


def _strip(transitions):
    return [{k: v for k, v in t.items() if k != "t"} for t in transitions]


def _state(governor, api):
    snap = governor.snapshot()
    snap["transitions"] = _strip(snap["transitions"])
    return {"transitions": _strip(governor.transitions),
            "counters": dict(governor.counters),
            "level": governor.level, "tier": governor.tier_name(),
            "admit_limit": governor.admit_limit,
            "effective_limit": governor.effective_limit,
            "retry_price": governor.retry_price,
            "last_burn": governor.last_burn, "snapshot": snap,
            "tier_requests": list(api.tier_requests),
            "trips": list(api.trip_requests),
            "quantize": api.decoder.quantize}


def _run(module, burns, seconds=None, step=1.0, api_kw=None, **config):
    """One governor fed ``burns`` on a stub front, ticked once a
    ``step`` on an injected clock; returns its observable state."""
    kw = dict(demote_burn=2.0, recover_burn=1.0, cooldown_s=10.0,
              interval_s=1.0, ladder=("int8",), prewarm=False,
              breaker_guard=False)
    kw.update(config)
    governor = module.ServingGovernor(module.GovernorConfig(**kw),
                                      clock=lambda: 0.0)
    api = StubApi(burns, **(api_kw or {}))
    for i in range(seconds if seconds is not None else len(burns)):
        governor.tick(api, now=i * step)
    return governor, api


def _both(fn):
    out = {name: fn(module) for name, module in PACKAGES.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


# -- configuration -----------------------------------------------------------

def test_spec_parsing_matches_jax():
    spec = ("demote_burn=3,recover_burn=0.5,cooldown_s=5,"
            "ladder=int8+int8-kv,min_admit=4,prewarm=0,deploy_aware=off,"
            "headroom_guard_s=12,guard_memory_frac=0.9")

    def parse(module):
        config = module.parse_governor_spec(spec, flag="--serve-governor")
        return vars(config)
    got = _both(parse)
    assert got["ladder"] == ("int8", "int8-kv") and got["prewarm"] is False
    for module in PACKAGES.values():
        assert module.parse_governor_spec(None) is None
        assert module.parse_governor_spec("") is None
        assert module.parse_governor_spec("enabled=0,demote_burn=3") \
            is None
        assert module.parse_governor_spec({}) is None
    assert tgov.GovernorConfig.KEYS == jgov.GovernorConfig.KEYS
    assert tgov.TIER_RANK == jgov.TIER_RANK


@pytest.mark.parametrize("bad", [
    "demote_burn", "nope=1", "demote_burn=x",
    "recover_burn=5,demote_burn=2", "cooldown_s=0", "interval_s=-1",
    "ladder=bf16", "ladder=int8-kv+int8", "admit_factor=1.5",
    "min_admit=0", "min_admit=x", "prewarm=maybe", "pool_high=0",
    "guard_memory_frac=2", "headroom_guard_s=-1", "prewarm_hot=0",
    "breaker_guard=2", "deploy_aware=perhaps"])
def test_validation_texts_match_jax(bad):
    messages = {}
    for name, module in PACKAGES.items():
        with pytest.raises(ValueError) as err:
            module.parse_governor_spec(bad, flag="--serve-governor")
        messages[name] = str(err.value)
    assert messages["torch"] == messages["jax"]
    assert "--serve-governor" in messages["torch"]


def test_disabled_spec_refused_by_the_constructor():
    for module in PACKAGES.values():
        with pytest.raises(ValueError, match="DISABLED"):
            module.ServingGovernor("enabled=0")


def test_from_config_reads_root_common_serve_governor(monkeypatch):
    assert tgov.ServingGovernor.from_config() is None
    monkeypatch.setattr(troot.common.serve, "governor",
                        "demote_burn=4,cooldown_s=2", raising=False)
    governor = tgov.ServingGovernor.from_config()
    assert governor.config.demote_burn == 4.0
    assert governor.config.cooldown_s == 2.0
    troot.common.serve.governor = "enabled=0"
    assert tgov.ServingGovernor.from_config() is None


def test_base_tier_drops_unreachable_rungs():
    def run(module):
        governor = module.ServingGovernor(module.GovernorConfig(
            ladder=("int8", "int8-kv")))
        governor.set_base_tier("int8")
        ladder, base = governor._ladder, governor.tier_name()
        governor.level = 1
        return ladder, base, governor.tier_name()
    assert _both(run) == (("int8-kv",), "int8", "int8-kv")


# -- the control law ---------------------------------------------------------

FLAP = [5.0, 0.2] * 11


@pytest.mark.parametrize("burns,config", [
    (FLAP, {}),                                          # one per window
    ([5.0] + [1.5] * 20, {"cooldown_s": 2.0}),           # the band holds
    ([9.0] * 12 + [0.0] * 12, {"cooldown_s": 2.0,
                               "ladder": ("int8", "int8-kv")}),
    ([None, 5.0, None, None, 0.1, 0.1, 0.1], {"cooldown_s": 1.0}),
    ([3.0, 3.0, 3.0], {"ladder": ()}),                   # no rungs
], ids=["flap", "band", "ladder", "empty_windows", "no_ladder"])
def test_hysteresis_matches_jax(burns, config):
    state = _both(lambda module: _state(*_run(module, burns, **config)))
    moves = [t for t in state["transitions"]
             if t["action"] in ("demote", "promote")]
    cooldown = config.get("cooldown_s", 10.0)
    for a, b in zip(moves, moves[1:]):
        assert b["mono"] - a["mono"] >= cooldown


def test_no_slo_engine_means_no_transitions():
    def run(module):
        governor, api = _run(module, [], seconds=0)
        api.slo = None
        for second in range(5):
            governor.tick(api, now=float(second))
        return _state(governor, api)
    state = _both(run)
    assert state["counters"]["demotions"] == 0
    assert state["last_burn"] is None


def test_interval_rate_limits_the_tick():
    def run(module):
        governor, api = _run(module, [5.0] * 10, seconds=10, step=0.3)
        return governor.counters["ticks"]
    assert _both(run) == 3


@pytest.mark.parametrize("green,blue,rollout,aware", [
    ([2.5, 3.5, 4.5, 5.5, 6.0], [0.2] * 5, ShiftingRollout, True),
    ([5.0] * 5, [4.0] * 5, ShiftingRollout, True),
    ([5.0] * 5, [0.2] * 5, None, True),
    ([5.0] * 5, [0.2] * 5, PromotedRollout, True),
    ([5.0] * 5, [0.2] * 5, ShiftingRollout, False),
    ([None] * 5, [0.2] * 5, ShiftingRollout, True),
    ([5.0] * 5, [None] * 5, ShiftingRollout, True),
], ids=["green_ramp", "ambient", "no_rollout", "promoted", "knob_off",
        "no_green_slice", "no_blue_slice"])
def test_deploy_aware_suppression_matches_jax(green, blue, rollout,
                                              aware):
    """tests/test_governor.py:242-323: a demotion whose burn is the
    ramping green slice's is suppressed (ledger-visible, cooldown
    limited); ambient burn, no rollout, a terminal rollout or the knob
    off demote as usual."""
    def run(module):
        governor = module.ServingGovernor(module.GovernorConfig(
            demote_burn=2.0, recover_burn=1.0, cooldown_s=1.0,
            interval_s=1.0, prewarm=False, breaker_guard=False,
            deploy_aware=aware), clock=lambda: 0.0)
        api = StubApi([])
        api.slo = VersionedSLO([5.0] * len(green), green, blue)
        api._rollout = rollout() if rollout is not None else None
        for second in range(len(green)):
            governor.tick(api, now=float(second))
        return _state(governor, api)
    state = _both(run)
    if rollout is ShiftingRollout and aware and green[0] == 2.5:
        assert state["counters"]["demotions"] == 0
        assert state["counters"]["demotes_suppressed_deploy"] >= 1
        assert any("deploy-attributable" in t["reason"]
                   for t in state["transitions"])


def test_pool_overhang_pricing_matches_jax():
    def run(module):
        pool = PressuredPool(used=90, reserved=20, price=37.0)
        governor, api = _run(module, [0.0], api_kw={"pool": pool,
                                                    "max_queue": 8},
                             pool_high=0.5)
        return _state(governor, api), pool.needs
    state, needs = _both(run)
    assert needs == [40] and state["retry_price"] == 37.0


def test_admission_resize_matches_jax():
    """Demotion and pool pressure shrink the limit, recovery restores
    it; every resize is an actuation."""
    def run(module):
        governor = module.ServingGovernor(module.GovernorConfig(
            demote_burn=2.0, recover_burn=1.0, cooldown_s=1.0,
            interval_s=0.5, min_admit=2, admit_factor=0.5,
            pool_high=0.85, prewarm=False, breaker_guard=False),
            clock=lambda: 0.0)
        api = StubApi([5.0, 5.0, 0.0, 0.0], max_queue=64)
        limits = []
        governor.tick(api, now=0.0)
        limits.append(governor.effective_limit)
        api.decoder.pool = PressuredPool()
        governor.tick(api, now=1.0)
        limits.append(governor.effective_limit)
        api.decoder.pool = None
        governor.tick(api, now=2.0)
        governor.tick(api, now=3.0)
        limits.append(governor.effective_limit)
        return limits, _state(governor, api)
    limits, state = _both(run)
    assert limits == [32, 16, 64]
    assert state["admit_limit"] is None


@pytest.mark.parametrize("max_queue", [0, -1])
def test_disabled_bound_stays_disabled(max_queue):
    state = _both(lambda module: _state(*_run(
        module, [9.0], api_kw={"max_queue": max_queue})))
    assert state["admit_limit"] is None and state["effective_limit"] is None


def test_retry_price_while_demoted_without_a_pool():
    state = _both(lambda module: _state(*_run(module, [5.0, 5.0],
                                              cooldown_s=7.0)))
    assert state["retry_price"] == 3.5


def test_breaker_guard_on_a_storm_matches_jax():
    """A storm past the baseline trips once a cooldown; the reason names
    the counts."""
    class Tracker:
        enabled = True

        def __init__(self, totals):
            self.totals = list(totals)

        def storm_total(self):
            return self.totals.pop(0)

    def run(module, monkeypatch_target):
        tracker = Tracker([0, 0, 2, 2, 3, 3])
        governor = module.ServingGovernor(module.GovernorConfig(
            cooldown_s=1.5, interval_s=1.0, prewarm=False,
            breaker_guard=True, guard_memory_frac=1.0),
            clock=lambda: 0.0)
        governor._device_memory_frac = lambda: None
        api = StubApi([0.0] * 6)
        with _patched(monkeypatch_target, tracker):
            for second in range(6):
                governor.tick(api, now=float(second))
        return _state(governor, api)

    from veles_tpu.observe import xla_stats as jstats
    from veles_tpu_torch.observe import xla_stats as tstats
    got = {name: run(module, target) for (name, module), target in zip(
        PACKAGES.items(), (jstats, tstats))}
    assert got["torch"] == got["jax"]
    assert got["torch"]["counters"]["guard_trips"] == 2
    assert "recompile storm (2 total, was 0)" in got["torch"]["trips"][0]


class _patched:
    def __init__(self, module, tracker):
        self.module, self.tracker = module, tracker

    def __enter__(self):
        self.real = self.module.get_compile_tracker
        self.module.get_compile_tracker = lambda: self.tracker

    def __exit__(self, *exc):
        self.module.get_compile_tracker = self.real


def test_memory_guard_trips_on_the_device_fraction():
    def run(module):
        governor = module.ServingGovernor(module.GovernorConfig(
            cooldown_s=5.0, prewarm=False, breaker_guard=True,
            guard_memory_frac=0.5), clock=lambda: 0.0)
        governor._device_memory_frac = lambda: 0.75
        api = StubApi([0.0, 0.0])
        for second in range(2):
            governor.tick(api, now=float(second))
        return _state(governor, api)
    state = _both(run)
    assert state["trips"] == ["governor breaker guard: device memory "
                              "75.0% of limit"]


def test_device_memory_frac_on_the_cpu_falls_back_to_memscope():
    """Without a card the sampler reports no limit; the fraction is
    memscope's (None without a budget)."""
    from veles_tpu_torch.observe.memscope import get_memscope

    assert tgov.ServingGovernor._device_memory_frac() \
        == get_memscope().device_fraction()


def test_storm_total_sums_every_source():
    from veles_tpu_torch.observe.xla_stats import CompileTracker

    tracker = CompileTracker(enabled=True)
    assert tracker.storm_total() == 0
    for name in ("a", "b"):
        for _ in range(tracker.STORM_THRESHOLD):
            tracker.record_compile(name, 0.001)
    for _ in range(tracker.STORM_THRESHOLD):
        tracker.record_compile("a", 0.001)
    assert tracker.storm_total() == 3
    assert tracker.snapshot()["storms"] == {"a": 2, "b": 1}


def test_prewarm_trend_and_decay_match_jax():
    """The port has no AOT bundle, so its decoders' ``aot`` is None and
    nothing is built; with a bundle stub both packages warm a hot bucket
    once, and the counts halve once a cooldown."""
    def run(module):
        governor = module.ServingGovernor(module.GovernorConfig(
            prewarm=True, prewarm_hot=3, breaker_guard=False,
            cooldown_s=2.0), clock=lambda: 0.0)
        warmed = []

        class Programs:
            def prewarm_bucket(self, bucket):
                warmed.append(bucket)

        api = StubApi([0.0] * 8)
        governor.observe_bucket(16)
        governor.tick(api, now=0.0)
        api.decoder.aot = Programs()
        for _ in range(3):
            governor.observe_bucket(16)
        governor.observe_bucket(32)
        governor.tick(api, now=1.0)
        governor.drain_prewarm()
        counts = dict(governor._bucket_counts)
        governor.tick(api, now=3.0)
        governor.drain_prewarm()
        return warmed, counts, dict(governor._bucket_counts), \
            _state(governor, api)
    warmed, before, after, state = _both(run)
    assert warmed == [16] and before == {16: 4, 32: 1}
    assert after == {16: 2} and state["counters"]["prewarms"] == 1


def test_prewarm_with_real_bundles_matches_jax(tmp_path):
    """The prewarm actuator on real CPU bundles (the port's from
    ``veles_tpu_torch.aot``, JAX's from ``veles_tpu.aot``): the same
    trend, counters and snapshot as JAX's, and the hot bucket's
    admission rows readied in each, no other bucket's."""
    import jax.numpy as jnp

    from veles_tpu.aot.artifact import build_serving_bundle as jbuild
    from veles_tpu.aot.loader import load_bundle as jload
    from veles_tpu.parallel.transformer_step import \
        init_transformer_params as jinit
    from veles_tpu_torch.aot.artifact import build_serving_bundle
    from veles_tpu_torch.aot.loader import load_bundle
    from veles_tpu_torch.convert import params_from_jax

    kw = dict(slots=2, max_len=32, n_tokens=4, tile=16)
    jparams = jinit(numpy.random.RandomState(0), 1, EMBED, HEADS, VOCAB)
    table = numpy.random.RandomState(1).randn(VOCAB, EMBED).astype(
        numpy.float32)
    jbuild(jparams, jnp.asarray(table), HEADS, str(tmp_path / "j.tar"),
           chunk=2, **kw)
    build_serving_bundle(params_from_jax(jparams, device="cpu"),
                         torch.from_numpy(table), HEADS,
                         str(tmp_path / "t.tar"), chunk=2, device="cpu",
                         **kw)
    bundles = {"jax": jload(str(tmp_path / "j.tar"), prefetch=False),
               "torch": load_bundle(str(tmp_path / "t.tar"),
                                    prefetch=False, device="cpu")}

    def run(module, programs):
        governor = module.ServingGovernor(module.GovernorConfig(
            prewarm=True, prewarm_hot=3, breaker_guard=False,
            cooldown_s=2.0), clock=lambda: 0.0)
        api = StubApi([0.0] * 8)
        governor.observe_bucket(16)
        governor.tick(api, now=0.0)
        api.decoder.aot = programs
        for _ in range(3):
            governor.observe_bucket(16)
        governor.observe_bucket(32)
        governor.tick(api, now=1.0)
        governor.drain_prewarm()
        counts = dict(governor._bucket_counts)
        governor.tick(api, now=3.0)
        governor.drain_prewarm()
        return counts, dict(governor._bucket_counts), _state(governor,
                                                             api)
    out = {name: run(module, bundles[name])
           for name, module in PACKAGES.items()}
    assert out["torch"] == out["jax"]
    before, after, state = out["torch"]
    assert before == {16: 4, 32: 1} and after == {16: 2}
    assert state["counters"]["prewarms"] == 1
    ours = bundles["torch"].stats()
    assert ours["compiled"] == 1
    assert bundles["torch"].program("decode.admit", ("admit", 16))
    theirs = bundles["jax"]._entries
    assert all((entry.compiled is not None) == (key[0] == "decode.admit"
                                                and key[1][1] == 16)
               for key, entry in theirs.items())


def test_port_decoders_carry_no_aot_bundle():
    params = tts.init_transformer_params(numpy.random.RandomState(0),
                                         BLOCKS, EMBED, HEADS, VOCAB,
                                         device="cpu")
    table = torch.zeros(VOCAB, EMBED)
    decoder = ContinuousDecoder(params, table, HEADS, slots=2,
                                max_len=32, device="cpu")
    assert decoder.aot is None and decoder.rollout_role is None


# -- visibility --------------------------------------------------------------

def test_metrics_families_match_jax():
    def run(module, registry):
        governor, _ = _run(module, [5.0, 5.0], pool_high=0.5,
                           api_kw={"pool": PressuredPool(used=80,
                                                         reserved=0)})
        module.publish_governor(registry, governor)
        return sorted(line for line in registry.expose().splitlines()
                      if line.startswith("veles_governor"))
    ours = run(tgov, MetricsRegistry(enabled=True))
    theirs = run(jgov, JaxRegistry(enabled=True))
    assert ours == theirs
    text = "\n".join(ours)
    assert "veles_governor_tier_level 1" in text
    assert 'veles_governor_actuations_total{action="demotions"} 1' in text
    assert "veles_governor_admit_limit" in text


def test_format_transitions_match_jax():
    entries = [{"action": "guard_trip", "tier": "bf16", "burn": None,
                "reason": "recompile storm (2 total, was 1)"},
               {"action": "demote", "tier": "int8", "burn": 12.0,
                "reason": "burn 12 >= 2"},
               {"action": "promote", "tier": "bf16", "burn": 0.4}, {}]
    assert tgov.format_governor_transitions(entries) \
        == jgov.format_governor_transitions(entries)


def test_health_consults_governor_then_pool():
    health = ServingHealth()
    assert health.retry_after_s() == 1.0

    class Pool:
        def retry_after(self, need, fallback=1.0):
            return 42.0

        def snapshot(self):
            return {}

    pool = Pool()
    health.attach_pool(pool)
    assert health.retry_after_s() == 42.0
    governor = tgov.ServingGovernor(tgov.GovernorConfig())
    governor.retry_price = 9.0
    health.attach_governor(governor)
    assert health.retry_after_s() == 9.0
    assert health.snapshot()["governor"]["retry_after_s"] == 9.0


def test_autopsy_cli_replays_governor_actuations(tmp_path, capsys):
    from veles_tpu_torch.observe.flight import FlightRecorder
    from veles_tpu_torch.observe.slo import slo_main

    recorder = FlightRecorder()
    recorder.note("governor", action="demote", tier="int8", burn=12.0,
                  reason="burn 12 >= 2")
    recorder.note("governor", action="promote", tier="bf16", burn=0.4,
                  reason="burn 0.4 <= 1")
    path = str(tmp_path / "box.json")
    recorder.dump("test", path=path)
    doc = json.loads(open(path).read())
    doc["requests"] = {"slowest": [], "inflight": []}
    with open(path, "w") as fout:
        json.dump(doc, fout)
    assert slo_main(path) == 0
    out = capsys.readouterr().out
    assert "governor actuations:" in out
    assert "tier=int8" in out and "burn=12" in out and "tier=bf16" in out


# -- the port's front, end to end --------------------------------------------

@pytest.fixture(scope="module")
def model():
    rng = numpy.random.RandomState(0)
    params = tts.init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                         device="cpu")
    table = torch.from_numpy(rng.randn(VOCAB, EMBED).astype(
        numpy.float32) * 0.3)
    return params, table


def _api(model, **kw):
    params, table = model
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("n_tokens", 5)
    kw.setdefault("chunk", 2)
    kw.setdefault("rebuild_backoff", 0.02)
    kw.setdefault("ledger", RequestLedger())
    return GenerateAPI(params, table, HEADS, device="cpu", **kw)


def post(url, tokens, trace=None):
    headers = {"X-Veles-Trace": trace} if trace else {}
    req = urllib.request.Request(url, data=json.dumps(
        {"tokens": tokens}).encode(), headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as err:
        return err.code, {}, dict(err.headers)


def wait_until(predicate, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _fixed_tier_stream(model, tier, prompt, **kw):
    params, table = model
    decoder = ContinuousDecoder(
        params, table, HEADS, slots=2, max_len=64, n_tokens=5,
        quantize=None if tier == "bf16" else tier, device="cpu", **kw)
    rid = decoder.submit(prompt)
    decoder.run_until_drained(chunk=2)
    return decoder.results[rid]


def test_latency_ramp_demotes_and_recovers(model):
    """The held ramp burns the ttft objective: the governor demotes to
    int8 (the swap drains first), holds while the ramp holds, and
    promotes once it clears; every request answered 200, every ledger
    row's quant names the tier that served it (demoted rows with their
    stage), and every stream equals a fixed-tier decoder's."""
    # a ttft objective far above a loaded CPU's toy request and far below
    # two stalled passes
    engine = SLOEngine({"ttft_p95_ms": 400.0}, windows=(0.5, 2.0),
                       bucket_seconds=0.1)
    governor = tgov.ServingGovernor(tgov.GovernorConfig(
        demote_burn=2.0, recover_burn=1.0, cooldown_s=0.6,
        interval_s=0.02, ladder=("int8",), breaker_guard=False,
        prewarm=False))
    monkey = ServingChaosMonkey(ServingChaosConfig(
        latency_ramp_ms=500.0, latency_ramp_steps=2,
        latency_ramp_hold=1 << 30))
    ledger = RequestLedger()
    api = _api(model, paged=True, page_size=8, slo=engine,
               governor=governor, chaos=monkey, ledger=ledger).start()
    url = "http://127.0.0.1:%d/generate" % api.port
    prompt = [1, 2, 3]
    answers, codes = {}, []

    def send():
        trace = "%016x" % (len(codes) + 1)
        code, body, _ = post(url, prompt, trace + "/" + "c" * 16)
        codes.append(code)
        if code == 200:
            answers[trace] = body["tokens"]
    try:
        assert wait_until(lambda: (send(), governor.demoted)[1], 30)
        assert wait_until(lambda: (send(), api.decoder.quantize
                                   == "int8")[1], 30)
        send()
        assert governor.counters["demotions"] == 1
        health = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/healthz" % api.port).read())
        assert health["governor"]["tier"] == "int8"
        monkey.clear_ramp()
        assert wait_until(lambda: (send(), not governor.demoted
                                   and api.decoder.quantize is None)[1],
                          30, interval=0.05)
        send()
        metrics = urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics" % api.port).read().decode()
    finally:
        api.stop()
    moves = [t["action"] for t in governor.transitions
             if t["action"] in ("demote", "promote")]
    assert moves == ["demote", "promote"]
    assert set(codes) == {200}
    assert api.health.counter("tier_swaps") == 2
    assert [swap["tier"] for swap in api.tier_swaps] == ["int8", "bf16"]
    assert 'veles_governor_actuations_total{action="demotions"} 1' \
        in metrics
    rows = {row["trace"]: row for row in ledger.slowest(512)}
    want = {tier: _fixed_tier_stream(model, tier, prompt, paged=True,
                                     page_size=8)
            for tier in ("bf16", "int8")}
    tiers = set()
    for trace, tokens in answers.items():
        row = rows[trace]
        tiers.add(row["quant"])
        assert tokens == want[row["quant"]], (row["quant"], tokens)
        stages = [stage for stage, _ in row["stages"]]
        if row["quant"] == "int8":
            assert "demoted" in stages and row["tier"] == "int8"
        else:
            # a row staged while demoted and served after the promotion
            # keeps its stage, its tier stamped back to the base
            assert row.get("tier") in (None, "bf16")
    assert tiers == {"bf16", "int8"}


def test_pool_flood_resizes_admission_and_prices_retry(model):
    governor = tgov.ServingGovernor(tgov.GovernorConfig(
        demote_burn=1e9, cooldown_s=0.5, interval_s=0.02, pool_high=0.5,
        min_admit=2, breaker_guard=False, prewarm=False))
    monkey = ServingChaosMonkey(ServingChaosConfig(
        pool_flood_pages=56, pool_flood_at=4, pool_flood_steps=1 << 30))
    api = _api(model, paged=True, page_size=8, pool_pages=64,
               max_queue=16, governor=governor, chaos=monkey).start()
    url = "http://127.0.0.1:%d/generate" % api.port
    try:
        for _ in range(4):
            assert post(url, [1, 2, 3])[0] == 200
        assert wait_until(lambda: (post(url, [1, 2, 3]),
                                   "flood_start" in monkey.stamps)[1])
        assert wait_until(lambda: (post(url, [1, 2]),
                                   api.effective_max_queue == 8)[1])
        assert governor.counters["admit_resizes"] >= 1
        assert api.health.retry_after_s() == governor.retry_price
        # 54 + 5 tokens want 8 pages; the flood leaves fewer free
        code, _, headers = post(url, [1, 2, 3] * 18)
        assert code == 429 and 1 <= int(headers["Retry-After"]) <= 60
        monkey.release_flood()
        assert wait_until(lambda: (post(url, [1, 2]),
                                   api.effective_max_queue == 16)[1])
        code, body, _ = post(url, [1, 2, 3])
        assert code == 200 and len(body["tokens"]) == 5
    finally:
        monkey.release_flood()
        api.stop()


def test_compile_storm_trips_the_breaker_and_heals(model):
    tracker = get_compile_tracker()
    governor = tgov.ServingGovernor(tgov.GovernorConfig(
        demote_burn=1e9, cooldown_s=5.0, interval_s=0.02,
        breaker_guard=True, prewarm=False))
    monkey = ServingChaosMonkey(ServingChaosConfig(compile_storm_at=6))
    api = _api(model, governor=governor, chaos=monkey).start()
    url = "http://127.0.0.1:%d/generate" % api.port
    try:
        assert tracker.enabled
        code, body, _ = post(url, [1, 2, 3])
        want = body["tokens"]
        assert wait_until(lambda: (post(url, [1, 2, 3]),
                                   monkey.counters["compile_storms"])[1])
        assert wait_until(lambda: governor.counters["guard_trips"] >= 1)
        assert wait_until(lambda: api.health.counter("rebuilds") >= 1)
        assert wait_until(lambda: api.health.ready)
        assert governor.counters["guard_trips"] == 1
        assert any(t["action"] == "guard_trip" and "storm" in t["reason"]
                   for t in governor.transitions)
        code, body, _ = post(url, [1, 2, 3])
        assert code == 200 and body["tokens"] == want
    finally:
        api.stop()


def test_a_failed_tier_swap_keeps_the_old_decoder(model, monkeypatch):
    """The new tier's probe fails: the old decoder keeps serving, the
    backoff is armed (request_tier ignored meanwhile) and the flight
    ring books ``governor.tier_failed``."""
    from veles_tpu_torch.observe.flight import get_flight_recorder

    api = _api(model, governor=tgov.ServingGovernor(tgov.GovernorConfig(
        prewarm=False, breaker_guard=False)), rebuild_backoff=5.0)
    old = api.decoder

    def refuse(kwargs):
        raise RuntimeError("probe decode did not finish")
    monkeypatch.setattr(api, "_build_probed_decoder", refuse)
    assert api._apply_tier("int8") is False
    assert api.decoder is old and api.decoder.quantize is None
    assert api._tier_block_until > time.monotonic()
    api.request_tier("int8")
    assert api._tier_request is None
    kinds = [e.get("kind") for e in get_flight_recorder().entries()]
    assert "governor.tier_failed" in kinds


def test_effective_limit_and_tier_requests(model):
    api = _api(model, max_queue=64,
               governor=tgov.ServingGovernor(tgov.GovernorConfig()))
    assert api.effective_max_queue == 64
    api.governor.admit_limit = 3
    assert api.effective_max_queue == 3
    api.request_tier("bf16")          # the live tier: nothing to do
    assert api._tier_request is None
    api.request_tier("int8-kv")
    assert api._tier_request == "int8-kv"
    api._green = {"decoder": None}    # a live rollout refuses the swap
    api._tier_request = None
    api.request_tier("int8")
    assert api._tier_request is None
    bare = _api(model, max_queue=5)
    assert bare.governor is None and bare.effective_max_queue == 5


def test_the_rebuild_lands_on_the_governed_tier(model):
    governor = tgov.ServingGovernor(tgov.GovernorConfig(
        ladder=("int8", "int8-kv"), prewarm=False, breaker_guard=False))
    api = _api(model, paged=True, page_size=8, governor=governor)
    governor.level = 2
    kwargs, tier = api._governed_kwargs()
    assert tier == "int8-kv" and kwargs["quantize"] == "int8-kv"
    assert api._rebuild() is True
    assert api.decoder.quantize == "int8-kv"
    # across tiers the prefix cache is left behind
    assert api.decoder.restore_stats is None


def test_concurrent_front_answers_while_a_swap_drains(model):
    """Requests arriving while a tier swap is pending wait in the staged
    queue and are answered by the new tier: nobody is shed."""
    governor = tgov.ServingGovernor(tgov.GovernorConfig(
        prewarm=False, breaker_guard=False, interval_s=1e6))
    api = _api(model, governor=governor).start()
    url = "http://127.0.0.1:%d/generate" % api.port
    codes = []
    try:
        post(url, [1, 2])
        governor.level = 1
        threads = [threading.Thread(target=lambda: codes.append(
            post(url, [3, 4, 5])[0])) for _ in range(4)]
        api.request_tier("int8")
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(60)
        assert wait_until(lambda: api.decoder.quantize == "int8")
    finally:
        api.stop()
    assert codes == [200] * 4
