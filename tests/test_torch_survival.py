"""The port's serving survival layer (veles_tpu_torch/serving.py,
serving_chaos.py, fleet/chaos.py) on the CPU against the JAX package:
the chaos schedule draw for draw, ServingHealth's counters and windows,
the circuit breaker over HTTP (trip, shed, rebuild, probe, heal; the
streams after recovery equal the port's fault-free run and the JAX
package's decode on the same weights), and GenerateAPI's sampling,
eos, tile, config defaults and deadline validation.

Greedy streams are compared exactly (f32 weights, the same sublayers on
both sides); sampled streams come from the port's own key stream, which
the JAX package's threefry keys do not share, so they are held against
the port's decoder on the same request id and seed. Rebuild backoffs
are 0.01 s, so no test sleeps long."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu import serving as jserving
from veles_tpu import serving_chaos as jchaos
from veles_tpu.parallel import decode as jdec
from veles_tpu.parallel import transformer_step as jts
from veles_tpu_torch import serving as tserving
from veles_tpu_torch import serving_chaos as tchaos
from veles_tpu_torch.core.config import root as troot
from veles_tpu_torch.fleet import chaos as tfleet
from veles_tpu_torch.parallel import transformer_step as tts

torch.set_num_threads(1)

BLOCKS, EMBED, HEADS, VOCAB = 2, 32, 4, 64
PS, SLOTS, MAX_LEN, N_TOKENS = 8, 3, 48, 6


@pytest.fixture(scope="module")
def model():
    jparams = jts.init_transformer_params(numpy.random.RandomState(0),
                                          BLOCKS, EMBED, HEADS, VOCAB)
    tparams = tts.init_transformer_params(numpy.random.RandomState(0),
                                          BLOCKS, EMBED, HEADS, VOCAB,
                                          device="cpu")
    table = numpy.random.RandomState(1).randn(VOCAB, EMBED).astype(
        numpy.float32)
    return jparams, tparams, table


def _jax_stream(model, prompt, n_tokens=N_TOKENS):
    jparams, _, table = model
    toks, _ = jdec.generate(jparams, jnp.asarray(table),
                            jnp.asarray(numpy.asarray(prompt)[None]),
                            HEADS, n_tokens=n_tokens)
    return numpy.asarray(toks)[0].tolist()


# -- the chaos schedule, draw for draw ---------------------------------------

def _before_step_pattern(module, config, calls=200):
    """(failed, slowed) of every before_step call."""
    monkey = module.ServingChaosMonkey(config)
    pattern = []
    for _ in range(calls):
        slowed = monkey.counters["steps_slowed"]
        try:
            monkey.before_step()
            failed = False
        except module.ChaosStepError:
            failed = True
        pattern.append((failed, monkey.counters["steps_slowed"] > slowed))
    return pattern, monkey.counters


@pytest.mark.parametrize("kwargs", [
    dict(seed=1, step_fail=0.5),
    dict(seed=7, step_fail=0.3, slow_step=0.4, slow_step_ms=0.0),
    dict(seed=3, slow_step=0.6, slow_step_ms=0.0),
    dict(seed=9, step_fail=0.8, step_fail_max=5, slow_step=0.2,
         slow_step_ms=0.0),
    dict(seed=2, step_fail=0.0, slow_step=0.0, disconnect=0.5),
], ids=["fail", "fail-slow", "slow", "capped", "client-only"])
def test_chaos_schedule_matches_jax(kwargs):
    """200 before_step calls fail and slow at the same calls as the JAX
    package's monkey: random.Random(seed), slow_step rolled before
    step_fail, a probability <= 0 never advancing the stream."""
    ours, our_counters = _before_step_pattern(
        tchaos, tchaos.ServingChaosConfig(**kwargs))
    theirs, their_counters = _before_step_pattern(
        jchaos, jchaos.ServingChaosConfig(**kwargs))
    assert ours == theirs
    assert {k: our_counters[k] for k in ("steps_failed", "steps_slowed")} \
        == {k: their_counters[k] for k in ("steps_failed", "steps_slowed")}


@pytest.mark.parametrize("kwargs", [
    dict(seed=1, disconnect=0.3, garbage_body=0.3, oversize_body=0.3),
    dict(seed=5, garbage_body=0.5),
    dict(seed=4, disconnect=1.0, oversize_body=0.2),
], ids=["all", "garbage-only", "always-disconnect"])
def test_client_fault_rolls_match_jax(kwargs):
    """roll_client_fault's 200 decisions equal the JAX monkey's, from
    random.Random("client-<seed>"), independent of the driver stream."""
    ours = tchaos.ServingChaosMonkey(tchaos.ServingChaosConfig(**kwargs))
    theirs = jchaos.ServingChaosMonkey(jchaos.ServingChaosConfig(**kwargs))
    assert [ours.roll_client_fault() for _ in range(200)] \
        == [theirs.roll_client_fault() for _ in range(200)]
    assert ours.counters["disconnects"] == theirs.counters["disconnects"]


def test_step_fail_max_caps_the_failures():
    monkey = tchaos.ServingChaosMonkey(tchaos.ServingChaosConfig(
        seed=7, step_fail=1.0, step_fail_max=2))
    failures = 0
    for _ in range(16):
        try:
            monkey.before_step()
        except tchaos.ChaosStepError:
            failures += 1
    assert failures == 2 == monkey.counters["steps_failed"]


def test_roll_is_the_jax_roll():
    """A probability <= 0 never fires and never draws; the rest draws
    once a call, as the JAX package's fleet roll."""
    import random

    from veles_tpu.fleet import chaos as jfleet

    for probability in (0.0, -1.0, 0.25, 1.0):
        ours, theirs = random.Random(3), random.Random(3)
        assert [tfleet.roll(ours, probability) for _ in range(50)] \
            == [jfleet.roll(theirs, probability) for _ in range(50)]
        assert ours.random() == theirs.random()


@pytest.mark.parametrize("knob,value", [
    ("compile_storm_at", 3), ("waste_cause", "padding"),
    ("waste_tokens", 4), ("deploy_green_ramp_ms", 5.0),
    ("deploy_green_ramp_steps", 2), ("leak_retain_pool_at", 1),
])
def test_unported_profile_knobs_raise(knob, value):
    with pytest.raises(ValueError, match="not yet ported"):
        tchaos.ServingChaosConfig(**{knob: value})


def test_config_validation_matches_jax():
    for module in (tchaos, jchaos):
        with pytest.raises(ValueError, match="outside"):
            module.ServingChaosConfig(step_fail=1.5)
        with pytest.raises(ValueError, match="step_fail_max"):
            module.ServingChaosConfig(step_fail_max=-1)
        with pytest.raises(ValueError, match="latency ramp"):
            module.ServingChaosConfig(latency_ramp_ms=-1)
        assert not module.ServingChaosConfig().any_enabled
        assert module.ServingChaosConfig(slow_step=0.1).any_enabled
        assert module.ServingChaosConfig(pool_flood_pages=2).any_profile


def test_from_config_reads_serve_chaos():
    """The default subtree builds no monkey; a knob set there builds one
    with it, and a knob of an unported profile raises."""
    chaos = troot.common.serve.chaos
    saved = chaos.__content__()
    try:
        assert tchaos.ServingChaosMonkey.from_config() is None
        chaos.update({"seed": 4, "slow_step": 0.5, "slow_step_ms": 0.0})
        monkey = tchaos.ServingChaosMonkey.from_config()
        assert monkey.config.seed == 4 and monkey.config.slow_step == 0.5
        chaos.update({"enabled": False})
        assert tchaos.ServingChaosMonkey.from_config() is None
        chaos.update({"enabled": True, "compile_storm_at": 2})
        with pytest.raises(ValueError, match="not yet ported"):
            tchaos.ServingChaosMonkey.from_config()
    finally:
        troot.common.serve.update({"chaos": saved})
        for key in ("enabled", "compile_storm_at"):
            if key not in saved:
                delattr(chaos, key)


class _PoolDecoder:
    """Just the pool a flood reserves from."""

    def __init__(self, pages):
        from veles_tpu_torch.parallel.kv_pool import PagePool
        self.pool = PagePool(pages, PS)


def test_latency_ramp_and_pool_flood_profiles():
    """The step-indexed profiles: the ramp stalls its window of steps
    then clears (stamps), the flood reserves its pages at its step and
    gives them back after its steps, as the JAX monkey does."""
    monkey = tchaos.ServingChaosMonkey(tchaos.ServingChaosConfig(
        latency_ramp_ms=0.5, latency_ramp_steps=2, latency_ramp_hold=1,
        pool_flood_pages=4, pool_flood_at=1, pool_flood_steps=2))
    dec = _PoolDecoder(10)
    reserved = []
    for _ in range(6):
        monkey.before_step(dec)
        reserved.append(dec.pool.snapshot()["reserved_pages"])
    assert reserved == [0, 4, 4, 0, 0, 0]
    assert monkey.counters["ramp_stalls"] == 3
    assert monkey.counters["pool_floods"] == 1
    assert {"ramp_start", "ramp_clear", "flood_start",
            "flood_clear"} <= set(monkey.stamps)
    monkey.clear_ramp()
    monkey.release_flood()


def test_poisoned_swap_names_the_jax_leaf(model):
    """deploy_poison_nan turns the first floating leaf in the JAX
    package's flatten order to NaN, once; _non_finite_leaf names the
    same leaf on both sides."""
    jparams, tparams, _ = model
    ours = tchaos.ServingChaosMonkey(tchaos.ServingChaosConfig(
        deploy_poison_nan=True))
    theirs = jchaos.ServingChaosMonkey(jchaos.ServingChaosConfig(
        deploy_poison_nan=True))
    poisoned = ours.maybe_poison_swap(tparams)
    name = tserving._non_finite_leaf(poisoned)
    assert name == jserving._non_finite_leaf(
        theirs.maybe_poison_swap(jparams)) == "['blocks'][0]['b1']"
    assert tserving._non_finite_leaf(tparams) is None
    assert ours.maybe_poison_swap(tparams) is tparams   # fires once


# -- ServingHealth ------------------------------------------------------------

def test_serving_health_matches_jax():
    """The same admissions, releases, rollbacks and latency samples give
    the JAX package's counters, readiness, breaker and p50/p95."""
    ours = tserving.ServingHealth(name="generate-api")
    theirs = jserving.ServingHealth(name="generate-api")
    for health in (ours, theirs):
        assert health.try_admit(2) == "unready"
        health.set_ready(True)
        assert health.try_admit(2) is None
        assert health.try_admit(2) is None
        assert health.try_admit(2) == "full"
        assert health.try_admit(0, pool_gate=lambda: 3.5) == ("pool", 3.5)
        health.release("completed")
        health.release("shed")
        assert health.try_admit(None) is None
        health.reject_admitted()
        health.incr("trips")
        health.incr("param_swaps", 2)
        health.set_breaker("open")
        for i in range(20):
            health.record_latency("ttft", 0.001 * i)
            health.record_latency("tpot", 0.0005 * (20 - i))
        health.record_latency("queue_wait", 0.25)
    a, b = ours.snapshot(), theirs.snapshot()
    for key in ("name", "ready", "breaker", "inflight", "counters",
                "latency_ms"):
        assert a[key] == b[key], key
    assert ours.counter("param_swaps") == theirs.counter("param_swaps") == 2
    assert ours.retry_after_s() == theirs.retry_after_s() == 1.0


# -- the breaker over HTTP ---------------------------------------------------

def _post(port, payload, timeout=60):
    data = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port, data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode()), dict(
                resp.headers)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode()), dict(err.headers)


def _get(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode()), dict(
                resp.headers)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode()), dict(err.headers)


@pytest.fixture
def api_factory(model):
    _, tparams, table = model
    started = []

    def make(start=True, **kwargs):
        args = dict(slots=SLOTS, max_len=MAX_LEN, n_tokens=N_TOKENS,
                    chunk=2, paged=True, page_size=PS, device="cpu",
                    rebuild_backoff=0.01)
        args.update(kwargs)
        api = tserving.GenerateAPI(tparams, torch.from_numpy(table), HEADS,
                                   **args)
        if start:
            api.start()
            started.append(api)
        return api

    yield make
    for api in started:
        api.stop()


def _collect(api, prompts, timeout=120):
    """Post every prompt at once, retrying on 429/503 (what a client of
    a rebuilding replica does); returns the streams in order."""
    results = [None] * len(prompts)
    codes = []

    def call(i):
        for attempt in range(400):
            code, body, _ = _post(api.port, {"tokens": list(prompts[i])})
            codes.append(code)
            if code == 200:
                results[i] = body["tokens"]
                return
            assert code in (429, 503), (code, body)
            time.sleep(0.01 * min(attempt + 1, 10))

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=timeout)
    assert not any(thread.is_alive() for thread in threads)
    return results, codes


def _wait_ready(api, seconds=30):
    deadline = time.time() + seconds
    while not api.health.ready and time.time() < deadline:
        time.sleep(0.01)
    assert api.health.ready, api.health.snapshot()


@pytest.mark.parametrize("paged", [True, False], ids=["pool", "slab"])
def test_breaker_trips_heals_and_streams_match(model, api_factory, paged):
    """step_fail=1.0 capped at 2 (the trip and the first rebuild's
    probe) with slow steps: every request completes after retries, the
    breaker tripped, shed and rebuilt, /readyz answers 200, and the
    streams equal the port's fault-free run and the JAX package's decode
    on the same weights."""
    prompts = [numpy.random.RandomState(5).randint(0, VOCAB, n).tolist()
               for n in (4, 6, 5)]
    clean_api = api_factory(paged=paged)
    clean, _ = _collect(clean_api, prompts)
    assert clean_api.health.snapshot()["counters"]["trips"] == 0
    monkey = tchaos.ServingChaosMonkey(tchaos.ServingChaosConfig(
        seed=1, step_fail=1.0, step_fail_max=2, slow_step=0.25,
        slow_step_ms=2.0))
    api = api_factory(paged=paged, chaos=monkey)
    chaotic, codes = _collect(api, prompts)
    assert monkey.counters["steps_failed"] == 2
    snap = api.health.snapshot()
    assert snap["counters"]["trips"] >= 1 and snap["counters"]["shed"] >= 1
    assert snap["counters"]["rebuilds"] >= 1
    assert snap["ready"] and snap["breaker"] == "closed"
    assert 503 in codes
    code, body, _ = _get(api.port, "/readyz")
    assert code == 200 and body["ready"]
    assert chaotic == clean == [_jax_stream(model, p) for p in prompts]
    assert snap["latency_ms"]["ttft"]["count"] >= 3
    assert snap["latency_ms"]["queue_wait"]["count"] >= 3


def test_readyz_503_while_the_breaker_is_open(api_factory):
    """While the rebuild's probes keep failing the breaker stays open:
    /readyz answers 503 with a Retry-After and the state, and new
    requests get a retryable 503; then it heals."""
    monkey = tchaos.ServingChaosMonkey(tchaos.ServingChaosConfig(
        step_fail=1.0, step_fail_max=4))
    api = api_factory(chaos=monkey, rebuild_backoff=0.2,
                      rebuild_backoff_max=0.4)
    code, body, _ = _post(api.port, {"tokens": [1, 2, 3]})
    assert code == 503 and "rebuilding" in body["error"]
    code, body, headers = _get(api.port, "/readyz")
    assert code == 503 and not body["ready"]
    assert body["state"]["breaker"] == "open"
    assert headers.get("Retry-After") == "1"
    code, body, headers = _post(api.port, {"tokens": [1, 2]})
    assert code == 503 and headers.get("Retry-After") == "1"
    _wait_ready(api)
    assert _get(api.port, "/readyz")[0] == 200
    assert _post(api.port, {"tokens": [1, 2]})[0] == 200
    assert api.health.counter("trips") == 1
    assert api.health.counter("rebuilds") == 1


def test_rebuild_carries_the_request_ids(api_factory):
    """Request ids stay monotonic across a rebuild (the probe takes the
    next one), so sampled requests never reuse another's key stream."""
    api = api_factory(start=False)
    api.decoder.submit([1, 2])
    before = api.decoder._next_id
    assert api._rebuild()
    assert api.decoder._next_id >= before + 1
    assert api.decoder.results == {}


def test_staged_reservation_moves_to_the_rebuilt_pool(api_factory):
    """A request admitted against the dying decoder's pool and staged
    across the rebuild moves its page reservation to the new pool; where
    the new pool is promised to capacity it is shed with a retryable
    503 and reserves nothing (``serving.py:2482-2507``)."""
    api = api_factory(start=False)
    old_pool = api.decoder.pool
    holders = []
    for need in (3, old_pool.capacity - 3):
        assert old_pool.try_reserve(need)
        holder = {"event": threading.Event(), "pool": old_pool,
                  "pool_reserved": need, "staged_at": 0.0,
                  "deadline": 1e9}
        holders.append(holder)
    api.health.set_ready(True)
    assert api.health.try_admit(0) is None
    assert api.health.try_admit(0) is None
    assert api._rebuild()
    new_pool = api.decoder.pool
    assert new_pool is not old_pool
    assert new_pool.try_reserve(1)   # a request admitted after the heal
    for holder in holders:
        api._staged.put(([1, 2, 3], None, holder))
    waiting = api._drain_staged()
    assert list(waiting.values()) == [holders[0]]
    assert holders[0]["pool"] is new_pool
    assert new_pool.snapshot()["reserved_pages"] == 1 + 3
    assert old_pool.snapshot()["reserved_pages"] == 0
    assert holders[1]["code"] == 503 and "retry" in holders[1]["error"]
    assert api.health.counter("shed") == 1


def test_a_hung_probe_fails_the_rebuild(api_factory, monkeypatch):
    """A probe that makes no progress exhausts its bounded steps and the
    rebuild fails; with the real drain the same rebuild succeeds."""
    api = api_factory(start=False)

    def stuck(self, max_steps=100000, chunk=1, before_step=None):
        for _ in range(max_steps):
            if before_step is not None:
                before_step()
        raise RuntimeError("decoder did not drain in %d steps" % max_steps)

    with monkeypatch.context() as patch:
        patch.setattr(tserving.ContinuousDecoder, "run_until_drained",
                      stuck)
        assert not api._rebuild()
    assert api._rebuild()


def test_trip_discards_the_chunk_in_flight(model, api_factory):
    """The chunk in flight when the fault hits is dropped, never
    collected into the shed request's results; the retry streams the
    fault-free tokens."""
    prompt = [1, 2, 3]
    api = api_factory()
    real = api.decoder.dispatch_chunk
    calls = {"n": 0}

    def flaky(n):
        calls["n"] += 1
        if calls["n"] == 2:   # chunk 1 is in flight when this raises
            raise RuntimeError("injected mid-flight failure")
        return real(n)

    api.decoder.dispatch_chunk = flaky
    code, body, _ = _post(api.port, {"tokens": prompt})
    assert code == 503 and "injected" in body["error"]
    _wait_ready(api)
    assert api._pending is None
    assert api.decoder.results == {}
    snap = api.health.snapshot()
    assert snap["counters"]["trips"] == 1 and snap["counters"]["shed"] == 1
    code, body, _ = _post(api.port, {"tokens": prompt})
    assert code == 200 and body["tokens"] == _jax_stream(model, prompt)


def test_request_trip_rebuilds_with_backoff(api_factory, monkeypatch):
    """request_trip opens the breaker on purpose; failed rebuilds back
    off exponentially up to rebuild_backoff_max, and the breaker closes
    on the first good one."""
    api = api_factory(rebuild_backoff=0.01, rebuild_backoff_max=0.04)
    waits, calls = [], []
    real_wait, real_rebuild = api._stop.wait, api._rebuild

    def wait(seconds):
        waits.append(seconds)
        return real_wait(0)

    def rebuild():
        calls.append(1)
        return real_rebuild() if len(calls) > 3 else False

    monkeypatch.setattr(api._stop, "wait", wait)
    monkeypatch.setattr(api, "_rebuild", rebuild)
    api.request_trip("operator drill")
    deadline = time.time() + 30
    while api.health.counter("rebuilds") < 1 and time.time() < deadline:
        time.sleep(0.01)
    assert api.health.ready
    assert waits == [0.01, 0.02, 0.04, 0.04]
    assert api.health.counter("trips") == 1
    assert api.health.counter("rebuilds") == 1
    assert api.last_rebuild["trip_to_ready_s"] > 0


# -- the new GenerateAPI arguments ---------------------------------------------

def test_sampled_streams_over_http_equal_the_decoder(model, api_factory):
    """temperature/top_k on the API: each HTTP stream equals the port's
    own decoder's stream for the same request id and seed."""
    _, tparams, table = model
    prompts = [[5, 6, 7], [1, 2, 3, 4, 5], [9, 8]]
    api = api_factory(temperature=0.8, top_k=5, seed=11, paged=False)
    streams = []
    for prompt in prompts:   # one at a time: request ids 0, 1, 2
        code, body, _ = _post(api.port, {"tokens": prompt})
        assert code == 200
        streams.append(body["tokens"])
    dec = tserving.ContinuousDecoder(
        tparams, torch.from_numpy(table), HEADS, slots=SLOTS,
        max_len=MAX_LEN, n_tokens=N_TOKENS, temperature=0.8, top_k=5,
        seed=11, device="cpu")
    rids = [dec.submit(p) for p in prompts]
    dec.run_until_drained(chunk=2)
    assert streams == [dec.results[rid] for rid in rids]
    assert len({tuple(s) for s in streams}) > 1


def test_eos_retires_early(model, api_factory):
    prompt = [3, 1, 4]
    full = _jax_stream(model, prompt)
    eos = full[2]
    api = api_factory(eos=eos)
    code, body, _ = _post(api.port, {"tokens": prompt})
    assert code == 200
    assert body["tokens"] == full[:full.index(eos) + 1]


def test_tile_gives_the_default_streams(model, api_factory):
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [4, 4]]
    default = api_factory(paged=False)
    tiled = api_factory(paged=False, tile=4)
    assert tiled.decoder.tile == 4 and default.decoder.tile == 128
    for prompt in prompts:
        assert _post(tiled.port, {"tokens": prompt})[1] \
            == _post(default.port, {"tokens": prompt})[1]
    with pytest.raises(ValueError, match="tile"):
        api_factory(start=False, tile=0)


def test_serve_config_defaults_are_read(api_factory):
    serve = troot.common.serve
    saved = {key: serve.get(key) for key in (
        "max_queue", "deadline", "rebuild_backoff", "rebuild_backoff_max",
        "paged", "page_size", "pool_pages")}
    try:
        serve.update({"max_queue": 7, "deadline": 12.5,
                      "rebuild_backoff": 0.25, "rebuild_backoff_max": 3.0,
                      "paged": True, "page_size": 4, "pool_pages": 40})
        api = api_factory(start=False, paged=None, page_size=None,
                          rebuild_backoff=None)
        assert (api.max_queue, api.deadline, api.rebuild_backoff,
                api.rebuild_backoff_max) == (7, 12.5, 0.25, 3.0)
        assert api.decoder.paged and api.decoder.page_size == 4
        assert api.decoder.pool_pages == 40
        assert api.chaos is None
    finally:
        serve.update(saved)


@pytest.mark.parametrize("deadline", [0, -1.0, float("inf"), 1e8])
def test_a_bad_server_deadline_fails_at_construction(model, deadline):
    _, tparams, table = model
    built = []
    real = tserving.ContinuousDecoder.__init__

    def counting(self, *args, **kwargs):
        built.append(1)
        real(self, *args, **kwargs)

    tserving.ContinuousDecoder.__init__ = counting
    try:
        with pytest.raises(ValueError, match="serve deadline"):
            tserving.GenerateAPI(tparams, torch.from_numpy(table), HEADS,
                                 device="cpu", deadline=deadline)
        with pytest.raises(ValueError, match="serve deadline"):
            tserving.GenerateAPI(tparams, torch.from_numpy(table), HEADS,
                                 device="cpu", request_timeout=deadline)
    finally:
        tserving.ContinuousDecoder.__init__ = real
    assert not built
