"""The port's memscope (veles_tpu_torch/observe/memscope.py) and its
owners and lifecycle edges in the serving path, on the CPU.

Held equal to the JAX package: the headroom forecast on the JAX drive's
points (5.0 s; None on flat or shrinking use), and the lifecycle-edge
verdicts (grown owners, the exempt ones, the named leak) for the same
owner byte sequence. Port-only: the decoder's owners against counts from
its tensors, the reconciliation invariant, a trip and rebuild and a hot
swap with no verdict, a planted reference to the old pool giving a
verdict naming ``kv_pool`` and a black box ``observe blackbox`` reads,
the breaker's black box shipping the shed request's ledger row, and
``/debug/memory`` and ``/healthz``'s cell."""

import gc
import json
import time
import urllib.request

import numpy
import pytest
import torch

from veles_tpu_torch.observe import flight as flight_mod
from veles_tpu_torch.observe import history as history_mod
from veles_tpu_torch.observe import memscope as memscope_mod
from veles_tpu_torch.observe.flight import FlightRecorder, load_dump
from veles_tpu_torch.observe.history import (MetricHistory,
                                             stop_history_sampler)
from veles_tpu_torch.observe.memscope import MemScope, pytree_nbytes
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.parallel.decode import slot_state_bytes
from veles_tpu_torch.parallel.kv_pool import paged_kv_bytes
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)

torch.set_num_threads(1)

KW = dict(slots=2, max_len=48, n_tokens=4, chunk=2, page_size=8)


@pytest.fixture(autouse=True)
def quiet_history(monkeypatch):
    """The port's metric history pinned to a 30 s cadence for the file,
    and every sampler stopped after each test."""
    monkeypatch.setattr(history_mod, "_history",
                        MetricHistory(registry=MetricsRegistry(),
                                      interval_s=30.0))
    monkeypatch.setattr(history_mod, "_history_built", True)
    yield
    stop_history_sampler()


@pytest.fixture
def scope(monkeypatch, tmp_path):
    """A fresh process memscope (1 KB leak threshold), a fresh flight
    recorder, and black boxes under tmp."""
    from veles_tpu_torch.core.config import root

    fresh = MemScope(leak_min_bytes=1024)
    monkeypatch.setattr(memscope_mod, "_memscope", fresh)
    monkeypatch.setattr(flight_mod, "_flight", FlightRecorder())
    monkeypatch.setattr(root.common.dirs, "run", str(tmp_path / "run"))
    return fresh


def _toy(seed=0):
    rng = numpy.random.RandomState(seed)
    params = init_transformer_params(rng, 2, 16, 4, 11, device="cpu")
    table = torch.from_numpy(rng.randn(11, 16).astype(numpy.float32) * 0.3)
    return params, table


def test_pytree_nbytes_over_dicts_of_tensors():
    tree = {"a": torch.zeros(3, 4), "b": [torch.zeros(5, dtype=torch.int8),
                                          (torch.zeros(2, dtype=torch.bfloat16),
                                           numpy.zeros(3))],
            "c": None, "d": 7}
    assert pytree_nbytes(tree) == 48 + 5 + 4 + 24
    assert pytree_nbytes(None) == 0


@pytest.mark.parametrize("paged", [False, True])
def test_decoder_owners_match_its_tensors(paged, scope):
    from veles_tpu_torch.serving import ContinuousDecoder

    params, table = _toy()
    dec = ContinuousDecoder(params, table, 4, paged=paged, device="cpu",
                            **{k: v for k, v in KW.items()
                               if k != "chunk"})
    owners = scope.attribute()
    weights = sum(t.numel() * t.element_size()
                  for t in [table] + [v for blk in params["blocks"]
                                      for v in blk.values()]
                  + [v for k, v in params.items() if k != "blocks"])
    assert owners["params"] == weights
    pool = paged_kv_bytes(dec.state) if paged else 0
    assert owners.get("kv_pool", 0) == pool
    assert owners["decode_state"] == slot_state_bytes(dec.state) - pool
    snap = scope.snapshot()
    assert snap["owners"]["untagged"] == max(
        0, snap["device_bytes"] - snap["tagged_bytes"])
    del dec
    gc.collect()
    assert scope.attribute().get("params", 0) == 0


def test_headroom_forecast_equals_jax():
    from veles_tpu.observe.memscope import MemScope as JaxScope

    base = time.monotonic()
    out = []
    for cls in (MemScope, JaxScope):
        grow, flat, shrink = cls(), cls(), cls()
        for i in range(6):
            grow._pool_points.append((base - (5 - i), 2 * i, 20 - 2 * i))
            flat._pool_points.append((base - (5 - i), 4, 10))
            shrink._pool_points.append((base - (5 - i), 10 - i, i))
        out.append((grow.headroom_forecast_s(now=base),
                    flat.headroom_forecast_s(now=base),
                    shrink.headroom_forecast_s(now=base)))
    assert out[0] == out[1] == (5.0, None, None)


class _Owner:
    def __init__(self, nbytes):
        self.nbytes = nbytes


def test_edge_verdicts_equal_jax():
    from veles_tpu.observe.memscope import MemScope as JaxScope

    out = []
    for cls in (MemScope, JaxScope):
        scope = cls(leak_min_bytes=100)
        pool, stash, params = _Owner(1000), _Owner(0), _Owner(500)
        scope.register("kv_pool", pool, lambda o: o.nbytes)
        scope.register("param_stash", stash, lambda o: o.nbytes)
        scope.register("params", params, lambda o: o.nbytes)
        verdicts = []
        scope.edge_begin("breaker_rebuild")
        zombie = _Owner(1000)
        scope.register("kv_pool", zombie, lambda o: o.nbytes)
        verdicts.append(scope.edge_end("breaker_rebuild"))
        scope.edge_begin("swap_params")
        stash.nbytes = 500
        verdicts.append(scope.edge_end("swap_params"))
        verdicts.append(scope.edge_end("never_begun"))
        out.append([None if v is None else {k: v[k] for k in (
            "edge", "before", "after", "grown", "leak", "owner",
            "grew_bytes")} for v in verdicts] + [scope.leaks_total,
                                                 scope.edges_total])
    assert out[0] == out[1]
    assert out[0][0]["owner"] == "kv_pool" and not out[0][1]["leak"]


def _api(**kw):
    from veles_tpu_torch.serving import GenerateAPI

    params, table = _toy()
    return GenerateAPI(params, table, 4, paged=True, rebuild_backoff=0.01,
                       device="cpu", **dict(KW, **kw)).start()


def _post(port, tokens, headers=None):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps({"tokens": tokens}).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _trip(api):
    rebuilds = api.health.counter("rebuilds")
    api.request_trip("drill")
    assert _wait(lambda: api.health.counter("rebuilds") == rebuilds + 1)


def test_rebuild_and_swap_give_no_leak(scope):
    """A trip over a populated prefix cache and a hot swap: no verdict.
    The rebuild captures the cache's shadows inside its edge (they grow)
    and the swap stashes the old weights: both retained on purpose (the
    JAX package exempts the stash only, and would name the shadows)."""
    from veles_tpu.observe.memscope import MemScope as JaxScope

    params2, table2 = _toy(seed=5)
    api = _api()
    try:
        assert _post(api.port, [1, 2, 3, 4, 5, 6, 7, 8, 9])[0] == 200
        _trip(api)
        assert _post(api.port, [1, 2, 3, 4, 5, 6, 7, 8, 9])[0] == 200
        api.swap_params(params2, table2, version="v2")
        assert _post(api.port, [4, 5])[0] == 200
    finally:
        api.stop()
    edges = [(e["edge"], e["leak"]) for e in scope.edges]
    assert edges == [("breaker_rebuild", False), ("swap_params", False)]
    assert scope.leaks_total == 0
    # the exempt owners grew, and the verdicts ignore them
    assert scope.edges[0]["grown"].get("prefix_shadows", 0) > 0
    assert scope.edges[1]["grown"].get("param_stash", 0) > 0
    assert set(MemScope.LEAK_EXEMPT) - set(JaxScope.LEAK_EXEMPT) \
        == {"prefix_shadows"}


def test_a_planted_pool_reference_names_kv_pool(scope, tmp_path, capsys):
    """A trip while a reference holds the old decoder's pool and state:
    the rebuild's verdict names ``kv_pool``, and its black box (with the
    ``memscope`` section) reads with ``observe blackbox``."""
    from veles_tpu_torch.observe.flight import blackbox_main

    api = _api()
    try:
        assert _post(api.port, [1, 2, 3])[0] == 200
        _trip(api)   # a clean one first: no verdict
        planted = (api.decoder.pool, api.decoder.state)
        _trip(api)
        payload = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/debug/memory?edges=4" % api.port,
            timeout=30).read().decode())
        health = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/healthz" % api.port,
            timeout=30).read().decode())
    finally:
        api.stop()
    assert [e["leak"] for e in scope.edges] == [False, True]
    verdict = scope.edges[-1]
    assert verdict["owner"] == "kv_pool"
    assert verdict["grew_bytes"] == paged_kv_bytes(planted[1])
    (incident,) = scope.incidents
    path = incident["artifact"]
    doc = load_dump(path)
    assert doc["reason"] == "memscope_leak_kv_pool"
    assert doc["extra"]["memscope_leak"]["owner"] == "kv_pool"
    assert doc["memscope"]["last_leak_owner"] == "kv_pool"
    assert blackbox_main(path) == 0
    assert "memscope_leak_kv_pool" in capsys.readouterr().out
    assert payload["leaks_total"] == 1 and payload["incidents"] == [path]
    assert [e["edge"] for e in payload["edges"]] == ["breaker_rebuild"] * 2
    owners = payload["memscope"]["owners"]
    assert owners["untagged"] == max(
        0, payload["memscope"]["device_bytes"]
        - payload["memscope"]["tagged_bytes"])
    assert health["memscope"]["last_leak_owner"] == "kv_pool"
    del planted


def test_the_breakers_black_box_ships_the_shed_request(scope):
    """A decoder fault sheds the request in flight; the trip's black box
    holds its ledger row (tenant, trace, waterfall) among ``requests``'s
    in-flight rows, and its memscope section."""
    from veles_tpu_torch.serving_chaos import (ServingChaosConfig,
                                               ServingChaosMonkey)

    api = _api()   # the process ledger: the one the black box reads
    try:
        assert _post(api.port, [1, 2, 3])[0] == 200
        api.chaos = ServingChaosMonkey(ServingChaosConfig(
            step_fail=1.0, step_fail_max=1))
        code, _ = _post(api.port, [4, 5, 6],
                        {"X-Veles-Tenant": "victim",
                         "X-Veles-Trace": "dead01/02"})
        assert code == 503
    finally:
        api.stop()
    flight = flight_mod.get_flight_recorder()
    doc = load_dump(flight.last_dump_path)
    assert doc["reason"] == "breaker_trip"
    shed = [r for r in doc["requests"]["inflight"]
            if r["tenant"] == "victim"]
    assert len(shed) == 1 and shed[0]["trace"] == "dead01"
    # the fault came before its admission: staged and gated, in flight
    assert [s for s, _ in shed[0]["stages"]] == ["staged", "pool_gated"]
    assert shed[0]["outcome"] is None
    assert doc["memscope"]["tagged_bytes"] > 0
    assert api.ledger.resolved()[-1]["outcome"] == "shed"
