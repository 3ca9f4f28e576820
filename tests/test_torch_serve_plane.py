"""The port's serve plane (veles_tpu_torch/fleet/serve_plane.py) on the
CPU, held against the JAX package's (veles_tpu/fleet/serve_plane.py,
tests/test_router.py::TestServePlane).

The same scripted ``/healthz`` sequences under an injected clock give
the same ``transitions`` (action, replica, state, reason, clock) and
counters in both planes: the leave-one-out drain and retire, a
fleet-wide brownout naming nobody, a drain waiting for its lease, a dead
replica with a standby's backfill, the ``min_active`` suppression, the
adopt under sustained pressure, the cooldown, and the counters-only
goodput. A collapse fires the detector-owned rule and cuts an incident
naming the replica on ``veles_ctrl_replica_goodput``; the control series
ride the port's metric history. Then the replicas themselves: the plane
reads the same goodput and pressure from a port ``GenerateAPI`` as from
a JAX one after the same traffic, and both fronts' ``/healthz`` carry
the fields the plane reads with equal values."""

import json
import urllib.request

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.fleet import serve_plane as jplane
from veles_tpu_torch.fleet import serve_plane as tplane

torch.set_num_threads(1)

PLANES = {"port": tplane, "jax": jplane}


def snap(goodput=1.0, inflight=0, limit=8, pages_used=0, pages_total=64,
         completed=0, errors=0, scope=True, reserved=0):
    out = {"inflight": inflight, "governor": {"effective_limit": limit},
           "pool": {"pages_used": pages_used, "pages_total": pages_total,
                    "reserved_pages": reserved},
           "counters": {"completed": completed, "errors": errors}}
    if scope:
        out["servescope"] = {"goodput_fraction": goodput}
    return out


@pytest.fixture
def no_history():
    from veles_tpu.observe import history as jhist
    from veles_tpu_torch.observe import history as thist
    saved = jhist.get_metric_history(), thist.get_metric_history()
    jhist.set_metric_history(None)
    thist.set_metric_history(None)
    try:
        yield
    finally:
        jhist.set_metric_history(saved[0])
        thist.set_metric_history(saved[1])


def run_script(which, n, standby, polls, script, lease=None, over=None):
    """A plane of ``n`` replicas (and ``standby``) whose fetch answers
    ``script(poll, index)`` (a snapshot, or None for a dead /healthz),
    polled ``polls`` times on the clock 0, 1, 2...; ``lease`` (poll,
    index, delta) books or ends one lease before a poll. Returns the
    transitions without wall time, the counters and the states."""
    mod = PLANES[which]
    cfg = mod.ServePlaneConfig(**dict({"poll_interval_s": 0.01,
                                       "cooldown_s": 0.0}, **(over or {})))
    urls = ["http://127.0.0.1:%d" % (9000 + i) for i in range(n)]
    spare = ["http://127.0.0.1:%d" % (9500 + i) for i in range(standby)]
    index = {url: i for i, url in enumerate(urls + spare)}
    clock = [0]

    def fetch(url):
        got = script(clock[0], index[url])
        if got is None:
            raise ConnectionRefusedError("down")
        return got

    plane = mod.ServePlane(urls, standby=spare, config=cfg, fetch=fetch)
    for poll in range(polls):
        clock[0] = poll
        for when, i, delta in lease or ():
            if when == poll:
                rep = plane.replicas[i]
                rep.note_dispatch() if delta > 0 else rep.note_done(True)
        plane.poll(now=float(poll))
    return ([{k: v for k, v in t.items() if k != "t"}
             for t in plane.transitions], dict(plane.counters),
            [(r.name, r.state, r.goodput, r.pressure, r.collapse_streak)
             for r in plane.replicas])


SCRIPTS = {
    "drain-retire": (3, 0, 3, lambda p, i: snap(0.05 if i == 0 else 1.0),
                     None, {"retire_polls": 2}),
    "brownout": (3, 0, 5, lambda p, i: snap(0.1), None,
                 {"retire_polls": 2}),
    "lease-wait": (3, 0, 4, lambda p, i: snap(0.0 if i == 0 else 1.0),
                   [(0, 0, 1), (3, 0, -1)], {"retire_polls": 1}),
    "dead-backfill": (1, 1, 3, lambda p, i: None if i == 0 else snap(),
                      None, {"fail_threshold": 3}),
    "suppressed": (2, 0, 4, lambda p, i: snap(0.0 if i == 0 else 1.0),
                   None, {"retire_polls": 2, "min_active": 2}),
    "adopt": (2, 1, 9, lambda p, i: snap(inflight=8 if p in (0, 1)
                                         or p >= 3 else 1),
              None, {"adopt_pressure": 0.8, "adopt_polls": 3}),
    "cooldown": (4, 0, 3, lambda p, i: snap(0.0 if i < 2 else 1.0), None,
                 {"retire_polls": 1, "cooldown_s": 100.0}),
    "counters-goodput": (3, 0, 5, lambda p, i: snap(
        scope=False, completed=10 * p if i else 2 * p,
        errors=0 if i else 8 * p), None, {"retire_polls": 2}),
    "pool-pressure": (2, 0, 3, lambda p, i: snap(
        scope=False, pages_used=60, pages_total=64, reserved=62,
        limit=None), None, {}),
    "flap": (3, 0, 8, lambda p, i: None if (i == 1 and p % 2) else snap(),
             None, {"fail_threshold": 2}),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_transitions_match_jax(case, no_history):
    n, standby, polls, script, lease, over = SCRIPTS[case]
    ours = run_script("port", n, standby, polls, script, lease, over)
    theirs = run_script("jax", n, standby, polls, script, lease, over)
    assert ours == theirs
    if case in ("drain-retire", "dead-backfill", "adopt",
                "suppressed", "counters-goodput"):
        assert ours[0], "the script must actuate"


@pytest.fixture
def isolated_history(tmp_path, monkeypatch):
    from veles_tpu_torch.observe import servescope
    from veles_tpu_torch.observe.history import (IncidentRecorder,
                                                 MetricHistory,
                                                 get_metric_history,
                                                 set_metric_history)
    from veles_tpu_torch.observe.metrics import MetricsRegistry
    monkeypatch.setattr(servescope, "MIN_EVAL_TOKENS", 10 ** 9)
    history = MetricHistory(
        registry=MetricsRegistry(enabled=True), interval_s=0.01,
        capacity=256, series_cap=64, rules=[],
        incidents=IncidentRecorder(cooldown_s=0.0,
                                   directory=str(tmp_path)))
    previous = get_metric_history()
    set_metric_history(history)
    try:
        yield history
    finally:
        set_metric_history(previous)


def _plane(n, **over):
    cfg = tplane.ServePlaneConfig(**dict({"poll_interval_s": 0.01,
                                          "cooldown_s": 0.0}, **over))
    return tplane.ServePlane(["http://127.0.0.1:%d" % (9000 + i)
                              for i in range(n)], config=cfg,
                             fetch=lambda url: snap())


def test_collapse_cuts_incident_naming_the_replica(isolated_history):
    history = isolated_history
    plane = _plane(3, retire_polls=2)
    victim = plane.replicas[0]
    plane._fetch = lambda url: snap(0.0 if url == victim.url else 1.0)
    for poll in range(3):
        plane.poll(now=float(poll))
    rule = next(r for r in history.rules if r.name == tplane.COLLAPSE_RULE)
    assert rule.external is True
    doc = history.incidents.last_doc
    assert doc is not None and history.incidents.last_path is not None
    leading = doc["leading_indicator"]
    assert leading["series"] == tplane.REPLICA_GOODPUT_SERIES
    assert ["replica", victim.name] in leading["labels"]
    assert tplane.ensure_router_rules(history) is rule


def test_control_series_recorded(isolated_history):
    plane = _plane(2)
    for poll in range(2):
        plane.poll(now=float(poll))
    rows = {(r["name"], tuple(sorted(r["labels"].items())))
            for r in isolated_history.debug_snapshot(
                window=60.0, now=2.0)["series"]}
    assert (tplane.FLEET_PRESSURE_SERIES, ()) in rows
    for rep in plane.replicas:
        assert (tplane.REPLICA_GOODPUT_SERIES,
                (("replica", rep.name),)) in rows


def test_registry_rejects_duplicates_and_drops_departed(no_history):
    plane = _plane(2)
    with pytest.raises(ValueError, match="already registered"):
        plane.add_standby(plane.replicas[0].url)
    fresh = plane.add_standby("http://127.0.0.1:9900")
    assert fresh.state == "standby"
    assert plane.drop_replica(fresh.name) is fresh
    assert plane.find(fresh.name) is None
    with pytest.raises(ValueError, match="duplicate"):
        tplane.ServePlane(["http://127.0.0.1:9000", "127.0.0.1:9000"])
    assert plane.snapshot()["active"] == 2


# -- real replicas: the fields the plane reads -------------------------------

HEADS, EMBED, BLOCKS, VOCAB = 4, 16, 2, 11
SERVE_KW = dict(slots=2, max_len=32, n_tokens=5, chunk=2, paged=True,
                page_size=4)
TRAFFIC = [[1, 2, 3, 4], [5, 6, 7], [1, 2, 3, 4, 5], [9, 9, 9, 9, 9, 9]]


def _post(port, tokens):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps({"tokens": tokens}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())["tokens"]


def _healthz(port):
    with urllib.request.urlopen("http://127.0.0.1:%d/healthz" % port,
                                timeout=60) as resp:
        return json.loads(resp.read().decode())


def test_plane_reads_port_replica_as_jax(no_history):
    from veles_tpu.parallel.transformer_step import init_transformer_params
    from veles_tpu.serving import GenerateAPI as JAPI
    from veles_tpu_torch import convert
    from veles_tpu_torch.serving import GenerateAPI

    rng = numpy.random.RandomState(0)
    jparams = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB)
    table = rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.3
    apis = {"jax": JAPI(jparams, jnp.asarray(table), HEADS,
                        **SERVE_KW).start(),
            "port": GenerateAPI(convert.params_from_jax(jparams,
                                                        device="cpu"),
                                torch.from_numpy(table), HEADS,
                                device="cpu", **SERVE_KW).start()}
    try:
        streams, readings, fields = {}, {}, {}
        for which, api in apis.items():
            plane = PLANES[which].ServePlane(
                ["http://127.0.0.1:%d" % api.port])
            plane.poll(now=0.0)
            streams[which] = [_post(api.port, p) for p in TRAFFIC]
            plane.poll(now=1.0)
            rep = plane.replicas[0]
            readings[which] = (rep.goodput, rep.pressure, rep.state)
            health = _healthz(api.port)
            fields[which] = (health["inflight"], health["counters"],
                             {k: health["pool"][k] for k in (
                                 "pages_total", "pages_used",
                                 "reserved_pages")},
                             (health.get("governor") or {}).get(
                                 "effective_limit"),
                             (health.get("servescope") or {}).get(
                                 "goodput_fraction"))
    finally:
        for api in apis.values():
            api.stop()
    assert streams["port"] == streams["jax"]
    assert readings["port"] == readings["jax"]
    assert fields["port"] == fields["jax"]
    assert fields["port"][1]["completed"] == len(TRAFFIC)
