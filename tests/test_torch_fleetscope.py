"""The port's fleet observatory (veles_tpu_torch/observe/fleetscope.py),
the tracer's span-ring hook and ``publish_fleet`` against the JAX
package's on the CPU.

One recorded sequence of job issues, updates and clock stamps, from two
slaves one of which straggles, drives both packages' ``FleetScope``:
the step windows, the clock estimates, the straggler verdicts, the
autopsy's incident, the goodput summary and the shipped spans are
equal. The same ``/debug/fleet`` payload assembles into the same Chrome
trace (the library call and ``python -m veles_tpu_torch observe
fleet-trace``), and the same fleet status gives the same
``veles_fleet_*`` exposition rows."""

import json
import math
import random

import pytest
import torch

from veles_tpu.observe import fleetscope as jscope
from veles_tpu.observe import history as jhistory
from veles_tpu.observe import metrics as jmetrics
from veles_tpu_torch.__main__ import main
from veles_tpu_torch.observe import fleetscope as scope_mod
from veles_tpu_torch.observe import history, metrics
from veles_tpu_torch.observe.tracing import Tracer

torch.set_num_threads(1)


class _Slave:
    def __init__(self, sid, pid):
        self.id, self.mid, self.pid = sid, "mid0", pid


def _script(module, hist_module, metrics_module, tmp_path):
    """The recorded sequence: slave-1 steps in 10 ms, slave-2 in 50 ms
    (the straggler), both with clock offsets and jittered wire legs; a
    duplicate replay, a garbage stamp, a rollback report and a drop."""
    rng = random.Random(21)
    scope = module.FleetScope()
    hist = hist_module.MetricHistory(
        registry=metrics_module.MetricsRegistry(enabled=False),
        incidents=hist_module.IncidentRecorder(directory=str(tmp_path),
                                               cooldown_s=0.0))
    slaves = {"slave-1": (_Slave("slave-1", 1), 0.010, 3.25),
              "slave-2": (_Slave("slave-2", 2), 0.050, -1.5)}
    for sid, (slave, _, _) in slaves.items():
        scope.track_window(sid, module.StepWindow())
    out = {"pairs": [], "events": [], "paths": 0}
    now, job_id = 100.0, 0
    for step in range(12):
        for sid, (slave, step_s, offset) in slaves.items():
            job_id += 1
            scope.note_issue(job_id, slave, now)
            d1, d2 = rng.uniform(1e-3, 4e-3), rng.uniform(1e-3, 4e-3)
            rx = now + d1 + offset
            compute = step_s * rng.uniform(0.9, 1.1)
            tx = rx + compute + 2e-3
            now += d1 + compute + 2e-3 + d2
            msg = {"job_id": job_id, "mono": [rx, tx],
                   "job_ms": compute * 1e3,
                   "spans": [["fleet.do_job", "tr%d" % job_id,
                              "sp%d" % job_id, "is%d" % job_id, rx,
                              compute * 1e3, 7]]}
            if step == 5 and sid == "slave-2":
                msg["rollback_ms"] = 12.5
            pair = scope.note_update(slave, msg, now)
            out["pairs"].append(None if pair is None else
                                sorted((k, round(v, 9))
                                       for k, v in pair.items()))
            scope.book_update(sid, pair, now)
            scope.windows[sid].push(compute)
            # a duplicate replay ships the same spans and job again
            if step == 3:
                assert scope.note_update(slave, dict(msg), now) is None
            path = scope.autopsy_tick(sid, hist, wasted_s=0.25, now=now)
            out["paths"] += path is not None
            out["events"].append(scope.straggler_summary())
        now += 0.005
    scope.note_update(slaves["slave-1"][0], {"job_id": 999,
                                             "mono": "zzz"}, now)
    out["goodput"] = scope.goodput_summary(wasted_s=0.25)
    out["clocks"] = scope.clock_summary()
    out["stats"] = [scope.slave_stats(sid) for sid in slaves]
    out["windows"] = [(w.samples, w.hang_timeout(120.0))
                      for w in (scope.windows[sid] for sid in slaves)]
    out["spans"] = scope.span_rows()
    out["rules"] = sorted((r.name, r.series, r.fired_total)
                          for r in hist.rules
                          if r.name.startswith("fleet_"))
    scope.drop_slave("slave-2")
    out["after_drop"] = (scope.straggler_summary(),
                         scope.slave_stats("slave-2"))
    return out


def _rounded(value):
    if isinstance(value, float):
        return round(value, 9)
    if isinstance(value, dict):
        return {k: _rounded(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_rounded(v) for v in value]
    return value


def test_the_recorded_sequence_gives_jax_results(tmp_path):
    mine = _script(scope_mod, history, metrics, tmp_path / "port")
    theirs = _script(jscope, jhistory, jmetrics, tmp_path / "jax")
    for key in theirs:
        assert _rounded(mine[key]) == _rounded(theirs[key]), key
    # the straggler is named, and an incident landed
    assert mine["events"][-1]["slave"] == "slave-2"
    assert mine["paths"] >= 1
    assert mine["goodput"]["jobs"] == 24


def test_the_autopsy_incident_matches_jax(tmp_path):
    """The incident an autopsy writes names the straggler, with the
    goodput breach as its lead reference, in both packages."""
    docs = []
    for module, hist_module, metrics_module, sub in (
            (scope_mod, history, metrics, "port"),
            (jscope, jhistory, jmetrics, "jax")):
        hist = hist_module.MetricHistory(
            registry=metrics_module.MetricsRegistry(enabled=False),
            incidents=hist_module.IncidentRecorder(
                directory=str(tmp_path / sub), cooldown_s=0.0))
        scope = module.FleetScope()
        slave = _Slave("slave-2", 2)
        for value in [0.01] * 6:
            scope.windows.setdefault("slave-1",
                                     module.StepWindow()).push(value)
        scope.note_issue(1, slave, now=0.0)
        pair = scope.note_update(
            slave, {"job_id": 1, "mono": [5.0, 5.1], "job_ms": 10.0},
            now=0.1)
        scope.book_update("slave-2", pair, now=0.1)
        path = None
        for step in range(module.STRAGGLER_WINDOWS * 2 + 2):
            scope.windows.setdefault("slave-2",
                                     module.StepWindow()).push(0.05)
            path = path or scope.autopsy_tick("slave-2", hist,
                                              now=float(step + 1))
        with open(path) as fin:
            doc = json.load(fin)
        docs.append({"reason": doc["reason"],
                     "labels": doc["trigger"]["labels"],
                     "straggler": doc["trigger"]["straggler"],
                     "breaching": sorted(r["name"]
                                         for r in doc["breaching"]),
                     "lead": doc["leading_indicator"]["reference"]})
    assert _rounded(docs[0]) == _rounded(docs[1])
    assert docs[0]["reason"] == "fleet_straggler"
    assert docs[0]["labels"] == [["slave", "slave-2"]]


@pytest.mark.parametrize("asym", [0.0, 0.004])
def test_clock_estimates_match_jax(asym):
    mine, theirs = scope_mod.ClockEstimate(), jscope.ClockEstimate()
    rng = random.Random(5)
    for _ in range(16):
        # a slave clock 2 s ahead, wire legs d1 out and d1 + asym back
        d1 = rng.uniform(1e-3, 5e-3)
        theta = 2.0 + (d1 - (d1 + asym)) / 2.0
        mine.observe(theta, 2 * d1 + asym)
        theirs.observe(theta, 2 * d1 + asym)
    assert _rounded(mine.as_dict()) == _rounded(theirs.as_dict())
    assert mine.to_master(10.0) == theirs.to_master(10.0)
    assert math.isfinite(mine.as_dict()["offset_ms"])


def _payload(offset_s=4.0):
    """A ``/debug/fleet`` payload: the master issues at 10.0 and applies
    at 10.2, the slave (its clock ahead by ``offset_s``) runs do_job in
    between; the master's own copy of do_job must dedupe."""
    master_spans = [dict(event, kind="span") for event in (
        {"name": "fleet.issue", "etype": "single", "mono": 10.0,
         "trace_id": "tr1", "span_id": "i1", "parent_id": None,
         "tid": 5, "pid": 999},
        {"name": "fleet.apply", "etype": "begin", "mono": 10.2,
         "trace_id": "tr1", "span_id": "a1", "parent_id": "d1",
         "tid": 5, "pid": 999},
        {"name": "fleet.apply", "etype": "end", "mono": 10.25,
         "trace_id": "tr1", "span_id": "a1", "parent_id": "d1",
         "tid": 5, "pid": 999},
        {"name": "fleet.do_job", "etype": "begin", "mono": 10.05,
         "trace_id": "tr1", "span_id": "d1", "parent_id": "i1",
         "tid": 6, "pid": 999})]
    slave_t0 = 10.05 + offset_s
    return {
        "kind": "fleetscope", "schema": 1, "master_pid": 999,
        "master_mid": "mid0",
        "status": {"goodput": {"jobs": 2, "fraction": 0.8,
                               "compute_s": 1.0, "host_s": 0.1,
                               "wire_s": 0.1, "idle_s": 0.05,
                               "wasted_s": 0.0},
                   "straggler": {"slave": "slave-1", "score": 2.5,
                                 "step_ms": 50.0,
                                 "fleet_median_ms": 20.0,
                                 "windows": 3}},
        "clocks": {"mid0:7": {"slave": "slave-1",
                              "offset_ms": offset_s * 1e3,
                              "uncertainty_ms": 1.0, "samples": 4}},
        "slave_spans": [
            {"proc": "mid0:7", "slave": "slave-1", "name": "fleet.do_job",
             "trace_id": "tr1", "span_id": "d1", "parent_id": "i1",
             "tid": 9, "t0": slave_t0, "dur_ms": 100.0,
             "t0_master": slave_t0 - offset_s}],
        "master_spans": master_spans}


def test_assembled_fleet_trace_matches_jax():
    payload = _payload()
    mine = scope_mod.assemble_fleet_trace(payload)
    assert mine == jscope.assemble_fleet_trace(payload)
    spans = {e["name"]: e for e in mine["traceEvents"] if e.get("ph") != "M"}
    assert spans["fleet.do_job"]["pid"] != spans["fleet.issue"]["pid"]
    assert spans["fleet.do_job"]["ts"] == pytest.approx(50e3, abs=1e3)
    assert scope_mod.render_fleet_summary(payload, mine) \
        == jscope.render_fleet_summary(payload, mine)


def test_observe_fleet_trace_runs(tmp_path, capsys):
    """``python -m veles_tpu_torch observe fleet-trace`` assembles a saved
    payload (exit 0, the JAX package's trace) and refuses garbage with
    exit 1."""
    saved = tmp_path / "fleet_debug.json"
    saved.write_text(json.dumps(_payload()))
    out = tmp_path / "fleet.trace.json"
    assert main(["observe", "fleet-trace", str(saved), "-o",
                 str(out)]) == 0
    assert json.loads(out.read_text()) \
        == jscope.assemble_fleet_trace(_payload())
    text = capsys.readouterr().out
    assert "goodput 80.0%" in text and "persistent straggler" in text
    bad = tmp_path / "nope.json"
    bad.write_text('{"kind": "other"}')
    assert main(["observe", "fleet-trace", str(bad)]) == 1
    with pytest.raises(SystemExit):
        main(["observe", "fleet-trace"])


def test_span_ring_matches_jax_and_caps_each_frame():
    rings = scope_mod.SpanRing(capacity=256).enable(), \
        jscope.SpanRing(capacity=256).enable()
    for ring in rings:
        for index in range(300):
            ring.note_span("s" * (index % 200), "t", "sp%d" % index, None,
                           0.5, 1.0, 0)
    drained = [ring.drain() for ring in rings]
    assert drained[0] == drained[1]
    assert len(drained[0]) == scope_mod.SPAN_SHIP_MAX_ROWS
    assert (rings[0].noted_total, rings[0].shipped_total) \
        == (rings[1].noted_total, rings[1].shipped_total)
    assert scope_mod.valid_span_rows(drained[0]) \
        == jscope.valid_span_rows(drained[0])


def test_the_tracer_feeds_the_span_ring():
    """Completed spans (end and single) reach the process ring while it
    is enabled, with the span's ids and duration; a disabled ring stays
    empty."""
    ring = scope_mod.get_span_ring()
    was = ring.enabled
    ring.drain(10 ** 6)
    tracer = Tracer(enabled=True)
    try:
        ring.enable()
        with tracer.span("fleet.do_job", job_id=7) as span:
            pass
        tracer.event("fleet.issue", job_id=7)
        rows = {row[0]: row for row in ring.drain()}
        ring.disable()
        with tracer.span("quiet"):
            pass
        assert len(ring) == 0
    finally:
        ring.enabled = was
    assert rows["fleet.do_job"][1:3] == [span.trace_id, span.span_id]
    assert rows["fleet.issue"][5] == 0.0


class _Server:
    """What ``publish_fleet`` reads of a fleet master."""

    def fleet_status(self):
        return {"slaves": [{"id": "slave-1", "jobs_done": 5, "power": 1.0,
                            "step_ms": 12.5, "straggler_score": 0.8},
                           {"id": "slave-2", "jobs_done": 3, "power": 2.0,
                            "step_ms": 50.0, "straggler_score": 2.5}],
                "queued_jobs": 1,
                "ledger": {"issued": 9, "done": 8, "requeued": 1,
                           "fenced": {"duplicate": 2, "stale-epoch": 0}},
                "goodput": {"fraction": 0.75, "compute_s": 3.0,
                            "wire_s": 0.5, "host_s": 0.25, "idle_s": 0.25,
                            "wasted_s": 0.0, "jobs": 8},
                "clock": {"mid0:1": {"slave": "slave-1", "offset_ms": 3.5,
                                     "uncertainty_ms": 0.5}}}

    def slave_metrics(self):
        return {"slave-1": [("veles_loader_samples_served_total",
                             "counter", {"loader": "l"}, 300),
                            ("veles_mesh_devices", "gauge", {}, 1)]}


def test_publish_fleet_rows_match_jax():
    rows = []
    server = _Server()
    for module in (metrics, jmetrics):
        registry = module.MetricsRegistry(enabled=True)
        module.publish_fleet(registry, server)
        rows.append(sorted(line for line in registry.expose().splitlines()
                           if line.startswith("veles_")))
    assert rows[0] == rows[1]
    assert 'veles_fleet_straggler_score{slave="slave-2"} 2.5' in rows[0]
    assert 'veles_mesh_devices{slave="slave-1"} 1' in rows[0]
