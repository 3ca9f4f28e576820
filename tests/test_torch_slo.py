"""The port's SLO engine (veles_tpu_torch/observe/slo.py) against the JAX
package on the CPU, and its wiring into the serving front.

Held equal to the JAX package: the objectives parsed from the same specs
and the errors of bad ones; the gauges, the summary and the version burn
under a fixed clock after the same numpy-seeded ``record`` sequence
(within 1e-9 relative); the tenant cap's fold into ``"other"``; the
latencies derived from the same ledger rows; and the ``observe slo``
autopsy printed from the same saved artifact. Port-only: the gauges
over HTTP with tenant slices, the unmeetable tpot objective burning and
availability held, ``/healthz``'s ``slo`` and ``tpot`` cells, the
exemplars on the latency histograms and ``observe slo --live``."""

import json
import math
import re
import urllib.request

import numpy
import pytest
import torch

from veles_tpu_torch.observe import history as history_mod
from veles_tpu_torch.observe.history import (MetricHistory,
                                             stop_history_sampler)
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.observe.reqledger import RequestLedger
from veles_tpu_torch.observe.slo import (SLOEngine, observe_request,
                                         parse_objectives, row_latencies,
                                         slo_main)
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)

torch.set_num_threads(1)

SPEC = "ttft_p95_ms=250,tpot_p99_ms=40,availability=0.999"


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


def _objectives(objs):
    return [(o.name, o.kind, o.metric, o.target, o.threshold_s)
            for o in objs]


@pytest.mark.parametrize("spec", [
    SPEC, {"ttft_p50_ms": "100", "availability": 0.99}, None, "",
    "tpot_p95_ms=0.5"])
def test_objectives_parse_as_jax(spec):
    from veles_tpu.observe.slo import parse_objectives as jax_parse

    assert _objectives(parse_objectives(spec)) \
        == _objectives(jax_parse(spec))


@pytest.mark.parametrize("spec", [
    "latency=5", "ttft_p95_ms", "ttft_p0_ms=5", "ttft_p95_ms=-1",
    "availability=1.5", "ttft_p95_ms=fast", 17])
def test_bad_objectives_fail_with_jax_messages(spec):
    from veles_tpu.observe.slo import parse_objectives as jax_parse

    with pytest.raises(ValueError) as port:
        parse_objectives(spec, flag="--serve-slo")
    with pytest.raises(ValueError) as jax:
        jax_parse(spec, flag="--serve-slo")
    assert str(port.value) == str(jax.value)


def _records(seed=0, n=400):
    """A seeded request stream: (ttft, tpot, ok, tenant, version, now)
    over 40 minutes of a monotonic clock, 20 tenants (past the cap)."""
    rng = numpy.random.RandomState(seed)
    now = 1000.0 + numpy.cumsum(rng.exponential(6.0, n))
    out = []
    for i in range(n):
        ttft = None if rng.rand() < 0.05 else float(rng.gamma(2.0, 0.1))
        tpot = None if rng.rand() < 0.1 else float(rng.gamma(2.0, 0.015))
        out.append((ttft, tpot, bool(rng.rand() > 0.02),
                    "t%d" % rng.randint(20) if rng.rand() < 0.8 else "",
                    ("blue", "green", "")[rng.randint(3)], float(now[i])))
    return out


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)
    return a == b


def test_gauges_under_a_fixed_clock_equal_jax():
    from veles_tpu.observe.slo import SLOEngine as JaxEngine

    kw = dict(windows=(60.0, 300.0, 1800.0), bucket_seconds=10.0,
              tenant_cap=8)
    port, jax = SLOEngine(SPEC, **kw), JaxEngine(SPEC, **kw)
    records = _records()
    for i, (ttft, tpot, ok, tenant, version, now) in enumerate(records):
        for engine in (port, jax):
            engine.record(ttft_s=ttft, tpot_s=tpot, ok=ok, tenant=tenant,
                          version=version, now=now)
        if i % 50 == 49:
            rows, jrows = port.gauges(now=now), jax.gauges(now=now)
            assert len(rows) == len(jrows) > 0
            for row, jrow in zip(rows, jrows):
                assert row.keys() == jrow.keys()
                assert all(_close(row[k], jrow[k]) for k in row), (row,
                                                                   jrow)
            assert port.summary(now=now) == jax.summary(now=now)
            for version in ("blue", "green", "none"):
                assert port.version_burn(version, now=now) \
                    == jax.version_burn(version, now=now)
    tenants = {row["tenant"] for row in port.gauges(now=records[-1][-1])}
    assert "other" in tenants and len(tenants - {None}) <= 9
    assert port.recorded_total == jax.recorded_total == len(records)
    registry = MetricsRegistry(enabled=True)
    port.publish(registry, now=records[-1][-1])
    text = registry.expose()
    for name in ("veles_slo_objective_ratio",
                 "veles_slo_error_budget_remaining",
                 "veles_slo_burn_rate"):
        assert name + '{objective="availability",tenant="other"' in text


def _row(stages, chunks, tokens, outcome="completed", tenant="a",
         trace="ab12"):
    return {"stages": [list(s) for s in stages],
            "chunks": [list(c) for c in chunks], "tokens": tokens,
            "outcome": outcome, "tenant": tenant, "trace": trace,
            "api": "generate-api", "deploy": None}


ROWS = [
    _row([("staged", 1.0), ("admitted", 1.05), ("first_token", 1.2),
          ("resolved", 1.5)], [(1.2, 2, 0), (1.3, 3, 0), (1.45, 1, 0)], 6),
    _row([("staged", 2.0), ("first_token", 2.1), ("resolved", 2.4)],
         [(2.1, 4, 0)], 4),
    _row([("staged", 3.0), ("resolved", 3.2)], [], 0, outcome="shed"),
    _row([("staged", 4.0), ("first_token", 4.3), ("resolved", 4.3)],
         [(4.3, 1, 0)], 1),
]


def test_row_latencies_equal_jax():
    from veles_tpu.observe.slo import row_latencies as jax_latencies

    for row in ROWS:
        assert row_latencies(row) == jax_latencies(row)
    assert row_latencies(ROWS[0]) == (pytest.approx(0.2),
                                      pytest.approx(0.25 / 4))


def test_observe_request_feeds_engine_health_and_exemplars():
    from veles_tpu_torch.serving import ServingHealth

    engine = SLOEngine("ttft_p95_ms=150,availability=0.9")
    registry = MetricsRegistry(enabled=True)
    health = ServingHealth()
    for row in ROWS:
        observe_request(row, engine=engine, registry=registry,
                        health=health)
    assert engine.recorded_total == len(ROWS)
    assert health.snapshot()["latency_ms"]["tpot"]["count"] == 2
    om = registry.expose(openmetrics=True)
    assert set(re.findall(r'veles_request_ttft_seconds_bucket.* # '
                          r'\{trace_id="(\w+)"\}', om)) == {"ab12"}
    assert 'veles_request_tpot_seconds_count{api="generate-api"} 2' in om


def test_slo_cli_on_a_saved_artifact_equals_jax(tmp_path, capsys):
    """``observe slo`` prints the same autopsy as the JAX package's CLI
    from one saved ``/debug/requests`` payload and from one black box."""
    from veles_tpu.observe.slo import slo_main as jax_slo_main

    ledger = RequestLedger()
    for i in range(3):
        row = ledger.stage(api="generate-api", tenant="t%d" % i,
                           trace="f00d%d" % i, prompt_len=5 + i)
        ledger.note_admit(row, "cold", bucket=8, program="paged.admit")
        ledger.note_tokens(row, 3)
        ledger.note_tokens(row, 2)
        ledger.resolve(row, "completed")
    ledger.stage(api="generate-api", tenant="late")
    saved = tmp_path / "requests.json"
    saved.write_text(json.dumps(ledger.debug_snapshot()))
    box = tmp_path / "box.json"
    box.write_text(json.dumps({
        "schema": 1, "reason": "breaker_trip", "entries": [
            {"kind": "governor", "action": "demote", "tier": "int8",
             "burn": 3.5, "reason": "burn"}],
        "requests": ledger.debug_snapshot(),
        "metrics": [["veles_slo_burn_rate", "gauge",
                     [["objective", "availability"], ["window", "60s"]],
                     0.5]]}))
    for path in (saved, box):
        assert slo_main(str(path), slowest=2) == 0
        port = capsys.readouterr().out
        assert jax_slo_main(str(path), slowest=2) == 0
        assert port == capsys.readouterr().out
        assert "1 in flight:" in port and "2 slowest resolved:" in port
    assert "governor actuations:" in port and "veles_slo_burn_rate" in port
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"inflight": [], "slowest": []}))
    assert slo_main(str(empty)) == 1
    assert slo_main(str(tmp_path / "missing.json")) == 1


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read().decode()


def _post(url, body, headers):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"}, **headers))
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())


def test_slo_gauges_over_http_and_the_live_cli(capsys, monkeypatch):
    """A front with an unmeetable tpot objective: ``veles_slo_*`` carry
    the tenant slices, tpot burns above 0, availability stays 1.0,
    ``/healthz`` shows the burn and the ``tpot`` window, and ``observe
    slo --live`` exits 0. A fresh process registry: earlier fronts'
    histograms would count too."""
    from veles_tpu_torch.observe import metrics as metrics_mod
    from veles_tpu_torch.serving import GenerateAPI

    monkeypatch.setattr(metrics_mod, "_registry", MetricsRegistry())

    rng = numpy.random.RandomState(2)
    params = init_transformer_params(rng, 1, 16, 4, 13, device="cpu")
    table = torch.from_numpy(rng.randn(13, 16).astype(numpy.float32))
    engine = SLOEngine("ttft_p95_ms=60000,tpot_p95_ms=0.0001,"
                       "availability=0.999")
    api = GenerateAPI(params, table, 4, slots=2, max_len=32, n_tokens=5,
                      chunk=2, slo=engine, ledger=RequestLedger(),
                      device="cpu").start()
    try:
        url = "http://127.0.0.1:%d" % api.port
        for i in range(4):
            _post(url + "/generate", {"tokens": [1 + i, 2, 3]},
                  {"X-Veles-Tenant": ("blue", "green")[i % 2],
                   "X-Veles-Trace": "5eed%02d/01" % i})
        metrics = _get(url + "/metrics")
        health = json.loads(_get(url + "/healthz"))
        assert slo_main(live=url, slowest=2) == 0
    finally:
        api.stop()
    out = capsys.readouterr().out
    assert "SLO gauges:" in out and "2 slowest resolved:" in out

    def gauge(name, **labels):
        pattern = name + "{" + ",".join(
            '%s="%s"' % kv for kv in sorted(labels.items())) + "} "
        (line,) = [line for line in metrics.splitlines()
                   if line.startswith(pattern)]
        return float(line.split()[-1])

    assert gauge("veles_slo_burn_rate", objective="tpot_p95_ms",
                 window="60s") > 0
    assert gauge("veles_slo_objective_ratio", objective="availability",
                 window="60s") == 1.0
    for tenant in ("blue", "green"):
        assert gauge("veles_slo_objective_ratio", objective="availability",
                     tenant=tenant, window="1800s") == 1.0
    assert health["slo"]["objective"] == "tpot_p95_ms"
    assert health["slo"]["burn_rate"] > 0
    assert health["latency_ms"]["tpot"]["count"] == 4
    assert 'veles_request_tpot_seconds_count{api="generate-api"} 4' \
        in metrics
