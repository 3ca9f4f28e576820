"""The port's metric history (veles_tpu_torch/observe/history.py) against
the JAX package on the CPU, and its sampler and surfaces on the serving
front.

Held equal to the JAX package: the parsed configuration and the errors
of bad specs; for the same numpy-seeded sample sequence, the stored
rates and values, every rule's state, the incident bundles (trigger,
breaching rules, leading indicator, the history window) and their
rendering by ``observe incident``; the sparklines, dashboard cells and
the fleet summary round trip. Port-only: every seed rule watches a
family the port publishes (the storm rule through
``xla_stats.DIFFERING_FAMILIES``), the sampler starts with a front and
stops with it, ``/debug/history`` and a served burst whose incident
names ``veles_serving_latency_ms`` as the leading indicator against the
``slo_burn`` reference."""

import ast
import glob
import json
import os
import threading
import urllib.request

import numpy
import pytest
import torch

from veles_tpu_torch.observe import history as history_mod
from veles_tpu_torch.observe.history import (
    AnomalyRule, IncidentRecorder, MetricHistory, default_rules,
    incident_main, parse_history_spec, render_incident, sparkline,
    stop_history_sampler)
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _config(cfg):
    return None if cfg is None else {k: getattr(cfg, k) for k in (
        "interval_s", "capacity", "series_cap", "seed_rules",
        "incident_cooldown_s")}


@pytest.mark.parametrize("spec", [
    None, "", "off", "on", True, False, "interval_s=0.2",
    "interval_s=2,capacity=16,series_cap=8,seed_rules=0",
    {"incident_cooldown_s": "5", "enabled": "yes"}, "enabled=0"])
def test_config_parses_as_jax(spec):
    from veles_tpu.observe.history import parse_history_spec as jax_parse

    assert _config(parse_history_spec(spec)) == _config(jax_parse(spec))


@pytest.mark.parametrize("spec", [
    "interval_s=0", "capacity=1", "bogus=1", "interval_s", "seed_rules=2",
    "capacity=x", 3.5])
def test_bad_specs_fail_with_jax_messages(spec):
    from veles_tpu.observe.history import parse_history_spec as jax_parse

    with pytest.raises(ValueError) as port:
        parse_history_spec(spec, flag="--serve-history")
    with pytest.raises(ValueError) as jax:
        jax_parse(spec, flag="--serve-history")
    assert str(port.value) == str(jax.value)


def _rows(rng, step, storm_name):
    """One sample pass's registry rows: a latency gauge ramping up, a burn
    rate, a counter (stored as a rate), an MFU dropping, a tenant slice
    and a storm counter that jumps once."""
    ttft = 50.0 + 40.0 * step + float(rng.rand())
    burn = 0.5 if step < 6 else 4.0 + float(rng.rand())
    return [
        ("veles_serving_latency_ms", "gauge",
         (("api", "generate-api"), ("kind", "ttft"), ("quantile", "p95")),
         ttft),
        ("veles_slo_burn_rate", "gauge",
         (("objective", "ttft_p95_ms"), ("window", "60s")), burn),
        ("veles_slo_burn_rate", "gauge",
         (("objective", "ttft_p95_ms"), ("tenant", "a"),
          ("window", "60s")), 9.0),
        ("veles_decode_tokens_total", "counter", (),
         100 * step + int(rng.randint(0, 50))),
        ("veles_mfu_ratio", "gauge", (("program", "paged.dispatch"),),
         0.3 if step < 5 else 0.05),
        (storm_name, "counter", (("kernel", "k.cu"),),
         0 if step < 8 else 1),
    ]


def _drive(history, storm_name, tmp=None):
    rng = numpy.random.RandomState(7)
    history.rules = [
        AnomalyRule("ttft_p95_high", "veles_serving_latency_ms",
                    match={"kind": "ttft", "quantile": "p95"},
                    kind="threshold", op=">=", threshold=150.0,
                    for_samples=1, cooldown_s=0.0),
        AnomalyRule("slo_burn", "veles_slo_burn_rate", kind="threshold",
                    op=">=", threshold=2.0, for_samples=2, cooldown_s=0.0),
        AnomalyRule("mfu_collapse", "veles_mfu_ratio", kind="drop",
                    drop_frac=0.5, window_s=3.0, baseline_s=6.0,
                    for_samples=2, cooldown_s=0.0),
        AnomalyRule("storm", storm_name, kind="threshold", op=">=",
                    threshold=0.01, for_samples=1, cooldown_s=0.0),
    ]
    history.incidents.cooldown_s = 0.0
    docs = []
    for step in range(12):
        history.sample(now=100.0 + step, rows=_rows(rng, step, storm_name))
        if history.incidents.last_doc is not None:
            docs.append(history.incidents.last_doc)
            history.incidents.last_doc = None
    return docs


def _doc_view(doc, storm_name):
    """An incident with the storm family's name (the one the packages
    name differently) replaced, its series in name order again."""
    text = json.dumps({k: doc[k] for k in (
        "reason", "trigger", "breaching", "leading_indicator",
        "window_s", "history")}, sort_keys=True)
    view = json.loads(text.replace(storm_name, "STORM"))
    view["history"]["incidents"].pop("last_path")   # each its own dir
    view["history"]["series"].sort(key=lambda r: (r["name"],
                                                  sorted(r["labels"])))
    return view


def test_rates_rules_and_incidents_equal_jax(tmp_path):
    from veles_tpu.observe.history import (
        IncidentRecorder as JaxRecorder, MetricHistory as JaxHistory)
    from veles_tpu.observe.metrics import MetricsRegistry as JaxRegistry

    jax = JaxHistory(registry=JaxRegistry(), capacity=8,
                     incidents=JaxRecorder(directory=str(tmp_path / "j")))
    port = MetricHistory(registry=MetricsRegistry(), capacity=8,
                         incidents=IncidentRecorder(
                             directory=str(tmp_path / "p")))
    jdocs = _drive(jax, "veles_xla_recompile_storms_total")
    docs = _drive(port, "veles_kernel_rebuild_storms_total")
    assert len(docs) == len(jdocs) >= 3
    for doc, jdoc in zip(docs, jdocs):
        assert _doc_view(doc, "veles_kernel_rebuild_storms_total") \
            == _doc_view(jdoc, "veles_xla_recompile_storms_total")
    assert [r.state() for r in port.rules][:3] \
        == [r.state() for r in jax.rules][:3]
    assert _doc_view({"reason": 0, "trigger": 0, "breaching": 0,
                      "leading_indicator": 0, "window_s": 0,
                      "history": port.debug_snapshot(now=111.0)},
                     "veles_kernel_rebuild_storms_total") \
        == _doc_view({"reason": 0, "trigger": 0, "breaching": 0,
                      "leading_indicator": 0, "window_s": 0,
                      "history": jax.debug_snapshot(now=111.0)},
                     "veles_xla_recompile_storms_total")
    tokens = port.get("veles_decode_tokens_total")
    assert all(v > 0 for v in tokens.values)   # a counter stores rates
    assert port.dashboard_cells() == jax.dashboard_cells()
    assert port.fleet_summary(now=111.0) == jax.fleet_summary(now=111.0)
    lead = docs[-1]["leading_indicator"]
    assert lead["series"] == "veles_serving_latency_ms"
    reasons = [d["reason"] for d in docs]
    assert "ttft_p95_high" in reasons and "storm" in reasons


def test_ingest_summary_and_sparklines_equal_jax():
    from veles_tpu.observe.history import MetricHistory as JaxHistory
    from veles_tpu.observe.history import sparkline as jax_sparkline
    from veles_tpu.observe.metrics import MetricsRegistry as JaxRegistry

    rows = [["veles_ctrl_burn_rate", [["objective", "a"]], [2.0, 1.0, 0.0],
             [1.0, 3.0, 2.0]],
            ["bad name", [], [0.0], [1.0]],
            ["veles_kv_pages_free", [["slave", "x"], ["bad-label", 1]],
             [0.5], [7.0]], "garbage"]
    port = MetricHistory(registry=MetricsRegistry())
    jax = JaxHistory(registry=JaxRegistry())
    assert port.ingest_summary("s1", rows, now=50.0) \
        == jax.ingest_summary("s1", rows, now=50.0) == 2
    assert port.debug_snapshot(now=50.0) == jax.debug_snapshot(now=50.0)
    for values in ([], [1.0], [3.0, 3.0], [1, 5, 2, 8, 3], range(40)):
        assert sparkline(values) == jax_sparkline(values)


def test_incident_render_and_cli_equal_jax(tmp_path, capsys):
    from veles_tpu.observe.history import incident_main as jax_main
    from veles_tpu_torch.__main__ import main

    port = MetricHistory(registry=MetricsRegistry(), incidents=(
        IncidentRecorder(directory=str(tmp_path))))
    _drive(port, "veles_kernel_rebuild_storms_total")
    path = port.incidents.last_path
    doc = json.loads(open(path).read())
    doc["requests"] = {"slowest": [{
        "id": 1, "rid": 0, "stages": [["staged", 1.0], ["resolved", 2.0]],
        "chunks": [], "tokens": 0, "wall_ms": 1000.0}]}
    doc["governor"] = [{"kind": "governor", "action": "demote",
                        "tier": "int8", "burn": 3.0}]
    doc["compile_windows"] = [["paged_attention.cu", 4000.0]]
    with open(path, "w") as fout:
        json.dump(doc, fout)
    assert main(["observe", "incident", path]) == 0
    out = capsys.readouterr().out
    assert jax_main(path) == 0
    assert out == capsys.readouterr().out
    assert "leading indicator: ttft_p95_high (veles_serving_latency_ms" \
        in out and "governor actuations:" in out
    assert incident_main(str(tmp_path)) == 0
    assert "leading indicator:" in capsys.readouterr().out
    assert incident_main(str(tmp_path / "missing.json")) == 1
    assert render_incident(doc) == __import__(
        "veles_tpu.observe.history", fromlist=["render_incident"]
    ).render_incident(doc)


def _port_families():
    """Every metric family the port's code writes, and the control series
    it records into the history."""
    from veles_tpu.analyze.rules import iter_metric_calls

    names = set()
    for path in glob.glob(os.path.join(REPO, "veles_tpu_torch", "**",
                                       "*.py"), recursive=True):
        with open(path) as fin:
            source = fin.read()
        tree = ast.parse(source)
        for _, _, name, _, _ in iter_metric_calls(tree):
            names.add(name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "attr", "") == "record_control" \
                    and node.args and isinstance(node.args[0],
                                                 ast.Constant):
                names.add(node.args[0].value)
    return names


def test_every_seed_rule_watches_a_family_the_port_publishes():
    from veles_tpu.observe.history import default_rules as jax_rules
    from veles_tpu_torch.observe.xla_stats import DIFFERING_FAMILIES

    families = _port_families()
    rules = default_rules()
    assert [r.name for r in rules] == [r.name for r in jax_rules()]
    for rule, jrule in zip(rules, jax_rules()):
        assert rule.series in families, rule.series
        assert rule.series == DIFFERING_FAMILIES.get(jrule.series,
                                                     jrule.series)
        assert rule.state() == dict(jrule.state(), series=rule.series)
    assert {r.name: r.series for r in rules}["compile_storm"] \
        == "veles_kernel_rebuild_storms_total"


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read().decode())


def _post(url, body, headers):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"}, **headers))
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())


def _sampler_threads():
    """The port's sampler thread while it runs (the JAX package's, which a
    JAX test in this process may have started, has the same name)."""
    return [t for t in threading.enumerate()
            if t is history_mod._sampler_thread]


def test_sampler_runs_with_the_front_and_stops_with_it(monkeypatch):
    """A front started with the history on starts the sampler; stopping
    the last front stops it. A disabled history answers 404."""
    from veles_tpu_torch.core import httpd
    from veles_tpu_torch.serving import GenerateAPI

    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, 1, 8, 2, 7, device="cpu")
    table = torch.from_numpy(rng.randn(7, 8).astype(numpy.float32))
    apis = [GenerateAPI(params, table, 2, slots=1, max_len=16, n_tokens=2,
                        device="cpu").start() for _ in range(2)]
    try:
        assert len(_sampler_threads()) == 1
        apis[0].stop()
        assert len(_sampler_threads()) == 1
    finally:
        for api in apis:
            api.stop()
    assert _sampler_threads() == []
    monkeypatch.setattr(history_mod, "_history", None)

    class Handler:
        path = "/debug/history"
        sent = []
    codes = []
    monkeypatch.setattr(httpd, "reply", lambda h, body, code=200, **kw:
                        codes.append(code))
    assert httpd.serve_debug_history(Handler())
    assert codes == [404]


def test_a_served_burst_names_the_latency_gauge_as_leading(tmp_path,
                                                           monkeypatch):
    """With an unmeetable ttft objective and a tight rule pair, a served
    burst sampled by hand fires an incident whose leading indicator is
    ``veles_serving_latency_ms`` against the ``slo_burn`` reference;
    ``/debug/history?series=`` filters, and ``observe incident`` reads
    the artifact."""
    from veles_tpu_torch.observe.metrics import get_metrics_registry
    from veles_tpu_torch.observe.reqledger import RequestLedger
    from veles_tpu_torch.observe.slo import SLOEngine
    from veles_tpu_torch.serving import GenerateAPI

    history = MetricHistory(
        registry=get_metrics_registry(), interval_s=30.0,
        incidents=IncidentRecorder(cooldown_s=0.0,
                                   directory=str(tmp_path)))
    monkeypatch.setattr(history_mod, "_history", history)
    # the waste autopsy's own rules stay out of the pair: their first
    # evaluation waits for more dispatched tokens than a test sends
    from veles_tpu_torch.observe import servescope
    monkeypatch.setattr(servescope, "MIN_EVAL_TOKENS", 1 << 62)
    history.rules = [
        AnomalyRule("ttft_p95_high", "veles_serving_latency_ms",
                    match={"kind": "ttft", "quantile": "p95"},
                    kind="threshold", op=">=", threshold=0.0,
                    for_samples=1, cooldown_s=0.0),
        AnomalyRule("slo_burn", "veles_slo_burn_rate", kind="threshold",
                    op=">=", threshold=2.0, for_samples=2,
                    cooldown_s=0.0)]
    rng = numpy.random.RandomState(3)
    params = init_transformer_params(rng, 1, 8, 2, 7, device="cpu")
    table = torch.from_numpy(rng.randn(7, 8).astype(numpy.float32))
    api = GenerateAPI(params, table, 2, slots=2, max_len=16, n_tokens=3,
                      slo=SLOEngine("ttft_p95_ms=0.001"),
                      ledger=RequestLedger(), device="cpu").start()
    try:
        url = "http://127.0.0.1:%d" % api.port
        for i in range(6):
            _post(url + "/generate", {"tokens": [1, 2, i % 7]}, {})
            history.sample()
        payload = _get(url + "/debug/history?series="
                       "veles_serving_latency_ms")
    finally:
        api.stop()
    assert payload["series"] and {row["name"] for row in
                                  payload["series"]} \
        == {"veles_serving_latency_ms"}
    doc = history.incidents.last_doc
    lead = doc["leading_indicator"]
    assert doc["reason"] == "slo_burn"
    assert lead["series"] == "veles_serving_latency_ms"
    assert lead["reference"] == "slo_burn" and lead["lead_ms"] >= 0
    assert incident_main(history.incidents.last_path) == 0


def test_observe_cost_reads_the_hooks_settings(monkeypatch, capsys):
    """``scripts/observe_cost.py``'s ``ledger_off`` (the ledger and the
    scope off) and ``history`` (the sampler at its 1 s default) settings
    on a narrow model on the CPU: one line a run, the medians, the planes
    put back and no sampler left running."""
    import re

    from veles_tpu_torch.observe.flight import get_flight_recorder
    from veles_tpu_torch.observe.metrics import get_metrics_registry
    from veles_tpu_torch.observe.reqledger import get_request_ledger
    from veles_tpu_torch.observe.servescope import get_serve_scope
    from veles_tpu_torch.observe.tracing import get_tracer
    from veles_tpu_torch.observe.xla_stats import get_compile_tracker
    from veles_tpu_torch.scripts import observe_cost

    for plane in (get_flight_recorder(), get_compile_tracker(),
                  get_metrics_registry(), get_tracer(),
                  get_request_ledger(), get_serve_scope()):
        monkeypatch.setattr(plane, "enabled", plane.enabled)
    seen = []
    real = observe_cost.set_planes

    def spy(setting):
        real(setting)
        seen.append((setting, get_request_ledger().enabled,
                     get_serve_scope().enabled,
                     history_mod.get_metric_history() is not None,
                     bool(_sampler_threads())))
    monkeypatch.setattr(observe_cost, "set_planes", spy)
    assert observe_cost.main(["--small", "--device", "cpu", "--reps", "1",
                              "--settings", "ledger_off,history"]) == 0
    out = capsys.readouterr().out
    runs = re.findall(r"^setting=(\w+) tokens_s=([\d.]+) .* chunks=(\d+)",
                      out, re.M)
    assert sorted(r[0] for r in runs) == ["history", "ledger_off"]
    assert all(float(rate) > 0 for _, rate, _ in runs)
    assert ("ledger_off", False, False, False, False) in seen
    assert ("history", True, True, True, True) in seen
    assert history_mod.get_metric_history() is None
    assert _sampler_threads() == []
