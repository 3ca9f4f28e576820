"""The port's observe plane (veles_tpu_torch/observe/, core/httpd.py's
metrics routes and the serving hooks) against tests/test_observe.py's
contracts and the JAX package itself, on the CPU.

Held equal to the JAX package: the exposition text for the same registry
writes (plain and OpenMetrics), the Chrome trace of one events file, and
a traced request through both packages' ``GenerateAPI``: the request
and token counters (``veles_serving_requests_total`` by outcome,
``veles_decode_tokens_total``) are compared exactly, and each request's
span tree by its names and parent shape; the dispatch counts are not
compared (the port's admission is ragged). The device-truth families
that differ from the JAX package's are pinned by name."""

import ast
import glob
import json
import logging
import os
import re
import threading
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu_torch.core import logger as logger_mod
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.logger import EventRecorder
from veles_tpu_torch.observe import xla_stats
from veles_tpu_torch.observe.metrics import (MetricsRegistry, bridge,
                                             get_metrics_registry)
from veles_tpu_torch.observe.trace_export import (chrome_trace,
                                                  export_chrome_trace,
                                                  load_events, span_tree)
from veles_tpu_torch.observe.tracing import (NULL_SPAN, Tracer, get_tracer,
                                             parse_trace_header)
from veles_tpu_torch.observe.xla_stats import (CompileTracker,
                                               get_compile_tracker,
                                               instrument)
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def get(url, headers=None, timeout=30):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode(), dict(resp.headers)


def post(url, payload, headers=None, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode()), dict(resp.headers)


def _writes(registry):
    """One fixed set of writes: labels with every escape, a histogram
    with exemplars (one oversized, dropped), a gauge family, a counter
    set absolutely and a kind collision."""
    registry.incr("veles_req_total", 3, labels={"path": 'a"b\\c\nd'},
                  help="requests\nby path")
    registry.incr("veles_req_total", labels={"path": "/x"})
    registry.set("veles_up", 1, help="liveness")
    registry.set("veles_ratio", 0.125, labels={"api": "a"})
    registry.counter_set("veles_abs_total", 1e16)
    registry.set_gauge_family("veles_fam", [({"k": "1"}, 2.5),
                                            ({"k": "2"}, float("nan"))])
    for value, trace in ((0.0004, "ab12"), (0.03, "cd34"),
                         (5.0, "ef56"), (0.02, "x" * 200)):
        registry.observe("veles_lat_seconds", value,
                         buckets=(0.01, 0.1, 1.0),
                         labels={"kind": "cold"},
                         exemplar={"trace_id": trace})
    registry.observe("veles_lat_seconds", 0.5)   # the family's buckets
    registry.incr("veles_lat_seconds")           # dropped: a histogram


@pytest.fixture
def fixed_clock(monkeypatch):
    """One wall clock for both packages' exemplar stamps."""
    import time as time_mod

    monkeypatch.setattr(time_mod, "time", lambda: 1700000000.25)


@pytest.mark.parametrize("openmetrics", [False, True])
def test_exposition_equals_jax(openmetrics, fixed_clock):
    from veles_tpu.observe.metrics import MetricsRegistry as JaxRegistry

    port, jax_registry = MetricsRegistry(enabled=True), \
        JaxRegistry(enabled=True)
    _writes(port)
    _writes(jax_registry)
    text = port.expose(openmetrics=openmetrics)
    assert text == jax_registry.expose(openmetrics=openmetrics)
    # as JSON: the NaN gauge compares unequal to itself
    assert json.dumps(port.snapshot()) == json.dumps(jax_registry.snapshot())
    assert ('veles_lat_seconds_bucket{kind="cold",le="0.01"} 1'
            in text)
    assert (' # {trace_id="ab12"}' in text) == openmetrics


def test_concurrent_counters_exact():
    registry = MetricsRegistry(enabled=True)
    threads_n, per_thread = 8, 1000

    def work(i):
        for _ in range(per_thread):
            registry.incr("veles_test_total")
            registry.incr("veles_test_labeled_total", 2,
                          labels={"worker": str(i % 2)})
            registry.observe("veles_test_seconds", 0.01,
                             buckets=(0.005, 0.05))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(threads_n)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
    assert not any(thread.is_alive() for thread in threads)
    text = registry.expose()
    assert "veles_test_total %d" % (threads_n * per_thread) in text
    for worker in ("0", "1"):
        assert ('veles_test_labeled_total{worker="%s"} %d'
                % (worker, threads_n // 2 * per_thread * 2)) in text
    assert "veles_test_seconds_count %d" % (threads_n * per_thread) in text


def test_bridge_unregisters_dead_source():
    import gc

    registry = MetricsRegistry(enabled=True)

    class Source:
        pass

    source = Source()
    bridge(registry, source, lambda reg, live: reg.set("veles_src_up", 1))
    assert "veles_src_up 1" in registry.expose()
    assert len(registry._collectors) == 1
    del source
    gc.collect()
    registry.expose()
    assert registry._collectors == []


def test_broken_collector_is_kept_and_reported_once(caplog):
    registry = MetricsRegistry(enabled=True)
    registry.add_collector(lambda: 1 / 0)
    registry.incr("veles_ok_total")
    with caplog.at_level(logging.ERROR, logger="MetricsRegistry"):
        assert "veles_ok_total 1" in registry.expose()
        assert "veles_ok_total 1" in registry.expose()
    assert len([r for r in caplog.records
                if "collector failed" in r.getMessage()]) == 1
    assert len(registry._collectors) == 1


def test_kind_collision_drops_the_write():
    registry = MetricsRegistry(enabled=True)
    registry.observe("veles_h_seconds", 0.1, buckets=(1.0,))
    registry.counter_set("veles_h_seconds", 7)
    registry.incr("veles_h_seconds")
    registry.set("veles_h_seconds", 3)
    registry.observe("veles_c_total", 0.5, buckets=(1.0,))
    registry.incr("veles_c_total", 2)
    text = registry.expose()
    assert "veles_h_seconds_count 1" in text
    assert "veles_c_total_count 1" in text
    assert "\nveles_c_total 2" not in text


def test_exemplars_only_on_buckets_and_bounded():
    from veles_tpu_torch.observe.metrics import EXEMPLAR_MAX_RUNES

    registry = MetricsRegistry(enabled=True)
    registry.observe("veles_ex_seconds", 0.003, buckets=(0.005, 0.01),
                     exemplar={"trace_id": "abc123"})
    registry.observe("veles_ex_seconds", 99.0, buckets=(0.005, 0.01),
                     exemplar={"trace_id": "x" * EXEMPLAR_MAX_RUNES})
    registry.observe("veles_ex_seconds", 0.007, buckets=(0.005, 0.01),
                     exemplar={"le": "1"})
    registry.incr("veles_ex_total", 2)
    text = registry.expose(openmetrics=True)
    lines = [line for line in text.splitlines() if " # {" in line]
    assert len(lines) == 1 and lines[0].startswith(
        'veles_ex_seconds_bucket{le="0.005"} 1 # {trace_id="abc123"}')
    assert "# TYPE veles_ex counter" in text
    assert text.endswith("# EOF\n")
    assert "veles_ex_seconds_count 3" in text
    plain = registry.expose()
    assert " # {" not in plain and "# EOF" not in plain
    assert "# TYPE veles_ex_total counter" in plain


def test_prune_label_retires_series():
    registry = MetricsRegistry(enabled=True)
    for slave in ("a", "b"):
        registry.set("veles_s", 1, labels={"slave": slave})
    registry.set("veles_only_b", 1, labels={"slave": "b"})
    registry.prune_label("slave", {"a"})
    text = registry.expose()
    assert 'veles_s{slave="a"} 1' in text and 'slave="b"' not in text
    assert "veles_only_b" not in text


# -- naming ------------------------------------------------------------------

def _family_names(package):
    from veles_tpu.analyze.rules import iter_metric_calls

    names = set()
    for path in glob.glob(os.path.join(REPO, package, "**", "*.py"),
                          recursive=True):
        with open(path) as fin:
            tree = ast.parse(fin.read())
        for _, _, name, _, _ in iter_metric_calls(tree):
            names.add(name)
    return names


def test_naming_conventions_hold_in_the_port():
    """The JAX package's metric rules (``metric.naming``,
    ``metric.help``) find nothing in the port, and the scan is not
    vacuous."""
    from veles_tpu.analyze import run_analysis

    findings, errors = run_analysis(
        [os.path.join(REPO, "veles_tpu_torch")], rule_filter="metric")
    assert not errors
    assert findings == [], [f.message for f in findings]
    names = _family_names("veles_tpu_torch")
    for name in ("veles_serving_requests_total", "veles_kernel_builds_total",
                 "veles_device_memory_bytes", "veles_mfu_ratio"):
        assert name in names


def test_the_families_that_differ_from_jax_are_pinned():
    """Every family the port publishes is the JAX package's, but the
    device-truth renames and additions of ``xla_stats``; of the JAX
    package's device-truth families only the listed ones are missing."""
    port, jax_names = (_family_names("veles_tpu_torch"),
                       _family_names("veles_tpu"))
    renamed = {v for v in xla_stats.DIFFERING_FAMILIES.values() if v}
    assert port - jax_names == renamed | set(xla_stats.PORT_FAMILIES)
    assert xla_stats.DIFFERING_FAMILIES == {
        "veles_xla_compiles_total": "veles_kernel_builds_total",
        "veles_xla_compile_seconds_total":
            "veles_kernel_build_seconds_total",
        "veles_xla_cache_hits_total": "veles_kernel_loads_total",
        "veles_xla_recompile_storms_total":
            "veles_kernel_rebuild_storms_total",
        "veles_xla_program_flops": "veles_program_flops"}
    assert set(xla_stats.DIFFERING_FAMILIES) <= jax_names
    assert not set(xla_stats.DIFFERING_FAMILIES) & port
    kept = {"veles_device_memory_bytes", "veles_device_memory_limit_bytes",
            "veles_device_peak_bf16_tflops", "veles_mfu_ratio",
            "veles_program_flops_per_second",
            "veles_serving_requests_total", "veles_decode_tokens_total",
            "veles_decode_dispatch_seconds", "veles_request_ttft_seconds",
            "veles_mesh_axis_size", "veles_mesh_devices",
            "veles_fleet_reduce_steps_total",
            "veles_fleet_reduce_bytes_total", "veles_fleet_reduce_seconds",
            "veles_fleet_chip_idle_fraction"}
    assert kept <= port & jax_names


# -- the overhead guard -------------------------------------------------------

def _toy(seed=0, blocks=1, embed=8, heads=2, vocab=7):
    rng = numpy.random.RandomState(seed)
    params = init_transformer_params(rng, blocks, embed, heads, vocab,
                                     device="cpu")
    table = torch.from_numpy(
        rng.randn(vocab, embed).astype(numpy.float32) * 0.3)
    return params, table, heads


def test_disabled_tracer_returns_the_shared_null_span():
    tracer = Tracer(enabled=False)
    spans = {id(tracer.span("a")), id(tracer.span("b", x=1)),
             id(tracer.event("c"))}
    assert spans == {id(NULL_SPAN)}
    with tracer.span("a") as span:
        assert span is NULL_SPAN and span.context() is None


def test_disabled_registry_mutates_nothing():
    registry = MetricsRegistry(enabled=False)
    ran = []
    registry.add_collector(lambda: ran.append(1))
    registry.incr("veles_x_total")
    registry.set("veles_g", 2)
    registry.observe("veles_h_seconds", 0.1)
    registry.counter_set("veles_c_total", 9)
    registry.set_gauge_family("veles_f", [({"a": "1"}, 1)])
    assert registry._families == {}
    assert registry.sample() == () and ran == []


@pytest.mark.parametrize("paged", [False, True])
def test_decoder_disabled_path_allocates_no_span(paged):
    from veles_tpu_torch.observe.flight import FlightRecorder
    from veles_tpu_torch.serving import ContinuousDecoder

    params, table, heads = _toy()
    dec = ContinuousDecoder(params, table, heads, slots=1, max_len=32,
                            n_tokens=2, paged=paged, page_size=8,
                            device="cpu")
    dec._tracer = Tracer(enabled=False)
    dec.metrics = MetricsRegistry(enabled=False)
    dec._xla = CompileTracker(enabled=False)
    dec.flight = FlightRecorder(capacity=4)
    assert dec._span("decode.dispatch", [0]) is NULL_SPAN
    dec.submit([1, 2])
    dec.run_until_drained(max_steps=8, chunk=2)
    assert dec.metrics._families == {}
    assert dec._xla.snapshot()["flops"] == {}
    # the default-on ring recorded the dispatch path, bounded
    assert "admit" in {e["kind"] for e in dec.flight.entries()}
    assert len(dec.flight.entries()) <= 4


def test_instrument_on_a_disabled_tracker_is_pure_delegation(monkeypatch):
    tracker = CompileTracker(enabled=False)
    monkeypatch.setattr(xla_stats, "_tracker", tracker)
    fn = instrument("veles_test_prog", lambda x: x + 1)
    assert fn(torch.ones(3)).sum().item() == 6.0
    assert fn.program_name == "veles_test_prog"
    assert tracker.snapshot()["calls"] == {}
    tracker.enable()
    inner = instrument("inner", lambda x: x * 2)
    outer = instrument("outer", lambda x: inner(x) + 1)
    assert outer(torch.ones(2)).sum().item() == 6.0
    # a program called inside another is part of its caller
    assert tracker.snapshot()["calls"] == {"outer": 1}


def test_serving_programs_carry_the_jax_names():
    from veles_tpu_torch.parallel import decode, kv_pool

    names = {fn.program_name for fn in (
        decode.generate, decode.slot_admit_many, decode.slot_step,
        decode.slot_step_many, kv_pool.paged_admit_many,
        kv_pool.paged_admit_tail, kv_pool.paged_admit_hit,
        kv_pool.paged_slot_step, kv_pool.paged_slot_step_many,
        kv_pool._paged_restore)}
    assert names == {"decode.generate", "decode.admit", "decode.step",
                     "decode.dispatch", "paged.admit", "paged.admit_tail",
                     "paged.admit_hit", "paged.step", "paged.dispatch",
                     "paged.restore"}


# -- the compile tracker ------------------------------------------------------

def test_rebuild_storm_detected_and_warned_once(caplog):
    tracker = CompileTracker(enabled=False)
    with caplog.at_level(logging.WARNING, logger="CompileTracker"):
        for _ in range(2 * tracker.STORM_THRESHOLD):
            tracker.record_compile("paged_attention.cu", 0.01)
    assert tracker._storms == {"paged_attention.cu": 2}
    assert len([r for r in caplog.records
                if "rebuild storm" in r.getMessage()]) == 1
    registry = MetricsRegistry(enabled=True)
    tracker.publish(registry)
    text = registry.expose()
    assert ('veles_kernel_builds_total{kernel="paged_attention.cu"} 10'
            in text)
    assert ('veles_kernel_rebuild_storms_total'
            '{kernel="paged_attention.cu"} 2') in text


def test_mfu_from_program_flops_and_the_step_ema(monkeypatch):
    tracker = CompileTracker(enabled=True)
    tracker.set_program_flops("prog", 2e9)
    tracker.observe_step("prog", 0.01)   # 200 GFLOP/s
    monkeypatch.setattr(root.common.observe, "peak_tflops", 1.0,
                        raising=False)
    registry = MetricsRegistry(enabled=True)
    tracker.publish(registry)
    text = registry.expose()
    assert 'veles_program_flops{program="prog"} 2000000000' in text
    assert 'veles_mfu_ratio{program="prog"} 0.2' in text
    assert tracker.snapshot()["mfu"]["prog"]["mfu"] == pytest.approx(0.2)


def test_peak_tflops_by_device_name(monkeypatch):
    monkeypatch.setattr(root.common.observe, "peak_tflops", None,
                        raising=False)
    assert xla_stats.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert xla_stats.peak_tflops("NVIDIA H100 PCIe") == 756.0
    assert xla_stats.peak_tflops("some CPU") is None


def test_kernel_builds_book_while_the_tracker_is_off(tmp_path,
                                                     monkeypatch):
    """``ops/_build.build`` reports each source it compiles, with its
    seconds, to the tracker even while it is disabled (a stand-in
    compiler writes the library)."""
    from veles_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "touch \"$2\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    tracker = CompileTracker(enabled=False)
    monkeypatch.setattr(xla_stats, "_tracker", tracker)
    monkeypatch.setattr(_build, "get_compile_tracker", lambda: tracker)
    _build.build(("int8_matmul", "paged_attention"))
    _build.build(("int8_matmul",))   # built: nothing to do
    snap = tracker.snapshot()
    assert snap["compiles"] == {"int8_matmul.cu": 1,
                                "paged_attention.cu": 1}
    assert all(s >= 0 for s in snap["compile_seconds"].values())


def test_device_memory_on_the_cpu_counts_the_decoders_bytes():
    from veles_tpu_torch.parallel.decode import slot_state_bytes
    from veles_tpu_torch.serving import ContinuousDecoder, _tree_bytes

    params, table, heads = _toy()
    dec = ContinuousDecoder(params, table, heads, slots=2, max_len=32,
                            device="cpu")
    registry = MetricsRegistry(enabled=True)
    xla_stats.publish_device_stats(registry)
    value = re.search(r'veles_device_memory_bytes\{device="cpu",'
                      r'kind="live_bytes"\} (\d+)', registry.expose())
    held = _tree_bytes((dec.params, dec.embed_table)) \
        + slot_state_bytes(dec.state)
    assert value is not None and int(value.group(1)) >= held


# -- the trace exporter -------------------------------------------------------

def _traced_events(tmp_path):
    """An events file from the port's tracer (a request span with
    children on two threads and an instant), plus a legacy event, an
    unpaired begin and a torn last line."""
    path = str(tmp_path / "events.jsonl")
    recorder = EventRecorder()
    recorder.open(path)
    saved = logger_mod._event_recorder
    logger_mod._event_recorder = recorder
    try:
        tracer = Tracer(enabled=True)
        with tracer.span("serve.request", rid=1) as root_span:
            ctx = root_span.context()
            done = threading.Event()

            def driver():
                with tracer.span("decode.dispatch", parent=ctx, chunk=2):
                    pass
                tracer.event("serve.complete", parent=ctx, tokens=4)
                done.set()

            threading.Thread(target=driver).start()
            assert done.wait(10)
        recorder.record(name="epoch", etype="single", source="Loader")
        tracer.span("crashed").__enter__()
    finally:
        logger_mod._event_recorder = saved
        recorder.close()
    with open(path, "a") as fout:
        fout.write('{"name": "torn", "etype": "be')
    return path


def test_chrome_export_equals_jax(tmp_path):
    from veles_tpu.observe.trace_export import chrome_trace as jax_chrome

    path = _traced_events(tmp_path)
    events = load_events(path)
    assert "torn" not in {e.get("name") for e in events}
    ours = chrome_trace(events, process_names={os.getpid(): "port"})
    assert ours == jax_chrome(events, process_names={os.getpid(): "port"})
    out = str(tmp_path / "trace.json")
    assert export_chrome_trace(path, out) == len(ours["traceEvents"])
    (trace_id, tree), = [(k, v) for k, v in span_tree(ours).items()
                         if len(v) > 1]
    names = {e["args"]["span_id"]: e["name"] for e in ours["traceEvents"]
             if e["args"].get("trace_id") == trace_id}
    root_id = next(s for s, n in names.items() if n == "serve.request")
    assert tree[root_id] is None
    assert {names[s] for s, p in tree.items() if p == root_id} == {
        "decode.dispatch", "serve.complete"}
    phases = {e["name"]: e["ph"] for e in ours["traceEvents"]}
    assert phases["crashed"] == "B" and phases["epoch"] == "i"


def test_torn_lines_are_skipped(tmp_path):
    src = tmp_path / "events.jsonl"
    src.write_text('{"name": "ok", "etype": "single"}\n[1, 2]\n{"trunc')
    assert [e["name"] for e in load_events(str(src))] == ["ok"]


def test_observe_cli_exports_a_trace(tmp_path, capsys):
    from veles_tpu_torch.__main__ import main

    path = _traced_events(tmp_path)
    out = str(tmp_path / "t.json")
    assert main(["observe", "export-trace", path, "-o", out]) == 0
    assert "trace events to" in capsys.readouterr().out
    assert json.loads(open(out).read())["displayTimeUnit"] == "ms"


@pytest.mark.parametrize("command,item", [
    ("fleet-trace", "ROADMAP A9")])
def test_observe_subcommands_not_ported_exit_2(command, item, capsys):
    """No ``observe`` subcommand waits any more: ``fleet-trace`` came with
    the fleet (ROADMAP A9), so it runs (exit 1 on a missing artifact,
    tests/test_torch_fleetscope.py holds it) and never exits 2."""
    from veles_tpu_torch.__main__ import main
    from veles_tpu_torch.observe import trace_export

    assert not hasattr(trace_export, "DEFERRED")
    assert main(["observe", command, "x"]) == 1
    captured = capsys.readouterr()
    assert "not ported yet" not in captured.err
    assert "cannot load x" in captured.out


@pytest.fixture
def stub_front():
    """A stand-in serving front on localhost: ``POST /generate`` answers
    ``n_tokens`` tokens, ``GET /metrics`` an SLO burn of 0.5 and ``GET
    /debug/serve`` a dominant waste cause."""
    import http.server

    class Front(http.server.BaseHTTPRequestHandler):
        def _send(self, body, kind="application/json"):
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            payload = json.loads(self.rfile.read(int(
                self.headers["Content-Length"])))
            self._send(json.dumps({"tokens": [1] * payload["n_tokens"]}))

        def do_GET(self):
            if self.path.startswith("/metrics"):
                self._send('veles_slo_burn_rate{objective="ttft_p95_ms",'
                           'window="60s"} 0.5\n', "text/plain")
            elif self.path.startswith("/debug/serve"):
                self._send(json.dumps({"dominant_cause": "discard"}))
            else:
                self.send_error(404)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Front)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield "http://127.0.0.1:%d" % server.server_address[1]
    server.shutdown()
    server.server_close()


def _requests_payload(n=6):
    """A saved ``/debug/requests`` payload of ``n`` resolved rows."""
    from veles_tpu_torch.observe.reqledger import RequestLedger

    ledger = RequestLedger()
    for i in range(n):
        row = ledger.stage(api="generate-api", trace="t%d" % i,
                           tenant=("acme", "globex")[i % 2],
                           prompt_len=3, budget=2, bucket=16, deadline=9.0)
        ledger.note_admit(row, "cold")
        ledger.note_tokens(row, 2)
        ledger.resolve(row, "completed")
    return {"slowest": ledger.slowest(64), "inflight": []}


@pytest.mark.parametrize("command", ["record", "replay", "capacity",
                                     "regress"])
def test_observe_subcommands_run_on_saved_artifacts(command, tmp_path,
                                                    stub_front, capsys):
    """The four subcommands of what acts on the hooks run on saved
    artifacts (a /debug/requests payload, a trace, a capacity report);
    replay and capacity against a stand-in front."""
    from veles_tpu_torch.__main__ import main
    from veles_tpu_torch.observe.replay import record_from_snapshot

    requests = tmp_path / "requests.json"
    requests.write_text(json.dumps(_requests_payload()))
    trace = str(tmp_path / "t.jsonl")
    if command != "record":
        record_from_snapshot(_requests_payload(), trace)
    if command == "record":
        argv = ["record", str(requests), "-o", trace, "--salt", "s"]
    elif command == "replay":
        argv = ["replay", trace, "--live", stub_front, "--workers", "2"]
    elif command == "capacity":
        argv = ["capacity", trace, "--live", stub_front, "-o",
                str(tmp_path / "cap.json"), "--max-warp", "2",
                "--warp-step", "2", "--workers", "2"]
    else:
        assert main(["observe", "capacity", trace, "--live", stub_front,
                     "-o", str(tmp_path / "cap.json"), "--max-warp", "1",
                     "--workers", "2"]) == 0
        argv = ["regress", str(tmp_path / "cap.json"),
                str(tmp_path / "cap.json")]
    capsys.readouterr()
    assert main(["observe"] + argv) == 0
    out = capsys.readouterr().out
    if command == "record":
        assert "recorded 6 requests" in out
        assert "acme" not in open(trace).read()
    elif command == "replay":
        assert json.loads(out[out.index("{"):])["delivered_ratio"] == 1.0
    elif command == "capacity":
        doc = json.loads((tmp_path / "cap.json").read_text())
        assert doc["kind"] == "veles-capacity-report"
        assert "no breach up to x2.00" in out
    else:
        assert "0 regression(s)" in out


# -- the profiler window ------------------------------------------------------

def test_profile_window_names_the_spans_on_the_cpu(tmp_path):
    from veles_tpu_torch.observe.profile import profile_window

    tracer = get_tracer()
    was = (tracer.enabled, tracer.annotate_device)
    with profile_window(str(tmp_path)) as path:
        assert tracer.enabled and tracer.annotate_device
        with tracer.span("paged.dispatch"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tracer.enabled, tracer.annotate_device) == was
    events = json.loads(open(path).read())["traceEvents"]
    dispatch = [e for e in events if e.get("name") == "paged.dispatch"]
    matmul = [e for e in events if e.get("name") in ("aten::mm",
                                                     "aten::matmul")]
    assert dispatch and matmul
    inside = [m for m in matmul
              if dispatch[0]["ts"] <= m["ts"]
              and m["ts"] + m["dur"] <= dispatch[0]["ts"]
              + dispatch[0]["dur"]]
    assert inside


def test_profile_window_without_a_dir_is_a_no_op():
    from veles_tpu_torch.observe.profile import profile_window

    with profile_window(None) as path:
        assert path is None


# -- serving ------------------------------------------------------------------

@pytest.fixture
def observability(tmp_path, monkeypatch):
    """A fresh port EventRecorder (JSONL in tmp), the tracer on and the
    registry reset, restored afterwards."""
    events = str(tmp_path / "events.jsonl")
    recorder = EventRecorder()
    recorder.open(events)
    monkeypatch.setattr(logger_mod, "_event_recorder", recorder)
    tracer, registry = get_tracer(), get_metrics_registry()
    was = tracer.enabled, registry.enabled
    tracer.enable()
    registry.reset()
    registry.enable()
    yield events
    recorder.close()
    tracer.enabled = was[0]
    registry.reset()
    registry.enabled = was[1]


def _scrape_counters(text):
    """``veles_serving_requests_total`` by outcome and
    ``veles_decode_tokens_total`` from an exposition."""
    outcomes = dict(re.findall(
        r'veles_serving_requests_total\{api="generate-api",'
        r'outcome="(\w+)"\} (\d+)', text))
    tokens = re.search(r"^veles_decode_tokens_total (\d+)$", text, re.M)
    return outcomes, int(tokens.group(1)) if tokens else None


def _tree_shapes(trace, trace_ids):
    """Per trace id: the set of (span name, parent span name) pairs."""
    shapes = {}
    for trace_id in trace_ids:
        names = {e["args"]["span_id"]: e["name"]
                 for e in trace["traceEvents"]
                 if e.get("args", {}).get("trace_id") == trace_id}
        tree = span_tree(trace).get(trace_id, {})
        shapes[trace_id] = {(names[s], names.get(p, p))
                            for s, p in tree.items()}
    return shapes


SERVE_PROMPTS = ([1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 1, 2], [3])


def _serve_traced(api, events_path, tmp_path, label):
    url = "http://127.0.0.1:%d" % api.port
    ids = []
    for i, prompt in enumerate(SERVE_PROMPTS):
        trace = "%08x" % (0xc0ffee00 + i)
        body, headers = post(url + "/generate", {"tokens": prompt},
                             headers={"X-Veles-Trace": trace + "/ab12"})
        assert len(body["tokens"]) == 4
        echoed = parse_trace_header(headers.get("X-Veles-Trace"))
        assert echoed[0] == trace
        ids.append(trace)
    text, _ = get(url + "/metrics")
    out = str(tmp_path / ("%s.trace.json" % label))
    from veles_tpu.observe.trace_export import export_chrome_trace \
        as jax_export
    (jax_export if label == "jax" else export_chrome_trace)(
        events_path, out)
    return text, json.loads(open(out).read()), ids


@pytest.mark.parametrize("paged", [False, True])
def test_serving_counters_and_span_trees_equal_jax(paged, observability,
                                                   tmp_path, monkeypatch):
    import jax.numpy as jnp
    from veles_tpu.core import logger as jax_logger
    from veles_tpu.observe import history as jax_history
    from veles_tpu.observe.metrics import get_metrics_registry as jax_reg
    from veles_tpu.observe.tracing import get_tracer as jax_tracer
    from veles_tpu.observe.xla_stats import (
        get_compile_tracker as jax_compile_tracker)
    from veles_tpu.parallel.transformer_step import (
        init_transformer_params as jax_init)
    from veles_tpu.serving import GenerateAPI as JaxAPI
    from veles_tpu_torch.serving import GenerateAPI

    rng = numpy.random.RandomState(0)
    jparams = jax_init(rng, 2, 16, 4, 11)
    table = rng.randn(11, 16).astype(numpy.float32) * 0.3
    params = init_transformer_params(numpy.random.RandomState(0), 2, 16,
                                     4, 11, device="cpu")
    kwargs = dict(slots=2, max_len=32, n_tokens=4, chunk=2, paged=paged,
                  page_size=8, port=0)
    jax_events = str(tmp_path / "jax_events.jsonl")
    jrecorder = jax_logger.EventRecorder()
    jrecorder.open(jax_events)
    monkeypatch.setattr(jax_logger, "_event_recorder", jrecorder)
    jtracer, jregistry = jax_tracer(), jax_reg()
    monkeypatch.setattr(jtracer, "enabled", True)
    monkeypatch.setattr(jregistry, "enabled", jregistry.enabled)
    # the JAX front's start turns its compile tracker on and starts its
    # metric-history sampler: both are put back after the test
    monkeypatch.setattr(jax_compile_tracker(), "enabled",
                        jax_compile_tracker().enabled)
    sampling = jax_history._sampler_thread is not None
    jregistry.reset()
    results = {}
    for label, make in (
            ("jax", lambda: JaxAPI(jparams, jnp.asarray(table), 4,
                                   **kwargs)),
            ("port", lambda: GenerateAPI(params, torch.from_numpy(table),
                                         4, device="cpu", **kwargs))):
        api = make().start()
        try:
            results[label] = _serve_traced(
                api, jax_events if label == "jax" else observability,
                tmp_path, label)
        finally:
            api.stop()
    jrecorder.close()
    jregistry.reset()
    if not sampling:
        jax_history.stop_history_sampler()
    counters = {k: _scrape_counters(v[0]) for k, v in results.items()}
    assert counters["port"] == counters["jax"]
    assert counters["port"][0]["completed"] == str(len(SERVE_PROMPTS))
    assert counters["port"][1] == 4 * len(SERVE_PROMPTS)
    shapes = {k: _tree_shapes(v[1], v[2]) for k, v in results.items()}
    assert shapes["port"] == shapes["jax"]
    dispatch = "paged.dispatch" if paged else "decode.dispatch"
    admit = "paged.admit" if paged else "decode.admit"
    for shape in shapes["port"].values():
        assert {("serve.request", "ab12"), ("serve.submit", "serve.request"),
                (admit, "serve.request"), (dispatch, "serve.request"),
                ("decode.collect", "serve.request"),
                ("serve.complete", "serve.request")} <= shape


def test_metrics_route_device_truth_and_exemplars(observability,
                                                  monkeypatch):
    """``/metrics`` on the port's GenerateAPI: the decoder's histograms,
    the program call counters, the MFU of the dispatch from its analytic
    FLOPs and cadence, the memory family, and the latency exemplars
    carrying the trace id sent; ``/debug/`` lists the four surfaces."""
    from veles_tpu_torch.serving import GenerateAPI

    monkeypatch.setattr(root.common.observe, "peak_tflops", 0.001,
                        raising=False)
    params, table, heads = _toy(seed=3, blocks=1, embed=12, vocab=13)
    api = GenerateAPI(params, table, heads, slots=2, max_len=64,
                      n_tokens=6, chunk=2, device="cpu").start()
    try:
        url = "http://127.0.0.1:%d" % api.port
        body, _ = post(url + "/generate", {"tokens": [1, 2, 3, 4]},
                       headers={"X-Veles-Trace": "feed01/ab"})
        assert len(body["tokens"]) == 6
        text, headers = get(url + "/metrics")
        assert headers["Content-Type"].startswith("text/plain")
        om, om_headers = get(url + "/metrics", headers={
            "Accept": "application/openmetrics-text"})
        debug, _ = get(url + "/debug/")
    finally:
        api.stop()
    assert "application/openmetrics-text" in om_headers["Content-Type"]
    assert sorted(json.loads(debug)["surfaces"]) == [
        "/debug/history", "/debug/memory", "/debug/requests",
        "/debug/serve"]
    for needle in ("veles_decode_dispatch_seconds_bucket",
                   "veles_decode_admit_seconds_count",
                   "veles_decode_collect_seconds_count",
                   'veles_decode_dispatches_total{kind="admit"} 1',
                   'veles_program_calls_total{program="decode.dispatch"}',
                   'veles_program_flops{program="decode.dispatch"}',
                   'veles_mfu_ratio{program="decode.dispatch"}',
                   "veles_device_peak_bf16_tflops 0.001",
                   'veles_device_memory_bytes{device="cpu",'
                   'kind="live_bytes"}',
                   'veles_request_ttft_seconds_count{api="generate-api"} 1',
                   'veles_request_tpot_seconds_count{api="generate-api"} 1'):
        assert needle in text, needle
    assert "decode.admit" not in {
        k for k, v in get_compile_tracker().snapshot()["compiles"].items()}
    exemplars = re.findall(r'veles_request_ttft_seconds_bucket.* # '
                           r'\{trace_id="(\w+)"\}', om)
    assert exemplars == ["feed01"]


def test_restful_api_mounts_metrics(observability):
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.serving import RESTfulAPI

    api = RESTfulAPI(DummyWorkflow(), port=0, path="/api")
    api.feed = lambda data, request: None
    api.requests = []
    api.initialize()
    try:
        url = "http://127.0.0.1:%d" % api.port
        text, _ = get(url + "/metrics")
        assert 'veles_serving_ready{api="restful-api"} 1' in text
        assert sorted(json.loads(get(url + "/debug")[0])["surfaces"]) == [
            "/debug/history", "/debug/memory", "/debug/requests",
            "/debug/serve"]
        with pytest.raises(urllib.error.HTTPError) as err:
            get(url + "/nowhere")
        assert err.value.code == 404
    finally:
        api.stop()


def test_restful_request_span_continues_the_header(observability):
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.serving import RESTfulAPI

    api = RESTfulAPI(DummyWorkflow(), port=0, path="/api")
    api.feed = lambda data, request: None
    api.requests = []
    api.initialize()
    try:
        req = urllib.request.Request(
            "http://127.0.0.1:%d/api" % api.port, data=b"not json",
            headers={"X-Veles-Trace": "beef01/cd"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
    finally:
        api.stop()
    spans = [e for e in load_events(observability)
             if e.get("name") == "restful.request"]
    assert {(e["etype"], e["trace_id"], e["parent_id"]) for e in spans} \
        == {("begin", "beef01", "cd"), ("end", "beef01", "cd")}


def test_concurrent_requests_each_reach_their_dispatches(observability):
    """A batch dispatch has one span, owned by its first traced request,
    as in the JAX package; every request of the batch rides its ``rids``
    attribute. Each request's own tree runs from ``serve.request``
    through ``serve.submit`` (which names its request id) to
    ``serve.complete``, and through ``rids`` it joins an admission, a
    dispatch and a collect span; no extra events are written."""
    from veles_tpu_torch.serving import GenerateAPI

    params, table, heads = _toy()
    api = GenerateAPI(params, table, heads, slots=4, max_len=32,
                      n_tokens=6, chunk=2, paged=True, page_size=8,
                      device="cpu").start()
    ids = ["a%03d" % i for i in range(4)]
    errors = []

    def client(trace_id, prompt):
        try:
            post("http://127.0.0.1:%d/generate" % api.port,
                 {"tokens": prompt},
                 headers={"X-Veles-Trace": trace_id + "/ee"})
        except Exception as exc:   # noqa: BLE001 - asserted below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=client, args=(t, [1, 2, i]))
                   for i, t in enumerate(ids)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        api.stop()
    assert not errors
    trace = chrome_trace(load_events(observability))
    trees = span_tree(trace)
    names = {e["args"]["span_id"]: e["name"] for e in trace["traceEvents"]
             if e.get("args", {}).get("span_id")}
    batch = [e for e in trace["traceEvents"] if e["ph"] == "X"
             and e["name"] in ("paged.admit", "paged.dispatch",
                               "decode.collect")]
    assert not [e for e in trace["traceEvents"] if e["ph"] == "i"
                and e["name"] in ("paged.dispatch", "decode.collect")]
    owners = 0
    for trace_id in ids:
        own = {names[s] for s in trees[trace_id]}
        assert {"serve.request", "serve.submit", "serve.complete"} <= own
        rid, = [e["args"]["rid"] for e in trace["traceEvents"]
                if e["name"] == "serve.submit"
                and e["args"]["trace_id"] == trace_id]
        joined = {e["name"] for e in batch if rid in e["args"]["rids"]}
        assert joined == {"paged.admit", "paged.dispatch",
                          "decode.collect"}, (trace_id, joined)
        owners += "paged.dispatch" in own
    assert owners >= 1
    # every batch span hangs off its owner's tree
    for event in batch:
        tree = trees[event["args"]["trace_id"]]
        assert tree[event["args"]["span_id"]] in tree


def test_observe_cost_script_reads_each_setting(observability, capsys,
                                               monkeypatch):
    """The planes' cost diagnostic on a narrow model on the CPU: one
    timeline line per run of each setting asked for, the medians, and
    every burst answered in full (tokens/s over the budget sent)."""
    from veles_tpu_torch.observe.flight import get_flight_recorder
    from veles_tpu_torch.scripts import observe_cost

    for plane in (get_flight_recorder(), get_compile_tracker()):
        monkeypatch.setattr(plane, "enabled", plane.enabled)
    assert observe_cost.main(["--small", "--device", "cpu", "--reps", "1",
                              "--settings", "default,off"]) == 0
    out = capsys.readouterr().out
    runs = re.findall(r"^setting=(\w+) tokens_s=([\d.]+) .* chunks=(\d+)",
                      out, re.M)
    assert sorted(r[0] for r in runs) == ["default", "off"]
    assert all(float(rate) > 0 and int(chunks) >= 4
               for _, rate, chunks in runs)
    medians = out.split("medians:")[1].split()
    assert medians[0] == "default" and "off" in medians


def test_profile_window_records_the_driver_threads_spans(observability,
                                                         tmp_path):
    """The serving driver runs on its own thread, started before the
    window: its ``paged.dispatch`` ranges are in the capture, with the
    step's ops inside them on the same thread."""
    from veles_tpu_torch.observe.profile import profile_window
    from veles_tpu_torch.serving import GenerateAPI

    params, table, heads = _toy()
    api = GenerateAPI(params, table, heads, slots=2, max_len=32,
                      n_tokens=4, chunk=2, paged=True, page_size=8,
                      device="cpu").start()
    try:
        with profile_window(str(tmp_path)) as path:
            post("http://127.0.0.1:%d/generate" % api.port,
                 {"tokens": [1, 2, 3]})
    finally:
        api.stop()
    events = json.loads(open(path).read())["traceEvents"]
    ranges = [e for e in events if e.get("name") == "paged.dispatch"
              and e.get("cat") == "user_annotation"]
    assert ranges
    inside = [e for e in events if e.get("cat") == "cpu_op"
              and any(r["tid"] == e["tid"] and r["ts"] <= e["ts"]
                      <= r["ts"] + r["dur"] for r in ranges)]
    assert inside
