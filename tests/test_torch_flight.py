"""The port's flight recorder (veles_tpu_torch/observe/flight.py) against
tests/test_flight.py's contracts on the CPU: the always-on bounded ring,
atomic black-box dumps that the JAX package's ``load_dump`` and
``blackbox_main`` read, and the triggers: a breaker trip of the port's
GenerateAPI (the dump holds the trip's spans and the dispatch tail), an
unhandled unit exception, SIGTERM (the previous handler still runs), and
the ``python -m veles_tpu_torch observe blackbox`` command."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu_torch.core import logger as logger_mod
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.logger import EventRecorder
from veles_tpu_torch.observe import flight as flight_mod
from veles_tpu_torch.observe.flight import (MAX_ENTRIES, SCHEMA_VERSION,
                                            FlightRecorder, blackbox_main,
                                            load_dump)
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.observe.tracing import Tracer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def flight_home(tmp_path, monkeypatch):
    """The run dir in tmp and a FRESH global recorder (restored after)."""
    run_dir = str(tmp_path / "run")
    monkeypatch.setattr(root.common.dirs, "run", run_dir)
    recorder = FlightRecorder()
    monkeypatch.setattr(flight_mod, "_flight", recorder)
    return recorder, run_dir


def test_the_ring_is_bounded_and_drops_the_oldest():
    recorder = FlightRecorder(capacity=10)
    for i in range(25):
        recorder.note("tick", i=i)
    assert [e["i"] for e in recorder.entries()] == list(range(15, 25))
    assert FlightRecorder()._entries.maxlen == MAX_ENTRIES


def test_a_disabled_recorder_records_nothing():
    recorder = FlightRecorder(enabled=False)
    recorder.note("tick")
    recorder.note_span({"name": "x"})
    assert recorder.entries() == []


def test_entries_carry_stamps_and_kind():
    recorder = FlightRecorder()
    recorder.note("dispatch", chunk=4)
    (entry,) = recorder.entries()
    assert entry["kind"] == "dispatch" and entry["chunk"] == 4
    assert "t" in entry and "mono" in entry
    assert not any("lock" in name and "dump" not in name
                   for name in vars(recorder))


def test_spans_and_events_land_in_the_ring(flight_home, monkeypatch):
    from veles_tpu_torch.core.logger import Logger
    import veles_tpu_torch.observe.tracing as tracing_mod

    recorder, _ = flight_home
    monkeypatch.setattr(logger_mod, "_event_recorder", EventRecorder())
    tracer = Tracer(enabled=True)
    monkeypatch.setattr(tracing_mod, "_tracer", tracer)
    with tracer.span("serve.request", rid=7):
        pass
    Logger().event("epoch", "single", number=3)
    kinds = [(e["kind"], e.get("name"), e.get("etype"))
             for e in recorder.entries()]
    assert ("span", "serve.request", "begin") in kinds
    assert ("span", "serve.request", "end") in kinds
    assert ("event", "epoch", "single") in kinds


def test_dump_is_atomic_and_both_packages_load_it(flight_home,
                                                  monkeypatch):
    from veles_tpu.observe.flight import load_dump as jax_load_dump
    from veles_tpu_torch.observe import memscope as memscope_mod
    from veles_tpu_torch.observe import metrics as metrics_mod
    from veles_tpu_torch.observe import reqledger, xla_stats

    recorder, run_dir = flight_home
    # an empty request ledger and memscope: the process ones hold what
    # earlier serving tests left
    monkeypatch.setattr(reqledger, "_ledger", reqledger.RequestLedger())
    monkeypatch.setattr(memscope_mod, "_memscope", memscope_mod.MemScope())
    registry = MetricsRegistry(enabled=True)
    registry.incr("veles_boxed_total", 3)
    monkeypatch.setattr(metrics_mod, "_registry", registry)
    tracker = xla_stats.CompileTracker(enabled=True)
    tracker.record_compile("paged_attention.cu", 2.5)
    monkeypatch.setattr(xla_stats, "_tracker", tracker)
    recorder.note("dispatch", chunk=2)
    path = recorder.dump("testing", extra={"k": "v"})
    assert path and os.path.dirname(path) == run_dir
    assert not [n for n in os.listdir(run_dir) if ".tmp" in n]
    for load in (load_dump, jax_load_dump):
        doc = load(path)
        assert doc["schema"] == SCHEMA_VERSION == 1
        assert doc["reason"] == "testing" and doc["extra"] == {"k": "v"}
        assert doc["entries"][-1]["kind"] == "dispatch"
        assert ["veles_boxed_total", "counter", [], 3] in doc["metrics"]
        assert doc["xla"]["compiles"] == {"paged_attention.cu": 1}
        # the request ledger's tail: the key is there even when the
        # ledger holds no row
        assert doc["requests"] == {"inflight": [], "slowest": []}
    assert set(doc) == {"schema", "reason", "time", "mono", "pid",
                        "entries", "extra", "metrics", "xla", "requests"}
    assert recorder.last_dump_path == path and recorder.dumps == 1


def test_jax_blackbox_main_reads_a_port_dump(flight_home, capsys):
    from veles_tpu.observe.flight import blackbox_main as jax_blackbox

    recorder, run_dir = flight_home
    recorder.note("breaker.trip", error="boom")
    path = recorder.dump("breaker_trip")
    assert jax_blackbox(path) == 0
    out = capsys.readouterr().out
    assert "reason: breaker_trip" in out and "breaker.trip" in out
    assert blackbox_main(run_dir) == 0
    assert "reason: breaker_trip" in capsys.readouterr().out


def test_dump_is_reentrant_from_the_same_thread(flight_home):
    recorder, _ = flight_home
    with recorder._dump_lock:
        path = recorder.dump("nested")
    assert path is not None and load_dump(path)["reason"] == "nested"


def test_dump_failure_is_warned_once_not_raised(flight_home, monkeypatch,
                                                caplog):
    recorder, _ = flight_home
    monkeypatch.setattr(root.common.dirs, "run",
                        "/proc/definitely/not/writable")
    assert recorder.dump("doomed") is None
    assert recorder.dump("doomed-again") is None
    assert recorder.dumps == 0
    assert len([r for r in caplog.records
                if "dump failed" in r.getMessage()]) == 1


def test_breaker_trip_dumps_spans_and_the_dispatch_tail(flight_home,
                                                       monkeypatch):
    """A device failure in the port's GenerateAPI trips the breaker, and
    the black box it dumps holds the trip, the admit dispatch before it
    and the request's spans (tests/test_flight.py's acceptance)."""
    import veles_tpu_torch.serving as serving_mod
    from veles_tpu_torch.observe.tracing import get_tracer
    from veles_tpu_torch.parallel.transformer_step import (
        init_transformer_params)
    from veles_tpu_torch.serving import GenerateAPI

    recorder, _ = flight_home
    monkeypatch.setattr(logger_mod, "_event_recorder", EventRecorder())
    monkeypatch.setattr(get_tracer(), "enabled", True)
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, 2, 16, 4, 11, device="cpu")
    table = torch.from_numpy(rng.randn(11, 16).astype(numpy.float32) * 0.3)
    api = GenerateAPI(params, table, 4, slots=2, max_len=32, n_tokens=4,
                      chunk=2, paged=True, page_size=8, rebuild_backoff=0.01,
                      device="cpu").start()

    def injected(*args, **kwargs):
        raise RuntimeError("injected device failure")

    try:
        monkeypatch.setattr(serving_mod, "paged_slot_step_many", injected)
        req = urllib.request.Request(
            "http://127.0.0.1:%d/generate" % api.port,
            data=json.dumps({"tokens": [1, 2]}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 503   # shed, retryable
    finally:
        api.stop()
    path = recorder.last_dump_path
    assert path is not None, "the breaker trip dumped no black box"
    doc = load_dump(path)
    assert doc["reason"] == "breaker_trip"
    assert "injected device failure" in doc["extra"]["error"]
    assert doc["extra"]["health"]["name"] == "generate-api"
    kinds = [e["kind"] for e in doc["entries"]]
    assert kinds[-1] == "breaker.trip" and "admit" in kinds
    spans = {(e.get("name"), e.get("etype")) for e in doc["entries"]
             if e["kind"] == "span"}
    assert {("serve.request", "begin"), ("serve.submit", "single"),
            ("paged.admit", "end"), ("paged.dispatch", "end")} <= spans
    failed = [e for e in doc["entries"] if e.get("name")
              == "paged.dispatch" and e.get("etype") == "end"]
    assert "injected device failure" in failed[-1]["error"]


def test_breaker_trip_before_admission_keeps_the_dispatch_tail(
        flight_home):
    """A trip requested on purpose: the ring holds the admit, dispatch
    and collect notes before it, and the front's breaker transitions
    after it (open, then closed once the probe passed)."""
    from veles_tpu_torch.parallel.transformer_step import (
        init_transformer_params)
    from veles_tpu_torch.serving import GenerateAPI

    recorder, _ = flight_home
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, 1, 8, 2, 7, device="cpu")
    table = torch.from_numpy(rng.randn(7, 8).astype(numpy.float32))
    api = GenerateAPI(params, table, 2, slots=1, max_len=32, n_tokens=4,
                      chunk=2, rebuild_backoff=0.01, device="cpu").start()
    try:
        req = urllib.request.Request(
            "http://127.0.0.1:%d/generate" % api.port,
            data=json.dumps({"tokens": [1, 2]}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
        api.request_trip("drill")
        for _ in range(3000):
            if api.health.counter("rebuilds"):
                break
            time.sleep(0.01)
    finally:
        api.stop()
    doc = load_dump(recorder.last_dump_path)
    kinds = [e["kind"] for e in doc["entries"]]
    assert kinds[-1] == "breaker.trip"
    assert {"admit", "dispatch", "collect"} <= set(kinds)
    assert [e["state"] for e in recorder.entries()
            if e["kind"] == "breaker"][:2] == ["open", "closed"]


def test_unhandled_unit_exception_dumps(flight_home):
    from veles_tpu_torch.dummy import DummyWorkflow

    recorder, _ = flight_home
    wf = DummyWorkflow(name="boom-wf")
    wf.on_error(RuntimeError("unit exploded"), None)
    doc = load_dump(recorder.last_dump_path)
    assert doc["reason"] == "unit_exception"
    assert "unit exploded" in doc["extra"]["error"]
    assert doc["extra"]["workflow"] == "boom-wf"


SIGTERM_CHILD = '''
import os, signal, sys
from veles_tpu_torch.core.config import root
from veles_tpu_torch.observe.flight import (get_flight_recorder,
                                            install_signal_handlers)
root.common.dirs.run = sys.argv[1]
marker = sys.argv[2]

def previous(signum, frame):
    with open(marker, "w") as fout:
        fout.write("previous ran")
    sys.exit(7)

signal.signal(signal.SIGTERM, previous)
install_signal_handlers()
get_flight_recorder().note("dispatch", chunk=8)
os.kill(os.getpid(), signal.SIGTERM)
'''


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")


def test_sigterm_dumps_and_chains_the_previous_handler(tmp_path):
    run_dir, marker = str(tmp_path / "run"), str(tmp_path / "marker")
    proc = subprocess.run([sys.executable, "-c", SIGTERM_CHILD, run_dir,
                           marker], env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 7, proc.stderr
    assert open(marker).read() == "previous ran"
    (name,) = os.listdir(run_dir)
    doc = load_dump(os.path.join(run_dir, name))
    assert doc["reason"] == "sigterm"
    assert [e["kind"] for e in doc["entries"]][-2:] == ["dispatch",
                                                        "signal"]


def test_sigterm_without_a_previous_handler_still_kills(tmp_path):
    child = ("import os, signal, sys\n"
             "from veles_tpu_torch.core.config import root\n"
             "from veles_tpu_torch.observe.flight import "
             "install_signal_handlers\n"
             "root.common.dirs.run = sys.argv[1]\n"
             "install_signal_handlers()\n"
             "os.kill(os.getpid(), signal.SIGTERM)\n"
             "import time; time.sleep(30)\n")
    run_dir = str(tmp_path / "run")
    proc = subprocess.run([sys.executable, "-c", child, run_dir],
                          env=_env(), capture_output=True, timeout=120)
    assert proc.returncode == -signal.SIGTERM
    assert len(os.listdir(run_dir)) == 1


def test_blackbox_command(tmp_path):
    recorder = FlightRecorder()
    recorder.note("collect", chunk=8)
    path = recorder.dump("testing", path=str(tmp_path / "box.json"))
    base = [sys.executable, "-m", "veles_tpu_torch", "observe", "blackbox"]
    proc = subprocess.run(base + [path, "--tail", "5"], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "reason: testing" in proc.stdout and "collect" in proc.stdout
    empty = tmp_path / "empty"
    empty.mkdir()
    proc = subprocess.run(base + [str(empty)], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "no black-box dumps" in proc.stdout
