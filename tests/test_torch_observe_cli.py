"""The observe plane through the port's command line, on the CPU:
``--trace-events`` (a ``unit.run`` span for every unit of the workflow,
framed by ``workflow.run``, exported by ``observe export-trace``),
``--profile`` (the torch.profiler window with CPU activities, the spans
named in it), SIGTERM during a CLI run (a black box, and the handler it
replaced still runs), and the flags and subcommands still deferred
(exit 2 naming their ROADMAP item); ``--serve-slo`` and
``--serve-history`` landing in ``root.common.observe`` or refused with the
JAX package's message, and ``observe slo|serve-trace|incident`` on saved
artifacts. The runs are subprocesses started together by one module
fixture."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy
import pytest
import torch

from veles_tpu_torch.__main__ import COMMANDS, DEFERRED, DEFERRED_COMMANDS
from veles_tpu_torch.observe.flight import load_dump
from veles_tpu_torch.observe.trace_export import load_events

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_sigterm():
    """A CLI run in this process installs the flight recorder's SIGTERM
    handler (``observe/flight.install_signal_handlers``), chained to the
    one before it: put that one back after every test, so the handlers
    do not pile up in the worker that runs this file."""
    previous = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, previous)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the six-feature toy of tests/test_torch_cli.py, with a knob for
#: epochs
TINY_WF = '''
import numpy
from veles_tpu_torch.core.config import root
from veles_tpu_torch.models.mlp import MLPWorkflow

root.tiny.update({"epochs": 1})


def run(load, main):
    rng = numpy.random.RandomState(0)
    x = rng.rand(120, 6).astype(numpy.float32)
    y = (x[:, 0] > 0.5).astype(numpy.int32)
    wf, _ = load(MLPWorkflow, layers=(6, 2),
                 loader_kwargs=dict(data=x, labels=y,
                                    class_lengths=[0, 40, 80],
                                    minibatch_size=20),
                 learning_rate=0.3, max_epochs=root.tiny.epochs,
                 name="tiny")
    main()
'''

#: a CLI run behind a SIGTERM handler of its own: the CLI chains it
CHAINED = '''
import signal, sys
marker = sys.argv[1]

def previous(signum, frame):
    with open(marker, "w") as fout:
        fout.write("previous ran")
    sys.exit(9)

signal.signal(signal.SIGTERM, previous)
from veles_tpu_torch.__main__ import main
sys.exit(main(sys.argv[2:]))
'''


def _env(tmp):
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                VELES_TPU_HOME=str(tmp),
                PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("observe_cli")
    tiny = tmp / "tiny_wf.py"
    tiny.write_text(TINY_WF)
    base = [sys.executable, "-m", "veles_tpu_torch", str(tiny), "-",
            "--device", "cpu"]
    procs = {
        "traced": subprocess.Popen(
            base + ["--trace-events", str(tmp / "events.jsonl")],
            env=_env(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "profiled": subprocess.Popen(
            base + ["--profile", str(tmp / "profile")], env=_env(tmp),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        # a long run, killed once its first unit.run span is on disk
        "killed": subprocess.Popen(
            [sys.executable, "-c", CHAINED, str(tmp / "marker"),
             str(tiny), "-", "--device", "cpu", "root.tiny.epochs=100000",
             "--trace-events", str(tmp / "killed.jsonl")],
            env=_env(tmp / "home"), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
    }
    deadline = time.monotonic() + 240
    killed = tmp / "killed.jsonl"
    while time.monotonic() < deadline:
        if killed.exists() and "unit.run" in killed.read_text():
            break
        time.sleep(0.1)
    procs["killed"].send_signal(signal.SIGTERM)
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        out[name] = (proc.returncode, stdout, stderr)
    return out, tmp


def test_trace_events_give_a_unit_run_span_for_every_unit(runs):
    out, tmp = runs
    code, _, err = out["traced"]
    assert code == 0, err[-3000:]
    assert "span tracing to" in err
    events = load_events(str(tmp / "events.jsonl"))
    ran = {e.get("unit") for e in events
           if e.get("name") == "unit.run" and e.get("etype") == "end"}
    assert {"FullBatchLoader", "fused_tick", "DecisionGD", "End"} <= ran
    assert [e for e in events if e.get("name") == "workflow.run"]
    # every unit.run span has its begin and end
    begins = {e["span_id"] for e in events
              if e.get("name") == "unit.run" and e["etype"] == "begin"}
    ends = {e["span_id"] for e in events
            if e.get("name") == "unit.run" and e["etype"] == "end"}
    assert begins == ends


def test_every_unit_that_runs_runs_under_a_span(tmp_path, monkeypatch):
    """In process, the toy workflow traced: the units that fired (their
    ``run_calls``; the fused tick stands in for the forwards and the
    gradient units) are exactly the units the ``unit.run`` spans name,
    once a firing each."""
    from veles_tpu_torch.core import logger as logger_mod
    from veles_tpu_torch.core.logger import EventRecorder
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.mlp import MLPWorkflow
    from veles_tpu_torch.observe.tracing import get_tracer

    path = str(tmp_path / "events.jsonl")
    recorder = EventRecorder()
    recorder.open(path)
    monkeypatch.setattr(logger_mod, "_event_recorder", recorder)
    monkeypatch.setattr(get_tracer(), "enabled", True)
    rng = numpy.random.RandomState(0)
    x = rng.rand(120, 6).astype(numpy.float32)
    y = (x[:, 0] > 0.5).astype(numpy.int32)
    wf = MLPWorkflow(DummyLauncher(), layers=(6, 2), device="cpu",
                     loader_kwargs=dict(data=x, labels=y,
                                        class_lengths=[0, 40, 80],
                                        minibatch_size=20),
                     learning_rate=0.3, max_epochs=2)
    wf.initialize()
    wf.run()
    recorder.close()
    spans = {}
    for event in load_events(path):
        if event.get("name") == "unit.run" and event["etype"] == "end":
            spans[event["unit"]] = spans.get(event["unit"], 0) + 1
    fired = {u.name: u.run_calls for u in wf.units if u.run_calls}
    assert spans == fired


def test_the_exported_trace_holds_the_unit_spans(runs):
    out, tmp = runs
    trace = str(tmp / "trace.json")
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "observe",
         "export-trace", str(tmp / "events.jsonl"), "-o", trace],
        env=_env(tmp), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    spans = [e for e in json.load(open(trace))["traceEvents"]
             if e["ph"] == "X"]
    assert {"unit.run", "workflow.run"} <= {e["name"] for e in spans}


def test_profile_writes_a_trace_with_the_span_names(runs):
    out, tmp = runs
    code, _, err = out["profiled"]
    assert code == 0, err[-3000:]
    (name,) = os.listdir(tmp / "profile")
    events = json.load(open(tmp / "profile" / name))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "unit.run" in names and "workflow.run" in names


def test_sigterm_dumps_a_black_box_and_chains(runs):
    out, tmp = runs
    code, _, err = out["killed"]
    assert code == 9, err[-3000:]
    assert (tmp / "marker").read_text() == "previous ran"
    run_dir = tmp / "home" / "run"
    (name,) = os.listdir(run_dir)
    doc = load_dump(str(run_dir / name))
    assert doc["reason"] == "sigterm"
    assert doc["entries"][-1]["kind"] == "signal"
    assert "unit.run" in {e.get("name") for e in doc["entries"]}


def test_the_observe_entries_left_the_deferred_maps():
    from veles_tpu_torch.observe import trace_export

    assert not {"profile", "trace_events", "serve_slo",
                "serve_history"} & set(DEFERRED)
    assert "observe" in COMMANDS and "observe" not in DEFERRED_COMMANDS
    assert "serve_governor" not in DEFERRED
    # fleet-trace came with the fleet: no observe subcommand waits
    assert not hasattr(trace_export, "DEFERRED")


@pytest.mark.parametrize("flag,key,value,parsed", [
    ("--serve-slo", "slo", "ttft_p95_ms=250,availability=0.999",
     ["availability", "ttft_p95_ms"]),
    ("--serve-history", "history", "interval_s=0.2,capacity=32",
     (0.2, 32))])
def test_observe_flags_land_in_root_common_observe(flag, key, value, parsed,
                                                   tmp_path, monkeypatch,
                                                   capsys):
    """``--serve-slo`` and ``--serve-history`` parse, pass the early
    validation and land in ``root.common.observe``, where the SLO engine
    and the history read them."""
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.core.config import root
    from veles_tpu_torch.observe.history import MetricHistory
    from veles_tpu_torch.observe.slo import SLOEngine

    monkeypatch.setattr(root.common.observe, key, None)
    tiny = tmp_path / "tiny_wf.py"
    tiny.write_text(TINY_WF)
    assert Main().run([str(tiny), "-", "--device", "cpu", flag, value,
                       "--dump-config"]) == 0
    assert getattr(root.common.observe, key) == value
    assert "'%s': '%s'" % (key, value) in capsys.readouterr().out
    if key == "slo":
        engine = SLOEngine.from_config()
        assert [o.name for o in engine.objectives] == parsed
    else:
        history = MetricHistory.from_config(registry=object())
        assert (history.interval_s, history.capacity) == parsed


@pytest.mark.parametrize("flag,value", [
    ("--serve-slo", "ttft_p95_ms=250,latency=3"),
    ("--serve-slo", "availability=2"),
    ("--serve-history", "interval_s=0"),
    ("--serve-history", "bogus=1")])
def test_bad_observe_flags_fail_with_the_jax_message(flag, value, tmp_path,
                                                    monkeypatch, capsys):
    """A bad spec exits 2 before the workflow runs, with the JAX
    package's message naming the flag."""
    from veles_tpu.observe.history import parse_history_spec
    from veles_tpu.observe.slo import parse_objectives
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.core.config import root

    monkeypatch.setattr(root.common.observe, "slo", None)
    monkeypatch.setattr(root.common.observe, "history", None)
    tiny = tmp_path / "tiny_wf.py"
    tiny.write_text(TINY_WF)
    with pytest.raises(SystemExit) as exit_:
        Main().run([str(tiny), "-", "--device", "cpu", flag, value])
    assert exit_.value.code == 2
    parse = parse_objectives if flag == "--serve-slo" \
        else parse_history_spec
    with pytest.raises(ValueError) as jax:
        parse(value, flag=flag)
    assert str(jax.value) in capsys.readouterr().err
    assert root.common.observe.slo is None
    assert root.common.observe.history is None


@pytest.mark.parametrize("value,error", [
    ("demote_burn=3,cooldown_s=5,ladder=int8+int8-kv", None),
    ("enabled=0", None),
    ("ladder=bf16", "not a degraded tier"),
    ("recover_burn=5,demote_burn=2", "hysteresis band"),
    ("bogus=1", "unknown key")])
def test_serve_governor_parses_into_root_common_serve(value, error,
                                                      tmp_path, monkeypatch,
                                                      capsys):
    """``--serve-governor`` parses, passes the early validation and lands
    in ``root.common.serve.governor``, where the front's governor reads
    it; a bad spec exits 2 with the JAX package's message naming the
    flag."""
    from veles_tpu.observe.governor import parse_governor_spec
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.core.config import root
    from veles_tpu_torch.observe.governor import ServingGovernor

    monkeypatch.setattr(root.common.serve, "governor", None, raising=False)
    tiny = tmp_path / "tiny_wf.py"
    tiny.write_text(TINY_WF)
    argv = [str(tiny), "-", "--device", "cpu", "--serve-governor", value,
            "--dump-config"]
    if error is None:
        assert Main().run(argv) == 0
        assert root.common.serve.governor == value
        governor = ServingGovernor.from_config()
        assert (governor is None) == (value == "enabled=0")
        if governor is not None:
            assert governor.config.ladder == ("int8", "int8-kv")
        return
    with pytest.raises(SystemExit) as exit_:
        Main().run(argv)
    assert exit_.value.code == 2
    with pytest.raises(ValueError) as jax:
        parse_governor_spec(value, flag="--serve-governor")
    err = capsys.readouterr().err
    assert str(jax.value) in err and error in err
    assert root.common.serve.governor is None


def _artifacts(tmp):
    """A saved /debug/requests payload, a /debug/serve payload and an
    incident artifact, written by the port's planes."""
    from veles_tpu_torch.observe.history import (AnomalyRule,
                                                 IncidentRecorder,
                                                 MetricHistory)
    from veles_tpu_torch.observe.metrics import MetricsRegistry
    from veles_tpu_torch.observe.reqledger import RequestLedger
    from veles_tpu_torch.observe.servescope import ServeScope

    ledger, scope = RequestLedger(), ServeScope()
    for rid in range(3):
        row = ledger.stage(api="generate-api", tenant="t", prompt_len=4)
        ledger.link(row, rid)
        scope.note_slot_admit(rid % 2, rid, "cold", bucket=8,
                              trace=("ab%d" % rid, None))
        ledger.note_admit(row, "cold", bucket=8, program="paged.admit")
        scope.note_admit("cold", 8, 1, 1, 4, 4, 0, 0.001)
        scope.note_dispatch(2, 2, 1, 10, 0.002, paged=True, pages=1,
                            kernel=True)
        ledger.note_tokens(row, 2)
        scope.note_slot_first(rid)
        scope.note_collect(2, 2, 0.0001)
        scope.note_slot_retire(rid)
        ledger.resolve(row, "completed")
    paths = {"slo": tmp / "requests.json",
             "serve-trace": tmp / "serve.json"}
    paths["slo"].write_text(json.dumps(ledger.debug_snapshot()))
    paths["serve-trace"].write_text(json.dumps(
        scope.debug_snapshot(ledger=ledger)))
    history = MetricHistory(
        registry=MetricsRegistry(), rules=[AnomalyRule(
            "burn", "veles_slo_burn_rate", for_samples=1, threshold=1.0)],
        incidents=IncidentRecorder(directory=str(tmp / "incidents")))
    for step in range(3):
        history.sample(now=10.0 + step, rows=[
            ("veles_slo_burn_rate", "gauge", (("window", "60s"),),
             2.0 * step)])
    paths["incident"] = history.incidents.last_path
    return paths


@pytest.mark.parametrize("command,needle", [
    ("slo", "3 slowest resolved:"),
    ("serve-trace", "serve trace: "),
    ("incident", "leading indicator: burn")])
def test_observe_subcommands_read_saved_artifacts(command, needle, tmp_path,
                                                  capsys):
    from veles_tpu_torch.__main__ import main

    path = _artifacts(tmp_path)[command]
    assert main(["observe", command, str(path)]) == 0
    assert needle in capsys.readouterr().out
    assert main(["observe", command, str(tmp_path / "missing")]) == 1
