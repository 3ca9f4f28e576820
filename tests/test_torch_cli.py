"""The port's entry points (veles_tpu_torch/__main__.py, launcher.py,
cli.py, the callable package and the port's samples) against the
contracts of tests/test_cli.py, on the CPU (``--device cpu``).

The command-line runs are subprocesses, started together by one
module-scoped fixture (each imports torch, the digits ones sklearn, the
JAX one jax), and each test reads its run's exit code and output. The
deferred flags and the callable package run in process."""

import functools
import http.server
import json
import os
import signal
import subprocess
import sys
import tarfile
import threading

import numpy
import pytest
import torch

import veles_tpu_torch
from veles_tpu_torch.__main__ import (DEFERRED, DEFERRED_COMMANDS,
                                      FLEET_FLAGS, Main, main)
from veles_tpu_torch.core import prng
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.snapshotter import Snapshotter

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
SAMPLES = os.path.join(REPO, "veles_tpu_torch", "samples")

#: a six-feature toy: no sklearn import, a second of training
TINY_WF = '''
import numpy
from veles_tpu_torch.core.config import root
from veles_tpu_torch.models.mlp import MLPWorkflow

root.tiny.update({"epochs": 1})


def run(load, main):
    rng = numpy.random.RandomState(0)
    x = rng.rand(120, 6).astype(numpy.float32)
    y = (x[:, 0] > 0.5).astype(numpy.int32)
    wf, loaded = load(MLPWorkflow, layers=(6, 2),
                      loader_kwargs=dict(data=x, labels=y,
                                         class_lengths=[0, 40, 80],
                                         minibatch_size=20),
                      learning_rate=0.3, max_epochs=root.tiny.epochs,
                      name="tiny")
    if loaded:
        wf.decision.max_epochs = root.tiny.epochs
        wf.decision.complete.unset()
        wf.decision.train_ended.unset()
    main()
'''


#: the slice's modules, imported with JAX, the JAX package and PIL blocked
#: before the toy workflow runs through ``main()`` and resumes
NO_JAX = '''
import importlib, sys
for name in ("jax", "jaxlib", "veles_tpu", "PIL"):
    sys.modules[name] = None
for name in ("__main__", "launcher", "cli", "snapshotter", "export",
             "inference", "serving", "scripts.compare_snapshots",
             "samples.mnist784", "samples.mnist_conv", "aot.artifact",
             "aot.loader", "aot.exec_cache", "aot.cli", "forge",
             "forge.package", "forge.server", "forge.client",
             "fleet.serve_plane", "router", "deploy_cli",
             "parallel.tp_engine", "parallel.reshard", "parallel.decode",
             "parallel.kv_pool", "parallel.mesh", "parallel.collectives",
             "parallel.step", "parallel.pipeline", "parallel.expert",
             "parallel.transformer_step", "ops.attention", "genetics",
             "genetics.config", "genetics.core", "genetics.optimizer",
             "ensemble", "ensemble.combiner", "ensemble.runner",
             "samples.genetic_example", "downloader", "loader.hdfs",
             "loader.mnist"):
    importlib.import_module("veles_tpu_torch." + name)
from veles_tpu_torch.__main__ import main
tiny, link = sys.argv[1:3]
assert main([tiny, "-", "--device", "cpu"]) == 0
assert main([tiny, "-", "root.tiny.epochs=2", "-w", link,
             "--device", "cpu"]) == 0
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "veles_tpu", "PIL")
          and sys.modules[m] is not None]
assert not leaked, leaked
print("imports clean")
'''


def _write_mnist(directory, n_test=100, n_train=300):
    """The four MNIST idx files (two gzipped) of random uint8 digits."""
    import gzip
    import struct
    rng = numpy.random.RandomState(1)
    for prefix, n in (("t10k", n_test), ("train", n_train)):
        for kind, array in (
                ("images-idx3", rng.randint(0, 256, (n, 28, 28))),
                ("labels-idx1", numpy.arange(n) % 10)):
            array = array.astype(numpy.uint8)
            name = os.path.join(directory, "%s-%s-ubyte" % (prefix, kind))
            opener = gzip.open if prefix == "train" else open
            with opener(name + (".gz" if prefix == "train" else ""),
                        "wb") as fout:
                fout.write(struct.pack(">HBB", 0, 8, array.ndim)
                           + struct.pack(">" + "I" * array.ndim,
                                         *array.shape) + array.tobytes())


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def _tiny_snapshot(directory):
    """One epoch of the toy workflow in process, snapshotted after the
    run to a file and to a sqlite database; returns the file's path."""
    prng.get("default").seed(3)
    rng = numpy.random.RandomState(0)
    x = rng.rand(120, 6).astype(numpy.float32)
    y = (x[:, 0] > 0.5).astype(numpy.int32)
    wf = MLPWorkflow(DummyLauncher(), layers=(6, 2), device="cpu",
                     loader_kwargs=dict(data=x, labels=y,
                                        class_lengths=[0, 40, 80],
                                        minibatch_size=20),
                     learning_rate=0.3, max_epochs=1, name="tiny")
    snap = Snapshotter(wf, prefix="tiny", directory=directory, interval=1,
                       time_interval=0)
    db = Snapshotter(wf, prefix="tiny", database=os.path.join(
        directory, "snapshots.db"), interval=1, time_interval=0)
    wf.initialize()
    wf.run()
    snap.export()
    db.export()
    return snap.destination


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every command-line run at once; ``runs[name]`` is
    ``(returncode, stdout, stderr, tmp)``."""
    tmp = str(tmp_path_factory.mktemp("cli"))
    tiny = os.path.join(tmp, "tiny_wf.py")
    with open(tiny, "w") as fout:
        fout.write(TINY_WF)
    snapshot = _tiny_snapshot(tmp)
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=tmp)
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d/%s" % (httpd.server_address[1],
                                      os.path.basename(snapshot))
    mnist = os.path.join(tmp, "mnist")
    os.makedirs(mnist)
    _write_mnist(mnist)
    port_cli = [sys.executable, "-m", "veles_tpu_torch"]
    digits = ["root.digits.max_epochs=2", "--seed", "7"]
    commands = {
        "digits": port_cli + [
            os.path.join(SAMPLES, "digits_mlp.py"),
            "samples/digits_config.py", "--device", "cpu",
            "--result-file", os.path.join(tmp, "digits.json")] + digits,
        "digits_jax": [sys.executable, "-m", "veles_tpu",
                       "samples/digits_mlp.py", "samples/digits_config.py",
                       "--result-file", os.path.join(tmp, "digits_jax.json")
                       ] + digits,
        "transformer": port_cli + [
            os.path.join(SAMPLES, "transformer_digits.py"), "-",
            "root.transformer.epochs=1",
            "root.transformer.export=%s" % os.path.join(tmp, "tx.tar"),
            "--device", "cpu",
            "--result-file", os.path.join(tmp, "tx.json")],
        "som": port_cli + [
            os.path.join(SAMPLES, "som_digits.py"), "-",
            "root.som.epochs=1", "--device", "cpu"],
        "mnist_no_files": port_cli + [
            os.path.join(SAMPLES, "mnist784.py"),
            "samples/mnist784_config.py",
            "root.mnist784.directory=%s" % tmp, "--device", "cpu"],
        "mnist784": port_cli + [
            os.path.join(SAMPLES, "mnist784.py"),
            "samples/mnist784_config.py",
            "root.mnist784.directory=%r" % mnist,
            "root.mnist784.max_epochs=1", "--device", "cpu",
            "--result-file", os.path.join(tmp, "mnist784.json")],
        "mnist_conv": port_cli + [
            os.path.join(SAMPLES, "mnist_conv.py"),
            "samples/mnist_conv_config.py",
            "root.mnist_conv.topology=caffe",
            "root.mnist_conv.directory=%r" % mnist,
            "root.mnist_conv.max_epochs=1", "--device", "cpu",
            "--result-file", os.path.join(tmp, "mnist_conv.json")],
        "dry_run": port_cli + [tiny, "-", "--dry-run", "init",
                               "--device", "cpu", "--train-ratio", "0.5",
                               "--visualize",
                               os.path.join(tmp, "graph.dot"),
                               "--dump-unit-attributes", "-v"],
        "dump_config": port_cli + [tiny, "-", "root.tiny.epochs=5",
                                   "--dump-config"],
        "bad_override": port_cli + [tiny, "-", "bogus.path=1",
                                    "--device", "cpu"],
        "no_card": port_cli + [tiny, "-"],
        "resume_file": port_cli + [
            tiny, "-", "root.tiny.epochs=3", "-w",
            os.path.join(tmp, "tiny_current.lnk"), "--device", "cpu",
            "--result-file", os.path.join(tmp, "resumed.json")],
        "resume_url": port_cli + [tiny, "-", "-w", url, "--dry-run",
                                  "init", "--device", "cpu"],
        "no_jax": [sys.executable, "-c", NO_JAX, tiny,
                   os.path.join(tmp, "tiny_current.lnk")],
        "resume_sqlite": port_cli + [
            tiny, "-", "root.tiny.epochs=2", "-w",
            "sqlite://%s#tiny" % os.path.join(tmp, "snapshots.db"),
            "--device", "cpu",
            "--result-file", os.path.join(tmp, "resumed_db.json")],
    }
    procs = {
        name: subprocess.Popen(
            cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=_env(CUDA_VISIBLE_DEVICES="")
            if name == "no_card" else _env())
        for name, cmd in commands.items()}
    results = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=240)
            results[name] = (proc.returncode, out, err, tmp)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        httpd.shutdown()
        httpd.server_close()
    return results


def _ok(run):
    rc, out, err, _ = run
    assert rc == 0, err[-3000:]
    return out, err


def test_digits_sample_end_to_end_keys_match_jax(runs):
    _ok(runs["digits"])
    _ok(runs["digits_jax"])
    tmp = runs["digits"][3]
    ours = json.load(open(os.path.join(tmp, "digits.json")))
    theirs = json.load(open(os.path.join(tmp, "digits_jax.json")))
    assert sorted(ours) == sorted(theirs)
    assert ours["epochs"] == theirs["epochs"] == 2
    assert ours["total_samples"] == theirs["total_samples"] == 1797
    assert ours["best_validation_errors"] < 297


def test_transformer_sample_exports_for_the_native_runtime(runs):
    from veles_tpu_torch.inference import NativeWorkflow
    out, _ = _ok(runs["transformer"])
    tmp = runs["transformer"][3]
    assert json.load(open(os.path.join(tmp, "tx.json")))["epochs"] == 1
    assert "exported to" in out
    package = os.path.join(tmp, "tx.tar")
    # the full pre-LN block (LN, residual attention, LN, ffn), a dense
    # layer and the softmax head
    assert NativeWorkflow(package).unit_count == 6
    with tarfile.open(package) as tar:
        assert tar.getnames()[0] == "contents.json"


def test_som_sample_end_to_end(runs):
    _, err = _ok(runs["som"])
    assert "stopping after 1 epochs" in err


@pytest.mark.parametrize("sample", ["mnist784", "mnist_conv"])
def test_mnist_samples_on_idx_files(runs, sample):
    """The MNIST samples with the repo's config files, on idx files the
    test writes (100 test rows validate, 300 train)."""
    _ok(runs[sample])
    results = json.load(open(os.path.join(runs[sample][3],
                                          sample + ".json")))
    assert results["epochs"] == 1 and results["total_samples"] == 400


def test_mnist_sample_without_idx_files_raises(runs):
    rc, _, err, _ = runs["mnist_no_files"]
    assert rc != 0
    assert "FileNotFoundError" in err and "idx files" in err


def test_dry_run_init(runs):
    """``--dry-run init`` initializes and stops; with it the graph
    (``--visualize``), the units' attributes and ``--train-ratio``."""
    out, err = _ok(runs["dry_run"])
    assert "launcher mode: standalone" in err
    assert "epoch 0" not in err
    graph = open(os.path.join(runs["dry_run"][3], "graph.dot")).read()
    assert graph.startswith("digraph") and "MLPWorkflow" not in graph
    units = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    loader = next(u for u in units if u["type"] == "FullBatchLoader")
    assert loader["attrs"]["train_ratio"] == 0.5
    assert loader["attrs"]["minibatch_size"] == 20


def test_dump_config(runs):
    out, _ = _ok(runs["dump_config"])
    assert "'epochs': 5" in out and "root" in out


def test_bad_override_rejected(runs):
    rc, _, err, _ = runs["bad_override"]
    assert rc != 0
    assert "must start with 'root.'" in err


def test_no_card_without_device_cpu_fails(runs):
    """``--device`` defaults to the card; without one the run fails
    instead of falling back to the CPU."""
    rc, _, err, _ = runs["no_card"]
    assert rc != 0
    assert "no CUDA device" in err


def test_resume_from_a_snapshot_file(runs):
    _, err = _ok(runs["resume_file"])
    assert "resuming from" in err
    tmp = runs["resume_file"][3]
    results = json.load(open(os.path.join(tmp, "resumed.json")))
    # one epoch in the snapshot, two more after the resume
    assert results["epochs"] == 3


def test_entry_points_import_neither_jax_nor_veles_tpu(runs):
    """The slice's modules and the samples' imports, a run and a resume
    through ``main()``, with JAX, the JAX package and PIL blocked."""
    out, err = _ok(runs["no_jax"])
    assert "imports clean" in out and "resuming from" in err


def test_resume_from_a_sqlite_row(runs):
    _, err = _ok(runs["resume_sqlite"])
    assert "resuming from sqlite://" in err
    tmp = runs["resume_sqlite"][3]
    assert json.load(open(os.path.join(tmp, "resumed_db.json")))[
        "epochs"] == 2


def test_resume_from_a_url(runs):
    _, err = _ok(runs["resume_url"])
    assert "resuming from" in err and "downloading snapshot" in err


def _flag_argv(dest):
    """A command line that sets the deferred flag ``dest``."""
    action = next(a for a in Main.init_parser()._actions if a.dest == dest)
    argv = ["wf.py", "-", action.option_strings[-1]]
    if action.nargs != 0:
        argv.append(str(action.choices[0]) if action.choices
                    else {int: "2", float: "0.5"}.get(action.type, "x=1"))
    return argv


@pytest.mark.parametrize("dest", sorted(DEFERRED))
def test_deferred_flag_exits_2_naming_its_roadmap_item(dest, capsys):
    with pytest.raises(SystemExit) as exc:
        Main().run(_flag_argv(dest))
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and DEFERRED[dest] in err


#: the meta-workflow flags -> (the flags given, the runner that must be
#: built, what it must be built with)
META_CASES = {
    "optimize": (["--optimize", "6:3"], "GeneticsOptimizer",
                 {"population_size": 6, "generations": 3,
                  "representation": "numeric", "fleet": None}),
    "optimize_fleet": (["--optimize", "4:2", "--optimize-fleet",
                        "127.0.0.1:0"], "GeneticsOptimizer",
                       {"fleet": "127.0.0.1:0"}),
    "optimize_representation": (["--optimize", "4:2",
                                 "--optimize-representation", "gray"],
                                "GeneticsOptimizer",
                                {"representation": "gray"}),
    "ensemble_train": (["--ensemble-train", "3:0.7"], "EnsembleTrainer",
                       {"instances": 3, "train_ratio": 0.7}),
    "ensemble_test": (["--ensemble-test", "ens.json"], "EnsembleTester",
                      {"ensemble_file": "ens.json"}),
}


@pytest.mark.parametrize("dest", sorted(META_CASES))
def test_meta_flag_reaches_its_runner(dest, tmp_path, monkeypatch, capsys):
    """Each of the five meta-workflow flags parses, is refused by nothing,
    and builds its runner (``_run_optimize``, ``_run_ensemble_train``,
    ``_run_ensemble_test``) with its value, the workflow, the config, the
    command line's overrides and ``--device`` passed through, the config's
    Range genes for the GA."""
    from veles_tpu_torch import ensemble, genetics

    assert dest not in DEFERRED
    flags, runner, want = META_CASES[dest]
    built = []

    class Runner:
        best_fitness_history = [1.0]
        populations = [[([0.1], 1.0)]]

        def __init__(self, *args, **kwargs):
            built.append((args, kwargs))

        def run(self):
            best = genetics.Chromosome([], [])
            best.fitness = 1.0
            return best if runner == "GeneticsOptimizer" else {}

    Runner.__name__ = runner
    module = genetics if runner == "GeneticsOptimizer" else ensemble
    monkeypatch.setattr(module, runner, Runner)
    config = tmp_path / "cfg.py"
    config.write_text("from veles_tpu_torch.genetics import Range\n"
                      "root.meta_cli.lr = Range(0.1, 0.01, 1.0)\n")
    tiny = tmp_path / "tiny_wf.py"
    tiny.write_text(TINY_WF)
    code = Main().run([str(tiny), str(config), "root.tiny.epochs=3",
                       "--device", "cpu"] + flags)
    assert code == 0 and len(built) == 1
    args, kwargs = built[0]
    assert kwargs["device"] == "cpu"
    assert kwargs["overrides"] == ["root.tiny.epochs=3"]
    if runner == "EnsembleTester":
        assert args == ("ens.json", str(tiny), str(config))
    else:
        assert args == (str(tiny), str(config))
    if runner == "GeneticsOptimizer":
        assert [path for path, _ in kwargs["genes"]] == ["root.meta_cli.lr"]
        assert json.loads(capsys.readouterr().out)["best_fitness"] == 1.0
    for key, value in want.items():
        got = args[0] if key == "ensemble_file" else kwargs[key]
        assert got == value, (key, got)


#: the fleet's flags -> the mode each is given with and what it must set
#: (a launcher attribute, or a root.common.fleet key)
FLEET_CASES = {
    "listen": ("master", {"mode": "master"}),
    "master_address": ("slave", {"mode": "slave"}),
    "nodes": ("master", {"nodes": ["x=1"]}),
    "respawn": ("master", {"respawn": True}),
    "slave_death_probability": ("slave", {"slave_death_probability": 0.5}),
    "async_slave": ("slave", {"async_slave": True}),
    "fleet_plane": ("slave", {"plane": "data"}),
    "chaos_seed": ("slave", {"chaos.seed": 2}),
    "chaos_frame_drop": ("slave", {"chaos.frame_drop": 0.5}),
    "chaos_frame_delay": ("slave", {"chaos.frame_delay": 0.5}),
    "chaos_slow_job": ("slave", {"chaos.slow_job": 0.5}),
    "chaos_duplicate_update": ("slave", {"chaos.duplicate_update": 0.5}),
    "chaos_death": ("slave", {"chaos.death": 0.5}),
    "background": ("slave", {"daemonized": True}),
}


@pytest.mark.parametrize("dest", sorted(FLEET_CASES))
def test_fleet_flag_reaches_the_launchers_fleet_mode(dest, tmp_path,
                                                     monkeypatch):
    """Each of the fleet's flags (and ``-b``) parses, is refused by
    nothing, and reaches the launcher's master or slave mode with its
    value (``--dry-run load`` stops before the fleet starts)."""
    from veles_tpu_torch.core.config import Config, root

    assert set(FLEET_CASES) == set(FLEET_FLAGS) | {"background"}
    assert not set(FLEET_CASES) & set(DEFERRED)
    daemonized = []
    monkeypatch.setattr(Main, "_daemonize",
                        lambda self: daemonized.append(True))
    # the flags write root.common.fleet: a fresh chaos subtree and the
    # plane's old value come back after the test
    monkeypatch.setattr(root.common.fleet, "chaos",
                        Config("root.common.fleet.chaos"), raising=False)
    monkeypatch.setattr(root.common.fleet, "plane",
                        root.common.fleet.get("plane", "data"),
                        raising=False)
    wf_file = tmp_path / "tiny_wf.py"
    wf_file.write_text(TINY_WF)
    mode, want = FLEET_CASES[dest]
    argv = _flag_argv(dest)
    argv[0] = str(wf_file)
    if dest not in ("listen", "master_address"):
        argv += (["-l", "127.0.0.1:0"] if mode == "master"
                 else ["-m", "127.0.0.1:1"])
    cli = Main()
    assert cli.run(argv + ["--device", "cpu", "--dry-run", "load"]) == 0
    launcher = cli.launcher
    assert launcher.mode == mode and cli.workflow.workflow is launcher
    for key, value in want.items():
        if key == "daemonized":
            got = bool(daemonized)
        elif key.startswith("chaos."):
            got = getattr(root.common.fleet.chaos, key[6:])
        elif key == "plane":
            got = root.common.fleet.plane
        else:
            got = getattr(launcher, key)
        assert got == value, (key, got)


@pytest.mark.parametrize("command", sorted(DEFERRED_COMMANDS))
def test_deferred_command_exits_2(command, capsys):
    assert main([command, "x"]) == 2
    assert DEFERRED_COMMANDS[command] in capsys.readouterr().err


@pytest.mark.parametrize("command", ["deploy", "forge", "route"])
def test_route_deploy_forge_commands_run(command, tmp_path, capsys,
                                         monkeypatch):
    """What the deferred ``route``, ``deploy`` and ``forge`` commands did
    before the serving-fleet slice now runs under ``main``: ``forge``
    uploads and lists against a forge server, ``deploy rollout`` resolves
    a package and exits with the JAX package's code (4: no live api in
    this process), ``route`` binds the elastic router over its replicas
    and stops on an interrupt."""
    from veles_tpu_torch import serving
    from veles_tpu_torch.forge import ForgeServer

    assert command not in DEFERRED_COMMANDS
    package = tmp_path / "pkg"
    package.mkdir()
    (package / "wf.py").write_text("# a workflow\n")
    (package / "manifest.json").write_text(json.dumps(
        {"name": "toy", "version": "1.0", "workflow": "wf.py"}))
    if command == "forge":
        server = ForgeServer(str(tmp_path / "store")).start()
        try:
            url = "http://127.0.0.1:%d" % server.port
            assert main(["forge", "upload", "-s", url, "-d",
                         str(package)]) == 0
            assert main(["forge", "list", "-s", url]) == 0
        finally:
            server.stop()
        out = capsys.readouterr().out
        assert '"toy"' in out and '"latest": "1.0"' in out
    elif command == "deploy":
        from veles_tpu_torch.forge.package import pack
        path, _ = pack(str(package), str(tmp_path / "toy.tar.gz"))
        monkeypatch.setattr(serving, "_CURRENT_API", None)
        # a package without a serving checkpoint: 2 before any api is
        # looked up
        assert main(["deploy", "rollout", path]) == 2
        assert "weights.npz" in capsys.readouterr().err
        with pytest.raises(SystemExit):
            main(["deploy"])
    else:
        import time
        import types

        from veles_tpu_torch import router as router_mod

        started = []

        def stop_at_once(seconds):
            started.append(seconds)
            raise KeyboardInterrupt

        # the router module's own clock: its foreground wait ends at once
        monkeypatch.setattr(router_mod, "time", types.SimpleNamespace(
            sleep=stop_at_once, monotonic=time.monotonic,
            time=time.time))
        assert main(["route", "--replicas", "127.0.0.1:9", "--port",
                     "0", "--spec", "poll_interval_s=30"]) == 0
        assert started and "router listening on" in \
            capsys.readouterr().out


@pytest.mark.parametrize("case", ["aot", "serve_aot"])
def test_aot_command_and_serve_aot_flag_run(case, tmp_path, capsys,
                                            monkeypatch):
    """What the deferred ``aot`` command and ``--serve-aot`` flag did
    before the AOT slice now runs: ``aot`` builds and verifies a bundle
    (``aot/cli.py``), ``--serve-aot`` lands in ``root.common.serve.aot``
    after the config layering, as the JAX package's does."""
    from veles_tpu_torch.core.config import root

    assert case not in DEFERRED and case not in DEFERRED_COMMANDS
    bundle = str(tmp_path / "b.aot.tar")
    if case == "aot":
        assert main(["aot", "build", "--out", bundle, "--device", "cpu",
                     "--blocks", "1", "--embed", "16", "--heads", "4",
                     "--vocab", "32", "--max-len", "32"]) == 0
        assert json.loads(capsys.readouterr().out)["programs"] > 0
        assert main(["aot", "verify", bundle]) == 0
        assert "loadable" in capsys.readouterr().out
        return
    monkeypatch.setattr(root.common.serve, "aot",
                        root.common.serve.get("aot"), raising=False)
    wf_file = tmp_path / "tiny_wf.py"
    wf_file.write_text(TINY_WF)
    assert Main().run([str(wf_file), "-", "root.common.serve.aot=x",
                       "--serve-aot", bundle, "--dump-config"]) == 0
    assert root.common.serve.aot == bundle


def test_callable_module(tmp_path):
    """``veles_tpu_torch(...)`` runs what the command line runs."""
    wf_file = tmp_path / "tiny_wf.py"
    wf_file.write_text(TINY_WF)
    result_file = str(tmp_path / "r.json")
    launcher = veles_tpu_torch(str(wf_file), None, device="cpu", seed=3,
                               result_file=result_file)
    assert launcher.workflow.name == "tiny"
    assert json.load(open(result_file))["epochs"] == 1


def test_serve_flags_write_root_common_serve(tmp_path, monkeypatch):
    """The serving flags write ``root.common.serve`` after the config
    layering (the CLI wins), as the JAX package's do."""
    from veles_tpu_torch.core.config import root
    serve, chaos = root.common.serve, root.common.serve.chaos
    for node, key in ((serve, "max_queue"), (serve, "deadline"),
                      (serve, "paged"), (serve, "page_size"),
                      (serve, "pool_pages"), (chaos, "seed"),
                      (chaos, "step_fail"), (chaos, "step_fail_max"),
                      (chaos, "slow_step")):
        monkeypatch.setattr(node, key, node.get(key), raising=False)
    wf_file = tmp_path / "tiny_wf.py"
    wf_file.write_text(TINY_WF)
    assert Main().run([
        str(wf_file), "-", "root.common.serve.max_queue=3",
        "--serve-max-queue", "7", "--serve-deadline", "2.5",
        "--serve-paged", "--serve-page-size", "16",
        "--serve-pool-pages", "40", "--chaos-serve-seed", "9",
        "--chaos-serve-step-fail", "0.25",
        "--chaos-serve-step-fail-max", "2",
        "--chaos-serve-slow-step", "0.5", "--dump-config"]) == 0
    assert (serve.max_queue, serve.deadline, serve.paged, serve.page_size,
            serve.pool_pages) == (7, 2.5, True, 16, 40)
    assert (chaos.seed, chaos.step_fail, chaos.step_fail_max,
            chaos.slow_step) == (9, 0.25, 2, 0.5)


def test_kwargs_to_argv():
    from veles_tpu_torch.cli import kwargs_to_argv
    assert kwargs_to_argv("w.py", None, ["root.a=1"], seed=3,
                          device="cpu", dump_config=True,
                          dry_run=None) == [
        "w.py", "-", "root.a=1", "--seed", "3", "--device", "cpu",
        "--dump-config"]


def test_scan_plugins_loads_the_entry_point_group(monkeypatch):
    """Plugins come from the ``veles_tpu_torch.plugins`` entry points; a
    plugin that fails to import is reported and skipped."""
    import importlib.metadata

    class EntryPoint:
        def __init__(self, name, value):
            self.name, self.value = name, value

        def load(self):
            if isinstance(self.value, Exception):
                raise self.value
            return self.value

    groups = []

    def entry_points(group):
        groups.append(group)
        return [EntryPoint("good", json), EntryPoint("bad", ImportError("x"))]

    monkeypatch.setattr(importlib.metadata, "entry_points", entry_points)
    monkeypatch.setattr(veles_tpu_torch, "__plugins__", None)
    assert veles_tpu_torch.scan_plugins() == [json]
    assert groups == ["veles_tpu_torch.plugins"]
    assert veles_tpu_torch.scan_plugins() == [json]  # scanned once
    assert groups == ["veles_tpu_torch.plugins"]
