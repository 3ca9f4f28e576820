"""The port's data-parallel mesh (veles_tpu_torch/parallel/mesh.py,
mapreduce.py and the fused tick's data axis) against the JAX package's
pod mode on the CPU.

The JAX side runs in this process on a data mesh of 2 and 4 of the 8
virtual CPU devices (tests/conftest.py). The port's side is a gloo world
of 2 and 4 processes, one per device: each rank is a fresh interpreter
(:data:`RANK`) that joins the world on an ephemeral port, runs every
case from JAX's initial weights (``convert.unit_params_from_jax``) and
writes its per-epoch error counts and final weights. One world per size
runs all the cases (module fixture :func:`worlds`); the ranks get a
deadline, are killed when it passes, and the test then fails.

The cases: a narrowed wide MLP (64 -> 256 tanh -> 10 on the digits,
minibatch 100) and MNIST784's reference topology (784 -> 100 tanh -> 10,
minibatch 100, on a 784-feature teacher set), each through the fused
tick's sweep (the pipelined product path) and per minibatch, at
precision level 2 in the f32 reduce tier. Per-epoch n_err must equal
JAX's; weights agree within :data:`ATOL` (f32 sums in another order:
~1e-7 measured after three epochs)."""

import json
import logging
import os
import socket
import subprocess
import sys
import tempfile

import numpy
import pytest
import torch

import jax
from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu.parallel import mesh as jmesh
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.parallel import fused, mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: f32 throughout: only the summation order differs between the packages
#: (the JAX mesh's psum against gloo's ring, the per-shard products)
ATOL = 1e-5
#: seconds a world of ranks may take for all its cases
DEADLINE = 120
EPOCHS = 3

#: one rank of the port's world: ``python -c RANK <config.json> <rank>``
RANK = r'''
import json, pickle, sys
import numpy, torch
torch.set_num_threads(1)
cfg = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.parallel.mesh import (build_mesh,
                                           finalize_distributed,
                                           initialize_distributed)
initialize_distributed(cfg["coordinator"], cfg["world"], rank,
                       device="cpu", timeout=cfg["timeout"])
root.common.engine.precision_level = 2
mesh = build_mesh(data=cfg["world"])
data = numpy.load(cfg["data"], allow_pickle=True)
out = {}
for case in cfg["cases"]:
    name = case["name"]
    x, y = data[case["set"] + "_x"], data[case["set"] + "_y"]
    prng.get("loader").seed(case["loader_seed"])
    wf = MLPWorkflow(DummyLauncher(), device="cpu", mesh=mesh,
                     layers=tuple(case["layers"]),
                     loader_kwargs=dict(data=x, labels=y,
                                        class_lengths=case["lengths"],
                                        minibatch_size=case["minibatch"],
                                        normalization_type="linear"),
                     learning_rate=case["lr"], max_epochs=case["epochs"],
                     fused_sweep=case["sweep"],
                     fused_pipeline=case["sweep"], name=name)
    unit_params_from_jax(wf, data[name + "_weights"].tolist())
    wf.initialize()
    seen = []
    summary = wf.decision._epoch_summary
    def recorded(stats, epoch, seen=seen, summary=summary):
        seen.append([int(s[0]) for s in stats])
        summary(stats, epoch)
    wf.decision._epoch_summary = recorded
    wf.run()
    out[name] = {
        "epochs": seen, "best": list(wf.decision.best_n_err),
        "sharded": wf.fused_tick is not None
        and wf.fused_tick.mesh is mesh,
        "weights": [(f.weights.data.numpy(), f.bias.data.numpy())
                    for f in wf.forwards]}
with open(cfg["out"] % rank, "wb") as fout:
    pickle.dump(out, fout)
finalize_distributed()
'''


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_world(world, cfg, directory):
    """Start ``world`` ranks of :data:`RANK` on ``cfg``; returns the
    processes and the results' path pattern."""
    os.makedirs(directory)
    cfg = dict(cfg, world=world, timeout=DEADLINE,
               coordinator="127.0.0.1:%d" % free_port(),
               out=os.path.join(directory, "rank%d.pickle"))
    path = os.path.join(directory, "config.json")
    with open(path, "w") as fout:
        json.dump(cfg, fout)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", RANK, path, str(rank)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    return procs, cfg["out"]


def join_worlds(started, deadline=DEADLINE):
    """Wait for every rank at most ``deadline`` seconds from now; kill
    them all and fail on expiry or on a rank's failure. Returns each
    world's per-rank results."""
    import pickle
    import time
    end = time.monotonic() + deadline
    try:
        logs = {}
        for world, (procs, _) in started.items():
            logs[world] = [proc.communicate(
                timeout=max(end - time.monotonic(), 0.1))[0]
                for proc in procs]
    except subprocess.TimeoutExpired:
        pytest.fail("a world of ranks passed its %d s deadline" % deadline)
    finally:
        for procs, _ in started.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    results = {}
    for world, (procs, pattern) in started.items():
        for rank, (proc, log) in enumerate(zip(procs, logs[world])):
            assert proc.returncode == 0, "world %d, rank %d:\n%s" % (
                world, rank, log[-3000:])
        results[world] = []
        for rank in range(world):
            with open(pattern % rank, "rb") as fin:
                results[world].append(pickle.load(fin))
    return results


def _digits():
    from sklearn.datasets import load_digits
    digits = load_digits()
    perm = numpy.random.RandomState(0).permutation(len(digits.data))
    return (digits.data.astype(numpy.float32)[perm],
            digits.target.astype(numpy.int32)[perm])


def _teacher784(n=900):
    """784 features whose labels a random linear teacher gives (the
    shape of MNIST784, learnable in a few epochs)."""
    rng = numpy.random.RandomState(7)
    x = rng.rand(n, 784).astype(numpy.float32)
    logits = (x - 0.5) @ rng.randn(784, 10).astype(numpy.float32)
    return x, logits.argmax(axis=1).astype(numpy.int32)


#: name -> (data set, layers, class lengths, minibatch, lr)
TOPOLOGIES = {
    "wide": ("digits", (256, 10), [0, 297, 1500], 100, 0.1),
    "mnist784": ("teacher", (100, 10), [0, 200, 700], 100, 0.1),
}
CASES = [(topo, sweep) for topo in TOPOLOGIES for sweep in (True, False)]
CASE_IDS = ["%s-%s" % (topo, "sweep" if sweep else "minibatch")
            for topo, sweep in CASES]


def _case_kwargs(topo, sweep, x, y):
    _, layers, lengths, minibatch, lr = TOPOLOGIES[topo]
    return dict(layers=layers,
                loader_kwargs=dict(data=x, labels=y, class_lengths=lengths,
                                   minibatch_size=minibatch,
                                   normalization_type="linear"),
                learning_rate=lr, max_epochs=EPOCHS, fused_sweep=sweep,
                fused_pipeline=sweep, name="%s-%d" % (topo, sweep))


def _record_epochs(wf):
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append([int(s[0]) for s in stats])
        summary(stats, epoch)

    wf.decision._epoch_summary = recorded
    return seen


@pytest.fixture(scope="module")
def level2():
    saved = (jroot.common.engine.precision_level,
             root.common.engine.precision_level)
    jroot.common.engine.precision_level = 2
    root.common.engine.precision_level = 2
    yield
    jroot.common.engine.precision_level, \
        root.common.engine.precision_level = saved


@pytest.fixture(scope="module")
def sets():
    return {"digits": _digits(), "teacher": _teacher784()}


def _jax_workflow(topo, sweep, x, y, mesh=None):
    """JAX's workflow of a case, initialized, its streams seeded as the
    ranks seed the port's (the loader's stream is drawn as it runs)."""
    jprng.get("default").seed(4321)
    jprng.get("loader").seed(8765)
    jwf = JMLPWorkflow(JDummyLauncher(), mesh=mesh,
                       **_case_kwargs(topo, sweep, x, y))
    jwf.initialize()
    return jwf


@pytest.fixture(scope="module")
def worlds(level2, sets):
    """For each world size: JAX's mesh run of every case (epochs, best,
    weights) and the port's ranks' results, from the same initial
    weights. The ranks run while this process runs the JAX side."""
    with tempfile.TemporaryDirectory() as directory:
        arrays, cases = {}, []
        for topo, sweep in CASES:
            name = "%s-%d" % (topo, sweep)
            data_set = TOPOLOGIES[topo][0]
            x, y = arrays[data_set + "_x"], arrays[data_set + "_y"] = \
                sets[data_set]
            jwf = _jax_workflow(topo, sweep, x, y)
            arrays[name + "_weights"] = numpy.array(
                [{"weights": numpy.asarray(f.weights.data),
                  "bias": numpy.asarray(f.bias.data)}
                 for f in jwf.forwards], dtype=object)
            _, layers, lengths, minibatch, lr = TOPOLOGIES[topo]
            cases.append({"name": name, "set": data_set,
                          "layers": list(layers), "lengths": lengths,
                          "minibatch": minibatch, "lr": lr,
                          "epochs": EPOCHS, "sweep": sweep,
                          "loader_seed": 8765})
        data_path = os.path.join(directory, "data.npz")
        numpy.savez(data_path, **arrays)
        started = {world: start_world(
            world, {"data": data_path, "cases": cases},
            os.path.join(directory, "world%d" % world))
            for world in (2, 4)}
        jax_runs = {2: {}, 4: {}}
        try:
            for world in (2, 4):
                jax_mesh = jmesh.build_mesh(devices=jax.devices()[:world],
                                            data=world)
                for topo, sweep in CASES:
                    x, y = sets[TOPOLOGIES[topo][0]]
                    jwf = _jax_workflow(topo, sweep, x, y, jax_mesh)
                    assert jwf.fused_tick.mesh is jax_mesh
                    seen = _record_epochs(jwf)
                    jwf.run()
                    jax_runs[world]["%s-%d" % (topo, sweep)] = {
                        "epochs": seen,
                        "best": list(jwf.decision.best_n_err),
                        "weights": [(numpy.asarray(f.weights.data),
                                     numpy.asarray(f.bias.data))
                                    for f in jwf.forwards]}
        finally:
            ranks = join_worlds(started)
    return {world: (jax_runs[world], ranks[world]) for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("topo,sweep", CASES, ids=CASE_IDS)
def test_data_parallel_tick_matches_jax_mesh(worlds, world, topo, sweep):
    """The port's n-rank fused tick against JAX's n-device mesh: equal
    per-epoch error counts and best errors, weights within ATOL, and
    every rank holding the same weights."""
    name = "%s-%d" % (topo, sweep)
    jax_runs, ranks = worlds[world]
    want = jax_runs[name]
    for got in (rank[name] for rank in ranks):
        assert got["sharded"], "the fused tick did not take the mesh"
        assert len(got["epochs"]) == EPOCHS
        assert got["epochs"] == want["epochs"]
        assert got["best"] == want["best"]
        for (tw, tb), (jw, jb) in zip(got["weights"], want["weights"]):
            numpy.testing.assert_allclose(tw, jw, atol=ATOL, rtol=0)
            numpy.testing.assert_allclose(tb, jb, atol=ATOL, rtol=0)
    first = ranks[0][name]["weights"]
    for rank in ranks[1:]:
        for (aw, ab), (bw, bb) in zip(first, rank[name]["weights"]):
            assert numpy.array_equal(aw, bw) and numpy.array_equal(ab, bb)


# -- the mesh's construction ------------------------------------------------

@pytest.fixture
def restore_sigterm():
    """An in-process CLI run installs the flight recorder's SIGTERM
    handler: put the previous one back."""
    import signal
    previous = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, previous)


@pytest.mark.parametrize("devices,overrides", [
    (4, {"foo": 2}), (4, {"data": 0}), (4, {"data": -2}),
    (4, {"data": 1.5}), (4, {"data": "x"}), (4, {"data": -1, "seq": -1}),
    (4, {"data": -1, "model": 3}), (4, {"data": 3}), (2, {"data": 4}),
], ids=["unknown-axis", "zero", "negative", "fraction", "string",
        "two-wildcards", "fixed-not-dividing", "product-short",
        "product-long"])
def test_build_mesh_errors_equal_jax(devices, overrides):
    with pytest.raises(ValueError) as want:
        jmesh.build_mesh(devices=jax.devices()[:devices], **overrides)
    with pytest.raises(ValueError) as got:
        mesh.build_mesh(devices=devices, **overrides)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["data", "data=x", "foo=2", "data=2,model",
                                  "=4"])
def test_parse_axes_errors_equal_jax(spec):
    with pytest.raises(ValueError) as want:
        jmesh.parse_axes(spec, flag="--mesh")
    with pytest.raises(ValueError) as got:
        mesh.parse_axes(spec, flag="--mesh")
    assert str(got.value) == str(want.value)


def test_mesh_shape_and_registry_as_jax():
    """A data mesh's shape, size, axis names and the active-mesh
    registry's records and labels are JAX's, a -1 axis absorbing the
    devices as there."""
    assert mesh.parse_axes("data=4,seq=1") \
        == jmesh.parse_axes("data=4,seq=1")
    assert mesh.AXIS_ORDER == jmesh.AXIS_ORDER
    want = jmesh.build_mesh(devices=jax.devices()[:4], data=-1)
    got = mesh.build_mesh(devices=4, data=-1)
    assert got.shape == dict(want.shape) and got.size == want.size
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert got.group is None and got.axis_index("data") == 0
    assert mesh.active_mesh_info() == jmesh.active_mesh_info()
    assert mesh.mesh_shape_label() == jmesh.mesh_shape_label() == "data4"
    assert mesh.is_primary() and mesh.axis_size("data") == 1
    assert mesh.mesh_configured() is jmesh.mesh_configured() is False


def test_axes_other_than_data_raise_naming_a8b():
    """The model, seq, pipe and expert axes of a TRAINING mesh are
    ROADMAP A8 (b): build_mesh builds such a mesh as JAX does (serving
    takes its model axis), and the training paths it reaches raise, a
    workflow handed it and the fused tick built over it."""
    want = jmesh.build_mesh(devices=jax.devices()[:4], data=2, model=2)
    got = mesh.build_mesh(devices=4, data=2, model=2)
    assert got.shape == dict(want.shape)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A8 \(b\)"):
        fused.build_tick([], mesh=got, cached=False)
    x, y = _digits()
    with pytest.raises(NotImplementedError, match=r"ROADMAP A8 \(b\)"):
        MLPWorkflow(DummyLauncher(), device="cpu",
                    mesh=mesh.Mesh({"data": 2, "seq": 2}),
                    **_case_kwargs("wide", True, x, y))


def _non_dividing_pair(jax_mesh, port_mesh, on_tick=False):
    """JAX's and the port's digits MLP at minibatch 75, the mesh given to
    the workflow or (``on_tick``) set on its fused tick before
    initialize, as a resumed run's launcher does."""
    x, y = _digits()
    kwargs = dict(_case_kwargs("wide", True, x, y), max_epochs=2)
    kwargs["loader_kwargs"] = dict(kwargs["loader_kwargs"],
                                   minibatch_size=75)
    jprng.get("default").seed(4321)
    jprng.get("loader").seed(8765)
    jwf = JMLPWorkflow(JDummyLauncher(), mesh=None if on_tick else jax_mesh,
                       **kwargs)
    if on_tick:
        jwf._enable_fused()
        jwf.fused_tick.mesh_ = jax_mesh
    jwf.initialize()
    layers = [{"weights": numpy.asarray(f.weights.data),
               "bias": numpy.asarray(f.bias.data)} for f in jwf.forwards]
    prng.get("loader").seed(8765)
    twf = MLPWorkflow(DummyLauncher(), device="cpu",
                      mesh=None if on_tick else port_mesh, **kwargs)
    if on_tick:
        twf._enable_fused()
        twf.fused_tick.mesh_ = port_mesh
    unit_params_from_jax(twf, layers)
    twf.initialize()
    return jwf, twf


@pytest.mark.parametrize("on_tick", [False, True], ids=["workflow", "tick"])
def test_non_dividing_minibatch_runs_single_device_as_jax(level2, caplog,
                                                          on_tick):
    """A minibatch that does not divide by the data axis: the reference's
    rule, a warning and a single-device run (fused.py:664-673 on the
    tick; on the workflow, supports() declines and the sweep tier takes
    the chain). Per-epoch errors equal JAX's."""
    jax_mesh = jmesh.build_mesh(devices=jax.devices()[:2], data=2)
    with caplog.at_level(logging.WARNING):
        jwf, twf = _non_dividing_pair(
            jax_mesh, mesh.build_mesh(devices=2, data=2), on_tick)
    assert "does not divide" in caplog.text or "must divide" in caplog.text
    if on_tick:
        assert twf.fused_tick.mesh is None and jwf.fused_tick.mesh is None
    else:
        assert twf.fused_tick is None and jwf.fused_tick is None
        assert type(twf.sweep_unit).__name__ \
            == type(jwf.sweep_unit).__name__ == "FusedSweep"
    jepochs, tepochs = _record_epochs(jwf), _record_epochs(twf)
    jwf.run()
    twf.run()
    assert tepochs == jepochs and len(tepochs) == 2
    assert twf.decision.best_n_err[VALID] == jwf.decision.best_n_err[VALID]


def test_supports_refuses_fill_transforms_under_a_mesh():
    """fused.supports keeps JAX's refusal of a fill-time transform under
    a mesh (its per-sample draws span the global minibatch)."""
    from veles_tpu.parallel import fused as jfused
    x = numpy.random.RandomState(0).rand(200, 8, 8, 1).astype(
        numpy.float32)
    y = (numpy.arange(200) % 4).astype(numpy.int32)
    layers = [{"type": "all2all_tanh", "output_sample_shape": 16},
              {"type": "softmax", "output_sample_shape": 4}]
    kwargs = dict(layers=layers, loader_kwargs=dict(
        data=x, labels=y, class_lengths=[0, 40, 160], minibatch_size=40,
        train_transform="shift1"))
    from veles_tpu.models.standard import StandardWorkflow as JStandard
    from veles_tpu_torch.models.standard import StandardWorkflow
    jwf = JStandard(JDummyLauncher(), **kwargs)
    twf = StandardWorkflow(DummyLauncher(), device="cpu", **kwargs)
    jax_mesh = jmesh.build_mesh(devices=jax.devices()[:2], data=2)
    assert fused.supports(twf) == jfused.supports(jwf) is True
    assert twf.loader.has_fill_transforms
    assert fused.supports(twf, mesh.build_mesh(devices=2, data=2)) \
        == jfused.supports(jwf, jax_mesh) is False


#: the CLI's toy workflow (tests/test_torch_cli.py's): minibatch 20
TINY_WF = '''
import numpy
from veles_tpu_torch.models.mlp import MLPWorkflow


def run(load, main):
    rng = numpy.random.RandomState(0)
    x = rng.rand(120, 6).astype(numpy.float32)
    y = (x[:, 0] > 0.5).astype(numpy.int32)
    load(MLPWorkflow, layers=(6, 2),
         loader_kwargs=dict(data=x, labels=y, class_lengths=[0, 40, 80],
                            minibatch_size=20),
         learning_rate=0.3, max_epochs=2, name="tiny")
    main()
'''


def test_cli_mesh_flags_run_a_two_process_world(tmp_path):
    """``--mesh data=2 --coordinator --num-processes --process-id
    --fleet-reduce bf16``: two processes train the toy data-parallel;
    rank 0 alone writes the result file."""
    wf_file = tmp_path / "tiny_wf.py"
    wf_file.write_text(TINY_WF)
    coordinator = "127.0.0.1:%d" % free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", str(wf_file), "-",
         "--device", "cpu", "--mesh", "data=2", "--coordinator",
         coordinator, "--num-processes", "2", "--process-id", str(rank),
         "--fleet-reduce", "bf16", "--seed", "3",
         "--result-file", str(tmp_path / ("r%d.json" % rank))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    try:
        logs = [proc.communicate(timeout=DEADLINE)[0] for proc in procs]
    except subprocess.TimeoutExpired:
        pytest.fail("the CLI world passed its %d s deadline" % DEADLINE)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
        assert "pod mode: Mesh(pipe=1, data=2" in log
        assert "over mesh Mesh(" in log
    assert json.load(open(tmp_path / "r0.json"))["epochs"] == 2
    assert not (tmp_path / "r1.json").exists()


def test_cli_coordinator_needs_the_world_size(restore_sigterm, capsys,
                                              tmp_path):
    from veles_tpu_torch.__main__ import DEFERRED, Main
    assert not {"mesh", "coordinator", "num_processes", "process_id",
                "fleet_reduce"} & set(DEFERRED)
    assert "serve_mesh" not in DEFERRED
    wf = tmp_path / "wf.py"
    wf.write_text("def run(load, main):\n    pass\n")
    with pytest.raises(SystemExit) as exc:
        Main().run([str(wf), "-", "--serve-mesh", "bogus=2"])
    assert exc.value.code == 2
    assert "--serve-mesh expects AXIS=N" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        Main().run(["wf.py", "-", "--coordinator", "127.0.0.1:1"])
    assert exc.value.code == 2
    assert "--coordinator requires --num-processes" \
        in capsys.readouterr().err
    with pytest.raises(SystemExit):
        Main().run(["wf.py", "-", "--fleet-reduce", "fp8"])
