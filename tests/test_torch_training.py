"""The port's training main path (MLPWorkflow → StandardWorkflow →
FusedTick, veles_tpu_torch/models, nn, loader, parallel/fused.py) against
the JAX package's on the CPU, from weights carried across
(``convert.unit_params_from_jax``).

The data is sklearn's digits set (64 features, 297 valid / 1500 train),
layers (32, 10), minibatch 100, 3 epochs: the JAX package's own fused
tests' configuration (tests/test_fused.py). Integer outputs (served
index matrices, class flags, per-epoch n_err, epoch counts, the stop
epoch) must be equal; weights agree within a stated tolerance. With the
kernel route forced open (the port's gate and JAX's), the JAX side runs
its Pallas kernels in interpret mode at precision level 2 (its interpret
mode cannot take bf16 operands on the CPU) — the whole workflow then
takes about 2 s there, so it runs whole."""

import os
import subprocess
import sys
import textwrap

import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu.ops import gemm as jgemm
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.ops import gemm
from veles_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: level 0 runs bf16 operands: the two packages round the same f32 sums
#: to bf16, and a sum that lands on the other side of a rounding boundary
#: moves a weight by one bf16 step of its update; over 45 SGD steps the
#: weights drift apart by ~1e-4 measured (the JAX package's own
#: fused-vs-graph tests allow 1e-3 for the same reason)
LEVEL0_ATOL = 1e-3
#: level 2 is f32 throughout: only the summation order differs (~1e-7
#: measured after 45 steps)
LEVEL2_ATOL = 1e-5


def _digits():
    from sklearn.datasets import load_digits
    digits = load_digits()
    x = digits.data.astype(numpy.float32)
    y = digits.target.astype(numpy.int32)
    perm = numpy.random.RandomState(0).permutation(len(x))
    return x[perm], y[perm]


def _kwargs(**overrides):
    x, y = _digits()
    kwargs = dict(layers=(32, 10),
                  loader_kwargs=dict(data=x, labels=y,
                                     class_lengths=[0, 297, 1500],
                                     minibatch_size=100,
                                     normalization_type="linear"),
                  learning_rate=0.1, max_epochs=3, name="parity")
    kwargs.update(overrides)
    return kwargs


def _record_epochs(wf):
    """Per-epoch (test, valid, train) error counts, in order."""
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append([int(s[0]) for s in stats])
        summary(stats, epoch)

    wf.decision._epoch_summary = recorded
    return seen


def _pair(**overrides):
    """A JAX workflow and the port's from its initial weights, both
    initialized, each with its epoch recorder."""
    jprng.get("default").seed(4321)
    jprng.get("loader").seed(8765)
    jwf = JMLPWorkflow(JDummyLauncher(), **_kwargs(**overrides))
    jwf.initialize()
    layers = [{"weights": numpy.asarray(f.weights.data),
               "bias": numpy.asarray(f.bias.data)} for f in jwf.forwards]
    prng.get("loader").seed(8765)
    twf = MLPWorkflow(DummyLauncher(), device="cpu", **_kwargs(**overrides))
    unit_params_from_jax(twf, layers)
    twf.initialize()
    return jwf, twf


def _run_and_compare(jwf, twf, atol):
    jepochs, tepochs = _record_epochs(jwf), _record_epochs(twf)
    jwf.run()
    twf.run()
    assert tepochs == jepochs
    for key in ("_epochs_done", "best_n_err", "best_epoch"):
        assert getattr(twf.decision, key) == getattr(jwf.decision, key)
    for jf, tf in zip(jwf.forwards, twf.forwards):
        numpy.testing.assert_allclose(tf.weights.data.numpy(),
                                      numpy.asarray(jf.weights.data),
                                      atol=atol, rtol=0)
        numpy.testing.assert_allclose(tf.bias.data.numpy(),
                                      numpy.asarray(jf.bias.data),
                                      atol=atol, rtol=0)
    return tepochs


@pytest.fixture
def engine(monkeypatch):
    """Engine knobs set on both packages' config for one test."""
    def set_knobs(**knobs):
        for cfg in (jroot, root):
            for key, value in knobs.items():
                monkeypatch.setattr(cfg.common.engine, key, value,
                                    raising=False)
    return set_knobs


@pytest.mark.parametrize("sweep,pipeline,level", [
    (True, True, 0), (True, False, 0), (False, False, 0), (True, True, 2)],
    ids=["pipelined", "sweep", "per-minibatch", "pipelined-f32"])
def test_mlp_workflow_matches_jax(engine, sweep, pipeline, level):
    """Knobs off (the default route): the pipelined product path, plain
    sweeps and per-minibatch ticks, at level 0 (bf16 operands) and 2."""
    engine(precision_level=level)
    jwf, twf = _pair(fused_sweep=sweep, fused_pipeline=pipeline)
    assert twf.fused_tick.pipelined == jwf.fused_tick.pipelined == pipeline
    assert twf.decision.pipeline_depth == jwf.decision.pipeline_depth
    epochs = _run_and_compare(jwf, twf,
                              LEVEL0_ATOL if level == 0 else LEVEL2_ATOL)
    assert len(epochs) == 3


def test_mlp_workflow_kernel_route_matches_jax(engine, monkeypatch):
    """Knobs on with both gates forced open: every layer takes the fused
    dense forward and its hand-written backward (the port's plain K5/K6
    versions, JAX's Pallas kernels in interpret mode), pipelined, level
    2. On the CPU no launch counter moves."""
    engine(precision_level=2, use_pallas=True, pallas_epilogue=True)
    monkeypatch.setattr(jgemm, "_pallas_eligible", lambda a, b: True)
    real_dense, real_mm = jgemm.pallas_dense, jgemm.pallas_matmul

    def interp_dense(a, b, bias, activation="linear", **kw):
        kw.update(bm=128, bn=128, bk=128, interpret=True)
        return real_dense(a, b, bias, activation=activation, **kw)

    def interp_mm(a, b, **kw):
        kw.update(bm=128, bn=128, bk=128, interpret=True)
        return real_mm(a, b, **kw)

    monkeypatch.setattr(jgemm, "pallas_dense", interp_dense)
    monkeypatch.setattr(jgemm, "pallas_matmul", interp_mm)
    jgemm._dense_with_vjp.cache_clear()
    routed = []
    real_function = gemm._DenseFunction.apply

    def counted(*args):
        routed.append(args[3])
        return real_function(*args)

    monkeypatch.setattr(gemm, "_kernel_eligible", lambda a, b: True)
    monkeypatch.setattr(gemm._DenseFunction, "apply", counted)
    launches = (gemm.blocked_matmul.launches, gemm.dense_epilogue.launches)
    try:
        jwf, twf = _pair()
        _run_and_compare(jwf, twf, LEVEL2_ATOL)
    finally:
        jgemm._dense_with_vjp.cache_clear()
    _, valid, train = twf.fused_tick.minibatch_counts
    assert routed.count("tanh") == routed.count("linear") \
        == valid + train == 3 * 3 + 3 * 15
    assert (gemm.blocked_matmul.launches,
            gemm.dense_epilogue.launches) == launches


@pytest.mark.parametrize("pipeline", [False, True])
def test_no_improvement_stop_matches_jax(engine, pipeline):
    """A fail_iterations stop (found one epoch late and rolled back in
    pipelined mode) stops both packages at the same epoch with the same
    weights."""
    engine(precision_level=2)
    jwf, twf = _pair(max_epochs=30, fail_iterations=1,
                     fused_pipeline=pipeline)
    epochs = _run_and_compare(jwf, twf, LEVEL2_ATOL)
    assert len(epochs) < 30, "the stop path was not exercised"


def test_loader_serving_matches_jax():
    """The served index matrices, valid sizes and class/epoch flags of
    three epochs of sweeps and of per-minibatch serving are equal to
    JAX's under the same prng seeds."""
    jprng.get("default").seed(1)
    jprng.get("loader").seed(2)
    jwf = JMLPWorkflow(JDummyLauncher(), **_kwargs())
    jwf.loader.initialize()
    prng.get("loader").seed(2)
    twf = MLPWorkflow(DummyLauncher(), device="cpu", **_kwargs())
    twf.loader.initialize()
    for _ in range(9):   # three epochs of (valid, train) sweeps
        want = jwf.loader.serve_next_class_sweep()
        got = twf.loader.serve_next_class_sweep()
        assert got[0] == want[0] and got[3:] == want[3:]
        numpy.testing.assert_array_equal(got[1], want[1])
        numpy.testing.assert_array_equal(got[2], want[2])
    twf.loader.fill_data = jwf.loader.fill_data = False
    for _ in range(40):  # per-minibatch, through run(): flags and indices
        jwf.loader.run()
        twf.loader.run()
        for name in ("minibatch_class", "minibatch_valid_size",
                     "epoch_number", "minibatch_offset"):
            assert getattr(twf.loader, name) == getattr(jwf.loader, name)
        for flag in ("last_minibatch", "epoch_ended",
                     "epoch_ended_for_class"):
            assert bool(getattr(twf.loader, flag)) \
                == bool(getattr(jwf.loader, flag))
        numpy.testing.assert_array_equal(
            twf.loader.minibatch_indices.data,
            numpy.asarray(jwf.loader.minibatch_indices.data))
    numpy.testing.assert_array_equal(
        twf.loader.original_labels.data.numpy(),
        numpy.asarray(jwf.loader.original_labels.data))


def test_fused_tick_counts_its_minibatches():
    prng.get("loader").seed(3)
    twf = MLPWorkflow(DummyLauncher(), device="cpu", **_kwargs(max_epochs=2))
    twf.initialize()
    twf.run()
    counts = twf.fused_tick.minibatch_counts
    assert counts[VALID] == 2 * 3 and counts[TRAIN] == 2 * 15
    assert twf.decision.epochs_done == 2
    # the unit Arrays hold the final (post-train) weights after the run
    assert twf.forwards[0].weights.data is \
        twf.fused_tick._params_[0]["p"]["w"]


def test_device_none_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MLPWorkflow(DummyLauncher(), **_kwargs())


def _fleet_pod_slave():
    """A fleet slave whose own mesh sizes the model axis, initialized."""
    from veles_tpu_torch.launcher import Launcher
    slave = Launcher(master_address="127.0.0.1:1")
    try:
        MLPWorkflow(slave, device="cpu",
                    **_kwargs(mesh=Mesh({"data": 2, "model": 2}))
                    ).initialize()
    finally:
        slave.stop()


@pytest.mark.parametrize("build,item", [
    (lambda: MLPWorkflow(DummyLauncher(), device="cpu",
                         **_kwargs(mesh=Mesh({"data": 2, "model": 2}))),
     r"ROADMAP A8 \(b\)"),
    (_fleet_pod_slave, r"ROADMAP A8 \(b\)"),
], ids=["mesh", "fleet-pod"])
def test_later_slices_raise(build, item):
    """A mesh axis other than data (ROADMAP A8 (b)) is a later slice, on a
    standalone run and on a fleet slave alike: it raises, it never runs
    another path (the data axis is ported, tests/test_torch_mesh.py, and
    a fleet slave over it, the fleet x pod composition,
    tests/test_torch_fleet_pod.py; so are the fleet,
    tests/test_torch_fleet.py, the MSE evaluator and the loader class:
    tests/test_torch_mse.py, test_torch_loaders.py)."""
    with pytest.raises(NotImplementedError, match=item):
        build()


def test_unit_params_from_jax_fills_before_initialize():
    weights = numpy.random.RandomState(4).rand(64, 32).astype(numpy.float32)
    twf = MLPWorkflow(DummyLauncher(), device="cpu", **_kwargs())
    unit_params_from_jax(twf, [
        {"weights": weights, "bias": numpy.zeros(32),
         "velocity_w": numpy.ones((64, 32))},
        {"weights": numpy.zeros((32, 10)), "bias": numpy.zeros(10)}])
    twf.initialize()
    assert torch.equal(twf.forwards[0].weights.data,
                       torch.from_numpy(weights))
    assert twf.forwards[0].bias.data.dtype == torch.float32
    assert torch.equal(twf.gds[0]._velocity_w.data, torch.ones(64, 32))
    assert not twf.gds[1]._velocity_w.data.any()
    with pytest.raises(ValueError):
        unit_params_from_jax(twf, [{}])


def test_training_path_imports_neither_jax_nor_veles_tpu():
    """The slice's modules import, and a tiny MLPWorkflow trains on the
    CPU, with JAX, the JAX package and PIL blocked."""
    code = textwrap.dedent("""
        import importlib, sys
        # PIL too: the card's machine has none, so the image loader and
        # external_mean may import it only to decode an image
        for name in ("jax", "jaxlib", "veles_tpu", "PIL"):
            sys.modules[name] = None
        import numpy
        names = ["veles_tpu_torch.core." + m for m in (
            "errors", "mutable", "config", "logger", "timing",
            "distributable", "pickling", "registry", "units", "plumbing",
            "executor", "workflow", "verified", "prng")] + [
            "veles_tpu_torch." + m for m in (
                "dummy", "memory", "convert", "ops.activations",
                "ops.losses", "ops.gather", "ops.gemm",
                "loader.normalization", "loader.base", "loader.fullbatch",
                "nn.jit_unit", "nn.all2all", "nn.gd", "nn.evaluator",
                "nn.decision", "parallel.fused", "models.standard",
                "models.mlp", "ops.augment", "nn.conv", "nn.pooling",
                "models.alexnet", "nn.attention", "nn.joiner",
                "nn.kohonen", "models.kohonen", "parallel.segments",
                "parallel.sweep", "ops.reduce", "ops.rng", "loader",
                "loader.mnist", "loader.pickles", "loader.file_loader",
                "loader.sound", "loader.saver", "loader.image")]
        for name in names:
            importlib.import_module(name)
        from veles_tpu_torch.dummy import DummyLauncher
        from veles_tpu_torch.models.mlp import MLPWorkflow
        rng = numpy.random.RandomState(0)
        wf = MLPWorkflow(DummyLauncher(), layers=(8, 3), device="cpu",
                         loader_kwargs=dict(
                             data=rng.rand(60, 5).astype(numpy.float32),
                             labels=rng.randint(0, 3, 60),
                             class_lengths=[0, 20, 40], minibatch_size=16),
                         max_epochs=2)
        wf.initialize()
        wf.run()
        assert wf.decision.epochs_done == 2
        # graph mode and the SOM, with JAX still blocked
        graph = MLPWorkflow(DummyLauncher(), layers=(8, 3), device="cpu",
                            loader_kwargs=dict(
                                data=rng.rand(60, 5).astype(numpy.float32),
                                labels=rng.randint(0, 3, 60),
                                class_lengths=[0, 20, 40],
                                minibatch_size=16),
                            max_epochs=1, fused=False)
        graph.initialize()
        graph.run()
        assert graph.decision.epochs_done == 1
        from veles_tpu_torch.models.kohonen import KohonenWorkflow
        som = KohonenWorkflow(DummyLauncher(), shape=(2, 2), device="cpu",
                              loader_kwargs=dict(
                                  data=rng.rand(40, 5).astype(numpy.float32),
                                  minibatch_size=16), max_epochs=1)
        som.initialize()
        som.run()
        assert som.trainer.steps == 3
        leaked = [m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "veles_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            env=env, capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr
    assert int(result.stdout.split()[-1]) == 51
