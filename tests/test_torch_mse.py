"""The port's regression family against the JAX package's on the CPU:
``ops/losses.masked_mse``/``mse``, ``ops/reduce``, ``ops/rng``,
``FullBatchLoaderMSE``, ``EvaluatorMSE`` + ``DecisionMSE`` and the MSE
chain in all four execution tiers (graph mode, the fused tick, the sweep
tier, the segment tier), from the same weights and loader seeds.

The workflow is tests/test_mse_workflow.py's ``_build`` (16 -> 24 tanh ->
4 linear, 1200 rows, 200 valid / 1000 train, minibatch 100), run at
precision level 2 (f32) in both packages: epochs and the best epoch are
equal, each epoch's validation MSE within 1e-5 relative, every weight
within 1e-4 of its leaf's largest element. The loss functions agree to
1e-6; ``reduce`` exactly; ``rng`` in shapes, dtypes and ranges only
(threefry and Philox streams do not cross)."""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.core.distributable import TriviallyDistributable as JTriv
from veles_tpu.core.units import Unit as JUnit
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.loader.fullbatch import FullBatchLoaderMSE as JLoaderMSE
from veles_tpu.models.standard import StandardWorkflow as JStandardWorkflow
from veles_tpu.ops import losses as jlosses
from veles_tpu.ops import reduce as jreduce
from veles_tpu.ops import rng as jrng
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.distributable import TriviallyDistributable
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.loader.fullbatch import FullBatchLoaderMSE
from veles_tpu_torch.models import mlp
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.nn.decision import DecisionMSE
from veles_tpu_torch.nn.evaluator import EvaluatorMSE
from veles_tpu_torch.ops import losses, reduce, rng

torch.set_num_threads(1)

LOSS_RTOL = 1e-6
MSE_RTOL = 1e-5
LEAF_RTOL = 1e-4


def _t(array):
    return torch.from_numpy(numpy.asarray(array))


# -- the ops ------------------------------------------------------------------

def test_masked_mse_and_mse_match_jax():
    rs = numpy.random.RandomState(11)
    out = rs.randn(8, 3, 2).astype(numpy.float32)
    target = rs.randn(8, 3, 2).astype(numpy.float32)
    mask = numpy.array([1] * 5 + [0] * 3, numpy.float32)
    want = jlosses.masked_mse(jnp.asarray(out), jnp.asarray(target),
                              jnp.asarray(mask), jnp.float32(5.0))
    got = losses.masked_mse(_t(out), _t(target), _t(mask), torch.tensor(5.0))
    for g, w in zip(got, want):
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(w),
                                      rtol=LOSS_RTOL, atol=LOSS_RTOL)
    for g, w in zip(losses.mse(_t(out), _t(target)),
                    jlosses.mse(jnp.asarray(out), jnp.asarray(target))):
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(w),
                                      rtol=LOSS_RTOL, atol=LOSS_RTOL)


@pytest.mark.parametrize("name", ["reduce_sum", "reduce_mean", "reduce_max"])
@pytest.mark.parametrize("axis", [0, 1])
def test_reduce_matches_jax(name, axis):
    x = numpy.random.RandomState(12).randint(-50, 50, (7, 5)).astype(
        numpy.float32)
    numpy.testing.assert_array_equal(
        getattr(reduce, name)(_t(x), axis).numpy(),
        numpy.asarray(getattr(jreduce, name)(jnp.asarray(x), axis)))


def test_argmin_rows_matches_jax():
    x = numpy.random.RandomState(13).rand(9, 6).astype(numpy.float32)
    numpy.testing.assert_array_equal(
        reduce.argmin_rows(_t(x)).numpy(),
        numpy.asarray(jreduce.argmin_rows(jnp.asarray(x))))


@pytest.mark.parametrize("name,args", [
    ("uniform", {"low": -2.0, "high": 3.0}),
    ("normal", {"mean": 1.0, "stddev": 0.5}),
    ("fill_uniform", {"vle": 0.25})])
def test_rng_shapes_dtypes_ranges(name, args):
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    shape = (300, 7)
    got = getattr(rng, name)(gen, shape, **args)
    want = numpy.asarray(getattr(jrng, name)(key, shape, **args))
    assert tuple(got.shape) == want.shape == shape
    assert got.dtype == torch.float32 and want.dtype == numpy.float32
    got = got.numpy()
    if name == "normal":
        for arr in (got, want):
            assert abs(arr.mean() - 1.0) < 0.1 and abs(arr.std() - 0.5) < 0.1
    else:
        low, high = ((args["low"], args["high"]) if name == "uniform"
                     else (-args["vle"], args["vle"]))
        for arr in (got, want):
            assert arr.min() >= low and arr.max() < high
            assert arr.max() - arr.min() > 0.9 * (high - low)
    # a generator is a stream: the next draw differs, the same seed repeats
    again = getattr(rng, name)(gen, shape, **args).numpy()
    assert not numpy.array_equal(again, got)
    numpy.testing.assert_array_equal(
        getattr(rng, name)(torch.Generator().manual_seed(0), shape,
                           **args).numpy(), got)


# -- the loader ---------------------------------------------------------------

def _cpu_workflow():
    wf = DummyWorkflow()
    wf.device = torch.device("cpu")
    return wf


def _regression_set(n=60, din=5, dout=3, seed=14):
    rs = numpy.random.RandomState(seed)
    return (rs.rand(n, din).astype(numpy.float32),
            rs.uniform(-2, 6, (n, dout)).astype(numpy.float32),
            rs.randint(0, 3, n))


@pytest.mark.parametrize("target_norm", ["none", "mean_disp", "pointwise"])
def test_loader_mse_targets_match_jax(target_norm):
    """Targets normalized by their own normalizer (analysed over the train
    split after the validation resplit), row-aligned through the resplit,
    and gathered by the served indices, as in the JAX loader."""
    data, targets, labels = _regression_set()
    kwargs = dict(data=data, targets=targets, labels=labels,
                  class_lengths=[0, 0, 60], validation_ratio=0.3,
                  minibatch_size=16, normalization_type="mean_disp",
                  target_normalization_type=target_norm)
    jprng.get("loader").seed(5)
    jl = JLoaderMSE(JDummyWorkflow(), **kwargs)
    jl.initialize()
    prng.get("loader").seed(5)
    tl = FullBatchLoaderMSE(_cpu_workflow(), **kwargs)
    tl.initialize()
    assert tl.class_lengths == jl.class_lengths == [0, 18, 42]
    assert tl.targets_shape == tuple(jl.targets_shape) == (3,)
    numpy.testing.assert_allclose(tl.original_targets.data.numpy(),
                                  numpy.asarray(jl.original_targets.data),
                                  rtol=LOSS_RTOL, atol=LOSS_RTOL)
    for key, value in jl.target_normalizer.jit_state().items():
        numpy.testing.assert_allclose(
            numpy.asarray(tl.target_normalizer.jit_state()[key]),
            numpy.asarray(value), rtol=LOSS_RTOL, atol=LOSS_RTOL)
    for _ in range(5):   # across the class and epoch boundary
        jl.run()
        tl.run()
        numpy.testing.assert_array_equal(
            tl.minibatch_indices.data,
            numpy.asarray(jl.minibatch_indices.data))
        assert tl.minibatch_targets.data.shape == (16, 3)
        numpy.testing.assert_allclose(
            tl.minibatch_targets.data.numpy(),
            numpy.asarray(jl.minibatch_targets.data),
            rtol=LOSS_RTOL, atol=LOSS_RTOL)
        numpy.testing.assert_allclose(
            tl.minibatch_data.data.numpy(),
            numpy.asarray(jl.minibatch_data.data), rtol=LOSS_RTOL,
            atol=LOSS_RTOL)


@pytest.mark.parametrize("name", ["linear", "exp"])
def test_target_normalizer_needing_sample_stats_is_refused(name):
    """A samplewise normalizer cannot map network output back to target
    units: both packages refuse it as the target normalizer (and the
    default, the data's own normalization type, when it is one)."""
    data, targets, _ = _regression_set()
    for make in (lambda **kw: JLoaderMSE(JDummyWorkflow(), **kw),
                 lambda **kw: FullBatchLoaderMSE(_cpu_workflow(), **kw)):
        with pytest.raises(ValueError, match="per-sample stats"):
            make(data=data, targets=targets,
                 target_normalization_type=name)
        with pytest.raises(ValueError, match="per-sample stats"):
            make(data=data, targets=targets, normalization_type=name)
        with pytest.raises(ValueError, match="unknown target"):
            make(data=data, targets=targets,
                 target_normalization_type="bogus")


def test_loader_mse_needs_targets():
    loader = FullBatchLoaderMSE(_cpu_workflow(),
                                data=numpy.zeros((4, 2), numpy.float32))
    with pytest.raises(NotImplementedError, match="targets="):
        loader.initialize()
    loader = FullBatchLoaderMSE(_cpu_workflow(),
                                data=numpy.zeros((4, 2), numpy.float32),
                                targets=numpy.zeros((3, 1), numpy.float32))
    with pytest.raises(ValueError, match="targets length"):
        loader.initialize()


# -- the workflow in four tiers -----------------------------------------------

class JSpy(JUnit, JTriv):
    """A host unit between the forwards (test_mse_workflow.py's Spy)."""

    sweep_transparent = False

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.ticks = 0

    def run(self):
        self.ticks += 1


class Spy(Unit, TriviallyDistributable):
    sweep_transparent = False

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.ticks = 0

    def run(self):
        self.ticks += 1


def _dataset(n=1200, din=16, dout=4):
    rs = numpy.random.RandomState(3)
    x = rs.rand(n, din).astype(numpy.float32)
    w = rs.randn(din, dout).astype(numpy.float32) * 0.4
    y = numpy.tanh(x @ w) + 0.01 * rs.randn(n, dout).astype(numpy.float32)
    return x, y.astype(numpy.float32)


def _kwargs(max_epochs, fused, **overrides):
    x, y = _dataset()
    kwargs = dict(
        layers=[{"type": "all2all_tanh", "output_sample_shape": (24,)},
                {"type": "all2all", "output_sample_shape": (4,)}],
        evaluator="mse",
        loader_kwargs=dict(data=x, targets=y, class_lengths=[0, 200, 1000],
                           minibatch_size=100, normalization_type="linear",
                           target_normalization_type="none"),
        learning_rate=0.1, gradient_moment=0.9,
        decision_kwargs=dict(max_epochs=max_epochs), fused=fused,
        name="mse-wf")
    kwargs.update(overrides)
    return kwargs


def _splice(wf, spy_cls, transparent):
    spy = spy_cls(wf, name="spy")
    spy.sweep_transparent = transparent
    fwd1 = wf.forwards[1]
    fwd1.unlink_from(wf.forwards[0])
    spy.link_from(wf.forwards[0])
    fwd1.link_from(spy)
    wf.spy = spy


def _record(wf):
    """Per-epoch average validation MSE, in order."""
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append(stats[VALID][2] / max(stats[VALID][1], 1))
        summary(stats, epoch)

    wf.decision._epoch_summary = recorded
    return seen


@pytest.fixture
def level2(monkeypatch):
    for cfg in (jroot, root):
        monkeypatch.setattr(cfg.common.engine, "precision_level", 2,
                            raising=False)


def _pair(tier, max_epochs=3, **overrides):
    """The JAX workflow and the port's from its initial weights, both
    initialized, with a host unit spliced in for the lower tiers (opaque
    for the segment tier, transparent for the sweep tier)."""
    fused = False if tier == "graph" else "auto"
    spliced = tier in ("segment", "sweep")
    jprng.get("default").seed(1111)
    jprng.get("loader").seed(2222)
    jwf = JStandardWorkflow(JDummyLauncher(),
                            **_kwargs(max_epochs, fused, **overrides))
    if spliced:
        _splice(jwf, JSpy, tier == "sweep")
    jwf.initialize()
    layers = [{"weights": numpy.asarray(f.weights.data),
               "bias": numpy.asarray(f.bias.data)} for f in jwf.forwards]
    prng.get("loader").seed(2222)
    twf = StandardWorkflow(DummyLauncher(), device="cpu",
                           **_kwargs(max_epochs, fused, **overrides))
    if spliced:
        _splice(twf, Spy, tier == "sweep")
    unit_params_from_jax(twf, layers)
    twf.initialize()
    return jwf, twf


def _tier(wf):
    """The engaged tier of either package's workflow (by the splice's
    class name, which the two packages share)."""
    names = {type(u).__name__ for u in wf.units}
    if wf.fused_tick is not None:
        return "fused"
    if "FusedSweep" in names:
        return "sweep"
    if "FusedSegment" in names:
        return "segment"
    return "graph"


def _leaf_rel(a, b):
    return float(numpy.abs(a - b).max() / max(numpy.abs(b).max(), 1e-30))


def _run_and_compare(jwf, twf):
    jmse, tmse = _record(jwf), _record(twf)
    jwf.run()
    twf.run()
    assert len(tmse) == len(jmse) == twf.decision.epochs_done
    numpy.testing.assert_allclose(tmse, jmse, rtol=MSE_RTOL)
    assert twf.decision.best_epoch == jwf.decision.best_epoch
    assert twf.decision.best_n_err[VALID] == pytest.approx(
        jwf.decision.best_n_err[VALID], rel=MSE_RTOL)
    for jf, tf in zip(jwf.forwards, twf.forwards):
        for name in ("weights", "bias"):
            assert _leaf_rel(getattr(tf, name).data.numpy(),
                             numpy.asarray(getattr(jf, name).data)) \
                <= LEAF_RTOL
    return tmse


@pytest.mark.parametrize("tier", ["graph", "fused", "sweep", "segment"])
def test_mse_workflow_matches_jax(level2, tier):
    jwf, twf = _pair(tier)
    assert _tier(twf) == _tier(jwf) == tier
    if tier == "fused":
        assert twf.fused_tick._loss_kind_ == "mse"
    epochs = _run_and_compare(jwf, twf)
    assert epochs[-1] < epochs[0]
    if tier in ("segment", "sweep"):
        assert twf.spy.ticks == jwf.spy.ticks > 0


def test_mse_fused_matches_graph_in_the_port(level2):
    """The fused tick against graph mode inside the port, as
    tests/test_mse_workflow.py holds them in the JAX package."""
    runs = []
    for fused in (False, "auto"):
        prng.get("default").seed(1111)
        prng.get("loader").seed(2222)
        wf = StandardWorkflow(DummyLauncher(), device="cpu",
                              **_kwargs(4, fused))
        wf.initialize()
        mse = _record(wf)
        wf.run()
        runs.append((wf, mse))
    (graph, gmse), (fused, fmse) = runs
    assert _tier(graph) == "graph" and _tier(fused) == "fused"
    numpy.testing.assert_allclose(fmse, gmse, rtol=MSE_RTOL)
    for fg, ff in zip(graph.forwards, fused.forwards):
        assert _leaf_rel(ff.weights.data.numpy(),
                         fg.weights.data.numpy()) <= LEAF_RTOL


@pytest.mark.parametrize("pipeline", [True, False])
def test_mse_stop_decisions_match_jax(level2, pipeline):
    """A no-improvement stop (found one epoch late and rolled back in
    pipelined mode: DecisionMSE peeks the lagged VALID loss) stops both
    packages at the same epoch with the same weights."""
    jwf, twf = _pair("fused", max_epochs=30, fused_pipeline=pipeline,
                     learning_rate=0.2,
                     decision_kwargs=dict(max_epochs=30, fail_iterations=1))
    assert twf.decision.pipeline_depth == jwf.decision.pipeline_depth \
        == int(pipeline)
    epochs = _run_and_compare(jwf, twf)
    assert len(epochs) < 30, "the stop path was not exercised"


def test_fused_declines_mse_over_a_plain_loader():
    """EvaluatorMSE over a plain FullBatchLoader: the fused tick declines
    (no original_targets to gather) and "auto" falls to the sweep tier,
    which reads the targets from the loader's minibatch slot."""
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.parallel import fused

    class TargetsLoader(FullBatchLoader):
        """A plain full-batch loader that fills a target slot itself."""

        def __init__(self, workflow, **kwargs):
            self.targets = kwargs.pop("targets")
            super().__init__(workflow, **kwargs)
            from veles_tpu_torch.memory import Array
            self.minibatch_targets = Array()

        def fill_minibatch(self, indices, valid):
            super().fill_minibatch(indices, valid)
            self.minibatch_targets.data = torch.from_numpy(
                self.targets[numpy.asarray(indices)])

    prng.get("loader").seed(2222)
    wf = StandardWorkflow(DummyLauncher(), device="cpu",
                          loader_cls=TargetsLoader,
                          **_kwargs(2, "auto"))
    assert not fused.supports(wf)
    wf.initialize()
    assert _tier(wf) == "segment"
    wf.run()
    assert wf.decision.epochs_done == 2
    assert isinstance(wf.evaluator, EvaluatorMSE)
    assert isinstance(wf.decision, DecisionMSE)


def test_mse_metrics_and_suffix():
    prng.get("loader").seed(2222)
    wf = StandardWorkflow(DummyLauncher(), device="cpu", **_kwargs(2, False))
    wf.initialize()
    wf.run()
    assert wf.decision.snapshot_suffix.startswith("validation_mse_")
    assert wf.decision.get_metric_names()[0] == "best_validation_mse"
    assert wf.decision.best_mse[VALID] == wf.decision.best_n_err[VALID]
    assert isinstance(wf.loader, FullBatchLoaderMSE)
    assert float(wf.evaluator.max_err.data) > 0


def test_mlp_workflow_takes_mse_and_a_loader_class():
    """MLPWorkflow passes evaluator= and loader_cls= through; evaluator
    names outside softmax/mse are refused."""
    x, y = _dataset(n=300)
    wf = mlp.MLPWorkflow(
        DummyLauncher(), layers=(8, 4), device="cpu", evaluator="mse",
        loader_cls=FullBatchLoaderMSE,
        loader_kwargs=dict(data=x, targets=y, class_lengths=[0, 100, 200],
                           minibatch_size=50,
                           target_normalization_type="none"),
        max_epochs=1)
    wf.initialize()
    wf.run()
    assert wf.decision.epochs_done == 1
    with pytest.raises(ValueError, match="evaluator must be"):
        mlp.MLPWorkflow(DummyLauncher(), device="cpu", evaluator="hinge",
                        loader_kwargs=dict(data=x, labels=y[:, 0] > 0))
