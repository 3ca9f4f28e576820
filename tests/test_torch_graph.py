"""Graph mode in the port (``fused=False``: every unit fires its own
compute, veles_tpu_torch/nn/*.py) against the JAX package's graph mode on
the CPU, from the JAX workflow's initial state carried across
(``convert.unit_state_of`` -> ``unit_params_from_jax``), and against the
port's own fused tick.

Shapes: sklearn's digits (64 features, 297 valid / 1500 train), layers
(32, 10), minibatch 100, the JAX package's fused-vs-graph configuration
(tests/test_fused.py); the convnet and the transformer blocks are in
tests/test_torch_graph_blocks.py. Integer outputs (per-epoch n_err, epoch
counts, the best epoch) must be equal; weights agree within the stated
tolerance: 1e-3 at level 0 (bf16 operands: a sum that lands on the other
side of a bf16 rounding boundary moves a weight by one bf16 step of its
update), 1e-5 at level 2 (f32: only the summation order differs)."""

import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu.ops import gemm as jgemm
from veles_tpu_torch.convert import unit_params_from_jax, unit_state_of
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.ops import gemm

torch.set_num_threads(1)

LEVEL0_ATOL = 1e-3
LEVEL2_ATOL = 1e-5
LEAVES = ("weights", "bias", "out_weights", "out_bias")


def _digits(images=False):
    from sklearn.datasets import load_digits
    digits = load_digits()
    x = (digits.images[..., None] if images else digits.data)
    x = x.astype(numpy.float32)
    y = digits.target.astype(numpy.int32)
    perm = numpy.random.RandomState(0).permutation(len(x))
    return x[perm], y[perm]


@pytest.fixture
def engine(monkeypatch):
    """Engine knobs set on both packages' config for one test."""
    def set_knobs(**knobs):
        for cfg in (jroot, root):
            for key, value in knobs.items():
                monkeypatch.setattr(cfg.common.engine, key, value,
                                    raising=False)
    return set_knobs


def _record_epochs(wf):
    """Per-epoch (test, valid, train) error counts, in order."""
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append([int(s[0]) for s in stats])
        summary(stats, epoch)

    wf.decision._epoch_summary = recorded
    return seen


def mlp_kwargs(**overrides):
    x, y = _digits()
    kwargs = dict(layers=(32, 10),
                  loader_kwargs=dict(data=x, labels=y,
                                     class_lengths=[0, 297, 1500],
                                     minibatch_size=100,
                                     normalization_type="linear"),
                  learning_rate=0.1, max_epochs=3, name="graph")
    kwargs.update(overrides)
    return kwargs


def pair(jcls, tcls, seeds=(4321, 8765), **kwargs):
    """A JAX workflow (initialized) and the port's from its initial
    state, the loader streams seeded alike; ``kwargs`` go to both."""
    jprng.get("default").seed(seeds[0])
    jprng.get("loader").seed(seeds[1])
    jwf = jcls(JDummyLauncher(), **kwargs)
    jwf.initialize()
    prng.get("loader").seed(seeds[1])
    twf = tcls(DummyLauncher(), device="cpu", **kwargs)
    unit_params_from_jax(twf, unit_state_of(jwf))
    twf.initialize()
    return jwf, twf


def run_and_compare(jwf, twf, atol):
    """Run both; per-epoch n_err, the epoch count and the best epoch
    equal; every leaf of every forward within ``atol``."""
    jepochs, tepochs = _record_epochs(jwf), _record_epochs(twf)
    jwf.run()
    twf.run()
    assert tepochs == jepochs
    for key in ("_epochs_done", "best_n_err", "best_epoch"):
        assert getattr(twf.decision, key) == getattr(jwf.decision, key)
    compare_leaves(jwf, twf, atol)
    return tepochs


def compare_leaves(a, b, atol):
    for fa, fb in zip(a.forwards, b.forwards):
        for attr in LEAVES:
            slot = getattr(fa, attr, None)
            if slot is None or getattr(slot, "data", None) is None:
                continue
            numpy.testing.assert_allclose(
                numpy.asarray(getattr(fb, attr).mem),
                numpy.asarray(slot.mem), atol=atol, rtol=0)


@pytest.mark.parametrize("solver", ["momentum", "adam", "adagrad"])
@pytest.mark.parametrize("level", [0, 2])
def test_mlp_graph_mode_matches_jax(engine, solver, level):
    """The MLP in graph mode, each solver, at level 0 (bf16 operands)
    and 2 (f32): the port's units against the JAX package's."""
    engine(precision_level=level)
    extra = {"gradient_moment": 0.9} if solver == "momentum" else {}
    jwf, twf = pair(JMLPWorkflow, MLPWorkflow, fused=False, solver=solver,
                    **mlp_kwargs(learning_rate=0.1 if solver == "momentum"
                                 else 0.01, **extra))
    assert twf.fused_tick is None and twf.sweep_unit is None
    epochs = run_and_compare(jwf, twf,
                             LEVEL0_ATOL if level == 0 else LEVEL2_ATOL)
    assert len(epochs) == 3
    if solver != "momentum":
        # 3 epochs x 15 train minibatches, every tier's update count
        for gd in twf.gds:
            assert float(gd._step.data) == 45.0


def test_mlp_graph_mode_kernel_route_matches_jax(engine, monkeypatch):
    """use_pallas on with both gates forced open: every product of the
    forwards and GD units goes through the kernel wrapper (K5's plain
    version on the CPU, JAX's Pallas kernel in interpret mode), level 2;
    counted per minibatch: two products a layer forward, four backward."""
    engine(precision_level=2, use_pallas=True)
    monkeypatch.setattr(jgemm, "_pallas_eligible", lambda a, b: True)
    real_mm = jgemm.pallas_matmul

    def interp_mm(a, b, **kw):
        kw.update(bm=128, bn=128, bk=128, interpret=True)
        return real_mm(a, b, **kw)

    monkeypatch.setattr(jgemm, "pallas_matmul", interp_mm)
    routed = []
    real_blocked = gemm.blocked_matmul

    def counted(a, b, out_dtype=torch.float32):
        routed.append(tuple(a.shape) + tuple(b.shape[1:]))
        return real_blocked(a, b, out_dtype=out_dtype)

    monkeypatch.setattr(gemm, "_kernel_eligible", lambda a, b: True)
    monkeypatch.setattr(gemm, "blocked_matmul", counted)
    launches = real_blocked.launches
    jwf, twf = pair(JMLPWorkflow, MLPWorkflow, fused=False,
                    **mlp_kwargs(max_epochs=2))
    run_and_compare(jwf, twf, LEVEL2_ATOL)
    # 2 epochs x (3 valid + 15 train) minibatches: 2 forward products
    # each, 4 backward products a train minibatch
    assert len(routed) == 2 * (3 * 2 + 15 * 6)
    assert (64, 100, 32) in routed        # the first weight gradient
    assert real_blocked.launches == launches   # CPU: no launch counted


def _port(kwargs, fused, seeds=(4321, 8765), cls=MLPWorkflow):
    prng.get("default").seed(seeds[0])
    prng.get("loader").seed(seeds[1])
    wf = cls(DummyLauncher(), device="cpu", fused=fused, **kwargs)
    wf.initialize()
    return wf


def test_graph_mode_annealing_applies():
    """set_learning_rate() reaches graph mode (the hyper slot is an input
    of every GD compute): lr = 0 freezes the weights."""
    wf = _port(mlp_kwargs(max_epochs=1), False)
    for gd in wf.gds:
        gd.set_learning_rate(0.0)
    w0 = wf.forwards[0].weights.data.clone()
    wf.run()
    assert wf.decision.epochs_done == 1
    assert torch.equal(w0, wf.forwards[0].weights.data)


def test_graph_mode_annealing_matches_jax(engine):
    """Annealing mid-run: both packages' GD units take the halved rate
    from the second epoch on (``scale_learning_rate`` at the first epoch
    boundary), level 2."""
    engine(precision_level=2)
    jwf, twf = pair(JMLPWorkflow, MLPWorkflow, fused=False,
                    **mlp_kwargs(max_epochs=2))
    for wf in (jwf, twf):
        inner = wf.decision._on_epoch_ended

        def halved(wf=wf, inner=inner):
            inner()
            for gd in wf.gds:
                gd.scale_learning_rate(0.5)

        wf.decision._on_epoch_ended = halved
    run_and_compare(jwf, twf, LEVEL2_ATOL)
    assert twf.gds[0].learning_rate == jwf.gds[0].learning_rate == 0.025


def test_graph_mode_unit_run_is_its_compute():
    """A unit's run() is its own compute over its slots: the softmax head
    writes logits and their argmax."""
    wf = _port(mlp_kwargs(), False)
    wf.loader.run()
    for fwd in wf.forwards:
        fwd.run()
    logits = wf.forwards[1].output.data
    assert logits.shape == (100, 10)
    assert torch.equal(wf.forwards[1].max_idx.data, logits.argmax(dim=-1))
    x = wf.loader.minibatch_data.data
    hidden = wf.forwards[0].output.data
    # level 0: bf16 operands, an f32 product
    w = wf.forwards[0].weights.data
    want = 1.7159 * torch.tanh(0.6666 * (
        x.bfloat16().float() @ w.bfloat16().float()
        + wf.forwards[0].bias.data))
    torch.testing.assert_close(hidden, want, rtol=1e-5, atol=1e-5)


def test_disable_fused_restores_graph_mode(engine):
    """_disable_fused() reverses the fused tick's splice: the chain runs
    in graph mode, with graph mode's results."""
    engine(precision_level=2)
    graph = _port(mlp_kwargs(max_epochs=2), False)
    graph.run()
    wf = _port(mlp_kwargs(max_epochs=2), True)
    assert wf.fused_tick is not None
    wf._disable_fused()
    assert wf.fused_tick is None and wf.loader.fill_data
    wf.run()
    assert wf.decision.epochs_done == graph.decision.epochs_done == 2
    compare_leaves(graph, wf, LEVEL2_ATOL)


def test_input_joiner_matches_jax():
    """InputJoiner: the inputs' flattened samples joined along the sample
    axis over the rows all inputs have, offsets and lengths published,
    as the JAX package's (``nn/joiner.py:21-72``)."""
    from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
    from veles_tpu.memory import Array as JArray
    from veles_tpu.nn.joiner import InputJoiner as JInputJoiner
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.nn.joiner import InputJoiner
    rng = numpy.random.RandomState(3)
    parts = [rng.rand(6, 4).astype(numpy.float32),
             rng.rand(5, 2, 3).astype(numpy.float32),
             rng.rand(7, 1).astype(numpy.float32)]
    jjoin = JInputJoiner(JDummyWorkflow(), inputs=[JArray(p) for p in parts])
    tjoin = InputJoiner(DummyWorkflow(),
                        inputs=[Array(torch.from_numpy(p)) for p in parts])
    for join in (jjoin, tjoin):
        join.initialize()
        join.run()
    for i in range(3):
        for attr in ("offset_%d" % i, "length_%d" % i):
            assert getattr(tjoin, attr) == getattr(jjoin, attr)
    assert tjoin.output.shape == (5, 11)
    numpy.testing.assert_array_equal(tjoin.output.mem,
                                     numpy.asarray(jjoin.output.mem))
    with pytest.raises(ValueError):
        InputJoiner(DummyWorkflow()).initialize()
