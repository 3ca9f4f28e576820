"""The sweep tier in the port (veles_tpu_torch/parallel/sweep.py): any
JitUnit chain the fused tick declines runs its units' own computes over
whole class sweeps, with graph mode's numbers; the shapes of
tests/test_sweep.py:89-290 and :335 (the MSE chain and the snapshot
resume are later slices), and parity with the JAX package's sweep tier
from the same initial state.

A random 1200 x 64 set (300 valid / 900 train), layers (24, 10),
minibatch 100. Integer outputs (per-epoch n_err, epoch counts, the best
epoch, the observer's ticks, the Adam step) are equal; weights agree
within 1e-3 at level 0 (the JAX package's own bound for this tier,
bf16 operands) and 1e-5 at level 2."""

import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.core.distributable import TriviallyDistributable as JTriv
from veles_tpu.core.units import Unit as JUnit
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu.parallel.sweep import FusedSweep as JFusedSweep
from veles_tpu_torch.convert import unit_params_from_jax, unit_state_of
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.distributable import TriviallyDistributable
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.models import standard as std
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.nn.all2all import All2AllTanh
from veles_tpu_torch.nn.gd import GDTanh
from veles_tpu_torch.parallel.segments import FusedSegment
from veles_tpu_torch.parallel.sweep import FusedSweep

torch.set_num_threads(1)

LEVEL0_ATOL = 1e-3
LEVEL2_ATOL = 1e-5


class Observer(Unit, TriviallyDistributable):
    """A transparent host unit: counts ticks, touches no slots."""

    sweep_transparent = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.ticks = 0

    def run(self):
        self.ticks += 1


class OpaqueObserver(Observer):
    """The same unit without the transparency declaration."""

    sweep_transparent = False


class JObserver(JUnit, JTriv):
    """The JAX package's transparent observer."""

    sweep_transparent = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.ticks = 0

    def run(self):
        self.ticks += 1


def _dataset(n=1200, features=64, classes=10):
    rng = numpy.random.RandomState(7)
    data = rng.rand(n, features).astype(numpy.float32)
    labels = rng.randint(0, classes, n).astype(numpy.int32)
    return data, labels


def _kwargs(max_epochs=3, **overrides):
    data, labels = _dataset()
    kwargs = dict(layers=(24, 10),
                  loader_kwargs=dict(data=data, labels=labels,
                                     class_lengths=[0, 300, 900],
                                     minibatch_size=100,
                                     normalization_type="linear"),
                  learning_rate=0.1, max_epochs=max_epochs,
                  name="sweep-test")
    kwargs.update(overrides)
    return kwargs


def _splice(wf, observer_cls):
    obs = observer_cls(wf, name="observer")
    fwd1 = wf.forwards[1]
    fwd1.unlink_from(wf.forwards[0])
    obs.link_from(wf.forwards[0])
    fwd1.link_from(obs)
    wf.observer = obs
    return wf


def _build(observer_cls=None, **kwargs):
    prng.get("default").seed(4321)
    prng.get("loader").seed(8765)
    wf = MLPWorkflow(DummyLauncher(), device="cpu", **_kwargs(**kwargs))
    return _splice(wf, observer_cls) if observer_cls else wf


def _train(wf):
    wf.initialize()
    wf.run()
    return wf


def _assert_parity(a, b, atol=LEVEL0_ATOL):
    assert a.decision.best_n_err[VALID] == b.decision.best_n_err[VALID]
    assert a.decision._epochs_done == b.decision._epochs_done
    assert a.decision.last_epoch_n_err == b.decision.last_epoch_n_err
    for fa, fb in zip(a.forwards, b.forwards):
        numpy.testing.assert_allclose(numpy.asarray(fa.weights.mem),
                                      numpy.asarray(fb.weights.mem),
                                      atol=atol, rtol=0)


def test_sweep_engages_and_matches_graph_mode():
    """A transparent host unit mid-chain: the fused tick declines, the
    sweep tier takes over, and the results are graph mode's."""
    graph = _train(_build(Observer, fused=False))
    swept = _train(_build(Observer, fused="auto"))
    assert swept.fused_tick is None, "the fused tick must decline"
    assert isinstance(swept.sweep_unit, FusedSweep), "no sweep tier"
    assert swept.sweep_unit.ticks > 0
    _assert_parity(graph, swept)


def test_sweep_host_unit_fires_per_tick():
    swept = _train(_build(Observer, fused="auto", max_epochs=2))
    assert isinstance(swept.sweep_unit, FusedSweep)
    graph = _train(_build(Observer, fused=False, max_epochs=2))
    # 3 VALID + 9 TRAIN minibatches an epoch, 2 epochs: graph mode fires
    # the observer once a tick
    assert swept.observer.ticks == graph.observer.ticks == 2 * 12


def test_opaque_host_unit_falls_back_to_segments():
    """No transparency declaration: the per-tick segment tier (the unit
    may read per-minibatch slot state)."""
    wf = _train(_build(OpaqueObserver, fused="auto", max_epochs=1))
    assert wf.sweep_unit is None and wf.fused_tick is None
    assert any(isinstance(u, FusedSegment) for u in wf.units)
    assert wf.decision.epochs_done == 1


def test_fused_true_refuses_what_the_tick_cannot_fuse():
    """fused=True does not fall back: a spliced host unit raises."""
    with pytest.raises(ValueError, match="fused=True"):
        _build(Observer, fused=True).initialize()


class ScaledTanh(All2AllTanh):
    """A custom forward: the tanh layer with a 1.1 output scale (a
    compute of its own, unknown to extract_model_spec)."""

    def compute(self, *tensors):
        return super().compute(*tensors) * 1.1


class GDScaledTanh(GDTanh):
    def compute(self, err_output, x, y, weights, bias, vel_w, vel_b,
                *rest):
        # d(1.1 t)/dt: the scale into the error, out of the saved output
        return super().compute(err_output * 1.1, x, y / 1.1, weights,
                               bias, vel_w, vel_b, *rest)


def test_sweep_custom_jit_layer(monkeypatch):
    """A layer type the fused tick has never heard of (a custom JitUnit
    subclass) still reaches the sweep tier."""
    monkeypatch.setitem(std.FORWARD_TYPES, "scaled_tanh",
                        (ScaledTanh, GDScaledTanh))
    data, labels = _dataset()

    def build(fused):
        prng.get("default").seed(11)
        prng.get("loader").seed(22)
        return std.StandardWorkflow(
            DummyLauncher(), device="cpu",
            layers=[{"type": "scaled_tanh", "output_sample_shape": (24,)},
                    {"type": "softmax", "output_sample_shape": (10,)}],
            loader_kwargs=dict(data=data, labels=labels,
                               class_lengths=[0, 300, 900],
                               minibatch_size=100,
                               normalization_type="linear"),
            learning_rate=0.05, fused=fused,
            decision_kwargs=dict(max_epochs=2), name="custom-layer")

    graph = _train(build(False))
    swept = _train(build("auto"))
    assert swept.fused_tick is None
    assert isinstance(swept.sweep_unit, FusedSweep)
    _assert_parity(graph, swept)


def test_sweep_adam_solver_state_carries(monkeypatch):
    """Adam's second moments and step carry from minibatch to minibatch
    and from chunk to chunk: 2 epochs end after the same 18 updates in
    graph mode and in the sweep (chunks of 4 minibatches)."""
    monkeypatch.setattr(root.common.engine, "sweep_chunk", 4,
                        raising=False)
    graph = _train(_build(Observer, fused=False, solver="adam",
                          max_epochs=2))
    swept = _train(_build(Observer, fused="auto", solver="adam",
                          max_epochs=2))
    assert isinstance(swept.sweep_unit, FusedSweep)
    assert float(swept.gds[0]._step.data) == 18.0
    assert float(graph.gds[0]._step.data) == 18.0
    # 2 epochs: a VALID sweep of 3 minibatches (1 chunk) and a TRAIN
    # sweep of 9 (3 chunks)
    assert swept.sweep_unit.chunk_calls == 2 * (1 + 3)
    _assert_parity(graph, swept)


def test_sweep_gate_mutation_slow_path():
    """A birth gate .set() after the splice: the sweep runs per unit and
    honours the gate, as graph mode does."""
    swept = _build(Observer, fused="auto", max_epochs=2)
    swept.initialize()
    assert isinstance(swept.sweep_unit, FusedSweep)
    swept.observer.gate_skip.set()
    swept.run()
    assert swept.decision._epochs_done == 2
    assert swept.observer.ticks == 0
    assert getattr(swept.sweep_unit, "_warned_slow_", False)
    assert swept.sweep_unit.chunk_calls == 0


def test_sweep_slow_path_matches_graph_mode():
    """The slow path's per-unit firing gives graph mode's results (the
    observer skipped on both sides)."""
    graph = _build(Observer, fused=False, max_epochs=2)
    graph.observer.gate_skip.set()
    _train(graph)
    swept = _build(Observer, fused="auto", max_epochs=2)
    swept.initialize()
    swept.observer.gate_skip.set()
    swept.run()
    _assert_parity(graph, swept, LEVEL2_ATOL)


def test_sweep_pipelined_identical_on_max_epochs_stop():
    """Pipelined sweeps (metrics one epoch late) give exactly the plain
    sweep run's outputs on a max_epochs stop."""
    plain = _train(_build(Observer, fused="auto", max_epochs=4,
                          fused_pipeline=False))
    piped = _train(_build(Observer, fused="auto", max_epochs=4,
                          fused_pipeline=True))
    assert piped.sweep_unit.pipelined and not plain.sweep_unit.pipelined
    assert piped.decision._epochs_done == plain.decision._epochs_done
    assert piped.decision.best_n_err[VALID] == plain.decision.best_n_err[
        VALID]
    assert piped.decision.best_epoch == plain.decision.best_epoch
    for fp, fs in zip(plain.forwards, piped.forwards):
        assert torch.equal(fp.weights.data, fs.weights.data)


def test_sweep_pipelined_identical_on_no_improvement_stop():
    """The lagged no-improvement stop drops the speculative epoch and
    rolls the state back: outputs identical to the unpipelined run."""
    kwargs = dict(fused="auto", max_epochs=50, fail_iterations=2)
    plain = _train(_build(Observer, fused_pipeline=False, **kwargs))
    piped = _train(_build(Observer, fused_pipeline=True, **kwargs))
    assert piped.sweep_unit.pipelined
    assert piped.decision._epochs_done == plain.decision._epochs_done < 50
    assert piped.decision.best_n_err[VALID] == plain.decision.best_n_err[
        VALID]
    assert piped.decision.best_epoch == plain.decision.best_epoch
    for fp, fs in zip(plain.forwards, piped.forwards):
        assert torch.equal(fp.weights.data, fs.weights.data)


def test_sweep_dispatch_count():
    """The tier's claim in structural form: one firing per class sweep
    (2 an epoch), not one per minibatch."""
    swept = _build(Observer, fused="auto", max_epochs=3)
    swept.initialize()
    unit = swept.sweep_unit
    assert isinstance(unit, FusedSweep)
    swept.run()
    assert unit.ticks == 6
    assert swept.observer.ticks == 3 * 12


def test_sweep_disable_restores_graph_mode():
    """disable() relinks the original cycle: the run is graph mode's."""
    graph = _train(_build(Observer, fused=False, max_epochs=2))
    wf = _build(Observer, fused="auto", max_epochs=2)
    wf.initialize()
    wf.sweep_unit.disable()
    assert wf.sweep_unit is None and wf.loader.fill_data
    wf.run()
    _assert_parity(graph, wf, LEVEL2_ATOL)


@pytest.mark.parametrize("solver,level", [("momentum", 2), ("adam", 2),
                                          ("momentum", 0)])
def test_sweep_matches_jax(monkeypatch, solver, level):
    """The port's sweep tier against the JAX package's, from the JAX
    workflow's initial state, the observer spliced on both sides."""
    for cfg in (jroot, root):
        monkeypatch.setattr(cfg.common.engine, "precision_level", level,
                            raising=False)
    kwargs = _kwargs(max_epochs=2, solver=solver,
                     learning_rate=0.1 if solver == "momentum" else 0.01)
    jprng.get("default").seed(4321)
    jprng.get("loader").seed(8765)
    jwf = _splice(JMLPWorkflow(JDummyLauncher(), **kwargs), JObserver)
    jwf.initialize()
    assert isinstance(jwf.sweep_unit, JFusedSweep)
    prng.get("loader").seed(8765)
    twf = _splice(MLPWorkflow(DummyLauncher(), device="cpu", **kwargs),
                  Observer)
    unit_params_from_jax(twf, unit_state_of(jwf))
    twf.initialize()
    assert isinstance(twf.sweep_unit, FusedSweep)
    seen = []
    for wf in (jwf, twf):
        epochs = []
        summary = wf.decision._epoch_summary

        def recorded(stats, epoch, epochs=epochs, summary=summary):
            epochs.append([int(s[0]) for s in stats])
            summary(stats, epoch)

        wf.decision._epoch_summary = recorded
        wf.run()
        seen.append(epochs)
    assert seen[0] == seen[1]
    assert twf.observer.ticks == jwf.observer.ticks
    assert twf.sweep_unit.ticks == jwf.sweep_unit.ticks
    _assert_parity(jwf, twf, LEVEL0_ATOL if level == 0 else LEVEL2_ATOL)
