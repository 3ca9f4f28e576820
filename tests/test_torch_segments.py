"""The segment tier in the port (veles_tpu_torch/parallel/segments.py):
runs of consecutive JitUnits fire as one composite unit each, with
graph mode's numbers; the shapes of tests/test_segments.py:53-160 (the
digits MLP, a host unit spliced into the chain, a monitor off a
mid-segment member, the Adam solver), and parity with the JAX package's
segment tier from the same initial state. Integer outputs (per-epoch
n_err, tick and epoch counts) are equal; weights agree within 1e-5 at
precision level 2 (f32, summation order only)."""

import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.core.distributable import TriviallyDistributable as JTriv
from veles_tpu.core.units import Unit as JUnit
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu.parallel import segments as jsegments
from veles_tpu_torch.convert import unit_params_from_jax, unit_state_of
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.distributable import TriviallyDistributable
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.parallel import segments

torch.set_num_threads(1)

ATOL = 1e-5


def _digits():
    from dataset_fixtures import digits_dataset
    return digits_dataset()


def _kwargs(max_epochs=3, **overrides):
    x, y = _digits()
    kwargs = dict(layers=(32, 10),
                  loader_kwargs=dict(data=x, labels=y,
                                     class_lengths=[0, 297, 1500],
                                     minibatch_size=100,
                                     normalization_type="linear"),
                  learning_rate=0.1, max_epochs=max_epochs, fused=False,
                  name="segments-test")
    kwargs.update(overrides)
    return kwargs


def _build(**kwargs):
    prng.get("default").seed(4321)
    prng.get("loader").seed(8765)
    return MLPWorkflow(DummyLauncher(), device="cpu", **_kwargs(**kwargs))


@pytest.fixture(autouse=True)
def level2(monkeypatch):
    for cfg in (jroot, root):
        monkeypatch.setattr(cfg.common.engine, "precision_level", 2,
                            raising=False)


class HostSpy(Unit, TriviallyDistributable):
    """A custom pure-host unit spliced into the chain: the segment tier
    must keep it between two segments."""

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.ticks = 0
        self.seen_shapes = set()
        self.watched = None

    def run(self):
        self.ticks += 1
        if self.watched is not None and self.watched.data is not None:
            self.seen_shapes.add(tuple(self.watched.data.shape))


class JHostSpy(JUnit, JTriv):
    """The same unit in the JAX package."""

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.ticks = 0

    def run(self):
        self.ticks += 1


def _splice_spy(wf, cls=HostSpy):
    """A spy between fwd0 and fwd1 (control only; the data links stay)."""
    spy = cls(wf, name="spy")
    spy.watched = wf.forwards[0].output
    fwd1 = wf.forwards[1]
    fwd1.unlink_from(wf.forwards[0])
    spy.link_from(wf.forwards[0])
    fwd1.link_from(spy)
    return spy


def _leaves_close(a, b, atol=ATOL):
    for fa, fb in zip(a.forwards, b.forwards):
        for attr in ("weights", "bias"):
            numpy.testing.assert_allclose(
                numpy.asarray(getattr(fa, attr).mem),
                numpy.asarray(getattr(fb, attr).mem), atol=atol, rtol=0)


def _record_epochs(wf):
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append([int(s[0]) for s in stats])
        summary(stats, epoch)

    wf.decision._epoch_summary = recorded
    return seen


def test_chain_extraction_and_partition():
    wf = _build()
    chain = segments.chain_of(wf)
    assert [type(u).__name__ for u in chain] == [
        "All2AllTanh", "All2AllSoftmax", "EvaluatorSoftmax", "DecisionGD",
        "GDSoftmax", "GDTanh"]
    kinds = [(kind, len(p) if kind == "segment" else type(p).__name__)
             for kind, p in segments.partition(chain)]
    assert kinds == [("segment", 3), ("host", "DecisionGD"),
                     ("segment", 2)]


def test_segments_match_graph_mode():
    graph = _build()
    graph.initialize()
    graph.run()
    seg = _build()
    created = segments.enable(seg)
    assert len(created) == 2
    seg.initialize()
    seg.run()
    assert seg.decision.best_n_err[VALID] == graph.decision.best_n_err[
        VALID]
    assert seg.decision._epochs_done == graph.decision._epochs_done
    # 3 epochs x 18 ticks fire the forward segment, 3 x 15 the GD one
    assert [s.calls for s in created] == [54, 45]
    _leaves_close(graph, seg)


def test_custom_host_unit_splits_segments():
    graph = _build()
    graph_spy = _splice_spy(graph)
    graph.initialize()
    graph.run()
    seg = _build()
    seg_spy = _splice_spy(seg)
    created = segments.enable(seg)
    # fwd0 alone is a run of one (stays a unit); [fwd1, evaluator] and
    # [gds] fuse
    assert len(created) == 2
    seg.initialize()
    seg.run()
    assert seg_spy.ticks == graph_spy.ticks == 3 * 18
    assert seg_spy.seen_shapes == graph_spy.seen_shapes == {(100, 32)}
    assert seg.decision.best_n_err[VALID] == graph.decision.best_n_err[
        VALID]
    _leaves_close(graph, seg)


def test_segments_learn():
    seg = _build(max_epochs=8)
    segments.enable(seg)
    seg.initialize()
    seg.run()
    best = seg.decision.best_n_err[VALID]
    assert best is not None and best < 45


def test_mid_segment_monitor_still_fires():
    """A side unit off a MID-segment member (a monitor linked from fwd0)
    keeps firing after fusion: its provider link goes to the segment."""
    graph = _build()
    gmon = HostSpy(graph, name="mon")
    gmon.watched = graph.forwards[0].output
    gmon.link_from(graph.forwards[0])
    graph.initialize()
    graph.run()
    seg = _build()
    smon = HostSpy(seg, name="mon")
    smon.watched = seg.forwards[0].output
    smon.link_from(seg.forwards[0])
    assert len(segments.enable(seg)) == 2
    seg.initialize()
    seg.run()
    assert smon.ticks == gmon.ticks > 0
    assert seg.decision.best_n_err[VALID] == graph.decision.best_n_err[
        VALID]


def test_segments_with_adam_solver():
    """The segment plan reads the GD units' extended slot tuples (the
    second moments and the step are instance INPUTS/OUTPUTS): the Adam
    state carries from tick to tick, and training learns."""
    seg = _build(max_epochs=6, learning_rate=0.01, solver="adam")
    _splice_spy(seg)
    assert segments.enable(seg)
    seg.initialize()
    seg.run()
    best = seg.decision.best_n_err[VALID]
    assert best is not None and best < 45, best
    assert float(seg.gds[0]._step.data) == 6 * 15


def test_segment_slow_path_when_a_birth_gate_is_set():
    """A member's birth gate .set() after fusion: the segment runs its
    members one by one and honours the gate, as graph mode does."""
    seg = _build(max_epochs=1)
    created = segments.enable(seg)
    seg.initialize()
    fwd_segment = created[0]
    seg.evaluator.gate_block.set()
    seg.loader.run()
    before = seg.forwards[1].output.data
    fwd_segment.run()
    assert getattr(fwd_segment, "_warned_slow_", False)
    assert fwd_segment.calls == 0
    # the forwards ran, the blocked evaluator did not
    assert seg.forwards[1].output.data is not before
    assert seg.evaluator.loss.data is None


@pytest.mark.parametrize("spliced", [False, True], ids=["plain", "spy"])
def test_segments_match_jax(spliced):
    """The port's segment tier against the JAX package's, from the JAX
    workflow's initial state: per-epoch n_err, the spy's ticks and every
    weight within 1e-5 (level 2)."""
    jprng.get("default").seed(4321)
    jprng.get("loader").seed(8765)
    jwf = JMLPWorkflow(JDummyLauncher(), **_kwargs())
    prng.get("loader").seed(8765)
    twf = MLPWorkflow(DummyLauncher(), device="cpu", **_kwargs())
    if spliced:
        jspy, tspy = _splice_spy(jwf, JHostSpy), _splice_spy(twf)
    jcreated, tcreated = jsegments.enable(jwf), segments.enable(twf)
    assert [s.name for s in tcreated] == [s.name for s in jcreated]
    jwf.initialize()
    unit_params_from_jax(twf, unit_state_of(jwf))
    twf.initialize()
    jepochs, tepochs = _record_epochs(jwf), _record_epochs(twf)
    jwf.run()
    twf.run()
    assert tepochs == jepochs
    for key in ("_epochs_done", "best_n_err", "best_epoch"):
        assert getattr(twf.decision, key) == getattr(jwf.decision, key)
    if spliced:
        assert tspy.ticks == jspy.ticks
    _leaves_close(jwf, twf)
