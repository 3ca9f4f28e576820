"""The port's normalizers (veles_tpu_torch/loader/normalization.py) against
the JAX package's (veles_tpu/loader/normalization.py) on the CPU: all eight
types, the interval variants, and external_mean from an ndarray, a .npy
file and a pickle. The same numpy inputs, made from a seed, go through
both; the accumulated state, ``jit_state()``, ``normalize`` and
``denormalize`` must agree to 1e-6 relative. ``convert`` carries a JAX
normalizer's state into the port's."""

import pickle

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.loader import normalization as jnorm
from veles_tpu.loader.fullbatch import (FullBatchLoader as JFullBatchLoader,
                                        FullBatchLoaderMSE as JLoaderMSE)
from veles_tpu_torch import convert
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.loader import normalization as tnorm
from veles_tpu_torch.loader.fullbatch import FullBatchLoader, \
    FullBatchLoaderMSE

torch.set_num_threads(1)

RTOL = 1e-6

CASES = [
    ("none", {}), ("mean_disp", {}), ("linear", {}),
    ("linear", {"interval": (0, 1)}), ("range_linear", {}),
    ("range_linear", {"interval": (0, 2)}), ("exp", {}), ("pointwise", {}),
    ("internal_mean", {}), ("internal_mean", {"scale": 0.5}),
    ("external_mean", "ndarray"), ("external_mean", "npy"),
    ("external_mean", "pickle")]
IDS = ["none", "mean_disp", "linear", "linear-0-1", "range_linear",
       "range_linear-0-2", "exp", "pointwise", "internal_mean",
       "internal_mean-scale", "external_mean-ndarray", "external_mean-npy",
       "external_mean-pickle"]


def _data(seed, n=40, dim=6):
    data = numpy.random.RandomState(seed).uniform(-3, 5, (n, dim)).astype(
        numpy.float32)
    data[:, 2] = 4.0   # a constant feature (pointwise maps it to 0)
    return data


def _kwargs(spec, tmp_path):
    """The constructor kwargs of a case; external_mean's mean sample comes
    from an ndarray, a .npy file or a pickle."""
    if not isinstance(spec, str):
        return dict(spec)
    mean = numpy.random.RandomState(3).rand(6).astype(numpy.float32)
    if spec == "ndarray":
        return {"mean_source": mean, "scale": 2.0}
    path = str(tmp_path / ("mean." + spec))
    if spec == "npy":
        numpy.save(path, mean)
    else:
        with open(path, "wb") as fout:
            pickle.dump(mean, fout)
    return {"mean_source": path}


def _np(value):
    return value.numpy() if isinstance(value, torch.Tensor) \
        else numpy.asarray(value)


def _close(got, want):
    numpy.testing.assert_allclose(_np(got), _np(want), rtol=RTOL,
                                  atol=RTOL * max(1.0, float(numpy.abs(
                                      _np(want)).max(initial=0))))


def _pair(name, spec, tmp_path):
    kwargs = _kwargs(spec, tmp_path)
    j, t = (jnorm.make_normalizer(name, **kwargs),
            tnorm.make_normalizer(name, **kwargs))
    if not t.STATELESS:
        # two passes: the statistics accumulate across analyze() calls
        # (range_linear's must see the same range twice)
        train = _data(1)
        parts = ((train, train) if name == "range_linear"
                 else (train[:13], train[13:]))
        for part in parts:
            j.analyze(part)
            t.analyze(part)
    return j, t


def test_registry_has_all_eight():
    assert set(tnorm.normalizer_registry) == set(jnorm.normalizer_registry)
    assert len(tnorm.normalizer_registry) == 8
    with pytest.raises(ValueError, match="unknown normalization"):
        tnorm.make_normalizer("bogus")


@pytest.mark.parametrize("name,spec", CASES, ids=IDS)
def test_state_and_normalize_match_jax(name, spec, tmp_path):
    j, t = _pair(name, spec, tmp_path)
    assert (t.STATELESS, t.INVERTIBLE_FROM_STATE) \
        == (j.STATELESS, j.INVERTIBLE_FROM_STATE)
    jstate, tstate = j.jit_state(), t.jit_state()
    assert sorted(tstate) == sorted(jstate)
    for key in jstate:
        _close(tstate[key], jstate[key])
    state = convert.normalizer_state(t)
    for key, value in convert.normalizer_state(j).items():
        if isinstance(value, numpy.ndarray):
            _close(state[key], value)
        else:
            assert state[key] == value
    batch = _data(2, n=9)
    batch[4] = 0.5   # a uniform sample (the linear types' midpoint)
    want = numpy.asarray(j.apply_state(jnp, jnp.asarray(batch), {
        k: jnp.asarray(v) for k, v in jstate.items()}))
    _close(t.normalize(batch), want)
    # apply_state on a tensor batch from the dict alone, as the tick does
    _close(t.apply_state(torch.from_numpy(batch),
                         tnorm.state_tensors(tstate, "cpu")), want)


@pytest.mark.parametrize("name,spec", CASES, ids=IDS)
def test_denormalize_matches_jax(name, spec, tmp_path):
    j, t = _pair(name, spec, tmp_path)
    batch = _data(4, n=9)
    if hasattr(j, "normalize_with_stats"):
        jout, jstats = j.normalize_with_stats(batch)
        tout, tstats = t.normalize_with_stats(batch)
        for key in jstats:
            _close(tstats[key], jstats[key])
        want = j.denormalize(jout, **jstats)
        got = t.denormalize(tout, **tstats)
    else:
        jout = j.normalize(batch)
        _close(t.normalize(batch), jout)
        want, got = j.denormalize(jout), t.denormalize(jout)
    _close(got, want)
    # a tensor in gives a tensor out
    if not hasattr(j, "normalize_with_stats"):
        assert isinstance(t.denormalize(torch.from_numpy(jout)),
                          torch.Tensor)


@pytest.mark.parametrize("name,spec", CASES, ids=IDS)
def test_state_carried_from_jax(name, spec, tmp_path):
    """``make_normalizer(name, state=convert.normalizer_state(jax))``
    reproduces the JAX normalizer without analysing."""
    j, _ = _pair(name, spec, tmp_path)
    t = tnorm.make_normalizer(name, state=convert.normalizer_state(j))
    assert t.is_initialized
    batch = _data(5, n=7)
    _close(t.normalize(batch), j.normalize(batch))
    if j.INVERTIBLE_FROM_STATE:
        _close(t.denormalize(batch), j.denormalize(batch))


def test_range_linear_rejects_a_drifting_range():
    t = tnorm.make_normalizer("range_linear")
    t.analyze(_data(1))
    with pytest.raises(ValueError, match="stable global"):
        t.analyze(_data(1) * 100)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="two values"):
        tnorm.make_normalizer("linear", interval=(1,))
    with pytest.raises(TypeError, match="scalar"):
        tnorm.make_normalizer("internal_mean", scale="x")
    with pytest.raises(ValueError, match="mean_source"):
        tnorm.make_normalizer("external_mean")
    with pytest.raises(ValueError, match="unable to load"):
        tnorm.make_normalizer("external_mean",
                              mean_source="/nonexistent/mean.npy")
    with pytest.raises(RuntimeError, match="before analyze"):
        tnorm.make_normalizer("mean_disp").normalize(_data(1))


def _cpu_workflow():
    wf = DummyWorkflow()
    wf.device = torch.device("cpu")
    return wf


@pytest.mark.parametrize("name", ["mean_disp", "pointwise", "range_linear",
                                  "internal_mean", "exp"])
def test_loader_normalizes_like_jax(name):
    """A FullBatchLoader analyses its train split (after the validation
    resplit) and serves the normalized minibatch as the JAX loader does;
    the analysis runs on the device of the originals."""
    data = _data(6, n=60)
    labels = numpy.arange(60) % 3
    kwargs = dict(data=data, labels=labels, class_lengths=[0, 0, 60],
                  validation_ratio=0.25, minibatch_size=60,
                  normalization_type=name, shuffle_limit=0)
    jl = JFullBatchLoader(JDummyWorkflow(), **kwargs)
    tl = FullBatchLoader(_cpu_workflow(), **kwargs)
    jl.initialize()
    tl.initialize()
    assert tl.class_lengths == jl.class_lengths == [0, 15, 45]
    for key, value in jl.normalizer.jit_state().items():
        _close(tl.normalizer.jit_state()[key], value)
    jl.run()
    tl.run()
    _close(tl.minibatch_data.data, numpy.asarray(jl.minibatch_data.data))


def test_loader_starts_from_a_carried_state():
    """``convert.normalizers_from_jax`` makes the port loader build its
    normalizer and target normalizer from the JAX loader's state."""
    data, targets = _data(7, n=50), _data(8, n=50)[:, :3]
    kwargs = dict(data=data, targets=targets, class_lengths=[0, 10, 40],
                  minibatch_size=50, normalization_type="mean_disp",
                  target_normalization_type="pointwise")
    jl = JLoaderMSE(JDummyWorkflow(), **kwargs)
    jl.initialize()
    # the port loader analyses other rows: only the carried state can
    # make its output equal
    tl = FullBatchLoaderMSE(_cpu_workflow(), **dict(
        kwargs, data=data * 3, targets=targets))
    convert.normalizers_from_jax(tl, jl.normalizer, jl.target_normalizer)
    tl.initialize()
    for key, value in jl.normalizer.jit_state().items():
        _close(tl.normalizer.jit_state()[key], value)
    for key, value in jl.target_normalizer.jit_state().items():
        _close(tl.target_normalizer.jit_state()[key], value)
    _close(tl.original_targets.data, numpy.asarray(jl.original_targets.data))
    with pytest.raises(ValueError, match="no target_normalizer_state"):
        convert.normalizers_from_jax(
            FullBatchLoader(_cpu_workflow(), data=data), jl.normalizer,
            jl.target_normalizer)
