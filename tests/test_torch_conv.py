"""The port's conv slice against the JAX package on the CPU: ``conv2d``
(ops/gemm.py), the three pools and their gradients (nn/pooling.py), a
fused convnet, and AlexNet (models/alexnet.py).

Inputs come from numpy seeds; JAX weights are carried across by
``convert.unit_params_from_jax``. Tolerances:

- ``conv2d`` at levels 1 and 2 is f32 on both sides (XLA's CPU conv
  ignores the HIGH/HIGHEST hints): the sums of up to 11 x 11 x 3 terms
  differ in order only, within 1e-5 of each element (and 1e-6 of the
  largest, where an element cancels towards 0);
- at level 0 both sides convolve bf16 operands and round the output to
  bf16: an output may land one bf16 step apart, so each is held to one
  bf16 ulp of the largest output;
- pools select or add the same f32 values in the same order: exact,
  values and gradients, ties included;
- the workflows at level 2: the two packages' f32 sums differ in order,
  so a near-tied argmax could flip; per-epoch n_err must still be equal
  and every weight within 2e-3 (the JAX package's own fused-vs-graph
  convnet bound, ``tests/test_fused.py:160``).
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.models.alexnet import AlexNetWorkflow as JAlexNetWorkflow
from veles_tpu.models.standard import StandardWorkflow as JStandardWorkflow
from veles_tpu.nn import pooling as jpooling
from veles_tpu.ops import gemm as jgemm
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models.alexnet import AlexNetWorkflow, alexnet_layers
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.nn import pooling
from veles_tpu_torch.ops.gemm import conv2d, conv_output_hw, same_padding

torch.set_num_threads(1)

#: (input H and W, kernel, stride, padding): strides 1, 2 and 4, XLA's
#: SAME with symmetric and asymmetric totals (k = 4, s = 2, in = 9 pads
#: 1 / 2; AlexNet's first layer, k = 11, s = 4, in = 67, pads 4 / 4, at
#: in = 66 4 / 5; k = 2 pads 0 / 1), and VALID with a ragged edge
CONV_CASES = [((8, 8), 3, 1, "SAME"), ((9, 9), 4, 2, "SAME"),
              ((67, 66), 11, 4, "SAME"), ((7, 10), 2, 1, "SAME"),
              ((10, 10), 3, 1, "VALID"), ((13, 11), 5, 2, "VALID"),
              ((17, 17), 4, 4, "VALID")]
CONV_IDS = ["k3s1-same", "k4s2-same-asym", "alexnet-conv1", "k2-same-even",
            "k3-valid", "k5s2-valid-ragged", "k4s4-valid"]


def _conv_inputs(hw, k, seed=0, channels=3, kernels=5):
    rng = numpy.random.RandomState(seed)
    x = rng.randn(2, hw[0], hw[1], channels).astype(numpy.float32)
    w = (rng.randn(k, k, channels, kernels)
         / numpy.sqrt(k * k * channels)).astype(numpy.float32)
    return x, w


def test_same_padding_is_xla_rule():
    assert same_padding(9, 4, 2) == (1, 2)
    assert same_padding(67, 11, 4) == (4, 4)
    assert same_padding(66, 11, 4) == (4, 5)
    assert same_padding(7, 2, 1) == (0, 1)
    assert same_padding(8, 3, 1) == (1, 1)
    assert same_padding(8, 1, 4) == (0, 0)
    assert conv_output_hw((67, 67), (11, 11), (4, 4), "SAME") == (17, 17)
    assert conv_output_hw((13, 11), (5, 5), (2, 2), "VALID") == (5, 4)


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("hw,k,stride,padding", CONV_CASES, ids=CONV_IDS)
def test_conv2d_matches_jax(hw, k, stride, padding, level):
    x, w = _conv_inputs(hw, k)
    want = numpy.asarray(jgemm.conv2d(jnp.asarray(x), jnp.asarray(w),
                                      (stride, stride), padding,
                                      precision_level=level))
    got = conv2d(torch.from_numpy(x), torch.from_numpy(w), (stride, stride),
                 padding, precision_level=level)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    largest = numpy.abs(want).max()
    if level == 0:
        ulp = 2.0 ** (numpy.floor(numpy.log2(largest)) - 7)
        assert numpy.abs(got - want).max() <= ulp
    else:
        numpy.testing.assert_allclose(got, want, rtol=1e-5,
                                      atol=1e-6 * largest)


@pytest.mark.parametrize("hw,k,stride,padding",
                         [CONV_CASES[1], CONV_CASES[2], CONV_CASES[5]],
                         ids=[CONV_IDS[1], CONV_IDS[2], CONV_IDS[5]])
def test_conv2d_gradients_match_jax(hw, k, stride, padding):
    """Level 2: autograd's dX and dW against ``jax.vjp`` for the same
    cotangent."""
    x, w = _conv_inputs(hw, k, seed=1)
    out, vjp = jax.vjp(lambda a, b: jgemm.conv2d(
        a, b, (stride, stride), padding, precision_level=2),
        jnp.asarray(x), jnp.asarray(w))
    g = numpy.random.RandomState(2).randn(*out.shape).astype(numpy.float32)
    want_x, want_w = (numpy.asarray(t) for t in vjp(jnp.asarray(g)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    conv2d(tx, tw, (stride, stride), padding, precision_level=2).backward(
        torch.from_numpy(g))
    for got, want in ((tx.grad, want_x), (tw.grad, want_w)):
        numpy.testing.assert_allclose(
            got.numpy(), want, rtol=1e-5, atol=1e-6 * numpy.abs(want).max())


def _tied_input(seed, shape=(2, 9, 9, 3)):
    """Small integers (many ties inside every window) with one +x / -x
    pair planted in a window, plus an all-equal window."""
    rng = numpy.random.RandomState(seed)
    x = rng.randint(-3, 4, shape).astype(numpy.float32)
    x[0, :3, :3, 0] = 0.0                       # the first window of each
    x[0, 0, 0, 0], x[0, 1, 1, 0] = 2.5, -2.5    # case: a maxabs tie, +x wins
    x[1, 2:4, 2:4, 1] = 1.0                     # a window of equal values
    return x


POOL_CASES = [((2, 2), (2, 2)), ((3, 3), (2, 2)), ((3, 2), (1, 2))]


@pytest.mark.parametrize("kind,jcls", [("max", jpooling.MaxPooling),
                                       ("avg", jpooling.AvgPooling),
                                       ("maxabs", jpooling.MaxAbsPooling)])
@pytest.mark.parametrize("window,sliding", POOL_CASES,
                         ids=["2x2", "3x3s2-overlap", "3x2s12"])
def test_pools_and_gradients_match_jax_exactly(kind, jcls, window,
                                               sliding):
    """Forward and VJP against ``jax.vjp`` of the JAX unit's pool: equal
    bit for bit, ties (and a +x / -x maxabs tie) included; for avg also
    on random floats, whose sums must add in the same order."""
    unit = jcls.__new__(jcls)
    unit.ky, unit.kx = window
    unit.sliding = sliding
    for x in (_tied_input(3),
              numpy.random.RandomState(4).randn(2, 9, 9, 3).astype(
                  numpy.float32)):
        out, vjp = jax.vjp(unit._pool, jnp.asarray(x))
        g = numpy.random.RandomState(5).randn(*out.shape).astype(
            numpy.float32)
        want_grad = numpy.asarray(vjp(jnp.asarray(g))[0])
        tx = torch.from_numpy(x).requires_grad_(True)
        got = pooling.POOLS[kind](tx, window, sliding)
        got.backward(torch.from_numpy(g))
        numpy.testing.assert_array_equal(got.detach().numpy(),
                                         numpy.asarray(out))
        numpy.testing.assert_array_equal(tx.grad.numpy(), want_grad)


def test_max_pool_gradient_goes_to_the_first_of_a_tie():
    """JAX's select-and-scatter rule: the first element of the window in
    row-major order takes a tied maximum's gradient."""
    x = torch.ones((1, 2, 2, 1), requires_grad=True)
    pooling.max_pool(x, (2, 2), (2, 2)).sum().backward()
    assert x.grad[0, :, :, 0].tolist() == [[1.0, 0.0], [0.0, 0.0]]


@pytest.fixture
def level2(monkeypatch):
    for cfg in (jroot, root):
        monkeypatch.setattr(cfg.common.engine, "precision_level", 2,
                            raising=False)


def _digit_images():
    from sklearn.datasets import load_digits
    d = load_digits()
    x = d.images.astype(numpy.float32)[..., None]    # (N, 8, 8, 1) NHWC
    y = d.target.astype(numpy.int32)
    perm = numpy.random.RandomState(0).permutation(len(x))
    return x[perm], y[perm]


def _record_epochs(wf):
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append([int(s[0]) for s in stats])
        summary(stats, epoch)

    wf.decision._epoch_summary = recorded
    return seen


def carry_weights(jwf):
    """The JAX workflow's unit parameters, one dict per forward ({} for
    a pooling layer), as numpy."""
    return [{"weights": numpy.asarray(f.weights.data),
             "bias": numpy.asarray(f.bias.data)}
            if getattr(f, "weights", None) is not None else {}
            for f in jwf.forwards]


def run_pair(build_jax, build_port, atol=2e-3):
    """Initialize the JAX workflow, carry its weights into the port's,
    run both; per-epoch n_err equal, every weight and bias within
    ``atol``. Returns the port's workflow."""
    jwf = build_jax()
    jwf.initialize()
    twf = build_port()
    unit_params_from_jax(twf, carry_weights(jwf))
    twf.initialize()
    assert twf.fused_tick is not None and jwf.fused_tick is not None
    jepochs, tepochs = _record_epochs(jwf), _record_epochs(twf)
    jwf.run()
    twf.run()
    assert tepochs == jepochs and len(tepochs) > 0
    for jf, tf in zip(jwf.forwards, twf.forwards):
        if getattr(jf, "weights", None) is None:
            continue
        for name in ("weights", "bias"):
            numpy.testing.assert_allclose(
                getattr(tf, name).data.numpy(),
                numpy.asarray(getattr(jf, name).data), atol=atol, rtol=0)
    return twf


def test_fused_convnet_matches_jax(level2):
    """tests/test_fused.py's convnet (conv_tanh 8 x 3x3, max pool 2x2,
    softmax) on 600 digit images, 2 epochs, the fused tick of both
    packages from the same weights and loader seed."""
    x, y = _digit_images()
    x, y = x[:600], y[:600]
    layers = [{"type": "conv_tanh", "n_kernels": 8, "kx": 3, "ky": 3},
              {"type": "max_pooling", "kx": 2, "ky": 2},
              {"type": "softmax", "output_sample_shape": (10,)}]
    kwargs = dict(layers=layers,
                  loader_kwargs=dict(data=x, labels=y,
                                     class_lengths=[0, 100, 500],
                                     minibatch_size=100,
                                     normalization_type="linear"),
                  learning_rate=0.05, decision_kwargs=dict(max_epochs=2),
                  name="fused-conv")

    def build_jax():
        jprng.get("default").seed(99)
        jprng.get("loader").seed(77)
        return JStandardWorkflow(JDummyLauncher(), fused=True, **kwargs)

    def build_port():
        prng.get("loader").seed(77)
        return StandardWorkflow(DummyLauncher(), device="cpu", **kwargs)

    twf = run_pair(build_jax, build_port)
    assert twf.fused_tick.minibatch_counts[1:] == [2, 10]
    assert [s.get("kind") for s in twf.fused_tick._specs_] == [
        "conv", "max", "dense"]
    assert twf.fused_tick._params_[1] == {}


def test_alexnet_matches_jax(level2):
    """AlexNet at scale 1/32 (4 to 12 channels, 128-unit dense layers) on
    67 x 67 x 3 pixels, 4 classes, one epoch (mean_disp normalization,
    the JAX package's lr, moment and decay)."""
    rng = numpy.random.RandomState(6)
    x = (rng.rand(48, 67, 67, 3) * 255).astype(numpy.float32)
    y = numpy.tile(numpy.arange(4, dtype=numpy.int32), 12)
    kwargs = dict(n_classes=4, scale=1 / 32,
                  loader_kwargs=dict(data=x, labels=y,
                                     class_lengths=[0, 16, 32],
                                     minibatch_size=16,
                                     normalization_type="mean_disp"),
                  decision_kwargs=dict(max_epochs=1), name="alexnet")

    def build_jax():
        jprng.get("default").seed(5)
        jprng.get("loader").seed(6)
        return JAlexNetWorkflow(JDummyLauncher(), **kwargs)

    def build_port():
        prng.get("loader").seed(6)
        return AlexNetWorkflow(DummyLauncher(), device="cpu", **kwargs)

    twf = run_pair(build_jax, build_port)
    assert [tuple(f.weights.data.shape) for f in twf.forwards
            if getattr(f, "weights", None) is not None][:2] == [
        (11, 11, 3, 4), (5, 5, 4, 8)]
    assert twf.forwards[-4].output.data.shape[1:] == (1, 1, 8)


def test_alexnet_layers_match_jax():
    from veles_tpu.models.alexnet import alexnet_layers as jlayers
    for scale in (1.0, 1 / 8, 1 / 32):
        assert alexnet_layers(1000, scale) == jlayers(1000, scale)
