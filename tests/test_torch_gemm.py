"""The port's training-path ops (veles_tpu_torch/ops/gemm.py, activations,
losses, gather; loader/normalization.py; nn/gd.make_updater) against the
JAX package's counterparts on the same numpy inputs.

On the CPU the kernel wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode (as tests/test_ops.py does),
or, where the gate must be forced, with pytest's monkeypatch. The CUDA
kernels themselves (K5, K6) are held against the plain versions on the
card by chip_smoke.py and tests/test_torch_cuda.py."""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.core.config import root as jroot
from veles_tpu.loader import normalization as jnorm
from veles_tpu.nn.gd import make_updater as jmake_updater
from veles_tpu.ops import activations as jact
from veles_tpu.ops import gemm as jgemm
from veles_tpu.ops import losses as jlosses
from veles_tpu.ops.gather import gather_minibatch as jgather
from veles_tpu_torch.core.config import root
from veles_tpu_torch.loader import normalization as tnorm
from veles_tpu_torch.nn.gd import make_updater
from veles_tpu_torch.ops import activations as tact
from veles_tpu_torch.ops import gemm
from veles_tpu_torch.ops import losses as tlosses
from veles_tpu_torch.ops.gather import gather_minibatch

torch.set_num_threads(1)

ACTIVATIONS = sorted(tact.ACTIVATIONS)
#: f32 products of up to 128 terms of order 1, summed in other orders:
#: a few ulp of values of order 10
F32_TOL = 2e-5


def _rand(*shape, seed=0):
    return numpy.random.RandomState(seed).randn(*shape).astype(
        numpy.float32)


def _t(array):
    return torch.from_numpy(numpy.array(array))


# -- K5 / K6 plain versions against the Pallas kernels ------------------------

@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (130, 70, 50)])
def test_blocked_matmul_plain_matches_pallas_matmul(m, k, n):
    a, b = _rand(m, k, seed=1), _rand(k, n, seed=2)
    want = jgemm.pallas_matmul(jnp.asarray(a), jnp.asarray(b),
                               out_dtype=jnp.float32, bm=64, bn=64, bk=64,
                               interpret=True)
    got = gemm.blocked_matmul(_t(a), _t(b))
    assert got.dtype == torch.float32
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  rtol=1e-5, atol=F32_TOL)
    # a transposed view is read as it is (x.T of the weight gradient)
    got_t = gemm.blocked_matmul(_t(a.T).t(), _t(b))
    numpy.testing.assert_allclose(got_t.numpy(), numpy.asarray(want),
                                  rtol=1e-5, atol=F32_TOL)


def test_blocked_matmul_writes_bfloat16():
    """grad_x is written in x's type: the f32 sum rounded once."""
    a, b = _rand(40, 64, seed=3), _rand(64, 24, seed=4)
    got = gemm.blocked_matmul(_t(a), _t(b), out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, torch.from_numpy(a @ b).to(
        torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_dense_epilogue_plain_matches_pallas_dense(activation):
    x, w, b = _rand(96, 80, seed=5), _rand(80, 64, seed=6), _rand(64, seed=7)
    want = jgemm.pallas_dense(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), activation=activation,
                              bm=32, bn=32, bk=16, interpret=True)
    got = gemm.dense_epilogue(_t(x), _t(w), _t(b), activation)
    assert got.dtype == torch.float32
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  rtol=2e-5, atol=2e-5)


# -- the kernel route's gradients against JAX's custom VJP --------------------

@pytest.fixture
def forced_routes(monkeypatch):
    """Both packages' kernel gates forced open on the CPU with the engine
    knobs on: JAX's kernels in interpret mode (tests/test_ops.py:234-281),
    the port's wrappers on their plain versions."""
    monkeypatch.setattr(jgemm, "_pallas_eligible", lambda a, b: True)
    real_dense, real_mm = jgemm.pallas_dense, jgemm.pallas_matmul

    def interp_dense(a, b, bias, activation="linear", **kw):
        kw.update(bm=32, bn=32, bk=16, interpret=True)
        return real_dense(a, b, bias, activation=activation, **kw)

    def interp_mm(a, b, **kw):
        kw.update(bm=32, bn=32, bk=16, interpret=True)
        return real_mm(a, b, **kw)

    monkeypatch.setattr(jgemm, "pallas_dense", interp_dense)
    monkeypatch.setattr(jgemm, "pallas_matmul", interp_mm)
    monkeypatch.setattr(gemm, "_kernel_eligible", lambda a, b: True)
    for cfg in (jroot, root):
        monkeypatch.setattr(cfg.common.engine, "use_pallas", True)
        monkeypatch.setattr(cfg.common.engine, "pallas_epilogue", True)
    jgemm._dense_with_vjp.cache_clear()
    yield monkeypatch
    jgemm._dense_with_vjp.cache_clear()


def _port_grads(x, w, b, activation, level, x_grad=True):
    tx = _t(x).requires_grad_(x_grad)
    tw, tb = _t(w).requires_grad_(), _t(b).requires_grad_()
    y = gemm.dense_layer(tx, tw, tb, activation=activation,
                         precision_level=level)
    (y ** 2).sum().backward()
    return y, (tx.grad, tw.grad, tb.grad)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_dense_layer_grads_match_jax_custom_vjp(forced_routes, activation):
    """The kernel route at level 1 (f32 operands: interpret mode takes
    them) against JAX's ``_dense_with_vjp``: forward and the three
    gradients, and the launch counters untouched on the CPU."""
    forced_routes.setattr(jroot.common.engine, "precision_level", 1)
    forced_routes.setattr(root.common.engine, "precision_level", 1)
    x, w, b = _rand(64, 48, seed=8), _rand(48, 32, seed=9), _rand(32,
                                                                 seed=10)

    def loss(x, w, b):
        return jnp.sum(jgemm.dense_layer(x, w, b, activation=activation,
                                         use_pallas=True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    launches = (gemm.blocked_matmul.launches, gemm.dense_epilogue.launches)
    _, got = _port_grads(x, w, b, activation, 1)
    for g, e in zip(got, want):
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(e),
                                      rtol=2e-4, atol=2e-4)
    assert (gemm.blocked_matmul.launches,
            gemm.dense_epilogue.launches) == launches


def test_first_layer_skips_grad_x(forced_routes):
    """An input that needs no gradient (a first layer's) gets none: the
    backward runs one product, the weight gradient."""
    calls = []
    real = gemm.blocked_matmul

    def counted(a, b, **kw):
        calls.append(tuple(a.shape))
        return real(a, b, **kw)

    forced_routes.setattr(gemm, "blocked_matmul", counted)
    x, w, b = _rand(16, 12, seed=11), _rand(12, 8, seed=12), _rand(8,
                                                                 seed=13)
    _, (gx, gw, gb) = _port_grads(x, w, b, "tanh", 2, x_grad=False)
    assert gx is None and gw is not None and gb is not None
    assert calls == [(12, 16)]


@pytest.mark.parametrize("activation", ["tanh", "strict_relu"])
def test_grad_w_rounds_through_bfloat16_at_level_0(monkeypatch, activation):
    """At level 0 the kernel route's weight gradient is the f32 product
    cast to bf16 (``gemm.py:276-281``). JAX's interpret mode cannot run a
    bf16 x bf16 -> f32 dot on the CPU, so its kernels are replaced by
    their XLA formulations here: ``_dense_with_vjp``'s own casts run
    unchanged."""
    monkeypatch.setattr(jgemm, "_pallas_eligible", lambda a, b: True)

    def xla_dense(a, b, bias, activation="linear", out_dtype=jnp.float32,
                  **kw):
        out = jnp.dot(a, b, preferred_element_type=jnp.float32)
        return jact.ACTIVATIONS[activation][0](out + bias).astype(out_dtype)

    def xla_mm(a, b, out_dtype=jnp.float32, **kw):
        return jnp.dot(a, b, preferred_element_type=jnp.float32).astype(
            out_dtype)

    monkeypatch.setattr(jgemm, "pallas_dense", xla_dense)
    monkeypatch.setattr(jgemm, "pallas_matmul", xla_mm)
    monkeypatch.setattr(gemm, "_kernel_eligible", lambda a, b: True)
    for cfg in (jroot, root):
        monkeypatch.setattr(cfg.common.engine, "use_pallas", True)
        monkeypatch.setattr(cfg.common.engine, "pallas_epilogue", True)
        monkeypatch.setattr(cfg.common.engine, "precision_level", 0)
    jgemm._dense_with_vjp.cache_clear()
    try:
        x, w, b = (_rand(64, 48, seed=14), _rand(48, 32, seed=15) * 0.2,
                   _rand(32, seed=16))

        def loss(x, w, b):
            return jnp.sum(jgemm.dense_layer(
                x, w, b, activation=activation, use_pallas=True) ** 2)

        want = jax.grad(loss, argnums=(1, 2))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    finally:
        jgemm._dense_with_vjp.cache_clear()
    _, (_, gw, gb) = _port_grads(x, w, b, activation, 0, x_grad=False)
    want_w = numpy.asarray(want[0], numpy.float32)
    # both weight gradients are bf16 values widened to f32 ...
    assert torch.equal(gw, gw.to(torch.bfloat16).float())
    assert numpy.array_equal(want_w, numpy.asarray(
        jnp.asarray(want_w).astype(jnp.bfloat16).astype(jnp.float32)))
    # ... of the same f32 sum up to its order: at most one bf16 rounding
    # step apart (2^-8 relative)
    numpy.testing.assert_allclose(gw.numpy(), want_w, rtol=2 ** -8,
                                  atol=1e-6)
    numpy.testing.assert_allclose(gb.numpy(), numpy.asarray(want[1]),
                                  rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_plain_route_matches_jax(level):
    """Knobs off: ``matmul`` and ``dense_layer`` at every precision level
    against JAX's XLA route (bf16 operands at level 0, f32 products)."""
    a, b, bias = _rand(32, 64, seed=17), _rand(64, 16, seed=18), _rand(
        16, seed=19)
    want = jgemm.matmul(jnp.asarray(a), jnp.asarray(b),
                        precision_level=level, out_dtype=jnp.float32,
                        use_pallas=False)
    got = gemm.matmul(_t(a), _t(b), precision_level=level,
                      out_dtype=torch.float32, use_pallas=False)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  rtol=1e-5, atol=F32_TOL)
    want = jgemm.dense_layer(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(bias), activation="tanh",
                             precision_level=level, use_pallas=False)
    got = gemm.dense_layer(_t(a), _t(b), _t(bias), activation="tanh",
                           precision_level=level, use_pallas=False)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  rtol=1e-5, atol=F32_TOL)


def test_cpu_operands_never_reach_the_kernel_route():
    """The gate wants CUDA operands: with the knobs on, CPU tensors take
    the plain route and no counter moves."""
    launches = (gemm.blocked_matmul.launches, gemm.dense_epilogue.launches)
    a = torch.ones((600, 600))
    assert not gemm._kernel_eligible(a, a)
    gemm.matmul(a, a, use_pallas=True)
    gemm.dense_layer(a, a, torch.zeros(600), use_pallas=True)
    assert (gemm.blocked_matmul.launches,
            gemm.dense_epilogue.launches) == launches


@pytest.mark.parametrize("case,copied", [
    ("row_major", False), ("transposed", False), ("k100", True),
    ("offset_view", True), ("strided", True)])
def test_tma_layout_copies_only_what_tma_refuses(case, copied):
    """K5's bf16 route reads an operand in place when its base is 16-byte
    aligned and its leading stride a multiple of 8 elements (x.T of a
    784-wide x included); otherwise it reads an aligned row-major copy
    with the same values."""
    base = torch.randn(64, 800).to(torch.bfloat16)
    t = {"row_major": base[:, :784], "transposed": base[:, :784].t(),
         "k100": base[:, :100].contiguous(), "offset_view": base[:, 1:101],
         "strided": base[::2, ::2]}[case]
    got, ld, c_contig = gemm._tma_layout(t)
    assert (got.data_ptr() != t.data_ptr()) == copied
    assert torch.equal(got, t)
    assert ld % 8 == 0 and got.data_ptr() % 16 == 0
    assert c_contig == (case != "transposed")


@pytest.mark.parametrize("call", [
    lambda: gemm.blocked_matmul(torch.ones(3, 4), torch.ones(5, 2)),
    lambda: gemm.blocked_matmul(torch.ones(3, 4),
                                torch.ones(4, 2, dtype=torch.bfloat16)),
    lambda: gemm.blocked_matmul(torch.ones(0, 4), torch.ones(4, 2)),
    lambda: gemm.blocked_matmul(torch.ones(3, 4), torch.ones(4, 2),
                                out_dtype=torch.float16),
    lambda: gemm.dense_epilogue(torch.ones(3, 4), torch.ones(4, 2),
                                torch.ones(2), "softmax"),
    lambda: gemm.dense_epilogue(torch.ones(3, 4), torch.ones(4, 2),
                                torch.ones(3), "tanh"),
    lambda: gemm.dense_epilogue(torch.ones(3, 4, dtype=torch.int32),
                                torch.ones(4, 2, dtype=torch.int32),
                                torch.ones(2), "tanh"),
], ids=["shapes", "dtypes", "empty", "out-dtype", "activation", "bias",
        "int"])
def test_kernel_wrappers_refuse(call):
    with pytest.raises((ValueError, TypeError)):
        call()


# -- activations, losses, gather ----------------------------------------------

@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activations_match_jax(name):
    x = numpy.concatenate([_rand(200, seed=20) * 4,
                           [-60.0, -20.0, 0.0, 20.0, 60.0]]).astype(
                               numpy.float32)
    jfn, jderiv = jact.ACTIVATIONS[name]
    tfn, tderiv = tact.ACTIVATIONS[name]
    y = numpy.asarray(jfn(jnp.asarray(x)))
    numpy.testing.assert_allclose(tfn(_t(x)).numpy(), y, rtol=1e-6,
                                  atol=1e-6)
    numpy.testing.assert_allclose(tderiv(_t(y)).numpy(),
                                  numpy.asarray(jderiv(jnp.asarray(y))),
                                  rtol=1e-6, atol=1e-6)


def test_masked_softmax_xent_and_confusion_match_jax():
    logits = _rand(50, 10, seed=21) * 3
    labels = numpy.random.RandomState(22).randint(0, 10, 50).astype(
        numpy.int32)
    mask = (numpy.arange(50) < 37).astype(numpy.float32)
    want = jlosses.masked_softmax_xent(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       jnp.asarray(mask), 37.0)
    got = tlosses.masked_softmax_xent(_t(logits), _t(labels), _t(mask),
                                      37.0)
    for g, w in zip(got[:2], want[:2]):
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(w),
                                      rtol=1e-6, atol=1e-6)
    assert int(got[2]) == int(want[2])
    numpy.testing.assert_array_equal(got[3].numpy(), numpy.asarray(want[3]))
    numpy.testing.assert_array_equal(
        tlosses.confusion_matrix(_t(logits), _t(labels), 10,
                                 _t(mask)).numpy(),
        numpy.asarray(jlosses.confusion_matrix(
            jnp.asarray(logits), jnp.asarray(labels), 10,
            jnp.asarray(mask))))


def test_gather_matches_jax():
    data = _rand(30, 7, seed=23)
    labels = numpy.arange(30, dtype=numpy.int32)
    idx = numpy.array([5, 0, 29, 5, 0, 0], numpy.int64)
    jb, jl = jgather(jnp.asarray(data), jnp.asarray(idx), jnp.asarray(labels))
    tb, tl = gather_minibatch(_t(data), _t(idx), _t(labels))
    numpy.testing.assert_array_equal(tb.numpy(), numpy.asarray(jb))
    numpy.testing.assert_array_equal(tl.numpy(), numpy.asarray(jl))


# -- normalizers, updaters ----------------------------------------------------

@pytest.mark.parametrize("name,kwargs", [
    ("none", {}), ("linear", {}), ("linear", {"interval": (0, 1)}),
    ("mean_disp", {})], ids=["none", "linear", "linear-0-1", "mean_disp"])
def test_normalizers_match_jax(name, kwargs):
    train = numpy.random.RandomState(24).rand(40, 12).astype(numpy.float32)
    batch = numpy.random.RandomState(25).rand(9, 12).astype(numpy.float32)
    batch[3] = 0.5   # a uniform sample lands on the interval midpoint
    j, t = (jnorm.make_normalizer(name, **kwargs),
            tnorm.make_normalizer(name, **kwargs))
    if not t.STATELESS:
        j.analyze(train)
        t.analyze(train)
    state = j.jit_state()
    for key, value in t.jit_state().items():
        numpy.testing.assert_array_equal(value, state[key])
    want = numpy.asarray(j.apply_state(jnp, jnp.asarray(batch), {
        k: jnp.asarray(v) for k, v in state.items()}))
    numpy.testing.assert_allclose(t.normalize(batch), want, rtol=1e-6,
                                  atol=1e-6)


@pytest.mark.parametrize("solver", ["momentum", "adagrad", "adam"])
def test_make_updater_matches_jax(solver):
    hyper = numpy.array([0.05, 0.02, 0.0, 0.0, 0.9, 0.8, 0.95, 1e-6],
                        numpy.float32)
    w, g, v, s = (_rand(6, 5, seed=26 + i) for i in range(4))
    s = numpy.abs(s)
    step = numpy.float32(3.0) if solver != "momentum" else None
    want = jmake_updater(solver, jnp.asarray(hyper), step)(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(v), jnp.asarray(s),
        jnp.float32(0.05))
    got = make_updater(solver, _t(hyper),
                       None if step is None else torch.tensor(step))(
        _t(w), _t(g), _t(v), _t(s), _t(hyper)[0])
    for gt, wt in zip(got, want):
        numpy.testing.assert_allclose(numpy.asarray(gt), numpy.asarray(wt),
                                      rtol=1e-6, atol=1e-6)
