"""The port's flash attention (veles_tpu_torch/ops/attention.py: K7, K8
and K9's plain versions, the custom VJP, the routing) and the sequence
blocks (attention_block, ffn_block) against the JAX package and the
installed JAX's flash reference on the CPU.

Inputs are numpy draws from fixed seeds, handed to both sides. The
reference for the flash kernels is
``jax.experimental.pallas.ops.tpu.flash_attention.
mha_reference_no_custom_vjp`` (its ``mha_reference`` has a custom
backward that raises for ``causal=True``), in the (B, H, T, D) layout;
the port keeps the JAX package's (B, T, H, D). Tolerances:

- f32 forward within 1e-5: the same f32 math in another summation order
  over at most 256 keys (~1e-7 measured);
- f32 gradients within 1e-4: four products and an exp in f32 (~3e-6
  measured);
- bf16 inputs within 1e-2 of the largest output: one bf16 rounding of the
  output (2^-8 relative) and of P where one side rounds it and the other
  does not.
"""

import math

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    mha_reference_no_custom_vjp)

from veles_tpu.ops import attention as jattention
from veles_tpu_torch.ops import attention as attn
from veles_tpu_torch.ops.attention import (
    _flash_attention_dkv_plain, _flash_attention_dq_plain,
    _flash_attention_fwd_plain, attention, attention_block, ffn_block,
    flash_attention, flash_attention_dkv, flash_attention_dq,
    flash_attention_fwd, plain_attention, plain_flash_backward)

torch.set_num_threads(1)

F32_FWD_ATOL = 1e-5
F32_GRAD_ATOL = 1e-4
BF16_RTOL = 1e-2


def _draw(seed, *shapes):
    rng = numpy.random.RandomState(seed)
    return [rng.randn(*shape).astype(numpy.float32) for shape in shapes]


def _bhtd(x):
    """(B, T, H, D) numpy -> the reference's (B, H, T, D) jax array."""
    return jnp.asarray(x).transpose(0, 2, 1, 3)


def _btd(x):
    return numpy.asarray(x).transpose(0, 2, 1, 3)


def _reference(q, k, v, causal):
    d = q.shape[-1]
    return mha_reference_no_custom_vjp(
        _bhtd(q), _bhtd(k), _bhtd(v), causal=causal,
        sm_scale=1.0 / math.sqrt(d), save_residuals=True)


def _relative(got, want):
    got = numpy.asarray(torch.as_tensor(got).float())
    want = numpy.asarray(want, numpy.float32)
    return numpy.abs(got - want).max() / numpy.abs(want).max()


#: small widths, the kernels' 128 and the wider multiples of 128 the
#: flash rule admits (256: K7's second wgmma width; 384: the chunked
#: kernels)
SHAPES = [(2, 200, 3, 32), (1, 256, 2, 128), (2, 77, 1, 64),
          (1, 160, 1, 256), (1, 96, 1, 384)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_forward_matches_the_flash_reference(shape, causal):
    """K7's plain version: O and the logsumexp against the reference's
    output and m + log(l), f32."""
    q, k, v = _draw(0, shape, shape, shape)
    out, lse = _flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)),
                                          causal)
    ref, l, m = _reference(q, k, v, causal)
    numpy.testing.assert_allclose(out.numpy(), _btd(ref), rtol=0,
                                  atol=F32_FWD_ATOL)
    numpy.testing.assert_allclose(lse.numpy(), numpy.asarray(m + jnp.log(l)),
                                  rtol=0, atol=F32_FWD_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_the_jax_package(shape, causal, dtype):
    """``attention`` (the plain route on the CPU) and K7's plain version
    against the JAX package's ``attention`` (XLA on the CPU), f32 and
    bf16 inputs."""
    q, k, v = _draw(1, shape, shape, shape)
    want = numpy.asarray(jattention.attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal),
        numpy.float32)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    for got in (attention(tq, tk, tv, causal),
                _flash_attention_fwd_plain(tq, tk, tv, causal)[0]):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        if dtype == "float32":
            numpy.testing.assert_allclose(got.numpy(), want, rtol=0,
                                          atol=F32_FWD_ATOL)
        else:
            assert _relative(got, want) <= BF16_RTOL


def _jax_grads(q, k, v, do, causal):
    d = q.shape[-1]

    def f(q, k, v):
        return mha_reference_no_custom_vjp(q, k, v, causal=causal,
                                           sm_scale=1.0 / math.sqrt(d))

    _, vjp = jax.vjp(f, _bhtd(q), _bhtd(k), _bhtd(v))
    return [_btd(g) for g in vjp(_bhtd(do))]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_jax_grad(shape, causal):
    """plain_flash_backward (K8's and K9's plain versions after di) and
    the custom VJP's CPU backward against jax.vjp of the reference, f32."""
    q, k, v, do = _draw(2, shape, shape, shape, shape)
    want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = _flash_attention_fwd_plain(tq, tk, tv, causal)
    for got, ref in zip(plain_flash_backward(tq, tk, tv, out, lse, tdo,
                                             causal), want):
        numpy.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                      atol=F32_GRAD_ATOL)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    flash_attention(*leaves, causal).backward(tdo)
    for leaf, ref in zip(leaves, want):
        numpy.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=0,
                                      atol=F32_GRAD_ATOL)


def test_plain_backward_agrees_with_the_jax_packages_grad():
    """jax.grad of the JAX package's own ``attention`` (XLA on the CPU)
    against the custom VJP's CPU backward: the port's flash backward
    computes the gradient the reference trains with."""
    shape = (1, 128, 2, 128)
    q, k, v, do = _draw(3, shape, shape, shape, shape)
    _, vjp = jax.vjp(lambda q, k, v: jattention.attention(q, k, v,
                                                          causal=True),
                     *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    flash_attention(*leaves, True).backward(torch.from_numpy(do))
    for leaf, ref in zip(leaves, vjp(jnp.asarray(do))):
        numpy.testing.assert_allclose(leaf.grad.numpy(), numpy.asarray(ref),
                                      rtol=0, atol=F32_GRAD_ATOL)


def test_bf16_backward_rounds_p_and_ds():
    """With bf16 operands the plain backward rounds P and dS to bf16
    before their products (``flash_attention.py:900, :918, :1258``): it
    stays within one rounding of the f32 gradient, returns bf16, and the
    custom VJP's bf16 backward returns the same tensors."""
    shape = (1, 96, 2, 64)
    q, k, v, do = (torch.from_numpy(x) for x in _draw(4, shape, shape,
                                                        shape, shape))
    out, lse = _flash_attention_fwd_plain(q, k, v, True)
    exact = plain_flash_backward(q, k, v, out, lse, do, True)
    b16 = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    out16, lse16 = _flash_attention_fwd_plain(*b16[:3], True)
    grads = plain_flash_backward(*b16[:3], out16, lse16, b16[3], True)
    for got, ref in zip(grads, exact):
        assert got.dtype == torch.bfloat16
        assert _relative(got, ref.numpy()) <= 4 * BF16_RTOL
    leaves = [t.clone().requires_grad_(True) for t in b16[:3]]
    flash_attention(*leaves, True).backward(b16[3])
    for leaf, ref in zip(leaves, grads):
        assert torch.equal(leaf.grad, ref)


def test_kernel_wrappers_run_the_plain_versions_on_cpu():
    """On CPU tensors K7, K8 and K9's wrappers return their plain
    versions' results and never count a launch."""
    shape = (1, 130, 2, 128)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _draw(5, shape, shape, shape, shape))
    counts = (flash_attention_fwd.launches, flash_attention_dkv.launches,
              flash_attention_dq.launches)
    out, lse = flash_attention_fwd(q, k, v, True)
    ref_out, ref_lse = _flash_attention_fwd_plain(q, k, v, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    di = attn._row_dot(out, do)
    for got, ref in zip(
            flash_attention_dkv(q, k, v, do, lse, di, True)
            + (flash_attention_dq(q, k, v, do, lse, di, True),),
            _flash_attention_dkv_plain(q, k, v, do, lse, di, True)
            + (_flash_attention_dq_plain(q, k, v, do, lse, di, True),)):
        assert torch.equal(got, ref)
    assert (flash_attention_fwd.launches, flash_attention_dkv.launches,
            flash_attention_dq.launches) == counts


def test_routing_on_the_cpu_at_the_flash_shape():
    """A CPU tensor where the flash rule holds (T = 4096, D = 128) runs
    plain_attention; a causal call with Tq != Tk keeps its prefix-offset
    mask (query j sees keys up to Tk - Tq + j)."""
    assert attn.uses_flash(4096, 4096, 128)
    q, k, v = (torch.from_numpy(x) for x in _draw(
        6, (1, 4096, 1, 128), (1, 4096, 1, 128), (1, 4096, 1, 128)))
    before = flash_attention_fwd.launches
    assert torch.equal(attention(q, k, v, causal=True),
                       plain_attention(q, k, v, causal=True))
    assert flash_attention_fwd.launches == before
    tail = q[:, -5:]
    got = attention(tail, k, v, causal=True)
    scores = torch.einsum("bqhd,bkhd->bhqk", tail, k) / math.sqrt(128)
    visible = torch.arange(4096)[None, :] <= 4091 + torch.arange(5)[:, None]
    p = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
    torch.testing.assert_close(got, torch.einsum("bhqk,bkhd->bqhd", p, v),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["rank", "heads", "dtype", "mixed",
                                  "causal_lengths", "stats", "dout"])
def test_flash_wrappers_refuse_bad_calls(case):
    """Shapes, types and the causal Tq != Tk the kernels do not take
    raise, on the CPU as on the card."""
    q = torch.zeros((1, 8, 2, 64))
    k = v = torch.zeros((1, 8, 2, 64))
    lse = di = torch.zeros((1, 2, 8))
    do = torch.zeros_like(q)
    calls = {
        "rank": lambda: flash_attention_fwd(q[0], k[0], v[0]),
        "heads": lambda: flash_attention_fwd(q, k[:, :, :1], v[:, :, :1]),
        "dtype": lambda: flash_attention_fwd(q.to(torch.float16), k, v),
        "mixed": lambda: flash_attention_fwd(q, k.to(torch.bfloat16), v),
        "causal_lengths": lambda: flash_attention_fwd(q[:, :4], k, v, True),
        "stats": lambda: flash_attention_dkv(q, k, v, do, lse[..., :4], di),
        "dout": lambda: flash_attention_dq(q, k, v, do[:, :4], lse, di),
    }
    with pytest.raises((ValueError, TypeError)):
        calls[case]()


# -- the training tier's blocks ------------------------------------------------

#: level 0 rounds q, k, v and the attention output to bf16 on both sides
#: at other places (JAX also rounds the probabilities): outputs of order 1
#: agree to a few bf16 steps; levels 1 and 2 are f32 (~1e-6 measured)
BLOCK_ATOL = {0: 3e-2, 1: 1e-4, 2: 1e-4}


@pytest.fixture
def engine(monkeypatch):
    from veles_tpu.core.config import root as jroot
    from veles_tpu_torch.core.config import root

    def set_level(level):
        for cfg in (jroot, root):
            monkeypatch.setattr(cfg.common.engine, "precision_level", level,
                                raising=False)
    return set_level


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_attention_block_matches_jax(engine, level, causal, residual):
    engine(level)
    embed, heads = 64, 2
    x, w, b, ow, ob = _draw(7, (2, 48, embed), (embed, 3 * embed),
                            (3 * embed,), (embed, embed), (embed,))
    w, ow = w / math.sqrt(embed), ow / math.sqrt(embed)
    want = jattention.attention_block(
        *map(jnp.asarray, (x, w, b, ow, ob)), heads, causal, residual)
    got = attention_block(*map(torch.from_numpy, (x, w, b, ow, ob)), heads,
                          causal, residual)
    assert got.dtype == torch.float32
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), rtol=0,
                                  atol=BLOCK_ATOL[level])


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("activation", ["gelu", "relu", "tanh", "linear"])
@pytest.mark.parametrize("level", [0, 2])
def test_ffn_block_matches_jax(engine, level, activation, residual):
    engine(level)
    embed, hidden = 32, 128
    x, w1, b1, w2, b2 = _draw(8, (2, 24, embed), (embed, hidden), (hidden,),
                              (hidden, embed), (embed,))
    w1, w2 = w1 / math.sqrt(embed), w2 / math.sqrt(hidden)
    want = jattention.ffn_block(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                                activation, residual)
    got = ffn_block(*map(torch.from_numpy, (x, w1, b1, w2, b2)), activation,
                    residual)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), rtol=0,
                                  atol=BLOCK_ATOL[level])


def test_attention_at_the_flash_shape_with_256_wide_heads(engine):
    """T = 4096 with one 256-wide head, where the flash rule holds (on
    the card the port runs K7 here): ``attention`` and, at level 0,
    ``attention_block`` on the CPU against the JAX package's (XLA on the
    CPU, its flash route being the TPU's)."""
    assert attn.uses_flash(4096, 4096, 256)
    shape = (1, 4096, 1, 256)
    q, k, v = _draw(9, shape, shape, shape)
    want = jattention.attention(*map(jnp.asarray, (q, k, v)), causal=True)
    got = attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), rtol=0,
                                  atol=F32_FWD_ATOL)
    engine(0)
    embed = 256
    x, w, b, ow, ob = _draw(10, (1, 4096, embed), (embed, 3 * embed),
                            (3 * embed,), (embed, embed), (embed,))
    w, ow = w / math.sqrt(embed), ow / math.sqrt(embed)
    want = jattention.attention_block(
        *map(jnp.asarray, (x, w, b, ow, ob)), 1, True, True)
    got = attention_block(*map(torch.from_numpy, (x, w, b, ow, ob)), 1,
                          True, True)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), rtol=0,
                                  atol=BLOCK_ATOL[0])
