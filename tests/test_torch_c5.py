"""C5 on the CPU: the plain versions of K1, K3 and K4 (what the port's
wrappers run on CPU tensors, and what chip_smoke.py holds the kernels
against on the card) at a head width past 1024 against the JAX
package's Pallas kernels run in interpret mode, as its own tests run
them, on the same numpy inputs; and the wrappers' limit.

Tolerance: both sides compute in f32 from values they widen exactly
(f32 or int8 codes with f32 scales); they differ in the order of the
1536-term dots and of the softmax merge, a few ulp of outputs of order
1, so 1e-5."""

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.ops import paged_attention as jpgatt
from veles_tpu.ops import quant as jquant
from veles_tpu_torch.ops import paged_attention as tpgatt
from veles_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

D = 1536
PS = 8
ATOL = 1e-5


def _table(lengths, pb):
    table = numpy.zeros((len(lengths), pb), numpy.int32)
    nxt = 1
    for s, n in enumerate(lengths):
        for p in range(min(n // PS + 1, pb)):
            table[s, p] = nxt
            nxt += 1
    return table, nxt


def _codes(rng, shape):
    """int8 codes and positive f32 scales, as the pool holds them."""
    codes = rng.randint(-127, 128, shape).astype(numpy.int8)
    return codes, rng.uniform(0.01, 0.05, shape[:-2] + shape[-1:]).astype(
        numpy.float32)


def test_k1_plain_matches_jax_at_1536():
    rng = numpy.random.RandomState(1)
    lengths, pb = [0, PS + 2, 3 * PS - 1], 4
    table, pages = _table(lengths, pb)
    q = rng.randn(3, 2, D).astype(numpy.float32)
    k = rng.randn(pages + 1, PS, 2, D).astype(numpy.float32)
    v = rng.randn(pages + 1, PS, 2, D).astype(numpy.float32)
    lengths = numpy.asarray(lengths, numpy.int32)
    ref = jpgatt.paged_attend(*map(jnp.asarray, (q, k, v, table, lengths)),
                              page_size=PS, interpret=True)
    out = tpgatt.paged_attend(*map(torch.from_numpy,
                                   (q, k, v, table, lengths)), page_size=PS)
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATOL, rtol=0)


def test_k3_plain_matches_jax_at_1536():
    rng = numpy.random.RandomState(2)
    lengths, pb = [0, PS + 2, 3 * PS - 1], 4
    table, pages = _table(lengths, pb)
    q = (rng.randn(3, 2, D) * D ** -0.5).astype(numpy.float32)
    k_q, k_s = _codes(rng, (pages + 1, 2, D, PS))
    v_q, v_s = _codes(rng, (pages + 1, 2, D, PS))
    lengths = numpy.asarray(lengths, numpy.int32)
    args = (q, k_q, k_s, v_q, v_s, table, lengths)
    ref = jpgatt.paged_attend_int8(*map(jnp.asarray, args), page_size=PS,
                                   interpret=True)
    out = tpgatt.paged_attend_int8(*map(torch.from_numpy, args),
                                   page_size=PS)
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATOL, rtol=0)


def test_k4_plain_matches_jax_at_1536():
    rng = numpy.random.RandomState(3)
    batch, heads, t = 2, 2, 256
    q = (rng.randn(batch, 1, heads, D) * D ** -0.5).astype(numpy.float32)
    k_q, k_s = _codes(rng, (batch, heads, D, t))
    v_q, v_s = _codes(rng, (batch, heads, D, t))
    pos = numpy.arange(t)
    mask = numpy.where(pos[None, :] <= numpy.array([5, 200])[:, None], 0.0,
                       -1e30).astype(numpy.float32)
    args = (q, k_q, k_s, v_q, v_s, mask)
    ref = jquant._pallas_cache_attend(*map(jnp.asarray, args),
                                      interpret=True)
    out = tquant.int8_cache_attend(*map(torch.from_numpy, args),
                                   use_pallas=True)
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATOL, rtol=0)


def test_the_limit_is_named():
    """MAX_HEAD_DIM is where one head's f32 query and accumulator and the
    smallest stages fill a block's 227 KB: the widest head K1, K3 and K4
    stage. Past it the wide path keeps each split's sums in the merge
    workspace, which is then allocated even for one split."""
    assert tpgatt.MAX_HEAD_DIM == 8192
    assert 2 * 4 * tpgatt.MAX_HEAD_DIM <= 227 * 1024
    d = tpgatt.MAX_HEAD_DIM
    assert tpgatt.split_elements(3, 1, d) == 0
    assert tpgatt.split_elements(3, 1, d + 1) == 3 * (d + 3)
    assert tpgatt.split_elements(3, 2, d) == 3 * 2 * (d + 2)


@pytest.mark.parametrize("wrapper", ["paged_attend", "paged_attend_int8",
                                     "int8_cache_attend"])
def test_cpu_plain_versions_take_any_width(wrapper):
    """On the CPU the plain versions run at any width, past the kernels'
    limit too (the limit is the card's shared memory)."""
    d = tpgatt.MAX_HEAD_DIM + 32
    if wrapper == "int8_cache_attend":
        q = torch.zeros((1, 1, 1, d))
        codes = torch.zeros((1, 1, d, 128), dtype=torch.int8)
        scale = torch.ones((1, 1, 128))
        out = tquant.int8_cache_attend(q, codes, scale, codes, scale,
                                       torch.zeros(128), use_pallas=True)
    else:
        table = torch.ones((1, 1), dtype=torch.int32)
        lengths = torch.zeros(1, dtype=torch.int32)
        q = torch.zeros((1, 1, d))
        if wrapper == "paged_attend":
            pool = torch.zeros((2, PS, 1, d))
            out = tpgatt.paged_attend(q, pool, pool, table, lengths,
                                      page_size=PS)
        else:
            codes = torch.zeros((2, 1, d, PS), dtype=torch.int8)
            scale = torch.ones((2, 1, PS))
            out = tpgatt.paged_attend_int8(q, codes, scale, codes, scale,
                                           table, lengths, page_size=PS)
    assert out.shape[-1] == d and torch.isfinite(out).all()
