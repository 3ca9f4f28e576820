"""The port's int8-KV tier against the JAX package's on the same numpy
inputs, on the CPU: the KV quantization, the dense int8 attend, the
paged int8 attend (the JAX Pallas kernel run in interpret mode, and its
gather path), the reference decode and the paged pool's int8 append.

On the CPU the port's paged_attend_int8 runs its plain version;
chip_smoke.py and tests/test_torch_cuda.py hold the CUDA kernel against
that plain version on the card."""

import math

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.ops import paged_attention as jpgatt
from veles_tpu.ops import quant as jquant
from veles_tpu.parallel import decode as jdec
from veles_tpu.parallel import kv_pool as jpool
from veles_tpu.parallel import transformer_step as jts
from veles_tpu_torch.ops import paged_attention as tpgatt
from veles_tpu_torch.ops import quant as tquant
from veles_tpu_torch.parallel import decode as tdec
from veles_tpu_torch.parallel import kv_pool as tpool
from veles_tpu_torch.parallel import transformer_step as tts

torch.set_num_threads(1)

PS = 8
BLOCKS, EMBED, HEADS, VOCAB = 2, 32, 4, 64
#: both sides compute in f32 from the same int8 codes and f32 scales;
#: only the order of the sums (and of the TPU kernel's page merge) moves
#: results of order 1 by a few ulp
ATOL = 1e-5


def _t(array):
    return torch.from_numpy(numpy.array(array))


def test_quantize_kv_matches_jax_bit_for_bit():
    x = numpy.random.RandomState(0).randn(3, 5, 4, 8).astype(numpy.float32)
    x[0, 0, 0] = 0.0               # absmax 0: scale 1, codes 0
    x[1, 2, 3, :2] = [0.5, -1.0]   # exact halves round to even
    x[1, 2, 3, 2:] = 0.0
    x[2, 1, 1] *= 300.0
    jq, js = jdec._quantize_kv(jnp.asarray(x))
    tq, ts = tdec._quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    numpy.testing.assert_array_equal(tq.numpy(), numpy.asarray(jq))
    numpy.testing.assert_array_equal(ts.numpy(), numpy.asarray(js))
    assert ts[0, 0, 0] == 1.0 and not tq[0, 0, 0].any()


def _dense_problem(batch=3, heads=4, head_dim=8, t=24, seed=1):
    rng = numpy.random.RandomState(seed)
    q = rng.randn(batch, 1, heads, head_dim).astype(numpy.float32) \
        / math.sqrt(head_dim)
    kv = []
    for _ in range(2):
        codes, scale = jdec._quantize_kv(jnp.asarray(
            rng.randn(batch, t, heads, head_dim).astype(numpy.float32)))
        kv += [numpy.asarray(jnp.transpose(codes, (0, 2, 3, 1))),
               numpy.asarray(jnp.transpose(scale, (0, 2, 1)))]
    return q, kv


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per-row"])
def test_int8_cache_attend_matches_jax(per_row):
    q, kv = _dense_problem()
    t = kv[0].shape[-1]
    if per_row:
        mask = numpy.where(numpy.arange(t)[None, :]
                           <= numpy.asarray([0, 9, t - 1])[:, None],
                           0.0, -1e30).astype(numpy.float32)
    else:
        mask = numpy.where(numpy.arange(t) <= 13, 0.0,
                           -1e30).astype(numpy.float32)
    ref = jquant.int8_cache_attend(jnp.asarray(q), *map(jnp.asarray, kv),
                                   jnp.asarray(mask))
    out = tquant.int8_cache_attend(torch.from_numpy(q), *map(_t, kv),
                                   torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == q.shape
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATOL, rtol=0)


def test_int8_cache_attend_bf16_rounds_the_value_weights():
    """With a bf16 q the JAX formulation rounds ``p * v_scale`` to bf16
    before the value product; the port does the same, so the two agree
    as closely as in f32."""
    q, kv = _dense_problem(seed=2)
    mask = numpy.zeros(kv[0].shape[-1], numpy.float32)
    ref = jquant.int8_cache_attend(jnp.asarray(q, jnp.bfloat16),
                                   *map(jnp.asarray, kv), jnp.asarray(mask))
    out = tquant.int8_cache_attend(torch.from_numpy(q).bfloat16(),
                                   *map(_t, kv), torch.from_numpy(mask))
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATOL, rtol=0)


def test_int8_cache_attend_refuses_the_dense_kernel():
    """T = 24 fails the dense attend kernel's gate (T % 128): asked for
    the kernel there, the port raises instead of running torch ops."""
    q, kv = _dense_problem()
    with pytest.raises(ValueError, match="T % 128"):
        tquant.int8_cache_attend(torch.from_numpy(q), *map(_t, kv),
                                 torch.zeros(kv[0].shape[-1]),
                                 use_pallas=True)


def _paged_problem(lengths, pb, heads=4, head_dim=8, seed=7):
    """Live pages 1.. of each row in logical order, the rest of each row
    the scratch page 0; codes and scales from the JAX package's
    quantization, re-laid head-major as the pool holds them."""
    rng = numpy.random.RandomState(seed)
    slots = len(lengths)
    table = numpy.zeros((slots, pb), numpy.int32)
    nxt = 1
    for s, n in enumerate(lengths):
        for p in range(min(n // PS + 1, pb)):
            table[s, p] = nxt
            nxt += 1
    q = rng.randn(slots, heads, head_dim).astype(numpy.float32) \
        / math.sqrt(head_dim)
    pool = []
    for _ in range(2):
        codes, scale = jdec._quantize_kv(jnp.asarray(rng.randn(
            nxt + 2, PS, heads, head_dim).astype(numpy.float32)))
        pool += [numpy.array(jnp.transpose(codes, (0, 2, 3, 1))),
                 numpy.array(jnp.transpose(scale, (0, 2, 1)))]
    return q, pool, table, numpy.asarray(lengths, numpy.int32)


PAGED_CASES = pytest.mark.parametrize("lengths,pb", [
    ([0, PS, 2 * PS + 3], 3),          # length 0, a page boundary
    ([5, 0, PS - 1, 3 * PS], 6),       # more table pages than live
    ([3 * PS - 1, 4 * PS + 2], 3),     # full table rows: the PB cap
], ids=["boundary", "wide-table", "full-row"])


@PAGED_CASES
def test_paged_int8_plain_matches_jax_kernel(lengths, pb):
    q, pool, table, lens = _paged_problem(lengths, pb)
    ref = jpgatt.paged_attend_int8(
        jnp.asarray(q), *map(jnp.asarray, pool), jnp.asarray(table),
        jnp.asarray(lens), page_size=PS, interpret=True)
    out = tpgatt.paged_attend_int8(torch.from_numpy(q), *map(_t, pool),
                                   torch.from_numpy(table),
                                   torch.from_numpy(lens), page_size=PS)
    assert out.dtype == torch.float32 and out.shape == q.shape
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATOL, rtol=0)


@pytest.mark.parametrize("head_dim", [96, 256])
def test_paged_int8_plain_matches_jax_kernel_at_the_wider_kernel_widths(
        head_dim):
    """Head widths of the card kernel's rule (every multiple of 32 up to
    1024) besides the powers of two, and past 128, with length 0, a page
    boundary and a full table row."""
    q, pool, table, lens = _paged_problem([0, PS, 3 * PS + 2], 3, heads=2,
                                          head_dim=head_dim)
    ref = jpgatt.paged_attend_int8(
        jnp.asarray(q), *map(jnp.asarray, pool), jnp.asarray(table),
        jnp.asarray(lens), page_size=PS, interpret=True)
    out = tpgatt.paged_attend_int8(torch.from_numpy(q), *map(_t, pool),
                                   torch.from_numpy(table),
                                   torch.from_numpy(lens), page_size=PS)
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATOL, rtol=0)


@PAGED_CASES
def test_paged_int8_plain_matches_jax_gather_path(lengths, pb):
    """The JAX serving path off the TPU: the page-table gather into the
    head-major span, then ``int8_cache_attend`` under the per-row
    mask (f32: no bf16 rounding on either side)."""
    q, pool, table, lens = _paged_problem(lengths, pb)
    state = dict(zip(("k", "k_scale", "v", "v_scale"),
                     (jnp.asarray(a)[None] for a in pool)))
    k8, ks, v8, vs = jpool._gather_block_int8(state, 0, jnp.asarray(table))
    span = pb * PS
    mask = jnp.where(jnp.arange(span)[None, :]
                     <= jnp.asarray(lens)[:, None], 0.0,
                     -1e30).astype(jnp.float32)
    ref = jquant.int8_cache_attend(jnp.asarray(q)[:, None], k8, ks, v8,
                                   vs, mask)[:, 0]
    out = tpgatt.paged_attend_int8(torch.from_numpy(q), *map(_t, pool),
                                   torch.from_numpy(table),
                                   torch.from_numpy(lens), page_size=PS)
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATOL, rtol=0)


def test_paged_int8_scratch_page_is_never_seen():
    q, pool, table, lens = _paged_problem([0, PS + 1, 3], 3)
    args = lambda: (torch.from_numpy(q), *map(_t, pool),  # noqa: E731
                    torch.from_numpy(table), torch.from_numpy(lens))
    first = tpgatt.paged_attend_int8(*args(), page_size=PS)
    for codes in (pool[0], pool[2]):
        codes[0] = 127
    for scale in (pool[1], pool[3]):
        scale[0] = 1e30
    second = tpgatt.paged_attend_int8(*args(), page_size=PS)
    torch.testing.assert_close(first, second, rtol=0, atol=0)


def test_paged_int8_cpu_tensors_never_count_a_launch():
    q, pool, table, lens = _paged_problem([1, 2], 1)
    before = tpgatt.paged_attend_int8.launches
    tpgatt.paged_attend_int8(torch.from_numpy(q), *map(_t, pool),
                             torch.from_numpy(table),
                             torch.from_numpy(lens), page_size=PS)
    assert tpgatt.paged_attend_int8.launches == before


@pytest.mark.parametrize("case", ["pool_shape", "scale_shape",
                                  "codes_dtype", "scale_dtype",
                                  "lengths_int64", "page_size"])
def test_paged_int8_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, (kq, ks, vq, vs), table, lens = _paged_problem([1, PS], 2)
    q, kq, ks, vq, vs, table, lens = map(_t, (q, kq, ks, vq, vs, table,
                                              lens))
    args = {"pool_shape": (q, kq[:, :2], ks, vq[:, :2], vs, table, lens),
            "scale_shape": (q, kq, ks[..., :2], vq, vs[..., :2], table,
                            lens),
            "codes_dtype": (q, kq.float(), ks, vq.float(), vs, table,
                            lens),
            "scale_dtype": (q, kq, ks.double(), vq, vs.double(), table,
                            lens),
            "lengths_int64": (q, kq, ks, vq, vs, table, lens.long()),
            "page_size": (q, kq, ks, vq, vs, table, lens)}[case]
    with pytest.raises((ValueError, TypeError)):
        tpgatt.paged_attend_int8(*args, page_size=PS * 2
                                 if case == "page_size" else PS)


@pytest.fixture(scope="module")
def model():
    jparams = jts.init_transformer_params(numpy.random.RandomState(0),
                                          BLOCKS, EMBED, HEADS, VOCAB)
    tparams = tts.init_transformer_params(numpy.random.RandomState(0),
                                          BLOCKS, EMBED, HEADS, VOCAB,
                                          device="cpu")
    table = numpy.random.RandomState(1).randn(VOCAB, EMBED).astype(
        numpy.float32)
    return jparams, tparams, table


def test_generate_int8_kv_matches_jax(model):
    """Tokens equal, and the cache the JAX package fills — codes bit for
    bit, scales to f32 round-off of K/V that went through the same
    sublayers in another summation order — with max_len rounded up to
    whole 128-position tiles on both sides."""
    jparams, tparams, table = model
    prompt = numpy.random.RandomState(5).randint(0, VOCAB, (1, 11))
    jtoks, jcache = jdec.generate(jparams, jnp.asarray(table),
                                  jnp.asarray(prompt), HEADS, n_tokens=12,
                                  quantize="int8-kv")
    ttoks, tcache = tdec.generate(tparams, torch.from_numpy(table), prompt,
                                  HEADS, n_tokens=12, quantize="int8-kv",
                                  device="cpu")
    assert ttoks.tolist() == numpy.asarray(jtoks).tolist()
    assert len(set(ttoks[0].tolist())) > 3   # a stream worth comparing
    assert tcache["k"].shape[-1] == 128 and tcache["length"] == 23
    for name in ("k", "v"):
        numpy.testing.assert_array_equal(tcache[name].numpy(),
                                         numpy.asarray(jcache[name]))
        numpy.testing.assert_allclose(
            tcache[name + "_scale"].numpy(),
            numpy.asarray(jcache[name + "_scale"]), rtol=1e-5, atol=0)


def test_paged_step_int8_append_matches_jax_pool(model):
    """One int8 paged step writes each slot's quantized K/V at page
    ``table[s, len // ps]``, offset ``len % ps`` of the head-major pool,
    the JAX package's pool bit for bit (a slot of length 0, one at a
    page boundary, one mid-page, and an inactive slot aimed at the
    scratch page)."""
    jparams, tparams, table = model
    pages, slots = 7, 4
    lengths = numpy.asarray([0, PS, PS + 3, 2], numpy.int32)
    page_table = numpy.asarray([[1, 0], [2, 3], [4, 5], [0, 0]],
                               numpy.int32)
    active = numpy.asarray([True, True, True, False])
    logits = numpy.random.RandomState(3).randn(slots, VOCAB).astype(
        numpy.float32)
    jstate = jpool.init_paged_state(BLOCKS, pages, PS, HEADS,
                                    EMBED // HEADS, VOCAB, slots,
                                    quantized=True)
    jstate = dict(jstate, lengths=jnp.asarray(lengths),
                  logits=jnp.asarray(logits))
    jstate, jtok = jpool._paged_slot_step(
        jparams, jnp.asarray(table), HEADS, jstate,
        jnp.asarray(page_table), jnp.asarray(active))
    tstate = tpool.init_paged_state(BLOCKS, pages, PS, HEADS,
                                    EMBED // HEADS, VOCAB, slots,
                                    quantized=True, device="cpu")
    tstate["lengths"][:] = torch.from_numpy(lengths)
    tstate["logits"][:] = torch.from_numpy(logits)
    tstate, ttok = tpool.paged_slot_step(
        tparams, torch.from_numpy(table), HEADS, tstate,
        torch.from_numpy(page_table), torch.from_numpy(active))
    assert ttok.tolist() == numpy.asarray(jtok).tolist()
    assert tstate["lengths"].tolist() == [1, PS + 1, PS + 4, 2]
    live = [1, 2, 3, 4, 5, 6]    # every page but the scratch page
    for name in ("k", "v"):
        numpy.testing.assert_array_equal(
            tstate[name][:, live].numpy(),
            numpy.asarray(jstate[name])[:, live])
        numpy.testing.assert_allclose(
            tstate[name + "_scale"][:, live].numpy(),
            numpy.asarray(jstate[name + "_scale"])[:, live],
            rtol=1e-6, atol=0)
    numpy.testing.assert_allclose(tstate["logits"].numpy(),
                                  numpy.asarray(jstate["logits"]),
                                  atol=2e-5, rtol=0)
    assert tpool.paged_kv_bytes(tstate) == 2 * BLOCKS * pages * HEADS * (
        EMBED // HEADS + 4) * PS
