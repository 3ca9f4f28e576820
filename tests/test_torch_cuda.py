"""The port's CUDA kernels against their plain versions on the card, at
the shapes and types the serving smoke does not reach: K2 at every
decode-step shape and 1 to 256 rows in both x types, its byte-wise path
(N % 16 != 0, misaligned q), ragged K and N, two calls bit-equal, calls
of other shapes in a row (the split counters reset), the M > 256 regime
rule; K1 at head widths 8 to 4096 (C4's widths: 8, 16, 33, 48, 80,
96, 100, 512, 1024, and 32 to 256; C5's: 1025, 1536, 2048, 4096) in
every mix of query and pool types (and 8192, the widest staged head),
past it on the wide path (C6's 8200, 12288 and 16384),
at its splits' boundaries (16- and 128-token pages), NaN rows on
invisible positions, twice bit for bit; K3 at length 0, full table rows,
head widths 8 to 4096 (the powers of two, 96, C4's and C5's widths) in
both query types, 8-, 16- and 128-token pages
at its splits' boundaries, NaN scales on invisible positions, twice bit
for bit, and at C6's widths past 8192; K4 at head widths 32 to 4096
(C5's 1056 to 4096 and C6's 8224 to 16384 twice bit for bit), shared
and per-row masks,
lanes of several 8192-position tiles (one fully masked tile first or
last) and a slab view cut to a span, with one split, a ragged last
split, a fully masked split and a fully masked row, twice bit for bit;
the split counters K1, K2, K3 and K4 share left at zero; the
breaker's page restore (_paged_restore) on a CUDA pool, the restored
pages bit-equal to their shadows; and the
dense int8-KV decoder on the card against the CPU; the wrappers'
refusals; prefill attention at 4096 positions with a head width the
flash rule leaves to plain attention; K5 and K6 at odd shapes, both
operand types, every activation, transposed and strided operands, and
the dense layer's backward on the card against the plain backward, and
K5's bf16 route (TMA and wgmma) at the training path's two layouts and
at operands TMA refuses (the wrapper copies them), K6's (the same
mainloop with the epilogue) at k = 784, a ragged shape and AlexNet's
head (N = 1000); a level-2 conv2d in full f32 with cuDNN's TF32 flag on; K7, K8 and K9 at
ragged T, at 4096 and 8192 positions, causal and not, at the edges of
the 128-wide kernels' tiles, at head widths 128, 256 and 384, on the qkv
projection's split views, K8 and K9 run twice bit for bit, attention() at
4096 positions with 256-wide heads, the custom VJP on the card against
the CPU, the wrappers' refusals and a refused launch; a workflow
trained on the card, snapshotted and resumed on either device; and the
autotuner's candidates: K5 and K6 at both output tile widths (BN 128 and
256), K2 at every split count, K1 and K3 at every pages-per-split it
races, a race on the card persisted under this card's key, the routes
the verdicts choose, and the device benchmark's power; and the observe
plane: the device families of ``/metrics`` on a front on the card, K1's
kernels under ``paged.dispatch`` in a profile, the card's bf16 peak,
memscope's owners against the caching allocator and a ledger row per
request served on the card; and what acts on it: a governed demotion to
int8 whose requests launch K2, and a rollout's green engine streaming
the new weights; and the data-parallel mesh: the three reduce tiers on
CUDA tensors in a world of one over NCCL, and two ranks sharing the card
over gloo against one process stepping the whole minibatches; and the
training fleet: a master and a slave on the card, the slave's data-plane
tick launching K6 on every minibatch and K5 on every train one, its
frames holding numpy arrays only; and the AOT bundle: a process booted
from a bundle of this card's libraries, from a copy of the package with
an empty build directory, building no kernel and streaming the live
decoder's tokens; and the sharded serving mesh: two ranks sharing the
card over gloo behind rank 0's GenerateAPI, one process's tokens and
each rank's K1 and K2 launches a decode step; and the training mesh's
seq axis: two ranks sharing the card through a Ulysses step, each
launching K7, K8 and K9, and C11's repair, an f32 step at flash shapes
training through K8 and K9's f32 route as the same step does on the CPU;
and the serving governor over that mesh: two ranks walking a tier swap
and back behind rank 0's governor, the follower building and dropping an
engine a swap.

Needs a CUDA card and nvcc; everywhere else every test skips. Run on
the card without the JAX package's conftest (the card's machine has no
JAX):

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda.py
"""

import math

import numpy
import pytest
import torch

from veles_tpu_torch.core.config import root
from veles_tpu_torch.ops import gemm
from veles_tpu_torch.ops.activations import ACTIVATIONS

from veles_tpu_torch.ops import attention as attn
from veles_tpu_torch.ops.attention import (
    _flash_attention_dkv_plain, _flash_attention_dq_plain,
    _flash_attention_fwd_plain, attention, flash_attention,
    flash_attention_dkv, flash_attention_dq, flash_attention_fwd,
    plain_attention)
from veles_tpu_torch.ops.gemm import (_blocked_matmul_plain,
                                      _dense_epilogue_plain, blocked_matmul,
                                      dense_epilogue)
from veles_tpu_torch.ops import _workspace
from veles_tpu_torch.ops.paged_attention import (MAX_HEAD_DIM,
                                                 _paged_attend_int8_plain,
                                                 _paged_attend_plain,
                                                 _paged_plan, paged_attend,
                                                 paged_attend_int8)
from veles_tpu_torch.ops.quant import (PALLAS_MAX_ROWS, _attend_plan,
                                       _cache_attend_plain,
                                       _int8_matmul_plain,
                                       int8_cache_attend, int8_matmul,
                                       quantize_int8)
from veles_tpu_torch.parallel import kv_pool
from veles_tpu_torch.parallel.decode import _quantize_kv
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)
from veles_tpu_torch.serving import ContinuousDecoder
from veles_tpu_torch.device import tree_leaves_with_path

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _empty_tuning_cache(tmp_path, monkeypatch):
    """Every test runs without verdicts (a fresh tuning cache), so the
    routes and plans are the defaults unless a test writes one."""
    monkeypatch.setattr(root.common.engine, "pallas_autotune_cache",
                        str(tmp_path / "pallas_tuning.json"), raising=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip, see the module "
                    "docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _int8_problem(gen, m, k, n, dtype):
    w = torch.randn((k, n), generator=gen, device="cuda")
    q, scale = quantize_int8(w)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    return x, q, scale


def _close(out, ref, dtype):
    if dtype == torch.float32:
        # f32 sums of up to 1024 terms in another order
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        # one bf16 rounding of the output may differ by an ulp (2^-8)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 1e-2 * ref.float().abs().max().item()


@pytest.mark.parametrize("m,k,n,dtype", [
    (1, 16, 16, torch.float32),
    (3, 37, 50, torch.bfloat16),      # byte-wise loads, ragged N edge
    (8, 600, 130, torch.float32),     # two K chunks, ragged N
    (100, 1024, 1000, torch.bfloat16),
    (PALLAS_MAX_ROWS, 64, 4096, torch.float32),
], ids=["tiny", "ragged", "two-chunks", "m100", "m256"])
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n, dtype):
    x, q, scale = _int8_problem(cuda, m, k, n, dtype)
    before = int8_matmul.launches
    out = int8_matmul(x, q, scale)
    assert int8_matmul.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    _close(out, _int8_matmul_plain(x, q, scale), dtype)


def test_int8_matmul_misaligned_weights_take_the_byte_path(cuda):
    x, q, scale = _int8_problem(cuda, 4, 32, 64, torch.float32)
    flat = torch.empty(q.numel() + 1, dtype=torch.int8, device="cuda")
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16
    _close(int8_matmul(x, shifted, scale),
           _int8_matmul_plain(x, q, scale), torch.float32)


def test_int8_matmul_large_m_runs_the_plain_product(cuda):
    x, q, scale = _int8_problem(cuda, PALLAS_MAX_ROWS + 1, 64, 32,
                                torch.float32)
    before = int8_matmul.launches
    out = int8_matmul(x, q, scale)
    assert int8_matmul.launches == before
    _close(out, _int8_matmul_plain(x, q, scale), torch.float32)


#: the serving model's decode-step weights (K, N): qkv, out, MLP up, MLP
#: down, the vocab head; and the rows the serving path sends
K2_DECODE_SHAPES = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
                    (1024, 32768)]
K2_ROWS = [1, 8, 16, 100, PALLAS_MAX_ROWS]


def _close_to_largest(out, ref):
    """K2 against its plain version, relative to the largest output: f32
    sums of up to 4096 terms in another order (~1e-6 of it); one bf16
    rounding of the output may differ by an ulp (2^-8)."""
    tol = 1e-5 if out.dtype == torch.float32 else 1e-2
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.parametrize("m", K2_ROWS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("k,n", K2_DECODE_SHAPES,
                         ids=["%dx%d" % s for s in K2_DECODE_SHAPES])
def test_int8_matmul_at_the_decode_shapes(cuda, k, n, dtype, m):
    x, q, scale = _int8_problem(cuda, m, k, n, dtype)
    before = int8_matmul.launches
    out = int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    _close_to_largest(out, _int8_matmul_plain(x, q, scale))


@pytest.mark.parametrize("m,k,n,dtype", [
    (8, 1000, 1024, torch.bfloat16),  # ragged K split, x rows copied
    (8, 37, 4096, torch.float32),     # one ragged 16-row step
    (100, 1000, 130, torch.bfloat16),  # ragged K and N: the byte path
    (16, 4100, 1040, torch.float32),  # ragged last tile, split
    (256, 37, 48, torch.bfloat16),
], ids=["k1000", "k37", "k1000_n130", "n1040", "m256_k37"])
def test_int8_matmul_ragged_k_and_n(cuda, m, k, n, dtype):
    x, q, scale = _int8_problem(cuda, m, k, n, dtype)
    out = int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    _close_to_largest(out, _int8_matmul_plain(x, q, scale))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_int8_matmul_is_deterministic(cuda, dtype):
    """Split-K partials meet in split order in the tile's last block:
    two calls are bit-equal at every decode shape."""
    for k, n in K2_DECODE_SHAPES:
        x, q, scale = _int8_problem(cuda, 8, k, n, dtype)
        first = int8_matmul(x, q, scale)
        second = int8_matmul(x, q, scale)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_int8_matmul_counters_reset_between_shapes(cuda):
    """Calls of other shapes (and splits) in a row on one stream each
    find their tile counters at zero."""
    problems = [_int8_problem(cuda, m, k, n, torch.bfloat16)
                for m, k, n in ((8, 4096, 1024), (8, 1024, 1024),
                                (8, 1024, 3072), (100, 4096, 1024))]
    outs = [int8_matmul(*p) for p in problems + problems[:2]]
    torch.cuda.synchronize()
    for out, p in zip(outs, problems + problems[:2]):
        _close_to_largest(out, _int8_matmul_plain(*p))
    assert torch.equal(outs[0], outs[4]) and torch.equal(outs[1], outs[5])


def _paged_problem(gen, head_dim, q_dtype, kv_dtype, heads=4, ps=16):
    lengths = [0, ps - 1, ps, 3 * ps + 5, 7]
    pb = 6
    table = torch.zeros((len(lengths), pb), dtype=torch.int32)
    nxt = 1
    for s, n in enumerate(lengths):
        for p in range(n // ps + 1):
            table[s, p] = nxt
            nxt += 1
    shape = (nxt, ps, heads, head_dim)
    k = torch.randn(shape, generator=gen, device="cuda").to(kv_dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(kv_dtype)
    q = torch.randn((len(lengths), heads, head_dim), generator=gen,
                    device="cuda").to(q_dtype)
    return (q, k, v, table.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), ps)


@pytest.mark.parametrize("head_dim,q_dtype,kv_dtype", [
    (64, torch.float32, torch.float32),
    (64, torch.float32, torch.bfloat16),
    (32, torch.bfloat16, torch.float32),
    (128, torch.bfloat16, torch.bfloat16),
    (128, torch.float32, torch.float32),
    (32, torch.bfloat16, torch.bfloat16),
    (256, torch.bfloat16, torch.bfloat16),
], ids=["f32-64", "mixed-64", "mixed-32", "bf16-128", "f32-128",
        "bf16-32", "bf16-256"])
def test_paged_attend_kernel_matches_plain(cuda, head_dim, q_dtype,
                                           kv_dtype):
    q, k, v, table, lengths, ps = _paged_problem(cuda, head_dim, q_dtype,
                                                 kv_dtype)
    before = paged_attend.launches
    out = paged_attend(q, k, v, table, lengths, page_size=ps)
    assert paged_attend.launches == before + 1
    # f32 from values both sides widen exactly: only the order of the
    # sums and of the softmax merge differs
    torch.testing.assert_close(
        out, _paged_attend_plain(q, k, v, table, lengths, ps),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["misaligned_pool", "strided_q"])
def test_paged_attend_refuses_what_the_kernel_does_not_take(cuda, case):
    if case == "misaligned_pool":   # pages one element off 16 bytes
        q, k, v, table, lengths, ps = _paged_problem(
            cuda, 64, torch.bfloat16, torch.bfloat16)
        k = torch.cat([k.new_zeros(1), k.reshape(-1)])[1:].view(k.shape)
    else:
        q, k, v, table, lengths, ps = _paged_problem(
            cuda, 64, torch.float32, torch.float32)
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        paged_attend(q, k, v, table, lengths, page_size=ps)


def _int8_paged_problem(gen, head_dim, q_dtype, lengths, pb, heads=4,
                        ps=16):
    """The pool from ``_quantize_kv`` of random K/V, head-major; q
    pre-scaled by 1/sqrt(D); rows padded with the scratch page."""
    table = torch.zeros((len(lengths), pb), dtype=torch.int32)
    nxt = 1
    for s, n in enumerate(lengths):
        for p in range(min(n // ps + 1, pb)):
            table[s, p] = nxt
            nxt += 1
    pool = []
    for _ in range(2):
        codes, scale = _quantize_kv(torch.randn(
            (nxt + 1, ps, heads, head_dim), generator=gen, device="cuda"))
        pool += [codes.permute(0, 2, 3, 1).contiguous(),
                 scale.permute(0, 2, 1).contiguous()]
    q = torch.randn((len(lengths), heads, head_dim), generator=gen,
                    device="cuda") * head_dim ** -0.5
    return (q.to(q_dtype), *pool, table.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), ps)


@pytest.mark.parametrize("head_dim,q_dtype,lengths,pb", [
    (64, torch.bfloat16, [0, 15, 16, 53, 7], 6),      # length 0, boundary
    (64, torch.float32, [0, 15, 16, 53, 7], 6),
    (32, torch.bfloat16, [95, 200, 3], 6),           # full rows: PB cap
    (128, torch.float32, [0, 95, 40], 6),
    (128, torch.bfloat16, [1000, 2], 64),             # many quads a thread
], ids=["bf16-64", "f32-64", "full-rows-32", "f32-128", "long-128"])
def test_paged_attend_int8_kernel_matches_plain(cuda, head_dim, q_dtype,
                                                lengths, pb):
    args = _int8_paged_problem(cuda, head_dim, q_dtype, lengths, pb)
    before = paged_attend_int8.launches
    out = paged_attend_int8(*args[:-1], page_size=args[-1])
    assert paged_attend_int8.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    # f32 from int8 codes and f32 scales both sides widen exactly: only
    # the order of the sums and of the softmax merge differs
    torch.testing.assert_close(out, _paged_attend_int8_plain(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["strided_q", "strided_pool",
                                  "pool_shape", "misaligned_scale",
                                  "table_rows", "page_size"])
def test_paged_attend_int8_refuses_what_the_kernel_does_not_take(cuda,
                                                                 case):
    q, kq, ks, vq, vs, table, lengths, ps = _int8_paged_problem(
        cuda, 64, torch.float32, [3, 20], 2)
    if case == "strided_q":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "strided_pool":
        kq = kq.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "pool_shape":
        vq, vs = vq[:, :2], vs[:, :2]
    elif case == "misaligned_scale":   # scales one float off 16 bytes
        ks = torch.cat([ks.new_zeros(1), ks.reshape(-1)])[1:].view(ks.shape)
    elif case == "table_rows":   # a page table row short
        table = table[:1]
    else:   # a page size the kernel's 4-position copies cannot walk
        q, kq, ks, vq, vs, table, lengths, ps = _int8_paged_problem(
            cuda, 64, torch.float32, [3, 20], 2, ps=10)
    before = paged_attend_int8.launches
    with pytest.raises(ValueError):
        paged_attend_int8(q, kq, ks, vq, vs, table, lengths, page_size=ps)
    assert paged_attend_int8.launches == before


#: every head width of K3's rule the card tests hold: the powers of two,
#: a width between them, and the widest
K3_WIDTHS = [32, 64, 96, 128, 256, 512, 1024]


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("head_dim", K3_WIDTHS)
def test_paged_attend_int8_at_every_width(cuda, head_dim, q_dtype):
    """128-token pages, one page a split: one stage a split up to D =
    128, then 2, 4 and 8 sub-page stages in the two-stage ring; a
    length-0 slot, a page boundary and a 1100-position slot."""
    args = _int8_paged_problem(cuda, head_dim, q_dtype, [0, 127, 1100], 10,
                               heads=2, ps=128)
    before = paged_attend_int8.launches
    out = paged_attend_int8(*args[:-1], page_size=128)
    assert paged_attend_int8.launches == before + 1
    torch.testing.assert_close(out, _paged_attend_int8_plain(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ps", [8, 16, 128])
def test_paged_attend_int8_at_split_boundaries(cuda, ps):
    """K3's splits (K1's plan: 16, 8 and 1 page(s) a split here) at the
    serving model's heads: slots whose visible positions end one before,
    at and one after a split's end, a length-0 slot beside a
    4000-position one, and a full table row; 4-byte copies at 8-token
    pages, 16-byte ones at 16 and 128."""
    pb = 4000 // ps + 2
    pages, splits, _ = _paged_plan(7, 16, 64, pb, ps, _sms())
    assert splits > 1
    span = pages * ps
    lengths = [span - 2, span - 1, span, 0, 4000, 2 * span, pb * ps + 7]
    args = _int8_paged_problem(cuda, 64, torch.bfloat16, lengths, pb,
                               heads=16, ps=ps)
    out = paged_attend_int8(*args[:-1], page_size=ps)
    torch.testing.assert_close(out, _paged_attend_int8_plain(*args),
                               rtol=1e-5, atol=1e-5)


def test_paged_attend_int8_is_deterministic(cuda):
    """The live splits meet in split order in the slot's last block: two
    calls are bit-equal, at the smoke's lengths and at lopsided ones."""
    for lengths in ([0, 127, 128, 300, 511, 700, 1023, 1100],
                    [1100] + [0] * 7):
        args = _int8_paged_problem(cuda, 64, torch.bfloat16, lengths, 10,
                                   heads=16, ps=128)
        first = paged_attend_int8(*args[:-1], page_size=128)
        second = paged_attend_int8(*args[:-1], page_size=128)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        torch.testing.assert_close(first, _paged_attend_int8_plain(*args),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ps", [8, 16, 128])
def test_paged_attend_int8_ignores_invisible_positions(cuda, ps):
    """NaN scales and extreme codes on the scratch page and past each
    slot's length in its last live page change no bit of the output:
    the kernel selects those positions out (score -inf, weight 0)."""
    lengths = [0, ps + 2, 2 * ps - 1, 5 * ps + 3]
    args = list(_int8_paged_problem(cuda, 64, torch.float32, lengths, 6,
                                    ps=ps))
    clean = paged_attend_int8(*args[:-1], page_size=ps)
    ref = _paged_attend_int8_plain(*args)
    table = args[5].cpu()
    for s, n in enumerate(lengths):
        last = int(table[s, n // ps])
        for codes, scale in ((args[1], args[2]), (args[3], args[4])):
            codes[last, :, :, n % ps + 1:] = 127
            scale[last, :, n % ps + 1:] = math.nan
    for codes, scale in ((args[1], args[2]), (args[3], args[4])):
        codes[0] = -128
        scale[0] = math.nan
    poisoned = paged_attend_int8(*args[:-1], page_size=ps)
    torch.cuda.synchronize()
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, clean)
    torch.testing.assert_close(poisoned, ref, rtol=1e-5, atol=1e-5)


def _slab_problem(gen, batch, heads, head_dim, width, q_dtype):
    """A head-major int8 slab (B, H, D, width) with (B, H, width)
    scales from ``_quantize_kv`` of random K/V, and q pre-scaled by
    1/sqrt(D)."""
    slab = []
    for _ in range(2):
        codes, scale = _quantize_kv(torch.randn(
            (batch, width, heads, head_dim), generator=gen, device="cuda"))
        slab += [codes.permute(0, 2, 3, 1).contiguous(),
                 scale.permute(0, 2, 1).contiguous()]
    q = torch.randn((batch, 1, heads, head_dim), generator=gen,
                    device="cuda") * head_dim ** -0.5
    return q.to(q_dtype), slab


def _slab_mask(kind, batch, t):
    """Per-row ragged lengths, one shared prefix as (T,) or (1, T), or
    ("late") only the positions past the first half visible."""
    if kind == "late":
        return torch.where(torch.arange(t, device="cuda") > t // 2, 0.0,
                           -1e30).float()
    if kind == "per-row":
        lengths = torch.arange(batch, device="cuda") * (t // batch) + 3
        return torch.where(torch.arange(t, device="cuda")[None, :]
                           <= lengths[:, None], 0.0, -1e30).float()
    mask = torch.where(torch.arange(t, device="cuda") <= t // 3, 0.0,
                       -1e30).float()
    return mask if kind == "shared" else mask[None]


@pytest.mark.parametrize("batch,heads,head_dim,t,q_dtype,mask_kind", [
    (8, 16, 64, 768, torch.bfloat16, "per-row"),     # the smoke's shape
    (3, 4, 32, 128, torch.float32, "shared"),
    (2, 2, 128, 256, torch.bfloat16, "shared-1xT"),
    (4, 2, 96, 384, torch.float32, "per-row"),
    (1, 2, 64, 16384, torch.float32, "per-row"),     # two whole tiles
    (3, 4, 64, 20480, torch.bfloat16, "per-row"),    # row 0: tile 1 only
    (2, 2, 32, 20480, torch.float32, "late"),        # tile 1 all masked
], ids=["smoke", "f32-32", "bf16-128", "f32-96", "long", "tiles",
        "late"])
def test_cache_attend_kernel_matches_plain(cuda, batch, heads, head_dim, t,
                                           q_dtype, mask_kind):
    q, slab = _slab_problem(cuda, batch, heads, head_dim, t, q_dtype)
    mask = _slab_mask(mask_kind, batch, t)
    before = int8_cache_attend.launches
    out = int8_cache_attend(q, *slab, mask)
    assert int8_cache_attend.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == q.shape
    # f32 from int8 codes, f32 scales and the same q widened: only the
    # order of the sums differs
    torch.testing.assert_close(out, _cache_attend_plain(q, *slab, mask),
                               rtol=1e-5, atol=1e-5)


def test_cache_attend_kernel_reads_a_slab_view_in_place(cuda):
    """The slot step's operands: a 768-wide slab cut to a 640-position
    span, rows 768 apart, read through the strides."""
    q, slab = _slab_problem(cuda, 8, 16, 64, 768, torch.bfloat16)
    view = [a[..., :640] for a in slab]
    assert not view[0].is_contiguous()
    mask = _slab_mask("per-row", 8, 640)
    before = int8_cache_attend.launches
    out = int8_cache_attend(q, *view, mask)
    assert int8_cache_attend.launches == before + 1
    torch.testing.assert_close(
        out, _cache_attend_plain(q, *(a.contiguous() for a in view), mask),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["t_off_tile", "d_off_tile",
                                  "misaligned", "strided_q",
                                  "misaligned_scale"])
def test_cache_attend_refuses_what_the_kernel_does_not_take(cuda, case):
    """use_pallas=True off the gate and operands the kernel cannot read
    in place raise on the card; nothing falls back to torch ops."""
    head_dim = 16 if case == "d_off_tile" else 32
    q, slab = _slab_problem(cuda, 2, 2, head_dim, 256, torch.float32)
    t = 256
    if case == "t_off_tile":
        slab, t = [a[..., :200] for a in slab], 200
    elif case == "misaligned":    # codes one byte off a 4-byte boundary
        slab = [a[..., 1:129] for a in slab]
        t = 128
    elif case == "strided_q":
        q = q.transpose(0, 2).contiguous().transpose(0, 2)
    elif case == "misaligned_scale":   # scales one float off 16 bytes
        slab = [a[..., 1:129] if a.dtype == torch.float32 else a[..., :128]
                for a in slab]
        t = 128
    before = int8_cache_attend.launches
    with pytest.raises(ValueError):
        int8_cache_attend(q, *slab, torch.zeros(t, device="cuda"),
                          use_pallas=True)
    assert int8_cache_attend.launches == before


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _paged_lengths_problem(gen, lengths, pb, ps, heads=16, head_dim=64,
                           dtype=torch.bfloat16):
    """The serving model's heads on a table of ``pb`` pages of ``ps``,
    each slot's live pages in logical order, rows padded with the
    scratch page."""
    table = torch.zeros((len(lengths), pb), dtype=torch.int32)
    nxt = 1
    for s, n in enumerate(lengths):
        for p in range(min(n // ps + 1, pb)):
            table[s, p] = nxt
            nxt += 1
    shape = (nxt, ps, heads, head_dim)
    k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = torch.randn((len(lengths), heads, head_dim), generator=gen,
                    device="cuda").to(dtype)
    return (q, k, v, table.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("ps", [16, 128])
def test_paged_attend_at_split_boundaries(cuda, ps):
    """K1's splits (whole pages of its plan): slots whose visible
    positions end one before, at and one after a split's end, and a
    length-0 slot beside a 4000-position one."""
    pb = 4000 // ps + 2
    pages, splits, _ = _paged_plan(6, 16, 64, pb, ps, _sms())
    assert splits > 1
    span = pages * ps
    lengths = [span - 2, span - 1, span, 0, 4000, 2 * span]
    args = _paged_lengths_problem(cuda, lengths, pb, ps)
    before = paged_attend.launches
    out = paged_attend(*args, page_size=ps)
    assert paged_attend.launches == before + 1
    torch.testing.assert_close(out, _paged_attend_plain(*args, ps),
                               rtol=1e-5, atol=1e-5)


#: every head width the JAX package's paged attends serve that K1 and K3
#: took no route for before (C4): the toy models' 8 and 16, bf16 rows of
#: 96, 160, 192 and 200 bytes, an odd width (plain 2-byte loads in bf16,
#: 4-byte copies in f32) and the widest two powers of two
C4_WIDTHS = [8, 16, 33, 48, 80, 96, 100, 512, 1024]


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["kv_f32", "kv_bf16"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
@pytest.mark.parametrize("head_dim", C4_WIDTHS)
def test_paged_attend_at_every_width(cuda, head_dim, q_dtype, kv_dtype):
    """128-token pages, one page a split: a length-0 slot, a page
    boundary and a 1100-position slot, sub-page stages past D = 128 in
    bf16 (64 in f32); two calls bit-equal."""
    q, k, v, table, lengths = _paged_lengths_problem(
        cuda, [0, 127, 1100], 10, 128, heads=2, head_dim=head_dim,
        dtype=kv_dtype)
    q = q.to(q_dtype)
    before = paged_attend.launches
    out = paged_attend(q, k, v, table, lengths, page_size=128)
    again = paged_attend(q, k, v, table, lengths, page_size=128)
    torch.cuda.synchronize()
    assert paged_attend.launches == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(
        out, _paged_attend_plain(q, k, v, table, lengths, 128),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("head_dim", C4_WIDTHS)
def test_paged_attend_int8_at_the_c4_widths(cuda, head_dim, q_dtype):
    """K3 at the widths off its old D % 32 == 0 rule (and 512, 1024):
    16- and 128-token pages, two calls bit-equal."""
    for ps, pb in ((16, 70), (128, 10)):
        args = _int8_paged_problem(cuda, head_dim, q_dtype,
                                   [0, ps - 1, 1100], pb, heads=2, ps=ps)
        before = paged_attend_int8.launches
        out = paged_attend_int8(*args[:-1], page_size=ps)
        again = paged_attend_int8(*args[:-1], page_size=ps)
        torch.cuda.synchronize()
        assert paged_attend_int8.launches == before + 2
        assert torch.equal(out, again)
        torch.testing.assert_close(out, _paged_attend_int8_plain(*args),
                                   rtol=1e-5, atol=1e-5)


def test_paged_attend_ignores_invisible_positions(cuda):
    """NaN rows on the scratch page and past each slot's length change no
    bit of K1's output at a padded width (D = 100 bf16, 8-byte copies)."""
    lengths = [0, 18, 31, 83]
    q, k, v, table, lengths_t = _paged_lengths_problem(
        cuda, lengths, 6, 16, heads=2, head_dim=100)
    clean = paged_attend(q, k, v, table, lengths_t, page_size=16)
    tab = table.cpu()
    for s, n in enumerate(lengths):
        last = int(tab[s, n // 16])
        k[last, n % 16 + 1:] = math.nan
        v[last, n % 16 + 1:] = math.nan
    k[0], v[0] = math.nan, math.nan
    poisoned = paged_attend(q, k, v, table, lengths_t, page_size=16)
    torch.cuda.synchronize()
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, clean)


def test_paged_attend_is_deterministic(cuda):
    """The live splits meet in split order in the slot's last block: two
    calls are bit-equal, at the smoke's lengths and at lopsided ones."""
    for lengths in ([0, 127, 128, 300, 511, 700, 1023, 1100],
                    [1100] + [0] * 7):
        args = _paged_lengths_problem(cuda, lengths, 10, 128)
        first = paged_attend(*args, page_size=128)
        second = paged_attend(*args, page_size=128)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        torch.testing.assert_close(first, _paged_attend_plain(*args, 128),
                                   rtol=1e-5, atol=1e-5)


def _split_mask(kind, batch, t):
    """A fully masked 128-position split in every row (positions 128 to
    255), or row 1 fully masked beside ragged lengths."""
    pos = torch.arange(t, device="cuda")
    if kind == "masked-split":
        visible = ((pos < 128) | (pos >= 256))[None, :].expand(batch, t)
    else:
        lengths = torch.arange(batch, device="cuda") * (t // batch) + 3
        visible = pos[None, :] <= lengths[:, None]
        visible[1] = False
    return torch.where(visible, 0.0, -1e30).float().contiguous()


@pytest.mark.parametrize("batch,heads,t,q_dtype,kind", [
    (2, 2, 128, torch.float32, "per-row"),           # one split
    (1, 1, 32896, torch.bfloat16, "per-row"),        # a ragged last split
    (8, 16, 768, torch.bfloat16, "masked-split"),
    (8, 16, 768, torch.float32, "masked-row"),
    (3, 4, 20480, torch.bfloat16, "masked-row"),     # several tiles a split
], ids=["one-split", "ragged-last-split", "masked-split", "masked-row",
        "masked-row-long"])
def test_cache_attend_splits(cuda, batch, heads, t, q_dtype, kind):
    splits, chunk = _attend_plan(batch, heads, t, _sms())
    if kind == "per-row" and t == 128:
        assert splits == 1
    if t == 32896:
        assert t % chunk and splits > 1
    q, slab = _slab_problem(cuda, batch, heads, 64, t, q_dtype)
    mask = (_slab_mask("per-row", batch, t) if kind == "per-row"
            else _split_mask(kind, batch, t))
    before = int8_cache_attend.launches
    out = int8_cache_attend(q, *slab, mask)
    assert int8_cache_attend.launches == before + 1
    torch.testing.assert_close(out, _cache_attend_plain(q, *slab, mask),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head_dim", [256, 512, 1024])
def test_cache_attend_wide_heads(cuda, head_dim):
    """Head widths past 128 stage fewer positions at a time (64, 32, 16)
    in a ring of two stages a split."""
    q, slab = _slab_problem(cuda, 2, 2, head_dim, 1024, torch.bfloat16)
    mask = _slab_mask("per-row", 2, 1024)
    torch.testing.assert_close(int8_cache_attend(q, *slab, mask),
                               _cache_attend_plain(q, *slab, mask),
                               rtol=1e-5, atol=1e-5)


def test_cache_attend_reads_rows_off_16_bytes(cuda):
    """A slab 772 positions wide cut to 768: code rows 4-byte but not
    16-byte aligned take the kernel's 4-byte copies."""
    q, slab = _slab_problem(cuda, 2, 4, 64, 772, torch.float32)
    view = [a[..., :768] for a in slab]
    assert view[0].stride(2) % 16
    mask = _slab_mask("per-row", 2, 768)
    torch.testing.assert_close(
        int8_cache_attend(q, *view, mask),
        _cache_attend_plain(q, *(a.contiguous() for a in view), mask),
        rtol=1e-5, atol=1e-5)


def test_cache_attend_is_deterministic(cuda):
    """The splits meet in split order in the (row, head)'s last block:
    two calls are bit-equal, on the slab and on a span view of it."""
    q, slab = _slab_problem(cuda, 8, 16, 64, 768, torch.bfloat16)
    for args in (slab, [a[..., :640] for a in slab]):
        mask = _slab_mask("per-row", 8, args[0].shape[-1])
        first = int8_cache_attend(q, *args, mask)
        second = int8_cache_attend(q, *args, mask)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_split_counters_reset_between_shapes(cuda):
    """K1, K4 and K2 share one stream's workspace and counters: calls of
    other shapes (and splits) in a row each find their counters at zero,
    repeat bit for bit, and leave the counters at zero."""
    paged = [_paged_lengths_problem(cuda, lengths, pb, ps)
             for lengths, pb, ps in (([0, 700, 1100, 5], 10, 128),
                                     ([4000, 0, 17], 252, 16))]
    slabs = [_slab_problem(cuda, b, h, 64, t, torch.bfloat16)
             for b, h, t in ((8, 16, 768), (2, 4, 4096))]
    masks = [_slab_mask("per-row", q.shape[0], slab[0].shape[-1])
             for q, slab in slabs]
    mat = _int8_problem(cuda, 8, 4096, 1024, torch.bfloat16)

    def calls():
        return [paged_attend(*paged[0], page_size=128),
                int8_cache_attend(slabs[0][0], *slabs[0][1], masks[0]),
                int8_matmul(*mat),
                paged_attend(*paged[1], page_size=16),
                int8_cache_attend(slabs[1][0], *slabs[1][1], masks[1])]

    first, second = calls(), calls()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    torch.testing.assert_close(first[0], _paged_attend_plain(*paged[0], 128),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(first[3], _paged_attend_plain(*paged[1], 16),
                               rtol=1e-5, atol=1e-5)
    for out, (q, slab), mask in zip((first[1], first[4]), slabs, masks):
        torch.testing.assert_close(out, _cache_attend_plain(q, *slab, mask),
                                   rtol=1e-5, atol=1e-5)
    stream = torch.cuda.current_stream().cuda_stream
    _, counters = _workspace._workspaces[(torch.cuda.current_device(),
                                          stream)]
    assert not counters.any()


def test_split_counters_reset_after_k3(cuda):
    """K3 shares the stream's workspace and counters with K1 and K4: a K3
    call, then a K1 and a K4 call on the same stream, each agrees with
    its plain version, and the counters are back at zero."""
    lengths = [0, 700, 1100, 5]
    k3 = _int8_paged_problem(cuda, 64, torch.bfloat16, lengths, 10,
                             heads=16, ps=128)
    k1 = _paged_lengths_problem(cuda, lengths, 10, 128)
    q, slab = _slab_problem(cuda, 8, 16, 64, 768, torch.bfloat16)
    mask = _slab_mask("per-row", 8, 768)
    outs = [paged_attend_int8(*k3[:-1], page_size=128),
            paged_attend(*k1, page_size=128),
            int8_cache_attend(q, *slab, mask)]
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], _paged_attend_int8_plain(*k3),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[1], _paged_attend_plain(*k1, 128),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[2], _cache_attend_plain(q, *slab, mask),
                               rtol=1e-5, atol=1e-5)
    stream = torch.cuda.current_stream().cuda_stream
    _, counters = _workspace._workspaces[(torch.cuda.current_device(),
                                          stream)]
    assert not counters.any()


def test_dense_int8_kv_decoder_on_the_card_matches_the_cpu(cuda):
    """The dense slab's int8-KV tier at a head width the gate admits: K4
    attends every block of every step on the card, and the greedy
    streams (f32) equal the decoder's on the CPU, where K4's plain
    version runs."""
    params = init_transformer_params(numpy.random.RandomState(0), 2, 128,
                                     4, 512, device="cpu")
    table = torch.randn((512, 128), generator=torch.Generator()
                        .manual_seed(1)) * 0.5
    prompts = [[(7 * i + j) % 512 for j in range(n)]
               for i, n in enumerate((9, 40, 3, 17))]
    streams = {}
    for device in ("cpu", "cuda"):
        dec = ContinuousDecoder(params, table, 4, slots=3, max_len=80,
                                n_tokens=8, quantize="int8-kv",
                                device=device)
        rids = [dec.submit(p) for p in prompts]
        before = int8_cache_attend.launches
        dec.drain_pipelined(4)
        launches = int8_cache_attend.launches - before
        streams[device] = [dec.results[r] for r in rids]
    assert launches == 2 * 4 * dec.dispatch_counts["chunk"]
    assert streams["cuda"] == streams["cpu"]


def test_attention_at_4096_with_head_dim_64_runs(cuda):
    """The JAX package runs plain XLA attention here (its flash rule
    wants head_dim % 128 == 0), so the port runs the plain version, no
    kernel; with 128-wide heads the same call launches K7 once."""
    q, k, v = (torch.randn((1, 4096, 2, 64), generator=cuda,
                           device="cuda") for _ in range(3))
    before = flash_attention_fwd.launches
    out = attention(q, k, v, causal=True)
    assert out.shape == q.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out, plain_attention(q, k, v, causal=True),
                               rtol=0, atol=0)
    assert flash_attention_fwd.launches == before
    q, k, v = (torch.randn((1, 4096, 1, 128), generator=cuda, device="cuda")
               for _ in range(3))
    out = attention(q, k, v, causal=True)
    assert flash_attention_fwd.launches == before + 1
    _flash_close(out, plain_attention(q, k, v, causal=True))


def test_attention_at_4096_with_head_dim_256_runs_k7(cuda):
    """The flash rule holds at 256-wide heads (a multiple of 128): the
    port's attention runs K7, one launch, where it used to raise."""
    q, k, v = _flash_inputs(cuda, 1, 4096, 4096, 2, 256, torch.bfloat16)
    before = flash_attention_fwd.launches
    out = attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    _flash_close(out, _flash_attention_fwd_plain(q, k, v, True)[0])


# -- K7, K8, K9: the flash-attention kernels ----------------------------------

def _flash_close(out, ref, grad=False):
    """chip_smoke.py's rule, row by row: every row (the last axis, one
    position's head_dim values for one head) within a share of its own
    norm, so late rows, ~sqrt(1/T) of the early ones, are held as tightly.
    f32: the same f32 math in another order and exp2 for exp -> 1e-5;
    bf16: both sides round the output and P or dS to bf16, and an
    element whose f32 value straddles a rounding boundary lands one step
    (up to 2^-7 of it) away -> 1e-2 for the forward, 2e-2 for the
    gradients, where a late key's (early query's) row is one or a few
    such terms. f32 gradients: 1e-4, the f32 route sums up to 8192
    terms a row in another order than the plain version and dS takes the
    difference dP - di, whose cancellation lifts the relative error of a
    small row. A row below 1e-2 of the median row's norm (the causal
    first query's dQ, zero in exact arithmetic) is held against that
    floor."""
    diff, ref = out.float() - ref.float(), ref.float()
    norms = ref.norm(dim=-1)
    rows = diff.norm(dim=-1) / norms.clamp_min(1e-2 * norms.median())
    tol = (1e-4 if grad else 1e-5) if out.dtype == torch.float32 \
        else 2e-2 if grad else 1e-2
    assert rows.max().item() <= tol
    assert diff.abs().max().item() <= tol * ref.abs().max().item()


def _flash_inputs(gen, batch, t_q, t_k, heads, dim, dtype):
    """q, k, v as the qkv projection hands them over: split views of one
    (B, T, 3 H D) tensor (t_q == t_k), else separate tensors."""
    if t_q == t_k:
        qkv = torch.randn((batch, t_q, 3 * heads * dim), generator=gen,
                          device="cuda").to(dtype)
        return [part.reshape(batch, t_q, heads, dim)
                for part in qkv.split(heads * dim, dim=-1)]
    return [torch.randn((batch, t, heads, dim), generator=gen,
                        device="cuda").to(dtype)
            for t in (t_q, t_k, t_k)]


#: (batch, t_q, t_k, heads, dim, causal): ragged T (not a multiple of the
#: 64 tiles or of 128), the serving prefill's 4096 and the training 8192,
#: a short query block against long keys; at width 128 the edges of the
#: wgmma kernels' tiles: one row past a 128 tile, one 128-query tile
#: against ragged keys, less than one tile
FLASH_CASES = [(2, 333, 333, 2, 128, True), (1, 1000, 1000, 3, 128, False),
               (1, 4096, 4096, 2, 128, True), (1, 4096, 4096, 1, 128, False),
               (1, 8192, 8192, 1, 128, True), (2, 300, 1000, 2, 128, False),
               (1, 4097, 4097, 1, 128, True), (1, 128, 4160, 2, 128, False),
               (3, 40, 40, 2, 128, True),
               (2, 333, 333, 1, 256, True), (1, 4096, 4096, 2, 256, True),
               (2, 300, 1000, 1, 256, False), (1, 500, 500, 2, 384, True),
               (1, 4096, 4096, 1, 384, False), (1, 200, 600, 1, 512, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "b%d_q%d_k%d_h%d_d%d_%s" % (
                             *c[:5], "causal" if c[5] else "full"))
def test_flash_forward_kernel_matches_plain(cuda, case, dtype):
    batch, t_q, t_k, heads, dim, causal = case
    q, k, v = _flash_inputs(cuda, batch, t_q, t_k, heads, dim, dtype)
    out, lse = flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = _flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    _flash_close(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "b%d_q%d_k%d_h%d_d%d_%s" % (
                             *c[:5], "causal" if c[5] else "full"))
def test_flash_backward_kernels_match_plain(cuda, case):
    batch, t_q, t_k, heads, dim, causal = case
    q, k, v = _flash_inputs(cuda, batch, t_q, t_k, heads, dim,
                            torch.bfloat16)
    do = torch.randn(q.shape, generator=cuda,
                     device="cuda").to(torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, causal)
    di = attn._row_dot(out, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di, causal)
    dq = flash_attention_dq(q, k, v, do, lse, di, causal)
    ref_dk, ref_dv = _flash_attention_dkv_plain(q, k, v, do, lse, di, causal)
    ref_dq = _flash_attention_dq_plain(q, k, v, do, lse, di, causal)
    torch.cuda.synchronize()
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        _flash_close(got, ref, grad=True)


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "b%d_q%d_k%d_h%d_d%d_%s" % (
                             *c[:5], "causal" if c[5] else "full"))
def test_flash_backward_f32_kernels_match_plain(cuda, case):
    """K8 and K9's f32 route (C11): f32 FMA with a chunk axis, P and dS
    unrounded, against the f32 plain versions at every case; each call
    counts one launch in ``launches`` and in ``launches_f32``."""
    batch, t_q, t_k, heads, dim, causal = case
    q, k, v = _flash_inputs(cuda, batch, t_q, t_k, heads, dim,
                            torch.float32)
    do = torch.randn(q.shape, generator=cuda, device="cuda")
    out, lse = flash_attention_fwd(q, k, v, causal)
    di = attn._row_dot(out, do)
    counts = (flash_attention_dkv.launches, flash_attention_dkv.launches_f32,
              flash_attention_dq.launches, flash_attention_dq.launches_f32)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di, causal)
    dq = flash_attention_dq(q, k, v, do, lse, di, causal)
    ref_dk, ref_dv = _flash_attention_dkv_plain(q, k, v, do, lse, di, causal)
    ref_dq = _flash_attention_dq_plain(q, k, v, do, lse, di, causal)
    torch.cuda.synchronize()
    assert (flash_attention_dkv.launches, flash_attention_dkv.launches_f32,
            flash_attention_dq.launches, flash_attention_dq.launches_f32) \
        == tuple(n + 1 for n in counts)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        _flash_close(got, ref, grad=True)


@pytest.mark.parametrize("shape", [(1, 8192, 4, 128), (1, 4096, 8, 256)],
                         ids=["8192x4x128", "4096x8x256"])
def test_flash_backward_f32_at_the_step_shapes(cuda, shape):
    """K8 and K9 f32 at C11's shape (1, 8192, 4, 128) causal and at
    (1, 4096, 8, 256): within 1e-4 of the plain versions row by row, and
    a planted fault (the last 64 positions' rows x 0.9) reads past the
    limit; bf16 operands still take the bf16 routes (launches_f32 does
    not move)."""
    q, k, v = _flash_inputs(cuda, *shape[:2], shape[1], *shape[2:],
                            torch.float32)
    do = torch.randn(q.shape, generator=cuda, device="cuda")
    out, lse = flash_attention_fwd(q, k, v, True)
    di = attn._row_dot(out, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di, True)
    dq = flash_attention_dq(q, k, v, do, lse, di, True)
    refs = (*_flash_attention_dkv_plain(q, k, v, do, lse, di, True),
            _flash_attention_dq_plain(q, k, v, do, lse, di, True))
    torch.cuda.synchronize()
    for got, ref in zip((dk, dv, dq), refs):
        _flash_close(got, ref, grad=True)
        planted = got.clone()
        planted[:, -64:] *= 0.9
        with pytest.raises(AssertionError):
            _flash_close(planted, ref, grad=True)
    f32 = (flash_attention_dkv.launches_f32, flash_attention_dq.launches_f32)
    b16 = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    out16, lse16 = flash_attention_fwd(*b16[:3], True)
    di16 = attn._row_dot(out16, b16[3])
    flash_attention_dkv(*b16, lse16, di16, True)
    flash_attention_dq(*b16, lse16, di16, True)
    torch.cuda.synchronize()
    assert (flash_attention_dkv.launches_f32,
            flash_attention_dq.launches_f32) == f32


@pytest.mark.parametrize("dim", [128, 256, 384])
def test_flash_reads_split_views_in_place(cuda, dim):
    """The kernels read the qkv projection's split views through their
    strides: the same results as on contiguous copies, bit for bit."""
    views = _flash_inputs(cuda, 1, 500, 500, 2, dim, torch.bfloat16)
    copies = [t.contiguous() for t in views]
    do = torch.randn(views[0].shape, generator=cuda,
                     device="cuda").to(torch.bfloat16)
    results = []
    for q, k, v in (views, copies):
        out, lse = flash_attention_fwd(q, k, v, True)
        di = attn._row_dot(out, do)
        results.append((out, *flash_attention_dkv(q, k, v, do, lse, di, True),
                        flash_attention_dq(q, k, v, do, lse, di, True)))
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_flash_backward_is_deterministic(cuda):
    """K8 and K9 sum every output element in one block in a fixed order
    (no atomics): two runs on the same inputs agree bit for bit, on the
    bf16 routes and on the f32 route."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _flash_inputs(cuda, 1, 4096, 4096, 4, 128, dtype)
        do = torch.randn(q.shape, generator=cuda, device="cuda").to(dtype)
        out, lse = flash_attention_fwd(q, k, v, True)
        di = attn._row_dot(out, do)
        runs = [(*flash_attention_dkv(q, k, v, do, lse, di, True),
                 flash_attention_dq(q, k, v, do, lse, di, True))
                for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def test_flash_autograd_on_the_card_matches_the_cpu(cuda):
    """The custom VJP on the card (K7, then K8 and K9, one launch each)
    against the same function on the CPU (the plain versions)."""
    shape = (1, 700, 2, 128)
    base = [torch.randn(shape, generator=cuda, device="cuda").to(
        torch.bfloat16) for _ in range(4)]
    counts = (flash_attention_fwd.launches, flash_attention_dkv.launches,
              flash_attention_dq.launches)
    grads = {}
    for device in ("cuda", "cpu"):
        leaves = [t.detach().to(device).requires_grad_(True)
                  for t in base[:3]]
        out = flash_attention(*leaves, True)
        out.backward(base[3].to(device))
        grads[device] = [out] + [leaf.grad for leaf in leaves]
    assert (flash_attention_fwd.launches, flash_attention_dkv.launches,
            flash_attention_dq.launches) \
        == tuple(n + 1 for n in counts)
    for i, (got, ref) in enumerate(zip(grads["cuda"], grads["cpu"])):
        _flash_close(got.detach().cpu(), ref.detach(), grad=i > 0)


@pytest.mark.parametrize("case", ["f16", "mixed_backward", "head_64",
                                  "head_strided", "misaligned", "devices",
                                  "causal_lengths",
                                  "attention_causal_lengths"])
def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda, case):
    """``attention_causal_lengths``: where the flash rule holds on the
    card, ``attention`` hands a causal Tq != Tk call to the kernels, which
    raise (their mask is key <= query)."""
    q, k, v = _flash_inputs(cuda, 1, 64, 64, 2, 128, torch.bfloat16)
    lse = torch.zeros((1, 2, 64), device="cuda")
    calls = {
        "f16": lambda: flash_attention_fwd(*(t.half() for t in (q, k, v))),
        "mixed_backward": lambda: flash_attention_dq(
            q.float(), k, v, q.float(), lse, lse),
        "head_64": lambda: flash_attention_fwd(q[..., :64], k[..., :64],
                                               v[..., :64]),
        "head_strided": lambda: flash_attention_fwd(
            q.transpose(2, 3).contiguous().transpose(2, 3), k, v),
        "misaligned": lambda: flash_attention_fwd(
            *(torch.zeros((1, 64, 2, 130), device="cuda",
                          dtype=torch.bfloat16)[..., 1:129]
              for _ in range(3))),
        "devices": lambda: flash_attention_fwd(q, k.cpu(), v),
        "causal_lengths": lambda: flash_attention_fwd(q[:, :32], k, v, True),
        "attention_causal_lengths": lambda: attention(
            *_flash_inputs(cuda, 1, 4096, 8192, 1, 128, torch.bfloat16),
            causal=True),
    }
    with pytest.raises((ValueError, TypeError)):
        calls[case]()


def test_flash_refused_launch_raises(cuda):
    """A launch the card refuses (a grid of 65536 rows, past the 65535
    of a grid's third axis) raises instead of returning unwritten
    outputs, and counts no launch."""
    q = torch.zeros((65536, 1, 1, 128), device="cuda",
                    dtype=torch.bfloat16)
    stats = torch.zeros((65536, 1, 1), device="cuda")
    counts = (flash_attention_fwd.launches, flash_attention_dkv.launches,
              flash_attention_dq.launches)
    for call in (lambda: flash_attention_fwd(q, q, q),
                 lambda: flash_attention_dkv(q, q, q, q, stats, stats),
                 lambda: flash_attention_dq(q, q, q, q, stats, stats)):
        with pytest.raises(RuntimeError, match="launch failed"):
            call()
    assert (flash_attention_fwd.launches, flash_attention_dkv.launches,
            flash_attention_dq.launches) == counts


# -- K5 / K6: the training path's GEMM kernels --------------------------------

#: odd shapes: ragged edges on every axis, a 1 x 1 x 1 product, the
#: digits MLP's head (k 784, n 10)
GEMM_SHAPES = [(100, 80, 64), (1, 1, 1), (100, 784, 10), (130, 70, 50),
               (257, 33, 129)]


def _gemm_operands(gen, shape, dtype, layout):
    """(a, b) with ``layout`` "rr" (both row-major), "cr" (a a transposed
    view, x.T), "rc" (b a transposed view, w.T) or "strided" (both
    sliced along both axes: the wrapper copies them)."""
    m, k, n = shape
    a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    b = (torch.randn((k, n), generator=gen, device="cuda")
         / math.sqrt(k)).to(dtype)
    if layout == "cr":
        a = a.t().contiguous().t()
    elif layout == "rc":
        b = b.t().contiguous().t()
    elif layout == "strided":
        a = torch.randn((2 * m, 2 * k), generator=gen,
                        device="cuda").to(dtype)[::2, ::2]
    return a, b


def _gemm_close(out, ref):
    """f32 sums of up to 784 terms in another order (~1e-6 of outputs of
    order 1); a bf16 output may differ by one rounding (2^-8)."""
    tol = 1e-2 if out.dtype == torch.bfloat16 else 1e-4
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item())


@pytest.mark.parametrize("layout", ["rr", "cr", "rc", "strided"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", GEMM_SHAPES,
                         ids=["x".join(map(str, s)) for s in GEMM_SHAPES])
def test_blocked_matmul_kernel_matches_plain(cuda, shape, dtype, layout):
    a, b = _gemm_operands(cuda, shape, dtype, layout)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = blocked_matmul.launches
        out = blocked_matmul(a, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert blocked_matmul.launches == before + 1
        assert out.dtype == out_dtype and out.shape == (shape[0], shape[2])
        _gemm_close(out, _blocked_matmul_plain(a, b, out_dtype))


@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_dense_epilogue_kernel_matches_plain(cuda, dtype, activation):
    for shape, layout in zip(GEMM_SHAPES, ("rr", "cr", "rc", "strided",
                                           "rr")):
        a, b = _gemm_operands(cuda, shape, dtype, layout)
        bias = torch.randn(shape[2], generator=cuda, device="cuda")
        before = dense_epilogue.launches
        out = dense_epilogue(a, b, bias, activation)
        torch.cuda.synchronize()
        assert dense_epilogue.launches == before + 1
        _gemm_close(out, _dense_epilogue_plain(a, b, bias, activation))


@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
@pytest.mark.parametrize("shape", [(512, 784, 640), (600, 520, 530),
                                   (600, 520, 544)],
                         ids=["k784", "ragged", "ragged_m"])
def test_dense_epilogue_bf16_route_matches_plain(cuda, shape, activation):
    """K6's bf16 operands on K5's TMA and wgmma mainloop (k = 784 is
    12.25 K tiles; 600 x 520 x 530 is ragged on every axis, and its b,
    1060-byte rows, is the one operand the wrapper copies; its output
    rows, 2120 bytes, take the direct stores, 544's the TMA stores,
    clipped at row 600), within 1e-4 of the largest output."""
    m, k, n = shape
    a = torch.randn((m, k), generator=cuda, device="cuda").to(torch.bfloat16)
    b = (torch.randn((k, n), generator=cuda, device="cuda")
         / math.sqrt(k)).to(torch.bfloat16)
    bias = torch.randn(n, generator=cuda, device="cuda")
    assert gemm._tma_layout(a)[0].data_ptr() == a.data_ptr()
    copied = gemm._tma_layout(b)[0].data_ptr() != b.data_ptr()
    assert copied == (n % 8 != 0)
    before = dense_epilogue.launches
    out = dense_epilogue(a, b, bias, activation)
    torch.cuda.synchronize()
    assert dense_epilogue.launches == before + 1
    ref = _dense_epilogue_plain(a, b, bias, activation)
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_dense_epilogue_at_alexnet_head(cuda, dtype):
    """K6 at AlexNet's softmax head with the knobs on, minibatch 512:
    (512, 4096) x (4096, 1000), N = 1000 (not a multiple of the 128-wide
    tiles), within 1e-4 of the largest output."""
    a = torch.randn((512, 4096), generator=cuda, device="cuda").to(dtype)
    b = (torch.randn((4096, 1000), generator=cuda, device="cuda")
         / 64.0).to(dtype)
    bias = torch.randn(1000, generator=cuda, device="cuda")
    for activation in ("linear", "relu"):
        before = dense_epilogue.launches
        out = dense_epilogue(a, b, bias, activation)
        torch.cuda.synchronize()
        assert dense_epilogue.launches == before + 1
        ref = _dense_epilogue_plain(a, b, bias, activation)
        err = (out - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item()


def test_conv2d_level2_is_full_f32_on_the_card(cuda, monkeypatch):
    """With cuDNN's TF32 flag at torch's default (on), a level-2 conv and
    its gradients on the card stay within 1e-5 of the largest element of
    a float64 reference (TF32's 10-bit mantissa would miss it by ~100x),
    and the flag is left as it was."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x = torch.randn((4, 67, 67, 3), generator=cuda, device="cuda")
    w = torch.randn((11, 11, 3, 64), generator=cuda, device="cuda") / 20.0
    g = torch.randn((4, 17, 17, 64), generator=cuda, device="cuda")
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = gemm.conv2d(tx, tw, (4, 4), "SAME", precision_level=2)
    out.backward(g)
    assert torch.backends.cudnn.allow_tf32
    dx = x.double().cpu().requires_grad_(True)
    dw = w.double().cpu().requires_grad_(True)
    top, bottom = gemm.same_padding(67, 11, 4)
    ref = torch.nn.functional.conv2d(
        torch.nn.functional.pad(dx.permute(0, 3, 1, 2),
                                (top, bottom, top, bottom)),
        dw.permute(3, 2, 0, 1), stride=4).permute(0, 2, 3, 1)
    ref.backward(g.double().cpu())
    for got, want in ((out, ref), (tx.grad, dx.grad), (tw.grad, dw.grad)):
        err = (got.detach().double().cpu() - want.detach()).abs().max()
        assert err.item() <= 1e-5 * want.detach().abs().max().item()


@pytest.mark.parametrize("level", [0, 2])
def test_dense_backward_on_the_card_matches_the_plain_backward(
        cuda, monkeypatch, level):
    """The kernel route (K6 forward, K5 for grad_x and grad_w) on the
    card against the same autograd.Function on the CPU, where both
    products run their plain versions; level 0 rounds grad_w and grad_x
    to bf16 (one rounding may differ by an ulp)."""
    monkeypatch.setattr(root.common.engine, "use_pallas", True)
    monkeypatch.setattr(root.common.engine, "pallas_epilogue", True)
    monkeypatch.setattr(root.common.engine, "precision_level", level)
    rng = numpy.random.RandomState(level)
    x = rng.randn(600, 520).astype(numpy.float32)
    w = (rng.randn(520, 530) / 20).astype(numpy.float32)
    b = rng.randn(530).astype(numpy.float32)
    g = rng.randn(600, 530).astype(numpy.float32)
    grads = {}
    for device in ("cuda", "cpu"):
        if device == "cpu":
            monkeypatch.setattr(gemm, "_kernel_eligible",
                                lambda a, bb: True)
        tx, tw, tb = (torch.from_numpy(v).to(device).requires_grad_()
                      for v in (x, w, b))
        before = (blocked_matmul.launches, dense_epilogue.launches)
        y = gemm.dense_layer(tx, tw, tb, activation="tanh")
        y.backward(torch.from_numpy(g).to(device))
        if device == "cuda":
            torch.cuda.synchronize()
            assert (blocked_matmul.launches - before[0],
                    dense_epilogue.launches - before[1]) == (2, 1)
        grads[device] = [t.cpu() for t in (y.detach(), tx.grad, tw.grad,
                                           tb.grad)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _gemm_close(got.to(torch.bfloat16) if level == 0 else got,
                    want)


def _bf16_operands(gen, case):
    """K5's bf16 route: the training path's weight gradient x.T @ err
    (A m-contiguous, B n-contiguous) and grad_x err @ w.T (B
    k-contiguous), both read in place through TMA; a ragged M with a
    bf16 output; and two operands TMA refuses, which the wrapper copies:
    k = 100 (a 200-byte row is no multiple of 16 bytes) and a view that
    starts 2 bytes past an aligned base."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if case == "weight_grad":
        return rand(4096, 784).to(torch.bfloat16).t(), \
            (rand(4096, 4096) / 64).to(torch.bfloat16)
    if case == "grad_x":
        return rand(4096, 4096).to(torch.bfloat16), \
            (rand(784, 4096) / 64).to(torch.bfloat16).t()
    if case == "ragged_m":
        return rand(130, 512).to(torch.bfloat16), \
            (rand(512, 320) / 23).to(torch.bfloat16)
    if case == "k100":
        return rand(200, 100).to(torch.bfloat16), \
            (rand(100, 300) / 10).to(torch.bfloat16)
    a = rand(256, 257).to(torch.bfloat16)[:, 1:]
    return a, (rand(256, 192) / 16).to(torch.bfloat16)


@pytest.mark.parametrize("case", ["weight_grad", "grad_x", "ragged_m",
                                  "k100", "offset_view"])
def test_blocked_matmul_bf16_route_matches_plain(cuda, case):
    a, b = _bf16_operands(cuda, case)
    if case == "k100" or case == "offset_view":
        assert gemm._tma_layout(a)[0].data_ptr() != a.data_ptr()
    else:
        assert gemm._tma_layout(a)[0].data_ptr() == a.data_ptr()
        assert gemm._tma_layout(b)[0].data_ptr() == b.data_ptr()
    for out_dtype in (torch.float32, torch.bfloat16):
        before = blocked_matmul.launches
        out = blocked_matmul(a, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert blocked_matmul.launches == before + 1
        assert out.dtype == out_dtype
        assert out.shape == (a.shape[0], b.shape[1])
        _gemm_close(out, _blocked_matmul_plain(a, b, out_dtype))


def test_gemm_gate_on_the_card(cuda):
    big = torch.ones((512, 512), device="cuda")
    assert gemm._kernel_eligible(big, big)
    assert not gemm._kernel_eligible(big[:511], big)
    assert not gemm._kernel_eligible(big, big[:, :511])
    assert not gemm._kernel_eligible(big.cpu(), big.cpu())
    with pytest.raises(ValueError):
        blocked_matmul(big, big.cpu())


#: C5: head widths past 1024 the JAX package's attends serve (K4's a
#: multiple of 32), up to MAX_HEAD_DIM
C5_WIDTHS = [1025, 1536, 2048, 4096, MAX_HEAD_DIM]
C5_K4_WIDTHS = [1056, 1536, 2048, 4096, MAX_HEAD_DIM]


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["kv_f32", "kv_bf16"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
@pytest.mark.parametrize("head_dim", C5_WIDTHS)
def test_paged_attend_past_1024(cuda, head_dim, q_dtype, kv_dtype):
    """C5: K1's accumulator in shared memory, stages of one to a few
    positions, at 128- and 16-token pages: a length-0 slot, a page
    boundary and a 1100-position slot; two calls bit-equal."""
    for ps, pb in ((128, 10), (16, 70)):
        q, k, v, table, lengths = _paged_lengths_problem(
            cuda, [0, ps - 1, 1100], pb, ps, heads=2, head_dim=head_dim,
            dtype=kv_dtype)
        q = q.to(q_dtype)
        out = paged_attend(q, k, v, table, lengths, page_size=ps)
        again = paged_attend(q, k, v, table, lengths, page_size=ps)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        torch.testing.assert_close(
            out, _paged_attend_plain(q, k, v, table, lengths, ps),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("head_dim", C5_WIDTHS)
def test_paged_attend_int8_past_1024(cuda, head_dim, q_dtype):
    """C5: K3's wide tile (8 positions a stage, the accumulator in shared
    memory, one buffer where two stages do not fit) at 8-, 16- and
    128-token pages (4- and 8-byte copies); two calls bit-equal."""
    for ps, pb in ((8, 140), (16, 70), (128, 10)):
        args = _int8_paged_problem(cuda, head_dim, q_dtype,
                                   [0, ps - 1, 1100], pb, heads=2, ps=ps)
        out = paged_attend_int8(*args[:-1], page_size=ps)
        again = paged_attend_int8(*args[:-1], page_size=ps)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        torch.testing.assert_close(out, _paged_attend_int8_plain(*args),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("head_dim", C5_K4_WIDTHS)
def test_cache_attend_past_1024(cuda, head_dim, q_dtype):
    """C5: K4's wide tile at 1024 positions (8 splits of 128) and on a
    span view of a wider slab (4-byte copies); two calls bit-equal."""
    q, slab = _slab_problem(cuda, 2, 2, head_dim, 1028, q_dtype)
    view = [a[..., :1024] for a in slab]
    mask = _slab_mask("per-row", 2, 1024)
    out = int8_cache_attend(q, *view, mask)
    again = int8_cache_attend(q, *view, mask)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(
        out, _cache_attend_plain(q, *(a.contiguous() for a in view), mask),
        rtol=1e-5, atol=1e-5)
    q, slab = _slab_problem(cuda, 2, 2, head_dim, 1024, q_dtype)
    torch.testing.assert_close(int8_cache_attend(q, *slab, mask),
                               _cache_attend_plain(q, *slab, mask),
                               rtol=1e-5, atol=1e-5)


#: C6: head widths past MAX_HEAD_DIM, the wide path (K4's multiples of 32)
C6_WIDTHS = [MAX_HEAD_DIM + 8, 12288, 16384]
C6_K4_WIDTHS = [MAX_HEAD_DIM + 32, 12288, 16384]


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["kv_f32", "kv_bf16"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
@pytest.mark.parametrize("head_dim", C6_WIDTHS)
def test_paged_attend_past_8192(cuda, head_dim, q_dtype, kv_dtype):
    """C6: K1's wide path (q, K and V from global memory, the split's sums
    in its workspace row) at 128- and 16-token pages: a length-0 slot, a
    page boundary and a 1100-position slot; two calls bit-equal."""
    for ps, pb in ((128, 10), (16, 70)):
        q, k, v, table, lengths = _paged_lengths_problem(
            cuda, [0, ps - 1, 1100], pb, ps, heads=2, head_dim=head_dim,
            dtype=kv_dtype)
        q = q.to(q_dtype)
        before = paged_attend.launches
        out = paged_attend(q, k, v, table, lengths, page_size=ps)
        again = paged_attend(q, k, v, table, lengths, page_size=ps)
        torch.cuda.synchronize()
        assert paged_attend.launches == before + 2
        assert torch.equal(out, again)
        torch.testing.assert_close(
            out, _paged_attend_plain(q, k, v, table, lengths, ps),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("head_dim", C6_WIDTHS)
def test_paged_attend_int8_past_8192(cuda, head_dim, q_dtype):
    """C6: K3's wide path at 8-, 16- and 128-token pages; two calls
    bit-equal."""
    for ps, pb in ((8, 140), (16, 70), (128, 10)):
        args = _int8_paged_problem(cuda, head_dim, q_dtype,
                                   [0, ps - 1, 1100], pb, heads=2, ps=ps)
        out = paged_attend_int8(*args[:-1], page_size=ps)
        again = paged_attend_int8(*args[:-1], page_size=ps)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        torch.testing.assert_close(out, _paged_attend_int8_plain(*args),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("head_dim", C6_K4_WIDTHS)
def test_cache_attend_past_8192(cuda, head_dim, q_dtype):
    """C6: K4's wide path at 1024 positions (8 splits of 128) on a span
    view of a wider slab, and at one split; two calls bit-equal."""
    q, slab = _slab_problem(cuda, 2, 2, head_dim, 1028, q_dtype)
    view = [a[..., :1024] for a in slab]
    mask = _slab_mask("per-row", 2, 1024)
    out = int8_cache_attend(q, *view, mask)
    again = int8_cache_attend(q, *view, mask)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(
        out, _cache_attend_plain(q, *(a.contiguous() for a in view), mask),
        rtol=1e-5, atol=1e-5)
    q, slab = _slab_problem(cuda, 1, 1, head_dim, 128, q_dtype)
    mask = _slab_mask("per-row", 1, 128)
    torch.testing.assert_close(int8_cache_attend(q, *slab, mask),
                               _cache_attend_plain(q, *slab, mask),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_paged_restore_on_the_card(cuda, quantized):
    """The breaker's restore on a CUDA pool: shadows captured from one
    pool copy into another's pages, bit-equal, every leaf; the pages not
    restored keep their bytes."""
    src = kv_pool.init_paged_state(2, 9, 16, 4, 64, 100, 3,
                                   quantized=quantized, device="cuda")
    for name in kv_pool.PAGED_KV_LEAVES:
        if name in src:
            val = torch.randn(src[name].shape, generator=cuda,
                              device="cuda") * 50
            src[name].copy_(val.to(src[name].dtype))
    shadows = kv_pool._shadow_pages(src, [2, 5, 7])
    dst = kv_pool.init_paged_state(2, 9, 16, 4, 64, 100, 3,
                                   quantized=quantized, device="cuda")
    before = {name: dst[name].clone() for name in kv_pool.PAGED_KV_LEAVES
              if name in dst}
    values = kv_pool._stack_shadow(shadows, [2, 5, 7])
    kv_pool._paged_restore(dst, [8, 1, 4], values)
    torch.cuda.synchronize()
    for name in before:
        for old, new in ((2, 8), (5, 1), (7, 4)):
            assert torch.equal(dst[name][:, new], src[name][:, old])
            assert torch.equal(dst[name][:, new].cpu(),
                               shadows[old][name])
        for page in (0, 2, 3, 5, 6, 7):
            assert torch.equal(dst[name][:, page], before[name][:, page])


def _graph_mlp(knobs, data, labels, monkeypatch):
    """The wide MLP (784 -> 4096 tanh -> 10, minibatch 4096) in graph
    mode at level 2 on the card, one epoch, the kernel knobs set."""
    from veles_tpu_torch.core import prng
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.mlp import MLPWorkflow
    for key, value in (("use_pallas", knobs), ("pallas_epilogue", knobs),
                       ("precision_level", 2)):
        monkeypatch.setattr(root.common.engine, key, value, raising=False)
    prng.get("default").seed(1234)
    prng.get("loader").seed(1234)
    wf = MLPWorkflow(DummyLauncher(), layers=(4096, 10), device="cuda",
                     loader_kwargs=dict(data=data, labels=labels,
                                        class_lengths=[0, 4096, 8192],
                                        minibatch_size=4096,
                                        normalization_type="linear"),
                     learning_rate=0.03, max_epochs=1, fused=False)
    errors = []
    run = wf.evaluator.run

    def recorded():
        run()
        errors.append(int(wf.evaluator.n_err.data))

    wf.evaluator.run = recorded
    wf.initialize()
    wf.run()
    return wf, errors


def test_graph_mode_wide_mlp_runs_k5(cuda, monkeypatch):
    """Graph mode's dense products run K5 with the knobs on: the hidden
    layer's forward on each of the 3 minibatches and its weight gradient
    and error product on each of the 2 train ones (7 launches); the
    result equals the knobs-off run's within the training agreement's
    limits (n_err within 2 a minibatch, weights within 1e-4)."""
    rng = numpy.random.RandomState(0)
    data = rng.rand(12288, 784).astype(numpy.float32)
    labels = rng.randint(0, 10, 12288).astype(numpy.int32)
    before = blocked_matmul.launches
    on, errors_on = _graph_mlp(True, data, labels, monkeypatch)
    assert blocked_matmul.launches - before == 3 + 2 * 2
    assert on.fused_tick is None and on.sweep_unit is None
    before = blocked_matmul.launches
    off, errors_off = _graph_mlp(False, data, labels, monkeypatch)
    assert blocked_matmul.launches == before
    assert len(errors_on) == len(errors_off) == 3
    assert max(abs(a - b) for a, b in zip(errors_on, errors_off)) <= 2
    for fa, fb in zip(on.forwards, off.forwards):
        for name in ("weights", "bias"):
            a, b = getattr(fa, name).data, getattr(fb, name).data
            assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_gd_self_attention_step_against_its_plain_route(cuda,
                                                       monkeypatch):
    """One GDSelfAttention step at (1, 4096, 4, 128), level 0: autograd
    of the block on the flash route (K7 recomputed, K8 and K9) against
    the same step on the plain attention route; every returned tensor
    within 2e-2 of its largest element (the flash route rounds P and dS
    to bf16, as the long-context agreement allows)."""
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.nn.attention import GDSelfAttention, SelfAttention
    monkeypatch.setattr(root.common.engine, "precision_level", 0,
                        raising=False)
    embed, heads = 512, 4
    gen = cuda
    fwd = SelfAttention(DummyWorkflow(), heads=heads, causal=True,
                        residual=True)
    gd = GDSelfAttention(DummyWorkflow(), learning_rate=0.01,
                         gradient_moment=0.9)
    gd.forward_unit = fwd

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = rand(1, 4096, embed)
    params = [rand(embed, 3 * embed, scale=embed ** -0.5),
              rand(3 * embed, scale=0.1),
              rand(embed, embed, scale=embed ** -0.5), rand(embed,
                                                            scale=0.1)]
    err = rand(1, 4096, embed, scale=1e-3)
    velocities = [torch.zeros_like(p) for p in params]
    hyper = torch.tensor([0.01, 0.01, 0.0, 0.0, 0.9, 0.9, 0.999, 1e-8],
                         device="cuda")
    launches = (flash_attention_fwd.launches, flash_attention_dkv.launches,
                flash_attention_dq.launches)
    flash = gd.compute(err, x, *params, *velocities, hyper)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches - launches[0],
            flash_attention_dkv.launches - launches[1],
            flash_attention_dq.launches - launches[2]) == (1, 1, 1)
    monkeypatch.setattr(attn, "uses_flash", lambda *a: False)
    plain = gd.compute(err, x, *params, *velocities, hyper)
    assert flash_attention_fwd.launches - launches[0] == 1
    for a, b in zip(flash, plain):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 2e-2 * b.abs().max()


NORMALIZER_CASES = ["none", "mean_disp", "linear", "range_linear", "exp",
                    "pointwise", "internal_mean", "external_mean"]


@pytest.mark.parametrize("name", NORMALIZER_CASES)
def test_normalizer_on_the_card_matches_the_cpu(cuda, name):
    """``analyze`` on a CUDA tensor (the loader's train split lives on the
    card) and ``apply_state`` there against the same on the CPU: the
    state and the output within 1e-5 of their largest element."""
    from veles_tpu_torch.loader.normalization import (make_normalizer,
                                                      state_tensors)
    rng = numpy.random.RandomState(2)
    data = rng.rand(8192, 784).astype(numpy.float32)
    kwargs = ({"mean_source": rng.rand(784).astype(numpy.float32)}
              if name == "external_mean" else {})
    results = []
    for device in ("cuda", "cpu"):
        norm = make_normalizer(name, **kwargs)
        batch = torch.from_numpy(data).to(device)
        if not norm.STATELESS:
            norm.analyze(batch)
        state = norm.jit_state()
        out = norm.apply_state(batch, state_tensors(state, device))
        results.append((state, out.cpu()))
    (state_c, out_c), (state_h, out_h) = results
    assert sorted(state_c) == sorted(state_h)
    for key, value in state_h.items():
        got = torch.as_tensor(state_c[key]).cpu().double()
        want = torch.as_tensor(value).double()
        assert (got - want).abs().max() <= 1e-5 * max(
            want.abs().max().item(), 1e-30)
    assert torch.isfinite(out_c).all()
    assert (out_c - out_h).abs().max() <= 1e-5 * out_h.abs().max()


def test_mse_fused_minibatch_on_the_card_matches_the_cpu(cuda,
                                                         monkeypatch):
    """One MSE train step of the fused tick with the knobs on (the wide
    MLP regressed: 784 -> 4096 tanh -> 10, minibatch 4096, f32) on the
    card, which launches K6 for the hidden layer's forward and K5 for its
    weight gradient, against the same step on the CPU (plain versions):
    the loss within 1e-5 relative, every new leaf within 1e-4 of its
    largest element."""
    from veles_tpu_torch.parallel import fused
    for key, value in (("use_pallas", True), ("pallas_epilogue", True),
                       ("precision_level", 2)):
        monkeypatch.setattr(root.common.engine, key, value, raising=False)
    rng = numpy.random.RandomState(3)
    data = rng.rand(4096, 784).astype(numpy.float32)
    targets = numpy.eye(10, dtype=numpy.float32)[rng.randint(0, 10, 4096)]
    widths, fan_in, host = (4096, 10), 784, []
    for width in widths:
        bound = fan_in ** -0.5
        host.append({k: rng.uniform(-bound, bound, s).astype(numpy.float32)
                     for k, s in (("w", (fan_in, width)), ("b", (width,)))})
        fan_in = width
    specs = [{"kind": "dense", "activation": act, "leaves": fused._WB_LEAVES,
              "has_params": True, "solver": "momentum"}
             for act in ("tanh", "linear")]
    # (lr, lr_bias, l2, l1, moment, beta1, beta2, eps): GradientDescent's
    # _hyper at lr 0.03, moment 0.9
    hyper = torch.tensor([0.03, 0.03, 0.0, 0.0, 0.9, 0.9, 0.999, 1e-8])
    results = []
    for device in ("cuda", "cpu"):
        train_step = fused.build_tick(specs, loss_kind="mse")[0]
        params = [{"p": {k: torch.from_numpy(v).to(device)
                         for k, v in layer.items()},
                   "v": {k: torch.zeros(v.shape, device=device)
                         for k, v in layer.items()}} for layer in host]
        launches = (dense_epilogue.launches, blocked_matmul.launches)
        new, (loss, n_err) = train_step(
            params, [hyper.to(device)] * 2, {},
            torch.from_numpy(data).to(device),
            torch.from_numpy(targets).to(device),
            torch.arange(4096, device=device), 4096.0)
        if device == "cuda":
            torch.cuda.synchronize()
        results.append((float(loss), [t.cpu() for p in new
                                      for t in p["p"].values()],
                        (dense_epilogue.launches - launches[0],
                         blocked_matmul.launches - launches[1])))
    (loss_c, leaves_c, launched_c), (loss_h, leaves_h, launched_h) = results
    assert launched_c == (1, 1) and launched_h == (0, 0)
    assert abs(loss_c - loss_h) <= 1e-5 * abs(loss_h)
    for a, b in zip(leaves_c, leaves_h):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def _tensors_of(obj, seen=None):
    """Every tensor reachable from a port object (the snapshot's walk)."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        return [obj]
    if id(obj) in seen or isinstance(obj, (str, bytes, numpy.ndarray)):
        return []
    seen.add(id(obj))
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors_of(v, seen)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors_of(v, seen)]
    if hasattr(obj, "__dict__") and type(obj).__module__.startswith(
            "veles_tpu_torch"):
        return _tensors_of(vars(obj), seen)
    return []


def test_snapshot_of_a_card_workflow_loads_on_either_device(cuda,
                                                             tmp_path):
    """A workflow trained on the card snapshots with every tensor on the
    host (the mean_disp normalizer's statistics, which no Pickleable
    holds, too) and resumes on the device ``import_`` is given: on the
    CPU when asked, on the card by default, where it trains on."""
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.mlp import MLPWorkflow
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    rng = numpy.random.RandomState(4)
    wf = MLPWorkflow(DummyLauncher(), layers=(32, 10), device="cuda",
                     loader_kwargs=dict(
                         data=rng.rand(600, 64).astype(numpy.float32),
                         labels=rng.randint(0, 10, 600).astype(numpy.int32),
                         class_lengths=[0, 100, 500], minibatch_size=100,
                         normalization_type="mean_disp"),
                     gradient_moment=0.9, max_epochs=1)
    wf.initialize()
    wf.run()
    assert any(t.is_cuda for t in _tensors_of(wf.loader.normalizer))
    snap = SnapshotterToFile(wf, directory=str(tmp_path), prefix="card",
                             interval=1, time_interval=0)
    snap.export()
    host = SnapshotterToFile.import_(snap.destination, device="cpu")
    tensors = _tensors_of(host)
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    assert host.device == torch.device("cpu")
    assert torch.equal(host.gds[0]._velocity_w.data,
                       wf.gds[0]._velocity_w.data.cpu())
    card = SnapshotterToFile.import_(snap.destination)
    assert all(t.is_cuda for t in _tensors_of(card))
    card.workflow = DummyLauncher()
    card.decision.max_epochs = 2
    card.decision.complete.unset()
    card.decision.train_ended.unset()
    card.initialize()
    card.run()
    assert card.decision.epochs_done == 2
    assert card.forwards[0].weights.data.is_cuda


# -- the autotuner's candidates and routes --------------------------------------

#: the wide MLP's K5/K6 products and AlexNet's head, (m, k, n)
TUNED_SHAPES = [(784, 4096, 4096), (4096, 784, 4096), (512, 4096, 1000),
                (100, 784, 10), (257, 33, 129)]


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("layout", ["rr", "cr", "rc"])
@pytest.mark.parametrize("shape", TUNED_SHAPES,
                         ids=["x".join(map(str, s)) for s in TUNED_SHAPES])
def test_blocked_matmul_at_both_tile_widths(cuda, shape, layout, bn):
    """K5's bf16 route at the width the autotuner names (a B box that
    disagreed with the kernel's BN would fill tiles wrongly, silently),
    within the K5 tolerance of its plain version."""
    a, b = _gemm_operands(cuda, shape, torch.bfloat16, layout)
    before = blocked_matmul.launches
    out = blocked_matmul(a, b, out_dtype=torch.float32, bn=bn)
    torch.cuda.synchronize()
    assert blocked_matmul.launches == before + 1
    _gemm_close(out, _blocked_matmul_plain(a, b, torch.float32))


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
def test_dense_epilogue_at_both_tile_widths(cuda, activation, bn):
    for shape in ((4096, 784, 4096), (512, 4096, 1000), (600, 520, 530)):
        a, b = _gemm_operands(cuda, shape, torch.bfloat16, "rr")
        bias = torch.randn(shape[2], generator=cuda, device="cuda")
        out = dense_epilogue(a, b, bias, activation, bn=bn)
        torch.cuda.synchronize()
        ref = _dense_epilogue_plain(a, b, bias, activation)
        err = (out - ref).abs().max().item()
        assert err <= 1e-4 * max(1.0, ref.abs().max().item())


def test_the_tile_widths_agree(cuda):
    """Both widths sum every output in the same order (one wgmma K walk),
    so they agree bit for bit with each other and with the kernel's own
    pick."""
    a, b = _gemm_operands(cuda, (784, 4096, 4096), torch.bfloat16, "cr")
    outs = [blocked_matmul(a, b, bn=bn) for bn in (0, 128, 256)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


@pytest.mark.parametrize("m", [8, PALLAS_MAX_ROWS])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("k,n", K2_DECODE_SHAPES,
                         ids=["%dx%d" % s for s in K2_DECODE_SHAPES])
def test_int8_matmul_at_every_raced_split(cuda, k, n, dtype, m):
    from veles_tpu_torch.ops import quant
    x, q, scale = _int8_problem(cuda, m, k, n, dtype)
    ref = _int8_matmul_plain(x, q, scale)
    candidates = quant.int8_split_candidates(
        m, k, n, _workspace.sm_count(x.device))
    for want in candidates:
        out = quant._int8_kernel(x, q, scale, want)
        again = quant._int8_kernel(x, q, scale, want)
        torch.cuda.synchronize()
        assert torch.equal(out, again), want
        _close_to_largest(out, ref)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_paged_attends_at_every_raced_split(cuda, head_dim, q_dtype):
    """K1 and K3 at every pages-per-split the autotuner races (a table
    of 6 pages: 1, 2, 4 and 6 pages a split)."""
    from veles_tpu_torch.ops import paged_attention as pa
    q, k, v, table, lengths, ps = _paged_problem(cuda, head_dim, q_dtype,
                                                 torch.bfloat16)
    ref = _paged_attend_plain(q, k, v, table, lengths, ps)
    args8 = _int8_paged_problem(cuda, head_dim, q_dtype, [0, 15, 16, 53, 7],
                                6)
    ref8 = _paged_attend_int8_plain(*args8)
    candidates = pa.paged_page_candidates(table.shape[1])
    assert candidates == [1, 2, 4, 6]
    for pages in candidates:
        out = pa._paged_launch(q, k, v, table, lengths, ps, pages)
        out8 = pa._paged_int8_launch(*args8, pages)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(out8, ref8, rtol=1e-5, atol=1e-5)


def test_a_race_on_the_card_persists_and_routes(cuda):
    """autotune_matmul on the card: an entry under this card's key with
    sane times; then ``matmul(use_pallas="tuned")`` launches K5 exactly
    where the verdict says ``beats_xla``, with the verdict's width."""
    import json
    blocks = gemm.autotune_matmul(784, 4096, 4096, iters=25)
    assert blocks[0] in (128, 256)
    kind = gemm._gemm_kind(784, 4096, 4096, torch.bfloat16)
    entry = json.load(open(gemm._cache_path()))[
        gemm._key(torch.device("cuda"), kind)]
    assert gemm.device_tag() == "%s sm_%d%d" % (
        torch.cuda.get_device_name(0), *torch.cuda.get_device_capability(0))
    assert entry["seconds"] > 0 and entry["xla_seconds"] > 0
    x = torch.randn((4096, 784), generator=cuda, device="cuda")
    err = torch.randn((4096, 4096), generator=cuda, device="cuda")
    for beats in (True, False):
        entry["beats_xla"] = beats
        gemm._persist_cache(dict(gemm._load_cache(), **{
            gemm._key(torch.device("cuda"), kind): entry}))
        before = blocked_matmul.launches
        out = gemm.matmul(x.t(), err, out_dtype=torch.float32,
                          use_pallas="tuned")
        torch.cuda.synchronize()
        assert blocked_matmul.launches == before + int(beats)
        _gemm_close(out, _blocked_matmul_plain(
            x.t().to(torch.bfloat16), err.to(torch.bfloat16)))


def test_int8_verdicts_choose_the_route(cuda):
    """An ``int8:KxN`` verdict for the plain route takes K2 off that
    shape; one for a split count runs K2 at it; True and False pin."""
    from veles_tpu_torch.ops import quant
    x, q, scale = _int8_problem(cuda, 8, 1024, 3072, torch.bfloat16)
    key = gemm._key(x.device, "int8:1024x3072")
    for use, splits, launched in ((False, None, 0), (True, 4, 1)):
        gemm._persist_cache({key: {"use_pallas": use, "splits": splits,
                                   "seconds": 1e-5, "xla_seconds": 2e-5}})
        assert quant._tuned_decision(8, 1024, 3072, x.device) \
            == (use, splits)
        before = int8_matmul.launches
        out = int8_matmul(x, q, scale)
        pinned = int8_matmul(x, q, scale, use_pallas=True)
        plain = int8_matmul(x, q, scale, use_pallas=False)
        torch.cuda.synchronize()
        assert int8_matmul.launches == before + launched + 1
        ref = _int8_matmul_plain(x, q, scale)
        for got in (out, pinned, plain):
            _close_to_largest(got, ref)
    with pytest.raises(ValueError, match="at most"):
        int8_matmul(*_int8_problem(cuda, PALLAS_MAX_ROWS + 1, 64, 32,
                                   torch.float32), use_pallas=True)


def test_device_benchmark_on_the_card(cuda):
    from veles_tpu_torch.ops.benchmark import device_benchmark
    power = device_benchmark()
    assert power > 0 and math.isfinite(power)


# -- the observe plane on the card (port slice 17) -----------------------------

def _observed_api(paged=True):
    """A toy GenerateAPI on the card (the paged pool: K1), started."""
    from veles_tpu_torch.serving import GenerateAPI

    params = init_transformer_params(numpy.random.RandomState(0), 2, 64,
                                     4, 97, device="cpu")
    table = torch.randn((97, 64), generator=torch.Generator()
                        .manual_seed(1)) * 0.5
    return GenerateAPI(params, table, 4, slots=2, max_len=64, n_tokens=6,
                       chunk=2, paged=paged, page_size=16,
                       device="cuda").start()


def test_metrics_device_families_on_the_card(cuda):
    """``/metrics`` on a serving front on the card: the allocator's
    counters for device 0 (in use at least the weights plus the pool,
    the limit the card's memory), the card's bf16 peak, and the library
    loads of K1's source."""
    import json as json_mod
    import urllib.request

    from veles_tpu_torch.observe.xla_stats import peak_tflops
    from veles_tpu_torch.parallel.kv_pool import paged_kv_bytes
    from veles_tpu_torch.serving import _tree_bytes

    api = _observed_api()
    try:
        url = "http://127.0.0.1:%d" % api.port
        req = urllib.request.Request(
            url + "/generate", data=json_mod.dumps(
                {"tokens": [1, 2, 3]}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert len(json_mod.loads(resp.read())["tokens"]) == 6
        with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
            text = resp.read().decode()
        held = _tree_bytes((api.decoder.params, api.decoder.embed_table)) \
            + paged_kv_bytes(api.decoder.state)
    finally:
        api.stop()

    def value(prefix):
        (line,) = [l for l in text.splitlines() if l.startswith(prefix)]
        return float(line.rsplit(" ", 1)[1])

    assert value('veles_device_memory_bytes{device="0",kind="bytes_in_use"}'
                 ) >= held
    assert value('veles_device_memory_bytes{device="0",kind="bytes_limit"}'
                 ) == torch.cuda.mem_get_info(0)[1]
    peak = peak_tflops(torch.cuda.get_device_name(0))
    if peak is not None:
        assert value("veles_device_peak_bf16_tflops") == peak
    assert value('veles_kernel_loads_total{kernel="paged_attention.cu"}') \
        >= 1
    assert 0 < value('veles_mfu_ratio{program="paged.dispatch"}') <= 1.05


def test_profile_ranges_stand_over_k1(cuda, tmp_path):
    """A paged decode dispatch inside the profiler window: K1's kernels
    are in the Chrome trace, each under a ``paged.dispatch`` range, on
    the card's timeline or launched inside the host range."""
    import json as json_mod

    from veles_tpu_torch.observe.profile import profile_window

    params = init_transformer_params(numpy.random.RandomState(0), 2, 64,
                                     4, 97, device="cpu")
    table = torch.randn((97, 64), generator=torch.Generator()
                        .manual_seed(1)) * 0.5
    dec = ContinuousDecoder(params, table, 4, slots=2, max_len=64,
                            n_tokens=6, paged=True, page_size=16,
                            device="cuda")
    dec.submit([1, 2, 3])
    with profile_window(str(tmp_path)) as path:
        dec.run_until_drained(chunk=2)
        torch.cuda.synchronize()
    events = json_mod.load(open(path))["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "paged_attend" in e["name"]]
    card = [e for e in events if e.get("cat") == "gpu_user_annotation"
            and e["name"] == "paged.dispatch"]
    host = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] == "paged.dispatch"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    assert k1 and host
    for kernel in k1:
        src = launch.get(kernel["args"].get("correlation"))
        assert any(r["ts"] <= kernel["ts"]
                   and kernel["ts"] + kernel["dur"] <= r["ts"] + r["dur"]
                   + 1e-3 for r in card) or (
            src is not None and any(r["tid"] == src["tid"] and r["ts"]
                                    <= src["ts"] <= r["ts"] + r["dur"]
                                    for r in host))


def test_peak_tflops_names_this_card(cuda, monkeypatch):
    from veles_tpu_torch.observe.xla_stats import peak_tflops

    monkeypatch.setattr(root.common.observe, "peak_tflops", None,
                        raising=False)
    name = torch.cuda.get_device_name(0)
    assert peak_tflops() == peak_tflops(name)
    if "H100" in name and "PCIe" not in name and "NVL" not in name:
        assert peak_tflops() == 989.0


def test_memscope_owners_against_the_allocator(cuda, monkeypatch):
    """memscope on the card: the decoder's owners equal the bytes of its
    tensors, the device total is the caching allocator's
    ``allocated_bytes.all.current`` (never the reserved bytes), the
    decoder's build allocated at least what its owners report, and the
    residue is ``max(0, device - tagged)``."""
    from veles_tpu_torch.observe import memscope as memscope_mod
    from veles_tpu_torch.observe.memscope import MemScope
    from veles_tpu_torch.parallel.decode import (param_tree_bytes,
                                                 slot_state_bytes)

    scope = MemScope()
    monkeypatch.setattr(memscope_mod, "_memscope", scope)
    params = init_transformer_params(numpy.random.RandomState(0), 2, 64,
                                     4, 97, device="cpu")
    table = torch.randn((97, 64), generator=torch.Generator()
                        .manual_seed(1)) * 0.5
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocated_bytes.all.current"]
    dec = ContinuousDecoder(params, table, 4, slots=2, max_len=64,
                            n_tokens=6, paged=True, page_size=16,
                            quantize="int8", device="cuda")
    torch.cuda.synchronize()
    owners = scope.attribute()
    allocated = torch.cuda.memory_stats()["allocated_bytes.all.current"]
    snap = scope.snapshot()
    pool = kv_pool.paged_kv_bytes(dec.state)
    assert owners["params"] == param_tree_bytes(dec.params, dec.embed_table)
    assert owners["kv_pool"] == pool
    assert owners["decode_state"] == slot_state_bytes(dec.state) - pool
    assert allocated - before >= owners["params"] + pool \
        + owners["decode_state"]
    assert snap["device_bytes"] == allocated
    assert snap["owners"]["untagged"] == max(
        0, snap["device_bytes"] - snap["tagged_bytes"])
    assert snap["limit_bytes"] == torch.cuda.mem_get_info(0)[1]


def test_a_ledger_row_per_request_on_the_card(cuda):
    """Each request served on the card leaves one complete ledger row:
    the waterfall, its tenant and trace, live dispatches equal to its
    admission and its collected chunks, chunk tokens adding up to its
    budget; the serve scope books ``tile_pad`` and no overshoot."""
    import json as json_mod
    import urllib.request

    from veles_tpu_torch.observe import servescope as scope_mod
    from veles_tpu_torch.observe.reqledger import RequestLedger
    from veles_tpu_torch.observe.servescope import ServeScope
    from veles_tpu_torch.serving import GenerateAPI

    ledger, scope = RequestLedger(), ServeScope()
    real, scope_mod._serve_scope = scope_mod._serve_scope, scope
    params = init_transformer_params(numpy.random.RandomState(0), 2, 64,
                                     4, 97, device="cpu")
    table = torch.randn((97, 64), generator=torch.Generator()
                        .manual_seed(1)) * 0.5
    try:
        api = GenerateAPI(params, table, 4, slots=2, max_len=64,
                          n_tokens=6, chunk=2, paged=True, page_size=16,
                          ledger=ledger, device="cuda").start()
    finally:
        scope_mod._serve_scope = real
    try:
        for i in range(3):
            req = urllib.request.Request(
                "http://127.0.0.1:%d/generate" % api.port,
                data=json_mod.dumps({"tokens": [1, 2, 3 + i]}).encode(),
                headers={"X-Veles-Trace": "c0de%02d/01" % i,
                         "X-Veles-Tenant": "t%d" % i})
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert len(json_mod.loads(resp.read())["tokens"]) == 6
    finally:
        api.stop()
    rows = ledger.resolved()
    assert [r["trace"] for r in rows] == ["c0de00", "c0de01", "c0de02"]
    for i, row in enumerate(rows):
        assert [s for s, _ in row["stages"]] == [
            "staged", "pool_gated", "admitted", "first_token", "resolved"]
        assert row["tenant"] == "t%d" % i and row["outcome"] == "completed"
        assert sum(c[1] for c in row["chunks"]) == 6
        assert row["dispatches"] == {"aot": 0,
                                     "live": 1 + len(row["chunks"])}
    assert scope.waste["tile_pad"] > 0
    assert scope.waste["page_overshoot"] == scope.waste["span_overshoot"] \
        == scope.waste["group_dup"] == 0
    assert scope.useful["decode"] == 18


def _act_model():
    params = init_transformer_params(numpy.random.RandomState(0), 2, 64,
                                     4, 97, device="cpu")
    table = torch.randn((97, 64), generator=torch.Generator()
                        .manual_seed(1)) * 0.5
    return params, table


def _act_post(port, tokens, tenant=""):
    import json as json_mod
    import urllib.request

    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json_mod.dumps({"tokens": tokens}).encode(),
        headers={"X-Veles-Tenant": tenant})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json_mod.loads(resp.read())["tokens"]


def _act_stream(params, table, prompt, **kwargs):
    decoder = ContinuousDecoder(params, table, 4, slots=2, max_len=64,
                                n_tokens=6, device="cuda", **kwargs)
    rid = decoder.submit(prompt)
    decoder.run_until_drained(chunk=2)
    return decoder.results[rid]


def test_a_governed_demotion_launches_k2(cuda):
    """The governor demotes a paged front on the card to int8: the swap
    builds and probes the int8 decoder, whose requests launch K2 (and
    K1, never K3), and every stream equals a fixed-tier decoder's on the
    card."""
    import time

    from veles_tpu_torch.observe.governor import (GovernorConfig,
                                                  ServingGovernor)
    from veles_tpu_torch.serving import GenerateAPI

    params, table = _act_model()
    governor = ServingGovernor(GovernorConfig(
        prewarm=False, breaker_guard=False, interval_s=1e6))
    api = GenerateAPI(params, table, 4, slots=2, max_len=64, n_tokens=6,
                      chunk=2, paged=True, page_size=16, governor=governor,
                      device="cuda").start()
    try:
        before = _act_post(api.port, [1, 2, 3])
        governor.level = 1
        api.request_tier("int8")
        deadline = time.monotonic() + 60
        while api.decoder.quantize != "int8" \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert api.decoder.quantize == "int8"
        k1, k2, k3 = (paged_attend.launches, int8_matmul.launches,
                      paged_attend_int8.launches)
        after = _act_post(api.port, [1, 2, 3])
        assert int8_matmul.launches > k2 and paged_attend.launches > k1
        assert paged_attend_int8.launches == k3
    finally:
        api.stop()
    assert api.tier_swaps[0]["tier"] == "int8"
    assert before == _act_stream(params, table, [1, 2, 3], paged=True,
                                 page_size=16)
    assert after == _act_stream(params, table, [1, 2, 3], paged=True,
                                page_size=16, quantize="int8")


def test_a_green_engine_streams_the_new_weights(cuda):
    """A rollout's green engine on the card: a green tenant's stream
    equals a decoder's on the new weights, a blue tenant's the old
    weights'."""
    import zlib

    from veles_tpu_torch.rollout import RolloutConfig
    from veles_tpu_torch.serving import GenerateAPI

    params, table = _act_model()
    params2 = init_transformer_params(numpy.random.RandomState(7), 2, 64,
                                      4, 97, device="cpu")
    tenants = ["t%d" % i for i in range(200)]
    point = [(zlib.crc32(t.encode()) % 10000) / 10000.0 for t in tenants]
    green = next(t for t, p in zip(tenants, point) if p < 0.5)
    blue = next(t for t, p in zip(tenants, point) if p >= 0.5)
    api = GenerateAPI(params, table, 4, slots=2, max_len=64, n_tokens=6,
                      chunk=2, device="cuda").start()
    try:
        rollout = api.begin_rollout(params2, version="v2", config=(
            RolloutConfig(steps=(0.5, 1.0), hold_s=100, cooldown_s=100)))
        green_stream = _act_post(api.port, [4, 5], green)
        blue_stream = _act_post(api.port, [4, 5], blue)
        assert rollout.state == "shifting"
    finally:
        api.stop()
    assert green_stream == _act_stream(params2, table, [4, 5])
    assert blue_stream == _act_stream(params, table, [4, 5])


# -- the data-parallel mesh (parallel/mesh.py, mapreduce.py) ---------------

def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_reduce_sum_over_nccl_at_world_one(cuda, precision):
    """A world of one over NCCL: each tier on CUDA tensors equals its
    plain version (f32 the input, bf16 its rounding, int8 the two
    quantization stages), the integer leaf untouched, nothing on the
    host."""
    from veles_tpu_torch.parallel import mapreduce
    from veles_tpu_torch.parallel.mesh import (build_mesh,
                                               finalize_distributed,
                                               initialize_distributed)
    initialize_distributed("127.0.0.1:%d" % _free_port(), 1, 0,
                           device="cuda", timeout=60)
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = build_mesh()
        x = torch.randn((37, 5), generator=cuda, device="cuda") * 3
        n = torch.tensor(7, dtype=torch.int32, device="cuda")
        got = mapreduce.reduce_sum({"x": x, "n": n}, precision=precision,
                                   group=mesh.group)
    finally:
        finalize_distributed()
    assert got["x"].is_cuda and got["n"].item() == 7
    ref = x.cpu()
    bound = 0.0
    if precision == "bf16":
        ref = ref.bfloat16().float()
    elif precision == "int8":
        scale = ref.abs().max() / 127.0
        ref = torch.round(ref / scale).clamp(-127, 127) * scale
        scale2 = ref.abs().max() / 127.0
        ref = torch.round(ref / scale2).clamp(-127, 127) * scale2
        # a quotient the card rounds otherwise may move a code by one
        bound = scale2.item()
    assert (got["x"].cpu() - ref).abs().max().item() <= bound


#: one rank of a world on the card: ``python -c`` with the config path
#: and the rank
_MESH_RANK = r'''
import json, sys
import numpy, torch
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.parallel.mesh import (build_mesh,
                                           finalize_distributed,
                                           initialize_distributed)
root.common.engine.precision_level = 2
cfg = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
initialize_distributed(cfg["coordinator"], 2, rank, device="cuda",
                       backend="gloo", timeout=120)
data = numpy.load(cfg["data"], allow_pickle=True)
prng.get("loader").seed(5)
wf = MLPWorkflow(DummyLauncher(), device="cuda", mesh=build_mesh(data=2),
                 **json.loads(cfg["kwargs"]),
                 loader_kwargs=dict(data=data["x"], labels=data["y"],
                                    class_lengths=[0, 256, 1024],
                                    minibatch_size=128))
unit_params_from_jax(wf, list(data["init"]))
wf.initialize()
seen = []
summary = wf.decision._epoch_summary
def recorded(stats, epoch):
    seen.append(int(stats[1][0]))
    summary(stats, epoch)
wf.decision._epoch_summary = recorded
wf.run()
numpy.save(cfg["out"] % rank, numpy.array(
    [seen, wf.fused_tick.mesh is not None]
    + [f.weights.data.cpu().numpy() for f in wf.forwards], dtype=object))
finalize_distributed()
'''


def test_mesh_tick_on_the_card_matches_a_single_run(cuda, tmp_path,
                                                    monkeypatch):
    """Two ranks share the card over gloo (NCCL takes one rank per
    device), each stepping its half of every minibatch: per-epoch
    validation errors equal to one process stepping the whole
    minibatches from the same weights, weights within 1e-5 (level 2:
    f32 sums in another order)."""
    import json
    import os
    import subprocess
    import sys

    from veles_tpu_torch.convert import unit_params_from_jax
    from veles_tpu_torch.core import prng
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.mlp import MLPWorkflow

    rng = numpy.random.RandomState(3)
    x = rng.rand(1280, 32).astype(numpy.float32)
    y = ((x[:, :4].sum(axis=1) * 2.5).astype(numpy.int32) % 10)
    init = numpy.array([{"weights": rng.uniform(-0.2, 0.2, (32, 64)),
                         "bias": numpy.zeros(64)},
                        {"weights": rng.uniform(-0.2, 0.2, (64, 10)),
                         "bias": numpy.zeros(10)}], dtype=object)
    numpy.savez(tmp_path / "data.npz", x=x, y=y, init=init)
    kwargs = dict(layers=[64, 10], learning_rate=0.1, max_epochs=3)
    cfg = {"coordinator": "127.0.0.1:%d" % _free_port(),
           "data": str(tmp_path / "data.npz"),
           "out": str(tmp_path / "rank%d.npy"), "kwargs": json.dumps(kwargs)}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setattr(root.common.engine, "precision_level", 2)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_RANK, str(tmp_path / "cfg.json"),
         str(rank)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        logs = [proc.communicate(timeout=240)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
    prng.get("loader").seed(5)
    wf = MLPWorkflow(DummyLauncher(), device="cuda", **kwargs,
                     loader_kwargs=dict(data=x, labels=y,
                                        class_lengths=[0, 256, 1024],
                                        minibatch_size=128))
    unit_params_from_jax(wf, list(init))
    wf.initialize()
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append(int(stats[1][0]))
        summary(stats, epoch)
    wf.decision._epoch_summary = recorded
    wf.run()
    for rank in range(2):
        got = numpy.load(cfg["out"] % rank, allow_pickle=True)
        assert got[1] and list(got[0]) == seen and len(seen) == 3
        for tw, f in zip(got[2:], wf.forwards):
            numpy.testing.assert_allclose(tw, f.weights.data.cpu().numpy(),
                                          atol=1e-5, rtol=0)


def test_a_fleet_slave_tick_on_the_card_runs_k6_and_k5(cuda, monkeypatch):
    """A master and one sync slave on the card over loopback, the engine
    knobs on at level 2: the slave's fused tick launches K6 once per
    minibatch (784 -> 512, every train and valid one) and K5 once per
    train minibatch (the weight gradient); every frame either side
    sends holds numpy arrays, never a tensor; the master's weights end
    within 1e-5 of one process stepping the same minibatches."""
    import threading

    from veles_tpu_torch.convert import unit_params_from_jax
    from veles_tpu_torch.core import prng
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.fleet import protocol
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.models.mlp import MLPWorkflow

    for key, value in (("use_pallas", True), ("pallas_epilogue", True),
                       ("precision_level", 2)):
        monkeypatch.setattr(root.common.engine, key, value)
    rng = numpy.random.RandomState(21)
    x = rng.rand(1536, 784).astype(numpy.float32)
    y = rng.randint(0, 10, 1536).astype(numpy.int32)
    init = [{"weights": rng.uniform(-0.05, 0.05, (784, 512)),
             "bias": numpy.zeros(512)},
            {"weights": rng.uniform(-0.05, 0.05, (512, 10)),
             "bias": numpy.zeros(10)}]
    kwargs = dict(layers=(512, 10), learning_rate=0.05, max_epochs=1,
                  device="cuda", name="fleet-card",
                  loader_kwargs=dict(data=x, labels=y,
                                     class_lengths=[0, 512, 1024],
                                     minibatch_size=512))
    tensors = []
    serialize = protocol._serialize

    def checked(message):
        def walk(value):
            if isinstance(value, torch.Tensor):
                tensors.append(type(value))
            elif isinstance(value, dict):
                for item in value.values():
                    walk(item)
            elif isinstance(value, (list, tuple)):
                for item in value:
                    walk(item)
        walk(message)
        return serialize(message)
    monkeypatch.setattr(protocol, "_serialize", checked)

    def build(launcher):
        prng.get("default").seed(1)
        prng.get("loader").seed(2)
        wf = MLPWorkflow(launcher, **kwargs)
        unit_params_from_jax(wf, init)
        return wf

    master = Launcher(listen_address="127.0.0.1:0")
    wf = build(master)
    master.initialize()
    slave = Launcher(master_address="127.0.0.1:%d" % master.agent.port)
    try:
        build(slave)
        slave.initialize()
        gemm.dense_epilogue.launches = gemm.blocked_matmul.launches = 0
        threads = [threading.Thread(target=launcher.run, daemon=True)
                   for launcher in (master, slave)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(120)
        assert not any(thread.is_alive() for thread in threads)
        launches = (gemm.dense_epilogue.launches,
                    gemm.blocked_matmul.launches)
    finally:
        slave.stop()
        master.stop()
    assert slave.agent.jobs_done == 3
    assert launches == (3, 2)
    assert not tensors
    alone = build(DummyLauncher())
    alone.initialize()
    alone.run()
    for fwd, ref in zip(wf.forwards, alone.forwards):
        assert fwd.weights.data.is_cuda
        numpy.testing.assert_allclose(fwd.weights.data.cpu().numpy(),
                                      ref.weights.data.cpu().numpy(),
                                      atol=1e-5, rtol=0)



# -- the AOT bundle ------------------------------------------------------------

#: a process booted from a bundle, from a copy of the package with no
#: ``_build/``: the toy model from its seed, the bundle's decoder on the
#: prompts, its streams, kernel builds and bundle stats printed
AOT_CARD_CHILD = r"""
import json, sys
import numpy, torch
from veles_tpu_torch.aot.loader import load_bundle
from veles_tpu_torch.observe.xla_stats import get_compile_tracker
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)
from veles_tpu_torch.serving import ContinuousDecoder
args = json.loads(sys.argv[1])
rng = numpy.random.RandomState(0)
params = init_transformer_params(rng, 2, 64, 4, 256, dtype=torch.bfloat16,
                                 device="cuda")
table = torch.from_numpy(rng.randn(256, 64).astype(numpy.float32)).to(
    device="cuda", dtype=torch.bfloat16)
aot = load_bundle(args["bundle"], prefetch=False)
dec = ContinuousDecoder(params, table, 4, aot=aot, **args["kw"])
for prompt in args["prompts"]:
    dec.submit(prompt)
dec.run_until_drained(chunk=args["chunk"])
print(json.dumps({"results": [dec.results[i] for i in sorted(dec.results)],
                  "builds": {k: v for k, v in get_compile_tracker()
                             .snapshot()["compiles"].items()
                             if k.endswith(".cu")},
                  "stats": aot.stats(), "active": dec.aot_active}))
"""


def test_aot_bundle_boots_a_process_without_nvcc(cuda, tmp_path):
    """A paged int8 bundle of this process's built libraries (K1, K2)
    boots a process whose package copy has an empty build directory: no
    kernel is built there, every dispatch is a hit, and its streams equal
    this process's live decoder's."""
    import json
    import os
    import shutil
    import subprocess
    import sys

    from veles_tpu_torch.aot.artifact import build_serving_bundle

    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, 2, 64, 4, 256,
                                     dtype=torch.bfloat16, device="cuda")
    table = torch.from_numpy(rng.randn(256, 64).astype(numpy.float32)).to(
        device="cuda", dtype=torch.bfloat16)
    kw = dict(slots=4, max_len=256, n_tokens=8, paged=True, page_size=16,
              quantize="int8")
    path = build_serving_bundle(params, table, 4, str(tmp_path / "b.tar"),
                                chunk=4, device="cuda", **kw)
    prompts = [numpy.random.RandomState(n).randint(0, 256, n).tolist()
               for n in (5, 17, 40, 100)]
    live = ContinuousDecoder(params, table, 4, device="cuda", **kw)
    for prompt in prompts:
        live.submit(prompt)
    live.run_until_drained(chunk=4)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(os.path.join(repo, "veles_tpu_torch"),
                    str(tmp_path / "copy" / "veles_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-c", AOT_CARD_CHILD,
         json.dumps({"bundle": path, "kw": kw, "prompts": prompts,
                     "chunk": 4})],
        cwd=str(tmp_path / "copy"), capture_output=True, text=True,
        timeout=300,
        env=dict(os.environ, PYTHONPATH=str(tmp_path / "copy")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["active"] and out["builds"] == {}
    assert not out["stats"]["misses"] and out["stats"]["hits"]
    assert out["stats"]["libraries"] == {"int8_matmul": "bundle",
                                         "paged_attention": "bundle"}
    assert out["results"] == [live.results[i] for i in sorted(live.results)]


#: a replica of the serving fleet test: the serving model at full width
#: (embed 1024, 16 heads, 4 blocks, vocab 32768, seed 0, bf16) in the
#: paged int8 tier (K1, K2), its port printed, serving until killed
ROUTER_CARD_CHILD = r"""
import json, os, sys, threading, time
threading.Timer(300, lambda: os._exit(3)).start()
import numpy
import torch
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)
from veles_tpu_torch.serving import GenerateAPI
rng = numpy.random.RandomState(0)
params = init_transformer_params(rng, 4, 1024, 16, 32768,
                                 dtype=torch.bfloat16, device="cuda")
table = torch.from_numpy(rng.randn(32768, 1024).astype(numpy.float32)
                         * 0.02).to(device="cuda", dtype=torch.bfloat16)
api = GenerateAPI(params, table, 16, slots=8, max_len=1024, n_tokens=16,
                  chunk=8, paged=True, page_size=128, quantize="int8",
                  device="cuda").start()
print(json.dumps({"port": api.port}), flush=True)
sys.stdin.read()
os._exit(0)
"""


_TP_RANK = r'''
import json, sys
import numpy, torch
from veles_tpu_torch.ops.paged_attention import paged_attend
from veles_tpu_torch.ops.quant import int8_matmul
from veles_tpu_torch.parallel.mesh import (build_mesh, finalize_distributed,
                                           initialize_distributed)
from veles_tpu_torch.parallel.transformer_step import init_transformer_params
from veles_tpu_torch.serving import GenerateAPI
cfg = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
initialize_distributed(cfg["coordinator"], 2, rank, device="cuda",
                       backend="gloo", timeout=120)
mesh = build_mesh(data=1, model=2)
out = {}
for dtype, quantize in (("float32", None), ("bfloat16", "int8")):
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, 2, 128, 4, 256,
                                     dtype=getattr(torch, dtype),
                                     device="cuda")
    table = torch.from_numpy(rng.randn(256, 128).astype(numpy.float32)
                             * 0.3).to(device="cuda",
                                        dtype=getattr(torch, dtype))
    paged_attend.launches = int8_matmul.launches = 0
    api = GenerateAPI(params, table, 4, slots=4, max_len=128, n_tokens=8,
                      chunk=4, paged=True, page_size=16, quantize=quantize,
                      device="cuda", mesh=mesh)
    if rank:
        api.start()
        steps = api.follow_stats["steps"]
        tokens = None
    else:
        import urllib.request
        api.start()
        tokens = []
        for prompt in cfg["prompts"]:
            req = urllib.request.Request(
                "http://127.0.0.1:%d/generate" % api.port,
                data=json.dumps({"tokens": prompt}).encode())
            with urllib.request.urlopen(req, timeout=120) as resp:
                tokens.append(json.loads(resp.read().decode())["tokens"])
        counts = api.decoder.dispatch_counts
        steps = counts["chunk"] * 4 + counts["step"]
        api.stop()
    out[dtype] = {"tokens": tokens, "steps": steps,
                  "k1": paged_attend.launches, "k2": int8_matmul.launches}
json.dump(out, open(cfg["out"] % rank, "w"))
finalize_distributed()
'''


def test_two_ranks_share_the_card_tensor_parallel(cuda, tmp_path):
    """The sharded serving mesh on the card: two ranks over gloo serve a
    small model (4 heads of 32, 2 ranks of 2) through rank 0's
    GenerateAPI over HTTP, one request at a time. In the paged float tier
    on f32 weights its tokens equal one process's; in the paged int8
    tier on bf16 weights each rank launches K1 twice a decode step (a
    block each) and K2 at least 9 times (4 projections a block, the
    head)."""
    import json
    import os
    import subprocess
    import sys

    rng = numpy.random.RandomState(1)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 16, 33, 20)]
    cfg = {"coordinator": "127.0.0.1:%d" % _free_port(),
           "prompts": prompts, "out": str(tmp_path / "rank%d.json")}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TP_RANK, str(tmp_path / "cfg.json"),
         str(rank)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        logs = [proc.communicate(timeout=300)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
    ranks = [json.load(open(cfg["out"] % rank)) for rank in range(2)]
    params = init_transformer_params(numpy.random.RandomState(0), 2, 128,
                                     4, 256, device="cuda")
    rng = numpy.random.RandomState(0)
    init_transformer_params(rng, 2, 128, 4, 256, device="cuda")
    table = torch.from_numpy(rng.randn(256, 128).astype(numpy.float32)
                             * 0.3).cuda()
    single = ContinuousDecoder(params, table, 4, slots=4, max_len=128,
                               n_tokens=8, paged=True, page_size=16,
                               device="cuda")
    for prompt in prompts:
        single.submit(prompt)
        single.run_until_drained(chunk=4)
    assert ranks[0]["float32"]["tokens"] == [single.results[i]
                                             for i in range(len(prompts))]
    for got in ranks:
        tier = got["bfloat16"]
        assert tier["steps"] > 0
        assert tier["k1"] == 2 * tier["steps"]
        assert tier["k2"] >= 9 * tier["steps"]
        assert got["float32"]["k1"] == 2 * got["float32"]["steps"]


_GOV_RANK = r'''
import json, sys, time
import numpy, torch
from veles_tpu_torch.observe.governor import GovernorConfig, ServingGovernor
from veles_tpu_torch.ops.paged_attention import paged_attend
from veles_tpu_torch.ops.quant import int8_matmul
from veles_tpu_torch.parallel.mesh import (build_mesh, finalize_distributed,
                                           initialize_distributed)
from veles_tpu_torch.parallel.transformer_step import init_transformer_params
from veles_tpu_torch.serving import GenerateAPI
cfg = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
initialize_distributed(cfg["coordinator"], 2, rank, device="cuda",
                       backend="gloo", timeout=120)
mesh = build_mesh(data=1, model=2)
rng = numpy.random.RandomState(0)
params = init_transformer_params(rng, 2, 128, 4, 256, device="cuda")
table = torch.from_numpy(rng.randn(256, 128).astype(numpy.float32)
                         * 0.3).cuda()
kw = dict(slots=4, max_len=128, n_tokens=8, chunk=4, paged=True,
          page_size=16, device="cuda", mesh=mesh)
out = {}
if rank:
    api = GenerateAPI(params, table, 4, **kw).start()
    out = {"calls": api.follow_stats["calls"],
           "engines": api.follow_stats["engines"],
           "k1": paged_attend.launches, "k2": int8_matmul.launches,
           "steps": api.follow_stats["steps"]}
else:
    import urllib.request

    class BurnSLO:
        burn = None

        def summary(self):
            return None if self.burn is None else {
                "burn_rate": self.burn, "objective": "ttft_p95_ms",
                "window": "2s"}

        def record(self, **kwargs):
            pass

        def publish(self, registry):
            pass

        def version_burn(self, version, now=None):
            return None

    def post(prompt):
        req = urllib.request.Request(
            "http://127.0.0.1:%d/generate" % api.port,
            data=json.dumps({"tokens": prompt}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read().decode())["tokens"]

    def wait(predicate):
        end = time.monotonic() + 60
        while not predicate():
            assert time.monotonic() < end
            time.sleep(0.01)

    slo = BurnSLO()
    governor = ServingGovernor(GovernorConfig(
        demote_burn=2.0, recover_burn=1.0, cooldown_s=0.3, interval_s=0.01,
        ladder=("int8",), breaker_guard=False, prewarm=False))
    api = GenerateAPI(params, table, 4, governor=governor, slo=slo,
                      **kw).start()
    rungs = []
    for burn, tier in ((None, None), (3.0, "int8"), (0.5, None)):
        if burn is not None:
            level = governor.level
            slo.burn = burn
            wait(lambda: governor.level != level)
            slo.burn = None
            wait(lambda: api.decoder.quantize == tier
                 and api._tier_request is None)
        k1, k2 = paged_attend.launches, int8_matmul.launches
        counts = dict(api.decoder.dispatch_counts)
        tokens = [post(p) for p in cfg["prompts"]]
        now = api.decoder.dispatch_counts
        rungs.append({"tier": tier, "tokens": tokens,
                      "k1": paged_attend.launches - k1,
                      "k2": int8_matmul.launches - k2,
                      "steps": (now["chunk"] - counts["chunk"]) * 4
                      + now["step"] - counts["step"]})
    api.stop()
    out = {"rungs": rungs}
json.dump(out, open(cfg["out"] % rank, "w"))
finalize_distributed()
'''


def test_two_ranks_governor_swap_on_the_card(cuda, tmp_path):
    """The governor over the serving mesh on the card: two ranks over
    gloo, rank 0's governor demoting the paged float tier (f32 weights)
    to int8 and promoting it back on a scripted burn. Rank 0's tokens at
    both float rungs equal one process's; the int8 rung launches K1 2
    and K2 at least 9 times a decode step; rank 1 built an engine for
    each swap and dropped the one it replaced, ending with one."""
    import json
    import os
    import subprocess
    import sys

    rng = numpy.random.RandomState(1)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 16, 33)]
    cfg = {"coordinator": "127.0.0.1:%d" % _free_port(),
           "prompts": prompts, "out": str(tmp_path / "rank%d.json")}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GOV_RANK, str(tmp_path / "cfg.json"),
         str(rank)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        logs = [proc.communicate(timeout=300)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
    lead, follow = [json.load(open(cfg["out"] % rank)) for rank in range(2)]
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, 2, 128, 4, 256, device="cuda")
    table = torch.from_numpy(rng.randn(256, 128).astype(numpy.float32)
                             * 0.3).cuda()
    single = ContinuousDecoder(params, table, 4, slots=4, max_len=128,
                               n_tokens=8, paged=True, page_size=16,
                               device="cuda")
    want = []
    for prompt in prompts:
        rid = single.submit(prompt)
        single.run_until_drained(chunk=4)
        want.append(single.results.pop(rid))
    float_rungs = [r for r in lead["rungs"] if r["tier"] is None]
    assert len(float_rungs) == 2
    for rung in float_rungs:
        assert rung["tokens"] == want
        assert rung["k1"] >= 2 * rung["steps"] > 0 and rung["k2"] == 0
    (int8,) = [r for r in lead["rungs"] if r["tier"] == "int8"]
    assert int8["k1"] >= 2 * int8["steps"] > 0
    assert int8["k2"] >= 9 * int8["steps"]
    assert follow["calls"]["build"] == 3 and follow["calls"]["discard"] == 2
    assert follow["calls"]["install"] == 2 and len(follow["engines"]) == 1
    assert follow["k2"] >= 9 * int8["steps"] and follow["steps"] > 0


@pytest.mark.slow
def test_router_kill9_failover_on_the_card(cuda):
    """Two full-width paged int8 replicas behind the port's router, one
    client posting one request at a time (a paged int8 replica's greedy
    stream is the same alone on either replica, not inside a burst:
    ROADMAP C): replica 0 SIGKILLed while it holds a lease, every reply
    200 and equal to the fault-free baseline, the plane naming it dead."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import threading
    import time
    import urllib.request

    from veles_tpu_torch.router import build_router

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", ROUTER_CARD_CHILD], cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo), stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True) for _ in range(2)]
    router = None

    def post(url, tokens):
        req = urllib.request.Request(
            url + "/generate", data=json.dumps({"tokens": tokens}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read().decode())["tokens"]

    try:
        urls = ["http://127.0.0.1:%d" % json.loads(
            proc.stdout.readline())["port"] for proc in procs]
        plane, router = build_router(
            urls, spec="poll_interval_s=0.2,fail_threshold=2,"
                       "cooldown_s=0.0,hedge_after_s=2.0,backoff_s=0.01,"
                       "page_size=128")
        router.start()
        front = "http://127.0.0.1:%d" % router.port
        rng = numpy.random.RandomState(3)
        prompts = [rng.randint(0, 32768, n).tolist()
                   for n in (40, 130, 260, 300, 500, 700)]
        baseline = [post(front, p) for p in prompts]
        assert all(status == 200 for status, _ in baseline)

        def kill_in_flight():
            # at replica 0's next lease (or after 30 s without one)
            deadline = time.monotonic() + 30
            while not plane.replicas[0].leases \
                    and time.monotonic() < deadline:
                time.sleep(0.001)
            procs[0].send_signal(signal.SIGKILL)

        killer = threading.Thread(target=kill_in_flight)
        killer.start()
        results = [(i, post(front, prompt)) for _ in range(3)
                   for i, prompt in enumerate(prompts)]
        killer.join()
        for i, got in results:
            assert got == baseline[i]
        deadline = time.monotonic() + 30
        while plane.replicas[0].state != "dead" \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert plane.replicas[0].state == "dead"
        assert plane.replicas[1].state == "active"
    finally:
        if router is not None:
            router.stop()
        for proc in procs:
            proc.kill()
            proc.wait()


_SP_RANK = r'''
import hashlib, json, sys
import numpy, torch
from veles_tpu_torch.ops.attention import (flash_attention_dkv,
                                           flash_attention_dq,
                                           flash_attention_fwd)
from veles_tpu_torch.parallel.mesh import build_mesh, initialize_distributed
from veles_tpu_torch.parallel.transformer_step import (
    build_transformer_train_step, init_transformer_params, shard_tokens)
cfg = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
initialize_distributed(cfg["coordinator"], 2, rank, device="cuda",
                       backend="gloo", timeout=120)
mesh = build_mesh(data=1, seq=2)
params = init_transformer_params(numpy.random.RandomState(0), 1, 256, 2,
                                 256, dtype=torch.bfloat16, device="cuda")
rng = numpy.random.RandomState(1)
x = torch.from_numpy(rng.randn(1, 4096, 256).astype(numpy.float32)
                     * 0.3).to(device="cuda", dtype=torch.bfloat16)
labels = torch.from_numpy(rng.randint(0, 256, (1, 4096))).cuda()
step = build_transformer_train_step(2, mesh=mesh)
for fn in (flash_attention_fwd, flash_attention_dkv, flash_attention_dq):
    fn.launches = 0
new, (loss, n_err) = step(params, *shard_tokens([x, labels], mesh))
torch.cuda.synchronize()
sha = hashlib.sha1()
for blk in new["blocks"]:
    for name in sorted(blk):
        sha.update(blk[name].float().cpu().numpy().tobytes())
json.dump({"loss": float(loss), "n_err": int(n_err), "digest":
           sha.hexdigest(), "head": new["head"].float().cpu().tolist(),
           "launches": [fn.launches for fn in (
               flash_attention_fwd, flash_attention_dkv,
               flash_attention_dq)]}, open(cfg["out"] % rank, "w"))
'''


def test_two_ranks_share_the_card_ulysses_step(cuda, tmp_path):
    """The sequence-parallel transformer step on the card: two ranks over
    gloo, seq=2, one block of 2 heads of 128 at 4096 positions in bf16.
    Ulysses hands each rank the whole sequence of its head, so each
    launches K7, K8 and K9 once (the flash rule holds); both ranks hold
    the same parameter bits, and the loss, n_err and the head agree with
    one process's step."""
    import json
    import os
    import subprocess
    import sys
    from veles_tpu_torch.parallel.transformer_step import (
        build_transformer_train_step)

    cfg = {"coordinator": "127.0.0.1:%d" % _free_port(),
           "out": str(tmp_path / "rank%d.json")}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SP_RANK, str(tmp_path / "cfg.json"),
         str(rank)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        logs = [proc.communicate(timeout=300)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
    ranks = [json.load(open(cfg["out"] % rank)) for rank in range(2)]
    params = init_transformer_params(numpy.random.RandomState(0), 1, 256,
                                     2, 256, dtype=torch.bfloat16,
                                     device="cuda")
    rng = numpy.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 4096, 256).astype(numpy.float32)
                         * 0.3).to(device="cuda", dtype=torch.bfloat16)
    labels = torch.from_numpy(rng.randint(0, 256, (1, 4096))).cuda()
    new, (loss, n_err) = build_transformer_train_step(2)(params, x, labels)
    for got in ranks:
        assert got["launches"] == [1, 1, 1]
        assert got["digest"] == ranks[0]["digest"]
        assert got["loss"] == pytest.approx(float(loss), rel=1e-2)
        assert abs(got["n_err"] - int(n_err)) <= 0.01 * 4096
    head = torch.tensor(ranks[0]["head"])
    want = new["head"].float().cpu()
    assert (head - want).abs().max() <= 1e-2 * want.abs().max()


def test_f32_transformer_step_at_flash_shapes_trains_c11(cuda):
    """C11, repaired: an f32 transformer step at flash shapes (4096
    positions, heads of 128) runs K7 forward and K8 and K9's f32 route
    backward on the card, one launch each, and its updates (new minus
    old parameters) equal the same step's on the CPU (the plain versions)
    within 1e-4 of each leaf's largest update, plus the f32 rounding of
    the leaf's largest parameter, which the update read back as a
    difference carries (a layer norm's weights sit at 1.0, one ulp 1.2e-7,
    their updates at 1e-4)."""
    from veles_tpu_torch.parallel.transformer_step import (
        build_transformer_train_step)

    rng = numpy.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 4096, 256).astype(numpy.float32)
                         * 0.3)
    labels = torch.from_numpy(rng.randint(0, 64, (1, 4096)))
    updates = {}
    for device in ("cuda", "cpu"):
        params = init_transformer_params(numpy.random.RandomState(0), 1,
                                         256, 2, 64, device=device)
        before = {name: leaf.clone() for name, leaf in
                  tree_leaves_with_path(params)}
        counts = (flash_attention_fwd.launches,
                  flash_attention_dkv.launches_f32,
                  flash_attention_dq.launches_f32)
        new, (loss, _) = build_transformer_train_step(2)(
            params, x.to(device), labels.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
            assert (flash_attention_fwd.launches,
                    flash_attention_dkv.launches_f32,
                    flash_attention_dq.launches_f32) \
                == tuple(n + 1 for n in counts)
        assert math.isfinite(float(loss))
        updates[device] = {name: ((leaf - before[name]).float().cpu(),
                                  before[name].abs().max().item())
                           for name, leaf in tree_leaves_with_path(new)}
    eps = torch.finfo(torch.float32).eps
    for name, (want, largest) in updates["cpu"].items():
        got = updates["cuda"][name][0]
        assert (got - want).abs().max() \
            <= 1e-4 * want.abs().max() + eps * largest, name
