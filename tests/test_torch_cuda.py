"""The port's CUDA kernels against their plain versions on the card, at
the shapes and types the serving smoke does not reach: K2's byte-wise
path (N % 16 != 0, misaligned q), K chunks past 512, f32 x, the M > 256
regime rule; K1 at head rows of 64 to 512 bytes, mixed query and pool
types, and the wrappers' refusals.

Needs a CUDA card and nvcc; everywhere else every test skips. Run on
the card without the JAX package's conftest (the card's machine has no
JAX):

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda.py
"""

import pytest
import torch

from veles_tpu_torch.ops.paged_attention import (_paged_attend_plain,
                                                 paged_attend)
from veles_tpu_torch.ops.quant import (PALLAS_MAX_ROWS,
                                       _int8_matmul_plain, int8_matmul,
                                       quantize_int8)

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("case", ["head_bytes", "strided_q"])
def test_paged_attend_refuses_what_the_kernel_does_not_take(cuda, case):
    if case == "head_bytes":   # 48 bf16 = 96-byte head rows
        q, k, v, table, lengths, ps = _paged_problem(
            cuda, 48, torch.bfloat16, torch.bfloat16)
    else:
        q, k, v, table, lengths, ps = _paged_problem(
            cuda, 64, torch.float32, torch.float32)
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        paged_attend(q, k, v, table, lengths, page_size=ps)
