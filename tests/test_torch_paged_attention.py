"""The port's paged decode attention (veles_tpu_torch/ops/
paged_attention.py) against the JAX package's Pallas kernel, run in
interpret mode as its own tests run it, on the same numpy inputs.

On the CPU the port's paged_attend runs its plain version (page-table
gather + masked f32 softmax); chip_smoke.py holds the CUDA kernel
against that plain version on the card."""

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.ops import paged_attention as jpgatt
from veles_tpu_torch.ops import paged_attention as tpgatt

torch.set_num_threads(1)

PS = 8
#: both sides compute in f32 from the same values; the online softmax
#: merges pages in another order than one softmax over the gathered
#: span, which moves results by a few ulp of values ~1
ATOL = 1e-5


def _problem(lengths, pb, heads=4, head_dim=8, seed=7):
    """Live pages 1.. per slot in logical order, the rest of each row
    padded with the scratch page 0 (which holds garbage, never seen)."""
    slots = len(lengths)
    rng = numpy.random.RandomState(seed)
    table = numpy.zeros((slots, pb), numpy.int32)
    nxt = 1
    for s, n in enumerate(lengths):
        for p in range(min(n // PS + 1, pb)):
            table[s, p] = nxt
            nxt += 1
    shape = (nxt + 2, PS, heads, head_dim)
    q = rng.randn(slots, heads, head_dim).astype(numpy.float32)
    k = rng.randn(*shape).astype(numpy.float32)
    v = rng.randn(*shape).astype(numpy.float32)
    return q, k, v, table, numpy.asarray(lengths, numpy.int32)


def _both(q, k, v, table, lengths, dtype):
    ref = jpgatt.paged_attend(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(table), jnp.asarray(lengths), page_size=PS,
        interpret=True)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    out = tpgatt.paged_attend(
        torch.from_numpy(q).to(tdtype), torch.from_numpy(k).to(tdtype),
        torch.from_numpy(v).to(tdtype), torch.from_numpy(table),
        torch.from_numpy(lengths), page_size=PS)
    return out, numpy.asarray(ref)


@pytest.mark.parametrize("lengths,pb", [
    ([0, PS, 2 * PS + 3], 3),          # ragged, length 0, page boundary
    ([5, 0, PS - 1, 3 * PS], 6),       # more table pages than live
    ([2 * PS - 1, 4 * PS + 2], 5),     # last page of a row partly live
], ids=["ragged", "wide-table", "partial-last-page"])
def test_plain_matches_jax_kernel_f32(lengths, pb):
    out, ref = _both(*_problem(lengths, pb), jnp.float32)
    assert out.dtype == torch.float32
    numpy.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_plain_matches_jax_kernel_bf16_pool():
    """bf16 query and pool: both widen to f32 exactly and return f32."""
    out, ref = _both(*_problem([0, PS, 2 * PS + 3], 4), jnp.bfloat16)
    assert out.dtype == torch.float32
    numpy.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_walk_stops_at_the_table_width():
    """A length past the table's PB pages attends the PB * ps positions
    the table holds, as the JAX grid stops at PB."""
    out, ref = _both(*_problem([3 * PS + 5], 2), jnp.float32)
    numpy.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_scratch_page_contents_are_never_seen():
    q, k, v, table, lengths = _problem([0, PS + 1, 3], 3)
    first = tpgatt.paged_attend(*map(torch.from_numpy,
                                     (q, k, v, table, lengths)),
                                page_size=PS)
    k[0], v[0] = 1e6, -1e6
    second = tpgatt.paged_attend(*map(torch.from_numpy,
                                      (q, k, v, table, lengths)),
                                 page_size=PS)
    torch.testing.assert_close(first, second, rtol=0, atol=0)


def test_cpu_tensors_never_count_a_launch():
    before = tpgatt.paged_attend.launches
    tpgatt.paged_attend(*map(torch.from_numpy,
                             _problem([1, 2], 1)), page_size=PS)
    assert tpgatt.paged_attend.launches == before


@pytest.mark.parametrize("case", ["lengths_int64", "table_int64",
                                  "page_size", "pool_dtype", "q_rank",
                                  "table_rows"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v, table, lengths = map(torch.from_numpy,
                                  _problem([1, PS], 2))
    args = {"lengths_int64": (q, k, v, table, lengths.long(), PS),
            "table_int64": (q, k, v, table.long(), lengths, PS),
            "page_size": (q, k, v, table, lengths, PS * 2),
            "pool_dtype": (q, k.double(), v.double(), table, lengths, PS),
            "q_rank": (q[None], k, v, table, lengths, PS),
            "table_rows": (q, k, v, table[:1], lengths, PS)}[case]
    with pytest.raises((ValueError, TypeError)):
        tpgatt.paged_attend(*args[:5], page_size=args[5])
