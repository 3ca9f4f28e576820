"""K2's launch plan (veles_tpu_torch/ops/quant._int8_plan), held on the
CPU: the card's kernel runs the grid this pure function gives it, so
its invariants are checked here, at every decode-step shape of the
serving model, at ragged K and at the row counts the serving path
sends (1 to 256, PALLAS_MAX_ROWS).

The kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import pytest
import torch

from veles_tpu_torch.ops.quant import (INT8_MAX_SPLIT_ROWS, INT8_STEP_K,
                                       INT8_TILE_N, PALLAS_MAX_ROWS,
                                       _int8_plan)

torch.set_num_threads(1)

#: an H100's SMs
SMS = 132
#: the serving model's decode-step weights (embed 1024, vocab 32768):
#: qkv, out, MLP up, MLP down, the vocab head
DECODE_SHAPES = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
                 (1024, 32768)]
#: ragged K (no multiple of the 16-row step) and ragged N
RAGGED_SHAPES = [(37, 50), (1000, 130), (37, 4096), (1000, 1024)]
ROWS = [1, 8, 100, PALLAS_MAX_ROWS]


def _slices(k, splits, slice_rows):
    return [(s * slice_rows, min(k, (s + 1) * slice_rows))
            for s in range(splits)]


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", DECODE_SHAPES + RAGGED_SHAPES,
                         ids=["%dx%d" % s for s in DECODE_SHAPES
                              + RAGGED_SHAPES])
def test_every_k_row_falls_in_exactly_one_split(m, k, n):
    tiles, splits, slice_rows = _int8_plan(m, k, n, SMS)
    assert tiles == -(-n // INT8_TILE_N)
    assert splits >= 1 and slice_rows >= INT8_STEP_K
    assert slice_rows % INT8_STEP_K == 0  # whole 16-row mma steps
    covered = [0] * k
    for begin, end in _slices(k, splits, slice_rows):
        assert begin < end  # no split is empty
        for row in range(begin, end):
            covered[row] += 1
    assert covered == [1] * k


@pytest.mark.parametrize("k,n", DECODE_SHAPES,
                         ids=["%dx%d" % s for s in DECODE_SHAPES])
def test_a_decode_step_fills_the_card(k, n):
    tiles, splits, _ = _int8_plan(8, k, n, SMS)
    assert tiles * splits >= SMS


@pytest.mark.parametrize("k,n", DECODE_SHAPES,
                         ids=["%dx%d" % s for s in DECODE_SHAPES])
def test_split_partials_stay_within_four_times_the_weight(k, n):
    # f32 partials: 4 x splits x m bytes a column, the int8 weight k
    for m in ROWS:
        _, splits, _ = _int8_plan(m, k, n, SMS)
        if splits > 1:
            assert 4 * splits * m <= 4 * k


@pytest.mark.parametrize("m", ROWS)
def test_the_last_block_sums_a_bounded_tile(m):
    for k, n in DECODE_SHAPES + RAGGED_SHAPES:
        _, splits, _ = _int8_plan(m, k, n, SMS)
        assert splits == 1 or splits * m <= INT8_MAX_SPLIT_ROWS


def test_wide_products_are_not_split():
    # the vocab head has more tiles than the card has SMs
    assert _int8_plan(8, 1024, 32768, SMS) == (256, 1, 1024)


def test_plan_follows_the_sm_count():
    assert _int8_plan(8, 1024, 1024, 66)[1] < _int8_plan(8, 1024, 1024,
                                                         SMS)[1]
