"""The launch plans of K4 (veles_tpu_torch/ops/quant._attend_plan) and
K1 (veles_tpu_torch/ops/paged_attention._paged_plan, K3's too), held on
the CPU, and the split-then-merge formula the three kernels compute,
emulated in torch ops on those plans and held against the JAX package's
kernels in interpret mode.

The kernels cut each (row, head)'s positions into splits, one block a
split, and merge the splits' softmax states (max m, sum l, acc) in the
same launch: out = sum_s acc_s exp(m_s - M) / sum_s l_s exp(m_s - M).
The kernels themselves are held against their plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py."""

import math

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.ops import paged_attention as jpgatt
from veles_tpu.ops import quant as jquant
from veles_tpu_torch.ops import paged_attention as tpgatt
from veles_tpu_torch.ops import quant as tquant
from veles_tpu_torch.ops.paged_attention import (PAGED_MAX_SPLITS,
                                                 PAGED_SPLIT_POSITIONS,
                                                 PAGED_WAVE, _paged_plan)
from veles_tpu_torch.ops.quant import (ATTEND_MAX_SPLITS, ATTEND_T_TILE,
                                       ATTEND_WAVE, _attend_plan)

torch.set_num_threads(1)

#: an H100's SMs
SMS = 132
#: both sides compute in f32 from the same values; the splits merge in
#: another order than one softmax over the lane, which moves results by a
#: few ulp of values ~1
ATOL = 1e-5

#: K4's shapes (B, H, T): the smoke's dense int8-KV slab (8 slots, 16
#: heads, 768 positions) and its 640-position span, one tile, a ragged
#: last split, long lanes of few heads and many rows of short lanes
ATTEND_SHAPES = [(8, 16, 768), (8, 16, 640), (2, 2, 128), (1, 1, 32896),
                 (1, 2, 16384), (3, 4, 20480), (64, 16, 8192),
                 (4, 2, 384)]
#: K1's shapes (S, H, D, PB, ps): the smoke's serving call (8 slots, 16
#: heads of 64, 10 pages of 128), 16-token pages, one slot of a long
#: table, and a table past the split cap
PAGED_SHAPES = [(8, 16, 64, 10, 128), (5, 4, 64, 6, 16), (1, 4, 64, 250, 16),
                (2, 4, 128, 40, 128), (1, 1, 32, 2000, 8),
                (64, 16, 64, 64, 16)]


def _attend_splits(t, splits, chunk):
    return [(s * chunk, min(t, (s + 1) * chunk)) for s in range(splits)]


@pytest.mark.parametrize("batch,heads,t", ATTEND_SHAPES,
                         ids=["%dx%dx%d" % s for s in ATTEND_SHAPES])
def test_attend_plan_covers_every_position_once_in_whole_tiles(batch, heads,
                                                               t):
    splits, chunk = _attend_plan(batch, heads, t, SMS)
    assert 1 <= splits <= ATTEND_MAX_SPLITS
    assert chunk % ATTEND_T_TILE == 0
    covered = numpy.zeros(t, numpy.int64)
    for begin, end in _attend_splits(t, splits, chunk):
        assert begin < end and begin % ATTEND_T_TILE == 0  # none empty
        assert (end - begin) % ATTEND_T_TILE == 0
        covered[begin:end] += 1
    assert (covered == 1).all()


def test_attend_plan_has_one_split_at_one_tile_and_a_ragged_last_one():
    assert _attend_plan(2, 2, ATTEND_T_TILE, SMS) == (1, ATTEND_T_TILE)
    splits, chunk = _attend_plan(1, 1, 32896, SMS)     # 257 tiles
    last = _attend_splits(32896, splits, chunk)[-1]
    assert last[1] - last[0] < chunk


@pytest.mark.parametrize("batch,heads,t", ATTEND_SHAPES,
                         ids=["%dx%dx%d" % s for s in ATTEND_SHAPES])
def test_attend_plan_fills_a_wave_and_bounds_the_workspace(batch, heads, t):
    splits, _ = _attend_plan(batch, heads, t, SMS)
    tiles = t // ATTEND_T_TILE
    # as many blocks as the wave asks for, as far as T has tiles and the
    # split cap allows (past the cap, whole tiles may leave half of it)
    assert batch * heads * splits >= min(ATTEND_WAVE * SMS,
                                         batch * heads * tiles,
                                         batch * heads * ATTEND_MAX_SPLITS
                                         // 2)
    # the f32 split states (D + 2 each) stay far below the codes they
    # summarise, at the narrowest head the gate admits (D = 32)
    head_dim = 32
    ws_bytes = 4 * batch * heads * splits * (head_dim + 2)
    assert ws_bytes <= 2 * batch * heads * head_dim * t // 16


def test_attend_plan_at_the_smoke_shape():
    """The dense int8-KV decode step's call: 6 splits of one tile, 768
    blocks, more than a wave of 132 SMs."""
    splits, chunk = _attend_plan(8, 16, 768, SMS)
    assert (splits, chunk) == (6, ATTEND_T_TILE)
    assert 8 * 16 * splits >= ATTEND_WAVE * SMS


def test_attend_plan_follows_the_sm_count():
    assert _attend_plan(2, 4, 8192, 33)[0] < _attend_plan(2, 4, 8192,
                                                          SMS)[0]


def _paged_splits(pb, pages, splits):
    return [(s * pages, min(pb, (s + 1) * pages)) for s in range(splits)]


@pytest.mark.parametrize("slots,heads,head_dim,pb,ps", PAGED_SHAPES,
                         ids=["%dx%dx%d-pb%d-ps%d" % s for s in PAGED_SHAPES])
def test_paged_plan_covers_every_page_once(slots, heads, head_dim, pb, ps):
    pages, splits, elements = _paged_plan(slots, heads, head_dim, pb, ps,
                                          SMS)
    assert 1 <= splits <= PAGED_MAX_SPLITS
    covered = numpy.zeros(pb, numpy.int64)
    for begin, end in _paged_splits(pb, pages, splits):
        assert begin < end  # whole pages, none empty
        covered[begin:end] += 1
    assert (covered == 1).all()
    assert elements == (slots * heads * splits * (head_dim + 2)
                        if splits > 1 else 0)


@pytest.mark.parametrize("ps", [16, 128])
def test_paged_live_splits_hold_every_visible_position_once(ps):
    """Each slot's visible positions, min(length + 1, PB * ps), fall in
    its first ceil(visible / split) splits, once each; every live split
    holds at least one (so its state has a real max), and every later
    split holds none (its blocks exit)."""
    pb = 4000 // ps + 2
    pages, splits, _ = _paged_plan(8, 16, 64, pb, ps, SMS)
    span = pages * ps
    for length in (0, span - 1, span, span + 1, 4000, pb * ps + 7):
        visible = min(length + 1, pb * ps)
        live = -(-visible // span)
        assert live <= splits
        seen = numpy.zeros(visible, numpy.int64)
        for s in range(splits):
            begin, end = s * span, min(visible, (s + 1) * span)
            if s < live:
                assert begin < end
                seen[begin:end] += 1
            else:
                assert begin >= visible
        assert (seen == 1).all()


def test_paged_plan_at_the_smoke_shape():
    """The paged decode step's call: one 128-token page a split, 10
    splits; the burst's lengths give 34 live splits x 16 heads = 544
    blocks, the lopsided one (1100 and seven of 0) 256."""
    pages, splits, elements = _paged_plan(8, 16, 64, 10, 128, SMS)
    assert (pages, splits) == (1, 10)
    assert 8 * 16 * splits >= PAGED_WAVE * SMS
    assert elements * 4 <= 8 * 10 * 128 * 16 * 64 * 2 // 8

    def blocks(lengths):
        return 16 * sum(-(-min(n + 1, 10 * 128) // 128) for n in lengths)

    assert blocks([0, 127, 128, 300, 511, 700, 1023, 1100]) == 544
    assert blocks([1100] + [0] * 7) == 256


def test_paged_plan_splits_finer_where_the_grid_is_small():
    # one slot of 4 heads on 16-token pages: 128 positions a split would
    # give 32 x 4 blocks; pages of 32 positions give 500
    pages, splits, _ = _paged_plan(1, 4, 64, 250, 16, SMS)
    assert pages * 16 < PAGED_SPLIT_POSITIONS
    assert 4 * splits >= SMS
    assert _paged_plan(1, 4, 64, 250, 16, 33)[0] > pages


def _merge(states):
    """The merge of split states [(m, l, acc)] in split order."""
    big = torch.stack([m for m, _, _ in states]).amax(0)
    weights = [torch.exp(m - big) for m, _, _ in states]
    lsum = sum(l * w for (_, l, _), w in zip(states, weights))
    acc = sum(a * w[..., None] for (_, _, a), w in zip(states, weights))
    return acc / lsum[..., None]


def _attend_split_emulation(q, k_q, k_scale, v_q, v_scale, mask, splits,
                            chunk):
    """K4's formula on a plan: each split's (m, l, acc) in f32, then the
    merge. q (B, 1, H, D); codes (B, H, D, T); scales (B, H, T); mask
    (T,) or (B, T)."""
    t = k_q.shape[-1]
    scores = torch.einsum("bhd,bhdt->bht", q[:, 0].float(), k_q.float()) \
        * k_scale + (mask if mask.dim() == 1 else mask[:, None, :])
    states = []
    for begin, end in _attend_splits(t, splits, chunk):
        s = scores[..., begin:end]
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        acc = torch.einsum("bhdt,bht->bhd", v_q[..., begin:end].float(),
                           p * v_scale[..., begin:end])
        states.append((m, p.sum(-1), acc))
    return _merge(states)[:, None]


def _attend_problem(batch, heads, head_dim, t, seed):
    rng = numpy.random.RandomState(seed)
    q = (rng.randn(batch, 1, heads, head_dim)
         / math.sqrt(head_dim)).astype(numpy.float32)
    codes = [rng.randint(-127, 128, (batch, heads, head_dim, t))
             .astype(numpy.int8) for _ in range(2)]
    scales = [rng.uniform(0.005, 0.02, (batch, heads, t))
              .astype(numpy.float32) for _ in range(2)]
    return q, (codes[0], scales[0], codes[1], scales[1])


def _attend_mask(kind, batch, t):
    pos = numpy.arange(t)
    visible = numpy.ones((batch, t), bool)
    if kind == "masked-split":      # the second 128-tile of every row
        visible[:, 128:256] = False
    elif kind == "masked-row":      # row 1 sees nothing
        visible[:, :] = pos[None, :] <= numpy.array([300, -1, 40])[:, None]
    else:                           # per-row lengths, one inside tile 0
        visible[:, :] = pos[None, :] <= numpy.array([5, 260, 639])[:, None]
    return numpy.where(visible, 0.0, -1e30).astype(numpy.float32)


@pytest.mark.parametrize("sms", [2, SMS], ids=["ragged-3-splits",
                                               "5-splits"])
@pytest.mark.parametrize("kind", ["masked-split", "masked-row", "per-row"])
def test_attend_split_formula_matches_the_jax_kernel(kind, sms):
    batch, heads, head_dim, t = 3, 2, 32, 640
    splits, chunk = _attend_plan(batch, heads, t, sms)
    assert splits > 1
    q, kv = _attend_problem(batch, heads, head_dim, t, seed=5)
    mask = _attend_mask(kind, batch, t)
    ref = numpy.asarray(jquant._pallas_cache_attend(
        jnp.asarray(q), *map(jnp.asarray, kv), jnp.asarray(mask),
        interpret=True))
    args = [torch.from_numpy(a) for a in (q, *kv, mask)]
    out = _attend_split_emulation(*args, splits, chunk)
    numpy.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    # the port's plain version (what the wrapper runs on the CPU) computes
    # the same function in one pass
    torch.testing.assert_close(
        tquant.int8_cache_attend(*args, use_pallas=True), out, rtol=0,
        atol=ATOL)
    if kind == "masked-row":        # the uniform softmax over the lane
        uniform = (kv[2][1].astype(numpy.float32)
                   * kv[3][1][:, None, :]).mean(-1)
        numpy.testing.assert_allclose(ref[1, 0], uniform, atol=ATOL,
                                      rtol=0)


PS = 8


def _paged_problem(lengths, pb, heads=4, head_dim=8, seed=3):
    """Live pages 1.. per slot in logical order, the rest of each row
    padded with the scratch page 0."""
    rng = numpy.random.RandomState(seed)
    table = numpy.zeros((len(lengths), pb), numpy.int32)
    nxt = 1
    for s, n in enumerate(lengths):
        for p in range(min(n // PS + 1, pb)):
            table[s, p] = nxt
            nxt += 1
    shape = (nxt + 1, PS, heads, head_dim)
    return (rng.randn(len(lengths), heads, head_dim).astype(numpy.float32),
            rng.randn(*shape).astype(numpy.float32),
            rng.randn(*shape).astype(numpy.float32), table,
            numpy.asarray(lengths, numpy.int32))


def _paged_split_emulation(q, k, v, table, lengths, ps, pages):
    """K1's formula on a plan: each slot's live splits, ceil(visible /
    (pages * ps)) of them, each an (m, l, acc) over its visible
    positions, then the merge; later splits are never touched."""
    slots, heads, head_dim = q.shape
    pb = table.shape[1]
    span = pages * ps
    outs = []
    for s in range(slots):
        visible = min(int(lengths[s]) + 1, pb * ps)
        states = []
        for begin in range(0, visible, span):
            pos = torch.arange(begin, min(visible, begin + span))
            rows = table[s, pos // ps].long()
            kr = k[rows, pos % ps].float()                  # (n, H, D)
            vr = v[rows, pos % ps].float()
            sc = torch.einsum("hd,nhd->hn", q[s].float(), kr) \
                / math.sqrt(head_dim)
            m = sc.amax(-1)
            p = torch.exp(sc - m[:, None])
            states.append((m, p.sum(-1), torch.einsum("hn,nhd->hd", p, vr)))
        outs.append(_merge(states))
    return torch.stack(outs)


@pytest.mark.parametrize("lengths,pb,sms", [
    ([0, 3 * PS, 2 * PS - 1, 40], 6, SMS),    # length 0, page boundaries
    ([0, 3 * PS, 3 * PS - 1, 40], 6, 8),      # 3-page splits: 24 +- 1
    ([0, 5 * PS + 3], 5, SMS),                # a length past the table
], ids=["one-page-splits", "three-page-splits", "past-the-table"])
def test_paged_split_formula_matches_the_jax_kernel(lengths, pb, sms):
    q, k, v, table, lens = _paged_problem(lengths, pb)
    pages, splits, _ = _paged_plan(len(lengths), q.shape[1], q.shape[2], pb,
                                   PS, sms)
    assert splits > 1
    ref = numpy.asarray(jpgatt.paged_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lens), page_size=PS, interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v, table, lens)]
    out = _paged_split_emulation(*args, PS, pages)
    numpy.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(tpgatt.paged_attend(*args, page_size=PS), out,
                               rtol=0, atol=ATOL)


def _stage_positions(head_dim):
    """The positions a stage of K3's (and K4's) int8 tile holds at this
    head width (``csrc/int8_tile.cuh``'s stage_positions)."""
    for tps, widest in ((128, 128), (64, 256), (32, 512)):
        if head_dim <= widest:
            return tps
    return 16


def _paged_int8_problem(lengths, pb, head_dim=32, heads=4, seed=11):
    """Live pages 1.. per slot in logical order, the rest of each row
    padded with the scratch page 0; random int8 codes and positive f32
    scales, head-major (P, H, D, ps) and (P, H, ps); q pre-scaled."""
    rng = numpy.random.RandomState(seed)
    table = numpy.zeros((len(lengths), pb), numpy.int32)
    nxt = 1
    for s, n in enumerate(lengths):
        for p in range(min(n // PS + 1, pb)):
            table[s, p] = nxt
            nxt += 1
    q = (rng.randn(len(lengths), heads, head_dim)
         / math.sqrt(head_dim)).astype(numpy.float32)
    pool = []
    for _ in range(2):
        pool += [rng.randint(-127, 128, (nxt, heads, head_dim, PS))
                 .astype(numpy.int8),
                 rng.uniform(0.005, 0.02, (nxt, heads, PS))
                 .astype(numpy.float32)]
    return q, pool, table, numpy.asarray(lengths, numpy.int32)


def _paged_int8_split_emulation(q, k_q, k_scale, v_q, v_scale, table,
                                lengths, ps, pages):
    """K3's formula on a plan: each slot's live splits, each walked in
    stages of the tile's width. A stage reads every position it holds
    whose page lies in the table (positions past ``lengths`` included:
    what the pool holds there is stale) and NaN scales past the table,
    then selects: an invisible position's score is -inf and its weight
    0. The stages meet by the online-softmax rescale, the splits by the
    merge."""
    slots, heads, head_dim = q.shape
    pb = table.shape[1]
    span, tps = pages * ps, _stage_positions(head_dim)
    outs = []
    for s in range(slots):
        visible = min(int(lengths[s]) + 1, pb * ps)
        states = []
        for begin in range(0, visible, span):
            n_pos = min(visible - begin, span)
            m = torch.full((heads,), -math.inf)
            l = torch.zeros(heads)
            acc = torch.zeros(heads, head_dim)
            for first in range(0, n_pos, tps):
                pos = begin + first + torch.arange(tps)
                in_table = pos < pb * ps
                rows = table[s, torch.clamp(pos // ps, max=pb - 1)].long()
                off = pos % ps

                def read(codes, scale):
                    c = codes[rows, :, :, off].float()          # (t, H, D)
                    sc = torch.where(in_table[:, None], scale[rows, :, off],
                                     math.nan)               # (t, H)
                    return c, sc

                kc, ks = read(k_q, k_scale)
                vc, vs = read(v_q, v_scale)
                counts = (torch.arange(tps) < n_pos - first)[:, None]
                sc = torch.where(counts, torch.einsum(
                    "hd,thd->th", q[s].float(), kc) * ks, -math.inf)
                m_new = torch.maximum(m, sc.amax(0))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new)
                w = torch.where(counts, p * vs, 0.0)
                l = l * alpha + p.sum(0)
                acc = acc * alpha[:, None] + torch.einsum("th,thd->hd", w, vc)
                m = m_new
            states.append((m, l, acc))
        outs.append(_merge(states))
    return torch.stack(outs)


PAGED_INT8_CASES = pytest.mark.parametrize("lengths,pb,sms,head_dim", [
    ([0, 3 * PS, 2 * PS - 1, 40], 6, SMS, 32),   # length 0, page boundaries
    ([0, 3 * PS, 3 * PS - 1, 40], 6, 8, 32),     # 3-page splits: 24 +- 1
    ([0, 5 * PS + 3], 5, SMS, 32),               # a length past the table
    ([0, 3 * PS, 3 * PS - 1, 40], 6, 8, 96),
    # 16-page splits of two 64-position stages at D = 256: one and two
    # splits, a full table row, a split of one visible position
    ([0, 130, 16 * PS - 1, 16 * PS, 40 * PS - 1], 40, 1, 256),
], ids=["one-page-splits", "three-page-splits", "past-the-table", "d96",
        "d256-two-stages"])


@PAGED_INT8_CASES
def test_paged_int8_split_formula_matches_the_jax_kernel(lengths, pb, sms,
                                                         head_dim):
    q, pool, table, lens = _paged_int8_problem(lengths, pb, head_dim)
    pages, splits, _ = _paged_plan(len(lengths), q.shape[1], head_dim, pb,
                                   PS, sms)
    assert splits > 1
    ref = numpy.asarray(jpgatt.paged_attend_int8(
        jnp.asarray(q), *map(jnp.asarray, pool), jnp.asarray(table),
        jnp.asarray(lens), page_size=PS, interpret=True))
    args = [torch.from_numpy(a) for a in (q, *pool, table, lens)]
    out = _paged_int8_split_emulation(*args, PS, pages)
    numpy.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(
        tpgatt.paged_attend_int8(*args, page_size=PS), out, rtol=0,
        atol=ATOL)


def test_paged_int8_invisible_nan_scales_change_nothing():
    """NaN scales (and extreme codes) on the scratch page and past
    ``lengths`` in every slot's last live page: the emulation and the
    plain version select them out, so both give the clean pool's output,
    finite. (The JAX kernel multiplies its zero weights by v_scale, so
    it is not the reference here.)"""
    lengths, pb = [0, 3 * PS, 3 * PS - 1, 40], 6
    q, pool, table, lens = _paged_int8_problem(lengths, pb, 32)
    pages, _, _ = _paged_plan(len(lengths), q.shape[1], 32, pb, PS, 8)
    clean = [torch.from_numpy(a) for a in (q, *pool, table, lens)]
    poisoned = [a.clone() for a in clean]
    kq, ks, vq, vs = poisoned[1:5]
    for s, n in enumerate(lengths):
        last = table[s, min(n // PS, pb - 1)]
        for codes, scale in ((kq, ks), (vq, vs)):
            codes[last, :, :, n % PS + 1:] = -128
            scale[last, :, n % PS + 1:] = math.nan
    for codes, scale in ((kq, ks), (vq, vs)):
        codes[0] = 127
        scale[0] = math.nan
    for fn in (lambda a: _paged_int8_split_emulation(*a, PS, pages),
               lambda a: tpgatt.paged_attend_int8(*a, page_size=PS)):
        want, got = fn(clean), fn(poisoned)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
