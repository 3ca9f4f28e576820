"""Why the flash kernels' f32 route takes three TF32 products for each
f32 product (``veles_tpu_torch/ops/csrc/flash_attention.cu``: fwd_tf32,
K7; ``flash_attention_bwd.cu``: dkv_tf32 and dq_tf32, K8 and K9; the
shared arithmetic in ``tf32x3.cuh``), shown on the CPU.

The tensor cores multiply TF32 values: the top 19 bits of an f32 (10 bits
of mantissa). The route splits each f32 operand into hi and lo and sums
lo * hi + hi * lo + hi * hi: dP = dO V^T with hi = tf32(x) and lo =
tf32(x - hi) rounded to nearest, the other products with both parts
truncated, as the mma reads them. Here that arithmetic is emulated with
torch bit operations (rounding to nearest with ties away from zero, as
the kernels round) and the sums taken in float64, so that only the
split's error shows: the flash backward's five products (S = Q K^T, dP =
dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) at a small causal shape, run
as the kernels split them, as 3xTF32 rounded to nearest throughout, as
one TF32 product and in float64, are held against the float64 run under
chip_smoke.py's row rule; the forward's two (S = Q K^T, O = P V with P
unrounded) likewise under the forward's tighter rule."""

import math

import numpy
import pytest
import torch

torch.set_num_threads(1)

#: chip_smoke.py's FLASH_F32_BWD_RTOL: each row (one position's head_dim
#: values for one head) of dK, dV or dQ within this share of its own
#: norm, a row below FLASH_ROW_FLOOR of the median row's norm held
#: against that floor
FLASH_F32_BWD_RTOL = 1e-4
#: chip_smoke.py's K7_F32_RTOL: the same rule for the f32 forward's O
K7_F32_RTOL = 1e-5
FLASH_ROW_FLOOR = 1e-2
#: (batch, heads, T, head_dim), causal and full
SHAPE = (1, 2, 256, 128)


def tf32(x):
    """f32 ``x`` rounded to TF32 as the kernels' tf32_rna rounds it: half
    of the lowest kept bit added to the magnitude's bits, the low 13 bits
    cleared."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """f32 ``x`` as the mma reads it: the low 13 bits dropped."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def product(a, b, mode):
    """a @ b of f32 operands, each product term exact and summed in
    float64: "f64" the operands as they are, "tf32" one product of the
    rounded operands, "nearest" and "trunc" the split's three products
    with both parts rounded to nearest or truncated."""
    if mode == "f64":
        return a.double() @ b.double()
    cut = tf32_trunc if mode == "trunc" else tf32
    a_hi, b_hi = cut(a), cut(b)
    out = a_hi.double() @ b_hi.double()
    if mode != "tf32":
        a_lo, b_lo = cut(a - a_hi), cut(b - b_hi)
        out = a_lo.double() @ b_hi.double() + a_hi.double() @ b_lo.double() \
            + out
    return out


def _problem(causal):
    rng = numpy.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(*SHAPE).astype(numpy.float32))
                   for _ in range(4))
    # the forward's statistics, as the kernels receive them: f32
    scale = 1.0 / math.sqrt(SHAPE[-1])
    mask = torch.ones(SHAPE[2], SHAPE[2], dtype=torch.bool)
    if causal:
        mask = mask.tril()
    s = (q.double() @ k.double().transpose(-1, -2) * scale).masked_fill(
        ~mask, -math.inf)
    o = torch.softmax(s, -1) @ v.double()
    lse = torch.logsumexp(s, -1).float()
    di = (o * do.double()).sum(-1).float()
    return q, k, v, do, lse, di, mask, scale


def backward(mode, causal=True):
    """(dV, dK, dQ) of the f32 route's formulas with every product taken
    as ``mode`` says ("kernels": dP rounded to nearest, the others
    truncated): P = exp(s / sqrt(D) - lse) and dS = P (dP - di) /
    sqrt(D), both kept in f32 off the float64 run."""
    q, k, v, do, lse, di, mask, scale = _problem(causal)
    others, dp_mode = ("trunc", "nearest") if mode == "kernels" \
        else (mode, mode)
    s = product(q, k.transpose(-1, -2), others) * scale
    p = torch.exp(s - lse.double()[..., None]).masked_fill(~mask, 0.0)
    dp = product(do, v.transpose(-1, -2), dp_mode)
    ds = p * (dp - di.double()[..., None]) * scale
    if mode != "f64":
        p, ds = p.float(), ds.float()
    return (product(p.transpose(-1, -2), do, others),
            product(ds.transpose(-1, -2), q, others),
            product(ds, k, others))


def row_errors(out, ref):
    """Each row's error relative to its own norm, floored at
    FLASH_ROW_FLOOR of the median row's norm: (batch, heads, T)."""
    norms = ref.norm(dim=-1)
    return (out - ref).norm(dim=-1) / norms.clamp_min(
        FLASH_ROW_FLOOR * norms.median())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 step above 1
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1.0, one, -one, one, 3.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    assert torch.equal(tf32_trunc(x), torch.tensor(
        [1.0, 1.0, -1.0, 1.0, 3.0, -0.0], dtype=torch.float32))
    # the split keeps 22 bits rounded to nearest, 20 truncated
    y = torch.from_numpy(numpy.random.RandomState(1).randn(4096)
                         .astype(numpy.float32))
    for cut, bits in ((tf32, 22), (tf32_trunc, 20)):
        hi = cut(y)
        lo = cut(y - hi)
        assert ((y.double() - hi.double() - lo.double()).abs()
                <= 2.0 ** -bits * y.double().abs()).all()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("mode", ["kernels", "nearest"])
def test_three_tf32_products_meet_the_f32_row_rule(mode, causal):
    """3xTF32, as the kernels split (dP to nearest, the rest truncated)
    and rounded to nearest throughout, holds dK, dV and dQ within
    FLASH_F32_BWD_RTOL of float64 on every row, and within a twentieth of
    it on every row but the causal first query's dQ (zero in exact
    arithmetic: one key, dP = di, so the row is the rounding of dP - di
    against the floor)."""
    rows = [row_errors(got, want) for got, want in
            zip(backward(mode, causal), backward("f64", causal))]
    for name, errors in zip(("dV", "dK", "dQ"), rows):
        assert errors.max().item() <= FLASH_F32_BWD_RTOL, name
    first = 1 if causal else 0
    for errors in rows[:2] + [rows[2][..., first:]]:
        assert errors.max().item() <= FLASH_F32_BWD_RTOL / 20


def test_one_tf32_product_misses_the_f32_row_rule():
    """One TF32 product for each f32 product misses the rule on dK, dV
    and dQ alike, by more than 5x: why the route takes three."""
    ref = backward("f64")
    single = [row_errors(got, want) for got, want in
              zip(backward("tf32"), ref)]
    for name, rows in zip(("dV", "dK", "dQ"), single):
        assert rows.max().item() > 5 * FLASH_F32_BWD_RTOL, name


def test_truncating_dp_misses_the_first_row():
    """Truncated throughout, dK, dV and every dQ row after the first
    still meet the rule, but the first query's dQ (the rounding of dP - di
    against the floor) misses it: why dP alone takes the split rounded to
    nearest."""
    rows = [row_errors(got, want) for got, want in
            zip(backward("trunc"), backward("f64"))]
    for errors in rows[:2] + [rows[2][..., 1:]]:
        assert errors.max().item() <= FLASH_F32_BWD_RTOL / 20
    assert rows[2][..., 0].max().item() > 2 * FLASH_F32_BWD_RTOL


#: the forward's products as fwd_tf32 splits them (kNearestS, kNearestV:
#: both truncated)
FORWARD_KERNELS = ("trunc", "trunc")


def forward(s_mode, v_mode, causal=True):
    """O of the f32 route's forward with S = Q K^T taken as ``s_mode``
    and P V as ``v_mode`` say (``product``'s modes): the softmax off the
    float64 sums, P kept in f32 (unrounded, as the f32 plain version
    keeps it) unless both products are "f64"."""
    q, k, v, _, _, _, mask, scale = _problem(causal)
    s = (product(q, k.transpose(-1, -2), s_mode) * scale).masked_fill(
        ~mask, -math.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if (s_mode, v_mode) != ("f64", "f64"):
        p = p.float()
    return product(p, v, v_mode) / l


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("modes", [FORWARD_KERNELS, ("nearest", "nearest")],
                         ids=["kernels", "nearest"])
def test_three_tf32_products_meet_the_forward_row_rule(modes, causal):
    """3xTF32 as fwd_tf32 splits both products (truncated), and rounded
    to nearest throughout, holds every row of O within K7_F32_RTOL of
    float64 with room to spare: within a fifth of it, so that the card's
    f32 sums and the plain version's own rounding fit beside it."""
    rows = row_errors(forward(*modes, causal=causal),
                      forward("f64", "f64", causal))
    assert rows.max().item() <= K7_F32_RTOL / 5


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("single", ["S", "PV"])
def test_one_tf32_product_misses_the_forward_row_rule(single, causal):
    """One TF32 product for S = Q K^T alone, or for P V alone, the other
    exact, misses the forward's rule by more than 10x: why the route
    takes three for each."""
    modes = ("tf32", "f64") if single == "S" else ("f64", "tf32")
    rows = row_errors(forward(*modes, causal=causal),
                      forward("f64", "f64", causal))
    assert rows.max().item() > 10 * K7_F32_RTOL
