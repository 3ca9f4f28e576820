"""Attention: the sequence-model tier's blocks and flash attention.

The port of ``veles_tpu/ops/attention.py:26-151``:

- :func:`attention`, single-device attention over (B, T, H, D) tensors.
  The JAX package computes it with XLA except where :func:`uses_flash`
  holds (4096 positions and more on both sides, a head width that is a
  multiple of 128): there it runs the library Pallas flash-attention
  kernel. The port keeps that rule. On a CUDA tensor where it holds the
  call runs :func:`flash_attention`, the hand-written kernels below;
  everywhere else :func:`plain_attention`, in f32.
- :func:`attention_block` and :func:`ffn_block`, the self-attention and
  feed-forward blocks of the training tier, under the engine's precision
  policy (``ops/gemm.compute_operands``): level 0 runs the projections
  on bf16 operands with an f32 accumulator and the core through
  :func:`attention`; levels 1 and 2 keep f32 and run
  :func:`_precise_attention`, never the kernels. The projections take
  the plain route of ``ops/gemm`` (``torch.matmul`` in f32), as the JAX
  package's take ``lax.dot_general``.

The three flash kernels replace the three ``pl.pallas_call``s of the
installed JAX's ``jax/experimental/pallas/ops/tpu/flash_attention.py``:

- K7 :func:`flash_attention_fwd` (``csrc/flash_attention.cu``) for
  ``_flash_attention_kernel``: the causal or full softmax(QK^T s) V and
  one f32 logsumexp per query row;
- K8 :func:`flash_attention_dkv` (``csrc/flash_attention_bwd.cu``) for
  ``_flash_attention_dkv_kernel``: dK and dV;
- K9 :func:`flash_attention_dq` (same source) for
  ``_flash_attention_dq_kernel``: dQ.

:class:`_FlashAttention` is the custom VJP: K7 forward, K8 and K9
backward, with di = rowsum(O * dO) a plain reduction between them, as
JAX computes it outside its kernels. Every kernel wrapper runs its plain
version for CPU tensors only; for CUDA tensors it launches its kernel or
raises, and counts its launches in ``launches``. The kernels read q, k,
v and dO in place through their strides (the qkv projection's split
views), so nothing is transposed or copied.

Sequence parallelism over the mesh's ``seq`` axis (``attention.py:
156-277``), on this rank's block of the sequence:

- :func:`ring_attention`: the K/V blocks rotate around the axis by
  ``collectives.ppermute`` while an online-softmax accumulator absorbs
  each, in plain torch ops in f32 (the JAX package's einsums, no
  kernel), and autograd differentiates the loop through the reverse
  ``ppermute``;
- :func:`ulysses_attention`: one ``all_to_all`` trades the sequence
  blocks for head blocks, :func:`attention` runs on the whole sequence
  of this rank's heads (K7, and K8 and K9 backward, where the flash rule
  holds), and the inverse ``all_to_all`` restores the sequence blocks.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from veles_tpu_torch.core.config import root
from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops.gemm import _plain_product, compute_operands

#: the JAX package's flash-attention threshold (``attention.py:58``)
FLASH_MIN_T = 4096
#: the flash kernel tiles head_dim onto 128-wide blocks
#: (``attention.py:59``); the CUDA kernels take every multiple of it
FLASH_HEAD_MULTIPLE = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def uses_flash(t_q, t_k, head_dim):
    """The JAX package's rule for the flash kernel
    (``_use_pallas_flash``, its backend check left aside): ``t_q`` and
    ``t_k`` at least :data:`FLASH_MIN_T` and ``head_dim`` a multiple of
    :data:`FLASH_HEAD_MULTIPLE`."""
    return (t_q >= FLASH_MIN_T and t_k >= FLASH_MIN_T
            and head_dim % FLASH_HEAD_MULTIPLE == 0)


def plain_attention(q, k, v, causal=False):
    """Attention over (B, T, H, D) tensors in f32, scaled by 1/sqrt(D),
    returned in q's dtype. ``causal`` aligns the query rows with the
    LAST ``t_q`` key positions: query j sees keys up to ``t_k - t_q +
    j``, which is the prefix-offset mask of a tail prefill."""
    t_q, t_k = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones((t_q, t_k), dtype=torch.bool,
                          device=q.device).tril(t_k - t_q)
        scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attention(q, k, v, causal=False):
    """Single-device attention over (B, T, H, D) tensors, scaled by
    1/sqrt(D), returned in q's dtype. On a CUDA tensor where
    :func:`uses_flash` holds it runs :func:`flash_attention` (K7, and K8
    and K9 in its backward), which raises on a causal call with ``t_q !=
    t_k``: its mask is key <= query. Everywhere else it runs
    :func:`plain_attention`."""
    if q.device.type == "cuda" and uses_flash(q.shape[1], k.shape[1],
                                               q.shape[-1]):
        return flash_attention(q, k, v, causal)
    return plain_attention(q, k, v, causal)


# -- the training tier's blocks (attention.py:62-151) -------------------------

#: activations usable inside the FFN block; gelu is jax.nn's default tanh
#: approximation
_FFN_ACTIVATIONS = {
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
    "relu": torch.relu,
    "tanh": torch.tanh,
    "linear": lambda h: h,
}


def _level(precision_level):
    if precision_level is None:
        return root.common.engine.get("precision_level", 0)
    return precision_level


def attention_block(x, w_qkv, b_qkv, w_out, b_out, heads, causal,
                    residual=False, precision_level=None):
    """The self-attention block (``attention.py:62-100``): the fused qkv
    projection, multi-head attention, the out projection and, with
    ``residual``, the block input added. ``x`` (B, T, E) float32;
    weights (E, 3E) and (E, E), biases float32. Level 0 rounds q, k and
    v to bf16 and runs :func:`attention`; levels 1 and 2 keep f32 and run
    :func:`_precise_attention`. Returns float32."""
    level = _level(precision_level)
    batch, t, embed = x.shape
    xc, wqkv, wout = compute_operands(x, w_qkv, w_out,
                                      precision_level=level)
    qkv = _plain_product(xc, wqkv) + b_qkv
    shape = (batch, t, heads, embed // heads)
    q, k, v = (part.reshape(shape)
               for part in qkv.to(xc.dtype).split(embed, dim=-1))
    if level == 0:
        out = attention(q, k, v, causal=causal)
    else:
        out = _precise_attention(q, k, v, causal)
    out = _plain_product(out.reshape(batch, t, embed).to(xc.dtype),
                         wout) + b_out
    return x + out if residual else out


def ffn_block(x, w1, b1, w2, b2, activation="gelu", residual=True,
              precision_level=None):
    """The position-wise feed-forward block (``attention.py:114-137``):
    ``act(x @ w1 + b1) @ w2 + b2`` (+ ``x`` with ``residual``), the
    products on the level's operands with an f32 accumulator, the bias
    adds, activation and residual in f32."""
    act = _FFN_ACTIVATIONS[activation]
    xc, w1c, w2c = compute_operands(x, w1, w2,
                                    precision_level=_level(precision_level))
    h = _plain_product(xc, w1c) + b1
    out = _plain_product(act(h).to(xc.dtype), w2c) + b2
    return x + out if residual else out


def _precise_attention(q, k, v, causal):
    """The level-1/2 core (``attention.py:140-151``): f32 scores, the
    causal mask as a -1e30 score, f32 softmax, the probabilities cast to
    q's type before the value product, the result in q's type."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(),
                        v.float()).to(q.dtype)


# -- flash attention: K7, K8, K9 ----------------------------------------------

def _check_flash(name, q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("%s wants q (B, Tq, H, D) and k, v (B, Tk, H, D), "
                         "got %s, %s, %s" % (name, tuple(q.shape),
                                             tuple(k.shape), tuple(v.shape)))
    if (q.shape[0], q.shape[2], q.shape[3]) \
            != (k.shape[0], k.shape[2], k.shape[3]) \
            or min(q.shape) < 1 or min(k.shape) < 1:
        raise ValueError("%s: q %s and k %s differ in batch, heads or head "
                         "width, or are empty" % (name, tuple(q.shape),
                                                  tuple(k.shape)))
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("%s takes float32 or bfloat16 q, k, v of one type, "
                        "got %s, %s, %s" % (name, q.dtype, k.dtype, v.dtype))
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("%s: the causal mask (key <= query) wants Tq == "
                         "Tk, got %d and %d" % (name, q.shape[1],
                                                k.shape[1]))
    devices = {q.device, k.device, v.device}
    if len(devices) != 1 or q.device.type not in ("cpu", "cuda"):
        raise ValueError("%s runs on cuda or cpu tensors, all on one "
                         "device, got %s" % (name, sorted(map(str, devices))))


def _check_rows(name, *tensors):
    """What the kernels read in place: a head width that is a multiple of
    :data:`FLASH_HEAD_MULTIPLE`, the last axis contiguous, every other
    stride and the pointer 16-byte aligned (the kernels load 16 bytes at
    a time; the wgmma kernels' tensor maps want the same)."""
    for t in tensors:
        if t.shape[-1] % FLASH_HEAD_MULTIPLE:
            raise ValueError("%s's kernels take head widths that are "
                             "multiples of %d, got %d"
                             % (name, FLASH_HEAD_MULTIPLE, t.shape[-1]))
        size = t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % 16 \
                or any(s * size % 16 for s in t.stride()[:3]):
            raise ValueError("%s's kernel wants the head axis contiguous and "
                             "the other strides and the pointer 16-byte "
                             "aligned, got strides %s" % (name, t.stride()))


def _check_stats(name, q, *stats):
    want = (q.shape[0], q.shape[2], q.shape[1])
    for t in stats:
        if tuple(t.shape) != want or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError("%s wants contiguous float32 row statistics of "
                             "shape %s on %s, got %s %s on %s"
                             % (name, want, q.device, t.dtype,
                                tuple(t.shape), t.device))


def _strides(t):
    return t.stride()[:3]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _scores(q, k, causal):
    """f32 scores (B, H, Tq, Tk) scaled by 1/sqrt(D), -inf past the
    flash kernels' causal mask (key <= query)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s, scale


def _flash_attention_fwd_plain(q, k, v, causal=False):
    """K7's plain version: the softmax in f32, P = exp(s - max) rounded
    to v's type before P V (``flash_attention.py:471``), the sum of the
    unrounded P dividing the f32 product; O in q's type and the
    logsumexp max + log(sum) (B, H, Tq) in f32."""
    s, _ = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.squeeze(-1).transpose(1, 2)[..., None]
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _flash_p_ds(q, k, v, do, lse, di, causal):
    """The backward's f32 P = exp(s - lse) and dS = P (dP - di) / sqrt(D),
    dP = dO V^T (``flash_attention.py:880-912``)."""
    s, scale = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - di[..., None]) * scale


def _flash_attention_dkv_plain(q, k, v, do, lse, di, causal=False):
    """K8's plain version: dV = P^T dO and dK = dS^T Q with P and dS
    rounded to the operands' type (``:900``, ``:918``), f32 sums."""
    p, ds = _flash_p_ds(q, k, v, do, lse, di, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_attention_dq_plain(q, k, v, do, lse, di, causal=False):
    """K9's plain version: dQ = dS K with dS rounded to k's type
    (``:1258``), f32 sums."""
    _, ds = _flash_p_ds(q, k, v, do, lse, di, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def _row_dot(o, do):
    """di = rowsum(O * dO) in f32, (B, H, Tq) contiguous
    (``flash_attention.py:273-275``)."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def plain_flash_backward(q, k, v, o, lse, do, causal=False):
    """The flash backward's formulas in f32 (the plain versions of K8
    and K9 after di): ``(dq, dk, dv)`` in the operands' types."""
    di = _row_dot(o, do)
    dk, dv = _flash_attention_dkv_plain(q, k, v, do, lse, di, causal)
    return _flash_attention_dq_plain(q, k, v, do, lse, di, causal), dk, dv


_FORWARD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                     + [ctypes.c_float] + [ctypes.c_longlong] * 9
                     + [ctypes.c_void_p])


def _count_launch(fn, q):
    """Book a K7, K8 or K9 launch: every launch in ``launches``, the f32
    route's also in ``launches_f32``."""
    fn.launches += 1
    if q.dtype == torch.float32:
        fn.launches_f32 += 1


def flash_attention_fwd(q, k, v, causal=False):
    """K7: ``(out, lse)`` of attention over q (B, Tq, H, D) and k, v
    (B, Tk, H, D), float32 or bfloat16, scaled by 1/sqrt(D); ``causal``
    is key <= query and wants Tq == Tk. ``out`` is in q's type,
    contiguous; ``lse`` the f32 logsumexp of each row's scaled scores,
    (B, H, Tq). On a CUDA tensor the kernel launches
    (:attr:`flash_attention_fwd.launches` counts it, and the f32 route's
    launches also :attr:`flash_attention_fwd.launches_f32`) and reads q,
    k, v in place: bf16 at head width 128 or 256 through TMA and wgmma,
    at other multiples of 128 with a grid axis over 128-wide output
    chunks; float32 at every multiple of 128 in 3xTF32 on the tensor
    cores, P unrounded, with the same chunk axis
    (``csrc/flash_attention.cu``). On a CPU tensor the plain version
    runs."""
    _check_flash("flash_attention_fwd", q, k, v, causal)
    if q.device.type == "cpu":
        return _flash_attention_fwd_plain(q, k, v, causal)
    _check_rows("flash_attention_fwd", q, k, v)
    (batch, t_q, heads, dim), t_k = q.shape, k.shape[1]
    out = torch.empty((batch, t_q, heads, dim), dtype=q.dtype,
                      device=q.device)
    lse = torch.empty((batch, heads, t_q), dtype=torch.float32,
                      device=q.device)
    fn = _build.function("flash_attention", "veles_flash_fwd",
                         _FORWARD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), batch, heads, t_q, t_k, dim, int(causal),
             _DTYPES[q.dtype], 1.0 / math.sqrt(dim), *_strides(q),
             *_strides(k), *_strides(v), _stream(q))
    if err:
        raise RuntimeError("flash_attention_fwd kernel launch failed: CUDA "
                           "error %d (negative: a CUresult of a tensor map)"
                           % err)
    _count_launch(flash_attention_fwd, q)
    return out, lse


#: kernel launches since the last reset (every type, and float32's)
flash_attention_fwd.launches = flash_attention_fwd.launches_f32 = 0


def _check_backward(name, q, k, v, do, lse, di, causal):
    _check_flash(name, q, k, v, causal)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("%s wants dO like q %s %s, got %s %s"
                         % (name, q.dtype, tuple(q.shape), do.dtype,
                            tuple(do.shape)))
    _check_stats(name, q, lse, di)
    if q.device.type == "cuda":
        _check_rows(name, q, k, v, do)


def _backward_args(q, k, v, do, lse, di, causal):
    (batch, t_q, heads, dim), t_k = q.shape, k.shape[1]
    return ([q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), di.data_ptr()],
            [batch, heads, t_q, t_k, dim, int(causal), _DTYPES[q.dtype],
             1.0 / math.sqrt(dim), *_strides(q), *_strides(k),
             *_strides(v), *_strides(do), _stream(q)])


_BACKWARD_ARGTYPES = ([ctypes.c_int] * 7 + [ctypes.c_float]
                      + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])


def flash_attention_dkv(q, k, v, do, lse, di, causal=False):
    """K8: ``(dk, dv)`` of the flash forward, from q, k, v, the output
    gradient ``do`` (like q), the forward's ``lse`` and ``di`` = rowsum(O
    * dO), both f32 (B, H, Tq) contiguous. On a CUDA tensor the kernel
    launches (:attr:`flash_attention_dkv.launches` counts it, and the f32
    route's launches also :attr:`flash_attention_dkv.launches_f32`) and
    reads q, k, v and dO in place: bfloat16 at head width 128 through TMA
    and wgmma, at other multiples of 128 with a grid axis over 128-wide
    output chunks; float32 at every multiple of 128 in 3xTF32 on the
    tensor cores, P and dS unrounded (``csrc/flash_attention_bwd.cu``). On
    a CPU tensor the plain version runs."""
    _check_backward("flash_attention_dkv", q, k, v, do, lse, di, causal)
    if q.device.type == "cpu":
        return _flash_attention_dkv_plain(q, k, v, do, lse, di, causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    ptrs, rest = _backward_args(q, k, v, do, lse, di, causal)
    fn = _build.function("flash_attention_bwd", "veles_flash_dkv",
                         [ctypes.c_void_p] * 8 + _BACKWARD_ARGTYPES)
    err = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *rest)
    if err:
        raise RuntimeError("flash_attention_dkv kernel launch failed: CUDA "
                           "error %d (negative: a CUresult of a tensor map)"
                           % err)
    _count_launch(flash_attention_dkv, q)
    return dk, dv


#: kernel launches since the last reset (every type, and float32's)
flash_attention_dkv.launches = flash_attention_dkv.launches_f32 = 0


def flash_attention_dq(q, k, v, do, lse, di, causal=False):
    """K9: ``dq`` of the flash forward, from the arguments K8 takes. On
    a CUDA tensor the kernel launches (:attr:`flash_attention_dq.launches`
    counts it, the f32 route's also
    :attr:`flash_attention_dq.launches_f32`), routed by type and head
    width as K8's; on a CPU tensor the plain version runs."""
    _check_backward("flash_attention_dq", q, k, v, do, lse, di, causal)
    if q.device.type == "cpu":
        return _flash_attention_dq_plain(q, k, v, do, lse, di, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ptrs, rest = _backward_args(q, k, v, do, lse, di, causal)
    fn = _build.function("flash_attention_bwd", "veles_flash_dq",
                         [ctypes.c_void_p] * 7 + _BACKWARD_ARGTYPES)
    err = fn(*ptrs, dq.data_ptr(), *rest)
    if err:
        raise RuntimeError("flash_attention_dq kernel launch failed: CUDA "
                           "error %d (negative: a CUresult of a tensor map)"
                           % err)
    _count_launch(flash_attention_dq, q)
    return dq


#: kernel launches since the last reset (every type, and float32's)
flash_attention_dq.launches = flash_attention_dq.launches_f32 = 0


class _FlashAttention(torch.autograd.Function):
    """The flash custom VJP (``flash_attention.py:204-318``): the forward
    runs K7 and saves O and the logsumexp; the backward computes di =
    rowsum(O * dO) and runs K8 and K9. On CPU tensors the wrappers run
    the plain versions: the plain forward and
    :func:`plain_flash_backward`'s formulas."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        do = grad.to(q.dtype).contiguous()
        di = _row_dot(out, do)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, di, ctx.causal)
        dq = flash_attention_dq(q, k, v, do, lse, di, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=False):
    """Differentiable flash attention over (B, T, H, D) tensors, scaled
    by 1/sqrt(D), in q's type: K7 forward, K8 and K9 backward on CUDA
    tensors, their plain versions on CPU tensors."""
    return _FlashAttention.apply(q, k, v, causal)


# -- sequence parallelism (attention.py:156-277) -----------------------------

def _block_attend(q, k, v, scale, mask_value, causal, q_pos, kv_pos):
    """One (q-block x kv-block) pass returning the unnormalized ``(o, m,
    l)``: o = exp(s - m) @ v, m the row max, l the row sum
    (``attention.py:156-168``), in f32 as :func:`plain_attention`
    computes (the JAX package's einsums keep bf16 operands' scores in
    bf16)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = kv_pos[None, :] <= q_pos[:, None]
        s = torch.where(keep[None, None], s,
                        torch.full((), mask_value, device=s.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, m, l


def ring_attention(q, k, v, mesh, axis_name="seq", causal=False, scale=None,
                   mask_value=-1e30):
    """Sequence-parallel attention over ``mesh``'s ``axis_name``
    (``attention.py:171-218``): ``q``, ``k``, ``v`` are this rank's
    blocks (B, T_local, H, D) of a sequence ``T_local * axis size`` long,
    laid out in axis order; returns this rank's block of the output.
    Step i attends the K/V block of the axis's rank ``index - i`` and
    passes the visiting block on to ``index + 1``; the last step passes
    nothing on (the JAX scan's last ``ppermute`` feeds no step). The
    running max starts at ``mask_value``, not -inf (a -inf start gives
    NaN gradients for a fully masked first block), and the row sum is
    floored at 1e-20."""
    from veles_tpu_torch.parallel import collectives

    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = collectives.axis_size(mesh, axis_name)
    index = mesh.axis_index(axis_name) if n > 1 else 0
    batch, t_local, heads, _ = q.shape
    steps = torch.arange(t_local, device=q.device)
    q_pos = index * t_local + steps
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((batch, heads, t_local), mask_value, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((batch, heads, t_local), dtype=torch.float32,
                    device=q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        kv_pos = ((index - step) % n) * t_local + steps
        o_i, m_i, l_i = _block_attend(q, k_blk, v_blk, scale, mask_value,
                                      causal, q_pos, kv_pos)
        m_new = torch.maximum(m, m_i)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_i - m_new)
        l = l * alpha + l_i * beta
        o = (o * alpha.transpose(1, 2)[..., None]
             + o_i * beta.transpose(1, 2)[..., None])
        m = m_new
        if step < n - 1:
            k_blk, v_blk = collectives.ppermute((k_blk, v_blk), mesh,
                                                axis_name)
    l = torch.clamp(l, min=1e-20)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def make_ring_attention(mesh, axis_name="seq", causal=False):
    """:func:`ring_attention` over ``mesh`` (``attention.py:221-233``):
    takes and returns this rank's sequence blocks (B, T_local, H, D)."""
    def ring(q, k, v):
        return ring_attention(q, k, v, mesh, axis_name, causal=causal)
    return ring


def ulysses_attention(q, k, v, mesh, axis_name="seq", causal=False):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses,
    ``attention.py:238-264``): ``q``, ``k``, ``v`` are this rank's
    sequence blocks (B, T_local, H, D); one ``all_to_all`` gives this
    rank the whole sequence of its ``H / n`` heads, :func:`attention`
    runs on it (on a CUDA tensor where :func:`uses_flash` holds: K7
    forward, K8 and K9 backward), and the inverse ``all_to_all``
    restores the sequence blocks. Needs ``heads % n == 0``."""
    from veles_tpu_torch.parallel import collectives

    n = collectives.axis_size(mesh, axis_name)
    heads = q.shape[2]
    if heads % n:
        raise ValueError("ulysses needs heads (%d) divisible by the "
                         "%r axis size (%d)" % (heads, axis_name, n))

    def seq_to_heads(x):  # (B, T/n, H, D) -> (B, T, H/n, D)
        return collectives.all_to_all(x, mesh, axis_name, split_axis=2,
                                      concat_axis=1)

    out = attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                    causal=causal)
    return collectives.all_to_all(out, mesh, axis_name, split_axis=1,
                                  concat_axis=2)


def make_ulysses_attention(mesh, axis_name="seq", causal=False):
    """:func:`ulysses_attention` over ``mesh`` (``attention.py:267-277``),
    the same contract as :func:`make_ring_attention`."""
    def ulysses(q, k, v):
        return ulysses_attention(q, k, v, mesh, axis_name, causal=causal)
    return ulysses
