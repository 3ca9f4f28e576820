"""Dense products under the engine's precision policy, with two
hand-written CUDA GEMM kernels.

The port of ``veles_tpu/ops/gemm.py`` as far as the dense training path
needs it. Precision levels (reference ``config.py:244-247``):

- 0 → bfloat16 operands (``root.common.engine.compute_dtype``), float32
  accumulation and result;
- 1, 2 → float32 operands, computed in true float32 (the port never lets
  a product fall to TF32).

Where a product runs:

- the plain route, the default: ``torch.matmul`` of the operands widened
  to float32 (a bf16 operand widens exactly, so the product keeps the
  "bf16 operands, f32 accumulator" contract), as the JAX package leaves
  its default product to XLA's ``dot_general``;
- K5, :func:`blocked_matmul` (``csrc/gemm.cu``, replacing ``_mm_kernel``
  via ``pallas_matmul``, ``gemm.py:133``): ``matmul`` runs it with
  ``root.common.engine.use_pallas`` on, where :func:`_kernel_eligible`
  holds;
- K6, :func:`dense_epilogue` (``csrc/dense_epilogue.cu``, replacing
  ``_mm_epilogue_kernel`` via ``pallas_dense``, ``gemm.py:199``): K5's
  product with the bias and the activation applied to the f32
  accumulator before the one store; ``dense_layer`` runs it with
  ``use_pallas`` and ``pallas_epilogue`` on, where the gate holds, through
  :class:`_DenseFunction`, whose backward is ``_dense_with_vjp``'s math
  (``gemm.py:269-302``) with both products through ``matmul``, so K5.

Convolutions (:func:`conv2d`) are no TPU kernel in the JAX package
(XLA's conv emitter runs them): here they run as
``torch.nn.functional.conv2d``, cuDNN on the card, under the same
precision policy, with TF32 off at levels 1 and 2.

The gate is the JAX package's (``gemm.py:119-128``) with the device test
changed: two 2-D CUDA operands, m, n and k all at least 512. Each kernel
wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises, and counts its launches in ``launches``.

The tuning cache (``gemm.py:338-623``): :func:`autotune_matmul` races K5
at both output tile widths (BN 128 and 256, bf16 operands; the f32 tile
has one shape) against the plain route on this card, per shape bucket
(:func:`_size_bucket`), and persists the winner's ``blocks`` (``[BN]``),
both times and the ``beats_xla`` verdict. In this package "xla" names
the plain route, the one ``use_pallas="tuned"`` runs without a verdict.
``matmul(..., use_pallas="tuned")`` runs K5 where the gate holds and this
card's verdict says ``beats_xla``; K5 and K6 take the bucket's tuned BN
whenever they run. The cache file is the port's own
(``root.common.engine.pallas_autotune_cache``, by default under the
git-ignored ``veles_tpu_torch/_build/``); the JAX package's is never
read. Every key starts with the card's name and compute capability
(:func:`device_tag`), so an entry measured on another device is never
found. ``ops/quant.py`` (``int8:KxN``) and ``ops/paged_attention.py``
(``pgatt:PSxD``) keep their verdicts in the same file.
"""

import contextlib
import ctypes
import json
import logging
import math
import os
import statistics

import torch
import torch.nn.functional as F

from veles_tpu_torch.core.config import root
from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops import activations as act_lib

#: the kernels' shape gate: m, n and k all at least this (gemm.py:128)
ELIGIBLE_MIN = 512

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the activation index the fused dense kernel takes (EPI_* in
#: csrc/epilogue.cuh)
_ACTIVATION_IDS = {"linear": 0, "tanh": 1, "sigmoid": 2, "relu": 3,
                   "strict_relu": 4}


def compute_operands(*tensors, precision_level=None):
    """The engine's compute-dtype policy for product operands: level 0
    casts to ``root.common.engine.compute_dtype`` (bfloat16), levels 1
    and 2 to float32."""
    if precision_level is None:
        precision_level = root.common.engine.get("precision_level", 0)
    if precision_level == 0:
        dtype = getattr(torch, root.common.engine.get("compute_dtype",
                                                      "bfloat16"))
    else:
        dtype = torch.float32
    return tuple(t.to(dtype) for t in tensors)


def same_padding(size, kernel, stride):
    """XLA's ``padding="SAME"`` along one axis: ``(low, high)`` with
    ``out = ceil(size / stride)`` and the total pad ``max((out - 1) *
    stride + kernel - size, 0)`` split low = total // 2, high = the rest
    (asymmetric where the total is odd)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_output_hw(hw, kernel, sliding, padding):
    """The (H, W) of a conv's output for an (H, W) input, a (ky, kx)
    kernel, (sy, sx) strides and ``"SAME"``, ``"VALID"`` or explicit
    ``((top, bottom), (left, right))`` padding."""
    pads = _conv_pads(hw, kernel, sliding, padding)
    return tuple((n + lo + hi - k) // s + 1 for n, k, s, (lo, hi)
                 in zip(hw, kernel, sliding, pads))


def _conv_pads(hw, kernel, sliding, padding):
    if padding == "SAME":
        return [same_padding(n, k, s)
                for n, k, s in zip(hw, kernel, sliding)]
    if padding == "VALID":
        return [(0, 0), (0, 0)]
    return [tuple(pair) for pair in padding]


@contextlib.contextmanager
def _full_f32():
    """cuDNN's f32 convolutions in full f32: PyTorch lets them run in
    TF32 by default (``torch.backends.cudnn.allow_tf32``), which keeps
    about three decimal digits."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class _F32Conv(torch.autograd.Function):
    """An NCHW conv whose forward and backward both run with TF32 off
    (autograd's own backward would read the process-wide flag when it
    runs, after this call has returned)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _full_f32():
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        with _full_f32():
            grad_x, grad_w, _ = torch.ops.aten.convolution_backward(
                grad, x, w, None, list(ctx.stride), [0, 0], [1, 1], False,
                [0, 0], 1, [ctx.needs_input_grad[0],
                            ctx.needs_input_grad[1], False])
        return grad_x, grad_w, None


def conv2d(x, w, sliding, padding, precision_level=None):
    """NHWC x HWIO convolution under the precision policy, f32 result
    (the JAX package's ``conv2d``, ``gemm.py:93-116``). Level 0 runs the
    conv on bf16 operands end to end, so its output rounds through bf16,
    then widens it; levels 1 and 2 run in true f32 (never TF32).
    ``padding`` is ``"SAME"`` (XLA's rule, :func:`same_padding`, applied
    as an explicit pad), ``"VALID"`` or ``((top, bottom), (left,
    right))``. The conv is ``torch.nn.functional.conv2d`` on the NCHW
    view of the NHWC tensor, a channels-last layout, so cuDNN runs its
    NHWC kernels on the card; the result is viewed back as NHWC."""
    if precision_level is None:
        precision_level = root.common.engine.get("precision_level", 0)
    xc, wc = compute_operands(x, w, precision_level=precision_level)
    stride = tuple(int(s) for s in sliding)
    pads = _conv_pads(tuple(x.shape[1:3]), tuple(w.shape[:2]), stride,
                      padding)
    xn = xc.permute(0, 3, 1, 2)              # NCHW view, channels last
    if any(lo or hi for lo, hi in pads):
        (top, bottom), (left, right) = pads
        xn = F.pad(xn, (left, right, top, bottom))
    wn = wc.permute(3, 2, 0, 1)              # OIHW
    if xn.dtype == torch.float32:
        out = _F32Conv.apply(xn, wn, stride)
    else:
        out = F.conv2d(xn, wn, stride=stride)
    return out.permute(0, 2, 3, 1).float()


def _plain_product(a, b):
    """The plain route: the operands widened to f32, an f32 product."""
    return torch.matmul(a.float(), b.float())


def _kernel_eligible(a, b):
    """The kernels' gate: two 2-D CUDA operands with m, n, k >= 512
    (the JAX package's gate, ``gemm.py:119-128``, on this card)."""
    if a.dim() != 2 or b.dim() != 2:
        return False
    if a.device.type != "cuda" or b.device.type != "cuda":
        return False
    m, k = a.shape
    return min(m, k, b.shape[1]) >= ELIGIBLE_MIN


def matmul(a, b, precision_level=None, out_dtype=None, use_pallas=None):
    """``a @ b`` under the precision policy, in ``out_dtype`` (``a``'s
    type by default). ``use_pallas`` True/False forces the route; None
    reads ``root.common.engine.use_pallas``. With it on an eligible
    product runs K5; with ``"tuned"`` only where this card's persisted
    verdict for the shape bucket says ``beats_xla``
    (:func:`_tuned_beats_xla`), else the plain route."""
    if precision_level is None:
        precision_level = root.common.engine.get("precision_level", 0)
    if out_dtype is None:
        out_dtype = a.dtype
    if use_pallas is None:
        use_pallas = root.common.engine.get("use_pallas", "tuned")
    a, b = compute_operands(a, b, precision_level=precision_level)
    if use_pallas and _kernel_eligible(a, b):
        if use_pallas != "tuned" or _tuned_beats_xla(a, b):
            return blocked_matmul(a, b, out_dtype=out_dtype)
    return _plain_product(a, b).to(out_dtype)


# -- the kernels --------------------------------------------------------------

def _check_operands(name, a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("%s wants a (M, K) and b (K, N), got %s and %s"
                         % (name, tuple(a.shape), tuple(b.shape)))
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1:
        raise ValueError("%s wants non-empty operands, got %s and %s"
                         % (name, tuple(a.shape), tuple(b.shape)))
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError("%s takes two float32 or two bfloat16 operands, "
                        "got %s and %s" % (name, a.dtype, b.dtype))
    if a.device != b.device:
        raise ValueError("%s operands on different devices: %s, %s"
                         % (name, a.device, b.device))
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError("%s runs on cuda or cpu tensors, got %s"
                         % (name, a.device))


def _layout(t):
    """How the kernel reads the 2-D operand ``t`` (R, C) in place:
    ``(tensor, leading stride, C contiguous, 16-byte loads allowed)``.
    An operand with neither axis contiguous is copied first."""
    rows, cols = t.shape
    s0, s1 = t.stride()
    if s1 == 1 or cols == 1:
        ld, c_contig = (s0 if rows > 1 else cols), True
    elif s0 == 1 or rows == 1:
        ld, c_contig = (s1 if cols > 1 else rows), False
    else:
        t = t.contiguous()
        ld, c_contig = cols, True
    vector = 16 // t.element_size()
    return t, ld, c_contig, int(ld % vector == 0 and t.data_ptr() % 16 == 0)


def _tma_layout(t):
    """How K5's bf16 route reads the 2-D operand ``t`` (R, C) in place:
    ``(tensor, leading stride, C contiguous)``. Its tensor maps (TMA)
    want the base 16-byte aligned and the leading stride a multiple of 8
    elements (16 bytes); an operand that breaks either rule, or has no
    contiguous axis, is copied into a row-major buffer whose rows are
    padded to a multiple of 8 elements (a bf16 row of k = 100, or a view
    that starts off a 16-byte boundary)."""
    t, ld, c_contig, _ = _layout(t)
    rows, cols = t.shape
    if ld % 8 == 0 and t.data_ptr() % 16 == 0 \
            and ld >= (cols if c_contig else rows):
        return t, ld, c_contig
    ld = -(-cols // 8) * 8
    buf = torch.empty((rows, ld), dtype=t.dtype, device=t.device)[:, :cols]
    buf.copy_(t)
    return buf, ld, True


def _blocked_matmul_plain(a, b, out_dtype=torch.float32):
    """K5's plain version: f32 product of the widened operands."""
    return _plain_product(a, b).to(out_dtype)


def _check_bn(name, bn):
    if bn is not None and bn not in BN_CHOICES:
        raise ValueError("%s: bn must be one of %s, got %r"
                         % (name, BN_CHOICES, bn))


def blocked_matmul(a, b, out_dtype=torch.float32, bn=None):
    """``a @ b`` with an f32 accumulator, in ``out_dtype`` (float32 or
    bfloat16): the port of ``pallas_matmul``. ``a`` (M, K) and ``b``
    (K, N), both float32 or both bfloat16, any M, N, K. On a CUDA tensor
    K5 launches (:attr:`blocked_matmul.launches` counts it) and reads
    each operand in place when one of its axes is contiguous (``x.T`` and
    ``w.T`` of row-major tensors included): bfloat16 operands through TMA
    and wgmma (``csrc/gemm_sm90.cuh``), copied first when TMA's alignment
    rules refuse them (:func:`_tma_layout`), float32 operands on the
    true-f32 tile. ``bn`` is the bf16 route's output tile width, 128 or
    256, or 0 for the kernel's own pick; None takes the tuned width of
    the shape's bucket on this card (:func:`_tuned_blocks`). On a CPU
    tensor the plain version runs."""
    _check_operands("blocked_matmul", a, b)
    if out_dtype not in _DTYPES:
        raise TypeError("blocked_matmul writes float32 or bfloat16, got %s"
                        % out_dtype)
    _check_bn("blocked_matmul", bn)
    if a.device.type == "cpu":
        return _blocked_matmul_plain(a, b, out_dtype)
    (m, k), n = a.shape, b.shape[1]
    if bn is None:
        bn = _tuned_blocks(m, n, k, a.dtype, a.device)[0]
    if a.dtype == torch.bfloat16:
        a, lda, a_k_contig = _tma_layout(a)
        b, ldb, b_n_contig = _tma_layout(b)
        vec_a = vec_b = 0
    else:
        a, lda, a_k_contig, vec_a = _layout(a)
        b, ldb, b_n_contig, vec_b = _layout(b)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    fn = _build.function(
        "gemm", "veles_gemm",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
             lda, a_k_contig, ldb, b_n_contig, n, _DTYPES[a.dtype],
             _DTYPES[out_dtype], vec_a, vec_b, bn,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError("blocked_matmul kernel launch failed: CUDA error "
                           "%d (negative: a CUresult of the tensor map)"
                           % err)
    blocked_matmul.launches += 1
    return out


#: kernel launches since the last reset
blocked_matmul.launches = 0


def _dense_epilogue_plain(a, b, bias, activation="linear"):
    """K6's plain version: ``act(a @ b + bias)`` on the f32 product."""
    act = act_lib.ACTIVATIONS[activation][0]
    return act(_plain_product(a, b) + bias.float())


def dense_epilogue(a, b, bias, activation="linear", bn=None):
    """``act(a @ b + bias)`` as one kernel, f32 out: the port of
    ``pallas_dense``. ``a`` (M, K) and ``b`` (K, N) both float32 or both
    bfloat16; ``bias`` (N,) float32; ``activation`` one of
    :data:`~veles_tpu_torch.ops.activations.ACTIVATIONS`. On a CUDA
    tensor K6 launches (:attr:`dense_epilogue.launches` counts it),
    reading the operands in place as K5 does: bfloat16 operands on K5's
    TMA and wgmma mainloop (``csrc/gemm_sm90.cuh``), copied first when
    TMA's alignment rules refuse them (:func:`_tma_layout`), float32
    operands on the true-f32 tile. ``bn`` as :func:`blocked_matmul`'s
    (None: the bucket's tuned width on this card). On a CPU tensor the
    plain version runs."""
    _check_operands("dense_epilogue", a, b)
    _check_bn("dense_epilogue", bn)
    if activation not in _ACTIVATION_IDS:
        raise ValueError("dense_epilogue: unknown activation %r (known: %s)"
                         % (activation, ", ".join(sorted(_ACTIVATION_IDS))))
    if tuple(bias.shape) != (b.shape[1],) or bias.dtype != torch.float32 \
            or bias.device != a.device:
        raise ValueError("dense_epilogue wants a float32 bias of shape "
                         "(%d,) on %s, got %s %s on %s"
                         % (b.shape[1], a.device, bias.dtype,
                            tuple(bias.shape), bias.device))
    if a.device.type == "cpu":
        return _dense_epilogue_plain(a, b, bias, activation)
    (m, k), n = a.shape, b.shape[1]
    if bn is None:
        bn = _tuned_blocks(m, n, k, a.dtype, a.device)[0]
    if a.dtype == torch.bfloat16:
        a, lda, a_k_contig = _tma_layout(a)
        b, ldb, b_n_contig = _tma_layout(b)
        vec_a = vec_b = 0
    else:
        a, lda, a_k_contig, vec_a = _layout(a)
        b, ldb, b_n_contig, vec_b = _layout(b)
    bias = bias.contiguous()
    if bias.data_ptr() % 8:  # the bf16 route reads bias pairs as float2
        bias = bias.clone()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    fn = _build.function(
        "dense_epilogue", "veles_dense",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(a.data_ptr(), b.data_ptr(), bias.data_ptr(), out.data_ptr(),
             m, n, k, lda, a_k_contig, ldb, b_n_contig, n, _DTYPES[a.dtype],
             _ACTIVATION_IDS[activation], vec_a, vec_b, bn,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError("dense_epilogue kernel launch failed: CUDA error "
                           "%d (negative: a CUresult of the tensor map)"
                           % err)
    dense_epilogue.launches += 1
    return out


#: kernel launches since the last reset
dense_epilogue.launches = 0


class _DenseFunction(torch.autograd.Function):
    """The fused dense forward (K6) with ``_dense_with_vjp``'s backward
    (``gemm.py:294-299``): the activation derivative off the saved
    OUTPUT, two products through :func:`matmul` (K5 where the gate
    holds) and the bias row-sum. ``grad_w`` accumulates in f32 and is
    cast to ``w``'s type, bf16 at level 0: one bf16 rounding of the
    weight gradient, as in the JAX package. ``grad_x`` is skipped when
    the input needs none (a first layer's)."""

    @staticmethod
    def forward(ctx, x, w, bias, activation):
        y = dense_epilogue(x, w, bias, activation=activation)
        ctx.save_for_backward(x, w, y)
        ctx.activation = activation
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        err = g * act_lib.ACTIVATIONS[ctx.activation][1](y)
        grad_x = grad_w = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_x = matmul(err, w.t(), out_dtype=x.dtype)
        if ctx.needs_input_grad[1]:
            grad_w = matmul(x.t(), err, out_dtype=torch.float32).to(w.dtype)
        if ctx.needs_input_grad[2]:
            grad_b = err.sum(dim=0)
        return grad_x, grad_w, grad_b, None


def dense_layer(x, w, bias, activation="linear", precision_level=None,
                out_dtype=torch.float32, use_pallas=None):
    """The dense-layer forward ``act(x @ w + b)`` (``gemm.py:305-335``),
    differentiable. ``use_pallas`` None reads ``use_pallas`` and
    ``pallas_epilogue`` from ``root.common.engine``: with both on, an
    eligible layer runs K6 (and K5 in its backward); otherwise the plain
    f32 product with the bias and activation on the f32 result, one
    final cast to ``out_dtype``."""
    if use_pallas is None:
        use_pallas = root.common.engine.get("use_pallas", False) \
            and root.common.engine.get("pallas_epilogue", False)
    xc, wc = compute_operands(x, w, precision_level=precision_level)
    if use_pallas and _kernel_eligible(xc, wc):
        return _DenseFunction.apply(xc, wc, bias, activation).to(out_dtype)
    act = act_lib.ACTIVATIONS[activation][0]
    return act(_plain_product(xc, wc) + bias).to(out_dtype)


# -- the tuning cache (the device_infos.json descendant) ----------------------

#: the bf16 route's output tile widths a caller may name; 0 is the
#: kernel's own pick (``csrc/gemm_sm90.cuh`` pick_bn), what a bucket
#: without a verdict runs
BN_CHOICES = (0, 128, 256)
#: the widths :func:`autotune_matmul` races on bf16 operands
_BN_CANDIDATES = (128, 256)
_DEFAULT_BLOCKS = (0,)
#: the margin a kernel must beat the plain route by for ``beats_xla``: a
#: sub-noise "win" must not move a product onto the kernel
BEATS_MARGIN = 0.97
#: the fewest repetitions a race takes its medians over
MIN_REPEATS = 25
#: the timing fields an entry may carry: positive finite seconds each
_TIMING_KEYS = ("seconds", "xla_seconds")
_tuning_cache = None
_cache_loaded_from = None
_insane_warned = False
_device_tags = {}


def _cache_path():
    return root.common.engine.get(
        "pallas_autotune_cache",
        os.path.join(_build.BUILD_DIR, "pallas_tuning.json"))


def device_tag(device=None):
    """The card a verdict belongs to: its name and compute capability,
    e.g. ``"NVIDIA H100 80GB HBM3 sm_90"`` (read once a device)."""
    device = torch.device("cuda" if device is None else device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    tag = _device_tags.get(index)
    if tag is None:
        major, minor = torch.cuda.get_device_capability(index)
        tag = _device_tags[index] = "%s sm_%d%d" % (
            torch.cuda.get_device_name(index), major, minor)
    return tag


def _key(device, kind):
    """The cache key of ``kind`` (``bfloat16:12``, ``int8:KxN``,
    ``pgatt:PSxD``) measured on ``device``."""
    return "%s|%s" % (device_tag(device), kind)


def _dtype_name(dtype):
    return str(dtype).split(".")[-1]


def _sane_entry(entry):
    """True when an autotune row is physically possible: a dict whose
    timing fields (where present) are positive finite numbers."""
    if not isinstance(entry, dict):
        return False
    for key in _TIMING_KEYS:
        if key in entry:
            value = entry[key]
            if isinstance(value, bool) \
                    or not isinstance(value, (int, float)) \
                    or not math.isfinite(value) or value <= 0:
                return False
    return True


def _drop_insane(cache, where):
    """Remove physically impossible rows in place (warn once); the
    dropped bucket runs its defaults until it is tuned again."""
    global _insane_warned
    bad = [key for key, entry in cache.items() if not _sane_entry(entry)]
    for key in bad:
        del cache[key]
    if bad and not _insane_warned:
        _insane_warned = True
        logging.getLogger("gemm.autotune").warning(
            "dropped %d physically impossible autotune entr%s %s "
            "(non-positive or non-finite timing): %s; affected buckets "
            "run their defaults until tuned again (reported once)",
            len(bad), "y" if len(bad) == 1 else "ies", where,
            ", ".join(sorted(bad)))
    return bad


def _load_cache():
    """The tuning cache of :func:`_cache_path`, read once a path (a new
    path is read anew). Impossible rows are dropped and the cleaned
    cache is written back."""
    global _tuning_cache, _cache_loaded_from
    path = _cache_path()
    if _tuning_cache is None or _cache_loaded_from != path:
        try:
            with open(path, "r") as fin:
                cache = json.load(fin)
        except (OSError, ValueError):
            cache = {}
        if not isinstance(cache, dict):
            cache = {}
        _tuning_cache, _cache_loaded_from = cache, path
        if _drop_insane(cache, "at load"):
            _persist_cache(cache)
    return _tuning_cache


def _persist_cache(cache):
    """Write the (already updated) tuning cache, shared by the GEMM,
    int8 and paged-attention autotuners; impossible rows are dropped
    first. The file is replaced whole, so a reader never sees half of
    it."""
    global _tuning_cache, _cache_loaded_from
    _drop_insane(cache, "at persist")
    path = _cache_path()
    _tuning_cache, _cache_loaded_from = cache, path
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = "%s.tmp%d" % (path, os.getpid())
        with open(tmp, "w") as fout:
            json.dump(cache, fout, indent=1)
        os.replace(tmp, path)
    except OSError as exc:
        logging.getLogger("gemm.autotune").warning(
            "could not write the tuning cache %s: %s", path, exc)


def _tuned_entry(device, kind):
    """This card's persisted entry of ``kind``, or None."""
    return _load_cache().get(_key(device, kind))


def _size_bucket(m, n, k):
    size = m * n * k
    bucket = 0
    while size > 1:
        size >>= 3  # buckets by order of magnitude in each dim
        bucket += 1
    return bucket


def _gemm_kind(m, n, k, dtype):
    return "%s:%d" % (_dtype_name(dtype), _size_bucket(m, n, k))


def _tuned_blocks(m, n, k, dtype, device):
    """``(bn,)``: the output tile width this card's verdict names for the
    shape's bucket, else :data:`_DEFAULT_BLOCKS` (the kernel's pick)."""
    entry = _tuned_entry(device, _gemm_kind(m, n, k, dtype))
    if entry and entry.get("blocks") \
            and entry["blocks"][0] in BN_CHOICES:
        return (int(entry["blocks"][0]),)
    return _DEFAULT_BLOCKS


def _tuned_beats_xla(a, b):
    """The "tuned" gate: K5 only where an autotune run on this card
    recorded it beating the plain route for the shape bucket."""
    (m, k), n = a.shape, b.shape[1]
    entry = _tuned_entry(a.device, _gemm_kind(m, n, k, a.dtype))
    return bool(entry and entry.get("beats_xla"))


def _autotune_device(device=None):
    """The CUDA device a race runs on; raises without one: autotune
    measures the card and has no answer to give on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            "autotune measures the CUDA card, and %s" % (
                "no CUDA device is available" if device.type == "cuda"
                else "was asked for %s" % device))
    return device


def _race(kernels, plain, repeats=None):
    """Median seconds of the card's time for one call of each of
    ``kernels`` (name -> callable) and of ``plain``. Each candidate runs
    once eagerly (builds, workspaces, library handles), then about a
    millisecond of its calls is captured once in a CUDA graph, and every
    sample replays that graph between two CUDA events: the card's time
    for the calls, without the host's Python around each launch (a
    decode-sized product takes less card time than its wrapper takes
    host time, so back-to-back eager calls would time the host). The
    calls reuse their operands, so what fits the 50 MB L2 cache stays
    there between calls (a warm reading, for both sides alike). At
    least :data:`MIN_REPEATS` repetitions, each timing every candidate
    and then the plain route (kernel, plain, kernel, plain), so an order
    effect falls on both sides alike. Returns ``({name: seconds}, plain
    seconds)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def eager(fn, calls):
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / calls

    everything = list(kernels.items()) + [(None, plain)]
    probe = min(eager(fn, 3) for _, fn in everything)
    calls = max(1, min(100, int(math.ceil(1e-3 / max(probe, 1e-7)))))
    # warm up on the capture stream first (PyTorch's recipe): the
    # per-stream workspaces and library state exist before the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _, fn in everything:
            fn()
    side.synchronize()
    graphs = {}
    for name, fn in everything:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
        graphs[name] = graph
    torch.cuda.synchronize()

    def sample(name):
        start.record()
        graphs[name].replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / calls

    times = {name: [] for name in kernels}
    plain_times = []
    for _ in range(max(repeats or 0, MIN_REPEATS)):
        for name in kernels:
            times[name].append(sample(name))
            plain_times.append(sample(None))
    return ({name: statistics.median(v) for name, v in times.items()},
            statistics.median(plain_times))


def autotune_matmul(m, n, k, dtype=torch.bfloat16, iters=MIN_REPEATS,
                    device=None):
    """Race K5's candidate tiles (BN 128 and 256 on bf16 operands, the
    one f32 tile on f32 ones) against the plain route for an (m, k) @
    (k, n) product on the card and persist the bucket's verdict under
    this card's key: ``{"blocks": [bn], "seconds", "xla_seconds",
    "beats_xla", "shape", "measured" (us by candidate)}``
    (``xla_seconds``: the plain route; ``beats_xla`` needs a
    :data:`BEATS_MARGIN` lead). ``iters``: repetitions of the race (at
    least :data:`MIN_REPEATS`). Returns the winning ``blocks`` tuple.
    Raises without a card."""
    device = _autotune_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    b = torch.randn((k, n), generator=gen, device=device).to(dtype)
    candidates = _BN_CANDIDATES if dtype == torch.bfloat16 else (0,)
    times, plain = _race(
        {bn: (lambda bn=bn: blocked_matmul(a, b, torch.float32, bn=bn))
         for bn in candidates},
        lambda: _plain_product(a, b), iters)
    best = min(times, key=times.get)
    entry = {"blocks": [best], "seconds": times[best],
             "xla_seconds": plain,
             "beats_xla": times[best] < BEATS_MARGIN * plain,
             "shape": [m, n, k],
             "measured": {str(bn): round(t * 1e6, 3)
                          for bn, t in times.items()}}
    if not _sane_entry(entry):
        logging.getLogger("gemm.autotune").warning(
            "autotune %dx%dx%d measured an impossible timing (kernel %.3g "
            "s, plain %.3g s); verdict NOT persisted", m, n, k,
            times[best], plain)
        return (best,)
    cache = _load_cache()
    cache[_key(device, _gemm_kind(m, n, k, dtype))] = entry
    _persist_cache(cache)
    return (best,)


def _persisted_entry(key):
    """The entry under ``key`` in the cache file as it is on disk (proof
    that a verdict persisted), or None."""
    try:
        with open(_cache_path()) as fin:
            return json.load(fin).get(key)
    except (OSError, ValueError, AttributeError):
        return None


def autotune_main(argv=None):
    """``python -m veles_tpu_torch autotune MxNxK[,MxNxK...]``: race the
    kernels on this card for each shape and persist the verdicts (the
    JAX package's flags, and ``--cache`` to name the cache file instead
    of ``root.common.engine.pallas_autotune_cache``). Prints one JSON
    line a shape, both timings beside the verdict; exits 1 when a
    verdict did not persist. Raises without a card."""
    import argparse
    parser = argparse.ArgumentParser(prog="veles_tpu_torch autotune")
    parser.add_argument("shapes",
                        help="comma-separated MxNxK matmul shapes")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument("--iters", type=int, default=MIN_REPEATS,
                        help="repetitions of each race (at least %d)"
                             % MIN_REPEATS)
    parser.add_argument("--int8", action="store_true",
                        help="tune the W8A16 product (ops/quant.py, K2's "
                             "split count and route) instead of the GEMM: "
                             "shapes are MxKxN")
    parser.add_argument("--paged-attention", action="store_true",
                        help="tune the paged attends' pages per split "
                             "(ops/paged_attention.py, K1 and K3) instead "
                             "of the GEMM: shapes are PSxD (page size x "
                             "head dim)")
    parser.add_argument("--cache", default=None,
                        help="the tuning cache file (default: "
                             "root.common.engine.pallas_autotune_cache)")
    args = parser.parse_args(argv)
    if args.cache is not None:
        root.common.engine.pallas_autotune_cache = os.path.abspath(
            args.cache)
    device = _autotune_device()
    dtype = getattr(torch, args.dtype)
    failed = 0
    for spec in args.shapes.split(","):
        dims = [int(x) for x in spec.lower().split("x")]
        if args.paged_attention:
            from veles_tpu_torch.ops.paged_attention import (
                autotune_paged_attention)
            ps, d = dims
            pages = autotune_paged_attention(ps, d, iters=args.iters,
                                             device=device)
            kind, line = "pgatt:%dx%d" % (ps, d), {"shape": [ps, d],
                                                   "pages": pages}
        elif args.int8:
            from veles_tpu_torch.ops.quant import autotune_int8
            m, k, n = dims
            decision = autotune_int8(m, k, n, dtype=dtype,
                                     repeats=args.iters, device=device)
            kind, line = "int8:%dx%d" % (k, n), dict(decision,
                                                     shape=[m, k, n])
        else:
            m, n, k = dims
            blocks = autotune_matmul(m, n, k, dtype=dtype,
                                     iters=args.iters, device=device)
            kind, line = _gemm_kind(m, n, k, dtype), {
                "shape": [m, n, k], "dtype": args.dtype,
                "blocks": list(blocks)}
        entry = _persisted_entry(_key(device, kind))
        if entry is None:
            failed += 1
        else:
            line.update(kernel_ms=entry["seconds"] * 1e3,
                        plain_ms=entry["xla_seconds"] * 1e3,
                        verdict=entry.get("beats_xla",
                                          entry.get("use_pallas")))
        line.update(key=kind, persisted=entry is not None,
                    device=device_tag(device), cache=_cache_path())
        print(json.dumps(line))
    return 1 if failed else 0
