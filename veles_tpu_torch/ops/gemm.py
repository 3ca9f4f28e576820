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
``use_pallas="tuned"`` (engage where an autotune verdict measured the
kernel faster) finds no verdict on this card yet and runs the plain
route; the JAX package's TPU tuning cache is never read.
"""

import contextlib
import ctypes

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
    reads ``root.common.engine.use_pallas``. With it on (and not
    ``"tuned"``) an eligible product runs K5."""
    if precision_level is None:
        precision_level = root.common.engine.get("precision_level", 0)
    if out_dtype is None:
        out_dtype = a.dtype
    if use_pallas is None:
        use_pallas = root.common.engine.get("use_pallas", "tuned")
    a, b = compute_operands(a, b, precision_level=precision_level)
    if use_pallas and use_pallas != "tuned" and _kernel_eligible(a, b):
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


def blocked_matmul(a, b, out_dtype=torch.float32):
    """``a @ b`` with an f32 accumulator, in ``out_dtype`` (float32 or
    bfloat16): the port of ``pallas_matmul``. ``a`` (M, K) and ``b``
    (K, N), both float32 or both bfloat16, any M, N, K. On a CUDA tensor
    K5 launches (:attr:`blocked_matmul.launches` counts it) and reads
    each operand in place when one of its axes is contiguous (``x.T`` and
    ``w.T`` of row-major tensors included): bfloat16 operands through TMA
    and wgmma (``csrc/gemm_sm90.cuh``), copied first when TMA's alignment
    rules refuse them (:func:`_tma_layout`), float32 operands on the
    true-f32 tile. On a CPU tensor the plain version runs."""
    _check_operands("blocked_matmul", a, b)
    if out_dtype not in _DTYPES:
        raise TypeError("blocked_matmul writes float32 or bfloat16, got %s"
                        % out_dtype)
    if a.device.type == "cpu":
        return _blocked_matmul_plain(a, b, out_dtype)
    (m, k), n = a.shape, b.shape[1]
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
           ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
             lda, a_k_contig, ldb, b_n_contig, n, _DTYPES[a.dtype],
             _DTYPES[out_dtype], vec_a, vec_b,
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


def dense_epilogue(a, b, bias, activation="linear"):
    """``act(a @ b + bias)`` as one kernel, f32 out: the port of
    ``pallas_dense``. ``a`` (M, K) and ``b`` (K, N) both float32 or both
    bfloat16; ``bias`` (N,) float32; ``activation`` one of
    :data:`~veles_tpu_torch.ops.activations.ACTIVATIONS`. On a CUDA
    tensor K6 launches (:attr:`dense_epilogue.launches` counts it),
    reading the operands in place as K5 does: bfloat16 operands on K5's
    TMA and wgmma mainloop (``csrc/gemm_sm90.cuh``), copied first when
    TMA's alignment rules refuse them (:func:`_tma_layout`), float32
    operands on the true-f32 tile. On a CPU tensor the plain version
    runs."""
    _check_operands("dense_epilogue", a, b)
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
           ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(a.data_ptr(), b.data_ptr(), bias.data_ptr(), out.data_ptr(),
             m, n, k, lda, a_k_contig, ldb, b_n_contig, n, _DTYPES[a.dtype],
             _ACTIVATION_IDS[activation], vec_a, vec_b,
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
