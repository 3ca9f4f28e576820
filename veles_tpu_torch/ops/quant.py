"""Int8 weight-only quantization (W8A16) with a dequant-fused CUDA matvec.

The port of ``veles_tpu/ops/quant.py``: weights live on the card as int8
with one f32 scale per output channel, and the kernel
(``csrc/int8_matmul.cu``) widens them inside the product, so the float
weights never exist in device memory. Quantization is symmetric
per-output-channel absmax (``q = round(w / scale)``, ``scale = absmax /
127``, round half to even); the product widens q to the activation type,
accumulates in f32, multiplies by the scale and casts back to the
activation type (``quant.py:52-60``, ``:69-71``, ``:150-153``).

Regime rule, as in the JAX package (``quant.py:104-111``): products of at
most :data:`PALLAS_MAX_ROWS` rows (every decode step, short prefills) run
the kernel on a CUDA tensor; larger ones dequantize and call
``torch.matmul``, as the JAX package left them to XLA. On a CPU tensor
the plain version runs.

:func:`int8_cache_attend` is the int8-KV tier's decode attention in
torch ops, as the JAX package's default formulation is XLA.
"""

import ctypes

import torch

from veles_tpu_torch.ops import _build

#: the kernel runs for products of at most this many rows of x (the
#: decode regime); above it the plain dequantized product runs
PALLAS_MAX_ROWS = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_int8(w):
    """Symmetric per-output-channel int8 quantization of ``w`` (K, N):
    returns ``(q int8 (K, N), scale f32 (N,))`` with ``w ~= q * scale``.
    Zero columns get scale 1 (q = 0)."""
    w = w.float()
    absmax = w.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127)
    return q.to(torch.int8), scale


def _int8_matmul_plain(x, q, scale):
    """The plain version: the int8 weights widen exactly to f32, the
    product accumulates in f32, then the scale and the cast to x's
    type."""
    out = torch.matmul(x.float(), q.float())
    return (out * scale).to(x.dtype)


def _check(x, q, scale):
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError("int8_matmul wants x (M, K), q (K, N) and scale "
                         "(N,), got %s, %s, %s" % (tuple(x.shape),
                                                   tuple(q.shape),
                                                   tuple(scale.shape)))
    if x.shape[1] != q.shape[0] or q.shape[1] != scale.shape[0]:
        raise ValueError("int8_matmul shapes disagree: x %s, q %s, "
                         "scale %s" % (tuple(x.shape), tuple(q.shape),
                                       tuple(scale.shape)))
    if min(x.shape[0], x.shape[1], q.shape[1]) < 1:
        raise ValueError("int8_matmul wants non-empty operands, got x %s"
                         ", q %s" % (tuple(x.shape), tuple(q.shape)))
    if x.dtype not in _DTYPES:
        raise TypeError("int8_matmul takes float32 or bfloat16 x, got %s"
                        % x.dtype)
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("int8_matmul wants int8 q and float32 scale, "
                        "got %s and %s" % (q.dtype, scale.dtype))
    if not (x.device == q.device == scale.device):
        raise ValueError("int8_matmul operands on different devices: "
                         "%s, %s, %s" % (x.device, q.device,
                                         scale.device))


def int8_matmul(x, q, scale):
    """``x @ (q * scale)`` with the dequantization fused into the
    product. ``x`` (M, K) float32 or bfloat16; ``q`` (K, N) int8;
    ``scale`` (N,) float32. Returns (M, N) in ``x``'s dtype.

    On a CUDA tensor with M <= :data:`PALLAS_MAX_ROWS` the kernel runs
    (and :attr:`int8_matmul.launches` counts it); a larger M runs the
    dequantized ``torch.matmul``. On a CPU tensor the plain version
    runs. The operands must be contiguous."""
    _check(x, q, scale)
    if x.device.type == "cpu" or x.shape[0] > PALLAS_MAX_ROWS:
        return _int8_matmul_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError("int8_matmul runs on cuda or cpu tensors, got %s"
                         % x.device)
    if not (x.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("int8_matmul's kernel wants contiguous operands")
    m, k = x.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    vec_ok = int(n % 16 == 0 and q.data_ptr() % 16 == 0)
    fn = _build.function(
        "int8_matmul", "veles_int8_matmul",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             m, k, n, _DTYPES[x.dtype], vec_ok,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("int8_matmul kernel launch failed: CUDA error "
                           "%d" % err)
    int8_matmul.launches += 1
    return out


#: kernel launches since the last reset (a plain integer the chip smoke
#: zeroes before driving the serving path)
int8_matmul.launches = 0


def int8_cache_attend(q, k_q, k_scale, v_q, v_scale, mask_addend,
                      use_pallas=None):
    """Decode attention of one query token against an int8 KV cache in
    the head-major (B, H, D, T) layout (``quant.py:221-259``). ``q``
    (B, 1, H, D) float, already 1/sqrt(D)-scaled by the caller;
    per-(position, head) ``k_scale``/``v_scale`` (B, H, T) f32;
    ``mask_addend`` f32 (0 visible, -1e30 masked), (T,) shared or (B, T)
    per row. Returns (B, 1, H, D) f32.

    Torch ops, the JAX package's default formulation: the scores and the
    value product accumulate in f32, and with a bf16 ``q`` the weights
    ``p * v_scale`` round to bf16 before the value product, as there.
    ``use_pallas=True`` (the JAX package's opt-in dense attend kernel)
    raises: that kernel is ported with the dense slot slab."""
    if use_pallas:
        raise NotImplementedError(
            "the dense int8-KV attend kernel (_pallas_cache_attend) is "
            "not ported yet: it comes with the dense slot slab (ROADMAP "
            "queue item A2)")
    s = torch.einsum("bhd,bhdt->bht", q[:, 0].float(), k_q.float())
    addend = mask_addend if mask_addend.dim() == 1 \
        else mask_addend[:, None, :]
    p = torch.softmax(s * k_scale + addend, dim=-1)
    pv = p * v_scale
    if q.dtype == torch.bfloat16:
        pv = pv.to(torch.bfloat16).float()
    return torch.einsum("bhdt,bht->bhd", v_q.float(), pv)[:, None]


def matmul_any(x, w):
    """``x @ w`` where ``w`` is a dense tensor OR the quantized
    ``{"q8", "scale"}`` dict — the one dispatch point the transformer
    sublayers route through, so the float and int8 tiers share the
    block math (leading dims of ``x`` are flattened for the product)."""
    if isinstance(w, dict):
        lead = x.shape[:-1]
        y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w["q8"],
                        w["scale"])
        return y.reshape(lead + (w["q8"].shape[1],))
    return x @ w
