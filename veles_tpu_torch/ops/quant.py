"""Int8 weight-only quantization (W8A16) with a dequant-fused CUDA product.

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

:func:`int8_cache_attend` is the dense int8-KV tier's decode attention:
the dequant-fused kernel (K4, ``csrc/cache_attend_int8.cu``) where the
JAX kernel's shape gate holds, otherwise (or with ``use_pallas=False``)
the JAX package's XLA formulation in torch ops.
"""

import ctypes

import torch

from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops._workspace import sm_count, split_workspace
from veles_tpu_torch.ops.paged_attention import split_elements

#: the kernel runs for products of at most this many rows of x (the
#: decode regime); above it the plain dequantized product runs
PALLAS_MAX_ROWS = 256
#: K2's column tile, and the granularity of its split over K (one
#: ``mma`` step of 16 rows)
INT8_TILE_N = 128
INT8_STEP_K = 16
#: splits x rows of one K2 call at most: the tile's last block sums
#: that many rows of 128 f32 partials alone
INT8_MAX_SPLIT_ROWS = 512

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


def _int8_plan(m, k, n, sms):
    """K2's launch plan for ``(m, k) @ (k, n)`` on a card of ``sms``
    SMs: ``(tiles, splits, slice)``. The kernel runs ``tiles`` x
    ``splits`` blocks: 128-column tiles, each K cut into ``splits``
    slices of ``slice`` rows (whole 16-row steps; the last may be
    ragged, none is empty). Fewer tiles than SMs split K into the fewest
    slices that give every SM a block (more splits add partials to write
    and sum, not bytes in flight: a decode product's blocks request all
    their weight bytes at once), as far as K has steps and two bounds
    allow: the f32 partials (4 x splits x m x n bytes, written and read
    back) stay within four times the weight's k x n bytes, and the
    tile's last block, which sums splits x m x 128 of them alone, reads
    at most 256 KB (splits x m <= 512), so prefill rows split less."""
    tiles = -(-n // INT8_TILE_N)
    steps = -(-k // INT8_STEP_K)
    cap = max(1, min(steps, k // m, INT8_MAX_SPLIT_ROWS // m))
    want = min(cap, 1 if tiles >= sms else -(-sms // tiles))
    per = max(steps // want, -(-steps // cap))
    return tiles, -(-steps // per), INT8_STEP_K * per


def _row_aligned(x):
    """``(x, ldx)``: x's rows 16-byte aligned for the kernel's copies,
    copied into a zero-padded buffer where K breaks that (K = 37)."""
    m, k = x.shape
    vector = 16 // x.element_size()
    if k % vector == 0 and x.data_ptr() % 16 == 0:
        return x, k
    ldx = -(-k // vector) * vector
    padded = torch.zeros((m, ldx), dtype=x.dtype, device=x.device)
    padded[:, :k].copy_(x)
    return padded, ldx


def int8_matmul(x, q, scale):
    """``x @ (q * scale)`` with the dequantization fused into the
    product. ``x`` (M, K) float32 or bfloat16; ``q`` (K, N) int8;
    ``scale`` (N,) float32. Returns (M, N) in ``x``'s dtype.

    On a CUDA tensor with M <= :data:`PALLAS_MAX_ROWS` the kernel runs
    (and :attr:`int8_matmul.launches` counts it) on the plan of
    :func:`_int8_plan`; a larger M runs the dequantized
    ``torch.matmul``. On a CPU tensor the plain version runs. The
    operands must be contiguous. Two calls on the same inputs give
    bit-equal outputs. Each stream keeps its own split-K workspace and
    counters (:func:`ops._workspace.split_workspace`)."""
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
    device = x.device
    tiles, splits, slice_rows = _int8_plan(m, k, n, sm_count(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    ws, counters = split_workspace(
        device, stream, splits * m * tiles * INT8_TILE_N if splits > 1
        else 0, tiles)
    x, ldx = _row_aligned(x)
    if scale.data_ptr() % 16:  # the kernel reads the scales as float4
        scale = scale.clone()
    out = torch.empty((m, n), dtype=x.dtype, device=device)
    vec = int(n % 16 == 0 and q.data_ptr() % 16 == 0)
    fn = _build.function(
        "int8_matmul", "veles_int8_matmul",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             ws.data_ptr(), counters.data_ptr(), m, k, n, ldx,
             _DTYPES[x.dtype], vec, slice_rows, splits, stream)
    if err:
        raise RuntimeError("int8_matmul kernel launch failed: CUDA error "
                           "%d" % err)
    int8_matmul.launches += 1
    return out


#: kernel launches since the last reset (a plain integer the chip smoke
#: zeroes before driving the serving path)
int8_matmul.launches = 0


#: the kernel's shape gate, the JAX kernel's own (``quant.py:245``): T
#: on whole tiles of this many positions, D a multiple of
#: :data:`ATTEND_D_TILE`
ATTEND_T_TILE = 128
ATTEND_D_TILE = 32
#: K4's plan: the blocks an SM the split of T aims at, and the most
#: splits a (row, head) may have (one block merges them all,
#: ``csrc/split_softmax.cuh``)
ATTEND_WAVE = 4
ATTEND_MAX_SPLITS = 128


def _attend_plan(batch, heads, t, sms):
    """K4's launch plan for ``batch`` rows x ``heads`` heads x ``t``
    positions (a multiple of :data:`ATTEND_T_TILE`) on a card of ``sms``
    SMs: ``(splits, chunk)``. The kernel runs heads x splits x batch
    blocks, split s reading positions [s * chunk, (s + 1) * chunk): whole
    128-position tiles, the last split ragged where the tiles do not
    divide, none empty. T is cut into the fewest splits that give every
    SM :data:`ATTEND_WAVE` blocks (a block's bytes are all requested as
    it starts, so blocks, not splits, set the bytes in flight), as far as
    T has tiles, and into at most :data:`ATTEND_MAX_SPLITS`. The plan
    reads shapes only: the mask is data, and reading it on the host
    would cost a sync a step."""
    tiles = t // ATTEND_T_TILE
    want = -(-ATTEND_WAVE * sms // (batch * heads))
    per = max(1, tiles // want, -(-tiles // ATTEND_MAX_SPLITS))
    return -(-tiles // per), per * ATTEND_T_TILE


def _attend_weights(q, k_q, k_scale, mask_addend):
    """softmax((q . K8) * k_scale + mask) in f32: (B, H, T)."""
    s = torch.einsum("bhd,bhdt->bht", q[:, 0].float(), k_q.float())
    addend = mask_addend if mask_addend.dim() == 1 \
        else mask_addend[:, None, :]
    return torch.softmax(s * k_scale + addend, dim=-1)


def _cache_attend_plain(q, k_q, k_scale, v_q, v_scale, mask_addend):
    """K4's plain version, the TPU kernel's numerics (``quant.py:
    174-183``): q widened to f32 and ``p * v_scale`` kept in f32."""
    pv = _attend_weights(q, k_q, k_scale, mask_addend) * v_scale
    return torch.einsum("bhdt,bht->bhd", v_q.float(), pv)[:, None]


def _cache_attend_xla(q, k_q, k_scale, v_q, v_scale, mask_addend):
    """The JAX package's XLA formulation (``quant.py:248-259``): as the
    plain version, except that with a bf16 ``q`` the weights
    ``p * v_scale`` round to bf16 before the value product."""
    pv = _attend_weights(q, k_q, k_scale, mask_addend) * v_scale
    if q.dtype == torch.bfloat16:
        pv = pv.to(torch.bfloat16).float()
    return torch.einsum("bhdt,bht->bhd", v_q.float(), pv)[:, None]


def _check_attend(q, k_q, k_scale, v_q, v_scale, mask_addend):
    if q.dim() != 4 or q.shape[1] != 1 or k_q.dim() != 4:
        raise ValueError("int8_cache_attend wants q (B, 1, H, D) and codes "
                         "(B, H, D, T), got %s and %s"
                         % (tuple(q.shape), tuple(k_q.shape)))
    batch, _, heads, head_dim = q.shape
    t = k_q.shape[-1]
    if tuple(k_q.shape[:3]) != (batch, heads, head_dim) \
            or v_q.shape != k_q.shape \
            or tuple(k_scale.shape) != (batch, heads, t) \
            or v_scale.shape != k_scale.shape:
        raise ValueError("int8_cache_attend codes %s / %s with scales %s / "
                         "%s do not match q %s"
                         % (tuple(k_q.shape), tuple(v_q.shape),
                            tuple(k_scale.shape), tuple(v_scale.shape),
                            tuple(q.shape)))
    if mask_addend.shape[-1:] != (t,) or mask_addend.dim() > 2 \
            or (mask_addend.dim() == 2
                and mask_addend.shape[0] not in (1, batch)):
        raise ValueError("int8_cache_attend wants a (T,), (1, T) or (B, T) "
                         "mask for B=%d, T=%d, got %s"
                         % (batch, t, tuple(mask_addend.shape)))
    if q.dtype not in _DTYPES \
            or {k_q.dtype, v_q.dtype} != {torch.int8} \
            or {k_scale.dtype, v_scale.dtype, mask_addend.dtype} \
            != {torch.float32}:
        raise TypeError("int8_cache_attend takes float32 or bfloat16 q, "
                        "int8 codes, float32 scales and mask, got %s, %s, "
                        "%s, %s, %s, %s"
                        % (q.dtype, k_q.dtype, v_q.dtype, k_scale.dtype,
                           v_scale.dtype, mask_addend.dtype))
    devices = {a.device for a in (q, k_q, k_scale, v_q, v_scale,
                                  mask_addend)}
    if len(devices) != 1:
        raise ValueError("int8_cache_attend operands on different devices: "
                         "%s" % sorted(str(d) for d in devices))


def _launch_cache_attend(q, k_q, k_scale, v_q, v_scale, mask_addend):
    """K4 on the card on the plan of :func:`_attend_plan`, reading the
    codes, scales and mask in place through their strides (a slab view
    cut to the attended span)."""
    batch, _, heads, head_dim = q.shape
    t = k_q.shape[-1]
    mask = mask_addend.reshape(-1, t) if mask_addend.dim() == 1 \
        else mask_addend
    if not q.is_contiguous():
        raise ValueError("int8_cache_attend's kernel wants a contiguous q")

    def live(a):  # a dimension of one element has no stride to read
        return tuple(s if n > 1 else 0 for s, n in zip(a.stride(), a.shape))

    if live(k_q) != live(v_q) or live(k_scale) != live(v_scale):
        raise ValueError("int8_cache_attend's kernel wants K and V (and "
                         "their scales) laid out alike")
    strides = live(k_q)[:3] + live(k_scale)[:2] + live(mask)[:1]
    if k_q.stride(3) != 1 or k_scale.stride(2) != 1 or mask.stride(1) != 1 \
            or any(s % 4 for s in strides) \
            or k_q.data_ptr() % 4 or v_q.data_ptr() % 4 \
            or any(a.data_ptr() % 16 for a in (k_scale, v_scale, mask)):
        raise ValueError("int8_cache_attend's kernel wants positions "
                         "minor, strides in multiples of 4, codes 4-byte "
                         "and scales and mask 16-byte aligned")
    # 16-byte copies of the code rows where every row starts on 16 bytes
    code16 = int(all(s % 16 == 0 for s in strides[:3])
                 and k_q.data_ptr() % 16 == 0 and v_q.data_ptr() % 16 == 0)
    device = q.device
    splits, chunk = _attend_plan(batch, heads, t, sm_count(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    ws, counters = split_workspace(
        device, stream, split_elements(batch * heads, splits, head_dim),
        batch * heads)
    out = torch.empty((batch, 1, heads, head_dim), dtype=torch.float32,
                      device=device)
    fn = _build.function(
        "cache_attend_int8", "veles_cache_attend_int8",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(),
             v_q.data_ptr(), v_scale.data_ptr(), mask.data_ptr(),
             out.data_ptr(), ws.data_ptr(), counters.data_ptr(), batch,
             heads, head_dim, t, chunk, _DTYPES[q.dtype], code16, *strides,
             stream)
    if err:
        raise RuntimeError("int8_cache_attend kernel launch failed: CUDA "
                           "error %d" % err)
    int8_cache_attend.launches += 1
    return out


def int8_cache_attend(q, k_q, k_scale, v_q, v_scale, mask_addend,
                      use_pallas=None):
    """Decode attention of one query token against an int8 KV cache in
    the head-major (B, H, D, T) layout (``quant.py:221-259``). ``q``
    (B, 1, H, D) float32 or bfloat16, already 1/sqrt(D)-scaled by the
    caller; per-(position, head) ``k_scale``/``v_scale`` (B, H, T) f32;
    ``mask_addend`` f32 (0 visible, -1e30 masked), (T,) or (1, T) shared
    or (B, T) per row. Returns (B, 1, H, D) f32.

    ``use_pallas`` picks the dequant-fused kernel (K4,
    ``csrc/cache_attend_int8.cu``): None runs it wherever its shape gate
    holds (T % 128 == 0 and D % 32 == 0, the JAX kernel's own gate) and
    the torch formulation elsewhere — unlike the JAX package, whose
    kernel is opt-in by a choice measured on the TPU; True runs it and
    raises where the gate fails; False runs the JAX package's XLA
    formulation in torch ops (the reference ``generate``'s attend, bf16
    rounding included). On a CUDA tensor the kernel launches
    (:attr:`int8_cache_attend.launches` counts it); on a CPU tensor its
    plain version runs. The codes, scales and mask may be views with
    positions minor (a slab cut to a span): the kernel reads them
    through their strides. It cuts T into splits over the card
    (:func:`_attend_plan`) and merges them in the same launch, in split
    order: two calls on the same inputs give bit-equal outputs."""
    _check_attend(q, k_q, k_scale, v_q, v_scale, mask_addend)
    gate = (k_q.shape[-1] % ATTEND_T_TILE == 0 and k_q.shape[-1] > 0
            and q.shape[-1] % ATTEND_D_TILE == 0)
    if use_pallas is None:
        use_pallas = gate
    if not use_pallas:
        return _cache_attend_xla(q, k_q, k_scale, v_q, v_scale, mask_addend)
    if not gate:
        raise ValueError(
            "int8_cache_attend's kernel wants T %% %d == 0 and D %% %d == "
            "0, got T=%d, D=%d (use_pallas=False runs the torch "
            "formulation)" % (ATTEND_T_TILE, ATTEND_D_TILE,
                              k_q.shape[-1], q.shape[-1]))
    if q.device.type == "cpu":
        return _cache_attend_plain(q, k_q, k_scale, v_q, v_scale,
                                   mask_addend)
    if q.device.type != "cuda":
        raise ValueError("int8_cache_attend runs on cuda or cpu tensors, "
                         "got %s" % q.device)
    return _launch_cache_attend(q, k_q, k_scale, v_q, v_scale, mask_addend)


#: kernel launches since the last reset
int8_cache_attend.launches = 0


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
