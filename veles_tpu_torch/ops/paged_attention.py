"""Fused paged decode attention: the page-table walk inside the kernel.

The port of ``veles_tpu/ops/paged_attention.py``: the float tier
(``paged_attend``, ``:151-198``, ``:287-315``) and the int8-KV tier
(``paged_attend_int8``, ``:201-247``, ``:318-344``). One query per slot
attends the slot's live KV pages, read through the page table; position
``lengths[s]`` (this step's append, which lands before the attend) is
visible, and only the first ``min(lengths[s] // page_size + 1, PB)``
pages are walked. Scores and the value product accumulate in f32 and the
output is f32, whatever the query and pool types.

On a CUDA tensor the hand-written kernel (``csrc/paged_attention.cu``,
``csrc/paged_attention_int8.cu``) runs at every head width, as the JAX
package's paged kernels take the whole head row whatever its width: up to
:data:`MAX_HEAD_DIM` from rows staged in shared memory, past it from
global memory with each split's sums in its workspace row
(``csrc/wide_attend.cuh``); on a CPU tensor the plain version, a
page-table gather followed by a masked softmax, computes the same
function.
"""

import ctypes
import math

import torch

from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops._workspace import sm_count, split_workspace

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the widest head K1, K3 and K4 stage in shared memory (K4's widths are
#: multiples of 32): past 1024 the kernels keep the split's f32
#: accumulator in shared memory beside the f32 query, and at 8192 the two
#: (64 KB) and the stages of the smallest tile fill the 227 KB of shared
#: memory a block may opt in to (``csrc/paged_attention.cu``,
#: ``csrc/int8_tile.cuh``). Wider heads take the wide path
#: (``csrc/wide_attend.cuh``), whose split sums live in the workspace even
#: with one split
MAX_HEAD_DIM = 8192

#: K1's (and K3's) plan: the positions a split holds at least (whole
#: pages) where the grid still fills the card, the blocks an SM it aims
#: at, and the most splits a slot may have (one block merges them all,
#: ``csrc/split_softmax.cuh``)
PAGED_SPLIT_POSITIONS = 128
PAGED_WAVE = 4
PAGED_MAX_SPLITS = 128


def _paged_plan(slots, heads, head_dim, pb, ps, sms):
    """K1's (and K3's) launch plan for ``slots`` x ``heads`` queries of
    width ``head_dim`` against a page table of ``pb`` pages of ``ps``
    positions, on a card of ``sms`` SMs: ``(pages, splits, elements)``.
    The kernel runs heads x splits x slots blocks, split s walking the
    table's pages [s * pages, (s + 1) * pages) (the last ragged where
    they do not divide, none empty); a block whose split starts past its
    slot's visible positions exits at once. A split is the fewest whole pages
    that hold :data:`PAGED_SPLIT_POSITIONS` positions, fewer (down to one
    page) where heads x slots x splits would not give every SM
    :data:`PAGED_WAVE` blocks, more where the table would need more than
    :data:`PAGED_MAX_SPLITS` splits. ``elements`` is the f32 workspace
    the split states take (:func:`split_elements`). The plan reads shapes
    only: the lengths are data on the card."""
    want = -(-PAGED_WAVE * sms // (slots * heads))
    pages = max(1, min(-(-PAGED_SPLIT_POSITIONS // ps), pb // want),
                -(-pb // PAGED_MAX_SPLITS))
    splits = -(-pb // pages)
    return pages, splits, split_elements(slots * heads, splits, head_dim)


def split_elements(items, splits, head_dim):
    """The f32 workspace of ``items`` (row, head) pairs of ``splits``
    splits at ``head_dim``: each split's (acc, max, sum) where several
    splits merge, or where the wide path keeps its sums there (past
    :data:`MAX_HEAD_DIM`); else 0."""
    if splits > 1 or head_dim > MAX_HEAD_DIM:
        return items * splits * (head_dim + 2)
    return 0


def gather_pages(pages, page_table):
    """Float tier: the pages of each row of ``page_table`` (B, NP) from
    one block's pool leaf ``pages`` (P, ps, H, D), as one
    (B, NP * ps, H, D) span each, in logical order."""
    rows, n_pages = page_table.shape
    return pages[page_table.long()].reshape(
        (rows, n_pages * pages.shape[1]) + tuple(pages.shape[2:]))


def _paged_attend_plain(q, k_pages, v_pages, page_table, lengths,
                        page_size):
    """Gather each slot's PB pages into one (S, PB * ps, H, D) span,
    mask positions past ``lengths`` with -1e30, softmax in f32."""
    head_dim = q.shape[2]
    span = page_table.shape[1] * page_size
    kg = gather_pages(k_pages, page_table).float()
    vg = gather_pages(v_pages, page_table).float()
    visible = (torch.arange(span, device=q.device)[None, :]
               <= lengths[:, None])
    scores = torch.einsum("shd,skhd->shk", q.float(), kg) \
        * (1.0 / math.sqrt(float(head_dim)))
    scores = torch.where(visible[:, None, :], scores,
                         torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("shk,skhd->shd", p, vg)


def _check(q, k_pages, v_pages, page_table, lengths, page_size):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("paged_attend wants q (S, H, D) and pool pages "
                         "(P, page_size, H, D), got %s and %s"
                         % (tuple(q.shape), tuple(k_pages.shape)))
    slots, heads, head_dim = q.shape
    if k_pages.shape != v_pages.shape \
            or tuple(k_pages.shape[1:]) != (page_size, heads, head_dim):
        raise ValueError("paged_attend pool pages %s / %s do not match "
                         "page_size %d and q %s"
                         % (tuple(k_pages.shape), tuple(v_pages.shape),
                            page_size, tuple(q.shape)))
    if page_table.dim() != 2 or page_table.shape[0] != slots \
            or page_table.shape[1] < 1 or tuple(lengths.shape) != (slots,):
        raise ValueError("paged_attend wants page_table (S, PB) and "
                         "lengths (S,), got %s and %s"
                         % (tuple(page_table.shape), tuple(lengths.shape)))
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attend wants int32 page_table and lengths, "
                        "got %s and %s" % (page_table.dtype, lengths.dtype))
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError("paged_attend takes float32 or bfloat16 q and "
                        "pools (one pool type), got %s, %s, %s"
                        % (q.dtype, k_pages.dtype, v_pages.dtype))
    devices = {t.device for t in (q, k_pages, v_pages, page_table,
                                  lengths)}
    if len(devices) != 1:
        raise ValueError("paged_attend operands on different devices: %s"
                         % sorted(str(d) for d in devices))


def paged_attend(q, k_pages, v_pages, page_table, lengths, *, page_size):
    """Fused paged decode attention, float tier. ``q`` (S, H, D);
    ``k_pages``/``v_pages`` one block's pool leaf (P, page_size, H, D);
    ``page_table`` (S, PB) int32 physical page ids in logical order
    (padding rows point at the scratch page); ``lengths`` (S,) int32
    live lengths (position ``lengths[s]`` is attended). Returns
    (S, H, D) float32.

    On CUDA tensors the kernel runs (and :attr:`paged_attend.launches`
    counts it) at any head width; the operands must be contiguous and
    page ids valid. It cuts the table's positions into splits
    of whole pages over the card (:func:`_paged_plan`) and merges each slot's live
    splits in the same launch, in split order: two calls on the same
    inputs give bit-equal outputs. On CPU tensors the plain version
    runs."""
    _check(q, k_pages, v_pages, page_table, lengths, page_size)
    if q.device.type == "cpu":
        return _paged_attend_plain(q, k_pages, v_pages, page_table,
                                   lengths, page_size)
    if q.device.type != "cuda":
        raise ValueError("paged_attend runs on cuda or cpu tensors, got %s"
                         % q.device)
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attend's kernel wants contiguous operands")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attend's kernel wants 16-byte aligned "
                         "pools")
    slots, heads, head_dim = q.shape
    device = q.device
    pb = page_table.shape[1]
    pages, _, elements = _paged_plan(slots, heads, head_dim, pb, page_size,
                                     sm_count(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    ws, counters = split_workspace(device, stream, elements, slots * heads)
    out = torch.empty((slots, heads, head_dim), dtype=torch.float32,
                      device=device)
    fn = _build.function(
        "paged_attention", "veles_paged_attend",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             ws.data_ptr(), counters.data_ptr(), slots, heads, head_dim, pb,
             page_size, pages, _DTYPES[q.dtype], _DTYPES[k_pages.dtype],
             stream)
    if err:
        raise RuntimeError("paged_attend kernel launch failed: CUDA error "
                           "%d" % err)
    paged_attend.launches += 1
    return out


#: kernel launches since the last reset (a plain integer the chip smoke
#: zeroes before driving the serving path)
paged_attend.launches = 0


def _paged_attend_int8_plain(q, k_q, k_scale, v_q, v_scale, page_table,
                             lengths, page_size):
    """Gather each slot's PB pages head-major into (S, H, D, PB * ps)
    codes and (S, H, PB * ps) scales (``kv_pool._gather_block_int8``),
    then ``int8_cache_attend``'s math in f32 throughout, as the TPU
    kernel computes it: scores ``(q . K8) * k_scale``, positions past
    ``lengths`` masked with -1e30, softmax, then ``p * v_scale``
    against V8."""
    slots, heads, head_dim = q.shape
    pb = page_table.shape[1]
    span = pb * page_size
    idx = page_table.long()

    def gather(codes, scale):
        codes = codes[idx].permute(0, 2, 3, 1, 4).reshape(
            slots, heads, head_dim, span)
        scale = scale[idx].permute(0, 2, 1, 3).reshape(slots, heads, span)
        return codes.float(), scale

    k8, ks = gather(k_q, k_scale)
    v8, vs = gather(v_q, v_scale)
    visible = (torch.arange(span, device=q.device)[None, :]
               <= lengths[:, None])[:, None, :]
    # selects, as the TPU kernel masks: whatever the scratch page holds
    # stays out of the max, the sum and the value product
    scores = torch.einsum("shd,shdt->sht", q.float(), k8) * ks
    p = torch.softmax(torch.where(visible, scores, -1e30), dim=-1)
    return torch.einsum("shdt,sht->shd", v8,
                        torch.where(visible, p * vs, 0.0))


def _check_int8(q, k_q, k_scale, v_q, v_scale, page_table, lengths,
                page_size):
    if q.dim() != 3 or k_q.dim() != 4:
        raise ValueError("paged_attend_int8 wants q (S, H, D) and pool "
                         "codes (P, H, D, page_size), got %s and %s"
                         % (tuple(q.shape), tuple(k_q.shape)))
    slots, heads, head_dim = q.shape
    pages = k_q.shape[0]
    if tuple(k_q.shape) != (pages, heads, head_dim, page_size) \
            or v_q.shape != k_q.shape \
            or tuple(k_scale.shape) != (pages, heads, page_size) \
            or v_scale.shape != k_scale.shape:
        raise ValueError(
            "paged_attend_int8 pool %s / %s with scales %s / %s does not "
            "match page_size %d and q %s"
            % (tuple(k_q.shape), tuple(v_q.shape), tuple(k_scale.shape),
               tuple(v_scale.shape), page_size, tuple(q.shape)))
    if page_table.dim() != 2 or page_table.shape[0] != slots \
            or page_table.shape[1] < 1 or tuple(lengths.shape) != (slots,):
        raise ValueError("paged_attend_int8 wants page_table (S, PB) and "
                         "lengths (S,), got %s and %s"
                         % (tuple(page_table.shape), tuple(lengths.shape)))
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attend_int8 wants int32 page_table and "
                        "lengths, got %s and %s"
                        % (page_table.dtype, lengths.dtype))
    if q.dtype not in _DTYPES or k_q.dtype != torch.int8 \
            or v_q.dtype != torch.int8 \
            or k_scale.dtype != torch.float32 \
            or v_scale.dtype != torch.float32:
        raise TypeError("paged_attend_int8 takes float32 or bfloat16 q, "
                        "int8 codes and float32 scales, got %s, %s, %s, "
                        "%s, %s" % (q.dtype, k_q.dtype, v_q.dtype,
                                    k_scale.dtype, v_scale.dtype))
    devices = {t.device for t in (q, k_q, k_scale, v_q, v_scale,
                                  page_table, lengths)}
    if len(devices) != 1:
        raise ValueError("paged_attend_int8 operands on different "
                         "devices: %s" % sorted(str(d) for d in devices))


def paged_attend_int8(q, k_q, k_scale, v_q, v_scale, page_table, lengths,
                      *, page_size):
    """Fused paged decode attention, int8-KV tier. ``q`` (S, H, D)
    float32 or bfloat16, ALREADY multiplied by 1/sqrt(D) (the caller's
    convention, ``kv_pool.py:415``); ``k_q``/``v_q`` one block's
    head-major pool leaf (P, H, D, page_size) int8 with ``k_scale``/
    ``v_scale`` (P, H, page_size) f32; ``page_table`` (S, PB) int32;
    ``lengths`` (S,) int32 (position ``lengths[s]`` is attended).
    Returns (S, H, D) float32.

    On CUDA tensors the kernel runs (and
    :attr:`paged_attend_int8.launches` counts it): the operands must be
    contiguous (any head width), the page size a multiple of 4 and page
    ids valid; other shapes raise ValueError. It
    cuts the table's
    positions into splits of whole pages over the card (K1's plan,
    :func:`_paged_plan`) and merges each slot's live splits in the same
    launch, in split order: two calls on the same inputs give bit-equal
    outputs. Positions past ``lengths`` count for nothing whatever the
    pool holds there. On CPU tensors the plain version runs."""
    _check_int8(q, k_q, k_scale, v_q, v_scale, page_table, lengths,
                page_size)
    if q.device.type == "cpu":
        return _paged_attend_int8_plain(q, k_q, k_scale, v_q, v_scale,
                                        page_table, lengths, page_size)
    if q.device.type != "cuda":
        raise ValueError("paged_attend_int8 runs on cuda or cpu tensors, "
                         "got %s" % q.device)
    tensors = (q, k_q, k_scale, v_q, v_scale, page_table, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attend_int8's kernel wants contiguous "
                         "operands")
    slots, heads, head_dim = q.shape
    if page_size % 4:
        raise ValueError(
            "paged_attend_int8's kernel takes a page size that is a "
            "multiple of 4, got %d" % page_size)
    if any(t.data_ptr() % 16 for t in (k_q, v_q, k_scale, v_scale)):
        raise ValueError("paged_attend_int8's kernel wants 16-byte "
                         "aligned pools")
    device = q.device
    pb = page_table.shape[1]
    pages, _, elements = _paged_plan(slots, heads, head_dim, pb, page_size,
                                     sm_count(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    ws, counters = split_workspace(device, stream, elements, slots * heads)
    out = torch.empty((slots, heads, head_dim), dtype=torch.float32,
                      device=device)
    fn = _build.function(
        "paged_attention_int8", "veles_paged_attend_int8",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(),
             v_q.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
             counters.data_ptr(), slots, heads, head_dim, pb, page_size,
             pages, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError("paged_attend_int8 kernel launch failed: CUDA "
                           "error %d" % err)
    paged_attend_int8.launches += 1
    return out


#: kernel launches since the last reset
paged_attend_int8.launches = 0
