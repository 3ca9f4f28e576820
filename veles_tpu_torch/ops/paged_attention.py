"""Fused paged decode attention: the page-table walk inside the kernel.

The port of ``veles_tpu/ops/paged_attention.py``'s float tier
(``paged_attend``, ``:151-198``, ``:287-315``). One query per slot
attends the slot's live KV pages, read through the page table; position
``lengths[s]`` (this step's append, which lands before the attend) is
visible, and only the first ``min(lengths[s] // page_size + 1, PB)``
pages are walked. Scores and the value product accumulate in f32 and the
output is f32, whatever the query and pool types.

On a CUDA tensor the hand-written kernel (``csrc/paged_attention.cu``)
runs; on a CPU tensor the plain version, a page-table gather followed by
a masked softmax, computes the same function.
"""

import ctypes
import math

import torch

from veles_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _paged_attend_plain(q, k_pages, v_pages, page_table, lengths,
                        page_size):
    """Gather each slot's PB pages into one (S, PB * ps, H, D) span,
    mask positions past ``lengths`` with -1e30, softmax in f32."""
    slots, heads, head_dim = q.shape
    pb = page_table.shape[1]
    span = pb * page_size
    idx = page_table.long()
    kg = k_pages[idx].reshape(slots, span, heads, head_dim).float()
    vg = v_pages[idx].reshape(slots, span, heads, head_dim).float()
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
    counts it); the operands must be contiguous and page ids valid. On
    CPU tensors the plain version runs."""
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
    row_bytes = head_dim * k_pages.element_size()
    if row_bytes not in (64, 128, 256, 512):
        raise ValueError("paged_attend's kernel takes head rows of 64, "
                         "128, 256 or 512 bytes, got head_dim %d in %s"
                         % (head_dim, k_pages.dtype))
    out = torch.empty((slots, heads, head_dim), dtype=torch.float32,
                      device=q.device)
    fn = _build.function(
        "paged_attention", "veles_paged_attend",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             slots, heads, head_dim, page_table.shape[1], page_size,
             _DTYPES[q.dtype], _DTYPES[k_pages.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("paged_attend kernel launch failed: CUDA error "
                           "%d" % err)
    paged_attend.launches += 1
    return out


#: kernel launches since the last reset (a plain integer the chip smoke
#: zeroes before driving the serving path)
paged_attend.launches = 0
