"""Paged KV pool for the serving engine.

The port of ``veles_tpu/parallel/kv_pool.py``'s float tier and cold
admission path (``:64-104``, ``:162-206``, ``:227-248``, ``:327-476``,
``:620-820``, ``:1047-1068``):

- **device side**: one ``(L, pages, page_size, H, D)`` pool plus the
  slot control tensors. A decode step appends each slot's K/V at its own
  position through the page table, in place (``index_put_`` into the
  pool: no copy of the pool is made), then attends with
  ``ops.paged_attention.paged_attend``, which walks the table itself.
- **host side**: :class:`PagePool` — free list, per-page refcounts and
  the page reservations that bound pool-aware admission.

Page 0 is the scratch page: never allocated, the target of every
padding page-table entry and of retired lanes' appends. The prefix
cache, the int8-KV tier and the tail/hit admissions are later slices.
"""

import threading

import torch
import torch.nn.functional as F

from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.ops.paged_attention import paged_attend
from veles_tpu_torch.ops.quant import matmul_any
from veles_tpu_torch.parallel.decode import _pick_token, _prefill_forward
from veles_tpu_torch.parallel.transformer_step import (_block_qkv, _head,
                                                       _mlp)

#: page 0 is the SCRATCH page: never allocated; padding page-table
#: entries and retired lanes point at it, and it is always masked
SCRATCH_PAGE = 0


def init_paged_state(n_blocks, pages, page_size, heads, head_dim, vocab,
                     slots, dtype=torch.float32, device=None):
    """Pool + control state for ``slots`` concurrent sequences over
    ``pages`` pages of ``page_size`` positions (page 0 is scratch).
    K/V ``(L, P, page_size, H, D)``; per-slot ``lengths`` (int32) and
    ``logits`` (float32, the next token's)."""
    device = resolve_device(device)
    shape = (n_blocks, pages, page_size, heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "lengths": torch.zeros((slots,), dtype=torch.int32, device=device),
        "logits": torch.zeros((slots, vocab), dtype=torch.float32,
                              device=device),
    }


def _scatter_pages(state, page_ids, k_all, v_all):
    """Write stacked prefill K/V (L, B, T, H, D) into the pool pages
    ``page_ids`` (B, NP) in place, positions zero-padded to whole pages.
    Stale padding positions are rewritten by a sequence's own appends
    before any mask exposes them; rows padded with the scratch page may
    race on it, which is harmless by definition."""
    n_pages = page_ids.shape[1]
    ps = state["k"].shape[2]
    idx = page_ids.long()
    for name, val in (("k", k_all), ("v", v_all)):
        val = val.to(state[name].dtype)
        t = val.shape[2]
        if t < n_pages * ps:
            val = F.pad(val, (0, 0, 0, 0, 0, n_pages * ps - t))
        lb = val.shape[:2]
        state[name][:, idx] = val.reshape(lb + (n_pages, ps)
                                          + val.shape[3:])


def paged_admit_many(params, heads, state, slots, page_ids, prompt_x,
                     lengths):
    """Cold paged admission of one ragged group: prefill ``prompt_x``
    (B, T, E) — rows right-padded to the group's page-rounded width —
    scatter the K/V into ``page_ids`` (B, NP) and write the control rows
    of ``slots`` (B,). ``lengths`` (B,) are the true prompt lengths.
    Updates ``state`` in place and returns it."""
    logits, k_all, v_all, lengths = _prefill_forward(params, prompt_x,
                                                     heads, lengths)
    slots = slots.long()
    state["lengths"][slots] = lengths.to(torch.int32)
    state["logits"][slots] = logits.float()
    _scatter_pages(state, page_ids, k_all, v_all)
    return state


def paged_slot_step(params, embed_table, heads, state, page_table, active,
                    temperature=1.0, sample=False, top_k=0,
                    generator=None):
    """One decode step across all slots. ``page_table`` (S, PB) int32
    lists each slot's pages in logical order (padding and retired rows
    point at scratch); ``active`` (S,) bool gates which slots advance.
    The token emitted at this step is picked from the PRE-step logits
    (the first one from the prefill's), as ``generate`` emits. Each
    slot's K/V append lands at position ``lengths[s]`` — page
    ``page_table[s, min(pos // ps, PB - 1)]``, offset ``pos % ps`` —
    before the attend, which sees it. Updates ``state`` in place;
    returns ``(state, emitted (S,))`` without a host sync."""
    slots = state["lengths"].shape[0]
    ps = state["k"].shape[2]
    pb = page_table.shape[1]
    lengths = state["lengths"]
    tok_in = _pick_token(state["logits"], generator, temperature, sample,
                         top_k)
    x = embed_table[tok_in][:, None, :]
    embed = x.shape[-1]
    logical = torch.clamp(lengths // ps, max=pb - 1).long()
    page = page_table.gather(1, logical[:, None])[:, 0].long()
    off = (lengths % ps).long()
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _block_qkv(blk, x, heads)
        state["k"][i, page, off] = k[:, 0].to(state["k"].dtype)
        state["v"][i, page, off] = v[:, 0].to(state["v"].dtype)
        att = paged_attend(q[:, 0].contiguous(), state["k"][i],
                           state["v"][i], page_table, lengths,
                           page_size=ps)
        att = att.to(x.dtype)
        x = x + matmul_any(att.reshape(slots, 1, embed),
                           blk["wout"]) + blk["bout"]
        x = _mlp(blk, x)
    logits = _head(params, x[:, 0]).float()
    state["lengths"] = torch.where(active, lengths + 1, lengths)
    state["logits"] = torch.where(active[:, None], logits, state["logits"])
    return state, tok_in


def paged_slot_step_many(params, embed_table, heads, state, page_table,
                         active, n, temperature=1.0, sample=False,
                         top_k=0, generator=None):
    """``n`` lockstep paged steps; the page table is constant across the
    chunk (the host pre-maps every page its appends can touch). Returns
    ``(state, emitted (n, S))``, still on the device."""
    emitted = []
    for _ in range(n):
        state, tok = paged_slot_step(params, embed_table, heads, state,
                                     page_table, active, temperature,
                                     sample, top_k, generator)
        emitted.append(tok)
    return state, torch.stack(emitted)


class PagePool:
    """Host-side page table: free list, per-page refcounts and admission
    reservations.

    Thread model: the decoder's driver thread allocates and frees; the
    HTTP admission gate reserves from handler threads — every mutation
    takes the one lock. A live slot holds one ref per mapped page; a
    page returns to the free list when its count reaches zero."""

    def __init__(self, pages, page_size):
        if pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is "
                             "scratch), got %d" % pages)
        if page_size < 1:
            raise ValueError("page_size must be >= 1, got %d"
                             % page_size)
        self.pages = int(pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        self._free = list(range(self.pages - 1, SCRATCH_PAGE, -1))
        self._refs = {}
        self._reserved = 0

    @property
    def capacity(self):
        """Allocatable pages (scratch excluded)."""
        return self.pages - 1

    @property
    def free_pages(self):
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self):
        with self._lock:
            return self.capacity - len(self._free)

    def snapshot(self):
        with self._lock:
            return {"pages_total": self.capacity,
                    "pages_used": self.capacity - len(self._free),
                    "pages_free": len(self._free),
                    "page_size": self.page_size,
                    "reserved_pages": self._reserved}

    def alloc(self, n):
        """Allocate ``n`` pages (refcount 1 each); returns the page ids,
        or None when the free list is too short."""
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                return None
            pages = [self._free.pop() for _ in range(n)]
            for page in pages:
                self._refs[page] = 1
            return pages

    def retain(self, pages):
        """Add one ref per page (a second holder of the same pages)."""
        with self._lock:
            for page in pages:
                self._refs[page] += 1

    def release(self, pages):
        """Drop one ref per page; refcount-0 pages return to the free
        list."""
        with self._lock:
            for page in pages:
                refs = self._refs.get(page)
                if refs is None:
                    continue
                if refs <= 1:
                    del self._refs[page]
                    self._free.append(page)
                else:
                    self._refs[page] = refs - 1

    def try_reserve(self, n):
        """Reserve worst-case page demand for one admission: the sum of
        live reservations never exceeds capacity, so an admitted request
        can always be given its pages (the no-deadlock invariant of the
        HTTP gate)."""
        with self._lock:
            if self._reserved + n > self.capacity:
                return False
            self._reserved += n
            return True

    def unreserve(self, n):
        with self._lock:
            self._reserved = max(0, self._reserved - n)


def pages_for(positions, page_size):
    """Pages needed to hold ``positions`` tokens (>= 1)."""
    return max(1, -(-int(positions) // int(page_size)))


def default_pool_pages(slots, max_len, page_size, chunk=1):
    """Slab-equivalent pool size: every slot full to ``max_len`` plus the
    lag-1 pipeline's dispatch overshoot of up to two chunks, plus the
    scratch page (``kv_pool.py:1052-1068``)."""
    return int(slots) * pages_for(int(max_len) + 2 * int(chunk),
                                  page_size) + 1
