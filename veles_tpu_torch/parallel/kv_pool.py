"""Paged KV pool with shared-prefix reuse for the serving engine.

The port of ``veles_tpu/parallel/kv_pool.py``'s single-chip engine
(``:64-330``, ``:327-476``, ``:572-921``, ``:1047-1068``):

- **device side**: one ``(L, pages, page_size, H, D)`` pool, or in the
  int8-KV tier head-major ``(L, pages, H, D, page_size)`` int8 codes
  with ``(L, pages, H, page_size)`` f32 scales, plus the slot control
  tensors. A decode step appends each slot's K/V at its own position
  through the page table, in place (``index_put_`` into the pool: no
  copy of the pool is made), then attends with
  ``ops.paged_attention.paged_attend`` / ``paged_attend_int8``, which
  walk the table themselves. Three admissions write a slot: cold (full
  prefill scattered into fresh pages), tail (prefill only the unique
  tail against the pooled prefix pages) and hit (control rows only).
- **host side**: :class:`PagePool` — free list, per-page refcounts, the
  LRU :class:`PrefixCache` of page-granular token prefixes, the page
  reservations that bound pool-aware admission, and the page-release
  window that prices ``Retry-After``.

Page 0 is the scratch page: never allocated, the target of every
padding page-table entry and of retired lanes' appends. Only whole pages
are shared, and a slot's appends land past its prompt, so a shared page
is never written. The int8-KV tier reuses exact prompts only: its pool
holds rounded K/V while a prefill attends exact values, so a tail
prefilled against rounded prefix pages would not match a cold prefill.
The prefix cache outlives its pool (``:597-617``, ``:923-1044``,
``:479-490``): when the serving breaker rebuilds a decoder,
:meth:`PagePool.capture_shadows` copies every cached page's payload to
the host from the dying decoder's state, and the fresh pool built with
``cache=`` adopts the entries by page copy (:meth:`PagePool.
restore_entries`, :func:`_paged_restore`), never by a new prefill. The
mesh functions and AOT are later slices.
"""

import collections
import hashlib
import threading
import time

import numpy
import torch
import torch.nn.functional as F

from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.ops.attention import plain_attention
from veles_tpu_torch.ops.paged_attention import (gather_pages,
                                                 paged_attend,
                                                 paged_attend_int8)
from veles_tpu_torch.ops.quant import matmul_any
from veles_tpu_torch.parallel.decode import (_pick_token, _prefill_forward,
                                             _quantize_kv, advance_control,
                                             control_state, write_control)
from veles_tpu_torch.parallel.transformer_step import (_block_qkv, _head,
                                                       _mlp)

#: page 0 is the SCRATCH page: never allocated; padding page-table
#: entries and retired lanes point at it, and it is always masked
SCRATCH_PAGE = 0

#: the state leaves whose bytes belong to the page pool
PAGED_KV_LEAVES = ("k", "v", "k_scale", "v_scale")

#: prefix-cache entries kept before LRU eviction
PREFIX_CACHE_ENTRIES = 256

#: trailing seconds of page releases that price Retry-After
RELEASE_WINDOW_S = 60.0

#: Retry-After seconds when no page was released in the window
RETRY_AFTER_FALLBACK_S = 1.0


def init_paged_state(n_blocks, pages, page_size, heads, head_dim, vocab,
                     slots, dtype=torch.float32, quantized=False,
                     device=None):
    """Pool + control state for ``slots`` concurrent sequences over
    ``pages`` pages of ``page_size`` positions (page 0 is scratch).
    Float tier: K/V ``(L, P, page_size, H, D)`` in ``dtype``.
    ``quantized``: int8 K/V ``(L, P, H, D, page_size)`` with f32
    ``k_scale``/``v_scale`` ``(L, P, H, page_size)``. Per-slot
    control rows as the slab's (``decode.control_state``): ``lengths``,
    ``step``, ``req_key`` and ``logits``."""
    device = resolve_device(device)
    state = control_state(slots, vocab, device)
    if quantized:
        qshape = (n_blocks, pages, heads, head_dim, page_size)
        sshape = (n_blocks, pages, heads, page_size)
        for name in ("k", "v"):
            state[name] = torch.zeros(qshape, dtype=torch.int8,
                                      device=device)
            state[name + "_scale"] = torch.zeros(sshape, device=device)
    else:
        shape = (n_blocks, pages, page_size, heads, head_dim)
        for name in ("k", "v"):
            state[name] = torch.zeros(shape, dtype=dtype, device=device)
    return state


def _page_size_of(state):
    """The page size from the pool's shape: the minor axis of the int8
    head-major layout, axis 2 of the float one."""
    return (state["k"].shape[-1] if "k_scale" in state
            else state["k"].shape[2])


def paged_kv_bytes(state):
    """Device bytes of the page arrays of a paged state (both tiers)."""
    return sum(state[name].numel() * state[name].element_size()
               for name in PAGED_KV_LEAVES if name in state)


def _pad_pages(val, n_pages, ps):
    """Zero-pad the positions axis (axis 2 of an (L, B, T, ...) stack)
    to whole pages and split it into (n_pages, ps)."""
    t = val.shape[2]
    if t < n_pages * ps:
        pad = [0, 0] * (val.dim() - 3) + [0, n_pages * ps - t]
        val = F.pad(val, pad)
    return val.reshape(val.shape[:2] + (n_pages, ps) + val.shape[3:])


def _scatter_pages(state, page_ids, k_all, v_all):
    """Write stacked prefill K/V (L, B, T, H, D) into the pool pages
    ``page_ids`` (B, NP) in place, positions zero-padded to whole pages
    (the int8 tier quantizes first and pads codes and scales with
    zeros, as the JAX package does). Stale padding positions are
    rewritten by a sequence's own appends before any mask exposes them;
    rows padded with the scratch page may race on it, which is harmless
    by definition."""
    n_pages = page_ids.shape[1]
    ps = _page_size_of(state)
    idx = page_ids.long()
    for name, val in (("k", k_all), ("v", v_all)):
        if "k_scale" in state:
            q8, scale = _quantize_kv(val)      # (L,B,T,H,D), (L,B,T,H)
            state[name][:, idx] = _pad_pages(q8, n_pages, ps).permute(
                0, 1, 2, 4, 5, 3)
            state[name + "_scale"][:, idx] = _pad_pages(
                scale, n_pages, ps).permute(0, 1, 2, 4, 3)
        else:
            state[name][:, idx] = _pad_pages(val.to(state[name].dtype),
                                             n_pages, ps)


def paged_admit_many(params, heads, state, slots, page_ids, prompt_x,
                     lengths, req_keys=None):
    """Cold paged admission of one ragged group: prefill ``prompt_x``
    (B, T, E) — rows right-padded to the group's page-rounded width —
    scatter the K/V into ``page_ids`` (B, NP) and write the control rows
    of ``slots`` (B,). ``lengths`` (B,) are the true prompt lengths,
    ``req_keys`` (B,) the rows' sampling keys. Updates ``state`` in
    place and returns it."""
    logits, k_all, v_all, lengths = _prefill_forward(params, prompt_x,
                                                     heads, lengths)
    write_control(state, slots, lengths, logits, req_keys)
    _scatter_pages(state, page_ids, k_all, v_all)
    return state


def paged_admit_tail(params, heads, state, slots, prefix_pages,
                     tail_pages, tail_x, lengths, req_keys=None):
    """Prefix-hit admission, float tier: prefill ONLY the unique tail.
    The shared prefix (``prefix_pages`` (B, PP), whole pages) is
    gathered from the pool as attention context; the tail tokens
    (``tail_x`` (B, Tt, E), rows right-padded to the group's
    page-rounded tail width) run the blocks under the prefix-offset
    causal mask (tail row j sees prefix and tail positions up to
    ``PP * ps + j``) and scatter their K/V into ``tail_pages`` (B, NT).
    ``lengths`` (B,) are the true TOTAL lengths, ``req_keys`` (B,) the
    rows' sampling keys. Plain torch attention,
    as the JAX package runs XLA's here. Updates ``state`` in place and
    returns it."""
    if "k_scale" in state:
        raise ValueError("the int8-KV pool takes exact-prompt hits only; "
                         "tail admissions are float tier")
    batch, t_tail, embed = tail_x.shape
    shared = prefix_pages.shape[1] * _page_size_of(state)
    x = tail_x
    ks, vs = [], []
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _block_qkv(blk, x, heads)
        ks.append(k)
        vs.append(v)
        kp = gather_pages(state["k"][i], prefix_pages).to(q.dtype)
        vp = gather_pages(state["v"][i], prefix_pages).to(q.dtype)
        att = plain_attention(q, torch.cat([kp, k], dim=1),
                              torch.cat([vp, v], dim=1), causal=True)
        x = x + matmul_any(att.reshape(batch, t_tail, embed),
                           blk["wout"]) + blk["bout"]
        x = _mlp(blk, x)
    rows = torch.arange(batch, device=x.device)
    last = x[rows, torch.clamp(lengths.long() - shared - 1, min=0)]
    write_control(state, slots, lengths, _head(params, last), req_keys)
    _scatter_pages(state, tail_pages, torch.stack(ks), torch.stack(vs))
    return state


def paged_admit_hit(state, slots, lengths, logits, req_keys=None):
    """Full-prompt prefix hit: the prompt's pages are already in the
    pool, so only the control rows are written, ``logits`` (B, V) being
    the cold prefill's cached last-position logits and ``req_keys`` (B,)
    the rows' sampling keys. Updates ``state`` in place and returns
    it."""
    write_control(state, slots, lengths, logits, req_keys)
    return state


def paged_slot_step(params, embed_table, heads, state, page_table, active,
                    temperature=1.0, sample=False, top_k=0):
    """One decode step across all slots. ``page_table`` (S, PB) int32
    lists each slot's pages in logical order (padding and retired rows
    point at scratch); ``active`` (S,) bool gates which slots advance.
    The token emitted at this step is picked from the PRE-step logits
    (the first one from the prefill's), as ``generate`` emits; a sampled
    one from the slot's (``req_key``, ``step``), as the slab picks. Each
    slot's K/V append lands at position ``lengths[s]`` — page
    ``page_table[s, min(pos // ps, PB - 1)]``, offset ``pos % ps`` —
    before the attend, which sees it. The int8-KV tier quantizes the
    append per (slot, head) and attends through ``paged_attend_int8``
    with q pre-scaled by 1/sqrt(D) in q's type. Updates ``state`` in
    place; returns ``(state, emitted (S,))`` without a host sync."""
    slots = state["lengths"].shape[0]
    quantized = "k_scale" in state
    ps = _page_size_of(state)
    pb = page_table.shape[1]
    lengths = state["lengths"]
    # a greedy step reads no key
    keys, steps = ((state["req_key"], state["step"]) if sample
                   else (None, None))
    tok_in = _pick_token(state["logits"], keys, steps, temperature, sample,
                         top_k)
    x = embed_table[tok_in][:, None, :]
    embed = x.shape[-1]
    inv_sqrt = (embed // heads) ** -0.5
    logical = torch.clamp(lengths // ps, max=pb - 1).long()
    page = page_table.gather(1, logical[:, None])[:, 0].long()
    off = (lengths % ps).long()
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _block_qkv(blk, x, heads)
        if quantized:
            # the int index and the two index tensors around the slices
            # put the slot axis first: the target is (S, H, D)
            for name, val in (("k", k), ("v", v)):
                q8, scale = _quantize_kv(val[:, 0])     # (S,H,D), (S,H)
                state[name][i, page, :, :, off] = q8
                state[name + "_scale"][i, page, :, off] = scale
            att = paged_attend_int8(
                (q * inv_sqrt)[:, 0].contiguous(), state["k"][i],
                state["k_scale"][i], state["v"][i], state["v_scale"][i],
                page_table, lengths, page_size=ps)
        else:
            state["k"][i, page, off] = k[:, 0].to(state["k"].dtype)
            state["v"][i, page, off] = v[:, 0].to(state["v"].dtype)
            att = paged_attend(q[:, 0].contiguous(), state["k"][i],
                               state["v"][i], page_table, lengths,
                               page_size=ps)
        att = att.to(x.dtype)
        x = x + matmul_any(att.reshape(slots, 1, embed),
                           blk["wout"]) + blk["bout"]
        x = _mlp(blk, x)
    advance_control(state, active, _head(params, x[:, 0]).float())
    return state, tok_in


def paged_slot_step_many(params, embed_table, heads, state, page_table,
                         active, n, temperature=1.0, sample=False,
                         top_k=0):
    """``n`` lockstep paged steps; the page table is constant across the
    chunk (the host pre-maps every page its appends can touch). Returns
    ``(state, emitted (n, S))``, still on the device."""
    emitted = []
    for _ in range(n):
        state, tok = paged_slot_step(params, embed_table, heads, state,
                                     page_table, active, temperature,
                                     sample, top_k)
        emitted.append(tok)
    return state, torch.stack(emitted)


def _boundary_keys(tokens, page_size, whole):
    """The prefix keys of every whole-page boundary (``tokens[:k * ps]``
    for k = 1..whole) in one O(T) pass: one SHA-1 advanced page by page
    and copied at each boundary, so each digest is the SHA-1 of the
    prefix's int32 bytes, the JAX package's key (a hash collision is
    guarded by an exact token comparison on lookup)."""
    data = numpy.ascontiguousarray(tokens, numpy.int32)
    hasher = hashlib.sha1()
    keys = []
    for k in range(whole):
        hasher.update(data[k * page_size:(k + 1) * page_size].tobytes())
        keys.append(hasher.copy().hexdigest())
    return keys


class PrefixCache:
    """LRU cache of page-granular token prefixes: each entry holds the
    prefix tokens, its page ids (one pool ref per page) and, at an
    admission's exact-prompt boundary, a copy of the prefill's
    last-position logits; at most ``max_entries`` entries. It lives
    outside the device state, so a breaker rebuild carries it to the
    next pool: ``page_shadow`` holds host copies of cached pages'
    payloads for the restore. Counters are cumulative across
    rebuilds."""

    def __init__(self, max_entries=PREFIX_CACHE_ENTRIES):
        self.max_entries = int(max_entries)
        self.entries = collections.OrderedDict()   # key -> entry
        self.page_shadow = {}                      # page id -> {leaf: t}
        self.counters = {"hits": 0, "misses": 0, "evictions": 0}

    def __len__(self):
        return len(self.entries)


class PagePool:
    """Host-side page table: free list, per-page refcounts, the prefix
    cache, admission reservations and the page-release window.

    Thread model: the decoder's driver thread allocates and frees; the
    HTTP admission gate reserves from handler threads — every mutation
    takes the one re-entrant lock. A live slot holds one ref per mapped
    page and each prefix-cache entry one ref per page it names; a page
    returns to the free list when its count reaches zero, and cache
    entries are evicted LRU-first when an allocation runs short."""

    def __init__(self, pages, page_size, cache=None):
        if pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is "
                             "scratch), got %d" % pages)
        if page_size < 1:
            raise ValueError("page_size must be >= 1, got %d"
                             % page_size)
        self.pages = int(pages)
        self.page_size = int(page_size)
        self._lock = threading.RLock()
        self._free = list(range(self.pages - 1, SCRATCH_PAGE, -1))
        self._refs = {}
        self._reserved = 0
        #: (monotonic stamp, pages freed): the observed release rate
        #: that prices Retry-After
        self._freed_events = collections.deque(maxlen=512)
        #: a previous pool's cache (its entries name that pool's pages
        #: until :meth:`restore_entries` re-maps them), or a fresh one
        self.cache = cache if cache is not None else PrefixCache()

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
            hits = self.cache.counters["hits"]
            misses = self.cache.counters["misses"]
            return {"pages_total": self.capacity,
                    "pages_used": self.capacity - len(self._free),
                    "pages_free": len(self._free),
                    "page_size": self.page_size,
                    "reserved_pages": self._reserved,
                    "prefix_entries": len(self.cache),
                    "prefix_hits": hits,
                    "prefix_misses": misses,
                    "prefix_evictions": self.cache.counters["evictions"],
                    "prefix_hit_rate": (round(hits / (hits + misses), 4)
                                        if hits + misses else None)}

    def alloc(self, n):
        """Allocate ``n`` pages (refcount 1 each), evicting LRU prefix
        entries under pressure; returns the page ids, or None when the
        pool cannot serve them even after eviction."""
        if n <= 0:
            return []
        with self._lock:
            while len(self._free) < n and self._evict_lru():
                pass
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
        list and feed the release-rate window."""
        freed = 0
        with self._lock:
            for page in pages:
                refs = self._refs.get(page)
                if refs is None:
                    continue
                if refs <= 1:
                    del self._refs[page]
                    self._free.append(page)
                    self.cache.page_shadow.pop(page, None)
                    freed += 1
                else:
                    self._refs[page] = refs - 1
            if freed:
                self._freed_events.append((time.monotonic(), freed))

    def _evict_lru(self):
        """Drop the least recently used prefix entry and its refs (pages
        a live slot maps stay until it retires); False when the cache is
        empty."""
        with self._lock:
            if not self.cache.entries:
                return False
            _, entry = self.cache.entries.popitem(last=False)
            self.cache.counters["evictions"] += 1
            self.release(entry["pages"])
            return True

    def flush_prefix_cache(self):
        """Drop every prefix entry and its page refs (what a weight swap
        must do: cached pages and logits were computed under the old
        weights). Returns the number of entries dropped."""
        dropped = 0
        with self._lock:
            while self._evict_lru():
                dropped += 1
            self.cache.page_shadow.clear()
        return dropped

    def shadow_bytes(self):
        """Host bytes the cache's page shadows hold."""
        return sum(t.numel() * t.element_size()
                   for leaves in list(self.cache.page_shadow.values())
                   for t in list(leaves.values()))

    def try_reserve(self, n):
        """Reserve worst-case page demand for one admission: the sum of
        live reservations never exceeds capacity, so an admitted request
        can always be given its pages (prefix sharing and eviction only
        free pages relative to the worst case) — the no-deadlock
        invariant of the HTTP gate."""
        with self._lock:
            if self._reserved + n > self.capacity:
                return False
            self._reserved += n
            return True

    def unreserve(self, n):
        with self._lock:
            self._reserved = max(0, self._reserved - n)

    def release_rate(self):
        """Observed page releases per second over the trailing
        :data:`RELEASE_WINDOW_S` seconds (0.0 when nothing was freed in
        it)."""
        now = time.monotonic()
        with self._lock:
            events = [(t, n) for t, n in self._freed_events
                      if now - t <= RELEASE_WINDOW_S]
        if not events:
            return 0.0
        span = max(now - events[0][0], 1e-3)
        return sum(n for _, n in events) / span

    def retry_after(self, need):
        """Retry-After for a pool rejection: the seconds the observed
        release rate needs to free ``need`` pages, clamped to [1, 60];
        :data:`RETRY_AFTER_FALLBACK_S` when nothing was freed lately."""
        rate = self.release_rate()
        if rate <= 0:
            return RETRY_AFTER_FALLBACK_S
        return float(min(60.0, max(1.0, need / rate)))

    def lookup(self, tokens, allow_partial=True):
        """The longest page-granular cached prefix of ``tokens``:
        returns ``(entry, shared_len)`` with the shared pages RETAINED
        for the caller's slot, or ``(None, 0)``. A full-prompt match
        needs stored logits (otherwise the last page counts as tail);
        ``allow_partial=False`` (the int8-KV tier) takes exact-prompt
        hits only. No counter moves: the caller books
        :meth:`book_hit` / :meth:`book_miss` once the admission
        commits, and :meth:`unlookup` rolls a hit back."""
        ps = self.page_size
        tokens = numpy.asarray(tokens, numpy.int32)
        n = len(tokens)
        keys = _boundary_keys(tokens, ps, n // ps)   # outside the lock
        with self._lock:
            for k in range(n // ps, 0, -1):
                shared = k * ps
                if shared != n and not allow_partial:
                    continue
                entry = self.cache.entries.get(keys[k - 1])
                if entry is None or not numpy.array_equal(
                        entry["tokens"], tokens[:shared]):
                    continue
                if shared == n and entry["logits"] is None:
                    continue
                self.cache.entries.move_to_end(keys[k - 1])
                self.retain(entry["pages"])
                return entry, shared
            return None, 0

    def book_hit(self):
        """Count one prefix-cache hit, when the admission commits."""
        with self._lock:
            self.cache.counters["hits"] += 1

    def book_miss(self):
        """Count one miss, when the cold admission commits (a request
        blocked on pages and scanned again every pass counts once)."""
        with self._lock:
            self.cache.counters["misses"] += 1

    def unlookup(self, entry):
        """Roll a :meth:`lookup` hit back (the caller could not admit):
        drop the retained refs. The hit was never booked."""
        self.release(entry["pages"])

    def insert(self, tokens, pages, logits=None):
        """Publish an admission's whole pages: one entry per page
        boundary (``tokens[:k * ps]``, its first k ``pages``), each
        holding refs on its pages, ``logits`` (a copy the caller owns:
        the slot's row is written again by later admissions) attached
        at the exact-length boundary."""
        ps = self.page_size
        tokens = numpy.asarray(tokens, numpy.int32)
        whole = len(tokens) // ps
        if whole == 0:
            return
        keys = _boundary_keys(tokens, ps, whole)     # outside the lock
        with self._lock:
            for k in range(1, whole + 1):
                shared = k * ps
                entry = self.cache.entries.get(keys[k - 1])
                boundary_logits = logits if shared == len(tokens) else None
                if entry is not None:
                    self.cache.entries.move_to_end(keys[k - 1])
                    if entry["logits"] is None:
                        entry["logits"] = boundary_logits
                    continue
                entry_pages = list(pages[:k])
                self.retain(entry_pages)
                self.cache.entries[keys[k - 1]] = {
                    "tokens": tokens[:shared].copy(),
                    "pages": entry_pages,
                    "length": shared,
                    "logits": boundary_logits,
                }
            while len(self.cache.entries) > self.cache.max_entries:
                self._evict_lru()

    def capture_shadows(self, state):
        """Copy every cached page that has no shadow yet to the host, from
        ``state`` (the dying decoder's, on a breaker trip): cached pages
        are read-only (appends land past a prompt, a divergence takes
        fresh pages), so the bytes at the trip are the bytes published.
        The copy runs outside the lock (entry refs pin the pages); a page
        evicted meanwhile is not shadowed, since it may already hold
        another prefix."""
        with self._lock:
            named = {page for entry in self.cache.entries.values()
                     for page in entry["pages"]}
            missing = sorted(page for page in named
                             if page not in self.cache.page_shadow)
        shadows = _shadow_pages(state, missing)
        with self._lock:
            still = {page for entry in self.cache.entries.values()
                     for page in entry["pages"]}
            for page, shadow in shadows.items():
                if page in still:
                    self.cache.page_shadow.setdefault(page, shadow)

    def restore_entries(self, state, restore_fn):
        """Adopt a previous pool's prefix cache into THIS (fresh) pool:
        allocate new pages for the union of the cached pages, copy the
        shadowed payloads into them with ``restore_fn(state, page_ids,
        values) -> state`` and re-point every entry. Entries naming a
        page without a shadow, and the oldest entries where the fresh
        pool is smaller, are dropped and counted as evictions. Returns
        the updated state."""
        cache = self.cache
        with self._lock:
            old_pages = []
            for entry in cache.entries.values():
                for page in entry["pages"]:
                    if page not in old_pages:
                        old_pages.append(page)
            old_pages = [p for p in old_pages if p in cache.page_shadow]
            for key in [k for k, e in cache.entries.items()
                        if any(p not in cache.page_shadow
                               for p in e["pages"])]:
                del cache.entries[key]
                cache.counters["evictions"] += 1
            shadow = dict(cache.page_shadow)
            cache.page_shadow = {}
            # sized against the free list: the entries name the OLD
            # pool's pages, so evicting them frees nothing here
            while old_pages and len(self._free) < len(old_pages):
                cache.entries.popitem(last=False)
                cache.counters["evictions"] += 1
                still = set()
                for entry in cache.entries.values():
                    still.update(entry["pages"])
                old_pages = [p for p in old_pages if p in still]
            if not old_pages:
                cache.entries.clear()
                return state
            new_ids = self.alloc(len(old_pages))
            mapping = dict(zip(old_pages, new_ids))
            for old, new in mapping.items():
                cache.page_shadow[new] = shadow[old]
            # alloc gave each page one ref: add the other entries' refs
            counts = {}
            for entry in cache.entries.values():
                entry["pages"] = [mapping[p] for p in entry["pages"]]
                for page in entry["pages"]:
                    counts[page] = counts.get(page, 0) + 1
            for page, count in counts.items():
                if count > 1:
                    self.retain([page] * (count - 1))
            # shadowed pages no entry names any more (their entries were
            # dropped for another unshadowed page) go back unrestored
            orphan = [p for p in new_ids if p not in counts]
            if orphan:
                self.release(orphan)
                for page in orphan:
                    cache.page_shadow.pop(page, None)
                new_ids = [p for p in new_ids if p in counts]
        values = _stack_shadow(cache.page_shadow, new_ids)
        if values:
            state = restore_fn(state, new_ids, values)
        return state


def _shadow_pages(state, pages):
    """Host copies of ``pages``' payloads across every pool leaf, one
    gather and one device-to-host copy a leaf: ``{page: {leaf: (L,
    ...page shape)}}``. They survive the decoder; the restore copies them
    into a fresh pool."""
    if not pages:
        return {}
    idx = torch.tensor(pages, dtype=torch.long, device=state["k"].device)
    stacked = {name: state[name].index_select(1, idx).cpu()
               for name in PAGED_KV_LEAVES if name in state}
    return {page: {name: val[:, i].clone()
                   for name, val in stacked.items()}
            for i, page in enumerate(pages)}


def _stack_shadow(page_shadow, page_ids):
    """Per-page shadows stacked into one (L, NP, ...) host tensor per
    leaf for the restore."""
    if not page_ids:
        return {}
    leaves = page_shadow[page_ids[0]].keys()
    return {name: torch.stack([page_shadow[p][name] for p in page_ids],
                              dim=1)
            for name in leaves}


def _paged_restore(state, page_ids, values):
    """The rebuild's restore: copy the preserved payloads ``values``
    (one (L, NP, ...) host tensor per pool leaf) into the FRESH pool at
    the pages ``page_ids`` (NP,), in place, with ``index_copy_`` over the
    page axis of every leaf (``k``, ``v`` and, in the int8-KV pool,
    ``k_scale`` and ``v_scale``). Returns ``state``."""
    idx = torch.tensor(page_ids, dtype=torch.long, device=state["k"].device)
    for name, val in values.items():
        state[name].index_copy_(1, idx, val.to(device=state[name].device,
                                               dtype=state[name].dtype))
    return state


def pages_for(positions, page_size):
    """Pages needed to hold ``positions`` tokens (>= 1)."""
    return max(1, -(-int(positions) // int(page_size)))


def default_pool_pages(slots, max_len, page_size, chunk=1):
    """Slab-equivalent pool size: every slot full to ``max_len`` plus the
    lag-1 pipeline's dispatch overshoot of up to two chunks, plus the
    scratch page (``kv_pool.py:1052-1068``)."""
    return int(slots) * pages_for(int(max_len) + 2 * int(chunk),
                                  page_size) + 1
