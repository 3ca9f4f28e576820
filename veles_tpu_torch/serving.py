"""Continuous-batching LLM serving on the dense slot slab or the paged
KV pool, and its HTTP front with the survival layer.

The port of ``veles_tpu/serving.py``'s ``ContinuousDecoder``
(``:761-2115``), ``ServingHealth`` (``:240-521``) and ``GenerateAPI``
(``:2138-3590``). A
fixed set of slots decodes in lockstep on the card while new requests
prefill into free slots mid-flight. In the ``"int8"`` and ``"int8-kv"``
tiers every projection runs the int8 matvec kernel (K2).

The default KV tier, as in the JAX package, is the dense slot slab
(``parallel/decode.py``): each slot owns a ``max_len`` lane, admissions
go in one prefill per prompt bucket (``serving.py:1309-1389``), and each
dispatch attends a span tiled to the longest live sequence — torch ops
in the float tier, the dense int8-KV attend kernel (K4) in the int8-KV
tier. The JAX package's pow2 duplicate rows (which only bound jit
caches) are left out; the buckets stay, so the admission count is the
JAX package's.

``paged=True`` serves from the page pool (``parallel/kv_pool.py``),
each step attending through the fused paged-attention kernel (K1; K3 in
the int8-KV tier). Every admission is classified against the pool's
prefix cache (``serving.py:1444-1691``): a hit (the whole prompt cached:
control rows only), a tail (a page-aligned prefix cached: prefill only
the tail against the pooled prefix pages) or cold (a full prefill).
Cold and tail groups are ragged — one prefill at the group's
page-rounded width, each row allocating exactly its prompt's (or
tail's) pages, as the JAX kernel path admits.

The survival layer (``GenerateAPI``): bounded admission (429), deadlines
(504), a circuit breaker that sheds the requests in flight with a
retryable 503 on a decoder fault, rebuilds the decoder from the held
weights with exponential backoff (the paged pool's prefix cache restored
into the new pool by page copy), probes it with a real decode and closes
again, and a live weight hot-swap behind a drain-then-swap seam with a
one-slot rollback stash. The JAX package's flight recorder, request
ledger, SLO engine, serve scope and memory scope notes along these paths,
its governor's tier swap, its blue-green rollout, the mesh and AOT wait
for the port's observe (A7), mesh (A8) and AOT (A9) slices.
"""

import collections
import json
import math
import threading
import time
import traceback
import weakref

import numpy
import torch

from veles_tpu_torch.core.config import root
from veles_tpu_torch.device import (keystr, resolve_device,
                                    tree_leaves_with_path, tree_structure,
                                    tree_to)
from veles_tpu_torch.parallel.decode import (SLOT_SPAN_TILE,
                                             init_slot_state,
                                             quantize_params,
                                             request_key,
                                             slot_admit_many,
                                             slot_step_many)
from veles_tpu_torch.parallel.kv_pool import (SCRATCH_PAGE, PagePool,
                                              _paged_restore,
                                              default_pool_pages,
                                              init_paged_state,
                                              paged_admit_hit,
                                              paged_admit_many,
                                              paged_admit_tail,
                                              paged_slot_step_many,
                                              pages_for)


def _dtype_name(dtype):
    """A torch dtype as numpy (and so JAX) names it: ``float32``."""
    return str(dtype).replace("torch.", "")


class ContinuousDecoder:
    """Continuous batching over the dense slot slab (the default) or,
    with ``paged=True``, the paged KV pool. Single-threaded host driver:
    :meth:`submit` at any time, then :meth:`step` (one token per slot),
    :meth:`dispatch_chunk` + :meth:`collect_chunk` (a chunk of tokens,
    split so a driver can enqueue chunk N+1 before reading chunk N
    back), or :meth:`run_until_drained` / :meth:`drain_pipelined`.
    Tokens stream into ``results[request_id]``; ``tokens_out`` counts
    every token delivered.

    Greedy by default; ``temperature > 0`` samples each request from
    its own key stream, ``request_key(seed, request_id)`` folded with
    the step (the JAX package's ``fold_in(base_key, request_id)``,
    ``serving.py:912-918``): a request's tokens equal
    ``generate(batch=1, key=request_key(seed, request_id))``'s whichever
    slot it lands in and whoever shares its steps.

    ``quantize="int8"`` serves int8 weights; ``"int8-kv"`` also stores
    the slab (or pool) as int8 codes with per-(position, head) scales
    and rounds ``max_len`` up to whole 128-position tiles, as the JAX
    package does. ``page_size`` and ``pool_pages`` size the pool and are
    ignored by the slab. ``tile`` (default :data:`SLOT_SPAN_TILE`) is
    the granule the slab's attended span rounds up to. ``prefix_cache``
    hands a previous pool's prefix cache (its page shadows captured,
    ``PagePool.capture_shadows``) to this decoder's fresh pool, which
    restores the cached pages by copy (the breaker's rebuild).

    Numerical contract: a request's greedy stream equals
    :func:`parallel.decode.generate` for its prompt up to f32
    round-off — the same sublayers, with the kernels attending in f32;
    near-tied argmaxes may break differently."""

    def __init__(self, params, embed_table, heads, slots=4, max_len=512,
                 n_tokens=32, eos=None, temperature=0.0, top_k=0, seed=0,
                 quantize=None, tile=None, paged=False, page_size=None,
                 pool_pages=None, prefix_cache=None, device=None):
        if quantize not in (None, "none", "int8", "int8-kv"):
            raise ValueError("quantize must be None, 'int8' or 'int8-kv', "
                             "got %r" % (quantize,))
        self.device = resolve_device(device)
        self.quantize = quantize if quantize != "none" else None
        params = tree_to(params, self.device)
        if self.quantize and not isinstance(params["head"], dict):
            params = quantize_params(params)
        self.params = params
        self.embed_table = embed_table.to(self.device)
        self.heads = heads
        self.slots = slots
        if self.quantize == "int8-kv":
            max_len = -(-max_len // SLOT_SPAN_TILE) * SLOT_SPAN_TILE
        self.max_len = max_len
        #: the attended span's granule on the slab: each dispatch attends
        #: ceil((longest live sequence + chunk) / tile) * tile positions
        self.tile = int(tile if tile is not None else SLOT_SPAN_TILE)
        if self.tile < 1:
            raise ValueError("tile must be >= 1, got %d" % self.tile)
        self.paged = bool(paged)
        self.n_tokens = n_tokens
        self.eos = eos
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        n_blocks = len(params["blocks"])
        embed = self.embed_table.shape[1]
        vocab = self.embed_table.shape[0]
        #: the pool (paged) or None (the slab)
        self.pool = None
        self.page_size = self.pool_pages = None
        #: what the restore of a handed-over prefix cache moved: pages,
        #: entries, bytes and wall seconds (None without one)
        self.restore_stats = None
        if self.paged:
            self.page_size = int(page_size if page_size is not None
                                 else SLOT_SPAN_TILE)
            if self.page_size < 1:
                raise ValueError("page_size must be >= 1, got %d"
                                 % self.page_size)
            #: default: every slot full to max_len plus the lag-1
            #: pipeline's overshoot for chunks up to n_tokens, plus the
            #: scratch page
            self.pool_pages = (int(pool_pages) if pool_pages is not None
                               else default_pool_pages(slots, max_len,
                                                       self.page_size,
                                                       chunk=n_tokens))
            self.pool = PagePool(self.pool_pages, self.page_size,
                                 cache=prefix_cache)
            self.state = init_paged_state(
                n_blocks, self.pool_pages, self.page_size, heads,
                embed // heads, vocab, slots, dtype=self.embed_table.dtype,
                quantized=self.quantize == "int8-kv", device=self.device)
            if prefix_cache is not None and len(prefix_cache):
                # the breaker's rebuild: the previous decoder's prefix
                # cache restores into this pool by page copy, never by a
                # prefill of every cached prompt
                started = time.perf_counter()
                self.state = self.pool.restore_entries(self.state,
                                                       _paged_restore)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.restore_stats = {
                    "pages": len(self.pool.cache.page_shadow),
                    "entries": len(self.pool.cache),
                    "bytes": self.pool.shadow_bytes(),
                    "seconds": time.perf_counter() - started}
        else:
            self.state = init_slot_state(
                n_blocks, slots, max_len, heads, embed // heads, vocab,
                dtype=self.embed_table.dtype,
                quantized=self.quantize == "int8-kv", device=self.device)
        self._slot_pages = {}    # slot -> [page id, ...] in logical order
        self._queue = collections.deque()
        self._free = list(range(slots))
        self._slot_req = {}      # slot -> request id
        self._slot_len = {}      # slot -> device-side sequence length
        self._budget = {}        # request id -> tokens still wanted
        self.results = {}        # request id -> [token, ...]
        self.admitted_at = {}    # request id -> monotonic admission stamp
        self._next_id = 0
        #: the version tag of the weights served (a hot swap stamps it)
        self.version = None
        self.tokens_out = 0
        #: dispatch tally: one "admit" per admission group (the slab: one
        #: per prompt bucket; the pool: one per cold group), one "chunk"
        #: per chunked dispatch, one "step" per single step; the pool
        #: adds one "admit_tail" per tail group (one per prefix page
        #: count) and one "admit_hit" per hit group
        self.dispatch_counts = {"admit": 0, "admit_requests": 0,
                                "chunk": 0, "step": 0}
        if self.paged:
            self.dispatch_counts.update(admit_tail=0, admit_hit=0)
        #: host-blocking wall seconds of admissions, chunk enqueues and
        #: readbacks
        self.timings = {"admit_s": 0.0, "dispatch_s": 0.0,
                        "collect_s": 0.0}

    def _upload(self, array):
        """A host array as a tensor on the decoder's device, without a
        host sync on the card (pinned memory, non-blocking copy)."""
        tensor = torch.from_numpy(numpy.ascontiguousarray(array))
        if self.device.type == "cuda":
            return tensor.pin_memory().to(self.device, non_blocking=True)
        return tensor

    def swap_params(self, new_params, new_embed_table=None):
        """Live weight hot-swap (``serving.py:1140-1217``): replace the
        weights in place; slots, pool and the request-id counter stay.
        The int8 tiers quantize the new weights first, as the
        constructor does. Raises ValueError when the checkpoint's tree
        structure, leaf shapes or dtypes do not match the serving
        weights (the old ones keep serving). The prefix cache is
        flushed: its pages and logits were computed under the old
        weights. The caller (``GenerateAPI._apply_swap``) swaps on an
        idle decoder and keeps the returned ``(old_params,
        old_embed_table)`` as its rollback stash. The JAX package's
        mesh reshard has no counterpart here (the mesh is a later
        slice)."""
        new_params = tree_to(new_params, self.device)
        if self.quantize and not isinstance(new_params["head"], dict):
            new_params = quantize_params(new_params)
        new_table = (new_embed_table.to(self.device)
                     if new_embed_table is not None else self.embed_table)
        old = (self.params, self.embed_table)
        old_tree = tree_structure(old)
        new_tree = tree_structure((new_params, new_table))
        if old_tree != new_tree:
            raise ValueError(
                "swap refused: checkpoint tree structure does not "
                "match the serving params (%s vs %s)"
                % (new_tree, old_tree))
        for (path, old_leaf), (_, new_leaf) in zip(
                tree_leaves_with_path(old),
                tree_leaves_with_path((new_params, new_table))):
            if tuple(old_leaf.shape) != tuple(new_leaf.shape) \
                    or old_leaf.dtype != new_leaf.dtype:
                raise ValueError(
                    "swap refused: leaf %s is %s%s in the checkpoint "
                    "but %s%s live — a mismatched swap would "
                    "invalidate every compiled program"
                    % (keystr(path), _dtype_name(new_leaf.dtype),
                       tuple(new_leaf.shape), _dtype_name(old_leaf.dtype),
                       tuple(old_leaf.shape)))
        self.params = new_params
        self.embed_table = new_table
        if self.pool is not None:
            self.pool.flush_prefix_cache()
        return old

    def submit(self, prompt_tokens, n_tokens=None):
        """Queue one prompt (1-D int sequence); returns the request id.
        It is admitted into a slot on a later step when one is free."""
        prompt = numpy.asarray(prompt_tokens, numpy.int64).reshape(-1)
        budget = n_tokens if n_tokens is not None else self.n_tokens
        if len(prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        if len(prompt) + budget > self.max_len:
            raise ValueError("prompt %d + n_tokens %d exceeds max_len %d"
                             % (len(prompt), budget, self.max_len))
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, prompt, budget))
        self.results[rid] = []
        self._budget[rid] = budget
        return rid

    @property
    def busy(self):
        return bool(self._queue or self._slot_req)

    def done(self, rid):
        """True once request ``rid``'s stream is complete."""
        return rid in self.results and rid not in self._budget

    def cancel(self, rid):
        """Abort an incomplete request wherever it is — the queue or a
        slot — freeing the slot and its pages at once and dropping its
        results. Safe mid-chunk: collection skips a request without a
        budget. Returns True when the request was still running."""
        if rid not in self._budget:
            return False
        for i, queued in enumerate(self._queue):
            if queued[0] == rid:
                del self._queue[i]
                break
        else:
            for slot, owner in list(self._slot_req.items()):
                if owner == rid:
                    del self._slot_req[slot]
                    self._free.append(slot)
                    self._release_slot_pages(slot)
                    break
        del self._budget[rid]
        self.results.pop(rid, None)
        self.admitted_at.pop(rid, None)
        return True

    def bucket_for(self, n):
        """The width an ``n``-token prompt prefills at in the slab: the
        next power of two, at least 16, clamped to ``max_len``
        (``serving.py:1286-1302``). Eager PyTorch needs no bucket to
        bound a cache; the slab keeps them so one admission per bucket
        group is the JAX package's count."""
        bucket = 16
        while bucket < n:
            bucket *= 2
        return min(bucket, self.max_len)

    def _admit_pending(self):
        if self.paged:
            self._admit_pending_paged()
        else:
            self._admit_pending_dense()

    def _admit_pending_dense(self):
        """Admit every queued request that fits a free slot, grouped by
        prompt bucket: one :func:`slot_admit_many` prefill per bucket
        group, in the order the buckets first appear in the queue."""
        groups = {}
        while self._queue and self._free:
            rid, prompt, _ = self._queue.popleft()
            groups.setdefault(self.bucket_for(len(prompt)), []).append(
                (rid, prompt, self._free.pop()))
        for bucket, group in groups.items():
            started = time.perf_counter()
            self.state = slot_admit_many(
                self.params, self.heads, self.state,
                self._upload(numpy.asarray([r[2] for r in group],
                                           numpy.int64)),
                self.embed_table[self._padded([r[1] for r in group],
                                              bucket)],
                self._upload(numpy.asarray([len(r[1]) for r in group],
                                           numpy.int64)),
                self._req_keys(group))
            self._book_admit("admit", started, group)
            now = time.monotonic()
            for rid, prompt, slot in group:
                self._slot_req[slot] = rid
                self._slot_len[slot] = len(prompt)
                self.admitted_at[rid] = now

    def _admit_pending_paged(self):
        """Admit every queued request that has a free slot and pages,
        classified against the prefix cache: a ``hit`` (the whole prompt
        cached with its logits) writes control rows only; a ``tail`` (a
        page-aligned prefix cached) prefills only the tail, allocating
        exactly its pages; a cold request prefills in full. Cold rows go
        in ONE ragged prefill, tails in one per prefix page count, hits
        in one. The int8-KV tier takes exact-prompt hits only. A request
        the pool cannot serve yet, even after LRU eviction, stays at the
        front of the queue."""
        ps = self.page_size
        allow_partial = self.quantize != "int8-kv"
        cold, tails, hits = [], {}, []
        while self._queue and self._free:
            rid, prompt, _ = self._queue[0]
            entry, shared = self.pool.lookup(prompt,
                                             allow_partial=allow_partial)
            if entry is not None and shared == len(prompt):
                self._queue.popleft()
                self.pool.book_hit()
                hits.append((rid, prompt, self._free.pop(), entry))
                continue
            pages = self.pool.alloc(pages_for(len(prompt) - shared, ps))
            if pages is None:
                if entry is not None:
                    self.pool.unlookup(entry)
                break
            self._queue.popleft()
            if entry is None:
                self.pool.book_miss()
                cold.append((rid, prompt, self._free.pop(), pages))
            else:
                self.pool.book_hit()
                tails.setdefault(len(entry["pages"]), []).append(
                    (rid, prompt, self._free.pop(), entry, shared, pages))
        if cold:
            self._admit_cold(cold)
        for group in tails.values():
            self._admit_tails(group)
        if hits:
            self._admit_hits(hits)

    def _req_keys(self, group):
        """The sampling keys of an admission group's requests (each
        row's first field is its request id), on the device."""
        return self._upload(request_key(
            self.seed, numpy.asarray([r[0] for r in group])).numpy())

    def _book_admit(self, key, started, group):
        self.timings["admit_s"] += time.perf_counter() - started
        self.dispatch_counts[key] += 1
        self.dispatch_counts["admit_requests"] += len(group)

    def _seat(self, slot, rid, prompt, pages):
        """Give ``slot`` to request ``rid`` and publish its prompt's
        whole pages (and, for a page-aligned prompt, a copy of its
        logits row, which a later admission into the slot overwrites)
        so the next admission of the prefix is a hit."""
        self._slot_req[slot] = rid
        self._slot_len[slot] = len(prompt)
        self._slot_pages[slot] = list(pages)
        self.admitted_at[rid] = time.monotonic()
        logits = (self.state["logits"][slot].clone()
                  if len(prompt) % self.page_size == 0 else None)
        self.pool.insert(prompt, pages, logits=logits)

    def _padded(self, rows, width, fill=0, dtype=numpy.int64):
        """Rows of unequal length right-padded into one array."""
        out = numpy.full((len(rows), width), fill, dtype)
        for j, row in enumerate(rows):
            out[j, :len(row)] = row
        return self._upload(out)

    def _admit_cold(self, group):
        """One ragged prefill at the group's page-rounded max width,
        short rows padding their page ids with the scratch page, which
        the per-row lengths keep invisible."""
        ps = self.page_size
        width = pages_for(max(len(r[1]) for r in group), ps) * ps
        started = time.perf_counter()
        self.state = paged_admit_many(
            self.params, self.heads, self.state,
            self._upload(numpy.asarray([r[2] for r in group], numpy.int64)),
            self._padded([r[3] for r in group],
                         max(len(r[3]) for r in group), SCRATCH_PAGE,
                         numpy.int32),
            self.embed_table[self._padded([r[1] for r in group], width)],
            self._upload(numpy.asarray([len(r[1]) for r in group],
                                       numpy.int64)),
            self._req_keys(group))
        self._book_admit("admit", started, group)
        for rid, prompt, slot, pages in group:
            self._seat(slot, rid, prompt, pages)

    def _admit_tails(self, group):
        """One ragged tail prefill for tails sharing a prefix page
        count: tails at their page-rounded max width against each row's
        pooled prefix pages. The extended prompt is published too (its
        pages hold what a cold prefill would), so a repeated one becomes
        a hit."""
        ps = self.page_size
        tails = [r[1][r[4]:] for r in group]
        width = pages_for(max(len(t) for t in tails), ps) * ps
        started = time.perf_counter()
        self.state = paged_admit_tail(
            self.params, self.heads, self.state,
            self._upload(numpy.asarray([r[2] for r in group], numpy.int64)),
            self._upload(numpy.asarray([r[3]["pages"] for r in group],
                                       numpy.int32)),
            self._padded([r[5] for r in group],
                         max(len(r[5]) for r in group), SCRATCH_PAGE,
                         numpy.int32),
            self.embed_table[self._padded(tails, width)],
            self._upload(numpy.asarray([len(r[1]) for r in group],
                                       numpy.int64)),
            self._req_keys(group))
        self._book_admit("admit_tail", started, group)
        for rid, prompt, slot, entry, _, pages in group:
            self._seat(slot, rid, prompt, list(entry["pages"]) + pages)

    def _admit_hits(self, group):
        """Control rows only, from each entry's cached logits; the slot
        maps the entry's pages (retained by the lookup)."""
        started = time.perf_counter()
        self.state = paged_admit_hit(
            self.state,
            self._upload(numpy.asarray([r[2] for r in group], numpy.int64)),
            self._upload(numpy.asarray([len(r[1]) for r in group],
                                       numpy.int64)),
            torch.stack([r[3]["logits"] for r in group]),
            self._req_keys(group))
        self._book_admit("admit_hit", started, group)
        now = time.monotonic()
        for rid, prompt, slot, entry in group:
            self._slot_req[slot] = rid
            self._slot_len[slot] = len(prompt)
            self._slot_pages[slot] = list(entry["pages"])
            self.admitted_at[rid] = now

    def _release_slot_pages(self, slot):
        """Return a retired or cancelled slot's pages to the pool."""
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self.pool.release(pages)

    def _ensure_tail_pages(self, extra):
        """Pre-map every page the next dispatch's appends can touch:
        each live slot's table covers its length plus ``extra``
        positions. Raises when the pool is exhausted — unreachable
        behind GenerateAPI's reservation gate, loud for direct
        drivers."""
        ps = self.page_size
        for slot in self._slot_req:
            need = pages_for(self._slot_len[slot] + extra, ps)
            have = len(self._slot_pages.get(slot) or ())
            if need > have:
                got = self.pool.alloc(need - have)
                if got is None:
                    raise RuntimeError(
                        "kv page pool exhausted mid-decode (%d pages, %d "
                        "free): raise pool_pages or admit through "
                        "GenerateAPI's pool-aware gate"
                        % (self.pool.capacity, self.pool.free_pages))
                self._slot_pages.setdefault(slot, []).extend(got)

    def _page_table_array(self, extra):
        """The (slots, PB) int32 page table for the next dispatch, on the
        device: PB pages cover the longest live sequence plus ``extra``
        appends; rows of free slots stay scratch."""
        self._ensure_tail_pages(extra)
        ps = self.page_size
        pb = max(pages_for(self._slot_len[s] + extra, ps)
                 for s in self._slot_req)
        table = numpy.zeros((self.slots, pb), numpy.int32)
        for slot in self._slot_req:
            pages = self._slot_pages[slot][:pb]
            table[slot, :len(pages)] = pages
        return self._upload(table)

    def worst_case_pages(self, prompt_len, budget, chunk=1):
        """Upper bound on the pages one request can hold at once: its
        prompt grown to the token budget plus the lag-1 pipeline's two
        chunks of slack — what the HTTP gate reserves. Ragged admission
        makes it the bound of every family: a tail maps the shared whole
        pages plus exactly its tail's, a hit the prompt's pages."""
        return pages_for(prompt_len + budget + 2 * chunk, self.page_size)

    def _active(self):
        active = numpy.zeros(self.slots, bool)
        for slot in self._slot_req:
            active[slot] = True
        return self._upload(active)

    def _retire(self, slot, rid):
        del self._budget[rid]
        self.admitted_at.pop(rid, None)
        if self._slot_req.get(slot) == rid:
            del self._slot_req[slot]
            self._free.append(slot)
            self._release_slot_pages(slot)

    def _attended_span(self, extra):
        """The slab positions the next dispatch attends: the longest live
        sequence plus the ``extra`` positions it appends, rounded up to
        ``tile`` and clamped to ``max_len``."""
        longest = max(self._slot_len[s] for s in self._slot_req)
        span = -(-(longest + extra) // self.tile) * self.tile
        return int(min(span, self.max_len))

    def _advance(self, n):
        """Run ``n`` lockstep steps of every slot (slab or pool); returns
        the emitted tokens (n, S), still on the device."""
        sampling = (self.temperature or 1.0, bool(self.temperature),
                    self.top_k)
        if self.paged:
            self.state, emitted = paged_slot_step_many(
                self.params, self.embed_table, self.heads, self.state,
                self._page_table_array(n), self._active(), n, *sampling)
        else:
            self.state, emitted = slot_step_many(
                self.params, self.embed_table, self.heads, self.state,
                self._active(), n, *sampling, span=self._attended_span(n))
        return emitted

    def step(self):
        """Admit what fits, advance every active slot one token; returns
        {request_id: token} for the tokens generated this step."""
        self._admit_pending()
        if not self._slot_req:
            return {}
        snapshot = dict(self._slot_req)
        emitted = self._advance(1)[0]
        for slot in snapshot:
            self._slot_len[slot] += 1
        self.dispatch_counts["step"] += 1
        emitted = emitted.cpu().numpy()
        out = {}
        for slot, rid in snapshot.items():
            token = int(emitted[slot])
            self.results[rid].append(token)
            out[rid] = token
            self.tokens_out += 1
            self._budget[rid] -= 1
            if self._budget[rid] <= 0 or token == self.eos:
                self._retire(slot, rid)
        return out

    def dispatch_chunk(self, chunk):
        """Admit what fits and enqueue one chunk of ``chunk`` steps
        WITHOUT waiting for it; returns a handle for
        :meth:`collect_chunk`, or None when nothing is active. Lanes
        advance every step of the chunk, even past a request's
        retirement; the host discards those tokens at collection."""
        self._admit_pending()
        if not self._slot_req:
            return None
        snapshot = dict(self._slot_req)
        t0 = time.perf_counter()
        emitted = self._advance(chunk)
        self.timings["dispatch_s"] += time.perf_counter() - t0
        for slot in snapshot:
            self._slot_len[slot] += chunk
        self.dispatch_counts["chunk"] += 1
        return emitted, snapshot

    def collect_chunk(self, dispatched):
        """Read one dispatched chunk back (the device sync) and account
        its tokens to the requests assigned when it was dispatched;
        requests retired or cancelled meanwhile are skipped, and tokens
        past a budget or ``eos`` are discarded."""
        emitted, snapshot = dispatched
        t0 = time.perf_counter()
        emitted = emitted.cpu().numpy()   # (chunk, slots)
        self.timings["collect_s"] += time.perf_counter() - t0
        out = {}
        for slot, rid in snapshot.items():
            if rid not in self._budget:
                continue
            tokens = emitted[:, slot].tolist()[:self._budget[rid]]
            if self.eos is not None and self.eos in tokens:
                tokens = tokens[:tokens.index(self.eos) + 1]
            self.results[rid].extend(tokens)
            out[rid] = tokens
            self.tokens_out += len(tokens)
            self._budget[rid] -= len(tokens)
            if self._budget[rid] <= 0 or (
                    tokens and tokens[-1] == self.eos):
                self._retire(slot, rid)
        return out

    def drain_pipelined(self, chunk, max_steps=100000, admit=None):
        """Lag-1 drain: chunk N's tokens are read back while chunk N+1
        already runs. ``admit`` is an optional zero-argument callable
        run once per pass (staggered submissions). Streams equal the
        unpipelined drain's."""
        pending = None
        for _ in range(max_steps):
            if admit is not None:
                admit()
            current = self.dispatch_chunk(chunk)
            if pending is not None:
                self.collect_chunk(pending)
            pending = current
            if pending is None and not self.busy:
                return self.results
        raise RuntimeError("decoder did not drain in %d steps" % max_steps)

    def step_many(self, n):
        """Admit what fits and run ``n`` steps as one chunk, then read
        it back; returns {request_id: [tokens...]}."""
        dispatched = self.dispatch_chunk(n)
        if dispatched is None:
            return {}
        return self.collect_chunk(dispatched)

    def run_until_drained(self, max_steps=100000, chunk=1,
                          before_step=None):
        """Drive :meth:`step` (``chunk`` > 1: :meth:`step_many`) until
        every submitted request finished. ``before_step`` is called
        once before each dispatch (the chaos hook's seat); the
        ``max_steps`` budget bounds the loop, so a decoder that makes no
        progress raises instead of spinning."""
        for _ in range(max_steps):
            if not self.busy:
                return self.results
            if before_step is not None:
                before_step()
            if chunk > 1:
                self.step_many(chunk)
            else:
                self.step()
        raise RuntimeError("decoder did not drain in %d steps" % max_steps)


class ServingHealth:
    """Thread-safe health and counter registry of a serving front
    (``serving.py:240-521``); :meth:`snapshot` backs ``/healthz``.

    ``ready`` is the load balancer's signal (``/readyz``): True only
    while the front can take traffic. ``breaker`` is ``closed`` in normal
    operation and ``open`` while :class:`GenerateAPI` rebuilds a failed
    decoder. The counters:

    - ``admitted`` / ``completed``: requests let in / answered;
    - ``rejected``: shed at admission (429 or 503), never queued;
    - ``expired``: deadline hit, the request's slot freed;
    - ``trips`` / ``rebuilds``: breaker opened / decoder rebuilt and
      probed;
    - ``shed``: requests in flight answered with a retryable 503 on a
      trip;
    - ``errors``: requests answered with any other error;
    - keys booked with :meth:`incr`, such as ``param_swaps`` and
      ``swap_failures``.

    Latency windows (:meth:`record_latency`): ``ttft`` (staged to the
    first token on the host), ``tpot`` (time per output token after the
    first) and ``queue_wait`` (staged to admitted into a slot), exposed
    as p50/p95 in milliseconds. The JAX package's SLO, governor and
    serve-scope mirrors wait for the observe plane (A7)."""

    COUNTERS = ("admitted", "completed", "rejected", "expired", "shed",
                "trips", "rebuilds", "errors")
    #: rolling-window latency kinds exposed as p50/p95 on /healthz
    LATENCY_KINDS = ("ttft", "tpot", "queue_wait")
    #: rolling-window size per latency kind
    LATENCY_WINDOW = 512

    def __init__(self, name="serving"):
        self.name = name
        self._lock = threading.Lock()
        self._ready = False
        self._breaker = "closed"
        self._inflight = 0
        self._counters = {key: 0 for key in self.COUNTERS}
        self._pool_ref = None
        self._deploy_ref = None
        self._latencies = {
            kind: collections.deque(maxlen=self.LATENCY_WINDOW)
            for kind in self.LATENCY_KINDS}

    @property
    def ready(self):
        with self._lock:
            return self._ready

    def set_ready(self, flag):
        with self._lock:
            self._ready = bool(flag)

    def set_breaker(self, state):
        with self._lock:
            self._breaker = state

    def incr(self, key, n=1):
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def counter(self, key):
        """One counter's current value."""
        with self._lock:
            return self._counters.get(key, 0)

    def attach_pool(self, pool):
        """Mirror a paged KV pool's occupancy and prefix-cache state into
        the snapshot (weakly referenced: a rebuilt decoder's fresh pool
        attaches again, a dead one drops out)."""
        with self._lock:
            self._pool_ref = weakref.ref(pool) if pool is not None \
                else None

    def attach_deploy(self, api):
        """Mirror the serving front's deploy state into the snapshot
        (weakly referenced): the weights' ``version`` and, from the
        decoder it drives now, its ``dispatch_counts`` and ``device``."""
        with self._lock:
            self._deploy_ref = weakref.ref(api) if api is not None \
                else None

    def retry_after_s(self, need=1):
        """The Retry-After price of this front's 429 and 503 replies, in
        seconds: the attached pool's page-release pricing, else 1."""
        with self._lock:
            pool = self._pool_ref() if self._pool_ref is not None \
                else None
        if pool is not None:
            return pool.retry_after(need)
        return 1.0

    def try_admit(self, limit, pool_gate=None):
        """One atomic admission decision: returns None and counts the
        request in, or the rejection (``"unready"`` -> 503, ``"full"``
        -> 429, ``("pool", retry_after)`` -> 429), checked and booked
        under one lock so a burst cannot race past the bound. ``limit``
        None or <= 0 admits without bound. ``pool_gate`` is a zero-arg
        callable run under the lock after the bound: None (the request's
        worst-case pages are reserved) or a retry-after in seconds, so a
        reservation is only made for an otherwise admitted request."""
        with self._lock:
            if not self._ready:
                self._counters["rejected"] += 1
                return "unready"
            if limit is not None and limit > 0 \
                    and self._inflight >= limit:
                self._counters["rejected"] += 1
                return "full"
            if pool_gate is not None:
                retry_after = pool_gate()
                if retry_after is not None:
                    self._counters["rejected"] += 1
                    return ("pool", retry_after)
            self._inflight += 1
            self._counters["admitted"] += 1
            return None

    def release(self, outcome="completed"):
        """Book one admitted request out (``completed`` / ``expired`` /
        ``shed`` / ``errors``)."""
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            self._counters[outcome] = self._counters.get(outcome, 0) + 1

    def reject_admitted(self):
        """Roll an admission back as a rejection (the request turned
        out unservable after :meth:`try_admit`): ``admitted ==
        completed + expired + shed + errors + inflight`` still holds."""
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            self._counters["admitted"] -= 1
            self._counters["rejected"] += 1

    @property
    def inflight(self):
        with self._lock:
            return self._inflight

    def record_latency(self, kind, seconds):
        """Feed one sample into the ``kind`` window (seconds)."""
        with self._lock:
            if kind not in self._latencies:
                self._latencies[kind] = collections.deque(
                    maxlen=self.LATENCY_WINDOW)
            self._latencies[kind].append(float(seconds))

    @staticmethod
    def _percentiles_ms(values):
        if not values:
            return {"p50": None, "p95": None, "count": 0}
        ordered = sorted(values)
        n = len(ordered)
        p50 = ordered[(n - 1) // 2]
        p95 = ordered[min(n - 1, int(math.ceil(0.95 * (n - 1))))]
        return {"p50": round(p50 * 1000.0, 3),
                "p95": round(p95 * 1000.0, 3), "count": n}

    def snapshot(self):
        with self._lock:
            snap = {"name": self.name, "ready": self._ready,
                    "breaker": self._breaker,
                    "inflight": self._inflight,
                    "counters": dict(self._counters),
                    "latency_ms": {
                        kind: self._percentiles_ms(window)
                        for kind, window in self._latencies.items()}}
            pool = self._pool_ref() if self._pool_ref is not None \
                else None
            deploy = self._deploy_ref() \
                if self._deploy_ref is not None else None
        if deploy is not None:
            snap["version"] = deploy.version
            decoder = deploy.decoder
            snap["dispatch_counts"] = dict(decoder.dispatch_counts)
            snap["device"] = str(decoder.device)
        if pool is not None:
            snap["pool"] = pool.snapshot()
        return snap


def _non_finite_leaf(tree):
    """The path (``jax.tree_util.keystr``'s form) of the first floating
    weight leaf holding a non-finite value, in the JAX package's leaf
    order, or None when clean: the hot swap's poisoned-checkpoint gate
    (``serving.py:2117-2135``). One scalar readback a leaf; integer
    leaves (the int8 tiers' codes) cannot hold NaN and are skipped."""
    for path, leaf in tree_leaves_with_path(tree):
        if not isinstance(leaf, torch.Tensor) \
                or not leaf.is_floating_point():
            continue
        if not bool(torch.isfinite(leaf).all()):
            return keystr(path)
    return None


class GenerateAPI:
    """HTTP front for :class:`ContinuousDecoder` (``serving.py:2138-
    3590``). ``POST <path>`` with ``{"tokens": [...], "n_tokens": N?,
    "deadline_s": S?}`` answers ``{"tokens": [...]}`` once the request's
    stream completes (greedy, or sampled at ``temperature`` with
    ``top_k`` from the request's own key stream of ``seed``, the port's
    counterpart of the JAX package's ``key``); ``GET /healthz`` answers
    :class:`ServingHealth`'s snapshot (and, with ``paged=True``, the
    pool with its ``prefix_*`` fields), ``GET /readyz`` 200 only while
    the front can serve.

    Handler threads validate (400, with the JAX package's messages) and
    pass the admission gate — at most ``max_queue`` requests in flight
    (429 beyond it; <= 0 disables the bound) and, on the pool, the
    request's worst-case pages reserved (429 when they are not there,
    Retry-After priced by the pool's page-release rate) — then stage the
    request and wait. ONE driver thread owns the decoder: it submits
    staged requests, cancels expired ones (504) and runs lag-1 chunk
    pipelining (chunk N+1 enqueued before chunk N's readback).

    The survival layer: a decoder fault trips a circuit breaker that
    sheds every request in flight with a retryable 503 (``Retry-After``
    set), drops the chunk in flight uncollected, rebuilds the decoder
    from the held weights with exponential backoff (``rebuild_backoff``
    doubling to ``rebuild_backoff_max``) — the pool's prefix cache
    captured from the dying decoder and restored into the new pool by
    page copy — probes the rebuilt decoder with a real decode and
    closes again. :meth:`request_trip` trips it on purpose.
    :meth:`swap_params` swaps the weights live: the staged queue holds,
    the requests in flight finish on the old weights, the decoder swaps
    and probes the new ones, and a refused or failed swap leaves the old
    ones serving; :meth:`rollback_swap` swaps back. ``chaos`` takes a
    :class:`~veles_tpu_torch.serving_chaos.ServingChaosMonkey` (default:
    built from ``root.common.serve.chaos``; None when it sets nothing).

    Every knob left None reads its default from ``root.common.serve``
    (``serving.py:2215-2325``); a bad server deadline is refused before
    the decoder is built."""

    #: extra handler-side wait beyond a request's deadline before the
    #: handler gives up on the driver (a wedged driver's backstop)
    BACKSTOP_GRACE = 10.0

    def __init__(self, params, embed_table, heads, slots=4, max_len=512,
                 n_tokens=32, temperature=0.0, top_k=0, eos=None, seed=0,
                 port=0, host="127.0.0.1", path="/generate", chunk=8,
                 request_timeout=None, max_queue=None, deadline=None,
                 rebuild_backoff=None, rebuild_backoff_max=None,
                 chaos=None, quantize=None, tile=None, paged=None,
                 page_size=None, pool_pages=None, device=None):
        import queue

        serve_cfg = root.common.serve
        # validated before the (expensive) decoder build, so a server
        # misconfiguration fails at startup, never as a 400 blaming a
        # field the client did not send
        if deadline is None:
            deadline = (request_timeout if request_timeout is not None
                        else serve_cfg.get("deadline", 300.0))
        self.deadline = float(deadline)
        if not math.isfinite(self.deadline) \
                or not 0 < self.deadline <= 1e7:
            raise ValueError(
                "serve deadline (--serve-deadline / deadline=) must "
                "be a positive number of seconds (at most 1e7), "
                "got %r" % deadline)
        if paged is None:
            paged = bool(serve_cfg.get("paged", False))
        if page_size is None:
            page_size = serve_cfg.get("page_size", None)
        if pool_pages is None:
            pool_pages = serve_cfg.get("pool_pages", None)
        #: what every decoder this front builds (the first and each
        #: rebuild) is built from; a successful swap replaces the weights
        self._decoder_kwargs = dict(
            params=params, embed_table=embed_table, heads=heads,
            slots=slots, max_len=max_len, n_tokens=n_tokens,
            temperature=temperature, top_k=top_k, eos=eos, seed=seed,
            quantize=quantize, tile=tile, paged=bool(paged),
            page_size=page_size, pool_pages=pool_pages, device=device)
        self.decoder = ContinuousDecoder(**self._decoder_kwargs)
        self.vocab = embed_table.shape[0]
        self.port = port
        self.host = host
        self.path = path
        self.chunk = int(chunk)
        self.max_queue = int(max_queue if max_queue is not None
                             else serve_cfg.get("max_queue", 64))
        self.rebuild_backoff = float(
            rebuild_backoff if rebuild_backoff is not None
            else serve_cfg.get("rebuild_backoff", 0.5))
        self.rebuild_backoff_max = float(
            rebuild_backoff_max if rebuild_backoff_max is not None
            else serve_cfg.get("rebuild_backoff_max", 30.0))
        if chaos is None:
            from veles_tpu_torch.serving_chaos import ServingChaosMonkey
            chaos = ServingChaosMonkey.from_config()
        self.chaos = chaos
        self.health = ServingHealth(name="generate-api")
        if self.decoder.pool is not None:
            self.health.attach_pool(self.decoder.pool)
        self.health.attach_deploy(self)
        #: the proactive trip request (request_trip), read by the driver
        self._trip_request = None
        #: the pending hot swap (request_swap), the one-slot rollback
        #: stash (params, embed_table, version of what the last swap
        #: replaced) and the version tag of the weights served
        self._swap_request = None
        self._param_stash = None
        self.version = None
        #: the last rebuild's and the last swap's seconds by part (the
        #: chip smoke prints them)
        self.last_rebuild = None
        self.last_swap = None
        self._staged = queue.Queue()
        self._stage_lock = threading.Lock()
        self._accepting = False
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._httpd = None
        self._driver = None
        self._tripped = None        # the breaker-open reason, or None
        self._tripped_at = None
        #: the lag-1 pipeline's chunk in flight (dispatched, not yet
        #: collected); dropped uncollected when the breaker trips or the
        #: server stops
        self._pending = None

    # -- driver thread (sole owner of the decoder) ----------------------
    def _resolve(self, holder, outcome, **fields):
        """Resolve one admitted request exactly once (the driver and a
        backstop-timing-out handler may race): stamp the reply fields,
        release its pages and its in-flight slot under ``outcome``, wake
        its handler."""
        token = object()
        if holder.setdefault("resolved", token) is not token:
            return
        holder.update(fields)
        reserved = holder.pop("pool_reserved", 0)
        if reserved:
            holder["pool"].unreserve(reserved)
        self.health.release(outcome)
        holder["event"].set()

    def _stage(self, prompt, budget, holder):
        """Put an admitted request on the driver's queue; False once the
        driver has made its final drain (the caller answers 503)."""
        with self._stage_lock:
            if not self._accepting:
                return False
            self._staged.put((prompt, budget, holder))
        self._wake.set()
        return True

    def _drain_staged(self):
        """Submit every staged request to the decoder; returns {request
        id: holder}. A request admitted against a previous decoder's pool
        (a rebuild raced its staging) moves its page reservation to the
        pool it will decode on, or is shed when that pool is promised to
        capacity (``serving.py:2482-2507``)."""
        import queue

        waiting = {}
        while True:
            try:
                prompt, budget, holder = self._staged.get_nowait()
            except queue.Empty:
                break
            # the pop is the claim: _resolve pops the same key, so
            # exactly one side ever releases the reservation
            reserved = holder.pop("pool_reserved", 0)
            if reserved:
                pool = self.decoder.pool
                if pool is not None and holder.get("pool") is not pool:
                    holder["pool"].unreserve(reserved)
                    if pool.try_reserve(reserved):
                        holder["pool"] = pool
                    else:
                        self._resolve(
                            holder, "shed",
                            error="rebuild raced admission: page "
                            "reservation lost; retry", code=503)
                        continue
                holder["pool_reserved"] = reserved
                if "resolved" in holder \
                        and holder.pop("pool_reserved", 0):
                    # _resolve ran between the claim and the give-back
                    # and found nothing to release: release it here
                    holder["pool"].unreserve(reserved)
            try:
                rid = self.decoder.submit(prompt, budget)
            except ValueError as exc:
                self._resolve(holder, "errors", error=str(exc), code=400)
                continue
            waiting[rid] = holder
        return waiting

    def _fail_all(self, waiting, message, outcome="errors", code=503):
        """Resolve every request in flight and staged with an error:
        nobody is left waiting out a deadline."""
        import queue

        for holder in waiting.values():
            self._resolve(holder, outcome, error=message, code=code)
        waiting.clear()
        while True:
            try:
                _, _, holder = self._staged.get_nowait()
            except queue.Empty:
                return
            self._resolve(holder, outcome, error=message, code=code)

    def _expire_deadlines(self, waiting):
        """Cancel every request whose deadline passed: its slot frees at
        once and the client gets a 504."""
        now = time.monotonic()
        for rid in [r for r, h in waiting.items()
                    if now >= h["deadline"]]:
            holder = waiting.pop(rid)
            self.decoder.cancel(rid)
            self._resolve(holder, "expired", error="deadline exceeded",
                          code=504)

    def _trip(self, exc, waiting):
        """Open the circuit: the decoder's state is not trusted after a
        fault. Everyone staged and in flight is shed now with a
        retryable 503, and a pending swap resolves with the trip. (The
        JAX package's flight-recorder dump here waits for A7.)"""
        self.health.incr("trips")
        self.health.set_breaker("open")
        self.health.set_ready(False)
        self._tripped_at = time.monotonic()
        pending, self._swap_request = self._swap_request, None
        if pending is not None:
            pending["error"] = "breaker tripped: %s" % exc
            pending["event"].set()
        self._tripped = "decode driver failed: %s; rebuilding" % exc
        self._fail_all(waiting, self._tripped, outcome="shed", code=503)

    def _governed_kwargs(self):
        """The decoder's construction kwargs at the tier in effect: the
        configured one, as the governor that would pick another (and
        with it a rebuild that leaves the prefix cache behind) waits for
        A7."""
        return dict(self._decoder_kwargs)

    def _build_probed_decoder(self, kwargs):
        """Build a decoder, carry the request-id counter over (sampling
        keys ``request_key(seed, rid)`` must never repeat), and prove
        the device path end to end with a probe decode through the
        decoder's own :meth:`ContinuousDecoder.run_until_drained`:
        bounded steps, the driver's chunk, the chaos hook in the loop.
        Raises on any failure, a hung probe included."""
        started = time.perf_counter()
        decoder = ContinuousDecoder(**kwargs)
        built = time.perf_counter()
        decoder._next_id = self.decoder._next_id
        probe = decoder.submit([0], 1)
        before = (self.chaos.before_step if self.chaos is not None
                  else None)
        decoder.run_until_drained(max_steps=8, chunk=self.chunk,
                                  before_step=before)
        if not decoder.done(probe):
            raise RuntimeError("probe decode did not finish")
        decoder.results.pop(probe, None)
        restore = decoder.restore_stats or {}
        self.last_rebuild = {
            "build_s": built - started - restore.get("seconds", 0.0),
            "restore_s": restore.get("seconds", 0.0),
            "probe_s": time.perf_counter() - built,
            "restored_pages": restore.get("pages", 0),
            "restored_bytes": restore.get("bytes", 0)}
        return decoder

    def _install_decoder(self, decoder):
        """Put the probed decoder in service and point the health
        snapshot's pool mirror at its pool."""
        self.decoder = decoder
        if decoder.pool is not None:
            self.health.attach_pool(decoder.pool)

    def _rebuild(self):
        """Build a fresh decoder from the held weights and probe it
        (:meth:`_build_probed_decoder`); only a probed decoder takes
        traffic. In the paged tier the prefix cache outlives the
        decoder: its page shadows are captured here, from the dying
        decoder, and handed on, so the new pool restores them by copy.
        Returns True on success. (The JAX package's memory-scope edge
        around this seam waits for A7.)"""
        capture_s = 0.0
        try:
            kwargs = self._governed_kwargs()
            if self.decoder.pool is not None:
                started = time.perf_counter()
                try:
                    self.decoder.pool.capture_shadows(self.decoder.state)
                except Exception:   # noqa: BLE001 - a sick device
                    # can refuse the reads: unshadowed entries are
                    # dropped by the restore and prefilled again later
                    traceback.print_exc()
                capture_s = time.perf_counter() - started
                kwargs["prefix_cache"] = self.decoder.pool.cache
            decoder = self._build_probed_decoder(kwargs)
        except Exception:   # noqa: BLE001 - the breaker retries
            traceback.print_exc()
            return False
        self.last_rebuild["capture_s"] = capture_s
        self._install_decoder(decoder)
        return True

    def request_trip(self, reason):
        """Trip the breaker at the top of the next driver pass: shed
        retryably, rebuild behind the probe, as after a real fault."""
        self._trip_request = reason
        self._wake.set()

    # -- the live weight hot-swap (serving.py:2752-2917) ----------------
    def request_swap(self, new_params, new_embed_table=None,
                     version=None):
        """Stage a live weight swap: the driver stops admitting, lets
        every request in flight finish on the OLD weights (nobody is
        shed), then swaps and probes (:meth:`_apply_swap`). Returns the
        holder: its ``event`` sets when the swap landed or was refused,
        ``error`` carries the refusal. A newer request supersedes an
        unapplied one (which resolves with an error)."""
        holder = {"event": threading.Event(), "params": new_params,
                  "embed_table": new_embed_table, "version": version,
                  "requested_at": time.perf_counter()}
        previous, self._swap_request = self._swap_request, holder
        if previous is not None:
            previous["error"] = "superseded by a newer swap request"
            previous["event"].set()
        self._wake.set()
        return holder

    def swap_params(self, new_params, new_embed_table=None,
                    version=None, timeout=120.0):
        """Blocking :meth:`request_swap`: True once the new weights
        serve; raises RuntimeError with the refusal (the old weights
        still serving, nothing shed) or on timeout."""
        holder = self.request_swap(new_params, new_embed_table,
                                   version=version)
        if not holder["event"].wait(timeout):
            raise RuntimeError("weight swap timed out after %.0fs"
                               % timeout)
        if "error" in holder:
            raise RuntimeError(holder["error"])
        return True

    def rollback_swap(self, timeout=120.0):
        """Swap back to the weights the last successful swap replaced
        (the one-slot stash), through the same seam."""
        if self._param_stash is None:
            raise RuntimeError("nothing to roll back to")
        params, embed_table, version = self._param_stash
        return self.swap_params(params, embed_table, version=version,
                                timeout=timeout)

    def _apply_swap(self, holder):
        """The swap itself (driver thread, decoder idle): refuse a
        poisoned checkpoint, swap, probe the new weights end to end, and
        on any failure put the old pair back from the one-slot stash.
        Nothing is shed on either path: the staged queue held while the
        swap was pending and drains into whichever weights won. (The
        JAX package's flight-recorder and memory-scope notes wait for
        A7.)"""
        started = time.perf_counter()
        new_params = holder["params"]
        new_table = holder.get("embed_table")
        if self.chaos is not None:
            new_params = self.chaos.maybe_poison_swap(new_params)
        old = None
        probe = None
        try:
            bad = _non_finite_leaf(new_params if new_table is None
                                   else (new_params, new_table))
            if bad is not None:
                raise ValueError("non-finite weights at %s — the "
                                 "checkpoint is poisoned" % bad)
            old = self.decoder.swap_params(new_params, new_table)
            swapped = time.perf_counter()
            probe = self.decoder.submit([0], 1)
            before = (self.chaos.before_step
                      if self.chaos is not None else None)
            self.decoder.run_until_drained(max_steps=8,
                                           chunk=self.chunk,
                                           before_step=before)
            if not self.decoder.done(probe):
                raise RuntimeError("probe decode did not finish")
            self.decoder.results.pop(probe, None)
            probe = None
        except Exception as exc:   # noqa: BLE001 - refused, old serves
            traceback.print_exc()
            if probe is not None:
                try:
                    self.decoder.cancel(probe)
                except Exception:   # noqa: BLE001
                    traceback.print_exc()
            if old is not None:
                try:
                    self.decoder.swap_params(old[0], old[1])
                except Exception as restore_exc:   # noqa: BLE001
                    # the old weights cannot be put back on top of a
                    # failed swap: trip and rebuild from the held ones
                    self.request_trip("weight-swap rollback failed: %s"
                                      % restore_exc)
            self.health.incr("swap_failures")
            holder["error"] = ("swap refused, old weights serving: %s"
                               % exc)
            holder["event"].set()
            return False
        done = time.perf_counter()
        self.last_swap = {"drain_s": started - holder["requested_at"],
                          "swap_s": swapped - started,
                          "probe_s": done - swapped}
        # the new checkpoint is what every later rebuild builds from; the
        # replaced raw weights become the rollback stash
        self._param_stash = (self._decoder_kwargs["params"],
                             self._decoder_kwargs["embed_table"],
                             self.version)
        self._decoder_kwargs["params"] = holder["params"]
        if new_table is not None:
            self._decoder_kwargs["embed_table"] = new_table
        self.version = holder.get("version")
        self.decoder.version = self.version
        self.health.incr("param_swaps")
        holder["event"].set()
        return True

    def _note_progress(self, waiting):
        """After a collect: book queue waits (staged to admitted), times
        to the first token and, at completion, times per output token
        into the health windows, and resolve every finished request."""
        decoder = self.decoder
        now = time.monotonic()
        for rid in list(waiting):
            holder = waiting[rid]
            staged_at = holder["staged_at"]
            if "queue_waited" not in holder:
                admitted = decoder.admitted_at.get(rid)
                if admitted is not None:
                    holder["queue_waited"] = True
                    self.health.record_latency(
                        "queue_wait", max(0.0, admitted - staged_at))
            if "first_token" not in holder and decoder.results.get(rid):
                holder["first_token"] = now
                self.health.record_latency("ttft",
                                           max(0.0, now - staged_at))
            if decoder.done(rid):
                tokens = decoder.results.pop(rid)
                if len(tokens) > 1:
                    self.health.record_latency(
                        "tpot", (now - holder["first_token"])
                        / (len(tokens) - 1))
                self._resolve(waiting.pop(rid), "completed",
                              tokens=tokens)

    def _drive(self):
        """The lag-1 loop (``serving.py:3099-3268``, without the
        governor, the rollout and the serve scope): each pass drains the
        staged queue, expires deadlines, DISPATCHES chunk N+1 and only
        then collects chunk N, so the card computes the next chunk while
        the host reads the last one back. The breaker opens on any
        fault of the pass and rebuilds with exponential backoff; the
        chunk in flight is dropped, never collected into shed requests'
        results. While a swap is pending the staged queue holds; the
        idle decoder swaps."""
        waiting = {}
        backoff = self.rebuild_backoff
        try:
            while not self._stop.is_set():
                if self._tripped is not None:
                    # breaker open: drop the chunk in flight, shed
                    # stragglers, rebuild behind the probe
                    self._pending = None
                    self._fail_all(waiting, self._tripped,
                                   outcome="shed", code=503)
                    if self._stop.wait(backoff):
                        break
                    if self._rebuild():
                        self._tripped = None
                        backoff = self.rebuild_backoff
                        self.last_rebuild["trip_to_ready_s"] = (
                            time.monotonic() - self._tripped_at)
                        self.health.incr("rebuilds")
                        self.health.set_breaker("closed")
                        self.health.set_ready(True)
                    else:
                        backoff = min(backoff * 2,
                                      self.rebuild_backoff_max)
                    continue
                if self._trip_request is not None:
                    reason, self._trip_request = self._trip_request, None
                    self._pending = None
                    self._trip(RuntimeError(reason), waiting)
                    continue
                if self._swap_request is None:
                    waiting.update(self._drain_staged())
                self._expire_deadlines(waiting)
                if not self.decoder.busy and self._pending is None:
                    if self._swap_request is not None:
                        # drained on the old weights: the swap seam
                        holder, self._swap_request = \
                            self._swap_request, None
                        self._apply_swap(holder)
                        continue
                    if self._wake.wait(timeout=0.05):
                        self._wake.clear()
                    continue
                try:
                    if self.chaos is not None:
                        self.chaos.before_step(self.decoder)
                    current = self.decoder.dispatch_chunk(self.chunk)
                    if self._pending is not None:
                        self.decoder.collect_chunk(self._pending)
                    self._pending = current
                    self._note_progress(waiting)
                except Exception as exc:   # noqa: BLE001 - device fault
                    traceback.print_exc()
                    self._pending = None
                    self._trip(exc, waiting)
                    continue
        finally:
            self.health.set_ready(False)
            with self._stage_lock:
                self._accepting = False
            self._pending = None
            self._fail_all(waiting, "server stopped")
            holder, self._swap_request = self._swap_request, None
            if holder is not None and not holder["event"].is_set():
                holder["error"] = "server stopped"
                holder["event"].set()

    # -- HTTP ----------------------------------------------------------
    def _validate(self, raw):
        """Parse one POST body into ``(prompt, budget, deadline_s)``;
        raises ValueError/TypeError/KeyError with the 400 message."""
        payload = json.loads(raw.decode())
        tokens = payload["tokens"]
        if not isinstance(tokens, list) or not tokens \
                or not all(isinstance(t, int) and 0 <= t < self.vocab
                           for t in tokens):
            raise ValueError("tokens must be a non-empty list of ids in "
                             "[0, %d)" % self.vocab)
        budget = payload.get("n_tokens")
        if budget is not None and (not isinstance(budget, int)
                                   or budget < 1):
            raise ValueError("n_tokens must be a positive integer")
        deadline_s = payload.get("deadline_s")
        if deadline_s is None:
            deadline_s = self.deadline
        elif isinstance(deadline_s, bool) \
                or not isinstance(deadline_s, (int, float)) \
                or not math.isfinite(deadline_s) \
                or not 0 < deadline_s <= 86400:
            raise ValueError("deadline_s must be a number of seconds in "
                             "(0, 86400]")
        prompt = numpy.asarray(tokens, numpy.int64)
        limit = budget if budget is not None else self.decoder.n_tokens
        if len(prompt) + limit > self.decoder.max_len:
            raise ValueError("prompt %d + n_tokens %d exceeds max_len %d"
                             % (len(prompt), limit, self.decoder.max_len))
        return prompt, budget, float(deadline_s)

    def _serve(self, handler, prompt, budget, deadline_s):
        """Admission, staging and the reply of one validated request."""
        from veles_tpu_torch.core.httpd import reply, retry_after_headers

        booked = {}
        pool_gate = None
        if self.decoder.pool is not None:
            limit = budget if budget is not None else self.decoder.n_tokens

            def pool_gate():
                # the decoder is read INSIDE the gate (under the
                # admission lock): a rebuild swaps it concurrently
                decoder = self.decoder
                pool = booked["pool"] = decoder.pool
                need = booked["need"] = decoder.worst_case_pages(
                    len(prompt), limit, self.chunk)
                if pool.try_reserve(need):
                    booked["reserved"] = True
                    return None
                return pool.retry_after(need)
        verdict = self.health.try_admit(self.max_queue, pool_gate=pool_gate)
        if verdict == "unready":
            reply(handler, {"error": self._tripped or "not ready"},
                  code=503, headers=retry_after_headers(self.health))
            return
        if verdict == "full":
            reply(handler, {"error": "saturated: %d requests in flight"
                            % self.max_queue},
                  code=429, headers=retry_after_headers(self.health))
            return
        if isinstance(verdict, tuple):
            reply(handler, {"error": "kv page pool exhausted: need %d "
                            "pages, %d free" % (booked["need"],
                                                booked["pool"].free_pages)},
                  code=429, headers={"Retry-After": "%d" % max(
                      1, round(verdict[1]))})
            return
        staged_at = time.monotonic()
        holder = {"event": threading.Event(), "staged_at": staged_at,
                  "deadline": staged_at + deadline_s}
        if booked.get("reserved"):
            holder["pool"] = booked["pool"]
            holder["pool_reserved"] = booked["need"]
        if not self._stage(prompt, budget, holder):
            self._resolve(holder, "errors", error="server stopped",
                          code=503)
        # the driver owns deadline expiry; this wait is only the backstop
        # against a wedged driver, which then cannot ratchet the
        # in-flight gauge up to max_queue
        if not holder["event"].wait(deadline_s + self.BACKSTOP_GRACE):
            self._resolve(holder, "errors", error="timed out", code=503)
        if "error" in holder:
            code = holder.get("code", 400)
            reply(handler, {"error": holder["error"]}, code=code,
                  headers=(retry_after_headers(self.health)
                           if code in (429, 503) else None))
            return
        reply(handler, {"tokens": holder["tokens"]})

    def start(self):
        """Start the HTTP server and the driver thread; returns self
        (``self.port`` holds the bound port)."""
        from http.server import BaseHTTPRequestHandler

        from veles_tpu_torch.core.httpd import (BodyTooLarge,
                                                QuietHandlerMixin,
                                                read_body, reply,
                                                serve_health, start_server)

        api = self

        class Handler(QuietHandlerMixin, BaseHTTPRequestHandler):
            def do_GET(self):
                if not serve_health(self, api.health):
                    self.send_error(404)

            def do_POST(self):
                if self.path.split("?")[0] != api.path:
                    self.send_error(404)
                    return
                try:
                    raw = read_body(self)
                except BodyTooLarge:
                    return  # 413 sent, nothing buffered
                try:
                    prompt, budget, deadline_s = api._validate(raw)
                except (ValueError, TypeError, KeyError) as exc:
                    reply(self, {"error": str(exc)}, code=400)
                    return
                api._serve(self, prompt, budget, deadline_s)

        self._stop.clear()
        with self._stage_lock:
            self._accepting = True
        self._httpd, self.port = start_server(
            Handler, self.host, self.port, name="generate-api")
        self._driver = threading.Thread(target=self._drive,
                                        name="generate-driver",
                                        daemon=True)
        self._driver.start()
        self.health.set_ready(True)
        return self

    def stop(self):
        """Stop the driver (answering what is in flight with 503) and the
        HTTP server."""
        self.health.set_ready(False)
        self._stop.set()
        self._wake.set()
        if self._driver is not None:
            self._driver.join(timeout=30)
            self._driver = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
