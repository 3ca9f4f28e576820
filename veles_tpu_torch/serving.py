"""Continuous-batching LLM serving on the dense slot slab or the paged
KV pool, and its HTTP front.

The port of ``veles_tpu/serving.py``'s ``ContinuousDecoder``
(``:761-2115``) and the core of ``GenerateAPI`` (``:2138-3590``). A
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
tail's) pages, as the JAX kernel path admits. The mesh and the
observability, breaker, governor and deploy planes are later slices.
"""

import collections
import json
import math
import threading
import time
import traceback

import numpy
import torch

from veles_tpu_torch.device import resolve_device, tree_to
from veles_tpu_torch.parallel.decode import (SLOT_SPAN_TILE,
                                             init_slot_state,
                                             quantize_params,
                                             request_key,
                                             slot_admit_many,
                                             slot_step_many)
from veles_tpu_torch.parallel.kv_pool import (SCRATCH_PAGE, PagePool,
                                              default_pool_pages,
                                              init_paged_state,
                                              paged_admit_hit,
                                              paged_admit_many,
                                              paged_admit_tail,
                                              paged_slot_step_many,
                                              pages_for)


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
    ignored by the slab.

    Numerical contract: a request's greedy stream equals
    :func:`parallel.decode.generate` for its prompt up to f32
    round-off — the same sublayers, with the kernels attending in f32;
    near-tied argmaxes may break differently."""

    def __init__(self, params, embed_table, heads, slots=4, max_len=512,
                 n_tokens=32, eos=None, temperature=0.0, top_k=0, seed=0,
                 quantize=None, paged=False, page_size=None,
                 pool_pages=None, device=None):
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
            self.pool = PagePool(self.pool_pages, self.page_size)
            self.state = init_paged_state(
                n_blocks, self.pool_pages, self.page_size, heads,
                embed // heads, vocab, slots, dtype=self.embed_table.dtype,
                quantized=self.quantize == "int8-kv", device=self.device)
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
        self._next_id = 0
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
            for rid, prompt, slot in group:
                self._slot_req[slot] = rid
                self._slot_len[slot] = len(prompt)

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
        for rid, prompt, slot, entry in group:
            self._slot_req[slot] = rid
            self._slot_len[slot] = len(prompt)
            self._slot_pages[slot] = list(entry["pages"])

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
        if self._slot_req.get(slot) == rid:
            del self._slot_req[slot]
            self._free.append(slot)
            self._release_slot_pages(slot)

    def _attended_span(self, extra):
        """The slab positions the next dispatch attends: the longest live
        sequence plus the ``extra`` positions it appends, rounded up to
        :data:`SLOT_SPAN_TILE` and clamped to ``max_len``."""
        longest = max(self._slot_len[s] for s in self._slot_req)
        span = -(-(longest + extra) // SLOT_SPAN_TILE) * SLOT_SPAN_TILE
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

    def run_until_drained(self, max_steps=100000, chunk=1):
        """Drive :meth:`step` (``chunk`` > 1: :meth:`step_many`) until
        every submitted request finished."""
        for _ in range(max_steps):
            if not self.busy:
                return self.results
            if chunk > 1:
                self.step_many(chunk)
            else:
                self.step()
        raise RuntimeError("decoder did not drain in %d steps" % max_steps)


class GenerateAPI:
    """HTTP front for :class:`ContinuousDecoder`. ``POST <path>`` with
    ``{"tokens": [...], "n_tokens": N?, "deadline_s": S?}`` answers
    ``{"tokens": [...]}`` once the request's greedy stream completes;
    ``GET /healthz`` answers the counters and, with ``paged=True``, the
    pool with its ``prefix_*`` cache fields. The decoder serves the
    dense slot slab by default, as the JAX package's does.

    Handler threads validate (400, with the JAX package's messages),
    pass the admission gate — at most ``max_queue`` requests in flight
    (429 beyond it; <= 0 disables the bound) and, on the pool, the
    request's worst-case pages reserved (429 when they are not there,
    its Retry-After priced by the pool's observed page-release rate)
    — then stage the request and wait. ONE driver thread owns the
    decoder: it submits staged requests, cancels expired ones (504),
    and runs lag-1 chunk pipelining (chunk N+1 enqueued before chunk
    N's readback). A decoder failure answers every request in flight
    with 503 and leaves the server unready: the card's state is not
    trusted after a fault."""

    #: extra handler-side wait beyond a request's deadline before the
    #: handler gives up on the driver
    BACKSTOP_GRACE = 10.0

    def __init__(self, params, embed_table, heads, slots=4, max_len=512,
                 n_tokens=32, port=0, host="127.0.0.1", path="/generate",
                 chunk=8,
                 max_queue=64, deadline=300.0, quantize=None, paged=False,
                 page_size=None, pool_pages=None, device=None):
        import queue

        self.deadline = float(deadline)
        if not math.isfinite(self.deadline) \
                or not 0 < self.deadline <= 1e7:
            raise ValueError("deadline must be a positive number of "
                             "seconds (at most 1e7), got %r" % (deadline,))
        self.decoder = ContinuousDecoder(
            params, embed_table, heads, slots=slots, max_len=max_len,
            n_tokens=n_tokens, quantize=quantize, paged=paged,
            page_size=page_size, pool_pages=pool_pages, device=device)
        self.vocab = embed_table.shape[0]
        self.port = port
        self.host = host
        self.path = path
        self.chunk = int(chunk)
        self.max_queue = int(max_queue)
        self.ready = False
        self.failure = None
        self.counters = {"completed": 0, "rejected": 0, "errors": 0,
                         "expired": 0}
        self._inflight = 0
        self._ttft = collections.deque(maxlen=256)
        self._lock = threading.Lock()
        self._staged = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._httpd = None
        self._driver = None
        #: the lag-1 pipeline's chunk in flight (dispatched, not yet
        #: collected)
        self._pending = None

    # -- admission (handler threads) ----------------------------------
    def _admit_and_stage(self, prompt, budget, need, holder):
        """Atomic admission: ready, the in-flight bound and the page
        reservation (``need`` pages, 0 on the slab) are checked and the
        request staged under one lock, so nothing stages after the
        driver's final drain. Returns "ok", "unready", "full" or
        "pool"."""
        pool = self.decoder.pool
        with self._lock:
            if not self.ready:
                return "unready"
            if 0 < self.max_queue <= self._inflight:
                self.counters["rejected"] += 1
                return "full"
            if pool is not None and not pool.try_reserve(need):
                self.counters["rejected"] += 1
                return "pool"
            holder["reserved"] = need
            self._inflight += 1
            self._staged.put((prompt, budget, holder))
        self._wake.set()
        return "ok"

    def _resolve(self, holder, outcome, **fields):
        """Resolve one admitted request exactly once (the driver and a
        backstop-timing-out handler may race): release its pages and
        its in-flight slot, book ``outcome``, wake its handler."""
        token = object()
        if holder.setdefault("resolved", token) is not token:
            return
        holder.update(fields)
        with self._lock:
            if self.decoder.pool is not None:
                self.decoder.pool.unreserve(holder.pop("reserved", 0))
            self._inflight -= 1
            self.counters[outcome] += 1
        holder["event"].set()

    # -- driver thread (sole owner of the decoder) --------------------
    def _drain_staged(self, waiting):
        import queue

        while True:
            try:
                prompt, budget, holder = self._staged.get_nowait()
            except queue.Empty:
                return
            try:
                rid = self.decoder.submit(prompt, budget)
            except ValueError as exc:
                self._resolve(holder, "errors", error=str(exc), code=400)
                continue
            waiting[rid] = holder

    def _expire_deadlines(self, waiting):
        now = time.monotonic()
        for rid in [r for r, h in waiting.items() if now >= h["deadline"]]:
            self.decoder.cancel(rid)
            self._resolve(waiting.pop(rid), "expired",
                          error="deadline exceeded", code=504)

    def _note_progress(self, waiting):
        now = time.monotonic()
        for rid in list(waiting):
            holder = waiting[rid]
            if "first_token" not in holder and self.decoder.results.get(rid):
                holder["first_token"] = now - holder["staged_at"]
                with self._lock:
                    self._ttft.append(holder["first_token"])
            if self.decoder.done(rid):
                self._resolve(waiting.pop(rid), "completed",
                              tokens=self.decoder.results.pop(rid))

    def _fail_all(self, waiting, message):
        import queue

        for holder in waiting.values():
            self._resolve(holder, "errors", error=message, code=503)
        waiting.clear()
        while True:
            try:
                _, _, holder = self._staged.get_nowait()
            except queue.Empty:
                return
            self._resolve(holder, "errors", error=message, code=503)

    def _drive(self):
        """The lag-1 loop: each pass submits staged requests, expires
        deadlines, DISPATCHES chunk N+1 and only then collects chunk N,
        so the card computes the next chunk while the host reads the
        previous one back and resolves finished requests."""
        waiting = {}
        try:
            while not self._stop.is_set():
                self._drain_staged(waiting)
                self._expire_deadlines(waiting)
                if not self.decoder.busy and self._pending is None:
                    if self._wake.wait(timeout=0.05):
                        self._wake.clear()
                    continue
                try:
                    current = self.decoder.dispatch_chunk(self.chunk)
                    if self._pending is not None:
                        self.decoder.collect_chunk(self._pending)
                    self._pending = current
                    self._note_progress(waiting)
                except Exception as exc:  # device/runtime failure
                    traceback.print_exc()
                    self.failure = "decoder failed: %s" % exc
                    return
        finally:
            with self._lock:
                self.ready = False
            self._pending = None
            self._fail_all(waiting, self.failure or "server stopped")

    # -- HTTP ----------------------------------------------------------
    def health(self):
        """The /healthz snapshot."""
        with self._lock:
            ttft = sorted(self._ttft)
            snap = {"ready": self.ready, "failure": self.failure,
                    "inflight": self._inflight,
                    "max_queue": self.max_queue,
                    "counters": dict(self.counters)}
        if self.decoder.pool is not None:
            snap["pool"] = self.decoder.pool.snapshot()
        snap["dispatch_counts"] = dict(self.decoder.dispatch_counts)
        snap["device"] = str(self.decoder.device)
        snap["ttft_ms"] = (
            {"p50": 1000 * ttft[len(ttft) // 2],
             "p95": 1000 * ttft[min(len(ttft) - 1,
                                    int(0.95 * len(ttft)))]}
            if ttft else None)
        return snap

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
        from veles_tpu_torch.core.httpd import reply

        limit = budget if budget is not None else self.decoder.n_tokens
        need = (self.decoder.worst_case_pages(len(prompt), limit,
                                              self.chunk)
                if self.decoder.pool is not None else 0)
        staged_at = time.monotonic()
        holder = {"event": threading.Event(), "staged_at": staged_at,
                  "deadline": staged_at + deadline_s}
        verdict = self._admit_and_stage(prompt, budget, need, holder)
        if verdict == "unready":
            reply(handler, {"error": self.failure or "not ready"},
                  code=503, headers={"Retry-After": "1"})
            return
        if verdict == "full":
            reply(handler, {"error": "saturated: %d requests in flight"
                            % self.max_queue},
                  code=429, headers={"Retry-After": "1"})
            return
        if verdict == "pool":
            pool = self.decoder.pool
            reply(handler, {"error": "kv page pool exhausted: need %d "
                            "pages, %d free" % (need, pool.free_pages)},
                  code=429, headers={"Retry-After": "%d" % max(
                      1, round(pool.retry_after(need)))})
            return
        if not holder["event"].wait(deadline_s + self.BACKSTOP_GRACE):
            self._resolve(holder, "errors", error="timed out", code=503)
        if "error" in holder:
            code = holder.get("code", 400)
            reply(handler, {"error": holder["error"]}, code=code,
                  headers=({"Retry-After": "1"} if code in (429, 503)
                           else None))
            return
        reply(handler, {"tokens": holder["tokens"]})

    def start(self):
        """Start the HTTP server and the driver thread; returns self
        (``self.port`` holds the bound port)."""
        from http.server import BaseHTTPRequestHandler

        from veles_tpu_torch.core.httpd import (BodyTooLarge,
                                                QuietHandlerMixin,
                                                read_body, reply,
                                                start_server)

        api = self

        class Handler(QuietHandlerMixin, BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?")[0] == "/healthz":
                    reply(self, api.health())
                else:
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
        self._httpd, self.port = start_server(
            Handler, self.host, self.port, name="generate-api")
        self._driver = threading.Thread(target=self._drive,
                                        name="generate-driver",
                                        daemon=True)
        with self._lock:
            self.ready = True
        self._driver.start()
        return self

    def stop(self):
        """Stop the driver (answering what is in flight with 503) and the
        HTTP server."""
        self._stop.set()
        self._wake.set()
        if self._driver is not None:
            self._driver.join(timeout=30)
            self._driver = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
