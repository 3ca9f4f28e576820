"""Continuous-batching LLM serving on the paged KV pool, and its HTTP
front.

The port of ``veles_tpu/serving.py``'s ``ContinuousDecoder`` (paged
branches, cold admissions: ``:761-2115``) and the core of
``GenerateAPI`` (``:2138-3590``). A fixed set of slots decodes in
lockstep on the card while new requests prefill into free slots
mid-flight; each decode step attends through the fused paged-attention
kernel and, in the ``quantize="int8"`` tier, every projection runs the
int8 matvec kernel.

PyTorch runs eagerly, so the JAX package's prompt buckets and pow2 group
padding (which only bound jit caches) are gone: every admission group is
ragged — one prefill at the group's page-rounded width, each row
allocating exactly its prompt's pages, as the JAX kernel path admits
(``serving.py:1486-1541``). The dense slot slab, the prefix cache, the
int8-KV tier, the mesh and the observability, breaker, governor and
deploy planes are later slices.
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
from veles_tpu_torch.parallel.decode import quantize_params
from veles_tpu_torch.parallel.kv_pool import (SCRATCH_PAGE, PagePool,
                                              default_pool_pages,
                                              init_paged_state,
                                              paged_admit_many,
                                              paged_slot_step,
                                              paged_slot_step_many,
                                              pages_for)

#: default page size (the JAX package's SLOT_SPAN_TILE)
DEFAULT_PAGE_SIZE = 128


class ContinuousDecoder:
    """Continuous batching over the paged KV pool. Single-threaded
    host driver: :meth:`submit` at any time, then :meth:`step` (one
    token per slot), :meth:`dispatch_chunk` + :meth:`collect_chunk` (a
    chunk of tokens, split so a driver can enqueue chunk N+1 before
    reading chunk N back), or :meth:`run_until_drained` /
    :meth:`drain_pipelined`. Tokens stream into
    ``results[request_id]``.

    Greedy by default; ``temperature > 0`` samples from one
    ``torch.Generator`` seeded with ``seed`` (the JAX package's
    per-request key streams have no counterpart yet, so a sampled
    stream depends on which requests share its steps).

    Numerical contract: a request's greedy stream equals
    :func:`parallel.decode.generate` for its prompt up to f32
    round-off — the same sublayers, with the paged kernel attending in
    f32; near-tied argmaxes may break differently."""

    def __init__(self, params, embed_table, heads, slots=4, max_len=512,
                 n_tokens=32, eos=None, temperature=0.0, top_k=0, seed=0,
                 quantize=None, paged=True, page_size=None,
                 pool_pages=None, device=None):
        if not paged:
            raise NotImplementedError(
                "the dense slot slab is not ported yet; the port serves "
                "the paged pool (paged=True)")
        if quantize not in (None, "none", "int8"):
            raise ValueError("quantize must be None or 'int8' (the "
                             "int8-KV tier is not ported yet), got %r"
                             % (quantize,))
        self.device = resolve_device(device)
        self.quantize = quantize if quantize != "none" else None
        params = tree_to(params, self.device)
        if self.quantize and not isinstance(params["head"], dict):
            params = quantize_params(params)
        self.params = params
        self.embed_table = embed_table.to(self.device)
        self.heads = heads
        self.slots = slots
        self.max_len = max_len
        self.page_size = int(page_size if page_size is not None
                             else DEFAULT_PAGE_SIZE)
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1, got %d"
                             % self.page_size)
        #: default: every slot full to max_len plus the lag-1 pipeline's
        #: overshoot for chunks up to n_tokens, plus the scratch page
        self.pool_pages = (int(pool_pages) if pool_pages is not None
                           else default_pool_pages(slots, max_len,
                                                   self.page_size,
                                                   chunk=n_tokens))
        self.n_tokens = n_tokens
        self.eos = eos
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        embed = self.embed_table.shape[1]
        self.state = init_paged_state(
            len(params["blocks"]), self.pool_pages, self.page_size, heads,
            embed // heads, self.embed_table.shape[0], slots,
            dtype=self.embed_table.dtype, device=self.device)
        self.pool = PagePool(self.pool_pages, self.page_size)
        self._slot_pages = {}    # slot -> [page id, ...] in logical order
        self._queue = collections.deque()
        self._free = list(range(slots))
        self._slot_req = {}      # slot -> request id
        self._slot_len = {}      # slot -> device-side sequence length
        self._budget = {}        # request id -> tokens still wanted
        self.results = {}        # request id -> [token, ...]
        self._next_id = 0
        #: dispatch tally: one "admit" per admission group, one "chunk"
        #: per chunked dispatch, one "step" per single step
        self.dispatch_counts = {"admit": 0, "admit_requests": 0,
                                "chunk": 0, "step": 0}
        #: host-blocking wall seconds of chunk enqueues and readbacks
        self.timings = {"dispatch_s": 0.0, "collect_s": 0.0}

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

    def _admit_pending(self):
        """Admit every queued request that has a free slot and pages for
        its prompt, as ONE ragged prefill: the group's page-rounded max
        width, each row allocating exactly its prompt's pages (short
        rows pad their page ids with the scratch page, which the
        per-row lengths keep invisible). A request the pool cannot
        serve yet stays at the front of the queue."""
        ps = self.page_size
        group = []
        while self._queue and self._free:
            rid, prompt, _ = self._queue[0]
            pages = self.pool.alloc(pages_for(len(prompt), ps))
            if pages is None:
                break
            self._queue.popleft()
            group.append((rid, prompt, self._free.pop(), pages))
        if not group:
            return
        width = pages_for(max(len(r[1]) for r in group), ps) * ps
        prompts = numpy.zeros((len(group), width), numpy.int64)
        page_ids = numpy.full((len(group), max(len(r[3]) for r in group)),
                              SCRATCH_PAGE, numpy.int32)
        for j, (_, prompt, _, pages) in enumerate(group):
            prompts[j, :len(prompt)] = prompt
            page_ids[j, :len(pages)] = pages
        x = self.embed_table[self._upload(prompts)]
        self.state = paged_admit_many(
            self.params, self.heads, self.state,
            self._upload(numpy.asarray([r[2] for r in group], numpy.int64)),
            self._upload(page_ids), x,
            self._upload(numpy.asarray([len(r[1]) for r in group],
                                       numpy.int64)))
        self.dispatch_counts["admit"] += 1
        self.dispatch_counts["admit_requests"] += len(group)
        for rid, prompt, slot, pages in group:
            self._slot_req[slot] = rid
            self._slot_len[slot] = len(prompt)
            self._slot_pages[slot] = list(pages)

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
        chunks of slack — what the HTTP gate reserves."""
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

    def step(self):
        """Admit what fits, advance every active slot one token; returns
        {request_id: token} for the tokens generated this step."""
        self._admit_pending()
        if not self._slot_req:
            return {}
        snapshot = dict(self._slot_req)
        self.state, emitted = paged_slot_step(
            self.params, self.embed_table, self.heads, self.state,
            self._page_table_array(1), self._active(),
            self.temperature or 1.0, bool(self.temperature), self.top_k,
            self.generator)
        for slot in snapshot:
            self._slot_len[slot] += 1
        self.dispatch_counts["step"] += 1
        emitted = emitted.cpu().numpy()
        out = {}
        for slot, rid in snapshot.items():
            token = int(emitted[slot])
            self.results[rid].append(token)
            out[rid] = token
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
        self.state, emitted = paged_slot_step_many(
            self.params, self.embed_table, self.heads, self.state,
            self._page_table_array(chunk), self._active(), chunk,
            self.temperature or 1.0, bool(self.temperature), self.top_k,
            self.generator)
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

    def run_until_drained(self, max_steps=100000):
        """Drive :meth:`step` until every submitted request finished."""
        for _ in range(max_steps):
            if not self.busy:
                return self.results
            self.step()
        raise RuntimeError("decoder did not drain in %d steps" % max_steps)


class GenerateAPI:
    """HTTP front for :class:`ContinuousDecoder`. ``POST <path>`` with
    ``{"tokens": [...], "n_tokens": N?, "deadline_s": S?}`` answers
    ``{"tokens": [...]}`` once the request's greedy stream completes;
    ``GET /healthz`` answers the counters and the pool.

    Handler threads validate (400, with the JAX package's messages),
    pass the admission gate — at most ``max_queue`` requests in flight
    (429 beyond it; <= 0 disables the bound) and the request's
    worst-case pages reserved in the pool (429 when they are not there)
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
                 max_queue=64, deadline=300.0, quantize=None, paged=True,
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
        reservation are checked and the request staged under one lock,
        so nothing stages after the driver's final drain. Returns
        "ok", "unready", "full" or "pool"."""
        with self._lock:
            if not self.ready:
                return "unready"
            if 0 < self.max_queue <= self._inflight:
                self.counters["rejected"] += 1
                return "full"
            if not self.decoder.pool.try_reserve(need):
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
        need = self.decoder.worst_case_pages(len(prompt), limit,
                                             self.chunk)
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
            reply(handler, {"error": "kv page pool exhausted: need %d "
                            "pages, %d free"
                            % (need, self.decoder.pool.free_pages)},
                  code=429, headers={"Retry-After": "1"})
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
