"""Continuous-batching LLM serving on the dense slot slab or the paged
KV pool, and its HTTP front with the survival layer; and per-tick
workflow serving (``RESTfulAPI`` with ``RestfulLoader``, and the REPL's
``InteractiveLoader``, ``serving.py:66-232`` and ``:522-728``).

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
one-slot rollback stash.

The observe plane's base (``observe/``) rides these paths as in the JAX
package: ``/metrics`` and ``/debug/`` on both HTTP fronts, the health and
decoder bridges, the ``X-Veles-Trace`` header continued into the
``serve.request`` span and echoed, the decoder's ``decode.admit``,
``paged.admit``, ``paged.admit_tail``, ``paged.admit_hit``,
``decode.dispatch``/``paged.dispatch`` and ``decode.collect`` spans and
``veles_decode_{admit,dispatch,collect}_seconds`` histograms, the flight
notes (``admit``, ``step``, ``dispatch``, ``collect``, ``breaker``,
``breaker.trip``, ``deploy.swap``) with a black box dumped on a breaker
trip, the exemplar-linked ``veles_request_{ttft,tpot}_seconds`` and the
dispatch's online MFU. The serving hooks (``observe/``, ROADMAP A7 (b))
ride them too: every request's ledger row (``reqledger.py``: staged,
pool-gated, admitted with its admission kind and group, each chunk's
tokens, resolved), read once at resolve time by the SLO engine, the
health windows and the latency histograms (``slo.observe_request``); the
serve scope's waste and wall accounting at every admission, dispatch,
collect and idle wait (``servescope.py``); memscope's owners (the
decoder's ``params``, ``decode_state``, ``kv_pool`` and
``prefix_shadows``, the front's ``param_stash`` and per-request
``admission_scratch``), with the breaker's rebuild and the hot swap
bracketed as lifecycle edges (``memscope.py``); and the metric history's
sampler, held by the fronts while they run (``history.py``).

What acts on those hooks (ROADMAP A7 (c)) rides the driver thread too:
the serving governor (``observe/governor.py``: the tier ladder bf16 ->
int8 -> int8-kv behind a drain-then-swap seam, the admission limit and
the Retry-After price, the proactive breaker guard) and the blue-green
rollout (``rollout.py``: a second, green engine on candidate weights
driven beside the primary in the same pass, tenants routed by their
fixed hash point, promoted or rolled back by the rollout predicate). The
AOT bundle (``aot/``, ``--serve-aot`` / ``root.common.serve.aot``) boots
a replica whose kernel libraries load from the bundle instead of
``nvcc``; every dispatch is looked up in it and booked as an AOT hit or
miss.

The sharded serving mesh (``build_serve_mesh``, ``--serve-mesh`` /
``root.common.serve.mesh``, ``serving.py:729-760``): ``ContinuousDecoder(
mesh=)`` and ``GenerateAPI(mesh=)`` serve the slab and the pool in every
tier tensor-parallel over the mesh's ``model`` axis, a world of one
process per device (``parallel/tp_engine.py``). Every rank holds its
heads of the weights and of the KV, rank 0 runs the host side (HTTP,
admission, page table, prefix cache) and hands each device call on; the
same program runs on every rank, and a rank above 0's ``GenerateAPI.
start()`` follows rank 0 until its end. A swap onto the mesh goes through
``parallel/reshard.reshard`` (slice-only from a host checkpoint) and keeps
its receipt; a breaker rebuild rebuilds every rank and restores the
prefix pages on each. The governor's tier swap and the blue-green
rollout build their decoders from the same kwargs, mesh included (``serving.
py:3035-3058``): each decoder is an engine of its own on every rank, named
in every hand-off, so a probe that fails, a rollback or a promote drops
one engine while the other serves (``tp_engine.follow``).
"""

import base64
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
from veles_tpu_torch.core.mutable import Bool
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.device import (keystr, resolve_device,
                                    tree_leaves_with_path, tree_structure,
                                    tree_to)
from veles_tpu_torch.loader.base import TEST, Loader, register_loader
from veles_tpu_torch.loader.normalization import state_tensors
from veles_tpu_torch.observe.flight import get_flight_recorder
from veles_tpu_torch.observe.history import (get_metric_history,
                                             release_history_sampler)
from veles_tpu_torch.observe.memscope import get_memscope, pytree_nbytes
from veles_tpu_torch.observe.metrics import (bridge, get_metrics_registry,
                                             publish_decoder,
                                             publish_serving_health)
from veles_tpu_torch.observe.reqledger import (get_request_ledger,
                                               publish_request_ledger)
from veles_tpu_torch.observe.servescope import get_serve_scope
from veles_tpu_torch.observe.slo import get_slo_engine, observe_request
from veles_tpu_torch.observe.tracing import (NULL_SPAN, TRACE_HEADER,
                                             current_context,
                                             format_trace_header,
                                             get_tracer, parse_trace_header)
from veles_tpu_torch.observe.xla_stats import (get_compile_tracker,
                                               track_owner)
from veles_tpu_torch.parallel.decode import (SLOT_SPAN_TILE, admit_waste,
                                             dispatch_flops,
                                             init_slot_state,
                                             param_tree_bytes,
                                             prefill_flops,
                                             quantize_params,
                                             request_key,
                                             slot_admit_many,
                                             slot_state_bytes,
                                             slot_step_many,
                                             span_overshoot_tokens,
                                             tile_pad_tokens)
from veles_tpu_torch.parallel.kv_pool import (SCRATCH_PAGE, PagePool,
                                              _paged_restore,
                                              default_pool_pages,
                                              init_paged_state,
                                              paged_admit_hit,
                                              paged_admit_many,
                                              paged_admit_tail,
                                              paged_kv_bytes,
                                              paged_slot_step_many,
                                              pages_for)


#: histogram buckets (seconds) of the decoder's host-blocking calls
#: (``serving.py:61-62``)
DECODE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5, 10.0)

#: the ``X-Veles-Tenant`` request header: a client's tenant id, bounded,
#: rides the ledger row and slices the SLO gauges
TENANT_HEADER = "X-Veles-Tenant"


def _tree_bytes(tree):
    """Bytes of every tensor leaf of ``tree``."""
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in tree_leaves_with_path(tree)
               if isinstance(leaf, torch.Tensor))


def _dtype_name(dtype):
    """A torch dtype as numpy (and so JAX) names it: ``float32``."""
    return str(dtype).replace("torch.", "")


def build_serve_mesh(spec):
    """Build the SERVING mesh from ``--serve-mesh`` /
    ``root.common.serve.mesh`` (``serving.py:729-760``): an
    ``AXIS=N[,AXIS=N...]`` string (the ``--mesh`` parser; -1 absorbs the
    remaining devices), a dict of axis sizes, or None/"" (no mesh: one
    device serves, the default). Errors name the flag; ``build_mesh``
    validates the sizes against the world's (outside a world: 1 device).

    The serve mesh is built from all-1 axes plus exactly what the spec
    names, never seeded from the TRAINING config
    (``root.common.mesh.axes``): a pod-training ``data=2`` must not leak
    into ``--serve-mesh model=2``."""
    if not spec:
        return None
    from veles_tpu_torch.parallel.mesh import (AXIS_ORDER, build_mesh,
                                               parse_axes)

    if isinstance(spec, str):
        spec = parse_axes(spec, flag="--serve-mesh")
    elif hasattr(spec, "__content__"):
        spec = spec.__content__()
    spec = dict(spec)
    if not spec:
        return None
    axes = {name: 1 for name in AXIS_ORDER}
    axes.update(spec)
    return build_mesh(flag="root.common.serve.mesh / --serve-mesh",
                      **axes)


def _sharded(mesh):
    """True when ``mesh`` spreads serving over more than one device."""
    return mesh is not None and mesh.size > 1


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
    near-tied argmaxes may break differently.

    ``mesh`` serves tensor-parallel over the mesh's ``mesh_axis``
    (``serving.py:801-960``): the decoder is rank 0 of the world, holds
    its shard of the weights and a slab or pool of its heads
    (``parallel/tp_engine.ShardEngine``), and hands every device call on
    to the other ranks (:func:`~veles_tpu_torch.parallel.tp_engine.follow`).
    Heads, FFN width and vocabulary must divide by the axis size
    (``decode.validate_slot_mesh``). Each mesh decoder is an engine of
    its own on every rank: the hand-offs name it, :meth:`install` puts it
    in service on the followers and :meth:`discard` drops its shards
    there; ``ship_weights`` hands its whole weights on with its build (a
    rollout's green decoder, whose weights the followers do not hold).
    :meth:`close` ends the world's stream.

    Observability (``observe/``): each admission, dispatch and collect
    opens a span parented to the first traced request it serves (the
    ``trace=`` of :meth:`submit`), observes its
    ``veles_decode_*_seconds`` histogram and notes itself in the flight
    ring; a disabled tracer or registry costs one attribute check, and
    the spans' writes stay outside the timed windows. While the device
    truth is on, each dispatch pins its analytic FLOPs
    (``decode.dispatch_flops``) and the wall time between chunk
    completions of a busy decoder is its step for the MFU gauge.

    The serving hooks: ``ledger`` (a ``RequestLedger``; ``GenerateAPI``
    passes the process ledger) receives each linked request's admission
    (kind ``dense``/``cold``/``tail``/``hit``, group, bucket, program,
    pages) and each chunk's tokens (:meth:`ledger_link` binds a row to a
    request id); the process serve scope (``observe/servescope.py``)
    books every admission, dispatch and collect; memscope registers the
    decoder's ``params`` and ``decode_state`` and the pool's ``kv_pool``
    and ``prefix_shadows``. All of them run between enqueues: no lock,
    no I/O, no device sync."""

    def __init__(self, params, embed_table, heads, slots=4, max_len=512,
                 n_tokens=32, eos=None, temperature=0.0, top_k=0, seed=0,
                 quantize=None, tile=None, paged=False, page_size=None,
                 pool_pages=None, prefix_cache=None, aot=None, ledger=None,
                 mesh=None, mesh_axis="model", device=None,
                 ship_weights=False):
        if quantize not in (None, "none", "int8", "int8-kv"):
            raise ValueError("quantize must be None, 'int8' or 'int8-kv', "
                             "got %r" % (quantize,))
        #: the whole weights a mesh build hands on (None: the followers
        #: build from the weights they hold)
        self._shipped = ((tree_to(params, "cpu"), embed_table.cpu())
                         if ship_weights and _sharded(mesh) else None)
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
        #: the serving mesh, its rank-0 shard and the world link, or None
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._tp = self._link = None
        #: this decoder's engine id on the mesh's link (None off a mesh)
        #: and whether its shards were discarded on the followers
        self.engine_id = None
        self._discarded = False
        #: the last hot swap's reshard receipt ({"bytes", "seconds",
        #: "counts"}, ``parallel/reshard.py``), None off a mesh
        self.last_swap_stats = None
        #: the whole weights a mesh decoder serves (its shard is
        #: ``params``): what a swap compares with and hands back
        self._whole = None
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
        if _sharded(mesh):
            self._build_shard(vocab)
        elif self.paged:
            self.state = init_paged_state(
                n_blocks, self.pool_pages, self.page_size, heads,
                embed // heads, vocab, slots, dtype=self.embed_table.dtype,
                quantized=self.quantize == "int8-kv", device=self.device)
        else:
            self.state = init_slot_state(
                n_blocks, slots, max_len, heads, embed // heads, vocab,
                dtype=self.embed_table.dtype,
                quantized=self.quantize == "int8-kv", device=self.device)
        if self.paged:
            if prefix_cache is not None and len(prefix_cache):
                # the breaker's rebuild: the previous decoder's prefix
                # cache restores into this pool by page copy, never by a
                # prefill of every cached prompt
                started = time.perf_counter()
                self.state = self.pool.restore_entries(
                    self.state, _paged_restore if self._tp is None
                    else self._restore_pages)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.restore_stats = {
                    "pages": len(self.pool.cache.page_shadow),
                    "entries": len(self.pool.cache),
                    "bytes": self.pool.shadow_bytes(),
                    "seconds": time.perf_counter() - started}
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
        #: "green" while this decoder is a rollout's candidate engine
        #: (the green-ramp chaos profile stalls only such steps)
        self.rollout_role = None
        #: the AOT bundle (``aot/loader.AotPrograms``) whose libraries
        #: this decoder's dispatches launch, and its bound facade: every
        #: dispatch is looked up by program and key and booked as a hit
        #: or a miss (``serving.py:961-975``). A geometry mismatch refuses
        #: the bundle with the field named, and the decoder serves live
        #: (the kernels built by nvcc, never a plain version on the card)
        self.aot = None
        self._aot = None
        if aot is not None:
            from veles_tpu_torch.aot.loader import AotCompatError
            try:
                self._aot = aot.bind(self)
                self.aot = aot
            except AotCompatError as exc:
                import logging
                logging.getLogger("ContinuousDecoder").warning(
                    "AOT bundle refused (stale field %r): %s - serving "
                    "continues with live kernel builds", exc.field, exc)
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
        #: requests cancelled before completion
        self.cancelled = 0
        #: the observe plane: the registry and tracer stay structural
        #: no-ops until a /metrics mount or a tracer turns them on; the
        #: flight ring is on (one flag check and an append a dispatch)
        self.metrics = get_metrics_registry()
        self._tracer = get_tracer()
        self.flight = get_flight_recorder()
        self._xla = get_compile_tracker()
        self._last_chunk_done = None
        self._trace = {}    # request id -> (trace_id, span_id)
        #: recently retired trace contexts, bounded: the lag-1 pipeline
        #: collects a request's last chunk one pass after it retires,
        #: and that collect's span must still join the request's trace
        self._done_trace = collections.OrderedDict()
        # without a card, /metrics counts the bytes this decoder holds
        track_owner(self, lambda dec: (
            _tree_bytes((dec.params, dec.embed_table))
            + slot_state_bytes(dec.state)))
        #: the request ledger (None: one attribute check a dispatch) and
        #: this decoder's request id -> row map, popped at retirement
        self.ledger = ledger
        self._ledger_rows = {}
        #: the serving goodput observatory, fed at every dispatch
        self.scope = get_serve_scope()
        self._register_memscope()

    def _build_shard(self, vocab):
        """Rank 0's side of a mesh decoder's build: validate the mesh,
        hand the geometry on (every follower builds its shard from the
        weights it holds) and build rank 0's shard; ``params`` and
        ``state`` are then this rank's."""
        from veles_tpu_torch.parallel.decode import validate_slot_mesh
        from veles_tpu_torch.parallel.tp_engine import (BUILD, ShardEngine,
                                                        world_link)

        mesh, axis = self.mesh, self.mesh_axis
        if mesh.rank != 0:
            raise ValueError(
                "rank %d of a serving mesh follows rank 0: run "
                "parallel.tp_engine.follow (GenerateAPI.start does)"
                % mesh.rank)
        if mesh.shape.get(axis, 1) != mesh.size:
            raise ValueError(
                "a serving mesh shards the %r axis alone, got %s"
                % (axis, dict(mesh.shape)))
        validate_slot_mesh(mesh, self.heads, self.params,
                           self.embed_table, axis=axis)
        config = {"slots": self.slots, "max_len": self.max_len,
                  "vocab": int(vocab), "paged": self.paged,
                  "page_size": self.page_size,
                  "pool_pages": self.pool_pages,
                  "quantize": self.quantize}
        self._link = world_link(mesh)
        self.engine_id = self._link.new_engine()
        self._link.hand_on(BUILD, {"config": config,
                                   "weights": self._shipped},
                           engine=self.engine_id)
        self._shipped = None
        self._whole = (self.params, self.embed_table)
        try:
            self._tp = ShardEngine(mesh, self.params, self.embed_table,
                                   self.heads, config, axis=axis,
                                   device=self.device,
                                   engine_id=self.engine_id)
        except BaseException:
            # the followers built theirs: drop it before raising
            self.discard()
            raise
        self.params = self._tp.params
        self.state = self._tp.state

    def _lead(self, op, args):
        """Rank 0's device call on a mesh: hand it on, then run it on
        this rank's shard; returns what it emits."""
        return self._link.run(self._tp, op, args)

    def _restore_pages(self, state, page_ids, values):
        """The prefix restore on a mesh: every rank copies its heads of
        the whole-head shadows into the fresh pool."""
        self._lead("restore", {"pages": list(page_ids), "values": values})
        return state

    def capture_prefix_shadows(self):
        """Copy the prefix cache's pages to the host from this decoder's
        state (a breaker rebuild's capture): on a mesh, every rank's heads
        of each page, gathered to rank 0."""
        shadow = None
        if self._tp is not None:
            def shadow(_state, pages):
                return self._lead("capture", {"pages": list(pages)})
        self.pool.capture_shadows(self.state, shadow=shadow)

    def heartbeat(self):
        """Keep an idle mesh's followers inside the world's timeout (a
        no-op off a mesh)."""
        if self._link is not None:
            self._link.heartbeat()

    def install(self):
        """Put this decoder's engine in service on the followers: their
        builds without weights take its weights from now on (a no-op off
        a mesh)."""
        if self._link is not None:
            from veles_tpu_torch.parallel.tp_engine import INSTALL
            self._link.hand_on(INSTALL, engine=self.engine_id)

    def discard(self, edge=None):
        """Drop this decoder's engine on the followers, which free its
        pool (a failed probe, a rollback, a replaced decoder). ``edge``
        names rank 0's memscope lifecycle edge, which each follower
        brackets the drop in. A no-op off a mesh, after the first call,
        and on a link that ended or is out of step."""
        link = self._link
        if link is None or self._discarded:
            return
        self._discarded = True
        if link.broken is None and not link.ended:
            from veles_tpu_torch.parallel.tp_engine import DISCARD
            link.hand_on(DISCARD, {"edge": edge}, engine=self.engine_id)

    def close(self):
        """End the serving mesh's stream: its followers return from
        :func:`~veles_tpu_torch.parallel.tp_engine.follow` (a no-op off a
        mesh, and after the first call)."""
        if self._link is not None:
            self._link.end()

    def tp_stats(self):
        """What the mesh's hand-offs and collectives cost on rank 0:
        ``{"handoff": {"calls", "bytes" by op, "seconds"}, "collectives":
        {kind: [calls, operand bytes, seconds]}}``, None off a mesh."""
        if self._tp is None:
            return None
        link = self._link.stats
        return {"handoff": {"calls": dict(link["calls"]),
                            "bytes": dict(link["bytes"]),
                            "seconds": link["seconds"]},
                "collectives": {kind: list(row) for kind, row
                                in self._tp.tp.stats.items()}}

    def _register_memscope(self):
        """memscope's owners (``serving.py:1059-1095``): the weights, the
        pool's pages and shadows, and the rest of the state. The pool's
        page arrays live in ``self.state`` but belong to ``kv_pool``
        (``page_bytes`` stamped here), so ``decode_state`` subtracts
        them. Registration is weak: a decoder the breaker replaces drops
        out when it is collected, and one that is retained keeps
        reporting, which is how an edge's diff names a leaked owner."""
        scope = get_memscope()
        scope.register("params", self, lambda dec: param_tree_bytes(
            dec.params, dec.embed_table))
        if self.pool is None:
            scope.register("decode_state", self,
                           lambda dec: slot_state_bytes(dec.state))
            return
        self.pool.page_bytes = paged_kv_bytes(self.state) // self.pool.pages
        scope.register("kv_pool", self.pool, lambda pool: pool.hbm_bytes())
        scope.register("prefix_shadows", self.pool,
                       lambda pool: pool.shadow_bytes())
        scope.register("decode_state", self, lambda dec: max(
            0, slot_state_bytes(dec.state) - dec.pool.hbm_bytes()))

    def ledger_link(self, rid, row):
        """Bind a staged ledger row to request ``rid`` for the dispatch
        hooks (``GenerateAPI`` calls this right after :meth:`submit`)."""
        if self.ledger is None or row is None:
            return
        self.ledger.link(row, rid)
        self._ledger_rows[rid] = row

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
        old_embed_table)`` as its rollback stash. On a mesh the new whole
        weights are handed on to every rank and each takes its slice
        through ``parallel/reshard.reshard`` (a host checkpoint onto the
        serving layout: slice-only, 0 bytes on the wire); the receipt is
        :attr:`last_swap_stats`, and the stash is the whole old
        weights."""
        sent = new_params
        new_params = tree_to(new_params, self.device)
        if self.quantize and not isinstance(new_params["head"], dict):
            new_params = quantize_params(new_params)
        new_table = (new_embed_table.to(self.device)
                     if new_embed_table is not None else self.embed_table)
        old = (self._whole if self._tp is not None
               else (self.params, self.embed_table))
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
        if self._tp is not None:
            from veles_tpu_torch.parallel.tp_engine import SWAP
            self._link.hand_on(SWAP, {
                "params": tree_to(sent, "cpu"),
                "embed_table": (None if new_embed_table is None
                                else new_embed_table.cpu())},
                engine=self.engine_id)
            self._tp.set_params(new_params, new_table, label="swap")
            self.last_swap_stats = self._tp.last_reshard
            self._whole = (new_params, new_table)
            new_params = self._tp.params
        self.params = new_params
        self.embed_table = new_table
        if self.pool is not None:
            self.pool.flush_prefix_cache()
        return old

    def _span(self, name, rids, **attrs):
        """A span parented to the first TRACED request among ``rids`` (a
        batch dispatch serves many; one owns the span, all ride its
        ``rids`` attribute, which is how a checker joins every other
        request of the batch to it). Disabled: the shared null span, the
        parent lookup skipped."""
        if not self._tracer.enabled:
            return NULL_SPAN
        parent = next((self._trace[r] for r in rids if r in self._trace),
                      None)
        if parent is None:
            parent = next((self._done_trace[r] for r in rids
                           if r in self._done_trace), None)
        return self._tracer.span(name, parent=parent, rids=list(rids),
                                 **attrs)

    def _retire_trace(self, rid):
        trace = self._trace.pop(rid, None)
        if trace is not None:
            self._done_trace[rid] = trace
            while len(self._done_trace) > 4 * self.slots + 8:
                self._done_trace.popitem(last=False)

    def submit(self, prompt_tokens, n_tokens=None, trace=None):
        """Queue one prompt (1-D int sequence); returns the request id.
        It is admitted into a slot on a later step when one is free.
        ``trace`` optionally carries the submitting request's
        (trace_id, span_id), so the dispatch spans join its trace."""
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
        if trace is not None:
            self._trace[rid] = trace
        return rid

    @property
    def busy(self):
        return bool(self._queue or self._slot_req)

    @property
    def aot_active(self):
        """True when an AOT bundle is bound (its geometry matched)."""
        return self._aot is not None

    def _aot_dispatch(self, name, key):
        """Look a dispatch up in the bound bundle before it runs: True
        when the bundle covers it (a hit, its libraries readied), False
        for a miss or without a bundle."""
        if self._aot is None:
            return False
        return self._aot.dispatch(name, key)

    def _dispatch_attribution(self, program):
        """``(program_name, aot_served)`` of the dispatch that just ran
        (the request ledger's per-dispatch attribution)."""
        name = getattr(program, "program_name", program)
        if self._aot is not None:
            last = self._aot.last_dispatch
            if last is not None and last[0] == name:
                return last
        return name, False

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
                    self.scope.note_slot_retire(rid, reason="cancelled")
                    break
        del self._budget[rid]
        self.results.pop(rid, None)
        self.admitted_at.pop(rid, None)
        self._ledger_rows.pop(rid, None)
        self._retire_trace(rid)
        self.cancelled += 1
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
            # the host time booked is the inputs' upload and the call,
            # as before the spans; the span's own writes stay outside it
            t0 = time.perf_counter()
            host = {"slots": numpy.asarray([r[2] for r in group],
                                           numpy.int64),
                    "tokens": self._pad([r[1] for r in group], bucket),
                    "lengths": numpy.asarray([len(r[1]) for r in group],
                                             numpy.int64),
                    "keys": self._host_keys(group)}
            if self._tp is None:
                slots = self._upload(host["slots"])
                x = self.embed_table[self._upload(host["tokens"])]
                lengths = self._upload(host["lengths"])
                keys = self._upload(host["keys"])
            elapsed = time.perf_counter() - t0
            self._aot_dispatch("decode.admit", ("admit", bucket))
            with self._span("decode.admit", [r[0] for r in group],
                            bucket=bucket, group=len(group)):
                t0 = time.perf_counter()
                if self._tp is not None:
                    self._lead("admit", host)
                else:
                    self.state = slot_admit_many(self.params, self.heads,
                                                 self.state, slots, x,
                                                 lengths, keys)
                elapsed += time.perf_counter() - t0
            self._book_admit("admit", elapsed, group, bucket,
                             [len(r[1]) for r in group])
            now = time.monotonic()
            for rid, prompt, slot in group:
                self._slot_req[slot] = rid
                self._slot_len[slot] = len(prompt)
                self.admitted_at[rid] = now
                self._note_seated(slot, rid, "dense", len(group), bucket,
                                  slot_admit_many)

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

    def _host_keys(self, group):
        """The sampling keys of an admission group's requests (each
        row's first field is its request id), on the host."""
        return request_key(self.seed,
                           numpy.asarray([r[0] for r in group])).numpy()

    def _req_keys(self, group):
        """:meth:`_host_keys` on the device."""
        return self._upload(self._host_keys(group))

    def _book_admit(self, kind, elapsed, group, bucket, lens=()):
        """The bookkeeping of one admission: timings, the dispatch tally,
        the ``veles_decode_admit_seconds`` histogram, the flight ring, the
        serve scope's prefill accounting (``lens`` the live prompt or
        tail lengths; a hit prefills nothing) and, while the device truth
        is on, the prefill's FLOPs. ``kind`` is the slab's ``"admit"``
        (the JAX package books it unlabelled, and its scope and ledger
        ``"dense"``) or the pool's ``"cold"``, ``"tail"`` or ``"hit"``;
        ``bucket`` the prefill's width (0 for hits). The groups carry no
        duplicate rows, so ``group_dup`` books 0."""
        if self.scope.enabled:
            live, pad, dup = admit_waste(bucket, lens, len(group))
            self.scope.note_admit("dense" if kind == "admit" else kind,
                                  bucket, len(group), len(group), live,
                                  pad, dup, elapsed)
        self.timings["admit_s"] += elapsed
        key = "admit" if kind in ("admit", "cold") else "admit_" + kind
        self.dispatch_counts[key] += 1
        self.dispatch_counts["admit_requests"] += len(group)
        ms = round(elapsed * 1000, 3)
        if kind == "admit":
            self.metrics.observe(
                "veles_decode_admit_seconds", elapsed,
                buckets=DECODE_BUCKETS,
                help="host-blocking bucket-prefill dispatch time")
            self.flight.note("admit", bucket=bucket, group=len(group),
                             ms=ms)
        else:
            self.metrics.observe(
                "veles_decode_admit_seconds", elapsed,
                buckets=DECODE_BUCKETS, labels={"kind": kind},
                help="host-blocking admission dispatch time")
            self.flight.note("admit", family=kind, bucket=bucket,
                             group=len(group), ms=ms)
        if self._xla.enabled and bucket:
            self._xla.set_program_flops(
                {"admit": "decode.admit", "cold": "paged.admit",
                 "tail": "paged.admit_tail"}[kind],
                prefill_flops(self.params, len(group), bucket))

    def _note_seated(self, slot, rid, kind, group, bucket, program):
        """The slot timeline and the request's ledger row for one seated
        request (``serving.py:1375-1387``); ``program`` is the admission
        function (its ``program_name``), attributed AOT or live as the
        bundle served it (:meth:`_dispatch_attribution`)."""
        self.scope.note_slot_admit(slot, rid, kind, bucket=bucket,
                                   trace=self._trace.get(rid))
        if self.ledger is not None:
            name, served = self._dispatch_attribution(program)
            self.ledger.note_admit(
                self._ledger_rows.get(rid), kind, group=group,
                bucket=bucket, aot=served, program=name,
                pages=len(self._slot_pages.get(slot) or ()))

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

    @staticmethod
    def _pad(rows, width, fill=0, dtype=numpy.int64):
        """Rows of unequal length right-padded into one host array."""
        out = numpy.full((len(rows), width), fill, dtype)
        for j, row in enumerate(rows):
            out[j, :len(row)] = row
        return out

    def _admit_cold(self, group):
        """One ragged prefill at the group's page-rounded max width,
        short rows padding their page ids with the scratch page, which
        the per-row lengths keep invisible."""
        ps = self.page_size
        width = pages_for(max(len(r[1]) for r in group), ps) * ps
        t0 = time.perf_counter()
        host = {"slots": numpy.asarray([r[2] for r in group], numpy.int64),
                "pages": self._pad([r[3] for r in group],
                                   max(len(r[3]) for r in group),
                                   SCRATCH_PAGE, numpy.int32),
                "tokens": self._pad([r[1] for r in group], width),
                "lengths": numpy.asarray([len(r[1]) for r in group],
                                         numpy.int64),
                "keys": self._host_keys(group)}
        if self._tp is None:
            args = (self._upload(host["slots"]), self._upload(host["pages"]),
                    self.embed_table[self._upload(host["tokens"])],
                    self._upload(host["lengths"]),
                    self._upload(host["keys"]))
        elapsed = time.perf_counter() - t0
        self._aot_dispatch("paged.admit", ("paged_admit", width))
        with self._span("paged.admit", [r[0] for r in group],
                        bucket=width, group=len(group)):
            t0 = time.perf_counter()
            if self._tp is not None:
                self._lead("paged.admit", host)
            else:
                self.state = paged_admit_many(self.params, self.heads,
                                              self.state, *args)
            elapsed += time.perf_counter() - t0
        self._book_admit("cold", elapsed, group, width,
                         [len(r[1]) for r in group])
        for rid, prompt, slot, pages in group:
            self._seat(slot, rid, prompt, pages)
            self._note_seated(slot, rid, "cold", len(group), width,
                              paged_admit_many)

    def _admit_tails(self, group):
        """One ragged tail prefill for tails sharing a prefix page
        count: tails at their page-rounded max width against each row's
        pooled prefix pages. The extended prompt is published too (its
        pages hold what a cold prefill would), so a repeated one becomes
        a hit."""
        ps = self.page_size
        tails = [r[1][r[4]:] for r in group]
        width = pages_for(max(len(t) for t in tails), ps) * ps
        t0 = time.perf_counter()
        host = {"slots": numpy.asarray([r[2] for r in group], numpy.int64),
                "prefix_pages": numpy.asarray([r[3]["pages"]
                                               for r in group], numpy.int32),
                "pages": self._pad([r[5] for r in group],
                                   max(len(r[5]) for r in group),
                                   SCRATCH_PAGE, numpy.int32),
                "tokens": self._pad(tails, width),
                "lengths": numpy.asarray([len(r[1]) for r in group],
                                         numpy.int64),
                "keys": self._host_keys(group)}
        if self._tp is None:
            args = (self._upload(host["slots"]),
                    self._upload(host["prefix_pages"]),
                    self._upload(host["pages"]),
                    self.embed_table[self._upload(host["tokens"])],
                    self._upload(host["lengths"]),
                    self._upload(host["keys"]))
        elapsed = time.perf_counter() - t0
        self._aot_dispatch("paged.admit_tail", (
            "paged_tail", width, len(group[0][3]["pages"])))
        with self._span("paged.admit_tail", [r[0] for r in group],
                        bucket=width, group=len(group),
                        prefix_pages=len(group[0][3]["pages"])):
            t0 = time.perf_counter()
            if self._tp is not None:
                self._lead("paged.admit_tail", host)
            else:
                self.state = paged_admit_tail(self.params, self.heads,
                                              self.state, *args)
            elapsed += time.perf_counter() - t0
        self._book_admit("tail", elapsed, group, width,
                         [len(t) for t in tails])
        for rid, prompt, slot, entry, _, pages in group:
            self._seat(slot, rid, prompt, list(entry["pages"]) + pages)
            self._note_seated(slot, rid, "tail", len(group), width,
                              paged_admit_tail)

    def _admit_hits(self, group):
        """Control rows only, from each entry's cached logits; the slot
        maps the entry's pages (retained by the lookup)."""
        t0 = time.perf_counter()
        args = (self._upload(numpy.asarray([r[2] for r in group],
                                           numpy.int64)),
                self._upload(numpy.asarray([len(r[1]) for r in group],
                                           numpy.int64)),
                torch.stack([r[3]["logits"] for r in group]),
                self._req_keys(group))
        elapsed = time.perf_counter() - t0
        self._aot_dispatch("paged.admit_hit", ("paged_hit",))
        with self._span("paged.admit_hit", [r[0] for r in group],
                        group=len(group)):
            t0 = time.perf_counter()
            if self._tp is not None:
                self._lead("paged.admit_hit", {
                    "slots": args[0].cpu().numpy(),
                    "lengths": args[1].cpu().numpy(),
                    "logits": args[2].cpu(), "keys": self._host_keys(group)})
            else:
                self.state = paged_admit_hit(self.state, *args)
            elapsed += time.perf_counter() - t0
        self._book_admit("hit", elapsed, group, 0)
        now = time.monotonic()
        for rid, prompt, slot, entry in group:
            self._slot_req[slot] = rid
            self._slot_len[slot] = len(prompt)
            self._slot_pages[slot] = list(entry["pages"])
            self.admitted_at[rid] = now
            self._note_seated(slot, rid, "hit", len(group), 0,
                              paged_admit_hit)

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
        return self._upload(self._page_table_host(extra))

    def _page_table_host(self, extra):
        """:meth:`_page_table_array` on the host."""
        self._ensure_tail_pages(extra)
        ps = self.page_size
        pb = max(pages_for(self._slot_len[s] + extra, ps)
                 for s in self._slot_req)
        table = numpy.zeros((self.slots, pb), numpy.int32)
        for slot in self._slot_req:
            pages = self._slot_pages[slot][:pb]
            table[slot, :len(pages)] = pages
        return table

    def worst_case_pages(self, prompt_len, budget, chunk=1):
        """Upper bound on the pages one request can hold at once: its
        prompt grown to the token budget plus the lag-1 pipeline's two
        chunks of slack — what the HTTP gate reserves. Ragged admission
        makes it the bound of every family: a tail maps the shared whole
        pages plus exactly its tail's, a hit the prompt's pages."""
        return pages_for(prompt_len + budget + 2 * chunk, self.page_size)

    def _active_host(self):
        active = numpy.zeros(self.slots, bool)
        for slot in self._slot_req:
            active[slot] = True
        return active

    def _active(self):
        return self._upload(self._active_host())

    def _retire(self, slot, rid):
        del self._budget[rid]
        self.admitted_at.pop(rid, None)
        self._ledger_rows.pop(rid, None)
        self._retire_trace(rid)
        self.scope.note_slot_retire(rid)
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
        """Run ``n`` lockstep steps of every slot (slab or pool), looked
        up in the bundle first; returns the emitted tokens (n, S), still
        on the device, and whether the bundle served the dispatch."""
        sampling = (self.temperature or 1.0, bool(self.temperature),
                    self.top_k)
        if self._tp is not None:
            host = {"active": self._active_host(), "n": n,
                    "sampling": sampling}
            if self.paged:
                host["table"] = self._page_table_host(n)
                served = self._aot_dispatch(
                    "paged.dispatch",
                    ("paged_dispatch", n, host["table"].shape[1]))
                return self._lead("paged.dispatch", host), served
            host["span"] = self._attended_span(n)
            served = self._aot_dispatch("decode.dispatch",
                                        ("dispatch", n, host["span"]))
            return self._lead("dispatch", host), served
        if self.paged:
            table = self._page_table_array(n)
            served = self._aot_dispatch(
                "paged.dispatch", ("paged_dispatch", n, table.shape[1]))
            self.state, emitted = paged_slot_step_many(
                self.params, self.embed_table, self.heads, self.state,
                table, self._active(), n, *sampling)
        else:
            span = self._attended_span(n)
            served = self._aot_dispatch("decode.dispatch",
                                        ("dispatch", n, span))
            self.state, emitted = slot_step_many(
                self.params, self.embed_table, self.heads, self.state,
                self._active(), n, *sampling, span=span)
        return emitted, served

    def _note_dispatch(self, n, lens, elapsed):
        """The serve scope's booking of one ``n``-step dispatch over the
        live lanes of lengths ``lens`` (before the dispatch): dead-slot
        lane-steps, and the slab's span-tile overshoot or the pool's
        last-page residual (K1 and K3 attend live pages only: the JAX
        package's ``paged_kernel`` route, ``serving.py:2025-2042``)."""
        if self.paged:
            overshoot = tile_pad_tokens(lens, self.page_size, n)
            span, pages = 0, max(pages_for(length + n, self.page_size)
                                 for length in lens)
        else:
            span = min(-(-(max(lens) + n) // self.tile) * self.tile,
                       self.max_len)
            overshoot = span_overshoot_tokens(lens, span, n)
            pages = 0
        self.scope.note_dispatch(n, self.slots, len(lens), overshoot,
                                 elapsed, paged=self.paged, span=span,
                                 pages=pages, kernel=self.paged)

    def step(self):
        """Admit what fits, advance every active slot one token; returns
        {request_id: token} for the tokens generated this step."""
        self._admit_pending()
        if not self._slot_req:
            return {}
        snapshot = dict(self._slot_req)
        lens = [self._slot_len[s] for s in snapshot]
        t0 = time.perf_counter()
        emitted, served = self._advance(1)
        emitted = emitted[0]
        for slot in snapshot:
            self._slot_len[slot] += 1
        self.dispatch_counts["step"] += 1
        self.flight.note("step", rids=list(snapshot.values()))
        emitted = emitted.cpu().numpy()
        if self.scope.enabled:
            # the step syncs inline: the whole call is one decode window,
            # and every live lane keeps its token
            self._note_dispatch(1, lens, time.perf_counter() - t0)
            self.scope.note_collect(len(snapshot), len(snapshot), 0.0)
        out = {}
        for slot, rid in snapshot.items():
            token = int(emitted[slot])
            if not self.results[rid]:
                self.scope.note_slot_first(rid)
            self.results[rid].append(token)
            if self.ledger is not None:
                self.ledger.note_tokens(self._ledger_rows.get(rid), 1,
                                        aot=served)
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
        program = "paged.dispatch" if self.paged else "decode.dispatch"
        with self._span(program, list(snapshot.values()), chunk=chunk):
            t0 = time.perf_counter()
            emitted, served = self._advance(chunk)
            elapsed = time.perf_counter() - t0
        if self.scope.enabled:
            self._note_dispatch(chunk, [self._slot_len[s] for s in snapshot],
                                elapsed)
        self.timings["dispatch_s"] += elapsed
        self.metrics.observe(
            "veles_decode_dispatch_seconds", elapsed,
            buckets=DECODE_BUCKETS,
            help="chunk enqueue (host-blocking dispatch) time")
        if self._xla.enabled:
            self._xla.set_program_flops(program, dispatch_flops(
                self.params, self.slots,
                [self._slot_len[s] for s in snapshot], chunk))
        for slot in snapshot:
            self._slot_len[slot] += chunk
        self.dispatch_counts["chunk"] += 1
        self.flight.note("dispatch", chunk=chunk,
                         rids=list(snapshot.values()),
                         ms=round(elapsed * 1000, 3))
        return emitted, snapshot, served

    def collect_chunk(self, dispatched):
        """Read one dispatched chunk back (the device sync) and account
        its tokens to the requests assigned when it was dispatched;
        requests retired or cancelled meanwhile are skipped, and tokens
        past a budget or ``eos`` are discarded."""
        emitted, snapshot, served = dispatched
        with self._span("decode.collect", list(snapshot.values())):
            t0 = time.perf_counter()
            emitted = emitted.cpu().numpy()   # (chunk, slots)
            elapsed = time.perf_counter() - t0
        self.timings["collect_s"] += elapsed
        self.metrics.observe(
            "veles_decode_collect_seconds", elapsed,
            buckets=DECODE_BUCKETS,
            help="chunk readback (device sync) time")
        self.flight.note("collect", chunk=int(emitted.shape[0]),
                         ms=round(elapsed * 1000, 3))
        if self._xla.enabled:
            # online MFU: under the lag-1 pipeline the wall time between
            # chunk completions is the steady per-chunk step time
            done = time.monotonic()
            if self._last_chunk_done is not None:
                self._xla.observe_step(
                    "paged.dispatch" if self.paged
                    else "decode.dispatch",
                    done - self._last_chunk_done)
            self._last_chunk_done = done
        out = {}
        kept = 0
        for slot, rid in snapshot.items():
            if rid not in self._budget:
                continue
            tokens = emitted[:, slot].tolist()[:self._budget[rid]]
            if self.eos is not None and self.eos in tokens:
                tokens = tokens[:tokens.index(self.eos) + 1]
            kept += len(tokens)
            if tokens and not self.results[rid]:
                self.scope.note_slot_first(rid)
            self.results[rid].extend(tokens)
            if self.ledger is not None and tokens:
                # one cadence stamp a collected chunk a request
                self.ledger.note_tokens(self._ledger_rows.get(rid),
                                        len(tokens), aot=served)
            out[rid] = tokens
            self.tokens_out += len(tokens)
            self._budget[rid] -= len(tokens)
            if self._budget[rid] <= 0 or (
                    tokens and tokens[-1] == self.eos):
                self._retire(slot, rid)
        if self.scope.enabled:
            # live lane-steps dispatched against tokens delivered: the
            # rest is the lag-1 tails, budget clamps and post-eos
            # positions, cause "discard"
            self.scope.note_collect(len(snapshot) * int(emitted.shape[0]),
                                    kept, elapsed)
        if not self.busy:
            # idle: the gap to the next burst's first chunk is no step
            self._last_chunk_done = None
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


#: a weak reference to the newest started GenerateAPI (the deploy CLI's
#: target)
_CURRENT_API = None


def get_current_api():
    """This process's live serving api (the newest
    ``GenerateAPI.start()``), or None (``veles_tpu/serving.py:229-237``):
    ``deploy_cli.rollout_package`` targets it when no api is
    injected."""
    return _CURRENT_API() if _CURRENT_API is not None else None


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
    as p50/p95 in milliseconds, published on ``/metrics`` by
    ``observe/metrics.publish_serving_health``; each breaker transition
    is noted in the flight ring. ``ttft`` and ``queue_wait`` come from the
    driver's progress, ``tpot`` from each resolved request's ledger row
    (``observe/slo.observe_request``). The snapshot mirrors an attached
    SLO engine's worst short-window burn (``slo``), the serve scope's
    occupancy and goodput (``servescope``) and memscope's light summary
    (``memscope``), an attached governor's tier and actuations
    (``governor``) and a live rollout's state (``rollout``)."""

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
        self._slo_ref = None
        self._governor_ref = None
        self._scope_ref = None
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
        # breaker transitions are what a post-mortem wants in the black
        # box (a bounded, lock-free append)
        get_flight_recorder().note("breaker", state=state, api=self.name)

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

    def attach_slo(self, engine):
        """Mirror an SLO engine's worst short-window burn rate into the
        snapshot (weakly referenced, like the pool)."""
        with self._lock:
            self._slo_ref = weakref.ref(engine) if engine is not None \
                else None

    def attach_governor(self, governor):
        """Mirror the serving governor's tier and actuations into the
        snapshot and let it price this front's Retry-After (weakly
        referenced, like the pool)."""
        with self._lock:
            self._governor_ref = weakref.ref(governor) \
                if governor is not None else None

    def attach_servescope(self, scope):
        """Mirror the serve scope's occupancy, goodput and waste share
        into the snapshot (weakly referenced)."""
        with self._lock:
            self._scope_ref = weakref.ref(scope) if scope is not None \
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
        seconds: the attached governor's price first (it watches the
        pool's release rate and the degradation state), else the pool's
        page-release pricing, else 1."""
        with self._lock:
            governor = self._governor_ref() \
                if self._governor_ref is not None else None
            pool = self._pool_ref() if self._pool_ref is not None \
                else None
        if governor is not None:
            return governor.retry_after_s(need)
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
            slo = self._slo_ref() if self._slo_ref is not None else None
            governor = self._governor_ref() \
                if self._governor_ref is not None else None
            scope = self._scope_ref() if self._scope_ref is not None \
                else None
        if deploy is not None:
            snap["version"] = deploy.version
            rollout = getattr(deploy, "_rollout", None)
            if rollout is not None:
                snap["rollout"] = rollout.snapshot()
            decoder = deploy.decoder
            snap["dispatch_counts"] = dict(decoder.dispatch_counts)
            snap["device"] = str(decoder.device)
        if pool is not None:
            snap["pool"] = pool.snapshot()
        if scope is not None:
            summary = scope.summary()
            if summary is not None:
                snap["servescope"] = summary
        if slo is not None:
            summary = slo.summary()
            if summary is not None:
                snap["slo"] = summary
        if governor is not None:
            snap["governor"] = governor.snapshot()
        # memscope's light summary (top owners, headroom, leaks): the
        # reconciled device read stays on /metrics and /debug/memory
        memscope = get_memscope().summary()
        if memscope.get("tagged_bytes"):
            snap["memscope"] = memscope
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
    the decoder is built.

    Observability: ``GET /metrics`` (the health and decoder bridges and
    the device truth) and ``GET /debug/``; an ``X-Veles-Trace`` request
    header continues into the ``serve.request`` span, whose context rides
    the request to the driver (``serve.submit``, ``serve.expire``,
    ``serve.complete`` events, the decoder's spans) and is echoed in the
    reply's header; a breaker trip notes ``breaker.trip`` and dumps the
    black box before it sheds. The serving hooks: each request opens a
    row in ``ledger`` (default: the process ledger) at staging, with its
    ``X-Veles-Tenant`` header and trace id, and resolves it once;
    ``slo`` (default: the engine built from ``root.common.observe.slo``,
    None without objectives) reads every resolved row; ``GET
    /debug/requests``, ``/debug/serve``, ``/debug/history`` and
    ``/debug/memory`` serve the ledger, the serve scope, the metric
    history and memscope.

    What acts on the hooks: ``governor`` (a
    :class:`~veles_tpu_torch.observe.governor.ServingGovernor`; default:
    built from ``root.common.serve.governor``, None without one, and then
    the hot path is unchanged) ticks once per drive pass. It moves new
    admissions down and up the tier ladder through :meth:`request_tier`
    (the staged queue holds, the requests in flight finish at their
    admitted tier, then a decoder built and probed at the new tier takes
    over; a swap whose probe fails keeps the old decoder serving and arms
    a backoff), shrinks :attr:`effective_max_queue`, prices Retry-After
    and trips the breaker ahead of a predicted stall
    (:meth:`request_trip`). :meth:`begin_rollout` builds and probes a
    green engine on candidate weights; the driver steps it beside the
    primary, routes each staged request by its tenant's hash point, and
    promotes it or rolls it back as the rollout's predicate says. The
    prefix cache never crosses a tier: its pages hold the tier's KV
    bytes.

    ``mesh`` (default: :func:`build_serve_mesh` of
    ``root.common.serve.mesh``, never the training mesh) serves
    tensor-parallel over its ``mesh_axis``: every decoder this front
    builds, a breaker rebuild's too, is a mesh decoder over the same
    mesh (``serving.py:2188-2215``). The same program runs on every rank
    of the world: on rank 0 this front serves; on a rank above 0 it opens
    no socket, and :meth:`start` follows rank 0's decoders until rank 0's
    :meth:`stop` ends the stream. The governor's tier swap and the
    blue-green rollout build their decoders over the same mesh: every
    rank holds each of rank 0's decoders as an engine of its own until
    rank 0 discards it (a failed probe, a rollback, a replaced or
    retired decoder)."""

    #: extra handler-side wait beyond a request's deadline before the
    #: handler gives up on the driver (a wedged driver's backstop)
    BACKSTOP_GRACE = 10.0

    def __init__(self, params, embed_table, heads, slots=4, max_len=512,
                 n_tokens=32, temperature=0.0, top_k=0, eos=None, seed=0,
                 port=0, host="127.0.0.1", path="/generate", chunk=8,
                 request_timeout=None, max_queue=None, deadline=None,
                 rebuild_backoff=None, rebuild_backoff_max=None,
                 chaos=None, quantize=None, tile=None, paged=None,
                 page_size=None, pool_pages=None, slo=None, ledger=None,
                 governor=None, aot=None, mesh=None, mesh_axis="model",
                 device=None):
        import queue

        serve_cfg = root.common.serve
        #: the serving mesh (``serving.py:2196-2214``), built here so every
        #: rebuild reuses it; a raw attribute read, since ``get()`` drops a
        #: dict-style ``root.common.serve.mesh.model = 2`` subtree
        if mesh is None:
            try:
                mesh_spec = object.__getattribute__(serve_cfg, "mesh")
            except AttributeError:
                mesh_spec = None
            mesh = build_serve_mesh(mesh_spec)
        self.mesh = mesh
        #: True on a rank above 0 of a serving mesh: start() follows
        self.follower = _sharded(mesh) and mesh.rank != 0
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
        #: the AOT boot (``--serve-aot PATH`` / ``root.common.serve.aot``,
        #: ``serving.py:2249-2282``): the bundle loads ONCE here, so the
        #: decoder and every rebuild reuse the same staged libraries. A
        #: stale, tampered or missing bundle is refused with the field
        #: named and the server boots live: its kernels built by nvcc
        if aot is None:
            aot_path = serve_cfg.get("aot", None)
            if aot_path:
                from veles_tpu_torch.aot.loader import (AotCompatError,
                                                        load_bundle)
                try:
                    aot = load_bundle(aot_path, mesh=mesh, device=device)
                except (AotCompatError, ValueError, OSError) as exc:
                    import logging
                    logging.getLogger("GenerateAPI").warning(
                        "AOT bundle %s refused (%s): %s - serving boots "
                        "with live kernel builds instead", aot_path,
                        getattr(exc, "field", "unreadable"), exc)
                    aot = None
        if aot is not None and aot.chunk is not None \
                and int(aot.chunk) != int(chunk):
            # not a refusal: admissions still hit, but every chunked
            # dispatch would miss, which defeats the boot
            import logging
            logging.getLogger("GenerateAPI").warning(
                "AOT bundle was built for dispatch chunk %d but this "
                "server drives chunk %d: every chunked dispatch will miss "
                "the bundle (veles_aot_misses_total) - rebuild with "
                "--chunk %d or pass chunk=%d", aot.chunk, chunk, chunk,
                aot.chunk)
        #: the bundle every decoder this front builds binds (None: live)
        self.aot = aot
        #: the request ledger (every request's row; the process ledger by
        #: default, so /debug/requests, the autopsy CLI and the black box
        #: see one view) and the SLO engine (None without objectives)
        self.ledger = ledger if ledger is not None \
            else get_request_ledger()
        self.slo = slo if slo is not None else get_slo_engine()
        #: what every decoder this front builds (the first and each
        #: rebuild) is built from; a successful swap replaces the weights
        self._decoder_kwargs = dict(
            params=params, embed_table=embed_table, heads=heads,
            slots=slots, max_len=max_len, n_tokens=n_tokens,
            temperature=temperature, top_k=top_k, eos=eos, seed=seed,
            quantize=quantize, tile=tile, paged=bool(paged),
            page_size=page_size, pool_pages=pool_pages, aot=aot,
            ledger=self.ledger, mesh=mesh, mesh_axis=mesh_axis,
            device=device)
        if self.follower:
            # a rank above 0 holds the weights and follows: no decoder,
            # no socket (start() runs the follower loop)
            self.port = port
            self.decoder = None
            return
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
        if self.slo is not None:
            self.health.attach_slo(self.slo)
        #: the serve scope the decoders feed (the process one); the
        #: driver books its idle and runs the waste autopsy
        self.scope = get_serve_scope()
        self.health.attach_servescope(self.scope)
        self.health.attach_deploy(self)
        #: the serving governor (``observe/governor.py``): None without
        #: config, and then the driver pays one attribute check a pass
        self._base_tier = self.decoder.quantize or "bf16"
        if governor is None:
            from veles_tpu_torch.observe.governor import ServingGovernor
            governor = ServingGovernor.from_config()
        self.governor = governor
        if governor is not None:
            governor.set_base_tier(self._base_tier)
            self.health.attach_governor(governor)
            # burn and pressure sensing run through the metric history,
            # so an incident replays the trends the demotions read
            from veles_tpu_torch.observe.history import \
                ensure_metric_history
            governor.attach_history(ensure_metric_history())
        #: the governor's graceful tier-swap request and the backoff a
        #: failed swap arms; each landed swap's seconds by part
        self._tier_request = None
        self._tier_requested_at = None
        self._tier_block_until = 0.0
        self.tier_swaps = []
        #: the proactive trip request (request_trip), read by the driver
        self._trip_request = None
        #: the pending hot swap (request_swap), the one-slot rollback
        #: stash (params, embed_table, version of what the last swap
        #: replaced) and the version tag of the weights served
        self._swap_request = None
        self._param_stash = None
        self.version = None
        #: the blue-green rollout (``rollout.py``): the staged
        #: begin_rollout holder, the live controller, and the green
        #: engine {"decoder", "waiting", "pending", "params",
        #: "embed_table"}, all owned by the driver thread
        self._rollout_request = None
        self._rollout = None
        self._green = None
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
        # the rollback stash is retention on purpose: memscope's exempt
        # owner, so an edge's diff never takes it for a leak
        get_memscope().register(
            "param_stash", self,
            lambda api: (pytree_nbytes(api._param_stash[0])
                         + pytree_nbytes(api._param_stash[1])
                         if api._param_stash is not None else 0))

    # -- driver thread (sole owner of the decoder) ----------------------
    def _resolve(self, holder, outcome, **fields):
        """Resolve one admitted request exactly once (the driver and a
        backstop-timing-out handler may race): stamp the reply fields,
        release its pages, its scratch tag and its in-flight slot under
        ``outcome``, close its ledger row and feed the row to the SLO
        engine, the ``tpot`` health window and the latency histograms
        (``observe_request``: once per request, never on the token
        path), wake its handler."""
        token = object()
        if holder.setdefault("resolved", token) is not token:
            return
        holder.update(fields)
        get_memscope().scratch_drop(holder.pop("memscope_key", None))
        reserved = holder.pop("pool_reserved", 0)
        if reserved:
            holder["pool"].unreserve(reserved)
        self.health.release(outcome)
        row = holder.get("ledger_row")
        if row is not None:
            self.ledger.resolve(row, outcome, error=holder.get("error"))
            observe_request(row, engine=self.slo,
                            registry=get_metrics_registry(),
                            health=self.health)
        rollout = self._rollout
        if rollout is not None and "deploy" in holder:
            # the rollback predicate's per-role feed (a bounded append)
            rollout.note_resolved(holder["deploy"], outcome == "completed")
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
        id: holder} of the primary engine's. While a rollout is live the
        tenant's fixed hash point picks the engine: green tenants submit
        into the green decoder and its own waiting map, blue ones stay on
        the primary path unchanged (``serving.py:2450-2544``). A request
        admitted against a previous decoder's pool (a rebuild raced its
        staging) moves its page reservation to the pool it will decode
        on, or is shed when that pool is promised to capacity."""
        import queue

        waiting = {}
        while True:
            try:
                prompt, budget, holder = self._staged.get_nowait()
            except queue.Empty:
                break
            rollout = self._rollout
            green = self._green
            target, bucket, role = self.decoder, waiting, None
            if green is not None and rollout is not None:
                role = ("green" if rollout.routes_green(
                    holder.get("tenant") or "") else "blue")
                if role == "green":
                    target = green["decoder"]
                    bucket = green["waiting"]
            # the pop is the claim: _resolve pops the same key, so
            # exactly one side ever releases the reservation
            reserved = holder.pop("pool_reserved", 0)
            if reserved:
                pool = target.pool
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
                rid = target.submit(prompt, budget,
                                    trace=holder.get("trace"))
            except ValueError as exc:
                self._resolve(holder, "errors", error=str(exc), code=400)
                continue
            row = holder.get("ledger_row")
            if row is not None:
                # the tier is stamped at submit, on the decoder that
                # serves the request: a request staged while a tier swap
                # was pending carries the handler's view, so a demoted
                # row gets its stage here and a promote-raced row drops
                # back to the base tier
                served_tier = target.quantize or "bf16"
                row["quant"] = served_tier
                if served_tier != self._base_tier:
                    if row.get("tier") != served_tier:
                        self.ledger.mark(row, "demoted", tier=served_tier)
                elif row.get("tier"):
                    row["tier"] = served_tier
            if role is not None:
                # the role feeds the per-version SLO slices and the
                # rollback predicate; the version names the weights
                holder["deploy"] = role
                if row is not None:
                    row["deploy"] = role
                    row["version"] = (rollout.version if role == "green"
                                      else self.version or "blue")
            target.ledger_link(rid, row)
            get_tracer().event("serve.submit",
                               parent=holder.get("trace"), rid=rid)
            bucket[rid] = holder
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

    def _expire_deadlines(self, waiting, decoder=None):
        """Cancel every request whose deadline passed: its slot frees at
        once and the client gets a 504. ``decoder`` defaults to the
        primary engine; a rollout's green engine passes its own."""
        if decoder is None:
            decoder = self.decoder
        now = time.monotonic()
        for rid in [r for r, h in waiting.items()
                    if now >= h["deadline"]]:
            holder = waiting.pop(rid)
            decoder.cancel(rid)
            get_tracer().event("serve.expire",
                               parent=holder.get("trace"), rid=rid)
            self._resolve(holder, "expired", error="deadline exceeded",
                          code=504)

    def _trip(self, exc, waiting):
        """Open the circuit: the decoder's state is not trusted after a
        fault. The flight recorder notes ``breaker.trip`` and dumps its
        black box FIRST, while the ring still holds the dispatches and
        spans that led here; then everyone staged and in flight is shed
        with a retryable 503, and a pending swap or rollout resolves with
        the trip; a live rollout aborts (the rebuild makes only the
        primary engine), its green requests shed."""
        flight = get_flight_recorder()
        flight.note("breaker.trip", error=str(exc)[:500],
                    inflight=len(waiting))
        flight.dump("breaker_trip",
                    extra={"error": str(exc)[:2000],
                           "health": self.health.snapshot()})
        self.health.incr("trips")
        self.health.set_breaker("open")
        self.health.set_ready(False)
        self._tripped_at = time.monotonic()
        # a pending tier swap is moot: the rebuild lands on the governed
        # tier directly (_governed_kwargs)
        self._tier_request = None
        for pending in (self._swap_request, self._rollout_request):
            if pending is not None:
                pending["error"] = "breaker tripped: %s" % exc
                pending["event"].set()
        self._swap_request = None
        self._rollout_request = None
        if self._green is not None:
            self._abort_green("blue breaker tripped during rollout: %s"
                              % exc)
        self._tripped = "decode driver failed: %s; rebuilding" % exc
        self._fail_all(waiting, self._tripped, outcome="shed", code=503)

    def _governed_kwargs(self):
        """The decoder's construction kwargs at the tier the governor
        wants (the configured one without a governor), and that tier: a
        rebuild lands on the governed rung directly."""
        kwargs = dict(self._decoder_kwargs)
        tier = (self.governor.tier_name() if self.governor is not None
                else self._base_tier)
        kwargs["quantize"] = None if tier == "bf16" else tier
        return kwargs, tier

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
        try:
            probe = decoder.submit([0], 1)
            before = (self.chaos.before_step if self.chaos is not None
                      else None)
            decoder.run_until_drained(max_steps=8, chunk=self.chunk,
                                      before_step=before)
            if not decoder.done(probe):
                raise RuntimeError("probe decode did not finish")
        except BaseException:
            # a mesh's followers drop the engine that failed its probe
            decoder.discard()
            raise
        decoder.results.pop(probe, None)
        restore = decoder.restore_stats or {}
        self.last_rebuild = {
            "build_s": built - started - restore.get("seconds", 0.0),
            "restore_s": restore.get("seconds", 0.0),
            "probe_s": time.perf_counter() - built,
            "restored_pages": restore.get("pages", 0),
            "restored_bytes": restore.get("bytes", 0)}
        return decoder

    def _install_decoder(self, decoder, edge=None):
        """Put the probed decoder in service and point the health
        snapshot's pool mirror at its pool. On a mesh the followers put
        its engine in service and drop the replaced decoder's (inside
        their memscope ``edge`` where one is named)."""
        old, self.decoder = self.decoder, decoder
        if decoder.pool is not None:
            self.health.attach_pool(decoder.pool)
        if old is not None and old is not decoder:
            decoder.install()
            old.discard(edge)

    def _rebuild(self):
        """Build a fresh decoder from the held weights and probe it
        (:meth:`_build_probed_decoder`); only a probed decoder takes
        traffic. In the paged tier the prefix cache outlives the
        decoder: its page shadows are captured here, from the dying
        decoder, and handed on, so the new pool restores them by copy.
        Returns True on success. The seam is a memscope lifecycle edge:
        its per-owner diff names what outlived the trip (the old pool
        retained past the rebuild)."""
        memscope = get_memscope()
        memscope.edge_begin("breaker_rebuild")
        capture_s = 0.0
        try:
            kwargs, tier = self._governed_kwargs()
            # the prefix cache crosses a rebuild at the same tier only:
            # its pages hold the tier's KV bytes
            if self.decoder.pool is not None \
                    and tier == (self.decoder.quantize or "bf16"):
                started = time.perf_counter()
                try:
                    self.decoder.capture_prefix_shadows()
                except Exception:   # noqa: BLE001 - a sick device
                    # can refuse the reads: unshadowed entries are
                    # dropped by the restore and prefilled again later
                    traceback.print_exc()
                capture_s = time.perf_counter() - started
                kwargs["prefix_cache"] = self.decoder.pool.cache
            decoder = self._build_probed_decoder(kwargs)
        except Exception:   # noqa: BLE001 - the breaker retries
            traceback.print_exc()
            # close the edge either way: a retry opens its own
            memscope.edge_end("breaker_rebuild", gc_collect=True)
            return False
        self.last_rebuild["capture_s"] = capture_s
        self._install_decoder(decoder, edge="breaker_rebuild")
        # the old decoder is unbound now; the seam already pays a build,
        # so a collection before the diff costs nothing that matters
        verdict = memscope.edge_end("breaker_rebuild", gc_collect=True)
        if verdict is not None and verdict["leak"]:
            memscope.flush_incidents()
        return True

    # -- the governor's seams (serving.py:2711-2750) ---------------------
    @property
    def effective_max_queue(self):
        """The admission bound in force: the governor's resized limit
        while it sets one, else ``max_queue``."""
        governor = self.governor
        if governor is not None:
            # one read: the driver's tick rebinds admit_limit, and a
            # check-then-read pair could return None (no bound at all)
            override = governor.admit_limit
            if override is not None:
                return override
        return self.max_queue

    def request_tier(self, tier):
        """The governor's actuator (a): ask the driver for a graceful
        swap to ``tier``: stop admitting, let the requests in flight
        finish at their admitted tier, then build and probe a decoder at
        the new tier (:meth:`_apply_tier`). Ignored while a failed swap's
        backoff is armed or a rollout is live, and idempotent at the
        live tier."""
        if time.monotonic() < self._tier_block_until:
            return
        if self._green is not None or self._rollout_request is not None:
            # one deploy-plane operation at a time; the governor asks
            # again after the rollout lands
            return
        if tier == (self.decoder.quantize or "bf16"):
            self._tier_request = None
            return
        if self._tier_request != tier:
            self._tier_requested_at = time.perf_counter()
        self._tier_request = tier
        self._wake.set()

    def request_trip(self, reason):
        """Trip the breaker at the top of the next driver pass: shed
        retryably, rebuild behind the probe, as after a real fault (the
        governor's actuator (d) calls this)."""
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
        unapplied one (which resolves with an error). Refused while a
        blue-green rollout is live: one deploy-plane operation at a
        time."""
        if self._green is not None or self._rollout_request is not None:
            holder = {"event": threading.Event(),
                      "error": "refused: a blue-green rollout is in "
                               "progress"}
            holder["event"].set()
            return holder
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

    def begin_rollout(self, new_params, new_embed_table=None,
                      version="green", config=None, timeout=120.0):
        """Start a blue-green rollout (``serving.py:2803-2828``): build
        and probe a second engine on the new weights, shift tenant slices
        onto it along the configured ladder, and roll back on the green
        slice's burn or TTFT against blue's (``rollout.py``). Blocks until
        the green engine passed (or failed) its probe; returns the
        :class:`~veles_tpu_torch.rollout.BlueGreenRollout`."""
        if self._swap_request is not None:
            raise RuntimeError("refused: a weight hot-swap is pending")
        holder = {"event": threading.Event(), "params": new_params,
                  "embed_table": new_embed_table, "version": version,
                  "config": config}
        previous, self._rollout_request = self._rollout_request, holder
        if previous is not None:
            previous["error"] = "superseded by a newer rollout request"
            previous["event"].set()
        self._wake.set()
        if not holder["event"].wait(timeout):
            raise RuntimeError("rollout start timed out after %.0fs"
                               % timeout)
        if "error" in holder:
            raise RuntimeError(holder["error"])
        return holder["rollout"]

    def _apply_swap(self, holder):
        """The swap itself (driver thread, decoder idle): refuse a
        poisoned checkpoint, swap, probe the new weights end to end, and
        on any failure put the old pair back from the one-slot stash.
        Nothing is shed on either path: the staged queue held while the
        swap was pending and drains into whichever weights won. Both
        outcomes are noted in the flight ring (``deploy.swap_refused``,
        ``deploy.swap``), and the seam is a memscope lifecycle edge (the
        stash grows on purpose under its exempt owner)."""
        memscope = get_memscope()
        memscope.edge_begin("swap_params")
        started = time.perf_counter()
        #: the last swap's reshard receipt on a mesh (None off one)
        self.last_swap_stats = None
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
            get_flight_recorder().note(
                "deploy.swap_refused", error=str(exc)[:200],
                version=str(holder.get("version")))
            from veles_tpu_torch.rollout import note_swap_failure
            note_swap_failure(str(exc), version=holder.get("version"))
            holder["error"] = ("swap refused, old weights serving: %s"
                               % exc)
            holder["event"].set()
            memscope.edge_end("swap_params", gc_collect=True)
            return False
        done = time.perf_counter()
        self.last_swap = {"drain_s": started - holder["requested_at"],
                          "swap_s": swapped - started,
                          "probe_s": done - swapped}
        self.last_swap_stats = self.decoder.last_swap_stats
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
        get_flight_recorder().note("deploy.swap", version=str(self.version))
        holder["event"].set()
        verdict = memscope.edge_end("swap_params", gc_collect=True)
        if verdict is not None and verdict["leak"]:
            memscope.flush_incidents()
        return True

    def _start_green(self, holder):
        """Build and probe the green engine of a blue-green rollout
        (driver thread, ``serving.py:2919-2975``). It shares nothing
        with the primary's pool or prefix cache (old-weight KV must never
        serve green streams); its request ids sit 2^20 above blue's, so
        ledger rows and slot timelines never collide."""
        from veles_tpu_torch.rollout import BlueGreenRollout, RolloutConfig

        if self._green is not None:
            holder["error"] = "a rollout is already in progress"
            holder["event"].set()
            return
        kwargs = dict(self._decoder_kwargs)
        kwargs["params"] = holder["params"]
        if holder.get("embed_table") is not None:
            kwargs["embed_table"] = holder["embed_table"]
        # a mesh's followers hold blue's weights: green's ride its build
        kwargs["ship_weights"] = True
        try:
            bad = _non_finite_leaf((kwargs["params"],
                                    kwargs["embed_table"]))
            if bad is not None:
                raise ValueError("non-finite weights at %s — the "
                                 "checkpoint is poisoned" % bad)
            decoder = self._build_probed_decoder(kwargs)
        except Exception as exc:   # noqa: BLE001 - refused, blue serves
            traceback.print_exc()
            self.health.incr("rollout_failures")
            get_flight_recorder().note("deploy.green_refused",
                                       error=str(exc)[:200])
            holder["error"] = "green build/probe refused: %s" % exc
            holder["event"].set()
            return
        decoder._next_id = self.decoder._next_id + (1 << 20)
        decoder.rollout_role = "green"
        decoder.version = holder.get("version") or "green"
        config = holder.get("config")
        if config is None:
            config = RolloutConfig.from_config()
        self._green = {"decoder": decoder, "waiting": {},
                       "pending": None, "params": holder["params"],
                       "embed_table": holder.get("embed_table")}
        self._rollout = BlueGreenRollout(decoder.version, config=config)
        self._rollout.start(api=self)
        self.health.incr("rollouts")
        holder["rollout"] = self._rollout
        holder["event"].set()

    def _abort_green(self, reason):
        """Tear the green engine down now (its failure, or blue's
        breaker trip): green's requests in flight shed retryably, and the
        rollout lands in ``rolled_back`` with the reason."""
        green, self._green = self._green, None
        if green is None:
            return
        green["decoder"].discard()
        for holder in list(green["waiting"].values()):
            self._resolve(holder, "shed", error=str(reason), code=503)
        green["waiting"].clear()
        if self._rollout is not None:
            self._rollout.abort(reason, api=self)
        self.health.incr("rollout_aborts")
        get_flight_recorder().note("deploy.abort", reason=str(reason)[:200])

    def _rollout_step(self, waiting):
        """The rollout's engine surgery (driver thread,
        ``serving.py:2995-3034``): finish a rollback once green drained
        (nothing shed), and promote once the ladder reached full traffic
        and blue drained: the green decoder becomes the primary, and the
        replaced weights go to the rollback stash. The promotion is a
        memscope lifecycle edge (the blue decoder's pool must die with
        it)."""
        rollout, green = self._rollout, self._green
        if rollout is None or green is None:
            return
        gdec = green["decoder"]
        if rollout.state == "rolling_back":
            if not gdec.busy and green["pending"] is None \
                    and not green["waiting"]:
                self._green = None
                gdec.discard()
                rollout.finish_rollback(api=self)
                self.health.incr("rollbacks")
            return
        if rollout.state != "promote_ready":
            return
        if self.decoder.busy or self._pending is not None or waiting:
            return
        memscope = get_memscope()
        memscope.edge_begin("rollout_promote")
        self._param_stash = (self._decoder_kwargs["params"],
                             self._decoder_kwargs["embed_table"],
                             self.version)
        self._decoder_kwargs["params"] = green["params"]
        if green["embed_table"] is not None:
            self._decoder_kwargs["embed_table"] = green["embed_table"]
        gdec.rollout_role = None
        self._install_decoder(gdec, edge="rollout_promote")
        self.version = rollout.version
        # green's work in flight rides over: its waiting map and lag-1
        # chunk belong to the (new) primary now
        waiting.update(green["waiting"])
        self._pending = green["pending"]
        self._green = None
        rollout.finish_promote(api=self)
        self.health.incr("promotes")
        verdict = memscope.edge_end("rollout_promote", gc_collect=True)
        if verdict is not None and verdict["leak"]:
            memscope.flush_incidents()

    def _apply_tier(self, tier):
        """The graceful tier swap (``serving.py:3035-3058``): the decoder
        is idle (the driver held the staged queue and drained the
        requests in flight), so nobody is shed. Build the decoder at the
        new tier, probe it, put it in service. The prefix cache does not
        cross tiers. A failed build or probe keeps the old decoder
        serving, arms a backoff and notes ``governor.tier_failed``; it
        never serves the new tier any other way. Returns True on
        success."""
        kwargs = dict(self._decoder_kwargs)
        kwargs["quantize"] = None if tier == "bf16" else tier
        started = time.perf_counter()
        try:
            decoder = self._build_probed_decoder(kwargs)
        except Exception:   # noqa: BLE001 - the old decoder serves
            traceback.print_exc()
            self._tier_block_until = time.monotonic() \
                + 4 * self.rebuild_backoff
            get_flight_recorder().note("governor.tier_failed", tier=tier)
            return False
        self._install_decoder(decoder)
        self.health.incr("tier_swaps")
        get_flight_recorder().note("governor.tier", tier=tier,
                                   base=self._base_tier)
        requested = self._tier_requested_at
        self.tier_swaps.append(dict(
            self.last_rebuild, tier=tier,
            swap_s=time.perf_counter() - started,
            drain_s=(started - requested) if requested is not None
            else None))
        return True

    def _note_progress(self, waiting, decoder=None):
        """After a collect: book queue waits (staged to admitted) and
        times to the first token into the health windows (and, during a
        rollout, into the role's TTFT feed), and resolve every finished
        request (its time per output token comes from its ledger row, in
        :meth:`_resolve`). ``decoder`` defaults to the primary engine;
        the green engine passes its own."""
        if decoder is None:
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
                holder["first_token"] = True
                waited = max(0.0, now - staged_at)
                self.health.record_latency("ttft", waited)
                if self._rollout is not None and "deploy" in holder:
                    self._rollout.note_ttft(holder["deploy"], waited,
                                            now=now)
            if decoder.done(rid):
                tokens = decoder.results.pop(rid)
                get_tracer().event("serve.complete",
                                   parent=holder.get("trace"), rid=rid,
                                   tokens=len(tokens))
                self._resolve(waiting.pop(rid), "completed",
                              tokens=tokens)

    def _drive(self):
        """The lag-1 loop (``serving.py:3099-3268``): each pass ticks the
        governor, drains the staged queue, expires deadlines, DISPATCHES
        chunk N+1 and only then collects chunk N, so the card computes
        the next chunk while the host reads the last one back. The
        breaker opens on any fault of the pass and rebuilds with
        exponential backoff; the chunk in flight is dropped, never
        collected into shed requests' results. While a tier swap or a
        weight swap is pending the staged queue holds; the idle decoder
        swaps. During a rollout the green engine steps in the same pass,
        lag-1 on its own chunk in flight: each engine collects its chunk
        before it dispatches again, and both enqueue on one stream, so
        their kernels serialise. A green fault aborts the rollout, never
        the primary."""
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
                if self.governor is not None:
                    # one rate-limited pass; a broken governor never
                    # takes the driver down
                    try:
                        self.governor.tick(self)
                    except Exception:   # noqa: BLE001
                        traceback.print_exc()
                if self._trip_request is not None:
                    reason, self._trip_request = self._trip_request, None
                    self._pending = None
                    self._trip(RuntimeError(reason), waiting)
                    continue
                if self._rollout_request is not None:
                    holder, self._rollout_request = \
                        self._rollout_request, None
                    self._start_green(holder)
                if self._tier_request is None \
                        and self._swap_request is None:
                    waiting.update(self._drain_staged())
                self._expire_deadlines(waiting)
                green = self._green
                if green is not None:
                    self._expire_deadlines(green["waiting"],
                                           decoder=green["decoder"])
                    # the rollout's control loop rides the driver like
                    # the governor's; a broken one never takes it down
                    if self._rollout is not None:
                        try:
                            self._rollout.tick(self)
                        except Exception:   # noqa: BLE001
                            traceback.print_exc()
                    self._rollout_step(waiting)
                    green = self._green   # _rollout_step may clear it
                blue_idle = not self.decoder.busy and self._pending is None
                green_idle = green is None or (
                    not green["decoder"].busy and green["pending"] is None)
                if blue_idle and green_idle:
                    if self._tier_request is not None:
                        # drained at the admitted tier: the tier seam
                        tier, self._tier_request = self._tier_request, None
                        if tier != (self.decoder.quantize or "bf16"):
                            self._apply_tier(tier)
                        continue
                    if self._swap_request is not None:
                        # drained on the old weights: the swap seam
                        holder, self._swap_request = \
                            self._swap_request, None
                        self._apply_swap(holder)
                        continue
                    try:
                        self.decoder.heartbeat()
                    except Exception as exc:   # noqa: BLE001 - lost rank
                        traceback.print_exc()
                        self._trip(exc, waiting)
                        continue
                    idle_from = time.monotonic()
                    woke = self._wake.wait(timeout=0.05)
                    # the queue-empty wall is the scope's idle, not host
                    self.scope.note_idle(time.monotonic() - idle_from)
                    if woke:
                        self._wake.clear()
                    continue
                try:
                    if not blue_idle:
                        if self.chaos is not None:
                            self.chaos.before_step(self.decoder)
                        current = self.decoder.dispatch_chunk(self.chunk)
                        if self._pending is not None:
                            self.decoder.collect_chunk(self._pending)
                        self._pending = current
                        self._note_progress(waiting)
                    # the waste and occupancy autopsy, off the record
                    # path: a broken autopsy never takes the driver down
                    try:
                        self.scope.autopsy_tick(get_metric_history())
                    except Exception:   # noqa: BLE001
                        traceback.print_exc()
                except Exception as exc:   # noqa: BLE001 - device fault
                    traceback.print_exc()
                    self._pending = None
                    self._trip(exc, waiting)
                    continue
                if green is not None and self._green is green \
                        and not green_idle:
                    gdec = green["decoder"]
                    try:
                        if self.chaos is not None:
                            self.chaos.before_step(gdec)
                        current = gdec.dispatch_chunk(self.chunk)
                        if green["pending"] is not None:
                            gdec.collect_chunk(green["pending"])
                        green["pending"] = current
                        self._note_progress(green["waiting"],
                                            decoder=gdec)
                    except Exception as exc:   # noqa: BLE001
                        traceback.print_exc()
                        green["pending"] = None
                        self._abort_green("green engine failed: %s" % exc)
        finally:
            self.health.set_ready(False)
            with self._stage_lock:
                self._accepting = False
            self._pending = None
            self._fail_all(waiting, "server stopped")
            green, self._green = self._green, None
            if green is not None:
                self._fail_all(green["waiting"], "server stopped")
            for attr in ("_swap_request", "_rollout_request"):
                holder = getattr(self, attr)
                setattr(self, attr, None)
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

    def _serve(self, handler, prompt, budget, deadline_s, span=NULL_SPAN,
               trace_hint=None, tenant=""):
        """Admission, staging and the reply of one validated request.
        ``span`` is its ``serve.request`` span: its context rides the
        holder to the driver and is echoed in ``X-Veles-Trace``; with
        tracing off the client's trace id (``trace_hint``) still rides
        the holder and the ledger row, so the latency exemplars and the
        autopsy link to it. The row opens before the admission verdict,
        so a rejected request leaves one too (``serving.py:3405-3530``)."""
        from veles_tpu_torch.core.httpd import reply, retry_after_headers

        ctx = span.context()
        decoder = self.decoder
        limit = budget if budget is not None else decoder.n_tokens
        row = self.ledger.stage(
            api=self.health.name, trace=ctx[0] if ctx else trace_hint,
            tenant=tenant, prompt_len=len(prompt), budget=limit,
            bucket=decoder.bucket_for(len(prompt)), quant=decoder.quantize,
            breaker_gen=self.health.counter("rebuilds"), deadline=deadline_s)
        serving_tier = decoder.quantize or "bf16"
        if serving_tier != self._base_tier:
            # the governed tier in effect: the demoted row names it; the
            # driver stamps it again at submit if a swap lands between
            self.ledger.mark(row, "demoted", tier=serving_tier)
        booked = {}
        pool_gate = None
        if decoder.pool is not None:
            def pool_gate():
                # the decoder is read INSIDE the gate (under the
                # admission lock): a rebuild swaps it concurrently
                decoder = self.decoder
                pool = booked["pool"] = decoder.pool
                need = booked["need"] = decoder.worst_case_pages(
                    len(prompt), limit, self.chunk)
                self.ledger.mark(row, "pool_gated", pages_reserved=need)
                if pool.try_reserve(need):
                    booked["reserved"] = True
                    return None
                return pool.retry_after(need)
        admit_limit = self.effective_max_queue
        verdict = self.health.try_admit(admit_limit, pool_gate=pool_gate)
        if verdict == "unready":
            self.ledger.resolve(row, "rejected", error="unready")
            reply(handler, {"error": self._tripped or "not ready"},
                  code=503, headers=retry_after_headers(self.health))
            return
        if verdict == "full":
            self.ledger.resolve(row, "rejected", error="queue full")
            reply(handler, {"error": "saturated: %d requests in flight"
                            % admit_limit},
                  code=429, headers=retry_after_headers(self.health))
            return
        if isinstance(verdict, tuple):
            self.ledger.resolve(row, "rejected", error="kv page pool full")
            reply(handler, {"error": "kv page pool exhausted: need %d "
                            "pages, %d free" % (booked["need"],
                                                booked["pool"].free_pages)},
                  code=429, headers={"Retry-After": "%d" % max(
                      1, round(verdict[1]))})
            return
        if self.governor is not None:
            # the prewarm trend: admitted requests only
            self.governor.observe_bucket(decoder.bucket_for(len(prompt)))
        staged_at = time.monotonic()
        trace = ctx
        if trace is None and trace_hint:
            trace = (trace_hint, None)
        holder = {"event": threading.Event(), "staged_at": staged_at,
                  "deadline": staged_at + deadline_s, "trace": trace,
                  "tenant": tenant, "ledger_row": row}
        if booked.get("reserved"):
            holder["pool"] = booked["pool"]
            holder["pool_reserved"] = booked["need"]
        # the staged request's host scratch (prompt and budget, int32)
        # under memscope's admission_scratch owner; _resolve drops it
        holder["memscope_key"] = id(holder)
        get_memscope().scratch_note(id(holder), (len(prompt) + limit) * 4)
        if not self._stage(prompt, budget, holder):
            self._resolve(holder, "errors", error="server stopped",
                          code=503)
        # the driver owns deadline expiry; this wait is only the backstop
        # against a wedged driver, which then cannot ratchet the
        # in-flight gauge up to max_queue
        if not holder["event"].wait(deadline_s + self.BACKSTOP_GRACE):
            self._resolve(holder, "errors", error="timed out", code=503)
        headers = {}
        echoed = format_trace_header(span.context())
        if echoed:
            # the client finds its request in the exported timeline
            headers[TRACE_HEADER] = echoed
        if "error" in holder:
            code = holder.get("code", 400)
            span.annotate(outcome="error", code=code)
            if code in (429, 503):
                headers.update(retry_after_headers(self.health))
            reply(handler, {"error": holder["error"]}, code=code,
                  headers=headers)
            return
        span.annotate(outcome="completed", tokens=len(holder["tokens"]))
        reply(handler, {"tokens": holder["tokens"]}, headers=headers)

    def start(self):
        """Start the HTTP server and the driver thread; returns self
        (``self.port`` holds the bound port). On a rank above 0 of a
        serving mesh: follow rank 0 until its end event (no socket),
        then return self; ``follow_stats`` holds what came."""
        if self.follower:
            from veles_tpu_torch.parallel.tp_engine import follow
            kwargs = self._decoder_kwargs
            self.follow_stats = follow(
                self.mesh, kwargs["params"], kwargs["embed_table"],
                kwargs["heads"], axis=kwargs["mesh_axis"],
                device=kwargs["device"])
            return self
        from http.server import BaseHTTPRequestHandler

        from veles_tpu_torch.core.httpd import (BodyTooLarge,
                                                QuietHandlerMixin,
                                                enable_metrics, read_body,
                                                reply, serve_debug_history,
                                                serve_debug_index,
                                                serve_debug_memory,
                                                serve_debug_requests,
                                                serve_debug_serve,
                                                serve_health, serve_metrics,
                                                start_server)

        api = self
        # the deploy CLI's seam (deploy_cli.py): the newest started front
        # is the process's deploy target, weakly referenced so a stopped
        # and collected api drops out on its own
        global _CURRENT_API
        _CURRENT_API = weakref.ref(self)
        # /metrics: the health counters and the decoder's dispatch and
        # timing state through weak scrape-time bridges; the decoder is
        # read THROUGH the api, so a breaker rebuild swaps the source.
        # This front holds the metric history's sampler until stop()
        registry = enable_metrics(self)
        bridge(registry, self.health, publish_serving_health)
        bridge(registry, self,
               lambda reg, live: publish_decoder(reg, live.decoder))
        bridge(registry, self.ledger, publish_request_ledger)
        if self.slo is not None:
            bridge(registry, self.slo, lambda reg, live: live.publish(reg))
        if self.governor is not None:
            from veles_tpu_torch.observe.governor import publish_governor
            bridge(registry, self.governor, publish_governor)

        class Handler(QuietHandlerMixin, BaseHTTPRequestHandler):
            def do_GET(self):
                if serve_metrics(self) \
                        or serve_debug_requests(self, api.ledger) \
                        or serve_debug_history(self) \
                        or serve_debug_serve(self, api.scope, api.ledger) \
                        or serve_debug_memory(self) \
                        or serve_debug_index(self):
                    return
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
                # continue the caller's trace (or root a new one); the
                # span covers admission, staging and the reply
                parent = parse_trace_header(self.headers.get(TRACE_HEADER))
                # the tenant, bounded, rides the ledger row and slices
                # the SLO gauges
                tenant = str(self.headers.get(TENANT_HEADER)
                             or "").strip()[:64]
                with get_tracer().span("serve.request",
                                       parent=parent) as span:
                    api._serve(self, prompt, budget, deadline_s, span,
                               parent[0] if parent else None, tenant)

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
        HTTP server; on a serving mesh, end the followers' stream."""
        if self.follower:
            return
        self.health.set_ready(False)
        self._stop.set()
        self._wake.set()
        if self._driver is not None:
            self._driver.join(timeout=30)
            self._driver = None
        if self.governor is not None:
            # after the driver, so its last pass cannot start a prewarm
            # this join misses
            self.governor.drain_prewarm()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self.decoder is not None:
            self.decoder.close()
        release_history_sampler(self)


# -- per-tick workflow serving (serving.py:66-232, :522-728) -----------------

@register_loader("restful")
class RestfulLoader(Loader):
    """Minibatches assembled from live HTTP requests (reference
    ``RestfulLoader``, ``loader/restful.py:52``): handler threads
    :meth:`feed` samples into a staged host batch; :meth:`run` publishes it
    on the workflow's device, normalized by the trained loader's
    normalizer, once the batch is full or ``max_response_time`` passed
    with at least one request staged."""

    def __init__(self, workflow, **kwargs):
        self.sample_shape = tuple(kwargs.pop("sample_shape", ()))
        self.max_response_time = float(kwargs.pop("max_response_time", 0.1))
        if self.max_response_time < 0:
            raise ValueError("max_response_time must be >= 0")
        super().__init__(workflow, **kwargs)
        self.complete = Bool(False)
        self.requests = []
        self.normalizer = None

    def init_unpickled(self):
        super().init_unpickled()
        self._event_ = threading.Event()
        self._lock_ = threading.Lock()
        self._staged_data_ = None
        self._staged_requests_ = []
        # the normalizer's state on the device, placed on the first tick
        self._norm_state_ = None

    def derive_from(self, loader):
        """Adopt the trained loader's sample geometry and normalizer, so
        served inputs get the training preprocessing (reference
        ``derive_from``)."""
        self.sample_shape = tuple(loader.minibatch_data.shape[1:])
        self.normalizer = getattr(loader, "normalizer", None)
        self._norm_state_ = None

    # -- ILoader --------------------------------------------------------------
    def load_data(self):
        if not self.sample_shape:
            raise ValueError(
                "%s: set sample_shape= or derive_from(trained_loader)"
                % self.name)
        self.class_lengths = [self.max_minibatch_size, 0, 0]
        self._staged_data_ = numpy.zeros(
            (self.max_minibatch_size,) + self.sample_shape, numpy.float32)

    def create_minibatch_data(self):
        mb = self.max_minibatch_size
        self.minibatch_data.reset(torch.zeros(
            (mb,) + self.sample_shape, device=self.device))
        self.minibatch_indices.reset(numpy.zeros(mb, numpy.int64))
        self.sample_mask.reset(torch.zeros(mb, device=self.device))

    def fill_minibatch(self, indices, valid):
        raise NotImplementedError("RestfulLoader overrides run()")

    # -- serving loop ---------------------------------------------------------
    def run(self):
        """Block until at least one request is staged (the flush timer or
        a full batch sets the event), then publish the minibatch."""
        # max_response_time=0 means "flush as soon as anything is staged":
        # poll at a small interval rather than waiting forever
        poll = self.max_response_time if self.max_response_time > 0 \
            else 0.01
        while not self._event_.wait(timeout=poll):
            if self.complete:
                return
            with self._lock_:
                if self._staged_requests_:
                    break
        self._event_.clear()
        if self.complete:
            return
        with self._lock_:
            n = len(self._staged_requests_)
            batch = torch.from_numpy(self._staged_data_.copy())
            self.requests = list(self._staged_requests_)
            self._staged_requests_ = []
        device = self.device
        batch = batch.to(device)
        if self.normalizer is not None:
            if self._norm_state_ is None:
                self._norm_state_ = state_tensors(
                    self.normalizer.jit_state(), device)
            batch = self.normalizer.apply_state(batch, self._norm_state_)
        self.minibatch_class = TEST
        self.minibatch_valid_size = n
        self.minibatch_data.data = batch
        self.sample_mask.data = (torch.arange(self.max_minibatch_size,
                                              device=device) < n).float()
        self.samples_served += n

    def feed(self, data, request):
        """Called from HTTP handler threads: stage one sample. Raises
        OverflowError when the minibatch is full."""
        data = numpy.asarray(data, numpy.float32)
        if data.shape != self.sample_shape:
            data = data.reshape(self.sample_shape)
        with self._lock_:
            slot = len(self._staged_requests_)
            if slot >= self.max_minibatch_size:
                raise OverflowError("minibatch overflow: retry")
            self._staged_data_[slot] = data
            self._staged_requests_.append(request)
            if slot + 1 == self.max_minibatch_size:
                self._event_.set()

    def stop(self):
        self.complete.set(True)
        self._event_.set()


@register_loader("interactive")
class InteractiveLoader(Loader):
    """One-sample serving driven from a REPL: ``loader.feed(obj)`` (an
    array, or a ``.npy``/``.npz``/text file path); ``feed(None)``
    completes the workflow (reference ``InteractiveLoader``,
    ``loader/interactive.py:57``)."""

    def __init__(self, workflow, **kwargs):
        self.sample_shape = tuple(kwargs.pop("sample_shape", ()))
        self.loadtxt_kwargs = kwargs.pop("loadtxt_kwargs", {})
        kwargs.setdefault("minibatch_size", 1)
        super().__init__(workflow, **kwargs)
        self.complete = Bool(False)

    def init_unpickled(self):
        super().init_unpickled()
        self._event_ = threading.Event()
        self._food_ = None

    def load_data(self):
        if not self.sample_shape:
            raise ValueError("%s: set sample_shape=" % self.name)
        self.class_lengths = [1, 0, 0]

    def create_minibatch_data(self):
        self.minibatch_data.reset(torch.zeros(
            (1,) + self.sample_shape, device=self.device))
        self.minibatch_indices.reset(numpy.zeros(1, numpy.int64))
        self.sample_mask.reset(torch.ones(1, device=self.device))

    def fill_minibatch(self, indices, valid):
        raise NotImplementedError("InteractiveLoader overrides run()")

    def run(self):
        self.info("waiting for feed()...")
        self._event_.wait()
        self._event_.clear()
        if self.complete:
            return
        self.minibatch_class = TEST
        self.minibatch_valid_size = 1
        self.minibatch_data.data = torch.from_numpy(
            self._food_.reshape((1,) + self.sample_shape)).to(self.device)
        self.samples_served += 1

    def feed(self, obj):
        if obj is None:
            self.complete.set(True)
            self._event_.set()
            return
        if isinstance(obj, str):
            obj = self._load_file(obj)
        self._food_ = numpy.ascontiguousarray(obj, numpy.float32)
        self._event_.set()

    def _load_file(self, path):
        try:
            loaded = numpy.load(path)
        except ValueError:  # not an .npy/.npz: a text file
            return numpy.loadtxt(path, **self.loadtxt_kwargs)
        if hasattr(loaded, "files"):  # npz
            return loaded[loaded.files[0]]
        return loaded


class RESTfulAPI(Unit):
    """HTTP inference endpoint (reference ``RESTfulAPI``,
    ``restful_api.py:78-215``).

    Wiring: ``api.link_attrs(loader, "feed", "requests",
    "minibatch_valid_size")`` and ``api.results`` = the forward output
    (an Array or a tensor); place it after the last forward in the
    control loop. ``POST <path> {"input": ..., "codec": "list"|"base64"
    [, "shape": [...], "type": "float32"]}`` answers ``{"result": ...}``;
    400 for a malformed body, 413 past ``max_body`` bytes, 429 with
    Retry-After while the serving minibatch is full, 503 with
    Retry-After while not ready or when no tick answers within
    ``RESPONSE_TIMEOUT``; ``/healthz``, ``/readyz``, ``/metrics`` (the
    health bridge), ``/debug/`` and its four surfaces; each POST runs in
    a ``restful.request`` span that continues an ``X-Veles-Trace``
    header, and opens a request-ledger row (staged to resolved, with its
    outcome: this front has no slot waterfall)."""

    VIEW_GROUP = "SERVICE"
    #: handler threads give up after this long without a tick
    RESPONSE_TIMEOUT = 60.0

    def __init__(self, workflow, **kwargs):
        self.port = int(kwargs.pop("port", root.common.api.get("port",
                                                               8180)))
        self.path = kwargs.pop("path", root.common.api.get("path", "/api"))
        # loopback by default, as the generate front
        self.host = kwargs.pop("host",
                               root.common.api.get("host", "127.0.0.1"))
        if not self.path.startswith("/"):
            raise ValueError("path must start with '/'")
        self.max_body = int(kwargs.pop("max_body", 0)) or None
        super().__init__(workflow, **kwargs)
        self.results = None
        self.demand("feed", "requests")

    def init_unpickled(self):
        super().init_unpickled()
        self._httpd_ = None
        # trailing underscore: it holds a lock, so it is rebuilt on load
        self.health_ = ServingHealth(name="restful-api")

    @property
    def health(self):
        """The ``/healthz`` and ``/readyz`` registry."""
        return self.health_

    def initialize(self, **kwargs):
        from http.server import BaseHTTPRequestHandler
        from veles_tpu_torch.core.httpd import (MAX_BODY, BodyTooLarge,
                                                QuietHandlerMixin,
                                                enable_metrics, read_body,
                                                serve_debug_history,
                                                serve_debug_index,
                                                serve_debug_memory,
                                                serve_debug_requests,
                                                serve_debug_serve,
                                                serve_health, serve_metrics,
                                                start_server)

        api = self
        limit = self.max_body or MAX_BODY
        bridge(enable_metrics(self), self.health, publish_serving_health)

        class Handler(QuietHandlerMixin, BaseHTTPRequestHandler):
            def do_POST(self):
                if self.path != api.path:
                    self.send_error(404)
                    return
                try:
                    raw = read_body(self, limit=limit)
                except BodyTooLarge:
                    return  # 413 already sent, nothing buffered
                with get_tracer().span(
                        "restful.request",
                        parent=parse_trace_header(
                            self.headers.get(TRACE_HEADER))):
                    api.serve(self, raw)

            def do_GET(self):
                if serve_metrics(self) or serve_debug_requests(self) \
                        or serve_debug_history(self) \
                        or serve_debug_serve(self) \
                        or serve_debug_memory(self) \
                        or serve_debug_index(self):
                    return
                if not serve_health(self, api.health):
                    self.send_error(404)

        self._httpd_, self.port = start_server(
            Handler, self.host, self.port, name="restful-api")
        self.health.set_ready(True)
        self.info("listening on %s:%d%s", self.host, self.port, self.path)

    def stop(self):
        self.health.set_ready(False)
        if self._httpd_ is not None:
            self._httpd_.shutdown()
            self._httpd_.server_close()
            self._httpd_ = None
        release_history_sampler(self)

    # -- request side (handler threads) ---------------------------------------
    def _fail(self, handler, message):
        from veles_tpu_torch.core.httpd import reply
        self.warning(message)
        reply(handler, {"error": message}, code=400)

    def _decode(self, handler, payload):
        codec = payload.get("codec")
        if codec == "list":
            try:
                return numpy.asarray(payload["input"], numpy.float32)
            except (ValueError, TypeError) as exc:
                self._fail(handler, "invalid input array: %s" % exc)
                return None
        if codec != "base64":
            self._fail(handler, "codec must be 'list' or 'base64'")
            return None
        shape = payload.get("shape")
        dtype = payload.get("type")
        if not isinstance(shape, list) or not shape or dtype is None:
            self._fail(handler, "base64 codec needs 'shape' and 'type'")
            return None
        try:
            buf = base64.b64decode(payload["input"])
            return numpy.frombuffer(
                buf, numpy.dtype(dtype)).reshape(shape).astype(
                numpy.float32)
        except (ValueError, TypeError) as exc:
            self._fail(handler, "failed to decode: %s" % exc)
            return None

    def serve(self, handler, raw):
        from veles_tpu_torch.core.httpd import reply, retry_after_headers
        try:
            payload = json.loads(raw.decode())
        except ValueError:
            self._fail(handler, "failed to parse JSON")
            return
        if not isinstance(payload, dict) or "input" not in payload \
                or "codec" not in payload:
            self._fail(handler, "need 'input' and 'codec' attributes")
            return
        data = self._decode(handler, payload)
        if data is None:
            return
        # the request-truth row (``serving.py:665-711``): staged and
        # resolved stamps and an outcome
        ctx = current_context()
        ledger = get_request_ledger()
        row = ledger.stage(api=self.health.name,
                           trace=ctx[0] if ctx else None,
                           prompt_len=int(getattr(data, "size", 0)))
        # the same atomic admit/release pair as GenerateAPI, so the
        # /healthz inflight gauge and counters stay balanced (the queue
        # bound itself is the minibatch: feed overflows)
        if self.health.try_admit(None) is not None:
            ledger.resolve(row, "rejected", error="not ready")
            reply(handler, {"error": "not ready"}, code=503,
                  headers=retry_after_headers(self.health))
            return
        responder = {"event": threading.Event(), "result": None}
        try:
            self.feed(data, responder)
        except OverflowError:
            # the serving minibatch is full: shed with a retry hint
            # instead of queueing without bound
            self.health.reject_admitted()
            ledger.resolve(row, "rejected", error="saturated")
            reply(handler, {"error": "server saturated: retry"},
                  code=429, headers=retry_after_headers(self.health))
            return
        except (ValueError, TypeError) as exc:
            self.health.release("errors")
            ledger.resolve(row, "errors", error=str(exc))
            self._fail(handler, "invalid input: %s" % exc)
            return
        if not responder["event"].wait(self.RESPONSE_TIMEOUT):
            # a server-side stall is retryable: 503, never a 400
            self.health.release("expired")
            ledger.resolve(row, "expired", error="inference timed out")
            self.warning("inference timed out")
            reply(handler, {"error": "inference timed out"}, code=503,
                  headers=retry_after_headers(self.health))
            return
        self.health.release("completed")
        ledger.resolve(row, "completed")
        reply(handler, {"result": responder["result"]})

    # -- response side (workflow thread, after the forward tick) --------------
    def run(self):
        if self.results is None:
            return
        out = getattr(self.results, "data", self.results)
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        out = numpy.asarray(out)
        for i, responder in enumerate(self.requests):
            if responder is None:
                continue
            value = out[i]
            responder["result"] = (value.tolist()
                                   if isinstance(value, numpy.ndarray)
                                   else float(value))
            responder["event"].set()
