"""memscope: per-owner device-memory attribution, leak forensics and
headroom forecasting.

The port of ``veles_tpu/observe/memscope.py``. The device-memory gauge
only says how full the card is; memscope says WHO holds the bytes and
how long the KV pool lasts at the current admission rate.

- **Attribution.** Owning subsystems register weakly referenced
  byte-accountants under a named owner (:data:`OWNERS`): the decoder
  its ``params`` and ``decode_state``, the page pool its pages
  (``kv_pool``) and page shadows (``prefix_shadows``), ``GenerateAPI``
  its one-slot rollback stash (``param_stash``), the admission path its
  per-request ``admission_scratch`` tags. A collected instance drops out
  of the next sample; several live instances of one owner sum, which is
  how a retained pool stays visible. Published at scrape time as
  ``veles_hbm_bytes{owner=}`` / ``veles_hbm_fraction{owner=}`` and
  reconciled against the device total: on the card the caching
  allocator's ``allocated_bytes.all.current`` (never
  ``reserved_bytes``: freed blocks stay reserved in the cache, so a
  clean rebuild would read as a leak), without one the bytes of the
  tensors the decoders hold (``xla_stats._sample_device_memory``, one
  sampler shared with the gauges). ``owner="untagged"`` is the residue
  no accountant explains: on the card the kernels' split workspaces
  (``ops/_workspace.py``), cuBLAS's workspace and the caller's own
  tensors (the raw weights a front keeps for rebuilds), which belong to
  no owner of the JAX package's taxonomy. ``aot_executables`` is the
  bytes of the kernel libraries a live AOT bundle staged
  (``aot/loader.AotPrograms.footprint_bytes``): loaded code, not
  allocator bytes.

- **Leak forensics.** Lifecycle edges where an old subsystem must die
  (the breaker's rebuild, the weight hot-swap, the rollout's promotion)
  bracket themselves with
  :meth:`MemScope.edge_begin` / :meth:`MemScope.edge_end`. The end diff
  names any owner that grew by ``leak_min_bytes`` or more across the
  edge in a leak verdict (but the owners retained on purpose,
  :attr:`MemScope.LEAK_EXEMPT`; ``prefix_shadows`` among them, unlike
  the JAX package, whose first trip over a populated prefix cache names
  the shadows its own rebuild captures); :meth:`MemScope.flush_incidents` writes each
  verdict as a black box naming the owner.

- **Headroom forecasting.** :meth:`MemScope.note_pool` feeds pool
  occupancy points into a bounded ring (the governor's tick, ROADMAP A7
  (c)); :meth:`MemScope.headroom_forecast_s` fits the net used-pages
  slope over the trailing window: "the pool exhausts in ~X s at the
  current admission rate".

No locks anywhere: registration rebinds copy-on-write tuples, the edge
and forecast rings are bounded deques, scratch tags are single dict
operations. An accountant reads shapes only: no device sync.
"""

import collections
import time
import weakref

import torch

#: the owner taxonomy (the JAX package's): registration accepts any
#: name; these are the ones the subsystems use
OWNERS = ("params", "decode_state", "kv_pool", "prefix_shadows",
          "admission_scratch", "aot_executables", "param_stash",
          "optimizer_state")

#: the reconciliation residue: device total minus everything tagged
UNTAGGED = "untagged"

#: metric families every /metrics mount publishes at scrape time
HBM_BYTES = "veles_hbm_bytes"
HBM_FRACTION = "veles_hbm_fraction"
HEADROOM_GAUGE = "veles_headroom_forecast_s"
#: the control-plane series the forecast records into MetricHistory
HEADROOM_SERIES = "veles_ctrl_headroom_s"


def pytree_nbytes(tree):
    """Total bytes of the tensor (or array) leaves of ``tree``, a nest of
    dicts, lists and tuples; other leaves and a ``None`` tree count 0.
    The one sizing primitive every accountant shares."""
    if tree is None:
        return 0
    from veles_tpu_torch.device import tree_leaves_with_path
    total = 0
    for _, leaf in tree_leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
            continue
        nbytes = getattr(leaf, "nbytes", None)
        if isinstance(nbytes, int) and not isinstance(nbytes, bool):
            total += nbytes
    return total


class MemScope:
    """The per-owner HBM ledger (see module docstring)."""

    #: completed lifecycle-edge verdicts kept (newest last)
    EDGE_CAPACITY = 64
    #: lifecycle edges allowed open at once (retrying rebuilds stack
    #: a begin per attempt; the matching end pairs with the newest)
    OPEN_EDGES = 8
    #: pool occupancy points feeding the headroom forecast
    FORECAST_POINTS = 256
    #: owners whose growth across a lifecycle edge is DELIBERATE
    #: retention, never a leak verdict: the hot-swap seam stashes the
    #: replaced params for rollback by design, and admission scratch
    #: tracks the staged queue — both are tagged precisely so the
    #: diff can ignore them and still flag bytes nobody accounts for.
    #: On purpose unlike the JAX package, ``prefix_shadows`` too: the
    #: breaker's rebuild captures them inside its own edge as the
    #: payload it restores the prefix cache from (host copies, bounded
    #: by the cache's entries), so the first trip over a cache past
    #: ``leak_min_bytes`` would otherwise name them as its leak
    LEAK_EXEMPT = ("param_stash", "admission_scratch", "prefix_shadows")

    def __init__(self, leak_min_bytes=None, limit_bytes=None):
        if leak_min_bytes is None or limit_bytes is None:
            try:
                from veles_tpu_torch.core.config import root
                cfg = root.common.observe.memscope
                if leak_min_bytes is None:
                    leak_min_bytes = cfg.get("leak_min_bytes", 1 << 20)
                if limit_bytes is None:
                    limit_bytes = cfg.get("limit_bytes", None)
            except Exception:
                pass
        self.enabled = True
        #: owner -> tuple of (weakref to the owning instance, sizing
        #: fn) pairs. Copy-on-write: register() rebinds a fresh tuple,
        #: so attribution always iterates a stable snapshot without a
        #: lock. Several live instances per owner sum (the zombie-pool
        #: visibility contract).
        self._accountants = {}
        #: admission-scratch tags: key -> bytes (handler threads set,
        #: the driver's resolve pops — both single GIL-atomic dict ops)
        self._scratch = {}
        #: minimum single-owner growth across a lifecycle edge that
        #: constitutes a leak verdict
        self.leak_min_bytes = int(leak_min_bytes
                                  if leak_min_bytes is not None
                                  else 1 << 20)
        #: operator byte budget for backends with no allocator limit
        #: (root.common.observe.memscope.limit_bytes): the CPU
        #: denominator of :meth:`device_fraction` — without it the
        #: governor's memory guard stays silent rather than guessing
        self.limit_bytes = (int(limit_bytes) if limit_bytes else None)
        #: (edge name, monotonic, attribution) stack of begun edges
        self._open_edges = collections.deque(maxlen=self.OPEN_EDGES)
        #: every completed edge diff, leak or not (newest last)
        self.edges = collections.deque(maxlen=self.EDGE_CAPACITY)
        #: leak verdicts awaiting their incident artifact
        self._pending_leaks = collections.deque(
            maxlen=self.EDGE_CAPACITY)
        #: verdicts whose artifact was written (newest last)
        self.incidents = collections.deque(maxlen=self.EDGE_CAPACITY)
        #: (monotonic, used_pages, free_pages) forecast ring
        self._pool_points = collections.deque(
            maxlen=self.FORECAST_POINTS)
        #: best-effort tallies (single-writer driver thread)
        self.leaks_total = 0
        self.edges_total = 0

    # -- attribution (scrape-time) ----------------------------------------
    def register(self, owner, obj, fn):
        """Register ``fn(obj) -> bytes`` as an accountant for
        ``owner``. ``obj`` is weakly referenced — a collected instance
        drops out of the next sample on its own (GC is the
        unregister). Re-registering the same instance replaces its
        entry; DIFFERENT live instances stack, and attribution sums
        them."""
        entries = []
        for ref, sizer in self._accountants.get(owner, ()):
            existing = ref()
            if existing is None or existing is obj:
                continue
            entries.append((ref, sizer))
        entries.append((weakref.ref(obj), fn))
        self._accountants[owner] = tuple(entries)

    def attribute(self):
        """``{owner: live bytes}`` — calls every registered accountant
        against its live instance; dead instances and raising
        accountants contribute nothing (an attribution must never take
        the caller down)."""
        out = {}
        for owner, entries in list(self._accountants.items()):
            total = 0
            for ref, sizer in entries:
                obj = ref()
                if obj is None:
                    continue
                try:
                    total += int(sizer(obj))
                except Exception:
                    continue
            out[owner] = total
        scratch = sum(self._scratch.values())
        if scratch:
            out["admission_scratch"] = (
                out.get("admission_scratch", 0) + scratch)
        return out

    # -- admission scratch tags (record path) -----------------------------
    def scratch_note(self, key, nbytes):
        """Tag ``nbytes`` of admission scratch under ``key`` (one
        GIL-atomic dict set; the admission handler calls this when a
        request stages)."""
        if not self.enabled:
            return
        self._scratch[key] = int(nbytes)

    def scratch_drop(self, key):
        """Release a scratch tag (one GIL-atomic dict pop; the
        driver's resolve path calls this exactly once per request)."""
        if key is None:
            return
        self._scratch.pop(key, None)

    # -- reconciliation ----------------------------------------------------
    @staticmethod
    def device_totals():
        """``(used_bytes, limit_bytes_or_None)`` summed over the local
        devices — ``bytes_in_use`` where the allocator reports, the
        live-buffer fallback on CPU. One sampler
        (``xla_stats._sample_device_memory``) shared with the gauges,
        the dashboard summary and the governor's memory guard."""
        from veles_tpu_torch.observe.xla_stats import _sample_device_memory
        used = 0
        limit = 0
        try:
            samples = _sample_device_memory()
        except Exception:
            samples = {}
        for stats in samples.values():
            in_use = stats.get("bytes_in_use")
            if in_use is not None:
                used += int(in_use)
            else:
                used += int(stats.get("live_bytes", 0) or 0)
            if stats.get("bytes_limit"):
                limit += int(stats["bytes_limit"])
        return used, (limit or None)

    def snapshot(self):
        """The reconciled attribution: per-owner bytes including the
        ``untagged`` residue, the device total/limit, and the untagged
        fraction. The contract tests pin:
        ``sum(owners.values()) >= device_bytes`` with
        ``owners["untagged"] == max(0, device_bytes - tagged)`` —
        residue exported, never hidden."""
        owners = self.attribute()
        total, limit = self.device_totals()
        if limit is None:
            limit = self.limit_bytes
        tagged = sum(owners.values())
        owners[UNTAGGED] = max(0, total - tagged)
        return {
            "owners": owners,
            "tagged_bytes": tagged,
            "device_bytes": total,
            "limit_bytes": limit,
            "untagged_fraction": (round(owners[UNTAGGED] / total, 6)
                                  if total else 0.0),
        }

    def device_fraction(self):
        """Reconciled device total / byte limit — the governor's
        memory-guard input on EVERY backend: the allocator limit when
        one is reported, else the configured ``limit_bytes`` budget;
        ``None`` when neither exists (the guard stays silent rather
        than guessing a denominator)."""
        total, limit = self.device_totals()
        if not limit:
            limit = self.limit_bytes
        if not limit:
            return None
        return total / limit

    # -- lifecycle-edge leak forensics ------------------------------------
    def edge_begin(self, edge):
        """Record-path lifecycle hook: snapshot per-owner bytes BEFORE
        a rebuild/swap/promotion replaces a subsystem. One GIL-atomic
        deque append; the attribution is plain accountant calls — no
        locks here, no I/O, no registry traffic."""
        if not self.enabled:
            return
        self._open_edges.append(
            (edge, time.monotonic(), self.attribute()))

    def edge_end(self, edge, gc_collect=False):
        """Record-path lifecycle hook: diff per-owner bytes against
        the NEWEST matching :meth:`edge_begin`. Appends the verdict
        row to :attr:`edges`; an owner grown by >=
        ``leak_min_bytes`` additionally queues a leak verdict for
        :meth:`flush_incidents` (the artifact write stays OFF this
        hook). ``gc_collect=True`` (the rebuild seam's cold path runs
        seconds of compile anyway) collects cycles first so "freed"
        means freed before the diff blames an owner for garbage the
        next GC pass would reclaim. Returns the verdict row, or
        ``None`` without a matching begin."""
        if not self.enabled:
            return None
        before = None
        for entry in reversed(tuple(self._open_edges)):
            if entry[0] == edge:
                before = entry
                try:
                    self._open_edges.remove(entry)
                except ValueError:
                    pass
                break
        if before is None:
            return None
        if gc_collect:
            import gc
            gc.collect()
        after = self.attribute()
        grown = {}
        for owner, now_bytes in after.items():
            delta = now_bytes - before[2].get(owner, 0)
            if delta >= self.leak_min_bytes:
                grown[owner] = delta
        suspects = {owner: delta for owner, delta in grown.items()
                    if owner not in self.LEAK_EXEMPT}
        leak_owner = (max(suspects, key=suspects.get)
                      if suspects else None)
        verdict = {
            "edge": edge,
            "t": time.time(),
            "span_s": round(time.monotonic() - before[1], 3),
            "before": before[2],
            "after": after,
            "grown": grown,
            "leak": leak_owner is not None,
            "owner": leak_owner,
            "grew_bytes": grown.get(leak_owner, 0),
        }
        self.edges.append(verdict)
        self.edges_total += 1
        if leak_owner is not None:
            self.leaks_total += 1
            self._pending_leaks.append(verdict)
        return verdict

    def flush_incidents(self):
        """Write the incident artifact for every pending leak verdict:
        a flight-recorder black box whose reason and ``extra`` name
        the grown owner. OFF the
        record path — called at scrape time and from the rebuild
        seam's cold path. Returns the paths written."""
        wrote = []
        while True:
            try:
                verdict = self._pending_leaks.popleft()
            except IndexError:
                break
            path = None
            try:
                from veles_tpu_torch.observe.flight import get_flight_recorder
                flight = get_flight_recorder()
                flight.note("memscope.leak", edge=verdict["edge"],
                            owner=verdict["owner"],
                            grew_bytes=verdict["grew_bytes"])
                path = flight.dump(
                    "memscope_leak_%s" % verdict["owner"],
                    extra={"memscope_leak": verdict})
            except Exception:
                path = None
            verdict["artifact"] = path
            self.incidents.append(verdict)
            if path:
                wrote.append(path)
        return wrote

    # -- headroom forecasting ---------------------------------------------
    def note_pool(self, pool):
        """Feed one pool occupancy point into the forecast ring (one
        GIL-atomic append). The serving governor's tick calls it
        (``observe/governor.py``), where it reads the pool anyway."""
        if not self.enabled or pool is None:
            return
        try:
            used = pool.used_pages
            free = pool.free_pages
        except Exception:
            return
        self._pool_points.append((time.monotonic(), used, free))

    def headroom_forecast_s(self, window_s=60.0, now=None):
        """Seconds until the pool's free list empties at the current
        net admission rate: ``free_pages / used-pages slope`` over the
        trailing window. ``None`` when usage is flat or shrinking (no
        exhaustion on trend) or with fewer than two points. The
        pool's own release-rate window counts FREES only (it prices
        Retry-After); this slope is net — admissions minus frees —
        which is what actually empties the free list."""
        now = time.monotonic() if now is None else now
        points = [p for p in tuple(self._pool_points)
                  if now - p[0] <= window_s]
        if len(points) < 2:
            return None
        t_first, used_first, _ = points[0]
        t_last, used_last, free_last = points[-1]
        span = t_last - t_first
        if span <= 0:
            return None
        slope = (used_last - used_first) / span
        if slope <= 0:
            return None
        return free_last / slope

    # -- publication (scrape-time collector) ------------------------------
    def publish(self, registry, history=None):
        """Publish the reconciled attribution on ``registry`` —
        ``veles_hbm_bytes{owner=}`` / ``veles_hbm_fraction{owner=}``
        as whole-family replacements (an owner that stopped reporting
        retires instead of freezing), the headroom gauge, and the
        control-plane headroom series into MetricHistory — then flush
        any pending leak artifacts. Scrape-time only: the record path
        never touches the registry."""
        snap = self.snapshot()
        total = snap["device_bytes"]
        byte_rows = []
        frac_rows = []
        for owner in sorted(snap["owners"]):
            nbytes = snap["owners"][owner]
            byte_rows.append(({"owner": owner}, nbytes))
            if total:
                frac_rows.append(
                    ({"owner": owner}, round(nbytes / total, 6)))
        registry.set_gauge_family(
            HBM_BYTES, byte_rows,
            help="per-owner HBM attribution, reconciled against the "
                 "device total (owner=untagged is the residue)")
        if frac_rows:
            registry.set_gauge_family(
                HBM_FRACTION, frac_rows,
                help="per-owner share of the device memory total")
        forecast = self.headroom_forecast_s()
        if forecast is not None:
            registry.set(
                HEADROOM_GAUGE, round(forecast, 3),
                help="seconds until the KV pool exhausts at the "
                     "current net admission rate")
            if history is None:
                from veles_tpu_torch.observe.history import get_metric_history
                history = get_metric_history()
            if history is not None:
                try:
                    history.record_control(HEADROOM_SERIES,
                                           float(forecast))
                except Exception:
                    pass
        self.flush_incidents()
        return snap

    # -- dashboard / debug payloads ---------------------------------------
    def summary(self, top=3):
        """The compact health-snapshot cell: top tagged owners, the
        headroom forecast and the leak tally. Deliberately SKIPS the
        device reconciliation (live-buffer scans are too heavy for
        every /healthz poll) — the full reconciled view lives on
        /metrics and /debug/memory."""
        owners = self.attribute()
        ranked = sorted(((o, b) for o, b in owners.items() if b > 0),
                        key=lambda item: item[1], reverse=True)
        forecast = self.headroom_forecast_s()
        out = {
            "tagged_bytes": sum(owners.values()),
            "owners": dict(ranked[:top]),
            "headroom_s": (round(forecast, 1)
                           if forecast is not None else None),
            "leaks": self.leaks_total,
        }
        if ranked:
            out["top_owner"] = ranked[0][0]
        last_leak = next((edge for edge in reversed(self.edges)
                          if edge["leak"]), None)
        if last_leak is not None:
            out["last_leak_owner"] = last_leak["owner"]
            out["last_leak_edge"] = last_leak["edge"]
        return out

    def debug_snapshot(self, edges=16):
        """The ``/debug/memory`` payload: the full reconciled
        snapshot, the forecast, the trailing edge verdicts and the
        incident artifact paths."""
        snap = self.snapshot()
        forecast = self.headroom_forecast_s()
        return {
            "memscope": snap,
            "headroom_forecast_s": (round(forecast, 3)
                                    if forecast is not None else None),
            "edges": list(self.edges)[-max(0, int(edges)):],
            "incidents": [v.get("artifact") for v in self.incidents
                          if v.get("artifact")],
            "leaks_total": self.leaks_total,
            "edges_total": self.edges_total,
        }


_memscope = MemScope()


def get_memscope():
    """The process-global scope (the singleton every subsystem
    registers against)."""
    return _memscope


def set_memscope(scope):
    """Swap the process-global scope (test/bench isolation); returns
    the previous one. ``None`` installs a fresh default."""
    global _memscope
    previous = _memscope
    _memscope = scope if scope is not None else MemScope()
    return previous


def publish_memscope(registry):
    """Collector body for the device-truth plane
    (``xla_stats.publish_xla_stats``): publish the process scope."""
    get_memscope().publish(registry)
