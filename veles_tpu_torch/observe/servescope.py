"""Serving goodput observatory: occupancy timelines, token-waste autopsy.

The port of ``veles_tpu/observe/servescope.py``: what fraction of the
card's serving time and of the dispatched tokens was useful.

- :class:`ServeScope`: a bounded, lock-free per-dispatch accounting ring
  fed by ``serving.ContinuousDecoder`` (slab and pool): every admission,
  dispatch and collect books its program key (bucket, group, span,
  pages), its live against padded rows, its span-tile overshoot or the
  paged kernels' last-page residual, and its dead-slot lane-steps; the
  driver books its queue-empty idle. From these it splits serving WALL
  into prefill compute, decode compute, host and idle (each on the
  host's clock: a dispatch's "compute" is the time its enqueue held the
  driver) and dispatched WORK into useful tokens and waste by cause
  (:data:`WASTE_CAUSES`).
- metrics: ``veles_serve_goodput_fraction``,
  ``veles_serve_goodput_seconds_total{component=}``,
  ``veles_serve_token_waste_total{cause=}``,
  ``veles_serve_tokens_useful_total{phase=}``, and the
  ``veles_serve_slot_occupancy`` / ``veles_serve_waste_share`` gauges on
  every ``/metrics`` mount (:func:`ensure_serve_registered`), so the
  history sampler records them as trends.
- anomaly rules: :func:`ensure_serve_rules` books the detector-owned
  ``serve_waste`` and ``serve_occupancy`` rules;
  :meth:`ServeScope.autopsy_tick` (run by the ``GenerateAPI`` driver off
  the record path) evaluates them over token deltas and lands a
  cooldown-limited incident naming the dominant waste cause.
- the slot timeline: per-slot occupancy entries merged with the request
  ledger's rows into a Perfetto-loadable Chrome trace (``python -m
  veles_tpu_torch observe serve-trace [ARTIFACT | --live URL]``, ``GET
  /debug/serve``): one row per slot.

What the port books, on purpose unlike the JAX package: the paged pool
always attends through K1 or K3, which walk only each slot's live pages,
so a paged dispatch books ``tile_pad`` (the JAX package's
``paged_kernel=True`` route) and never ``page_overshoot``; and the
port's admissions add no power-of-two duplicate rows, so ``group_dup``
is 0 on every engine (the JAX slab pads its groups and books it).

Record-path discipline: every ``note_*`` method and
:meth:`ServeScope.inject_waste` run on the serving driver's thread
between enqueues: no lock, no I/O, no device sync, GIL-atomic container
ops, bounded memory. Everything that can write an incident lives in
:meth:`ServeScope.autopsy_tick`.

Units: ``bucket_pad``, ``group_dup``, ``dead_slot`` and ``discard``
count token-steps (prompt positions, decode lane-steps);
``span_overshoot``, ``page_overshoot`` and ``tile_pad`` count masked
attended positions: one decomposition of dispatched work, not a
FLOP-exact model.
"""

import collections
import json
import os
import time

#: per-dispatch accounting ring capacity (drop-oldest)
DISPATCH_RING_CAPACITY = 1024

#: completed slot-occupancy entries kept (drop-oldest)
SLOT_RING_CAPACITY = 1024

#: open (admitted, not yet retired) occupancy entries hard cap — a
#: tripped decoder's stragglers must not grow the map forever
OPEN_SLOT_CAP = 4096

#: the waste-cause catalog:
#: - bucket_pad: prompt right-padding to the power-of-two bucket
#: - group_dup: duplicate rows padding admission groups to pow2 size
#: - span_overshoot: attended positions past each live slot's sequence
#:   (the dense span tile)
#: - page_overshoot: gathered page positions past each live slot's
#:   sequence (the paged PB bucket; dead lanes append to scratch)
#: - dead_slot: inactive lanes advanced through decode dispatches
#: - discard: live-lane tokens computed but never delivered (lag-1
#:   retirement tails, budget clamp, post-eos)
#: - tile_pad: dead lanes of each live slot's LAST partial page on the
#:   fused-kernel path (ops/paged_attention.py) — the kernel attends
#:   live pages only, so span/page overshoot is structurally zero and
#:   the residual books here instead of mis-crediting zero work done
WASTE_CAUSES = ("bucket_pad", "group_dup", "span_overshoot",
                "page_overshoot", "dead_slot", "discard", "tile_pad")

#: wall components the serving seconds decompose into
WALL_COMPONENTS = ("prefill_compute", "decode_compute", "host", "idle")

#: the serve_waste anomaly rule's threshold: more than half the tokens
#: dispatched inside an evaluation window were waste
WASTE_SHARE_BREACH = 0.5

#: the serve_occupancy rule's threshold: under a quarter of the decode
#: lane-steps inside an evaluation window carried a live request
OCCUPANCY_BREACH = 0.25

#: consecutive breaching evaluations before each rule fires
WASTE_FOR_SAMPLES = 2
OCCUPANCY_FOR_SAMPLES = 3

#: minimum dispatched tokens per autopsy evaluation window: below it
#: the tick returns WITHOUT consuming the anchors (the trickle
#: accumulates until judgeable) — a lightly-loaded toy server's
#: organic dead-slot/overshoot waste on a handful of tokens must not
#: page an incident (found by the verify drive: one 3-token request
#: landed a serve_waste artifact)
MIN_EVAL_TOKENS = 256

#: /debug/serve payload schema version
SERVE_TRACE_SCHEMA = 1


class ServeScope:
    """The per-process serving goodput observatory (module docstring).

    One instance (:func:`get_serve_scope`) is fed by every
    ``serving.ContinuousDecoder`` in the process:
    breaker rebuilds keep accounting into the same scope (rids carry
    over, so the occupancy map never cross-talks). All ``note_*``
    methods are record path: one enabled check plus GIL-atomic
    container ops, bounded memory, no I/O."""

    def __init__(self):
        self.enabled = True
        #: wall decomposition (cumulative seconds)
        self.seconds = {key: 0.0 for key in WALL_COMPONENTS}
        #: useful dispatched tokens by phase
        self.useful = {"prefill": 0, "decode": 0}
        #: wasted dispatched tokens by cause
        self.waste = {cause: 0 for cause in WASTE_CAUSES}
        #: decode lane-step occupancy (live vs total across dispatches)
        self.live_lane_steps = 0
        self.total_lane_steps = 0
        self.admits = 0
        self.dispatches = 0
        self.collects = 0
        self.injected = 0
        self._last_mark = None
        #: per-dispatch ring: admit/dispatch/inject rows, drop-oldest
        self._ring = collections.deque(maxlen=DISPATCH_RING_CAPACITY)
        #: rid -> open occupancy entry; bounded drop-oldest
        self._open = {}
        #: completed occupancy entries, drop-oldest
        self._slots = collections.deque(maxlen=SLOT_RING_CAPACITY)
        #: autopsy evaluation anchors (token deltas between ticks)
        self._eval_useful = 0
        self._eval_waste = 0
        self._eval_by_cause = dict(self.waste)
        self._eval_live = 0
        self._eval_total = 0
        #: per-cause waste accumulated across the CURRENT waste-rule
        #: breach streak — what the incident names as dominant
        self._breach_by_cause = {}

    # -- wall accounting helpers (record path) ----------------------------
    def _mark(self, now, elapsed, component):
        """Book ``elapsed`` seconds ending at ``now`` into
        ``component`` and the gap since the previous mark into host
        time (the dispatch→collect / collect→dispatch bookkeeping
        wall the driver spends between device-facing calls)."""
        start = now - elapsed
        if self._last_mark is not None:
            gap = start - self._last_mark
            if gap > 0:
                self.seconds["host"] += gap
        self.seconds[component] += elapsed
        self._last_mark = now

    def note_idle(self, waited, now=None):
        """The driver's queue-empty wait (record path): ``waited``
        seconds of idle ending at ``now``."""
        if not self.enabled:
            return
        if now is None:
            now = time.monotonic()
        waited = max(0.0, float(waited))
        start = now - waited
        if self._last_mark is not None:
            gap = start - self._last_mark
            if gap > 0:
                self.seconds["host"] += gap
        self.seconds["idle"] += waited
        self._last_mark = now

    # -- dispatch accounting (record path) --------------------------------
    def note_admit(self, kind, bucket, group, rows, live_tokens,
                   pad_tokens, dup_tokens, elapsed, now=None, pages=0):
        """One admission dispatch: ``group`` live requests padded to
        ``rows`` rows of ``bucket`` positions; ``live_tokens`` real
        prompt/tail positions, ``pad_tokens`` bucket right-padding,
        ``dup_tokens`` duplicate-row positions (record path)."""
        if not self.enabled:
            return
        if now is None:
            now = time.monotonic()
        self._mark(now, float(elapsed), "prefill_compute")
        self.admits += 1
        self.useful["prefill"] += int(live_tokens)
        self.waste["bucket_pad"] += int(pad_tokens)
        self.waste["group_dup"] += int(dup_tokens)
        self._ring.append(["admit", str(kind), int(bucket), int(group),
                           int(rows), int(pages), int(live_tokens),
                           int(pad_tokens) + int(dup_tokens),
                           round(float(elapsed) * 1e3, 3), now])

    def note_dispatch(self, chunk, slots, active, overshoot, elapsed,
                      now=None, paged=False, span=0, pages=0,
                      kernel=False):
        """One decode dispatch of ``chunk`` steps over ``slots`` lanes
        (``active`` live): books dead-slot lane-steps, the span/page
        overshoot positions — or, on the fused-kernel path
        (``kernel=True``), the last-partial-page ``tile_pad`` residual
        — and the lane-step occupancy numerators (record path)."""
        if not self.enabled:
            return
        if now is None:
            now = time.monotonic()
        self._mark(now, float(elapsed), "decode_compute")
        self.dispatches += 1
        chunk = int(chunk)
        active = int(active)
        slots = int(slots)
        dead = max(0, slots - active) * chunk
        self.waste["dead_slot"] += dead
        self.waste["tile_pad" if kernel
                   else "page_overshoot" if paged
                   else "span_overshoot"] += int(overshoot)
        self.total_lane_steps += slots * chunk
        self.live_lane_steps += active * chunk
        self._ring.append(["dispatch",
                           "kernel" if kernel
                           else "paged" if paged else "dense",
                           chunk, slots, active,
                           int(pages) if paged else int(span),
                           int(overshoot), dead,
                           round(float(elapsed) * 1e3, 3), now])

    def note_collect(self, live_steps, kept, elapsed, now=None):
        """One chunk readback: ``live_steps`` lane-steps were
        dispatched live, ``kept`` tokens were delivered — the rest is
        ``discard`` waste (record path)."""
        if not self.enabled:
            return
        if now is None:
            now = time.monotonic()
        self._mark(now, float(elapsed), "decode_compute")
        self.collects += 1
        self.useful["decode"] += int(kept)
        self.waste["discard"] += max(0, int(live_steps) - int(kept))

    def inject_waste(self, cause, tokens, now=None):
        """The chaos seam (the waste profile, ``serving_chaos.py``): book
        ``tokens`` of synthetic ``cause`` waste — the compile-storm
        injection idiom pointed at the waste plane, so a seeded
        profile deterministically dominates the decomposition (record
        path)."""
        if not self.enabled or cause not in self.waste:
            return
        if now is None:
            now = time.monotonic()
        self.waste[cause] += int(tokens)
        self.injected += 1
        self._ring.append(["inject", str(cause), int(tokens), 0, 0, 0,
                           0, int(tokens), 0.0, now])

    # -- slot occupancy timeline (record path) ----------------------------
    def note_slot_admit(self, slot, rid, kind, now=None, bucket=0,
                        trace=None):
        """Request ``rid`` occupied ``slot`` via a ``kind`` admission;
        ``trace`` is the request's (trace_id, span_id) context when
        tracing is on (record path)."""
        if not self.enabled:
            return
        if now is None:
            now = time.monotonic()
        if len(self._open) >= OPEN_SLOT_CAP:
            self._open.pop(next(iter(self._open)), None)
        trace_id, span_id = (trace if isinstance(trace, tuple)
                             and len(trace) == 2 else (None, None))
        self._open[rid] = {"slot": int(slot), "rid": int(rid),
                           "kind": str(kind), "bucket": int(bucket),
                           "admit": now, "first": None, "retire": None,
                           "reason": None, "trace": trace_id,
                           "span": span_id}

    def note_slot_first(self, rid, now=None):
        """Request ``rid`` delivered its first token (record path)."""
        if not self.enabled:
            return
        entry = self._open.get(rid)
        if entry is not None and entry["first"] is None:
            entry["first"] = now if now is not None \
                else time.monotonic()

    def note_slot_retire(self, rid, now=None, reason="done"):
        """Request ``rid`` left its slot (completed / cancelled); the
        entry moves to the bounded completed ring (record path)."""
        if not self.enabled:
            return
        entry = self._open.pop(rid, None)
        if entry is None:
            return
        entry["retire"] = now if now is not None else time.monotonic()
        entry["reason"] = str(reason)
        self._slots.append(entry)

    # -- views ------------------------------------------------------------
    def goodput_summary(self):
        """The two-plane decomposition: useful/waste token fraction +
        the cumulative wall-component seconds."""
        useful = sum(self.useful.values())
        waste = sum(self.waste.values())
        total = useful + waste
        return {
            "fraction": round(useful / total, 4) if total else 1.0,
            "useful_tokens": useful,
            "waste_tokens": waste,
            "useful": dict(self.useful),
            "admits": self.admits,
            "dispatches": self.dispatches,
            "seconds": {key: round(value, 4)
                        for key, value in self.seconds.items()},
        }

    def waste_share(self):
        """Cumulative wasted share of dispatched tokens (None before
        any traffic)."""
        useful = sum(self.useful.values())
        waste = sum(self.waste.values())
        total = useful + waste
        return round(waste / total, 4) if total else None

    def occupancy(self):
        """Cumulative decode lane-step occupancy."""
        total = self.total_lane_steps
        return {
            "fraction": (round(self.live_lane_steps / total, 4)
                         if total else None),
            "live_lane_steps": self.live_lane_steps,
            "total_lane_steps": total,
        }

    def dominant_cause(self):
        """The waste cause holding the most tokens, or None."""
        worst = max(self.waste.items(), key=lambda kv: kv[1])
        return worst[0] if worst[1] > 0 else None

    def summary(self):
        """The compact /healthz + web-status cell payload
        (``ServingHealth.attach_servescope``), or None before any
        traffic."""
        if not (self.admits or self.dispatches or self.injected):
            return None
        out = {"goodput": self.goodput_summary()["fraction"],
               "occupancy": self.occupancy()["fraction"],
               "waste_share": self.waste_share()}
        cause = self.dominant_cause()
        if cause is not None:
            out["dominant_cause"] = cause
        return out

    def slot_rows(self):
        """Completed + still-open occupancy entries (dict copies)."""
        rows = [dict(entry) for entry in list(self._slots)]
        rows.extend(dict(entry) for entry in list(self._open.values()))
        return rows

    def debug_snapshot(self, ledger=None, slowest=16, ring_tail=256):
        """The ``GET /debug/serve`` payload: decomposition + waste
        catalog + the slot timeline merged with the request-ledger
        rows — what ``observe serve-trace`` assembles."""
        payload = {
            "kind": "servescope",
            "schema": SERVE_TRACE_SCHEMA,
            "pid": os.getpid(),
            "now_mono": time.monotonic(),
            "goodput": self.goodput_summary(),
            "waste": dict(self.waste),
            "occupancy": self.occupancy(),
            "dominant_cause": self.dominant_cause(),
            "slots": self.slot_rows(),
            "dispatches": [list(row)
                           for row in list(self._ring)[-ring_tail:]],
        }
        if ledger is not None:
            payload["requests"] = ledger.debug_snapshot(slowest=slowest)
        return payload

    def reset(self):
        """Drop everything (test/bench isolation)."""
        self.seconds = {key: 0.0 for key in WALL_COMPONENTS}
        self.useful = {"prefill": 0, "decode": 0}
        self.waste = {cause: 0 for cause in WASTE_CAUSES}
        self.live_lane_steps = 0
        self.total_lane_steps = 0
        self.admits = 0
        self.dispatches = 0
        self.collects = 0
        self.injected = 0
        self._last_mark = None
        self._ring.clear()
        self._open.clear()
        self._slots.clear()
        self._eval_useful = 0
        self._eval_waste = 0
        self._eval_by_cause = dict(self.waste)
        self._eval_live = 0
        self._eval_total = 0
        self._breach_by_cause = {}

    # -- anomaly autopsy (driver thread, NOT record path) -----------------
    def autopsy_tick(self, history, now=None):
        """The per-drive-pass follow-up the GenerateAPI driver runs
        OFF the record path: feed the goodput/waste/occupancy trend
        series into ``history`` (``record_control``), evaluate the
        detector-owned ``serve_waste`` / ``serve_occupancy`` rules
        over the token deltas since the previous evaluation
        (deterministic in dispatch counts, not wall time), and land a
        cooldown-limited incident artifact naming the DOMINANT waste
        cause of the breach window. Returns the incident path or
        None."""
        if history is None:
            return None
        if now is None:
            now = time.monotonic()
        useful = sum(self.useful.values())
        waste_total = sum(self.waste.values())
        moved = (useful + waste_total) \
            - (self._eval_useful + self._eval_waste)
        if moved < MIN_EVAL_TOKENS:
            # not enough dispatched work to judge a share: leave the
            # anchors in place so the trickle accumulates into the
            # next evaluation instead of paging on a toy window
            return None
        waste_rule, occupancy_rule = ensure_serve_rules(history)
        waste_delta = waste_total - self._eval_waste
        share = waste_delta / moved
        by_cause_delta = {
            cause: self.waste[cause] - self._eval_by_cause.get(cause, 0)
            for cause in self.waste}
        live_delta = self.live_lane_steps - self._eval_live
        total_delta = self.total_lane_steps - self._eval_total
        occupancy = (live_delta / total_delta) if total_delta > 0 \
            else None
        self._eval_useful = useful
        self._eval_waste = waste_total
        self._eval_by_cause = dict(self.waste)
        self._eval_live = self.live_lane_steps
        self._eval_total = self.total_lane_steps
        goodput = self.goodput_summary()
        # trend feed: the cumulative fraction matches the registry
        # gauge's semantics, so both writers land the same numbers in
        # one series; the WINDOWED share/occupancy go under the
        # governor's veles_ctrl_ control-feed naming — recording them
        # under the gauge names would interleave windowed and
        # cumulative points into one sawtoothing history series
        history.record_control("veles_serve_goodput_fraction",
                               goodput["fraction"], now=now)
        history.record_control("veles_ctrl_serve_waste_share", share,
                               now=now)
        if occupancy is not None:
            history.record_control("veles_ctrl_serve_occupancy",
                                   occupancy, now=now)
        # -- serve_waste rule state (detector-owned) --
        waste_rule.last_value = share
        if share >= waste_rule.threshold:
            waste_rule.streak += 1
            if waste_rule.breach_since is None:
                waste_rule.breach_since = now
                self._breach_by_cause = {}
            for cause, delta in by_cause_delta.items():
                if delta > 0:
                    self._breach_by_cause[cause] = \
                        self._breach_by_cause.get(cause, 0) + delta
            if waste_rule.breach_value is None \
                    or share > waste_rule.breach_value:
                waste_rule.breach_value = share
        else:
            waste_rule.streak = 0
            waste_rule.breach_since = None
            waste_rule.breach_value = None
            waste_rule.breach_labels = None
            self._breach_by_cause = {}
        # -- serve_occupancy rule state --
        if occupancy is not None:
            occupancy_rule.last_value = occupancy
            if occupancy <= occupancy_rule.threshold:
                occupancy_rule.streak += 1
                if occupancy_rule.breach_since is None:
                    occupancy_rule.breach_since = now
                if occupancy_rule.breach_value is None \
                        or occupancy < occupancy_rule.breach_value:
                    occupancy_rule.breach_value = occupancy
            else:
                occupancy_rule.streak = 0
                occupancy_rule.breach_since = None
                occupancy_rule.breach_value = None
        # -- firings (at most one incident per tick) --
        dominant = None
        if self._breach_by_cause:
            dominant = max(self._breach_by_cause.items(),
                           key=lambda kv: kv[1])[0]
            waste_rule.breach_labels = (("cause", dominant),)
        candidates = []
        if waste_rule.streak >= waste_rule.for_samples:
            candidates.append((waste_rule, share,
                               [["cause", dominant]] if dominant
                               else []))
        if occupancy is not None \
                and occupancy_rule.streak >= occupancy_rule.for_samples:
            # the None guard matters: a dispatch-free window (admit
            # traffic only) leaves a completed streak from earlier
            # windows standing, and firing it would format a None
            # value
            candidates.append((occupancy_rule, occupancy, []))
        for rule, value, labels in candidates:
            if rule.last_fired is not None \
                    and now - rule.last_fired < rule.cooldown_s:
                continue
            rule.last_fired = now
            rule.fired_total += 1
            firing = {"rule": rule.name, "series": rule.series,
                      "kind": rule.kind,
                      "value": round(float(value), 6),
                      "labels": labels,
                      "breach_since": rule.breach_since, "mono": now,
                      "dominant_cause": dominant,
                      "waste": dict(self.waste),
                      "waste_window": {
                          cause: tokens for cause, tokens
                          in self._breach_by_cause.items()},
                      "goodput": goodput,
                      "occupancy": occupancy}
            history.anomalies_total += 1
            try:
                from veles_tpu_torch.observe.metrics import \
                    get_metrics_registry
                registry = get_metrics_registry()
                if registry.enabled:
                    registry.incr(
                        "veles_anomaly_fired_total",
                        labels={"rule": rule.name},
                        help="anomaly-rule firings "
                             "(observe/history.py)")
            except Exception:
                pass
            try:
                from veles_tpu_torch.observe.flight import \
                    get_flight_recorder
                get_flight_recorder().note(
                    "anomaly", rule=rule.name, series=rule.series,
                    value=firing["value"], cause=dominant,
                    breach_since=rule.breach_since)
            except Exception:
                pass
            return history.incidents.trigger(history, rule, firing,
                                             now=now)
        return None


_serve_scope = ServeScope()


def get_serve_scope():
    """The process-global serving goodput observatory (fed by every
    ContinuousDecoder; breaker rebuilds keep accounting here)."""
    return _serve_scope


def ensure_serve_rules(history):
    """Book the serving anomaly rules into ``history`` (idempotent):
    ``serve_waste`` over ``veles_serve_waste_share`` and
    ``serve_occupancy`` over ``veles_serve_slot_occupancy``. Both are
    detector-owned (``external=True``): :meth:`ServeScope.autopsy_tick`
    evaluates and fires them on its own dispatch-delta cadence, so the
    sampler thread must not race their state
    (``MetricHistory._check_rules`` skips external rules). Returns the
    (waste, occupancy) pair."""
    from veles_tpu_torch.observe.history import AnomalyRule

    by_name = {rule.name: rule for rule in history.rules}
    waste = by_name.get("serve_waste")
    if waste is None:
        waste = history.add_rule(AnomalyRule(
            "serve_waste", "veles_serve_waste_share",
            kind="threshold", op=">=", threshold=WASTE_SHARE_BREACH,
            for_samples=WASTE_FOR_SAMPLES))
        waste.external = True
    occupancy = by_name.get("serve_occupancy")
    if occupancy is None:
        occupancy = history.add_rule(AnomalyRule(
            "serve_occupancy", "veles_serve_slot_occupancy",
            kind="threshold", op="<=", threshold=OCCUPANCY_BREACH,
            for_samples=OCCUPANCY_FOR_SAMPLES))
        occupancy.external = True
    return waste, occupancy


# -- metrics export ----------------------------------------------------------

def publish_serve_scope(registry, scope=None):
    """The serving goodput families (module docstring) — published at
    scrape time off the process scope, but only once it has seen
    traffic (a trainer's /metrics must not advertise empty serving
    families)."""
    if scope is None:
        scope = get_serve_scope()
    if not (scope.admits or scope.dispatches or scope.injected):
        return
    summary = scope.goodput_summary()
    registry.set("veles_serve_goodput_fraction", summary["fraction"],
                 help="useful share of dispatched serving tokens "
                      "(observe/servescope.py)")
    for component, seconds in scope.seconds.items():
        registry.counter_set(
            "veles_serve_goodput_seconds_total", seconds,
            labels={"component": component},
            help="serving wall decomposition: prefill/decode compute, "
                 "host bookkeeping, queue-empty idle")
    for cause, tokens in scope.waste.items():
        registry.counter_set(
            "veles_serve_token_waste_total", tokens,
            labels={"cause": cause},
            help="dispatched-but-wasted serving tokens by cause")
    for phase, tokens in scope.useful.items():
        registry.counter_set(
            "veles_serve_tokens_useful_total", tokens,
            labels={"phase": phase},
            help="useful dispatched serving tokens by phase")
    occupancy = scope.occupancy()["fraction"]
    if occupancy is not None:
        registry.set("veles_serve_slot_occupancy", occupancy,
                     help="live share of decode lane-steps (slot-pool "
                          "occupancy)")
    share = scope.waste_share()
    if share is not None:
        registry.set("veles_serve_waste_share", share,
                     help="wasted share of dispatched serving tokens")


def ensure_serve_registered(registry=None):
    """Idempotently attach the serving-goodput collector to
    ``registry`` (default: the process-global one) — called by every
    ``/metrics`` mount (``core/httpd.py``), the
    ``xla_stats.ensure_registered`` idiom."""
    from veles_tpu_torch.observe.metrics import get_metrics_registry

    if registry is None:
        registry = get_metrics_registry()
    collector = getattr(registry, "_serve_scope_collector", None)
    if collector is None:
        def collector():
            publish_serve_scope(registry)
        registry._serve_scope_collector = collector
    # registry.reset() (test isolation) clears collectors, so
    # membership is re-checked per mount rather than remembered
    if collector not in registry._collectors:
        registry.add_collector(collector)
    return registry


# -- trace assembly + the `observe serve-trace` CLI -------------------------

def assemble_serve_trace(payload):
    """A ``/debug/serve`` payload -> one Perfetto-loadable Chrome
    trace dict: ONE ROW PER SLOT (process "slots", tid = slot id) with
    each request's occupancy as a span and its first token as an
    instant, merged with the request-ledger rows (process "requests",
    tid = rid) as staged→resolved spans. Slot spans parent to their
    request's span (matched by rid) and both carry the request's trace
    id, so ``span_tree`` walks connected chains."""
    from veles_tpu_torch.observe.trace_export import chrome_trace

    slot_rows = [row for row in payload.get("slots") or []
                 if isinstance(row, dict)]
    requests = payload.get("requests") or {}
    ledger_rows = {}
    for row in list(requests.get("inflight") or []) \
            + list(requests.get("slowest") or []):
        if isinstance(row, dict) and isinstance(row.get("rid"), int) \
                and not isinstance(row.get("rid"), bool):
            ledger_rows.setdefault(row["rid"], row)
    names = {"slots": "slots (serving engine pid %s)"
                      % payload.get("pid", "?"),
             "requests": "requests (ledger)"}
    events = []
    for entry in slot_rows:
        slot = entry.get("slot")
        rid = entry.get("rid")
        admit = entry.get("admit")
        if isinstance(slot, bool) or not isinstance(slot, int) \
                or isinstance(admit, bool) \
                or not isinstance(admit, (int, float)):
            continue
        row = ledger_rows.get(rid)
        trace_id = entry.get("trace") \
            or (row.get("trace") if row else None) or "rid-%s" % rid
        parent = "req-%s" % rid if row is not None \
            else entry.get("span")
        base = {"name": "r%s %s" % (rid, entry.get("kind", "?")),
                "pid": "slots", "tid": slot, "trace_id": trace_id,
                "span_id": "occ-%s" % rid, "parent_id": parent,
                "rid": rid, "kind": entry.get("kind"),
                "reason": entry.get("reason")}
        events.append(dict(base, etype="begin", mono=float(admit)))
        retire = entry.get("retire")
        if not isinstance(retire, bool) \
                and isinstance(retire, (int, float)):
            events.append(dict(base, etype="end", mono=float(retire)))
        first = entry.get("first")
        if not isinstance(first, bool) \
                and isinstance(first, (int, float)):
            events.append({"name": "first_token", "pid": "slots",
                           "tid": slot, "etype": "single",
                           "mono": float(first), "trace_id": trace_id,
                           "span_id": "first-%s" % rid,
                           "parent_id": "occ-%s" % rid, "rid": rid})
    for rid, row in sorted(ledger_rows.items()):
        stamps = [(stage, stamp) for stage, stamp
                  in (s for s in row.get("stages") or ()
                      if isinstance(s, (list, tuple)) and len(s) == 2)
                  if isinstance(stamp, (int, float))
                  and not isinstance(stamp, bool)]
        if not stamps:
            continue
        trace_id = row.get("trace") or "rid-%s" % rid
        base = {"name": "req #%s rid=%s" % (row.get("id"), rid),
                "pid": "requests", "tid": rid, "trace_id": trace_id,
                "span_id": "req-%s" % rid, "parent_id": None,
                "outcome": row.get("outcome")}
        events.append(dict(base, etype="begin",
                           mono=float(stamps[0][1])))
        if row.get("outcome") is not None:
            events.append(dict(base, etype="end",
                               mono=float(stamps[-1][1])))
        for index, (stage, stamp) in enumerate(stamps[1:-1], start=1):
            events.append({"name": str(stage), "pid": "requests",
                           "tid": rid, "etype": "single",
                           "mono": float(stamp), "trace_id": trace_id,
                           "span_id": "st-%s-%s" % (rid, index),
                           "parent_id": "req-%s" % rid})
    return chrome_trace(events, process_names=names)


def render_serve_summary(payload, trace):
    """The CLI's human summary of one assembled serve trace."""
    lines = []
    events = trace.get("traceEvents", [])
    slots_pid = next(
        (event.get("pid") for event in events
         if event.get("ph") == "M"
         and event.get("name") == "process_name"
         and str((event.get("args") or {}).get("name", ""))
         .startswith("slots")), None)
    slot_tids = {event.get("tid") for event in events
                 if event.get("ph") == "M"
                 and event.get("name") == "thread_name"
                 and event.get("pid") == slots_pid
                 and slots_pid is not None}
    lines.append("serve trace: %d events across %d slot row(s)"
                 % (sum(1 for e in events if e.get("ph") != "M"),
                    len(slot_tids)))
    goodput = payload.get("goodput")
    if isinstance(goodput, dict):
        seconds = goodput.get("seconds") or {}
        lines.append(
            "  goodput %.1f%% of %s dispatched tokens · wall: "
            "prefill %ss · decode %ss · host %ss · idle %ss"
            % (100.0 * (goodput.get("fraction") or 0.0),
               (goodput.get("useful_tokens", 0)
                + goodput.get("waste_tokens", 0)),
               seconds.get("prefill_compute", 0),
               seconds.get("decode_compute", 0),
               seconds.get("host", 0), seconds.get("idle", 0)))
    waste = payload.get("waste")
    if isinstance(waste, dict) and any(waste.values()):
        lines.append("  waste by cause: " + " · ".join(
            "%s %s" % (cause, tokens)
            for cause, tokens in sorted(waste.items(),
                                        key=lambda kv: -kv[1])
            if tokens))
        dominant = payload.get("dominant_cause")
        if dominant:
            lines.append("  dominant waste cause: %s" % dominant)
    occupancy = payload.get("occupancy")
    if isinstance(occupancy, dict) \
            and occupancy.get("fraction") is not None:
        lines.append("  slot occupancy %.1f%% (%s of %s lane-steps "
                     "live)" % (100.0 * occupancy["fraction"],
                                occupancy.get("live_lane_steps", 0),
                                occupancy.get("total_lane_steps", 0)))
    return "\n".join(lines)


def load_serve_payload(path):
    """Load a saved ``/debug/serve`` payload (or an artifact embedding
    one under ``"servescope"``); raises ValueError on anything else."""
    with open(path, "r") as fin:
        doc = json.load(fin)
    if isinstance(doc, dict) and isinstance(doc.get("servescope"),
                                            dict):
        doc = doc["servescope"]
    if not isinstance(doc, dict) or doc.get("kind") != "servescope":
        raise ValueError("%s is not a servescope payload (save "
                         "GET /debug/serve from a serving surface)"
                         % path)
    return doc


def serve_trace_main(artifact=None, live=None, output=None):
    """``python -m veles_tpu_torch observe serve-trace [ARTIFACT |
    --live URL]``:
    assemble the per-slot occupancy timeline + request waterfalls into
    a Chrome trace JSON (open in ui.perfetto.dev) and print the
    goodput/waste/occupancy summary. Returns 0, or 1 when the payload
    cannot be loaded."""
    if live:
        import urllib.request

        url = "%s/debug/serve" % live.rstrip("/")
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                payload = json.loads(resp.read().decode())
        except Exception as exc:
            print("cannot fetch %s: %s" % (url, exc))
            return 1
        if not isinstance(payload, dict) \
                or payload.get("kind") != "servescope":
            print("%s did not return a servescope payload" % url)
            return 1
        default_out = "serve.trace.json"
    else:
        try:
            payload = load_serve_payload(artifact)
        except (OSError, ValueError) as exc:
            print("cannot load %s: %s" % (artifact, exc))
            return 1
        default_out = os.path.splitext(artifact)[0] + ".trace.json"
    trace = assemble_serve_trace(payload)
    out = output or default_out
    with open(out, "w") as fout:
        json.dump(trace, fout)
    print(render_serve_summary(payload, trace))
    print("wrote %s (open in ui.perfetto.dev)" % out)
    return 0
