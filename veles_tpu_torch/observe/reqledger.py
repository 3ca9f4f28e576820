"""Request-truth ledger: one structured row per serving request.

The port of ``veles_tpu/observe/reqledger.py``. A process-global,
bounded, lock-free ledger records the stage waterfall of each serving
request (``staged -> pool_gated -> admitted -> first_token -> per-chunk
token cadence -> resolved``) with monotonic stamps, and the attribution
facts the driver knows at each hop: prompt bucket, admission kind
(cold/tail/hit/dense) and group size, quant tier, pages reserved and
used, AOT-served against live dispatches, the kernel builds and loads
that overlapped the request (``observe/xla_stats.py``'s windows: a
request that waited on an ``nvcc`` build carries the stall), breaker
generation and trace id. A dispatch the decoder's AOT bundle covered
books ``aot`` (``aot/loader.py``), every other ``live``.

Surfaces: ``GET /debug/requests`` on both serving fronts
(``core/httpd.serve_debug_requests``), ``python -m veles_tpu_torch
observe slo`` (the waterfall autopsy of the slowest requests), the
flight recorder's black boxes (a breaker trip ships the requests it
shed), and the SLO engine (``observe/slo.py``), which reads resolved
rows.

Overhead contract: the record path takes no lock and does no I/O. A
stage mark is one enabled-flag check and one small list append; rows
live in a bounded in-flight map and a bounded resolved ring
(``deque(maxlen=...)``), both mutated only by GIL-atomic container ops.
A ``ContinuousDecoder`` without a ledger (``ledger=None``) pays one
attribute check a dispatch; the rid -> row map (``ledger_link``) is
scoped per decoder, so two engines with their own request counters can
share this ledger.
"""

import collections
import itertools
import time

#: resolved-row ring capacity (the autopsy window)
CAPACITY = 512

#: in-flight map hard cap: admission control bounds it in practice,
#: this bounds it against leaky direct drivers (drop-oldest)
INFLIGHT_CAP = 4096

#: per-row chunk-cadence cap: beyond it new chunk stamps are counted,
#: not stored (a 100k-token stream must not grow its row unboundedly)
CHUNK_CAP = 512

#: canonical stage order (the waterfall) — the stage-ordering test
#: pins that rows only ever append these left to right
STAGES = ("staged", "pool_gated", "admitted", "first_token", "resolved")

#: resolution outcomes a row can carry
OUTCOMES = ("completed", "cancelled", "expired", "shed", "rejected",
            "errors")


class RequestLedger:
    """The bounded per-request ledger (see module docstring)."""

    def __init__(self, capacity=CAPACITY, enabled=True,
                 inflight_cap=INFLIGHT_CAP, chunk_cap=CHUNK_CAP):
        self.enabled = enabled
        self.capacity = capacity
        self.inflight_cap = inflight_cap
        self.chunk_cap = chunk_cap
        self._resolved = collections.deque(maxlen=capacity)
        self._inflight = {}   # seq -> row (insertion-ordered)
        self._seq = itertools.count()  # next() is GIL-atomic
        self.staged_total = 0
        self.resolved_total = 0
        self.dropped_total = 0
        # loss truth for the trace recorder (``observe/replay.py``): every
        # way a bounded ring under-records is tallied here so an
        # exported trace can be stamped "lossy" WITH the amount —
        # chunk stamps past the per-row cap, and resolved rows pushed
        # off the ring before anyone exported them
        self.chunk_stamps_dropped_total = 0
        self.ring_overflow_total = 0

    # -- recording (no locks, GIL-atomic container ops only) --------------
    def stage(self, api="", trace=None, tenant="", prompt_len=0,
              budget=0, bucket=0, quant=None, breaker_gen=0,
              deadline=0.0):
        """Open one row at request staging (handler thread); returns
        the row dict to carry alongside the request, or None while
        disabled. One dict/list allocation per REQUEST — never per
        token."""
        if not self.enabled:
            return None
        now = time.monotonic()
        row = {
            "id": next(self._seq),
            "api": api,
            "trace": trace,
            "tenant": tenant,
            "rid": None,
            "prompt_len": int(prompt_len),
            "bucket": int(bucket),
            "budget": int(budget),
            "quant": quant or "bf16",
            "deadline_s": float(deadline),
            "breaker_gen": int(breaker_gen),
            "t": time.time(),
            "staged": now,
            "stages": [["staged", now]],
            "admit": None,
            "pages_reserved": 0,
            "pages_used": 0,
            "chunks": [],
            "chunks_dropped": 0,
            "dispatches": {"aot": 0, "live": 0},
            "tokens": 0,
            "outcome": None,
            "error": None,
        }
        self._inflight[row["id"]] = row
        self.staged_total += 1
        if len(self._inflight) > self.inflight_cap:
            # leaky direct driver: bound memory by dropping the oldest
            # unresolved row (admission-controlled serving never hits
            # this — max_queue is orders of magnitude smaller)
            oldest = next(iter(self._inflight), None)
            if oldest is not None \
                    and self._inflight.pop(oldest, None) is not None:
                self.dropped_total += 1
        return row

    def mark(self, row, stage, **attrs):
        """Append one stage mark to ``row`` (no-op for None rows, so
        callers never branch). Extra attrs merge into the row."""
        if row is None:
            return
        row["stages"].append([stage, time.monotonic()])
        if attrs:
            row.update(attrs)

    def link(self, row, rid):
        """Stamp a staged row with its decoder request id. The rid ->
        row MAP lives on the decoder (``ContinuousDecoder.
        ledger_link``), scoped per decoder — two engines with
        independent rid counters can share one process ledger without
        cross-talk."""
        if row is None:
            return
        row["rid"] = int(rid)

    def note_admit(self, row, kind, group=1, bucket=0, aot=False,
                   program=None, pages=0):
        """The decoder admitted the row's request into a slot: stamp
        the ``admitted`` stage with the dispatch-group attribution
        (kind cold/tail/hit/dense, group size, prompt bucket, AOT vs
        live, program name, pages mapped). ``row=None`` (direct
        submits, probes) is a no-op."""
        if row is None:
            return
        row["admit"] = {"kind": kind, "group": int(group),
                        "bucket": int(bucket), "aot": bool(aot),
                        "program": program}
        if pages:
            row["pages_used"] = int(pages)
        row["dispatches"]["aot" if aot else "live"] += 1
        row["stages"].append(["admitted", time.monotonic()])

    def note_tokens(self, row, n, aot=False):
        """One collected chunk delivered ``n`` tokens to the row's
        request: append a cadence stamp (bounded), stamp
        ``first_token`` on the first, book the dispatch's AOT/live
        attribution."""
        if row is None or not n:
            return
        now = time.monotonic()
        if row["tokens"] == 0:
            row["stages"].append(["first_token", now])
        row["tokens"] += int(n)
        row["dispatches"]["aot" if aot else "live"] += 1
        if len(row["chunks"]) < self.chunk_cap:
            row["chunks"].append([now, int(n), 1 if aot else 0])
        else:
            row["chunks_dropped"] += 1
            self.chunk_stamps_dropped_total += 1

    def resolve(self, row, outcome, error=None):
        """Close a row exactly once: stamp ``resolved``, attach the
        compile windows that overlapped the request (device truth —
        only when the compile tracker is live), move it from the
        in-flight map to the bounded ring."""
        if row is None or row["outcome"] is not None:
            return
        now = time.monotonic()
        row["outcome"] = outcome
        if error:
            row["error"] = str(error)[:200]
        row["stages"].append(["resolved", now])
        row["resolved"] = now
        row["wall_ms"] = round((now - row["staged"]) * 1000.0, 3)
        try:
            from veles_tpu_torch.observe.xla_stats import (
                get_compile_tracker)
            tracker = get_compile_tracker()
            if tracker.enabled:
                stalls = tracker.compiles_overlapping(row["staged"], now)
                if stalls:
                    row["compile_stalls"] = [
                        [name, round(sec * 1000.0, 3)]
                        for name, sec in stalls[:8]]
                    row["compile_stall_ms"] = round(
                        sum(sec for _, sec in stalls) * 1000.0, 3)
        except Exception:   # noqa: BLE001 - attribution never fails a row
            pass
        self._inflight.pop(row["id"], None)
        if len(self._resolved) >= self.capacity:
            # deque(maxlen) evicts silently; count it so the trace
            # recorder knows how many resolved rows it never saw
            self.ring_overflow_total += 1
        self._resolved.append(row)
        self.resolved_total += 1

    # -- views ------------------------------------------------------------
    @staticmethod
    def _copy(row):
        """JSON-safe shallow copy (rows mutate concurrently; list()
        under the GIL is a consistent snapshot of each container)."""
        out = dict(row)
        out["stages"] = [list(s) for s in row["stages"]]
        out["chunks"] = [list(c) for c in row["chunks"]]
        out["dispatches"] = dict(row["dispatches"])
        if row.get("admit"):
            out["admit"] = dict(row["admit"])
        return out

    def inflight(self):
        """Copies of the live rows, oldest first."""
        return [self._copy(row) for row in list(self._inflight.values())]

    def slowest(self, n=8):
        """The ``n`` slowest RESOLVED rows (by staged->resolved wall),
        slowest first."""
        rows = sorted(list(self._resolved),
                      key=lambda r: r.get("wall_ms", 0.0), reverse=True)
        return [self._copy(row) for row in rows[:max(0, int(n))]]

    def resolved(self, n=None):
        """Copies of the resolved rows in ring order (oldest first) —
        the trace recorder's export seam (``observe/replay.py`` reads
        the arrival cadence from these rows' ``staged`` stamps). ``n``
        keeps only the newest n."""
        rows = list(self._resolved)
        if n is not None:
            rows = rows[-max(0, int(n)):]
        return [self._copy(row) for row in rows]

    def loss_tallies(self):
        """Every way this bounded ledger under-records, as one dict —
        what the trace recorder stamps into a lossy trace's header."""
        return {"inflight_dropped": self.dropped_total,
                "chunk_stamps_dropped": self.chunk_stamps_dropped_total,
                "resolved_ring_overflow": self.ring_overflow_total}

    def debug_snapshot(self, slowest=8):
        """The ``/debug/requests`` payload: live in-flight rows + the N
        slowest resolved, plus the ledger's own tallies."""
        return {"inflight": self.inflight(),
                "slowest": self.slowest(slowest),
                "staged_total": self.staged_total,
                "resolved_total": self.resolved_total,
                "dropped_total": self.dropped_total,
                "chunk_stamps_dropped_total":
                    self.chunk_stamps_dropped_total,
                "ring_overflow_total": self.ring_overflow_total,
                "capacity": self.capacity}

    def reset(self):
        """Drop everything (test isolation)."""
        self._resolved.clear()
        self._inflight.clear()
        self.staged_total = 0
        self.resolved_total = 0
        self.dropped_total = 0
        self.chunk_stamps_dropped_total = 0
        self.ring_overflow_total = 0


_ledger = RequestLedger()


def get_request_ledger():
    return _ledger


def publish_request_ledger(registry, ledger):
    """Scrape-time bridge: the ledger's own tallies as
    ``veles_reqledger_*`` counters on /metrics.
    The loss counters are the trace recorder's honesty contract made
    operator-visible — a cadence-capped or ring-overflowed ledger
    under-records, and these say by how much BEFORE anyone exports a
    trace from it."""
    registry.counter_set(
        "veles_reqledger_staged_total", ledger.staged_total,
        help="requests that opened a ledger row at staging")
    registry.counter_set(
        "veles_reqledger_resolved_total", ledger.resolved_total,
        help="ledger rows resolved into the bounded ring")
    registry.counter_set(
        "veles_reqledger_inflight_dropped_total", ledger.dropped_total,
        help="unresolved rows dropped past the in-flight cap "
             "(leaky direct drivers only)")
    registry.counter_set(
        "veles_reqledger_chunk_stamps_dropped_total",
        ledger.chunk_stamps_dropped_total,
        help="per-request chunk cadence stamps dropped past chunk_cap "
             "(a trace recorded from this ledger is lossy)")
    registry.counter_set(
        "veles_reqledger_ring_overflow_total",
        ledger.ring_overflow_total,
        help="resolved rows evicted off the bounded ring "
             "(a trace recorded from this ledger is lossy)")


# -- waterfall formatting (the autopsy view) --------------------------------

def _segments(row):
    """The waterfall as (label, start, end) segments: consecutive stage
    marks, with the chunk cadence expanded between ``first_token`` and
    ``resolved`` (``decode[i]`` per collected chunk)."""
    points = []
    for stage, stamp in row.get("stages", ()):
        if stage == "resolved":
            continue  # appended last, after the chunk cadence
        points.append((stage, float(stamp)))
        if stage == "first_token":
            break
    for i, chunk in enumerate(row.get("chunks", ())[1:], start=2):
        points.append(("decode[%d]" % i, float(chunk[0])))
    for stage, stamp in row.get("stages", ()):
        if stage == "resolved":
            points.append(("resolved", float(stamp)))
    segments = []
    for (a, t0), (b, t1) in zip(points, points[1:]):
        segments.append(("%s→%s" % (a, b), t0, t1))
    return points, segments


def widest_gap(row):
    """(label, ms) of the dominant waterfall segment — what a chaos
    slow-step autopsy names as the stall."""
    _, segments = _segments(row)
    if not segments:
        return None, 0.0
    label, t0, t1 = max(segments, key=lambda s: s[2] - s[1])
    return label, round((t1 - t0) * 1000.0, 3)


def format_waterfall(row):
    """One row as a human-readable stage waterfall with attribution —
    the ``observe slo`` autopsy block."""
    lines = []
    trace = row.get("trace") or "-"
    lines.append(
        "request #%s rid=%s api=%s tenant=%s outcome=%s tokens=%s "
        "wall=%.1fms trace=%s"
        % (row.get("id"), row.get("rid"), row.get("api") or "-",
           row.get("tenant") or "-", row.get("outcome") or "in-flight",
           row.get("tokens", 0), row.get("wall_ms") or 0.0, trace))
    admit = row.get("admit") or {}
    facts = ["prompt=%d" % row.get("prompt_len", 0),
             "bucket=%d" % (admit.get("bucket") or row.get("bucket", 0)),
             "quant=%s" % row.get("quant", "bf16")]
    if admit:
        facts.append("admit=%s group=%d" % (admit.get("kind"),
                                            admit.get("group", 1)))
        if admit.get("program"):
            facts.append("program=%s" % admit["program"])
    if row.get("pages_reserved") or row.get("pages_used"):
        facts.append("pages=%d(reserved %d)"
                     % (row.get("pages_used", 0),
                        row.get("pages_reserved", 0)))
    dispatches = row.get("dispatches") or {}
    facts.append("dispatches aot=%d live=%d"
                 % (dispatches.get("aot", 0), dispatches.get("live", 0)))
    facts.append("breaker_gen=%d" % row.get("breaker_gen", 0))
    if row.get("error"):
        facts.append("error=%r" % row["error"])
    lines.append("  " + " ".join(facts))
    points, segments = _segments(row)
    stall = None
    if segments:
        stall = max(segments, key=lambda s: s[2] - s[1])
    t0 = points[0][1] if points else 0.0
    tokens_at = {}
    for i, chunk in enumerate(row.get("chunks", ())[1:], start=2):
        tokens_at["decode[%d]" % i] = chunk[1]
    for label, stamp in points:
        mark = ""
        if stall is not None and label == stall[0].split("→")[1] \
                and (stall[2] - stall[1]) > 0:
            mark = "   <-- stall (%s %.1fms)" % (
                stall[0], (stall[2] - stall[1]) * 1000.0)
        extra = ""
        if label in tokens_at:
            extra = "   +%d tok" % tokens_at[label]
        lines.append("  %-14s +%.1fms%s%s"
                     % (label, (stamp - t0) * 1000.0, extra, mark))
    if row.get("chunks_dropped"):
        lines.append("  (%d chunk stamps dropped past the cap)"
                     % row["chunks_dropped"])
    stalls = row.get("compile_stalls")
    if stalls:
        lines.append("  compile stalls: "
                     + ", ".join("%s %.0fms" % (name, ms)
                                 for name, ms in stalls))
    return "\n".join(lines)


def autopsy(rows, slowest=8):
    """Waterfall blocks for the ``slowest`` rows, slowest first."""
    rows = sorted(rows, key=lambda r: r.get("wall_ms", 0.0),
                  reverse=True)[:max(0, int(slowest))]
    return "\n\n".join(format_waterfall(row) for row in rows)
