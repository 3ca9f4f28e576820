"""Fleet goodput observatory: cross-process traces, clocks, stragglers.

The port's copy of ``veles_tpu/observe/fleetscope.py``.

Every process in the fleet already tells rich truth about itself —
spans, MetricHistory, incident artifacts — but that truth dies at the
process boundary: the Chrome exporter is single-process, and "which
slave is slow, and what did it cost us" was answered by a crude
mean/variance over ``job_times`` on the master. This module makes the
FLEET observable as one system:

- :class:`SpanRing` — a bounded, lock-free ring of **completed-span
  summaries** on each slave (fed by ``tracing.Span`` at finish), which
  the fleet client piggybacks onto update frames exactly like the
  metric/history snapshots (``fleet/client.py``). The master validates
  and caps the rows at ingestion (the hostile-slave doctrine of
  ``Server.slave_metrics``) and keeps them in a bounded store.
- :class:`ClockEstimate` — NTP-style per-process clock alignment from
  the job→update round-trip stamp pairs the wire already exchanges:
  the master stamps the job send, the slave echoes its receive/send
  monotonic stamps, and the filtered (min round-trip over the last few
  pairs) estimate maps slave mono-stamps onto the master timeline with
  an explicit uncertainty bound (half the best filtered round trip).
- :class:`FleetScope` — the master-side aggregate: per-slave step-time
  windows (ONE implementation behind both the adaptive hang timeout
  and the straggler detector), a goodput decomposition of fleet wall
  time into compute / wire / host / idle / **wasted** (requeued-after-
  death in-flight seconds from the job ledger plus rollback-discarded
  compute the control-plane client reports), and a persistent-straggler
  detector (per-slave median step time vs the fleet median over
  ``STRAGGLER_WINDOWS`` consecutive windows) that books the
  ``fleet_straggler``/``fleet_goodput`` anomaly rules into the master's
  MetricHistory and lands a fleet incident artifact NAMING the
  straggler slave and its lead vs the goodput breach.
- :func:`assemble_fleet_trace` + ``veles_tpu_torch observe
  fleet-trace [ARTIFACT | --live URL]`` — merge master + slave spans into one
  Perfetto-loadable Chrome trace with per-process rows
  (``process_name`` metadata) and clock-aligned timestamps, preserving
  the fleet.issue → fleet.do_job → fleet.apply one-trace chains across
  the wire. The payload comes from the fleet metrics sidecar's
  ``GET /debug/fleet`` (live) or a saved copy of it (artifact).

Record-path discipline (the JAX package's
``veles_tpu/analyze/registry.py`` declares these):
``SpanRing.note_span``/``drain``, ``ClockEstimate.observe``,
``StepWindow.push`` and ``FleetScope.note_update`` run on hot paths
(the span-finish path on slaves, the master's event loop) — no locks,
no I/O, GIL-atomic container ops, bounded memory. Everything that can
write an incident artifact lives in :meth:`FleetScope.autopsy_tick`,
which the server calls OFF the record path.

See docs/observability.md ("Fleet timeline + goodput") and
tests/test_fleetscope.py (``make fleetscope``).
"""

import collections
import json
import math
import os
import time

#: slave-side completed-span ring capacity (summaries, drop-oldest)
SPAN_RING_CAPACITY = 512

#: span-summary rows per update frame (the piggyback bound — span
#: traffic must stay small beside the job payload it rides)
SPAN_SHIP_MAX_ROWS = 128

#: master-side assembled-span store bound (across all slaves)
SPAN_STORE_CAP = 4096

#: span-summary field bounds (ingestion validation)
SPAN_NAME_MAX = 120
SPAN_ID_MAX = 64

#: NTP-style clock filter: keep the last N (round-trip, offset) pairs
#: and trust the minimum-round-trip one (its asymmetry bound is
#: tightest)
CLOCK_FILTER_KEEP = 8

#: floor on the reported uncertainty (scheduler jitter never lets two
#: monotonic reads align better than this)
CLOCK_UNCERTAINTY_FLOOR_S = 1e-4

#: persistent-straggler detection: a slave whose median step time sits
#: >= RATIO x the fleet median for WINDOWS consecutive completed jobs
#: (each with >= MIN_SAMPLES history) is named a straggler
STRAGGLER_RATIO = 1.75
STRAGGLER_WINDOWS = 3
STRAGGLER_MIN_SAMPLES = 3

#: the goodput-breach threshold the fleet_goodput anomaly rule pages
#: on: less than half the fleet's wall time doing useful compute
GOODPUT_BREACH_FRACTION = 0.5

#: bound on tracked per-slave windows / per-process clock estimates
#: (slave churn in a long-lived master must not grow these forever)
TRACKED_CAP = 64

#: bound on outstanding job-issue stamps awaiting their update
PENDING_CAP = 4096

#: /debug/fleet payload schema version
FLEET_TRACE_SCHEMA = 1


def _median(values):
    """Median of a non-empty list (mean of the middle two when even)."""
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


class SpanRing:
    """The slave-side bounded ring of completed-span summaries.

    ``note_span`` is on the flight-recorder record path: one enabled
    check plus one GIL-atomic bounded append — no locks, no I/O, no
    registry traffic; memory is bounded by the deque ``maxlen``.
    ``drain`` pops the oldest rows for one update frame (the fleet
    client's piggyback; each ``popleft`` is a single GIL-atomic op)."""

    def __init__(self, capacity=SPAN_RING_CAPACITY):
        self.enabled = False
        self._ring = collections.deque(maxlen=int(capacity))
        self.noted_total = 0
        self.shipped_total = 0

    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def note_span(self, name, trace_id, span_id, parent_id, t0, dur_ms,
                  tid):
        """Record one COMPLETED span summary (record path)."""
        if not self.enabled:
            return
        self.noted_total += 1
        self._ring.append([str(name)[:SPAN_NAME_MAX], trace_id, span_id,
                           parent_id, t0, dur_ms, tid])

    def drain(self, max_rows=SPAN_SHIP_MAX_ROWS):
        """Pop up to ``max_rows`` summaries, oldest first (record
        path: per-row GIL-atomic pops, no lock)."""
        rows = []
        while len(rows) < max_rows:
            try:
                rows.append(self._ring.popleft())
            except IndexError:
                break
        self.shipped_total += len(rows)
        return rows

    def __len__(self):
        return len(self._ring)


_span_ring = SpanRing()


def get_span_ring():
    """The process-global span ring (enabled by the fleet client; fed
    by ``tracing.Span`` whenever tracing is on)."""
    return _span_ring


def valid_span_rows(rows, max_rows=SPAN_SHIP_MAX_ROWS):
    """Hostile-slave ingestion validation (the ``slave_metrics``
    doctrine): the rows came off the wire, so anything not shaped like
    a ``[name, trace_id, span_id, parent_id, t0, dur_ms, tid]`` span
    summary with sane types/bounds is dropped — a hostile or
    version-skewed slave can at most contribute bogus TIMINGS, never
    balloon the master's memory or break the trace assembly."""
    out = []
    if not isinstance(rows, list):
        return out
    for row in rows[:max_rows]:
        try:
            name, trace_id, span_id, parent_id, t0, dur_ms, tid = row
        except (TypeError, ValueError):
            continue
        if not isinstance(name, str) or not name:
            continue
        if not isinstance(span_id, str) or not span_id \
                or len(span_id) > SPAN_ID_MAX:
            continue
        if trace_id is not None and (not isinstance(trace_id, str)
                                     or len(trace_id) > SPAN_ID_MAX):
            continue
        if parent_id is not None and (not isinstance(parent_id, str)
                                      or len(parent_id) > SPAN_ID_MAX):
            continue
        if isinstance(t0, bool) or not isinstance(t0, (int, float)) \
                or not math.isfinite(t0):
            continue
        if isinstance(dur_ms, bool) \
                or not isinstance(dur_ms, (int, float)) \
                or not 0 <= dur_ms < 1e9:
            continue
        if isinstance(tid, bool) or not isinstance(tid, int):
            tid = 0
        out.append((name[:SPAN_NAME_MAX], trace_id, span_id, parent_id,
                    float(t0), float(dur_ms), tid))
    return out


class ClockEstimate:
    """One remote process's clock offset vs the master timeline,
    NTP-filtered.

    Each job→update exchange yields the four stamps (t0 master send,
    t1 slave receive, t2 slave send, t3 master receive); the classic
    estimates are offset θ = ((t1-t0) + (t2-t3))/2 (slave clock MINUS
    master clock) and round trip δ = (t3-t0) - (t2-t1). The asymmetry
    error of θ is bounded by δ/2, so the filter keeps the last
    ``CLOCK_FILTER_KEEP`` (δ, θ) pairs and trusts the minimum-δ one —
    ``offset_s`` ± ``uncertainty_s`` is then a true bound, chaos frame
    delays only widen δ on the samples they hit and the filter routes
    around them. ``observe`` is on the master's event-loop record
    path: no locks, no I/O."""

    __slots__ = ("pairs", "offset_s", "uncertainty_s", "samples")

    def __init__(self, keep=CLOCK_FILTER_KEEP):
        self.pairs = collections.deque(maxlen=int(keep))
        self.offset_s = None
        self.uncertainty_s = None
        self.samples = 0

    def observe(self, theta_s, delta_s):
        """Ingest one (offset, round-trip-residual) pair (record
        path)."""
        self.samples += 1
        self.pairs.append((max(float(delta_s), 1e-9), float(theta_s)))
        delta, theta = min(self.pairs)
        self.offset_s = theta
        self.uncertainty_s = delta / 2.0 + CLOCK_UNCERTAINTY_FLOOR_S

    def to_master(self, slave_mono):
        """Map a slave monotonic stamp onto the master timeline."""
        if self.offset_s is None:
            return float(slave_mono)
        return float(slave_mono) - self.offset_s

    def as_dict(self):
        return {
            "offset_ms": (round(self.offset_s * 1e3, 3)
                          if self.offset_s is not None else None),
            "uncertainty_ms": (round(self.uncertainty_s * 1e3, 3)
                               if self.uncertainty_s is not None
                               else None),
            "samples": self.samples,
        }


class StepWindow:
    """One slave's rolling step-time window — the SINGLE implementation
    behind the master's adaptive hang timeout (mean + 3σ, the old
    ``SlaveDescription.job_times`` math) and the straggler detector's
    per-slave median. ``push`` is on the master's event-loop record
    path: bounded list append + trim, no locks."""

    __slots__ = ("samples", "keep")

    def __init__(self, keep=100):
        self.keep = int(keep)
        self.samples = []

    def push(self, seconds):
        """Record one step time (record path)."""
        self.samples.append(float(seconds))
        if len(self.samples) > self.keep:
            del self.samples[:-self.keep]

    @property
    def n(self):
        return len(self.samples)

    def median(self):
        if not self.samples:
            return 0.0
        return _median(self.samples)

    def mean_sigma(self):
        samples = list(self.samples)
        if not samples:
            return 0.0, 0.0
        mean = sum(samples) / len(samples)
        var = sum((t - mean) ** 2 for t in samples) / len(samples)
        return mean, var ** 0.5

    def hang_timeout(self, default):
        """The reference mean + 3σ adaptive hang threshold
        (``server.py:619-635``), floored at ``default``."""
        if len(self.samples) < 3:
            return default
        mean, sigma = self.mean_sigma()
        return max(mean + 3.0 * sigma, default)


class FleetScope:
    """The master-side fleet observatory (see module docstring).

    One instance lives on ``fleet.Server``; the event loop feeds it
    (``note_issue``/``note_update``/``book_update`` — record path) and
    runs ``autopsy_tick`` after each accepted update (NOT record path:
    it may write an incident artifact, cooldown-limited)."""

    RATIO = STRAGGLER_RATIO
    WINDOWS = STRAGGLER_WINDOWS
    MIN_SAMPLES = STRAGGLER_MIN_SAMPLES

    def __init__(self):
        #: sid -> StepWindow (shared with SlaveDescription — the hang
        #: timeout and the straggler detector read one window)
        self.windows = {}
        #: "mid:pid" -> [latest sid, ClockEstimate]
        self.clocks = {}
        #: job_id -> (sid, proc, master tx mono), awaiting the update
        self._pending = {}
        #: assembled slave-span store (bounded; dedup by span_id so a
        #: chaos duplicate-update replay cannot double a span)
        self.spans = collections.deque(maxlen=SPAN_STORE_CAP)
        self._span_ids = set()
        self._span_idq = collections.deque()
        self.spans_ingested = {}
        self.spans_dropped = 0
        #: goodput totals (seconds, cumulative)
        self.totals = {"compute_s": 0.0, "host_s": 0.0, "wire_s": 0.0,
                       "idle_s": 0.0}
        self.jobs_booked = 0
        self._last_done = {}
        #: latest cumulative rollback-discarded compute per process
        #: (control-plane clients report it; last-wins like the chaos
        #: tallies, so reconnects never double count)
        self._rollback_ms = {}
        #: straggler detection state
        self.scores = {}
        self._streaks = {}
        self.straggler = None
        #: departed sids: kept out of the scoring pool (a dead
        #: slave's frozen median must not skew the leave-one-out
        #: reference), windows retained for status display
        self._departed = set()

    # -- record-path ingestion (master event loop) ------------------------
    def track_window(self, sid, window):
        """Adopt a slave's step window (one implementation for hang
        timeout + straggler detection). Bounded: oldest tracked sid
        evicted past ``TRACKED_CAP``."""
        if len(self.windows) >= TRACKED_CAP and sid not in self.windows:
            self.windows.pop(next(iter(self.windows)), None)
        self.windows[sid] = window
        self._departed.discard(sid)
        self._departed.intersection_update(self.windows)

    def drop_slave(self, sid):
        """A slave departed (death, blacklist, clean exit): take it
        out of the scoring pool — its frozen window must not skew the
        rest-of-fleet median — and flag (not erase) a straggler
        verdict that named it, so the autopsy stays visible without
        pinning a dead slave as breaching forever."""
        self._departed.add(sid)
        self._streaks.pop(sid, None)
        if self.straggler is not None \
                and self.straggler.get("slave") == sid \
                and not self.straggler.get("departed"):
            self.straggler = dict(self.straggler, departed=True)

    def note_issue(self, job_id, slave, now):
        """Stamp a job send (record path): the t0 of the NTP exchange
        and the origin of this job's round trip."""
        if len(self._pending) >= PENDING_CAP:
            self._pending.pop(next(iter(self._pending)), None)
        proc = "%s:%s" % (slave.mid, slave.pid)
        self._pending[job_id] = (slave.id, proc, now)
        self._last_done.setdefault(slave.id, now)

    def note_update(self, slave, msg, now):
        """Ingest one update frame's observability freight (record
        path): span summaries (validated + deduped), the clock stamp
        pair, the rollback-waste report. Returns the round-trip facts
        for :meth:`book_update`, or None when the frame carries no
        usable stamp pair (keepalive, duplicate, old client)."""
        proc = "%s:%s" % (slave.mid, slave.pid)
        rollback = msg.get("rollback_ms")
        if isinstance(rollback, (int, float)) \
                and not isinstance(rollback, bool) \
                and 0 <= rollback < 1e12:
            self._rollback_ms[proc] = float(rollback)
        rows = msg.get("spans")
        if isinstance(rows, list):
            kept = 0
            for row in valid_span_rows(rows):
                name, trace_id, span_id, parent_id, t0, dur_ms, tid = row
                if span_id in self._span_ids:
                    continue
                self._span_ids.add(span_id)
                self._span_idq.append(span_id)
                if len(self._span_idq) > SPAN_STORE_CAP:
                    self._span_ids.discard(self._span_idq.popleft())
                self.spans.append({
                    "proc": proc, "slave": slave.id, "name": name,
                    "trace_id": trace_id, "span_id": span_id,
                    "parent_id": parent_id, "t0": t0, "dur_ms": dur_ms,
                    "tid": tid})
                kept += 1
            self.spans_ingested[slave.id] = \
                self.spans_ingested.get(slave.id, 0) + kept
            self.spans_dropped += max(0, len(rows) - kept)
        job_id = msg.get("job_id")
        pending = None
        if isinstance(job_id, int) and not isinstance(job_id, bool):
            entry = self._pending.get(job_id)
            # owner check: a fenced zombie answering a REQUEUED lease
            # must not consume the stamp pair of the slave the job was
            # re-issued to (note_issue overwrote the entry) — its
            # mixed-origin stamps would poison the clock estimate and
            # orphan the genuine update's goodput booking
            if entry is not None and entry[0] == slave.id:
                pending = self._pending.pop(job_id)
        stamps = msg.get("mono")
        if pending is None or not isinstance(stamps, (list, tuple)) \
                or len(stamps) != 2:
            return None
        try:
            rx, tx = float(stamps[0]), float(stamps[1])
        except (TypeError, ValueError):
            return None
        if not (math.isfinite(rx) and math.isfinite(tx)) or tx < rx:
            return None
        _, _, tx_mono = pending
        rtt = now - tx_mono
        if rtt <= 0:
            return None
        residence = min(tx - rx, rtt)
        # NTP: theta = slave clock - master clock; delta = wire-only
        # round trip (total minus the slave's residence)
        theta = ((rx - tx_mono) + (tx - now)) / 2.0
        delta = max(rtt - residence, 1e-9)
        entry = self.clocks.get(proc)
        if entry is None and len(self.clocks) < TRACKED_CAP:
            entry = self.clocks[proc] = [slave.id, ClockEstimate()]
        if entry is not None:
            entry[0] = slave.id
            entry[1].observe(theta, delta)
        job_ms = msg.get("job_ms")
        compute = None
        if isinstance(job_ms, (int, float)) \
                and not isinstance(job_ms, bool) and 0 <= job_ms < 1e9:
            compute = float(job_ms) / 1e3
        return {"rtt": rtt, "residence": residence, "compute": compute}

    def book_update(self, sid, pair, now):
        """Book one ACCEPTED update into the goodput decomposition
        (record path). ``pair`` is :meth:`note_update`'s return; a
        stamp-less frame still advances the idle anchor so the next
        gap is not overcounted."""
        if pair is None:
            self._last_done[sid] = now
            return
        residence = pair["residence"]
        rtt = pair["rtt"]
        compute = pair["compute"]
        if compute is None:
            compute = residence
        compute = min(compute, residence)
        last = self._last_done.get(sid, now - rtt)
        totals = self.totals
        totals["compute_s"] += compute
        totals["host_s"] += residence - compute
        totals["wire_s"] += max(0.0, rtt - residence)
        totals["idle_s"] += max(0.0, (now - last) - rtt)
        self.jobs_booked += 1
        self._last_done[sid] = now

    # -- straggler detection + autopsy (event loop, NOT record path) ------
    def evaluate_straggler(self, sid, now):
        """Re-score the fleet after ``sid`` completed a job; returns a
        detection event dict the first/each time the slave's breach
        streak reaches ``WINDOWS``, else None. Needs >= 2 slaves with
        >= MIN_SAMPLES history (a fleet of one has no median to lag)."""
        window = self.windows.get(sid)
        if window is None or window.n < self.MIN_SAMPLES:
            return None
        medians = {s: w.median() for s, w in self.windows.items()
                   if w.n >= self.MIN_SAMPLES
                   and s not in self._departed}
        if sid not in medians or len(medians) < 2:
            return None
        # leave-one-out: each slave scores against the median of the
        # REST of the fleet — a fleet median that included the
        # candidate would dilute the very straggler it measures (with
        # 2 slaves the mixed score asymptotes at 2.0)
        for s, med in medians.items():
            rest = _median([m for other, m in medians.items()
                            if other != s])
            self.scores[s] = med / rest if rest > 0 else 1.0
        score = self.scores[sid]
        fleet_median = _median([m for other, m in medians.items()
                                if other != sid])
        if fleet_median <= 0:
            return None
        streak = self._streaks.setdefault(sid, [0, None])
        if score >= self.RATIO:
            streak[0] += 1
            if streak[1] is None:
                streak[1] = now
        else:
            streak[0] = 0
            streak[1] = None
            if self.straggler is not None \
                    and self.straggler.get("slave") == sid:
                self.straggler = None
            return None
        if streak[0] < self.WINDOWS:
            return None
        self.straggler = {
            "slave": sid, "score": round(score, 3),
            "windows": streak[0], "since": streak[1],
            "step_ms": round(medians[sid] * 1e3, 3),
            # the reference: the median of the REST of the fleet
            "fleet_median_ms": round(fleet_median * 1e3, 3)}
        return dict(self.straggler)

    def autopsy_tick(self, sid, history, wasted_s=0.0, now=None):
        """The per-accepted-update follow-up the server runs OFF the
        record path: evaluate the straggler detector, feed the
        goodput/straggler trend series into the master's MetricHistory
        (``record_control`` — lock-free), keep the ``fleet_straggler``
        / ``fleet_goodput`` anomaly-rule states synced to detector
        truth, and land a (cooldown-limited) fleet incident artifact
        naming the straggler. Returns the incident path or None."""
        if now is None:
            now = time.monotonic()
        event = self.evaluate_straggler(sid, now)
        if history is None:
            return None
        summary = self.goodput_summary(wasted_s=wasted_s)
        straggler_rule, goodput_rule = ensure_fleet_rules(history)
        fraction = summary["fraction"]
        history.record_control("veles_fleet_goodput_fraction", fraction,
                               now=now)
        for s, score in list(self.scores.items()):
            history.record_control("veles_fleet_straggler_score", score,
                                   labels=(("slave", s),), now=now)
        goodput_rule.last_value = fraction
        if summary["jobs"] and fraction <= goodput_rule.threshold:
            goodput_rule.streak += 1
            if goodput_rule.breach_since is None:
                goodput_rule.breach_since = now
            goodput_rule.breach_value = fraction
        else:
            goodput_rule.streak = 0
            goodput_rule.breach_since = None
            goodput_rule.breach_value = None
        current = self.straggler
        if current is not None:
            streak = self._streaks.get(current["slave"]) or [0, None]
            straggler_rule.streak = streak[0]
            straggler_rule.breach_since = streak[1]
            straggler_rule.breach_value = current["score"]
            straggler_rule.last_value = current["score"]
            straggler_rule.breach_labels = (("slave",
                                             current["slave"]),)
        elif not any(streak[0] for streak in self._streaks.values()):
            straggler_rule.streak = 0
            straggler_rule.breach_since = None
            straggler_rule.breach_value = None
            straggler_rule.breach_labels = None
        if event is None:
            return None
        if straggler_rule.last_fired is not None \
                and now - straggler_rule.last_fired \
                < straggler_rule.cooldown_s:
            return None
        straggler_rule.last_fired = now
        straggler_rule.fired_total += 1
        firing = {"rule": straggler_rule.name,
                  "series": straggler_rule.series,
                  "kind": straggler_rule.kind,
                  "value": event["score"],
                  "labels": [["slave", event["slave"]]],
                  "breach_since": event["since"], "mono": now,
                  "straggler": event, "goodput": summary}
        history.anomalies_total += 1
        try:
            from veles_tpu_torch.observe.metrics import get_metrics_registry
            registry = get_metrics_registry()
            if registry.enabled:
                registry.incr(
                    "veles_anomaly_fired_total",
                    labels={"rule": straggler_rule.name},
                    help="anomaly-rule firings (observe/history.py)")
        except Exception:
            pass
        try:
            from veles_tpu_torch.observe.flight import get_flight_recorder
            get_flight_recorder().note(
                "anomaly", rule=straggler_rule.name,
                series=straggler_rule.series, value=event["score"],
                slave=event["slave"], breach_since=event["since"])
        except Exception:
            pass
        return history.incidents.trigger(history, straggler_rule,
                                         firing, now=now)

    # -- views ------------------------------------------------------------
    def goodput_summary(self, wasted_s=0.0):
        """The fleet wall-time decomposition: cumulative component
        seconds + the goodput fraction (compute over everything,
        wasted included). ``wasted_s`` is the ledger's requeued
        in-flight seconds; rollback-discarded compute reported by
        control-plane clients adds on top."""
        wasted = float(wasted_s or 0.0) \
            + sum(self._rollback_ms.values()) / 1e3
        totals = self.totals
        spent = sum(totals.values()) + wasted
        fraction = totals["compute_s"] / spent if spent > 0 else 1.0
        return {
            "jobs": self.jobs_booked,
            "fraction": round(fraction, 4),
            "compute_s": round(totals["compute_s"], 3),
            "host_s": round(totals["host_s"], 3),
            "wire_s": round(totals["wire_s"], 3),
            "idle_s": round(totals["idle_s"], 3),
            "wasted_s": round(wasted, 3),
        }

    def straggler_summary(self):
        """The current persistent straggler, or None."""
        return dict(self.straggler) if self.straggler is not None \
            else None

    def clock_summary(self):
        """Per-process clock estimates keyed "mid:pid" (each carries
        the latest sid seen for that process)."""
        out = {}
        for proc, (sid, estimate) in list(self.clocks.items()):
            row = estimate.as_dict()
            row["slave"] = sid
            out[proc] = row
        return out

    def slave_stats(self, sid):
        """The fleet_status()/dashboard per-slave row extras, or None
        when the slave has no history yet."""
        window = self.windows.get(sid)
        if window is None or not window.n:
            return None
        stats = {"step_ms": round(window.median() * 1e3, 3),
                 "steps": window.n}
        score = self.scores.get(sid)
        if score is not None:
            stats["straggler_score"] = round(score, 3)
        return stats

    def span_rows(self):
        """The stored slave spans with their t0 mapped onto the master
        timeline (``t0_master``) via the per-process clock estimate."""
        out = []
        for span in list(self.spans):
            entry = self.clocks.get(span["proc"])
            row = dict(span)
            row["t0_master"] = (entry[1].to_master(span["t0"])
                                if entry is not None else span["t0"])
            out.append(row)
        return out


def ensure_fleet_rules(history):
    """Book the fleet anomaly rules into ``history`` (idempotent):
    ``fleet_straggler`` over ``veles_fleet_straggler_score`` (slave-
    labeled, so ``exclude_labels`` must not drop the slave slices) and
    ``fleet_goodput`` over ``veles_fleet_goodput_fraction`` (the
    reference breach the straggler's lead is measured against —
    ``REFERENCE_RULES`` in observe/history.py). Returns the pair."""
    from veles_tpu_torch.observe.history import AnomalyRule

    by_name = {rule.name: rule for rule in history.rules}
    straggler = by_name.get("fleet_straggler")
    if straggler is None:
        straggler = history.add_rule(AnomalyRule(
            "fleet_straggler", "veles_fleet_straggler_score",
            kind="threshold", op=">=", threshold=STRAGGLER_RATIO,
            for_samples=STRAGGLER_WINDOWS, exclude_labels=()))
        # detector-owned: the sampler thread must not evaluate (and
        # race) a rule whose state autopsy_tick writes per job — see
        # MetricHistory._check_rules
        straggler.external = True
    goodput = by_name.get("fleet_goodput")
    if goodput is None:
        goodput = history.add_rule(AnomalyRule(
            "fleet_goodput", "veles_fleet_goodput_fraction",
            kind="threshold", op="<=",
            threshold=GOODPUT_BREACH_FRACTION, for_samples=2))
        goodput.external = True
    return straggler, goodput


# -- trace assembly + the `observe fleet-trace` CLI -------------------------

def assemble_fleet_trace(payload):
    """A ``/debug/fleet`` payload -> one Perfetto-loadable Chrome trace
    dict: the master's flight-ring span events plus every shipped slave
    span (clock-aligned onto the master timeline), one process row per
    process with ``process_name`` metadata. Master ring entries whose
    span_id was ALSO shipped by a slave (same-host fleets share one
    ring) are dropped in favor of the shipped summary, so no span
    renders twice."""
    from veles_tpu_torch.observe.trace_export import chrome_trace

    master_pid = payload.get("master_pid", "?")
    names = {"master": "master (%s pid %s)"
                       % (payload.get("master_mid", "?"), master_pid)}
    slave_spans = [span for span in payload.get("slave_spans") or []
                   if isinstance(span, dict)]
    shipped = {span.get("span_id") for span in slave_spans
               if span.get("span_id")}
    events = []
    for entry in payload.get("master_spans") or []:
        if not isinstance(entry, dict) \
                or entry.get("span_id") in shipped:
            continue
        event = {key: value for key, value in entry.items()
                 if key not in ("kind", "t")}
        event["pid"] = "master"
        events.append(event)
    for span in slave_spans:
        proc = str(span.get("proc", "?"))
        names.setdefault(proc, "slave %s (%s)"
                               % (span.get("slave", "?"), proc))
        t0 = span.get("t0_master", span.get("t0"))
        if isinstance(t0, bool) or not isinstance(t0, (int, float)):
            continue
        base = {"name": span.get("name", "?"),
                "trace_id": span.get("trace_id"),
                "span_id": span.get("span_id"),
                "parent_id": span.get("parent_id"),
                "tid": span.get("tid", 0), "pid": proc,
                "slave": span.get("slave")}
        dur_s = max(0.0, float(span.get("dur_ms") or 0.0)) / 1e3
        if dur_s <= 0:
            events.append(dict(base, etype="single", mono=float(t0)))
        else:
            events.append(dict(base, etype="begin", mono=float(t0)))
            events.append(dict(base, etype="end",
                               mono=float(t0) + dur_s))
    return chrome_trace(events, process_names=names)


def render_fleet_summary(payload, trace):
    """The CLI's human summary of one assembled fleet trace."""
    lines = []
    events = trace.get("traceEvents", [])
    processes = [event for event in events
                 if event.get("ph") == "M"
                 and event.get("name") == "process_name"]
    lines.append("fleet trace: %d events across %d process row(s)"
                 % (sum(1 for e in events if e.get("ph") != "M"),
                    len(processes)))
    for proc, row in sorted((payload.get("clocks") or {}).items()):
        lines.append(
            "  clock %s (%s): offset %s ms ± %s ms over %s pair(s)"
            % (proc, row.get("slave", "?"), row.get("offset_ms", "?"),
               row.get("uncertainty_ms", "?"),
               row.get("samples", "?")))
    status = payload.get("status") or {}
    goodput = status.get("goodput")
    if isinstance(goodput, dict):
        lines.append(
            "  goodput %.1f%% over %s job(s): compute %ss · wire %ss "
            "· host %ss · idle %ss · wasted %ss"
            % (100.0 * (goodput.get("fraction") or 0.0),
               goodput.get("jobs", 0), goodput.get("compute_s", 0),
               goodput.get("wire_s", 0), goodput.get("host_s", 0),
               goodput.get("idle_s", 0), goodput.get("wasted_s", 0)))
    straggler = status.get("straggler")
    if isinstance(straggler, dict):
        lines.append(
            "  persistent straggler: %s at %.2fx the fleet median "
            "(%s ms vs %s ms, %s window(s))"
            % (straggler.get("slave", "?"),
               straggler.get("score", 0.0),
               straggler.get("step_ms", "?"),
               straggler.get("fleet_median_ms", "?"),
               straggler.get("windows", "?")))
    return "\n".join(lines)


def load_fleet_payload(path):
    """Load a saved ``/debug/fleet`` payload (or an artifact embedding
    one under ``"fleetscope"``); raises ValueError on anything else."""
    with open(path, "r") as fin:
        doc = json.load(fin)
    if isinstance(doc, dict) and isinstance(doc.get("fleetscope"),
                                            dict):
        doc = doc["fleetscope"]
    if not isinstance(doc, dict) or doc.get("kind") != "fleetscope":
        raise ValueError("%s is not a fleetscope payload (save "
                         "GET /debug/fleet from the fleet metrics "
                         "sidecar)" % path)
    return doc


def fleet_trace_main(artifact=None, live=None, output=None):
    """``veles_tpu_torch observe fleet-trace [ARTIFACT | --live URL]``:
    assemble the merged master+slave timeline into a Chrome trace JSON
    (open in ui.perfetto.dev) and print the clock/goodput/straggler
    summary. Returns 0, or 1 when the payload cannot be loaded."""
    if live:
        import urllib.request

        url = "%s/debug/fleet" % live.rstrip("/")
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                payload = json.loads(resp.read().decode())
        except Exception as exc:
            print("cannot fetch %s: %s" % (url, exc))
            return 1
        if not isinstance(payload, dict) \
                or payload.get("kind") != "fleetscope":
            print("%s did not return a fleetscope payload" % url)
            return 1
        default_out = "fleet.trace.json"
    else:
        try:
            payload = load_fleet_payload(artifact)
        except (OSError, ValueError) as exc:
            print("cannot load %s: %s" % (artifact, exc))
            return 1
        default_out = os.path.splitext(artifact)[0] + ".trace.json"
    trace = assemble_fleet_trace(payload)
    out = output or default_out
    with open(out, "w") as fout:
        json.dump(trace, fout)
    print(render_fleet_summary(payload, trace))
    print("wrote %s (open in ui.perfetto.dev)" % out)
    return 0
