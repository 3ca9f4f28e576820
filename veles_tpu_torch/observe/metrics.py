"""MetricsRegistry: the one telemetry plane for counters, gauges and
histograms.

The port's copy of ``veles_tpu/observe/metrics.py:31-582``: a pull-model
Prometheus surface. Every HTTP surface of the port (``GenerateAPI``,
``RESTfulAPI``) mounts ``/metrics`` off ``core/httpd.serve_metrics``,
and one scrape sees the whole process: the serving survival counters,
the decoder's dispatch and timing histograms, the loader's epoch
progress and the device truth (``observe/xla_stats.py``).

- **No hot-path cost while disabled**: the registry starts disabled;
  ``incr``/``set``/``observe`` return before touching the lock. Mounting
  ``/metrics`` enables it.
- **Bridges, not rewrites**: ``ServingHealth``,
  ``ContinuousDecoder.dispatch_counts``/``timings`` and the loaders stay
  the source of truth; :func:`bridge` registers a weakly referenced
  collector that re-publishes their state at scrape time. A dead source
  unregisters itself; a collector that raises is kept and reported once.
- **Valid exposition**: HELP/TYPE lines, label escaping, cumulative
  histogram buckets with ``+Inf``/``_sum``/``_count``, and OpenMetrics
  exemplars with ``# EOF`` when the scraper asks for them. For the same
  writes the text is the JAX package's byte for byte.

``publish_fleet`` re-publishes a fleet master's ``fleet_status()`` and
its slaves' piggybacked rows (``fleet/server.py``).
"""

import logging
import math
import re
import threading
import time
import weakref

#: valid exposition tokens (the Prometheus data model): metric names
#: and label names — label VALUES are escaped instead
METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default histogram buckets (seconds) — spans sub-ms host bookkeeping
#: to multi-second device dispatches
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)

COUNTER, GAUGE, HISTOGRAM = "counter", "gauge", "histogram"

#: OpenMetrics bound on an exemplar's label set: the total character
#: count of all label names + values must not exceed this (the spec's
#: 128-rune rule); oversized exemplars are DROPPED, never truncated
#: (a truncated trace id links to nothing)
EXEMPLAR_MAX_RUNES = 128


def _escape_help(text):
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value):
    return str(value).replace("\\", "\\\\").replace("\n", "\\n") \
        .replace('"', '\\"')


def _format_value(value):
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if isinstance(value, float) and math.isnan(value):
        return "NaN"
    if isinstance(value, float) and value == int(value) \
            and abs(value) < 1e15:
        return str(int(value))
    return repr(value) if isinstance(value, float) else str(value)


def _label_str(labels):
    if not labels:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (key, _escape_label(value))
        for key, value in labels)


class _Family:
    """One metric family: a kind, a help string and samples keyed by
    the sorted label tuple."""

    __slots__ = ("kind", "help", "samples", "buckets")

    def __init__(self, kind, help_text, buckets=None):
        self.kind = kind
        self.help = help_text or ""
        self.samples = {}
        self.buckets = buckets

    def hist_slot(self, key, buckets):
        slot = self.samples.get(key)
        if slot is None:
            slot = self.samples[key] = {
                "buckets": [0] * len(buckets), "sum": 0.0, "count": 0}
        return slot


class MetricsRegistry:
    """Thread-safe counter/gauge/histogram registry with Prometheus
    text exposition. All mutators take ``labels`` as a dict (order
    never matters — keys are sorted into the sample identity)."""

    def __init__(self, enabled=False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families = {}
        self._collectors = []
        self._collector_warned = set()

    # -- lifecycle --------------------------------------------------------
    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def reset(self):
        """Drop every family and collector (test isolation)."""
        with self._lock:
            self._families.clear()
            self._collectors[:] = []
            self._collector_warned.clear()

    # -- family plumbing --------------------------------------------------
    def _family(self, name, kind, help_text, buckets=None):
        """Get-or-create the family; returns None (caller drops the
        write) when ``name`` already exists under a DIFFERENT kind — a
        scalar sample landing in a histogram family (or vice versa)
        would poison every subsequent exposition."""
        family = self._families.get(name)
        if family is None:
            family = self._families[name] = _Family(kind, help_text,
                                                    buckets)
        elif family.kind != kind:
            return None
        return family

    @staticmethod
    def _key(labels):
        if not labels:
            return ()
        return tuple(sorted(labels.items()))

    # -- mutators (no-ops while disabled — not even the lock) -------------
    def incr(self, name, value=1, labels=None, help=None):
        """Add ``value`` to a counter sample."""
        if not self.enabled:
            return
        key = self._key(labels)
        with self._lock:
            family = self._family(name, COUNTER, help)
            if family is not None:
                family.samples[key] = family.samples.get(key, 0) + value

    def counter_set(self, name, value, labels=None, help=None):
        """Set a counter sample to an ABSOLUTE cumulative value — the
        bridge mode: the source (ServingHealth, dispatch_counts, the
        ledger) already keeps the cumulative tally."""
        if not self.enabled:
            return
        with self._lock:
            family = self._family(name, COUNTER, help)
            if family is not None:
                family.samples[self._key(labels)] = value

    def set(self, name, value, labels=None, help=None):
        """Set a gauge sample."""
        if not self.enabled:
            return
        with self._lock:
            family = self._family(name, GAUGE, help)
            if family is not None:
                family.samples[self._key(labels)] = value

    def set_gauge_family(self, name, rows, help=None):
        """Atomically REPLACE a gauge family's whole sample set with
        ``rows`` (``[(labels_dict, value)]``) — the publisher mode for
        windowed sources (the SLO engine): a series the source no
        longer reports must STOP being exported, not freeze at its
        last value forever. An empty ``rows`` retires the family."""
        if not self.enabled:
            return
        with self._lock:
            family = self._family(name, GAUGE, help)
            if family is None:
                return
            family.samples = {self._key(labels): value
                              for labels, value in rows}
            if not family.samples:
                del self._families[name]

    @staticmethod
    def _valid_exemplar(exemplar):
        """Validate an exemplar label dict (OpenMetrics rules): valid
        label names, never ``le``, total runes bounded. Returns the
        sorted label tuple or None (drop — an invalid exemplar must
        never drop the OBSERVATION it rides)."""
        if not isinstance(exemplar, dict) or not exemplar:
            return None
        runes = 0
        pairs = []
        for key in sorted(exemplar):
            value = str(exemplar[key])
            if not isinstance(key, str) or not LABEL_NAME_RE.match(key) \
                    or key == "le":
                return None
            runes += len(key) + len(value)
            pairs.append((key, value))
        if runes > EXEMPLAR_MAX_RUNES:
            return None
        return tuple(pairs)

    def observe(self, name, value, labels=None, buckets=None, help=None,
                exemplar=None):
        """Record one observation into a fixed-bucket histogram.
        ``buckets`` binds on first use of the family and is immutable
        after (Prometheus semantics: bucket layout is part of the
        family identity). ``exemplar`` optionally attaches an
        OpenMetrics exemplar label dict (e.g. ``{"trace_id": ...}``) to
        the bucket this observation lands in — kept latest-wins per
        bucket, exposed ONLY on openmetrics-negotiated scrapes
        (:meth:`expose` with ``openmetrics=True``) so plain Prometheus
        text scrapes stay parseable."""
        if not self.enabled:
            return
        with self._lock:
            family = self._family(
                name, HISTOGRAM, help,
                tuple(buckets) if buckets else DEFAULT_BUCKETS)
            if family is None:
                return
            slot = family.hist_slot(self._key(labels), family.buckets)
            index = len(family.buckets)  # the +Inf bucket
            for i, bound in enumerate(family.buckets):
                if value <= bound:
                    slot["buckets"][i] += 1
                    index = i
                    break
            slot["sum"] += value
            slot["count"] += 1
            if exemplar is not None:
                pairs = self._valid_exemplar(exemplar)
                if pairs is not None:
                    slot.setdefault("exemplars", {})[index] = (
                        pairs, float(value), time.time())

    # -- collectors -------------------------------------------------------
    def add_collector(self, fn):
        """Register a zero-arg callable invoked at every scrape (before
        formatting); it re-publishes source state via
        ``counter_set``/``set``/``observe``. Exceptions are swallowed
        (warned once per collector) so a broken bridge can never break
        the whole exposition."""
        with self._lock:
            self._collectors.append(fn)
        return fn

    def prune_label(self, label, keep):
        """Drop every counter/gauge sample carrying label ``label``
        with a value NOT in ``keep`` — how the fleet bridge retires a
        departed slave's re-exported series instead of advertising its
        last counters forever (and how slave churn stays bounded)."""
        keep = set(keep)
        with self._lock:
            for name, family in list(self._families.items()):
                if family.kind == HISTOGRAM:
                    continue
                for key in [k for k in family.samples
                            for lk, lv in k
                            if lk == label and lv not in keep]:
                    family.samples.pop(key, None)
                if not family.samples:
                    # a fully-pruned family must not keep advertising
                    # its HELP/TYPE header forever
                    del self._families[name]

    def remove_collector(self, fn):
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)
            self._collector_warned.discard(id(fn))

    def _run_collectors(self):
        with self._lock:
            collectors = list(self._collectors)
        dead = []
        for fn in collectors:
            try:
                if fn() is _DEAD:
                    dead.append(fn)
            except Exception:
                with self._lock:
                    warn = id(fn) not in self._collector_warned
                    self._collector_warned.add(id(fn))
                if warn:
                    logging.getLogger("MetricsRegistry").exception(
                        "metrics collector failed (kept; reported once)")
        for fn in dead:
            self.remove_collector(fn)

    def sample(self):
        """Collector-run snapshot WITHOUT rendering exposition text:
        ``[(name, kind, labels_tuple, value)]`` for every counter and
        gauge, plus each histogram's ``_count``/``_sum`` synthesized as
        counter rows (so a sampler can track observation rates).
        Collector-backed series (``veles_kernel_*``,
        ``veles_device_*``), which otherwise materialize only inside a
        scrape, are refreshed first — the feed of the metric-history
        sampler (``observe/history.py``). Disabled:
        returns an empty tuple before touching the lock or the
        collectors, so the no-scrape fast path stays allocation-free."""
        if not self.enabled:
            return ()
        self._run_collectors()
        out = []
        with self._lock:
            for name, family in self._families.items():
                if family.kind == HISTOGRAM:
                    for key, slot in family.samples.items():
                        out.append((name + "_count", COUNTER, key,
                                    slot["count"]))
                        out.append((name + "_sum", COUNTER, key,
                                    slot["sum"]))
                else:
                    for key, value in family.samples.items():
                        out.append((name, family.kind, key, value))
        return out

    def snapshot(self):
        """Flat counter/gauge snapshot ``[(name, kind, labels, value)]``
        — the piggyback payload a fleet slave rides on its update
        frames so the master's ``/metrics`` can re-export the whole
        fleet with a ``slave`` label (histograms stay local: their
        bucket layout does not merge across processes)."""
        self._run_collectors()
        out = []
        with self._lock:
            for name, family in sorted(self._families.items()):
                if family.kind == HISTOGRAM:
                    continue
                for key, value in sorted(family.samples.items()):
                    # fully list-shaped: the row rides fleet frames
                    # through whichever wire codec is configured
                    out.append([name, family.kind,
                                [[k, v] for k, v in key], value])
        return out

    # -- exposition -------------------------------------------------------
    @staticmethod
    def _exemplar_str(slot, index):
        """The OpenMetrics exemplar suffix for bucket ``index`` (or ""):
        `` # {label="value"} observed_value timestamp``."""
        entry = (slot.get("exemplars") or {}).get(index)
        if entry is None:
            return ""
        pairs, value, stamp = entry
        return " # {%s} %s %s" % (
            ",".join('%s="%s"' % (k, _escape_label(v))
                     for k, v in pairs),
            _format_value(value), _format_value(round(stamp, 3)))

    def expose(self, openmetrics=False):
        """The Prometheus text exposition (format version 0.0.4).
        ``openmetrics=True`` (Accept-header negotiated by
        ``core/httpd.serve_metrics``) additionally renders histogram
        bucket exemplars and the ``# EOF`` terminator — the gate that
        keeps plain-Prometheus scrapes parseable."""
        self._run_collectors()
        lines = []
        with self._lock:
            for name, family in sorted(self._families.items()):
                # OpenMetrics names counter FAMILIES without the
                # _total sample suffix — a negotiated scrape with the
                # 0.0.4 spelling would fail to parse on a modern
                # Prometheus (which advertises openmetrics by default)
                family_name = (name[:-len("_total")]
                               if openmetrics and family.kind == COUNTER
                               and name.endswith("_total") else name)
                if family.help:
                    lines.append("# HELP %s %s"
                                 % (family_name,
                                    _escape_help(family.help)))
                lines.append("# TYPE %s %s" % (family_name, family.kind))
                if family.kind == HISTOGRAM:
                    for key, slot in sorted(family.samples.items()):
                        cum = 0
                        for i, (bound, n) in enumerate(
                                zip(family.buckets, slot["buckets"])):
                            cum += n
                            labels = list(key) + [
                                ("le", _format_value(float(bound)))]
                            lines.append("%s_bucket%s %d%s" % (
                                name, _label_str(labels), cum,
                                self._exemplar_str(slot, i)
                                if openmetrics else ""))
                        labels = list(key) + [("le", "+Inf")]
                        lines.append("%s_bucket%s %d%s" % (
                            name, _label_str(labels), slot["count"],
                            self._exemplar_str(slot, len(family.buckets))
                            if openmetrics else ""))
                        lines.append("%s_sum%s %s" % (
                            name, _label_str(list(key)),
                            _format_value(slot["sum"])))
                        lines.append("%s_count%s %d" % (
                            name, _label_str(list(key)), slot["count"]))
                else:
                    for key, value in sorted(family.samples.items()):
                        lines.append("%s%s %s" % (
                            name, _label_str(list(key)),
                            _format_value(value)))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


#: sentinel a weak bridge returns when its source was collected
_DEAD = object()


def bridge(registry, source, publish):
    """Register a weakly-referenced collector: at scrape time,
    ``publish(registry, source)`` re-publishes the live object's state;
    once ``source`` is garbage-collected the collector unregisters
    itself. Returns the collector (for explicit removal)."""
    ref = weakref.ref(source)

    def collect():
        live = ref()
        if live is None:
            return _DEAD
        publish(registry, live)

    registry.add_collector(collect)
    return collect


# -- the process-global registry ------------------------------------------

_registry = MetricsRegistry(enabled=False)


def get_metrics_registry():
    return _registry


# -- bridge publishers for the existing state holders ----------------------

def publish_serving_health(registry, health):
    """ServingHealth.snapshot() -> veles_serving_* families."""
    snap = health.snapshot()
    name = snap.get("name", "serving")
    registry.set("veles_serving_ready", int(bool(snap.get("ready"))),
                 labels={"api": name},
                 help="1 while the unit can take traffic (/readyz)")
    registry.set("veles_serving_breaker_open",
                 int(snap.get("breaker") != "closed"),
                 labels={"api": name},
                 help="1 while the circuit breaker is open")
    registry.set("veles_serving_inflight", snap.get("inflight", 0),
                 labels={"api": name},
                 help="admitted requests not yet resolved")
    for key, value in (snap.get("counters") or {}).items():
        registry.counter_set(
            "veles_serving_requests_total", value,
            labels={"api": name, "outcome": key},
            help="request outcomes by admission/resolution class")
    for kind, entry in (snap.get("latency_ms") or {}).items():
        if not isinstance(entry, dict) or not entry.get("count"):
            continue
        for quantile in ("p50", "p95"):
            if entry.get(quantile) is not None:
                registry.set(
                    "veles_serving_latency_ms", entry[quantile],
                    labels={"api": name, "kind": kind,
                            "quantile": quantile},
                    help="rolling-window serving latency percentiles")


def publish_decoder(registry, decoder):
    """ContinuousDecoder dispatch/timing state -> veles_decode_*."""
    for kind, value in decoder.dispatch_counts.items():
        registry.counter_set(
            "veles_decode_dispatches_total", value,
            labels={"kind": kind},
            help="dispatches on the slot path by call family")
    for phase, seconds in decoder.timings.items():
        registry.counter_set(
            "veles_decode_host_seconds_total", seconds,
            labels={"phase": phase.replace("_s", "")},
            help="host-blocking wall seconds per slot call family")
    registry.set("veles_decode_slots_free", len(decoder._free),
                 help="slot-pool lanes currently free")
    registry.set("veles_decode_queue_depth", len(decoder._queue),
                 help="submitted prompts not yet admitted into a slot")
    registry.counter_set("veles_decode_tokens_total",
                         decoder.tokens_out,
                         help="tokens generated on the slot path")
    registry.counter_set("veles_decode_cancelled_total",
                         decoder.cancelled,
                         help="requests cancelled before completion")
    pool = getattr(decoder, "pool", None)
    if pool is not None:
        publish_kv_pool(registry, pool)
    tp_stats = getattr(decoder, "tp_stats", None)
    stats = tp_stats() if tp_stats is not None else None
    if stats is not None:
        publish_tp(registry, stats)


def publish_tp(registry, stats):
    """A serving mesh's costs on rank 0 (``ContinuousDecoder.tp_stats``)
    -> ``veles_tp_*``: the hand-offs to the other ranks by op (calls,
    pickled bytes) with their seconds, and the collectives that complete
    the sharded products by kind (calls, operand bytes, wall seconds)."""
    handoff = stats["handoff"]
    for op, calls in handoff["calls"].items():
        registry.counter_set("veles_tp_handoff_calls_total", calls,
                             labels={"op": op},
                             help="device calls and events handed on to "
                             "the serving mesh's other ranks")
        registry.counter_set("veles_tp_handoff_bytes_total",
                             handoff["bytes"].get(op, 0), labels={"op": op},
                             help="bytes handed on to the serving mesh's "
                             "other ranks")
    registry.counter_set("veles_tp_handoff_seconds_total",
                         handoff["seconds"],
                         help="wall seconds rank 0 spent handing calls on")
    for kind, (calls, nbytes, seconds) in stats["collectives"].items():
        labels = {"kind": kind}
        registry.counter_set("veles_tp_collective_calls_total", calls,
                             labels=labels,
                             help="tensor-parallel collectives on rank 0")
        registry.counter_set("veles_tp_collective_bytes_total", nbytes,
                             labels=labels,
                             help="operand bytes of rank 0's collectives")
        registry.counter_set("veles_tp_collective_seconds_total", seconds,
                             labels=labels,
                             help="wall seconds of rank 0's collectives")


def publish_kv_pool(registry, pool):
    """PagePool occupancy + prefix-cache traffic -> veles_kv_* /
    veles_prefix_cache_*. Rides every /metrics mount through
    :func:`publish_decoder`."""
    snap = pool.snapshot()
    registry.set("veles_kv_pages_used", snap["pages_used"],
                 help="allocated pages in the paged KV pool")
    registry.set("veles_kv_pages_free", snap["pages_free"],
                 help="free pages in the paged KV pool")
    registry.set("veles_kv_pages_reserved", snap["reserved_pages"],
                 help="pages reserved by admitted in-flight requests")
    registry.set("veles_kv_page_size", snap["page_size"],
                 help="positions per KV page")
    registry.set("veles_prefix_cache_entries", snap["prefix_entries"],
                 help="live prefix-cache entries (page-boundary "
                 "prefixes)")
    for key in ("hits", "misses", "evictions"):
        registry.counter_set(
            "veles_prefix_cache_%s_total" % key,
            snap["prefix_" + key],
            help="prefix-cache %s across decoder rebuilds" % key)


def publish_loader(registry, loader):
    """Loader epoch progress -> veles_loader_*."""
    registry.set("veles_loader_epoch", loader.epoch_number,
                 labels={"loader": loader.name},
                 help="current epoch number")
    registry.counter_set("veles_loader_samples_served_total",
                         loader.samples_served,
                         labels={"loader": loader.name},
                         help="samples served across all epochs")
    registry.set("veles_loader_total_samples", loader.total_samples,
                 labels={"loader": loader.name},
                 help="dataset size across the three splits")


def publish_fleet(registry, server):
    """Server.fleet_status() + per-slave piggybacked metric snapshots
    -> veles_fleet_* (the master's /metrics aggregates the fleet)."""
    status = server.fleet_status()
    registry.set("veles_fleet_slaves", len(status.get("slaves", [])),
                 help="slaves currently connected")
    registry.set("veles_fleet_queued_jobs", status.get("queued_jobs", 0),
                 help="backpressured job requests waiting")
    ledger = status.get("ledger") or {}
    for key in ("issued", "done", "requeued"):
        if key in ledger:
            registry.counter_set("veles_fleet_jobs_total", ledger[key],
                                 labels={"state": key},
                                 help="job-ledger lifecycle tallies")
    fenced = ledger.get("fenced")
    if isinstance(fenced, dict):
        for verdict, count in fenced.items():
            registry.counter_set("veles_fleet_fenced_total", count,
                                 labels={"verdict": str(verdict)},
                                 help="updates rejected by the fence")
    elif ledger.get("fenced_total") is not None:
        registry.counter_set("veles_fleet_fenced_total",
                             ledger["fenced_total"],
                             labels={"verdict": "all"},
                             help="updates rejected by the fence")
    for row in status.get("slaves", []):
        sid = str(row.get("id"))
        registry.counter_set("veles_fleet_slave_jobs_done_total",
                             row.get("jobs_done", 0),
                             labels={"slave": sid},
                             help="jobs completed per connected slave")
        registry.set("veles_fleet_slave_power", row.get("power", 0.0),
                     labels={"slave": sid},
                     help="reported computing power per slave")
        if isinstance(row.get("step_ms"), (int, float)):
            registry.set("veles_fleet_slave_step_ms", row["step_ms"],
                         labels={"slave": sid},
                         help="median per-job step time per slave "
                              "(observe/fleetscope.py StepWindow)")
        if isinstance(row.get("straggler_score"), (int, float)):
            registry.set("veles_fleet_straggler_score",
                         row["straggler_score"],
                         labels={"slave": sid},
                         help="per-slave median step time over the "
                              "fleet median (persistent straggler at "
                              ">= 1.75x for 3 windows — "
                              "observe/fleetscope.py)")
    # fleet goodput decomposition + clock alignment
    # (observe/fleetscope.py; docs/observability.md "Fleet timeline +
    # goodput")
    goodput = status.get("goodput")
    if isinstance(goodput, dict):
        registry.set("veles_fleet_goodput_fraction",
                     goodput.get("fraction", 1.0),
                     help="share of accounted fleet wall time spent "
                          "in slave compute (higher is better)")
        for component in ("compute", "wire", "host", "idle", "wasted"):
            value = goodput.get(component + "_s")
            if isinstance(value, (int, float)):
                registry.counter_set(
                    "veles_fleet_goodput_seconds_total", value,
                    labels={"component": component},
                    help="fleet wall-time decomposition by component "
                         "(compute/wire/host/idle/wasted)")
    for proc, row in sorted((status.get("clock") or {}).items()):
        if not isinstance(row, dict):
            continue
        sid = str(row.get("slave", proc))
        if isinstance(row.get("offset_ms"), (int, float)):
            registry.set("veles_fleet_clock_offset_ms",
                         row["offset_ms"], labels={"slave": sid},
                         help="estimated slave-clock offset vs the "
                              "master timeline (NTP-style from "
                              "job/update stamp pairs)")
        if isinstance(row.get("uncertainty_ms"), (int, float)):
            registry.set("veles_fleet_clock_uncertainty_ms",
                         row["uncertainty_ms"], labels={"slave": sid},
                         help="clock-offset uncertainty bound (half "
                              "the best filtered wire round trip)")
    # re-export each slave's piggybacked counter/gauge snapshot under
    # its slave id — one scrape of the master sees the whole fleet
    slave_rows = server.slave_metrics()
    for sid, rows in slave_rows.items():
        for name, kind, labels, value in rows:
            merged = dict(labels)
            merged["slave"] = sid
            if kind == COUNTER:
                registry.counter_set(name, value, labels=merged)
            else:
                registry.set(name, value, labels=merged)
    # retire series of slaves no longer in the roster: a departed or
    # respawned-under-a-new-sid slave must not advertise its last
    # counters forever, and churn must not grow the exposition
    live = set(slave_rows) | {str(row.get("id"))
                              for row in status.get("slaves", [])}
    registry.prune_label("slave", live)
