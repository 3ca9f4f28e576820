"""Metric flight recorder: embedded time-series history and incident
autopsy.

The port of ``veles_tpu/observe/history.py``: a bounded, lock-free
in-process time-series store that samples the whole registry (the
collector-backed series included: ``MetricsRegistry.sample()`` runs the
collectors) into per-series rings, and the layers on top:

- :class:`MetricHistory`: per-series bounded rings (drop-oldest),
  counters stored as rates per second, a hard cap on the series count
  with an overflow tally. No lock: GIL-atomic container operations, and
  a cooperative ``_busy`` flag against concurrent samplers.
- the anomaly rules (:class:`AnomalyRule`): threshold for N samples,
  slope and drop against a baseline, over any series. The seed rules
  (:func:`default_rules`) watch SLO burn, the tpot/ttft p95 slopes, an
  MFU collapse, the pool's exhaustion trend and rebuild storms, each
  series mapped to the family the port publishes
  (``xla_stats.DIFFERING_FAMILIES``: the JAX package's
  ``veles_xla_recompile_storms_total`` is the port's
  ``veles_kernel_rebuild_storms_total``). Firings book
  ``veles_anomaly_*`` counters and flight-ring entries and trigger an
  incident artifact.
- :class:`IncidentRecorder`: one JSON bundle per incident (cooldown
  bounded) with the breach window's history, the request ledger's rows,
  the flight ring's tail and the overlapping kernel builds, written
  atomically; it names the leading indicator: which rule's series
  breached first and by how long it led the user-visible SLO breach.
- surfaces: ``GET /debug/history`` (``core/httpd.serve_debug_history``,
  ``?series=&window=``) and ``python -m veles_tpu_torch observe incident
  PATH | --live URL`` (:func:`incident_main`). :meth:`MetricHistory.
  fleet_summary` and :meth:`MetricHistory.ingest_summary` are ported, and
  the fleet carries the rows as the JAX package's does: a slave's update
  frames (``fleet/client.py``) and the master's slave-labelled series
  (``fleet/server.py``).

Configuration: ``root.common.observe.history`` (a config subtree or a
``key=value,...`` string: the ``--serve-history`` flag). Unset means on
wherever ``/metrics`` is mounted, at :data:`DEFAULT_INTERVAL_S`;
``enabled=0`` or ``off`` disables it. The sampler thread starts with the
first serving front (``core/httpd.enable_metrics``) and stops when the
last front that started it stops (:func:`release_history_sampler`), or
at interpreter exit. It only reads: the collectors may call
``torch.cuda.memory_stats`` and ``mem_get_info``, never synchronize.
"""

import collections
import json
import logging
import os
import threading
import time
import weakref

#: default sampler cadence (seconds)
DEFAULT_INTERVAL_S = 1.0

#: default per-series ring capacity (samples) — 4 minutes at 1 Hz
DEFAULT_CAPACITY = 240

#: hard cap on distinct series; past it NEW series are counted into
#: ``series_dropped`` and discarded — a hostile label set cannot
#: balloon memory
DEFAULT_SERIES_CAP = 1024

#: incident artifact schema version (bump on breaking layout changes)
INCIDENT_SCHEMA = 1

#: default pause between incident artifacts (seconds) — one bundle per
#: burst, not one per firing sample
DEFAULT_INCIDENT_COOLDOWN_S = 60.0

#: fleet piggyback bounds: rows per frame, points per row — an update
#: frame must stay small beside the job traffic it rides
FLEET_MAX_SERIES = 64
FLEET_MAX_POINTS = 32

#: series prefixes worth shipping to the master / showing on the
#: dashboard (the trend set an on-call scans first)
SUMMARY_PREFIXES = ("veles_ctrl_", "veles_slo_", "veles_serving_",
                    "veles_serve_", "veles_kv_", "veles_anomaly_",
                    "veles_mfu_ratio", "veles_governor_",
                    "veles_fleet_goodput", "veles_fleet_straggler",
                    "veles_hbm_", "veles_headroom_")

#: rules that stand in for "the user-visible breach" when computing an
#: incident's leading-indicator lead time: SLO burn for serving,
#: goodput collapse for the fleet (observe/fleetscope.py)
REFERENCE_RULES = ("slo_burn", "ctrl_burn", "fleet_goodput")

#: unicode sparkline ramp (web-status cells + the incident CLI)
SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values, width=32):
    """Render the tail of ``values`` as a unicode sparkline (empty for
    no data; a flat series renders at the floor block)."""
    vals = [float(v) for v in list(values)[-int(width):]]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return SPARK_BLOCKS[0] * len(vals)
    top = len(SPARK_BLOCKS) - 1
    return "".join(SPARK_BLOCKS[int((v - lo) / (hi - lo) * top)]
                   for v in vals)


def _parse_bool(value, key, flag):
    if isinstance(value, bool):
        return value
    text = str(value).strip().lower()
    if text in ("1", "true", "yes", "on"):
        return True
    if text in ("0", "false", "no", "off"):
        return False
    raise ValueError("%s: %s needs a boolean, got %r" % (flag, key, value))


class HistoryConfig:
    """Validated history knobs. Errors name ``flag`` so a CLI
    misconfiguration reads as the flag's fault."""

    KEYS = ("enabled", "interval_s", "capacity", "series_cap",
            "seed_rules", "incident_cooldown_s")

    def __init__(self, interval_s=DEFAULT_INTERVAL_S,
                 capacity=DEFAULT_CAPACITY,
                 series_cap=DEFAULT_SERIES_CAP, seed_rules=True,
                 incident_cooldown_s=DEFAULT_INCIDENT_COOLDOWN_S,
                 flag="root.common.observe.history"):
        self.interval_s = float(interval_s)
        if self.interval_s <= 0:
            raise ValueError("%s: interval_s must be > 0, got %r"
                             % (flag, interval_s))
        self.capacity = int(capacity)
        if self.capacity < 2:
            raise ValueError("%s: capacity must be >= 2, got %r"
                             % (flag, capacity))
        self.series_cap = int(series_cap)
        if self.series_cap < 1:
            raise ValueError("%s: series_cap must be >= 1, got %r"
                             % (flag, series_cap))
        self.seed_rules = _parse_bool(seed_rules, "seed_rules", flag)
        self.incident_cooldown_s = float(incident_cooldown_s)
        if self.incident_cooldown_s < 0:
            raise ValueError("%s: incident_cooldown_s must be >= 0, "
                             "got %r" % (flag, incident_cooldown_s))


def parse_history_spec(spec, flag="root.common.observe.history"):
    """Parse the history config: None/unset means the DEFAULT config
    (history is on wherever /metrics is mounted); a dict (config
    subtree) or ``key=value[,key=value...]`` string tunes it; the
    literal ``off``/``false``/``0`` or ``enabled=0`` disables (returns
    None). Unknown keys and invalid values raise naming ``flag``."""
    if spec is None:
        return HistoryConfig(flag=flag)
    if hasattr(spec, "__content__"):
        spec = spec.__content__()
    if isinstance(spec, bool):
        return HistoryConfig(flag=flag) if spec else None
    if isinstance(spec, str):
        text = spec.strip()
        if text.lower() in ("", "on", "1", "true", "default"):
            return HistoryConfig(flag=flag)
        if text.lower() in ("off", "0", "false", "no"):
            return None
        parsed = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, value = part.partition("=")
            if not sep:
                raise ValueError("%s: %r is not key=value" % (flag, part))
            parsed[key.strip()] = value.strip()
        spec = parsed
    if not isinstance(spec, dict):
        raise ValueError("%s must be a dict or 'key=value,...' string, "
                         "got %r" % (flag, type(spec).__name__))
    spec = dict(spec)
    for key in spec:
        if key not in HistoryConfig.KEYS:
            raise ValueError("%s: unknown key %r (supported: %s)"
                             % (flag, key,
                                ", ".join(HistoryConfig.KEYS)))
    if not _parse_bool(spec.pop("enabled", True), "enabled", flag):
        return None
    for key in ("interval_s", "incident_cooldown_s"):
        if key in spec:
            try:
                spec[key] = float(spec[key])
            except (TypeError, ValueError):
                raise ValueError("%s: %s needs a number, got %r"
                                 % (flag, key, spec[key]))
    for key in ("capacity", "series_cap"):
        if key in spec:
            try:
                spec[key] = int(spec[key])
            except (TypeError, ValueError):
                raise ValueError("%s: %s needs an integer, got %r"
                                 % (flag, key, spec[key]))
    return HistoryConfig(flag=flag, **spec)


class _Series:
    """One metric series' bounded ring. Counters store RATES (delta
    over the sample gap, per second); gauges store raw values."""

    __slots__ = ("name", "kind", "labels", "stamps", "values",
                 "last_raw", "last_mono", "seen")

    def __init__(self, name, kind, labels, capacity):
        self.name = name
        self.kind = kind
        self.labels = tuple(labels)
        self.stamps = collections.deque(maxlen=capacity)
        self.values = collections.deque(maxlen=capacity)
        self.last_raw = None
        self.last_mono = None
        #: the sample pass this series last appeared in — freshness
        #: gate for reads (a retired gauge family must stop answering)
        self.seen = -1

    def label_dict(self):
        return {k: v for k, v in self.labels}

    def push(self, now, value, pass_index, anchor=None):
        """Ingest one raw sample; counters convert to a per-second
        rate (resets re-baseline without emitting a point). ``anchor``
        (the previous sample pass's instant) lets a counter FIRST SEEN
        mid-flight rate against an implicit 0 at the prior pass — the
        first recompile storm must register as a spike, not vanish
        into a baseline; the history's very first pass anchors nothing,
        so attaching to a long-lived process books baselines only."""
        self.seen = pass_index
        if self.kind == "counter":
            last_raw, last_mono = self.last_raw, self.last_mono
            self.last_raw, self.last_mono = value, now
            if last_raw is None or last_mono is None:
                if anchor is None or anchor >= now or value < 0:
                    return
                last_raw, last_mono = 0, anchor
            dt = now - last_mono
            if dt <= 1e-6 or value < last_raw:
                return  # double-sample jitter / counter reset
            value = (value - last_raw) / dt
        self.stamps.append(now)
        self.values.append(float(value))

    def window(self, seconds=None, now=None):
        """(stamps, values) tail covering the last ``seconds`` (all
        points when None)."""
        stamps, values = list(self.stamps), list(self.values)
        if seconds is None or not stamps:
            return stamps, values
        horizon = (now if now is not None else stamps[-1]) - seconds
        start = 0
        while start < len(stamps) and stamps[start] < horizon:
            start += 1
        return stamps[start:], values[start:]


# -- the anomaly rule engine -------------------------------------------------

#: supported predicate kinds
RULE_KINDS = ("threshold", "slope", "drop")

_OPS = {">=": lambda a, b: a >= b, "<=": lambda a, b: a <= b}


class AnomalyRule:
    """One declarative anomaly predicate over matching series.

    - ``threshold``: latest value ``op`` ``threshold`` for
      ``for_samples`` consecutive samples;
    - ``slope``: least-squares per-second slope over the trailing
      ``window_s`` ``op`` ``threshold`` (needs >= 3 points), for
      ``for_samples`` samples;
    - ``drop``: the trailing ``window_s`` mean has fallen below
      ``(1 - drop_frac)`` of the preceding ``baseline_s`` mean, for
      ``for_samples`` samples (the MFU-collapse shape).

    ``match`` restricts by label subset; ``exclude_labels`` skips
    series CARRYING a label name (tenant/slave slices must not page the
    aggregate rule). State (streak, breach instant, firing tally) lives
    on the rule; evaluation runs on the sampler cadence, never a hot
    path."""

    def __init__(self, name, series, kind="threshold", op=">=",
                 threshold=0.0, for_samples=3, window_s=30.0,
                 baseline_s=120.0, drop_frac=0.5, cooldown_s=30.0,
                 match=None, exclude_labels=("tenant", "slave")):
        if kind not in RULE_KINDS:
            raise ValueError("anomaly rule %r: unknown kind %r "
                             "(supported: %s)"
                             % (name, kind, ", ".join(RULE_KINDS)))
        if op not in _OPS:
            raise ValueError("anomaly rule %r: unknown op %r "
                             "(supported: >=, <=)" % (name, op))
        self.name = name
        self.series = series
        self.kind = kind
        self.op = op
        self.threshold = float(threshold)
        self.for_samples = max(1, int(for_samples))
        self.window_s = float(window_s)
        self.baseline_s = float(baseline_s)
        self.drop_frac = float(drop_frac)
        if not 0 < self.drop_frac <= 1:
            raise ValueError("anomaly rule %r: drop_frac must be in "
                             "(0, 1], got %r" % (name, drop_frac))
        self.cooldown_s = float(cooldown_s)
        self.match = dict(match or {})
        self.exclude_labels = tuple(exclude_labels or ())
        # -- evaluation state --
        self.streak = 0
        self.breach_since = None     # mono of the streak's first breach
        self.breach_value = None     # worst observed value this streak
        self.breach_labels = None    # labels of the breaching series
        self.last_value = None
        self.last_fired = None
        self.fired_total = 0

    def matches(self, series):
        if series.name != self.series:
            return False
        labels = series.label_dict()
        for key in self.exclude_labels:
            if key in labels:
                return False
        for key, value in self.match.items():
            if labels.get(key) != value:
                return False
        return True

    def _measure(self, series, now):
        """The rule's scalar for one series at ``now`` (None = not
        enough data)."""
        if self.kind == "threshold":
            return series.values[-1] if series.values else None
        if self.kind == "slope":
            stamps, values = series.window(self.window_s, now=now)
            if len(values) < 3:
                return None
            t0 = stamps[0]
            xs = [t - t0 for t in stamps]
            n = float(len(xs))
            mx = sum(xs) / n
            my = sum(values) / n
            var = sum((x - mx) ** 2 for x in xs)
            if var <= 1e-12:
                return None
            return sum((x - mx) * (y - my)
                       for x, y in zip(xs, values)) / var
        # drop-vs-baseline: compare window means
        stamps, values = series.window(
            self.window_s + self.baseline_s, now=now)
        if len(values) < 4:
            return None
        split = now - self.window_s
        base = [v for t, v in zip(stamps, values) if t < split]
        head = [v for t, v in zip(stamps, values) if t >= split]
        if not base or not head:
            return None
        baseline = sum(base) / len(base)
        if baseline <= 0:
            return None
        return sum(head) / len(head) / baseline

    def _breaches(self, value):
        if self.kind == "drop":
            return value <= (1.0 - self.drop_frac)
        return _OPS[self.op](value, self.threshold)

    def _severity(self, value):
        """Direction-aware badness (higher = worse): drop ratios and
        ``<=`` rules breach DOWNWARD, so their worst value is the
        lowest one."""
        if self.kind == "drop" or self.op == "<=":
            return -value
        return value

    def evaluate(self, history, now):
        """One pass over the matching series; returns a firing dict
        when the streak crosses ``for_samples`` (cooldown-limited),
        else None. Series not seen in the latest sample pass are
        skipped — a retired gauge family must stop driving the rule."""
        worst = None       # (severity, value, labels) among breaching
        observed = None    # (severity, value) across every match
        for series in history.matching(self, now=now):
            value = self._measure(series, now)
            if value is None:
                continue
            severity = self._severity(value)
            if observed is None or severity > observed[0]:
                observed = (severity, value)
            if self._breaches(value) and (
                    worst is None or severity > worst[0]):
                worst = (severity, value, series.labels)
        if observed is not None:
            # the worst MEASURED value, so a breaching rule's state
            # never displays a healthy sibling series' number
            self.last_value = observed[1]
        if worst is None:
            self.streak = 0
            self.breach_since = None
            self.breach_value = None
            self.breach_labels = None
            return None
        _, value, labels = worst
        self.streak += 1
        if self.breach_since is None:
            self.breach_since = now
        if self.breach_value is None or self._severity(value) \
                > self._severity(self.breach_value):
            self.breach_value = value
            self.breach_labels = labels
        if self.streak < self.for_samples:
            return None
        if self.last_fired is not None \
                and now - self.last_fired < self.cooldown_s:
            return None
        self.last_fired = now
        self.fired_total += 1
        return {"rule": self.name, "series": self.series,
                "kind": self.kind, "value": round(float(value), 6),
                "labels": [list(kv) for kv in (labels or ())],
                "breach_since": self.breach_since, "mono": now}

    def state(self):
        """The /debug/history + incident view of this rule."""
        return {"name": self.name, "series": self.series,
                "kind": self.kind, "op": self.op,
                "threshold": self.threshold,
                "for_samples": self.for_samples,
                "streak": self.streak,
                "breach_since": self.breach_since,
                "breach_value": self.breach_value,
                "last_value": self.last_value,
                "fired_total": self.fired_total}


def port_series(name):
    """The family the port publishes for the JAX package's series
    ``name`` (``xla_stats.DIFFERING_FAMILIES``; the name itself where
    the two agree, None where the port has no counterpart)."""
    from veles_tpu_torch.observe.xla_stats import DIFFERING_FAMILIES
    return DIFFERING_FAMILIES.get(name, name)


def default_rules():
    """The seed rule set: SLO burn, tpot p95 slope, MFU collapse,
    pool-exhaustion trend, rebuild storms. Counter series are RATES
    here, so ``>= 0.01`` on a storm counter means "any storm inside the
    sample gap". Each rule watches the JAX package's series mapped
    through :func:`port_series`, so none watches a family the port never
    publishes; a rule whose family has no counterpart is left out."""
    rules = []
    for rule in _jax_default_rules():
        rule.series = port_series(rule.series)
        if rule.series is not None:
            rules.append(rule)
    return rules


def _jax_default_rules():
    """The JAX package's seed rules (``veles_tpu/observe/history.py:
    454-492``), under its series names."""
    return [
        # the user-visible breach: worst burn over any window crossing
        # the page threshold (the governor's demote default)
        AnomalyRule("slo_burn", "veles_slo_burn_rate",
                    kind="threshold", op=">=", threshold=2.0,
                    for_samples=2),
        # same predicate on the control feed (veles_ctrl_burn_rate is
        # what the governor actually acted on, recorded per tick)
        AnomalyRule("ctrl_burn", "veles_ctrl_burn_rate",
                    kind="threshold", op=">=", threshold=2.0,
                    for_samples=2),
        AnomalyRule("tpot_p95_slope", "veles_serving_latency_ms",
                    match={"kind": "tpot", "quantile": "p95"},
                    kind="slope", op=">=", threshold=25.0,
                    window_s=15.0, for_samples=2),
        AnomalyRule("ttft_p95_slope", "veles_serving_latency_ms",
                    match={"kind": "ttft", "quantile": "p95"},
                    kind="slope", op=">=", threshold=50.0,
                    window_s=15.0, for_samples=2),
        AnomalyRule("mfu_collapse", "veles_mfu_ratio", kind="drop",
                    drop_frac=0.5, window_s=15.0, baseline_s=60.0,
                    for_samples=2),
        # the flood signature: reservations surging toward capacity
        AnomalyRule("pool_exhaustion", "veles_kv_pages_reserved",
                    kind="slope", op=">=", threshold=8.0,
                    window_s=10.0, for_samples=1),
        AnomalyRule("pool_free_trend", "veles_kv_pages_free",
                    kind="slope", op="<=", threshold=-8.0,
                    window_s=10.0, for_samples=1),
        # storm counters sampled as rates: any storm in the gap fires
        AnomalyRule("compile_storm", "veles_xla_recompile_storms_total",
                    kind="threshold", op=">=", threshold=0.01,
                    for_samples=1),
    ]


class MetricHistory:
    """The bounded in-process time-series store (see module
    docstring). Lock-free record path: deque/dict mutations only; the
    cooperative ``_busy`` flag keeps concurrent samplers from doubling
    work (a rare race double-samples harmlessly)."""

    def __init__(self, registry=None, interval_s=DEFAULT_INTERVAL_S,
                 capacity=DEFAULT_CAPACITY,
                 series_cap=DEFAULT_SERIES_CAP, rules=None,
                 incidents=None):
        if registry is None:
            from veles_tpu_torch.observe.metrics import get_metrics_registry
            registry = get_metrics_registry()
        self.registry = registry
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.series_cap = int(series_cap)
        self._series = {}            # (name, labels) -> _Series
        self._pass = 0               # sample-pass counter
        self._busy = False
        self._last_sample = None
        self.samples_total = 0
        self.series_dropped = 0      # overflow tally (hostile labels)
        self.anomalies_total = 0
        self.rules = list(rules) if rules is not None else []
        self.incidents = incidents if incidents is not None \
            else IncidentRecorder()

    @classmethod
    def from_config(cls, registry=None, **kwargs):
        """Build from ``root.common.observe.history``; None when
        disabled. UNSET means the default config — history is on
        wherever ``/metrics`` is mounted. Raw attribute read, not
        ``get()`` — get() collapses Config subtrees to the default
        (the serve-mesh doctrine)."""
        from veles_tpu_torch.core.config import root

        try:
            spec = object.__getattribute__(root.common.observe,
                                           "history")
        except AttributeError:
            spec = None
        config = parse_history_spec(spec)
        if config is None:
            return None
        history = cls(registry=registry, interval_s=config.interval_s,
                      capacity=config.capacity,
                      series_cap=config.series_cap,
                      incidents=IncidentRecorder(
                          cooldown_s=config.incident_cooldown_s),
                      **kwargs)
        if config.seed_rules:
            history.rules.extend(default_rules())
        return history

    # -- recording (sampler thread / governor tick; never hot path) -------
    def _ingest(self, name, kind, labels, value, now, anchor=None):
        key = (name, labels)
        series = self._series.get(key)
        if series is None:
            if len(self._series) >= self.series_cap:
                self.series_dropped += 1
                return
            series = self._series[key] = _Series(
                name, kind, labels, self.capacity)
        series.push(now, value, self._pass, anchor=anchor)

    def sample(self, now=None, rows=None, check_rules=True):
        """Snapshot the registry (or injected ``rows`` for tests) into
        the rings, then evaluate the anomaly rules. A disabled registry
        samples nothing — the no-scrape fast path stays a no-op.
        ``check_rules=False`` ingests data only: deadline-sensitive
        callers (the governor's driver-thread fallback) keep trends
        alive without ever running a rule firing's incident write."""
        if now is None:
            now = time.monotonic()
        if rows is None:
            rows = self.registry.sample()
            if not rows:
                return False
        # counters first seen AFTER the first pass anchor against an
        # implicit 0 at the previous pass (see _Series.push)
        anchor = self._last_sample if self.samples_total else None
        self._pass += 1
        for name, kind, labels, value in rows:
            if isinstance(value, bool) \
                    or not isinstance(value, (int, float)):
                continue
            self._ingest(name, kind, tuple(labels), value, now,
                         anchor=anchor)
        self.samples_total += 1
        self._last_sample = now
        if check_rules:
            self._check_rules(now)
        return True

    def maybe_sample(self, now=None, check_rules=True):
        """Rate-limited :meth:`sample` — safe to call from any cadence
        (the sampler thread, the governor tick, a scrape)."""
        if now is None:
            now = time.monotonic()
        if self._busy:
            return False
        if self._last_sample is not None \
                and now - self._last_sample < self.interval_s:
            return False
        self._busy = True
        try:
            return self.sample(now=now, check_rules=check_rules)
        finally:
            self._busy = False

    def record_control(self, name, value, labels=(), now=None):
        """Record one control-loop sensor reading as a gauge series
        (the governor's feed): the values the control loop acts on ARE
        history samples, so the incident autopsy replays exactly what
        the governor saw — control plane and autopsy trends cannot
        disagree."""
        if value is None:
            return
        if now is None:
            now = time.monotonic()
        self._ingest(name, "gauge", tuple(labels), float(value), now)

    def control_burn(self, engine, now=None):
        """The governor's burn sensor refactored onto history: read
        the engine's worst short-window burn, record it as the
        ``veles_ctrl_burn_rate`` series, return it (None = no traffic,
        the tier HOLDS)."""
        summary = engine.summary() if engine is not None else None
        if not summary:
            return None
        burn = summary["burn_rate"]
        self.record_control("veles_ctrl_burn_rate", burn,
                            labels=(("objective", summary["objective"]),
                                    ("window", summary["window"])),
                            now=now)
        return burn

    # -- rules -------------------------------------------------------------
    def add_rule(self, rule):
        self.rules.append(rule)
        return rule

    def matching(self, rule, now=None):
        """Series matching ``rule`` that appeared in the LATEST sample
        pass. Control series (recorded between passes by the governor
        tick) count as live while their last point is recent — a
        frozen feed from a stopped governor must not keep a rule
        breaching forever."""
        out = []
        for series in list(self._series.values()):
            if not rule.matches(series):
                continue
            if series.seen >= self._pass:
                out.append(series)
            elif series.name.startswith("veles_ctrl_") \
                    and series.stamps and now is not None \
                    and now - series.stamps[-1] <= 5 * self.interval_s:
                out.append(series)
        return out

    def _check_rules(self, now):
        fired = []
        for rule in list(self.rules):
            if getattr(rule, "external", False):
                # detector-owned rules (observe/fleetscope.py books
                # fleet_straggler/fleet_goodput with external=True):
                # their state is synced — and their firing decided —
                # by the owning detector's own cadence; sampler-side
                # evaluation would race those writes and double-fire
                # with different window semantics
                continue
            try:
                event = rule.evaluate(self, now)
            except Exception:
                logging.getLogger("MetricHistory").exception(
                    "anomaly rule %s failed (kept)", rule.name)
                continue
            if event is not None:
                fired.append((rule, event))
        for rule, event in fired:
            self.anomalies_total += 1
            try:
                if self.registry.enabled:
                    self.registry.incr(
                        "veles_anomaly_fired_total",
                        labels={"rule": rule.name},
                        help="anomaly-rule firings (observe/history.py)")
            except Exception:
                pass
            try:
                from veles_tpu_torch.observe.flight import get_flight_recorder
                get_flight_recorder().note(
                    "anomaly", rule=rule.name, series=rule.series,
                    value=event["value"],
                    breach_since=event["breach_since"])
            except Exception:
                pass
            self.incidents.trigger(self, rule, event, now)

    def breaching_rules(self):
        """Rules currently inside a breach streak, earliest first."""
        out = [rule for rule in self.rules
               if rule.breach_since is not None]
        out.sort(key=lambda r: r.breach_since)
        return out

    # -- views -------------------------------------------------------------
    def series_list(self):
        return list(self._series.values())

    def get(self, name, labels=None):
        """One series by name (+ exact labels dict), or None."""
        key = (name, tuple(sorted((labels or {}).items())))
        found = self._series.get(key)
        if found is not None:
            return found
        if labels is None:
            for series in self._series.values():
                if series.name == name:
                    return series
        return None

    def debug_snapshot(self, series=None, window=None, max_series=256,
                       now=None):
        """The ``/debug/history`` payload: windowed series tails
        (filtered by name substring ``series``), rule states and the
        store's own tallies."""
        if now is None:
            now = time.monotonic()
        rows = []
        for entry in list(self._series.values()):
            if series and series not in entry.name:
                continue
            stamps, values = entry.window(window, now=now)
            if not stamps:
                continue
            rows.append({
                "name": entry.name,
                "kind": entry.kind,
                "labels": entry.label_dict(),
                # ages in seconds (newest-last): monotonic stamps mean
                # nothing to another process, ages survive transport
                "ages": [round(now - t, 3) for t in stamps],
                "values": [round(v, 6) for v in values],
            })
            if len(rows) >= max_series:
                break
        rows.sort(key=lambda r: (r["name"],
                                 tuple(sorted(r["labels"].items()))))
        return {
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "now_mono": now,
            "samples_total": self.samples_total,
            "series_count": len(self._series),
            "series_dropped": self.series_dropped,
            "anomalies_total": self.anomalies_total,
            "series": rows,
            "rules": [rule.state() for rule in self.rules],
            "incidents": {"count": self.incidents.count,
                          "last_path": self.incidents.last_path},
        }

    def dashboard_cells(self, max_cells=6):
        """Compact sparkline cells for the web-status dashboard: the
        preferred trend series with their tails."""
        cells = []
        for series in sorted(self._series.values(),
                             key=lambda s: s.name):
            if not series.values \
                    or not series.name.startswith(SUMMARY_PREFIXES):
                continue
            labels = series.label_dict()
            label = series.name.replace("veles_", "")
            extra = ",".join("%s" % v for k, v in sorted(labels.items())
                             if k not in ("api", "objective"))
            if extra:
                label += "{%s}" % extra
            cells.append({"label": label,
                          "spark": list(series.values)[-16:],
                          "last": round(series.values[-1], 4)})
            if len(cells) >= max_cells:
                break
        return cells

    def fleet_summary(self, max_series=FLEET_MAX_SERIES,
                      max_points=FLEET_MAX_POINTS, now=None):
        """The piggyback rows a fleet slave rides on its update frames:
        ``[[name, [[k, v], ...], [ages], [values]], ...]`` for the
        summary-prefix series, bounded. Ages (seconds before ``now``)
        instead of stamps — monotonic clocks don't cross processes."""
        if now is None:
            now = time.monotonic()
        rows = []
        for series in sorted(self._series.values(),
                             key=lambda s: s.name):
            if not series.values \
                    or not series.name.startswith(SUMMARY_PREFIXES):
                continue
            stamps = list(series.stamps)[-max_points:]
            values = list(series.values)[-max_points:]
            rows.append([series.name,
                         [list(kv) for kv in series.labels],
                         [round(now - t, 3) for t in stamps],
                         [round(v, 6) for v in values]])
            if len(rows) >= max_series:
                break
        return rows

    def ingest_summary(self, sid, rows, now=None):
        """Master side of the piggyback: land a slave's summary rows in
        THIS history as slave-labeled series, so a master-side incident
        (and ``/debug/history``) spans the fleet. Validated and bounded
        — the rows came off the wire."""
        from veles_tpu_torch.observe.metrics import (LABEL_NAME_RE,
                                               METRIC_NAME_RE)

        if not isinstance(rows, list):
            return 0
        if now is None:
            now = time.monotonic()
        sid = str(sid)
        ingested = 0
        for row in rows[:FLEET_MAX_SERIES]:
            try:
                name, labels, ages, values = row
                if not isinstance(name, str) \
                        or not METRIC_NAME_RE.match(name) \
                        or len(ages) != len(values):
                    continue
                clean = []
                for key, value in list(labels)[:8]:
                    key = str(key)
                    if not LABEL_NAME_RE.match(key) or key == "slave":
                        continue
                    clean.append((key, str(value)[:64]))
                clean.append(("slave", sid))
                key = (name, tuple(sorted(clean)))
                series = self._series.get(key)
                if series is None:
                    if len(self._series) >= self.series_cap:
                        self.series_dropped += 1
                        continue
                    series = self._series[key] = _Series(
                        name, "gauge", tuple(sorted(clean)),
                        self.capacity)
                # REPLACE the ring: each frame carries the slave's
                # current tail; appending would duplicate overlap
                series.stamps.clear()
                series.values.clear()
                for age, value in zip(ages[-FLEET_MAX_POINTS:],
                                      values[-FLEET_MAX_POINTS:]):
                    series.stamps.append(now - float(age))
                    series.values.append(float(value))
                series.seen = self._pass
                ingested += 1
            except (TypeError, ValueError):
                continue
        return ingested

    def reset(self):
        """Drop everything (test isolation)."""
        self._series.clear()
        self._pass = 0
        self._last_sample = None
        self.samples_total = 0
        self.series_dropped = 0
        self.anomalies_total = 0
        for rule in self.rules:
            rule.streak = 0
            rule.breach_since = None
            rule.breach_value = None
            rule.breach_labels = None
            rule.last_fired = None


class IncidentRecorder:
    """Atomic incident-artifact writer (flight-recorder dump
    discipline: temp + ``os.replace``, counter-suffixed filenames so
    two incidents in one second never overwrite each other)."""

    def __init__(self, cooldown_s=DEFAULT_INCIDENT_COOLDOWN_S,
                 directory=None, window_s=120.0):
        self.cooldown_s = float(cooldown_s)
        self.directory = directory
        self.window_s = float(window_s)
        self.count = 0
        self.last_path = None
        self.last_doc = None
        self._last_trigger = None
        self._write_failed_warned = False

    def _dump_dir(self):
        if self.directory:
            return self.directory
        from veles_tpu_torch.core.config import root

        return root.common.dirs.get("run", ".")

    def trigger(self, history, rule, event, now=None):
        """Assemble + write one incident bundle (cooldown-limited).
        Returns the path, or None when suppressed/failed."""
        if now is None:
            now = time.monotonic()
        if self._last_trigger is not None \
                and now - self._last_trigger < self.cooldown_s:
            return None
        doc = self.build(history, rule, event, now=now)
        path = self.write(doc, rule.name)
        if path is not None:
            # cooldown arms only on a SUCCESSFUL write: a transiently
            # unwritable run dir must not consume the window and lose
            # the fault's only artifact
            self._last_trigger = now
            try:
                from veles_tpu_torch.observe.flight import get_flight_recorder
                get_flight_recorder().note("incident", rule=rule.name,
                                           path=path)
            except Exception:
                pass
            try:
                if history.registry.enabled:
                    history.registry.incr(
                        "veles_anomaly_incidents_total",
                        labels={"rule": rule.name},
                        help="incident artifacts written per "
                             "triggering rule")
            except Exception:
                pass
        return path

    def build(self, history, rule, event, now=None):
        """The incident JSON: trigger + breaching rules + leading
        indicator + the breach window's history + request rows +
        flight tail + compile windows + governor actuations."""
        if now is None:
            now = time.monotonic()
        breaching = history.breaching_rules()
        leading = breaching[0] if breaching else rule
        # the user-visible breach the lead is measured against: the
        # SLO-burn/goodput rule when it is breaching, else the trigger
        reference = next(
            (r for r in breaching if r.name in REFERENCE_RULES), rule)
        lead_ms = 0.0
        if leading.breach_since is not None \
                and reference.breach_since is not None:
            lead_ms = max(0.0, (reference.breach_since
                                - leading.breach_since) * 1000.0)
        start = min([r.breach_since for r in breaching
                     if r.breach_since is not None] or [now])
        window = min(self.window_s + (now - start), self.window_s * 4)
        doc = {
            "schema": INCIDENT_SCHEMA,
            "kind": "incident",
            "reason": rule.name,
            "time": time.time(),
            "mono": now,
            "pid": os.getpid(),
            "trigger": dict(event),
            "breaching": [r.state() for r in breaching] or [rule.state()],
            "leading_indicator": {
                "rule": leading.name,
                "series": leading.series,
                "labels": [list(kv)
                           for kv in (leading.breach_labels or ())],
                "breach_since": leading.breach_since,
                "lead_ms": round(lead_ms, 3),
                "reference": reference.name,
            },
            "window_s": round(window, 3),
            "history": history.debug_snapshot(window=window, now=now),
        }
        try:
            from veles_tpu_torch.observe.reqledger import get_request_ledger
            ledger = get_request_ledger()
            if ledger.enabled and (ledger.staged_total
                                   or ledger.resolved_total):
                doc["requests"] = ledger.debug_snapshot(slowest=16)
        except Exception:
            pass
        try:
            from veles_tpu_torch.observe.flight import get_flight_recorder
            entries = get_flight_recorder().entries()
            doc["flight_tail"] = entries[-64:]
            doc["governor"] = [e for e in entries
                               if e.get("kind") == "governor"][-32:]
        except Exception:
            pass
        try:
            from veles_tpu_torch.observe.xla_stats import get_compile_tracker
            tracker = get_compile_tracker()
            if tracker.enabled:
                stalls = tracker.compiles_overlapping(now - window, now)
                doc["compile_windows"] = [
                    [name, round(sec * 1000.0, 3)]
                    for name, sec in stalls[:16]]
        except Exception:
            pass
        self.last_doc = doc
        return doc

    def write(self, doc, reason):
        """Atomic temp + ``os.replace`` write, counter-suffixed name
        (the black-box discipline). Returns the path or None (warned
        once — an incident must never crash the sampler)."""
        try:
            directory = self._dump_dir()
            os.makedirs(directory, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            path = os.path.join(
                directory, "incident-%s-%s-%d-%d.json"
                % (stamp, str(reason).replace("/", "_"), os.getpid(),
                   self.count))
            tmp = path + ".tmp"
            with open(tmp, "w") as fout:
                json.dump(doc, fout, default=str)
            os.replace(tmp, path)
        except (OSError, ValueError):
            if not self._write_failed_warned:
                self._write_failed_warned = True
                logging.getLogger("IncidentRecorder").exception(
                    "incident write failed (reported once)")
            return None
        self.count += 1
        self.last_path = path
        logging.getLogger("IncidentRecorder").warning(
            "incident artifact written (%s): %s", reason, path)
        return path


# -- the process-global history + sampler thread ----------------------------

_history = None
_history_built = False
_sampler_thread = None
_sampler_stop = threading.Event()


def get_metric_history():
    """The process history, or None when disabled / never ensured."""
    return _history


def set_metric_history(history):
    """Swap the process history (test isolation / explicit wiring)."""
    global _history, _history_built
    _history = history
    _history_built = True
    return history


def ensure_metric_history(registry=None):
    """Build the process history from config on first call (None when
    ``root.common.observe.history`` disables it). Idempotent."""
    global _history, _history_built
    if not _history_built:
        _history = MetricHistory.from_config(registry=registry)
        _history_built = True
    return _history


#: the serving fronts that started the sampler and have not stopped yet
_holders = weakref.WeakSet()


def start_history_sampler(holder=None):
    """Ensure the process history exists and its sampler thread runs
    (idempotent; called wherever ``/metrics`` mounts). ``holder`` (a
    serving front) keeps it running until :func:`release_history_sampler`
    releases the last one. NON-daemon: the exit hook below stops it
    before interpreter shutdown joins non-daemon threads."""
    global _sampler_thread
    history = ensure_metric_history()
    if history is None:
        return None
    if holder is not None:
        _holders.add(holder)
    if _sampler_thread is None or not _sampler_thread.is_alive():
        _sampler_stop.clear()

        def loop():
            # no closure over the history object: re-fetch each pass
            # so a set_metric_history() swap changes BOTH the store
            # sampled and the wait cadence, and the replaced store's
            # rings are not pinned for the thread's lifetime
            while True:
                live = get_metric_history()
                interval = (live.interval_s if live is not None
                            else DEFAULT_INTERVAL_S)
                if _sampler_stop.wait(interval):
                    return
                live = get_metric_history()
                if live is None:
                    return
                try:
                    live.maybe_sample()
                except Exception:
                    logging.getLogger("MetricHistory").exception(
                        "history sample failed (sampler kept)")

        _sampler_thread = threading.Thread(target=loop,
                                           name="metric-history")
        _sampler_thread.start()
    return history


def history_sampler_alive():
    """True while the process sampler thread runs — callers on
    deadline-sensitive threads (the governor's driver tick) skip their
    own fallback sampling then, so a rule firing can never run an
    incident write on the serving hot path."""
    thread = _sampler_thread
    return thread is not None and thread.is_alive()


def release_history_sampler(holder, timeout=5.0):
    """A serving front stopped: drop it from the holders, and stop the
    sampler once no front holds it (``GenerateAPI.stop``,
    ``RESTfulAPI.stop``)."""
    _holders.discard(holder)
    if not len(_holders):
        stop_history_sampler(timeout=timeout)


def stop_history_sampler(timeout=5.0):
    """Stop + join the sampler thread (interpreter-exit hook; also
    test teardown)."""
    global _sampler_thread
    _sampler_stop.set()
    thread = _sampler_thread
    if thread is not None and thread.is_alive():
        thread.join(timeout=timeout)
    _sampler_thread = None


# threading._register_atexit (the concurrent.futures hook) runs BEFORE
# threading._shutdown joins non-daemon threads; plain atexit runs
# after, which would deadlock the join
try:
    from threading import _register_atexit as _register_exit_hook
except ImportError:  # pragma: no cover - future-proofing
    from atexit import register as _register_exit_hook

_register_exit_hook(stop_history_sampler)


# -- the `observe incident` CLI ---------------------------------------------

def load_incident(path):
    """Load one incident artifact; raises on unreadable/garbage."""
    with open(path, "r") as fin:
        doc = json.load(fin)
    if not isinstance(doc, dict) or doc.get("kind") != "incident":
        raise ValueError("%s is not an incident artifact" % path)
    return doc


def _labels_suffix(labels):
    pairs = [kv for kv in (labels or ()) if len(kv) == 2]
    if not pairs:
        return ""
    return "{%s}" % ",".join("%s=%s" % (k, v) for k, v in pairs)


def render_incident(doc, slowest=4):
    """The merged-timeline rendering of one incident artifact (or a
    live pseudo-doc built from ``/debug/history``)."""
    lines = []
    when = doc.get("time")
    lines.append("incident: %s%s  pid=%s  schema=%s" % (
        doc.get("reason", "?"),
        ("  at %s" % time.strftime("%Y-%m-%d %H:%M:%S",
                                   time.localtime(when))) if when
        else "", doc.get("pid", "?"), doc.get("schema", "?")))
    lead = doc.get("leading_indicator") or {}
    if lead:
        lines.append(
            "leading indicator: %s (%s%s) led %s by %.0fms"
            % (lead.get("rule", "?"), lead.get("series", "?"),
               _labels_suffix(lead.get("labels")),
               lead.get("reference", "?"),
               float(lead.get("lead_ms") or 0.0)))
    breaching = doc.get("breaching") or []
    if breaching:
        mono = doc.get("mono")
        lines.append("breaching rules:")
        for state in breaching:
            since = state.get("breach_since")
            age = ""
            if since is not None and mono is not None:
                age = "  breached %.1fs ago" % (float(mono)
                                                - float(since))
            lines.append("  %-18s %-8s value=%s%s"
                         % (state.get("name"), state.get("kind"),
                            state.get("last_value"), age))
    history = doc.get("history") or {}
    rows = history.get("series") or []
    if rows:
        lines.append("timeline (%d series, window %ss, cadence %ss):"
                     % (len(rows), doc.get("window_s", "?"),
                        history.get("interval_s", "?")))
        for row in rows:
            values = row.get("values") or []
            label = row.get("name", "?") + _labels_suffix(
                sorted((row.get("labels") or {}).items()))
            lines.append("  %-52s %s last=%s"
                         % (label[:52], sparkline(values),
                            values[-1] if values else "-"))
    governor = doc.get("governor") or []
    if governor:
        from veles_tpu_torch.observe.governor import \
            format_governor_transitions
        lines.append("governor actuations:")
        lines.append(format_governor_transitions(governor))
    compile_windows = doc.get("compile_windows") or []
    if compile_windows:
        lines.append("compile windows in the breach: "
                     + ", ".join("%s %.0fms" % (name, ms)
                                 for name, ms in compile_windows[:8]))
    requests = doc.get("requests") or {}
    slow_rows = list(requests.get("slowest") or [])[:slowest]
    if slow_rows:
        from veles_tpu_torch.observe.reqledger import autopsy
        lines.append("%d slowest requests in the window:"
                     % len(slow_rows))
        lines.append(autopsy(slow_rows, slowest=slowest))
    return "\n".join(lines)


def _live_doc(url):
    """Build an incident-shaped pseudo-doc from a live server's
    ``/debug/history`` (the ``--live`` path: no artifact needed to see
    what is breaching right now)."""
    import urllib.request

    base = url.rstrip("/")
    with urllib.request.urlopen("%s/debug/history" % base,
                                timeout=10) as resp:
        payload = json.loads(resp.read().decode())
    rules = payload.get("rules") or []
    breaching = [r for r in rules if r.get("breach_since") is not None]
    breaching.sort(key=lambda r: r["breach_since"])
    leading = breaching[0] if breaching else None
    reference = next((r for r in breaching
                      if r.get("name") in REFERENCE_RULES),
                     leading)
    lead_ms = 0.0
    if leading and reference \
            and reference.get("breach_since") is not None:
        lead_ms = max(0.0, (reference["breach_since"]
                            - leading["breach_since"]) * 1000.0)
    return {
        "kind": "incident",
        "schema": INCIDENT_SCHEMA,
        "reason": (leading or {}).get("name", "live"),
        "time": time.time(),
        "mono": payload.get("now_mono"),
        "pid": "live",
        "breaching": breaching,
        "leading_indicator": {
            "rule": leading["name"], "series": leading["series"],
            "breach_since": leading["breach_since"],
            "lead_ms": round(lead_ms, 3),
            "reference": (reference or leading).get("name"),
        } if leading else {},
        "window_s": "live",
        "history": payload,
    }


def incident_main(target=None, live=None, slowest=4):
    """``python -m veles_tpu_torch observe incident PATH | --live URL``:
    render the
    merged incident timeline and name the leading indicator. With a
    directory PATH, list the artifacts newest-first and render the
    newest. Returns 0, or 1 when nothing is found."""
    import glob

    if live:
        try:
            doc = _live_doc(live)
        except Exception as exc:
            print("cannot fetch %s/debug/history: %s" % (live, exc))
            return 1
        print(render_incident(doc, slowest=slowest))
        return 0
    if target is None:
        target = IncidentRecorder()._dump_dir()
    if os.path.isdir(target):
        paths = sorted(glob.glob(os.path.join(target,
                                              "incident-*.json")),
                       key=os.path.getmtime, reverse=True)
        if not paths:
            print("no incident artifacts under %s" % target)
            return 1
        for path in paths[1:][::-1]:
            print("%s" % path)
        target = paths[0]
    try:
        doc = load_incident(target)
    except (OSError, ValueError) as exc:
        print("cannot load %s: %s" % (target, exc))
        return 1
    print(render_incident(doc, slowest=slowest))
    return 0
