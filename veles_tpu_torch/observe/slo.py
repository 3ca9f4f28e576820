"""SLO engine: objectives, multi-window burn rates, exemplar feeds.

The port of ``veles_tpu/observe/slo.py``: the aggregate layer over the
request ledger (``observe/reqledger.py``). Objectives
(``root.common.observe.slo`` or the ``--serve-slo`` flag) are evaluated
over multi-window rolling buckets and exported on every ``/metrics``
mount as

- ``veles_slo_objective_ratio{objective=,window=}``: the fraction of
  requests meeting the objective over the window;
- ``veles_slo_error_budget_remaining{objective=,window=}``: the window's
  unburned share of the error budget (1.0 untouched, 0.0 exhausted,
  negative overdrawn);
- ``veles_slo_burn_rate{objective=,window=}``: the observed error ratio
  over the budget (1.0 burns exactly at the sustainable rate).

Objective spellings:

- ``<metric>_p<NN>_ms = T``: NN% of requests must see ``metric``
  (``ttft`` or ``tpot``) at or under T milliseconds;
- ``availability = R``: the completed fraction of admitted requests must
  be at least R.

Rows that carry a tenant (the ``X-Veles-Tenant`` header) slice every
objective with a ``tenant`` label beside the aggregate series; at most
:data:`TENANT_CAP` tenants, the rest fold into ``"other"``.

:func:`observe_request` is the one resolve-time feed: it derives ttft
and tpot from a ledger row's stage stamps and chunk cadence and records
them into the engine, the ``tpot`` health window and the exemplar-linked
request histograms (``veles_request_ttft_seconds`` /
``veles_request_tpot_seconds`` carry the row's trace id as an
OpenMetrics exemplar). Without objectives the engine is None and only
the histograms and the health window are fed.
"""

import re
import threading
import time

#: rolling-bucket granularity (seconds)
BUCKET_SECONDS = 10.0

#: default burn-rate windows (seconds) — short page / mid ticket / long
#: trend, each exported under a ``window="<N>s"`` label
WINDOWS = (60.0, 300.0, 1800.0)

#: distinct-tenant bound per engine; overflow folds into "other"
TENANT_CAP = 16

#: request-latency histogram buckets (seconds): ttft spans prefill
#: stalls, tpot is per-token
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_LATENCY_RE = re.compile(r"^(ttft|tpot)_p(\d{1,2})_ms$")


class Objective:
    """One parsed objective: a name, a target ratio, and a classifier
    over (ttft_s, tpot_s, ok)."""

    __slots__ = ("name", "kind", "metric", "target", "threshold_s")

    def __init__(self, name, kind, target, metric=None, threshold_s=None):
        self.name = name
        self.kind = kind          # "latency" | "availability"
        self.metric = metric      # "ttft" | "tpot" (latency only)
        self.target = float(target)
        self.threshold_s = threshold_s

    def classify(self, ttft_s, tpot_s, ok):
        """(good, counted) for one resolved request."""
        if self.kind == "availability":
            return bool(ok), True
        value = ttft_s if self.metric == "ttft" else tpot_s
        if value is None:
            # no latency signal: a failed request counts AGAINST the
            # latency objective (it never produced its first token);
            # a completed single-token request just has no tpot
            return (False, True) if not ok else (False, False)
        return value <= self.threshold_s, True


def parse_objectives(spec, flag="root.common.observe.slo"):
    """Parse the objective config: a dict (config subtree) or a
    ``name=value[,name=value...]`` string (the CLI flag). Unknown
    objective spellings raise naming ``flag``."""
    if spec is None:
        return []
    if hasattr(spec, "__content__"):
        spec = spec.__content__()
    if isinstance(spec, str):
        parsed = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, value = part.partition("=")
            if not sep:
                raise ValueError(
                    "%s: %r is not name=value" % (flag, part))
            parsed[name.strip()] = value.strip()
        spec = parsed
    if not isinstance(spec, dict):
        raise ValueError("%s must be a dict or 'name=value,...' string, "
                         "got %r" % (flag, type(spec).__name__))
    objectives = []
    for name, value in sorted(spec.items()):
        try:
            value = float(value)
        except (TypeError, ValueError):
            raise ValueError("%s: objective %r needs a numeric target, "
                             "got %r" % (flag, name, value))
        match = _LATENCY_RE.match(name)
        if match:
            metric, percentile = match.group(1), int(match.group(2))
            if not 0 < percentile < 100 or value <= 0:
                raise ValueError(
                    "%s: %r needs a percentile in (0, 100) and a "
                    "positive ms threshold" % (flag, name))
            objectives.append(Objective(
                name, "latency", percentile / 100.0, metric=metric,
                threshold_s=value / 1000.0))
        elif name == "availability":
            if not 0 < value < 1:
                raise ValueError(
                    "%s: availability target must be in (0, 1), got %r"
                    % (flag, value))
            objectives.append(Objective(name, "availability", value))
        else:
            raise ValueError(
                "%s: unknown objective %r (supported: ttft_pNN_ms, "
                "tpot_pNN_ms, availability)" % (flag, name))
    return objectives


class SLOEngine:
    """Multi-window rolling SLO accounting (see module docstring).
    ``record`` runs once per RESOLVED request under one small lock —
    never on the driver's token path."""

    def __init__(self, objectives, windows=WINDOWS,
                 bucket_seconds=BUCKET_SECONDS, tenant_cap=TENANT_CAP):
        if isinstance(objectives, (dict, str)):
            objectives = parse_objectives(objectives)
        if not objectives:
            raise ValueError("SLOEngine needs at least one objective")
        self.objectives = list(objectives)
        self.windows = tuple(sorted(float(w) for w in windows))
        self.bucket_seconds = float(bucket_seconds)
        self.tenant_cap = int(tenant_cap)
        self._lock = threading.Lock()
        #: [(bucket_start, {(objective, tenant): [good, total]})]
        self._buckets = []
        self._tenants = set()
        self.recorded_total = 0

    @classmethod
    def from_config(cls, **kwargs):
        """Build from ``root.common.observe.slo``; None when unset (the
        no-SLO null path). Raw attribute read, not ``get()`` — get()
        collapses Config subtrees to the default (the serve-mesh
        doctrine)."""
        from veles_tpu_torch.core.config import root

        try:
            spec = object.__getattribute__(root.common.observe, "slo")
        except AttributeError:
            return None
        objectives = parse_objectives(spec)
        if not objectives:
            return None
        return cls(objectives, **kwargs)

    def _tenant_key(self, tenant):
        if not tenant:
            return None
        if tenant in self._tenants:
            return tenant
        if len(self._tenants) >= self.tenant_cap:
            return "other"
        self._tenants.add(tenant)
        return tenant

    def record(self, ttft_s=None, tpot_s=None, ok=True, tenant="",
               version="", now=None):
        """Book one resolved request into the current bucket (the
        aggregate series plus, when ``tenant`` is set, its slice, and
        when ``version`` is set, the deploy-version slice the
        blue-green rollback predicate compares, ``rollout.py``)."""
        if now is None:
            now = time.monotonic()
        start = now - now % self.bucket_seconds
        with self._lock:
            if not self._buckets or self._buckets[-1][0] < start:
                self._buckets.append((start, {}))
                horizon = now - self.windows[-1] - self.bucket_seconds
                pruned = False
                while self._buckets and self._buckets[0][0] < horizon:
                    self._buckets.pop(0)
                    pruned = True
                if pruned and self._tenants:
                    # a tenant whose windows all emptied retires in
                    # the SAME pruning pass as the global buckets: its
                    # gauges stop exporting (publish REPLACES the
                    # sample sets) AND its cardinality-cap slot frees,
                    # so a long-dead tenant cannot pin the cap and
                    # fold every new tenant into "other" forever
                    live = {tenant for _, cells in self._buckets
                            for (_, tenant) in cells if tenant}
                    self._tenants &= live
            cells = self._buckets[-1][1]
            tenant_key = self._tenant_key(tenant)
            # version slices are tagged with a TUPLE second element so
            # they can never collide with a tenant literally named
            # "blue"/"green" (bounded: two live versions at most)
            for objective in self.objectives:
                good, counted = objective.classify(ttft_s, tpot_s, ok)
                if not counted:
                    continue
                keys = [(objective.name, None)]
                if tenant_key:
                    keys.append((objective.name, tenant_key))
                if version:
                    keys.append((objective.name,
                                 ("version", str(version)[:64])))
                for key in keys:
                    cell = cells.setdefault(key, [0, 0])
                    cell[0] += int(good)
                    cell[1] += 1
            self.recorded_total += 1

    # -- views ------------------------------------------------------------
    def gauges(self, now=None):
        """Per (objective, tenant, window) rows:
        ``{"objective", "tenant", "window", "ratio",
        "error_budget_remaining", "burn_rate", "count"}`` — windows
        with no traffic are omitted (a gauge of nothing is a lie)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            buckets = [(start, {key: list(cell)
                                for key, cell in cells.items()})
                       for start, cells in self._buckets]
        by_target = {obj.name: obj.target for obj in self.objectives}
        rows = []
        for window in self.windows:
            horizon = now - window
            sums = {}
            for start, cells in buckets:
                if start + self.bucket_seconds <= horizon:
                    continue
                for key, (good, total) in cells.items():
                    cell = sums.setdefault(key, [0, 0])
                    cell[0] += good
                    cell[1] += total
            for (objective, tag), (good, total) in sorted(
                    sums.items(), key=lambda kv: (kv[0][0],
                                                  str(kv[0][1] or ""))):
                if not total:
                    continue
                # tag: None = aggregate, str = tenant slice,
                # ("version", v) = deploy-version slice
                tenant = version = None
                if isinstance(tag, tuple):
                    version = tag[1]
                else:
                    tenant = tag
                ratio = good / total
                budget = 1.0 - by_target[objective]
                burn = (1.0 - ratio) / budget if budget > 0 else 0.0
                rows.append({
                    "objective": objective,
                    "tenant": tenant,
                    "version": version,
                    "window": "%ds" % int(window),
                    "ratio": round(ratio, 6),
                    "error_budget_remaining": round(1.0 - burn, 6),
                    "burn_rate": round(burn, 6),
                    "count": total,
                })
        return rows

    def version_burn(self, version, now=None):
        """The deploy-version slice's worst burn over the SHORTEST
        window (the rollback predicate's sensor — same shape and cost
        as :meth:`summary`, filtered to the version's cells), or None
        without traffic on that slice."""
        if now is None:
            now = time.monotonic()
        window = self.windows[0]
        horizon = now - window
        tag = ("version", str(version)[:64])
        sums = {}
        with self._lock:
            for start, cells in self._buckets:
                if start + self.bucket_seconds <= horizon:
                    continue
                for (objective, cell_tag), (good, total) \
                        in cells.items():
                    if cell_tag != tag:
                        continue
                    cell = sums.setdefault(objective, [0, 0])
                    cell[0] += good
                    cell[1] += total
        worst = None
        for objective in self.objectives:
            good, total = sums.get(objective.name, (0, 0))
            if not total:
                continue
            budget = 1.0 - objective.target
            burn = (1.0 - good / total) / budget if budget > 0 else 0.0
            burn = round(burn, 6)
            if worst is None or burn > worst["burn_rate"]:
                worst = {"burn_rate": burn,
                         "objective": objective.name,
                         "window": "%ds" % int(window),
                         "count": total}
        return worst

    def summary(self, now=None):
        """The dashboard cell AND the governor's per-tick sensor: the
        worst aggregate burn rate over the SHORTEST window (the page
        signal), or None without traffic. Deliberately cheap — it sums
        only the shortest window's aggregate cells under the lock
        (never the full multi-window/tenant copy ``gauges`` makes),
        because the serving governor reads it at ~4 Hz on the decode
        driver thread."""
        if now is None:
            now = time.monotonic()
        window = self.windows[0]
        horizon = now - window
        sums = {}
        with self._lock:
            for start, cells in self._buckets:
                if start + self.bucket_seconds <= horizon:
                    continue
                for (objective, tenant), (good, total) in cells.items():
                    if tenant is not None:
                        continue
                    cell = sums.setdefault(objective, [0, 0])
                    cell[0] += good
                    cell[1] += total
        worst = None
        for objective in self.objectives:
            good, total = sums.get(objective.name, (0, 0))
            if not total:
                continue
            budget = 1.0 - objective.target
            burn = (1.0 - good / total) / budget if budget > 0 else 0.0
            burn = round(burn, 6)
            if worst is None or burn > worst["burn_rate"]:
                worst = {"burn_rate": burn,
                         "objective": objective.name,
                         "window": "%ds" % int(window)}
        return worst

    def publish(self, registry, now=None):
        """Scrape-time re-publication (the bridge contract). The
        sample sets are REPLACED wholesale, not merged: a window that
        emptied (incident over, traffic gone) must stop exporting its
        last burn rate — a frozen ``burn_rate 20`` would page forever
        while ``/healthz``'s summary correctly went quiet."""
        rows = self.gauges(now=now)

        def labelled(key):
            out = []
            for row in rows:
                labels = {"objective": row["objective"],
                          "window": row["window"]}
                if row["tenant"] is not None:
                    labels["tenant"] = row["tenant"]
                if row.get("version") is not None:
                    labels["version"] = row["version"]
                out.append((labels, row[key]))
            return out

        registry.set_gauge_family(
            "veles_slo_objective_ratio", labelled("ratio"),
            help="fraction of requests meeting the objective over "
                 "the rolling window")
        registry.set_gauge_family(
            "veles_slo_error_budget_remaining",
            labelled("error_budget_remaining"),
            help="unburned share of the window's error budget "
                 "(negative = overdrawn)")
        registry.set_gauge_family(
            "veles_slo_burn_rate", labelled("burn_rate"),
            help="observed error ratio over the error budget "
                 "(1.0 burns exactly at the sustainable rate)")


# -- the process-global engine (config-built, for CLI serving) --------------

_engine = None
_engine_built = False


def get_slo_engine():
    """The config-built process engine (``root.common.observe.slo``),
    or None when no objectives are configured. Built once; tests swap
    it via :func:`set_slo_engine`."""
    global _engine, _engine_built
    if not _engine_built:
        _engine = SLOEngine.from_config()
        _engine_built = True
    return _engine


def set_slo_engine(engine):
    """Swap the process engine (test isolation / explicit wiring)."""
    global _engine, _engine_built
    _engine = engine
    _engine_built = True
    return engine


def ensure_slo_registered(registry):
    """Idempotently attach the process engine's publisher to
    ``registry`` — run by serving mounts and by the fleet slave's
    piggyback path, so a slave's SLO gauges ride its update frames to
    the master exactly like the mesh/device rows. No-op without an
    engine."""
    engine = get_slo_engine()
    if engine is None:
        return registry
    collector = getattr(registry, "_slo_collector", None)
    if collector is None:
        def collector():
            live = get_slo_engine()
            if live is not None:
                live.publish(registry)
        registry._slo_collector = collector
    if collector not in registry._collectors:
        registry.add_collector(collector)
    return registry


# -- the resolve-time feed ---------------------------------------------------

def row_latencies(row):
    """(ttft_s, tpot_s) derived from a ledger row: ttft is the
    staged -> first_token stage gap; tpot is the per-token cadence over
    the collected chunks (first-chunk tokens excluded — they arrive
    with the first stamp), falling back to the first_token -> resolved
    span when the request fit in one chunk."""
    stages = {}
    for stage, stamp in row.get("stages", ()):
        stages.setdefault(stage, float(stamp))
    ttft = None
    if "first_token" in stages and "staged" in stages:
        ttft = max(0.0, stages["first_token"] - stages["staged"])
    tpot = None
    chunks = row.get("chunks") or ()
    tokens = int(row.get("tokens", 0))
    if len(chunks) >= 2:
        span = float(chunks[-1][0]) - float(chunks[0][0])
        later_tokens = sum(int(c[1]) for c in chunks[1:])
        if later_tokens > 0 and span >= 0:
            tpot = span / later_tokens
    elif tokens > 1 and "first_token" in stages \
            and "resolved" in stages:
        tpot = max(0.0, stages["resolved"] - stages["first_token"]) \
            / (tokens - 1)
    return ttft, tpot


def observe_request(row, engine=None, registry=None, health=None):
    """Feed one RESOLVED ledger row everywhere aggregate truth is
    kept: the SLO engine, the ``tpot`` health window, and the
    exemplar-linked request histograms. Called once per request by
    ``GenerateAPI._resolve``, never on the token path."""
    if row is None:
        return
    ttft, tpot = row_latencies(row)
    ok = row.get("outcome") == "completed"
    if engine is not None:
        engine.record(ttft_s=ttft, tpot_s=tpot, ok=ok,
                      tenant=row.get("tenant") or "",
                      version=row.get("deploy") or "")
    if health is not None and tpot is not None:
        health.record_latency("tpot", tpot)
    if registry is not None and registry.enabled:
        exemplar = ({"trace_id": row["trace"]} if row.get("trace")
                    else None)
        labels = {"api": row.get("api") or "serving"}
        if ttft is not None:
            registry.observe(
                "veles_request_ttft_seconds", ttft, labels=labels,
                buckets=LATENCY_BUCKETS, exemplar=exemplar,
                help="per-request time to first token (exemplars link "
                     "buckets to trace ids on openmetrics scrapes)")
        if tpot is not None:
            registry.observe(
                "veles_request_tpot_seconds", tpot, labels=labels,
                buckets=LATENCY_BUCKETS, exemplar=exemplar,
                help="per-request time per output token from the chunk "
                     "collect cadence")


# -- the `observe slo` CLI --------------------------------------------------

def _rows_from_doc(doc):
    """Ledger rows + SLO gauge lines + governor actuations out of a
    JSON artifact: a flight-recorder black box (``requests`` section +
    ``metrics`` snapshot + governor flight entries) or a saved
    ``/debug/requests`` payload."""
    if "entries" in doc or "requests" in doc:  # black-box dump
        requests = doc.get("requests") or {}
        slo_rows = [row for row in doc.get("metrics") or []
                    if str(row[0]).startswith("veles_slo_")]
        governor = [entry for entry in doc.get("entries") or []
                    if entry.get("kind") == "governor"]
        return requests, slo_rows, governor
    if "slowest" in doc or "inflight" in doc:  # /debug/requests
        return doc, [], []
    raise ValueError("not a black-box dump or /debug/requests payload")


def slo_main(target=None, live=None, slowest=8):
    """``python -m veles_tpu_torch observe slo ARTIFACT | --live URL``: print the
    waterfall autopsy of the slowest requests (+ any SLO burn-rate
    rows found beside them). Returns 0, or 1 when nothing is found."""
    import json
    import urllib.request

    from veles_tpu_torch.observe.reqledger import autopsy

    slo_lines = []
    governor_entries = []
    if live:
        base = live.rstrip("/")
        with urllib.request.urlopen(
                "%s/debug/requests?n=%d" % (base, slowest),
                timeout=10) as resp:
            requests = json.loads(resp.read().decode())
        try:
            with urllib.request.urlopen("%s/metrics" % base,
                                        timeout=10) as resp:
                slo_lines = [line for line
                             in resp.read().decode().splitlines()
                             if line.startswith("veles_slo_")]
        except Exception:
            pass
    else:
        try:
            with open(target, "r") as fin:
                doc = json.load(fin)
            requests, slo_rows, governor_entries = _rows_from_doc(doc)
        except (OSError, ValueError) as exc:
            print("cannot load %s: %s" % (target, exc))
            return 1
        slo_lines = ["%s{%s} %s" % (
            name, ",".join('%s="%s"' % (k, v) for k, v in labels),
            value) for name, _, labels, value in slo_rows]
    if slo_lines:
        print("SLO gauges:")
        for line in slo_lines:
            print("  " + line)
        print()
    if governor_entries:
        from veles_tpu_torch.observe.governor import \
            format_governor_transitions
        # the actuation replay: what the governor DID during the
        # window the black box covers, in order
        print("governor actuations:")
        print(format_governor_transitions(governor_entries))
        print()
    rows = list(requests.get("slowest") or [])
    inflight = list(requests.get("inflight") or [])
    if not rows and not inflight:
        print("no request rows (ledger empty?)")
        # gauges or governor actuations alone are still a successful
        # autopsy — 1 is reserved for a dump with nothing to show
        return 0 if (slo_lines or governor_entries) else 1
    if inflight:
        print("%d in flight:" % len(inflight))
        print(autopsy(inflight, slowest=slowest))
        print()
    if rows:
        print("%d slowest resolved:" % min(len(rows), slowest))
        print(autopsy(rows, slowest=slowest))
    return 0
