"""Serving control plane: one logical endpoint over N self-healing
replicas.

The port's copy of ``veles_tpu/fleet/serve_plane.py``, on the port's
``observe/history.py``, ``observe/flight.py`` and ``rollout.py``; it
runs on the host and reads each replica (a port ``GenerateAPI``, or any
front with the same ``/healthz``) over HTTP.

VELES scales training by putting a fault-tolerant master in front of
expendable slaves (PAPER.md §master/slave; ``fleet/ledger.py``); this
module is the same doctrine pointed at SERVING
(docs/elastic_serving.md). A :class:`ServePlane` owns the replica
registry behind :class:`~veles_tpu_torch.router.ElasticRouter`: it polls
each replica's ``/healthz`` (the same snapshot the fleet piggyback ships as
slave metric rows — ``veles_serve_goodput_fraction``, pool gauges, SLO
burn), derives a per-replica **goodput** and **pressure** reading, and
runs two control loops on them:

- **the leave-one-out collapse detector** (the
  ``observe/fleetscope.py`` straggler idiom generalized from training
  slaves to serving replicas): a replica whose goodput falls below
  ``retire_ratio`` x the median of the REST of the fleet for
  ``retire_polls`` consecutive polls is named — relative scoring, so a
  fleet-wide brownout (every replica slow) never scapegoats one
  replica. A replica whose ``/healthz`` stops answering scores 0.0 and
  is named by the same math — the kill -9 acceptance's detector
  contract;
- **health-gated lifecycle as governor actuations** (the
  ``observe/governor.py`` ledger discipline): ``replica_drain`` (stop
  routing new work, let leases finish), ``replica_retire`` (drained),
  ``replica_dead`` (consecutive poll/request failures past
  ``fail_threshold``), ``replica_adopt`` (a standby joins under
  sustained fleet pressure), and the suppressed variants — every
  actuation lands in the bounded ``transitions`` ledger AND the flight
  ring under the governor's own kind, with hysteresis (consecutive-poll
  streaks) and a cooldown (at most one lifecycle actuation per
  ``cooldown_s``) so a flapping replica cannot thrash the fleet.

Detector firings ride the metric-history plane exactly like rollout
regressions (``rollout.py``): the per-replica goodput is
recorded as the ``veles_ctrl_replica_goodput`` control series, the
``router_replica_collapse`` rule is detector-owned (``external=True`` —
the sampler never evaluates it), and a retire/dead actuation triggers
the cooldown-limited incident artifact whose labels NAME the replica.

Threading: the plane's state machine is single-writer — every lifecycle
decision runs on the router's poller thread (``poll``). Router handler
threads only feed :class:`Replica` counters (lease tallies, request
failures) under the replica's own lock; the poller converts threshold
crossings into actuations on its next pass. The router's routing check
(:meth:`Replica.routable`) reads GIL-atomic scalars, so a kill -9 stops
attracting traffic at the first failed REQUEST, before the next poll.

Configuration: ``root.common.serve.router.*`` (see
:meth:`ServePlaneConfig.from_spec`).
"""

import collections
import json
import threading
import time
import urllib.request

from veles_tpu_torch.core.logger import Logger

#: per-replica control series (labels: (("replica", name),))
REPLICA_GOODPUT_SERIES = "veles_ctrl_replica_goodput"
#: fleet-pressure control series (the adopt loop's sensor)
FLEET_PRESSURE_SERIES = "veles_ctrl_fleet_pressure"

#: detector-owned anomaly rule: fired by the plane, never the sampler
COLLAPSE_RULE = "router_replica_collapse"

#: bounded actuation ledger length (the governor's TRANSITION_CAP)
TRANSITION_CAP = 64

#: replica lifecycle states
STATES = ("active", "standby", "draining", "retired", "dead")


class ServePlaneConfig:
    """Validated control-plane knobs.

    - ``poll_interval_s``: health-scrape cadence;
    - ``fail_threshold``: consecutive request/poll failures before a
      replica is DEAD (routing already skips it at the threshold);
    - ``retire_ratio`` / ``retire_polls``: the leave-one-out band — a
      replica's goodput below ``retire_ratio`` x the rest-of-fleet
      median for ``retire_polls`` consecutive polls drains it;
    - ``goodput_floor``: the median floor, so an idle fleet (goodput
      ~0 everywhere) never divides by silence;
    - ``adopt_pressure`` / ``adopt_polls``: mean fleet pressure at or
      above ``adopt_pressure`` for ``adopt_polls`` polls adopts one
      standby;
    - ``cooldown_s``: at most one lifecycle actuation per window;
    - ``min_active``: a retire that would drop the active set below
      this is suppressed (ledger-visibly) unless a standby backfills.
    """

    KEYS = ("poll_interval_s", "fail_threshold", "retire_ratio",
            "retire_polls", "goodput_floor", "adopt_pressure",
            "adopt_polls", "cooldown_s", "min_active")

    def __init__(self, poll_interval_s=1.0, fail_threshold=3,
                 retire_ratio=0.5, retire_polls=3, goodput_floor=0.05,
                 adopt_pressure=0.85, adopt_polls=3, cooldown_s=10.0,
                 min_active=1, flag="root.common.serve.router"):
        self.poll_interval_s = float(poll_interval_s)
        if self.poll_interval_s <= 0:
            raise ValueError("%s: poll_interval_s must be > 0" % flag)
        self.fail_threshold = int(fail_threshold)
        if self.fail_threshold < 1:
            raise ValueError("%s: fail_threshold must be >= 1" % flag)
        self.retire_ratio = float(retire_ratio)
        if not 0 < self.retire_ratio < 1:
            raise ValueError(
                "%s: retire_ratio must be in (0, 1) — it compares a "
                "replica AGAINST the rest of the fleet" % flag)
        self.retire_polls = int(retire_polls)
        if self.retire_polls < 1:
            raise ValueError("%s: retire_polls must be >= 1" % flag)
        self.goodput_floor = float(goodput_floor)
        if self.goodput_floor <= 0:
            raise ValueError("%s: goodput_floor must be > 0" % flag)
        self.adopt_pressure = float(adopt_pressure)
        if not 0 < self.adopt_pressure <= 1:
            raise ValueError("%s: adopt_pressure must be in (0, 1]"
                             % flag)
        self.adopt_polls = int(adopt_polls)
        if self.adopt_polls < 1:
            raise ValueError("%s: adopt_polls must be >= 1" % flag)
        self.cooldown_s = float(cooldown_s)
        if self.cooldown_s < 0:
            raise ValueError("%s: cooldown_s must be >= 0" % flag)
        self.min_active = int(min_active)
        if self.min_active < 1:
            raise ValueError("%s: min_active must be >= 1" % flag)

    @classmethod
    def from_spec(cls, spec, flag="root.common.serve.router"):
        """Build from a config subtree dict or ``key=value,...``
        string (the governor's spelling); None/"" -> defaults. Unknown
        keys raise naming ``flag`` — plus the router-front keys
        (host/port/path/replicas/...) the ROUTER consumes, which are
        skipped here."""
        if spec is None or spec == "":
            return cls(flag=flag)
        if hasattr(spec, "__content__"):
            spec = spec.__content__()
        if isinstance(spec, str):
            parsed = {}
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                key, sep, value = part.partition("=")
                if not sep:
                    raise ValueError("%s: %r is not key=value"
                                     % (flag, part))
                parsed[key.strip()] = value.strip()
            spec = parsed
        if not isinstance(spec, dict):
            raise ValueError(
                "%s must be a dict or 'key=value,...' string, got %r"
                % (flag, type(spec).__name__))
        from veles_tpu_torch.router import RouterConfig
        kwargs = {}
        for key, value in spec.items():
            if key in RouterConfig.KEYS:
                continue  # the router front's keys, not the plane's
            if key not in cls.KEYS:
                raise ValueError(
                    "%s: unknown key %r (supported: %s)"
                    % (flag, key,
                       ", ".join(cls.KEYS + RouterConfig.KEYS)))
            kwargs[key] = value
        for key in ("fail_threshold", "retire_polls", "adopt_polls",
                    "min_active"):
            if key in kwargs:
                kwargs[key] = int(kwargs[key])
        for key in ("poll_interval_s", "retire_ratio", "goodput_floor",
                    "adopt_pressure", "cooldown_s"):
            if key in kwargs:
                kwargs[key] = float(kwargs[key])
        return cls(flag=flag, **kwargs)


class Replica:
    """One replica endpoint's shared record. Router handler threads
    bump lease/failure tallies; the plane's poller thread owns the
    lifecycle state — every cross-thread mutation sits under
    ``_lock``."""

    def __init__(self, url, name=None, state="active"):
        url = str(url).rstrip("/")
        if "://" not in url:
            url = "http://" + url
        self.url = url
        self.name = name or url.split("://", 1)[1]
        if state not in STATES:
            raise ValueError("unknown replica state %r" % state)
        self.state = state
        self._lock = threading.Lock()
        self._leases = 0
        self._failures = 0
        #: last /healthz snapshot (poller thread writes, others read)
        self.stats = None
        #: derived readings (None until the first successful poll)
        self.goodput = None
        self.pressure = None
        #: leave-one-out breach streak (poller thread only)
        self.collapse_streak = 0
        #: resolved-counter baseline for the goodput delta
        self._resolved_seen = None
        self._completed_seen = None

    # -- handler-thread feeds ---------------------------------------------
    def note_dispatch(self):
        with self._lock:
            self._leases += 1

    def note_done(self, ok):
        with self._lock:
            self._leases = max(0, self._leases - 1)
            if ok:
                self._failures = 0
            else:
                self._failures += 1

    def note_poll(self, ok):
        """Poller-thread feed: one health scrape's verdict."""
        with self._lock:
            if ok:
                self._failures = 0
            else:
                self._failures += 1

    @property
    def leases(self):
        with self._lock:
            return self._leases

    @property
    def failures(self):
        with self._lock:
            return self._failures

    def routable(self, fail_threshold):
        """Whether the router may send NEW work here: active AND not
        past the failure threshold (a kill -9 stops attracting traffic
        at the first failed request, before the poller's next pass)."""
        return self.state == "active" and self.failures < fail_threshold

    def snapshot(self):
        return {"name": self.name, "url": self.url, "state": self.state,
                "leases": self.leases, "failures": self.failures,
                "goodput": self.goodput, "pressure": self.pressure}


def _median(values):
    ordered = sorted(values)
    n = len(ordered)
    if not n:
        return None
    if n % 2:
        return ordered[n // 2]
    return 0.5 * (ordered[n // 2 - 1] + ordered[n // 2])


def _http_healthz(url, timeout=2.0):
    """Default health fetch: GET ``/healthz``; raises on any failure."""
    with urllib.request.urlopen(url + "/healthz",
                                timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def ensure_router_rules(history):
    """Register the detector-owned replica anomaly rule (idempotent by
    name; the rollout.py idiom — ``external=True`` so the plane syncs
    state and decides firing, never the sampler)."""
    from veles_tpu_torch.observe.history import AnomalyRule

    have = {rule.name for rule in history.rules}
    if COLLAPSE_RULE not in have:
        rule = AnomalyRule(COLLAPSE_RULE, REPLICA_GOODPUT_SERIES,
                           kind="threshold", op="<=", threshold=0.0,
                           for_samples=1, cooldown_s=5.0,
                           exclude_labels=())
        rule.external = True
        history.add_rule(rule)
    return next(r for r in history.rules if r.name == COLLAPSE_RULE)


class ServePlane(Logger):
    """The replica control plane (see module docstring). Single-writer:
    every method below except the :class:`Replica` feeds runs on ONE
    poller thread (or the test harness driving ``poll`` with an
    explicit clock)."""

    def __init__(self, replicas, standby=(), config=None,
                 clock=time.monotonic, fetch=None):
        super().__init__(logger_name="serve.Plane")
        self.config = config if config is not None else \
            ServePlaneConfig()
        self._clock = clock
        self._fetch = fetch if fetch is not None else _http_healthz
        self.replicas = []
        for rep in replicas:
            self.replicas.append(rep if isinstance(rep, Replica)
                                 else Replica(rep))
        for rep in standby:
            rep = rep if isinstance(rep, Replica) \
                else Replica(rep, state="standby")
            rep.state = "standby"
            self.replicas.append(rep)
        names = [rep.name for rep in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError("duplicate replica names: %s" % names)
        self.counters = {"polls": 0, "replica_drain": 0,
                         "replica_retire": 0, "replica_dead": 0,
                         "replica_adopt": 0,
                         "replica_retire_suppressed": 0}
        #: bounded actuation ledger (the governor's /healthz payload)
        self.transitions = collections.deque(maxlen=TRANSITION_CAP)
        self._last_actuation = None
        self._pressure_streak = 0

    # -- registry views ----------------------------------------------------
    def active(self):
        return [r for r in self.replicas if r.state == "active"]

    def standby(self):
        return [r for r in self.replicas if r.state == "standby"]

    def find(self, name):
        for rep in self.replicas:
            if rep.name == name:
                return rep
        return None

    def add_standby(self, url):
        """Register a fresh standby at runtime (the adopt loop's
        supply side)."""
        rep = Replica(url, state="standby")
        if self.find(rep.name) is not None:
            raise ValueError("replica %s already registered" % rep.name)
        self.replicas.append(rep)
        return rep

    def drop_replica(self, name):
        """Remove a DEPARTED replica from the scoring pool entirely
        (the fleetscope ``drop_slave`` idiom): its goodput must not
        keep skewing the leave-one-out medians."""
        rep = self.find(name)
        if rep is not None:
            self.replicas.remove(rep)
        return rep

    # -- the poll loop (poller thread) -------------------------------------
    def poll(self, now=None):
        """One control pass: scrape every living replica's /healthz,
        derive goodput/pressure, run the leave-one-out detector and
        the lifecycle actuators. Returns the number of replicas that
        answered."""
        if now is None:
            now = self._clock()
        self.counters["polls"] += 1
        answered = 0
        for rep in self.replicas:
            if rep.state in ("retired", "dead"):
                continue
            try:
                snap = self._fetch(rep.url)
            except Exception:
                snap = None
            if snap is not None:
                answered += 1
            self.observe(rep, snap, now)
        self._detect(now)
        self._lifecycle(now)
        return answered

    def observe(self, rep, snap, now):
        """Feed one replica's health verdict (the testable seam —
        harnesses call this directly with synthetic snapshots)."""
        rep.note_poll(snap is not None)
        if snap is None:
            rep.stats = None
            rep.goodput = 0.0
            rep.pressure = None
        else:
            rep.stats = snap
            rep.goodput = self._goodput(rep, snap)
            rep.pressure = self._pressure(snap)
        self._record_control(REPLICA_GOODPUT_SERIES, rep.goodput,
                             (("replica", rep.name),), now)

    def _goodput(self, rep, snap):
        """The replica's goodput reading: the serving goodput
        observatory's fraction when the snapshot carries one (the
        piggybacked ``veles_serve_goodput_fraction``), else the
        completed share of resolved requests over the poll delta
        (availability — the same 0..1 scale), else 1.0 (an idle,
        healthy replica is not a collapse candidate)."""
        scope = snap.get("servescope") or {}
        fraction = scope.get("goodput_fraction")
        if fraction is not None:
            return float(fraction)
        counters = snap.get("counters") or {}
        completed = int(counters.get("completed", 0))
        resolved = completed + sum(
            int(counters.get(key, 0))
            for key in ("errors", "shed", "expired"))
        if rep._resolved_seen is None:
            rep._resolved_seen = resolved
            rep._completed_seen = completed
            return 1.0
        d_resolved = resolved - rep._resolved_seen
        d_completed = completed - rep._completed_seen
        rep._resolved_seen = resolved
        rep._completed_seen = completed
        if d_resolved <= 0:
            return 1.0
        return max(0.0, min(1.0, d_completed / float(d_resolved)))

    @staticmethod
    def _pressure(snap):
        """The replica's load pressure in [0, 1]: the worst of its
        queue occupancy (inflight against the governor's effective
        admission bound when one is exposed) and its KV page-pool
        occupancy — the same two planes the single-process governor
        resizes against."""
        parts = []
        inflight = snap.get("inflight")
        governor = snap.get("governor") or {}
        limit = governor.get("effective_limit")
        if inflight is not None and limit:
            parts.append(min(1.0, float(inflight) / float(limit)))
        pool = snap.get("pool") or {}
        total = pool.get("pages_total")
        if total:
            used = max(int(pool.get("pages_used", 0)),
                       int(pool.get("reserved_pages", 0)))
            parts.append(min(1.0, used / float(total)))
        if not parts and inflight is not None:
            # no bound exposed: saturate softly against the inflight
            # count alone so a flooded bound-less replica still reads
            # as pressured
            parts.append(min(1.0, float(inflight) / 8.0))
        return max(parts) if parts else 0.0

    # -- leave-one-out collapse detector -----------------------------------
    def _detect(self, now):
        """The fleetscope straggler idiom on goodput: score each
        active replica against the median of the REST. Needs >= 2
        scored replicas — with one replica there is no 'rest of the
        fleet' to be worse than."""
        cfg = self.config
        scored = [r for r in self.active() if r.goodput is not None]
        if len(scored) < 2:
            for rep in scored:
                rep.collapse_streak = 0
            return
        for rep in scored:
            others = _median([r.goodput for r in scored if r is not rep])
            bar = cfg.retire_ratio * max(others, cfg.goodput_floor)
            if rep.goodput < bar:
                rep.collapse_streak += 1
            else:
                rep.collapse_streak = 0
            if rep.collapse_streak >= cfg.retire_polls:
                detail = ("goodput %.3f < %.2f x rest-median %.3f "
                          "for %d polls"
                          % (rep.goodput, cfg.retire_ratio, others,
                             rep.collapse_streak))
                self._drain(rep, now, detail)

    # -- lifecycle actuators -----------------------------------------------
    def _cooled(self, now):
        return self._last_actuation is None \
            or now - self._last_actuation >= self.config.cooldown_s

    def _drain(self, rep, now, reason):
        """Drain-and-retire: stop routing new work, let leases finish
        (the retire lands when they do). Suppressed — ledger-visibly —
        when the active set would fall below ``min_active`` with no
        standby to backfill."""
        if rep.state != "active" or not self._cooled(now):
            return
        backfill = self.standby()
        if len(self.active()) - 1 < self.config.min_active \
                and not backfill:
            self.counters["replica_retire_suppressed"] += 1
            self._note("replica_retire_suppressed", rep, now,
                       reason="would drop below min_active=%d with no "
                       "standby; %s" % (self.config.min_active, reason))
            rep.collapse_streak = 0
            return
        rep.state = "draining"
        rep.collapse_streak = 0
        self.counters["replica_drain"] += 1
        self._last_actuation = now
        self._note("replica_drain", rep, now, reason=reason)
        self._fire_collapse(rep, now, reason)
        if backfill:
            self._adopt(backfill[0], now,
                        reason="backfill for draining %s" % rep.name)

    def _mark_dead(self, rep, now):
        reason = ("%d consecutive request/poll failures >= %d"
                  % (rep.failures, self.config.fail_threshold))
        rep.state = "dead"
        self.counters["replica_dead"] += 1
        self._last_actuation = now
        self._note("replica_dead", rep, now, reason=reason)
        self._fire_collapse(rep, now, reason)
        backfill = self.standby()
        if backfill and len(self.active()) < self.config.min_active:
            self._adopt(backfill[0], now,
                        reason="backfill for dead %s" % rep.name)

    def _adopt(self, rep, now, reason):
        rep.state = "active"
        rep.collapse_streak = 0
        self.counters["replica_adopt"] += 1
        self._last_actuation = now
        self._note("replica_adopt", rep, now, reason=reason)

    def _lifecycle(self, now):
        """Per-poll lifecycle sweep: promote finished drains to
        retired, convert failure-threshold crossings into DEAD
        actuations, adopt a standby under sustained fleet pressure."""
        cfg = self.config
        for rep in list(self.replicas):
            if rep.state in ("active", "draining") \
                    and rep.failures >= cfg.fail_threshold:
                self._mark_dead(rep, now)
        for rep in self.replicas:
            if rep.state == "draining" and rep.leases == 0:
                rep.state = "retired"
                self.counters["replica_retire"] += 1
                self._note("replica_retire", rep, now,
                           reason="drained (0 leases)")
        active = self.active()
        pressures = [r.pressure for r in active
                     if r.pressure is not None]
        pressure = max(pressures) if pressures else 0.0
        self._record_control(FLEET_PRESSURE_SERIES, pressure, (), now)
        if pressure >= cfg.adopt_pressure:
            self._pressure_streak += 1
        else:
            self._pressure_streak = 0
        if self._pressure_streak >= cfg.adopt_polls:
            backfill = self.standby()
            if backfill and self._cooled(now):
                self._pressure_streak = 0
                self._adopt(backfill[0], now,
                            reason="fleet pressure %.2f >= %.2f for "
                            "%d polls" % (pressure, cfg.adopt_pressure,
                                          cfg.adopt_polls))

    # -- observability plumbing --------------------------------------------
    def _history(self):
        try:
            from veles_tpu_torch.observe.history import get_metric_history
            return get_metric_history()
        except Exception:
            return None

    def _record_control(self, series, value, labels, now):
        history = self._history()
        if history is None or value is None:
            return
        try:
            history.record_control(series, float(value), labels=labels,
                                   now=now)
        except Exception:
            pass

    def _fire_collapse(self, rep, now, reason):
        """Fire the detector-owned rule so the cooldown-limited
        incident artifact names the replica (the rollout.py firing
        idiom). Never raises — a broken autopsy must not mask the
        (already actuated) lifecycle decision."""
        history = self._history()
        if history is None:
            return None
        try:
            from veles_tpu_torch.rollout import _fire_rule
            rule = ensure_router_rules(history)
            labels = (("replica", rep.name),)
            path = _fire_rule(history, rule, rep.goodput or 0.0,
                              labels, now, reason)
            # one replica's collapse is a one-shot event against that
            # replica — clear the breach so a LATER incident's
            # leading-indicator ordering starts fresh
            rule.streak = 0
            rule.breach_since = None
            return path
        except Exception:
            self.exception("collapse incident bookkeeping failed "
                           "(swallowed)")
            return None

    def _note(self, action, rep, now, reason=""):
        """One ledger-visible actuation: bounded transition history +
        the flight ring under the governor kind (the single-process
        governor's discipline, fleet-level)."""
        entry = {"action": action, "replica": rep.name,
                 "state": rep.state, "reason": reason,
                 "t": time.time(), "mono": now}
        self.transitions.append(entry)
        try:
            from veles_tpu_torch.observe.flight import get_flight_recorder
            get_flight_recorder().note(
                "governor", action=action, replica=rep.name,
                state=rep.state, reason=reason)
        except Exception:
            pass
        self.info("plane %s %s%s", action, rep.name,
                  (": " + reason) if reason else "")

    def snapshot(self):
        """The router's /healthz fleet view."""
        return {"replicas": [rep.snapshot() for rep in self.replicas],
                "active": len(self.active()),
                "standby": len(self.standby()),
                "counters": dict(self.counters),
                "transitions": list(self.transitions)[-8:]}
