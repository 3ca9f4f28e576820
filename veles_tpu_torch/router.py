"""Elastic replicated serving: a fault-tolerant HTTP front over N
``GenerateAPI`` replicas (``python -m veles_tpu_torch route --replicas
...``).

The port's copy of ``veles_tpu/router.py``, on the port's
``core/httpd.py``, ``serving.ServingHealth`` and ``observe/metrics.py``.
It runs on the host; the replicas behind it are the port's
``GenerateAPI`` processes, which launch their kernels on the card.

VELES's master/slave doctrine, pointed at serving
(docs/elastic_serving.md): one logical ``POST /generate`` endpoint whose
death-of-a-replica is a retry, not an outage. The router

- **admits once** at the fleet level — its own
  :class:`~veles_tpu_torch.serving.ServingHealth` runs the same
  ``try_admit`` gate every replica runs per-process, so a burst is
  shed at the front with a priced ``Retry-After`` instead of being
  sprayed across N already-full replicas;
- **routes by affinity, spills by pressure** — the request's
  page-aligned prefix key is consistent-hashed onto the replica ring
  (:class:`HashRing`), so shared-prefix requests land on the replica
  whose prefix cache already holds their pages (the hit rate survives
  the spread); a primary owner above ``spill_pressure`` (live pool +
  queue occupancy from the control plane's /healthz polls) spills to
  the next owner on the ring, and requests with no reusable prefix go
  to the least-pressured replica outright;
- **holds a lease per request with an exactly-once fence**
  (:class:`Lease`) — a replica that dies mid-stream (connection drop,
  kill -9, breaker trip) fails its attempt and the request is
  transparently re-dispatched to the next healthy replica with
  ``Retry-After``-priced backoff; a slow-then-recovered replica's late
  response is DISCARDED by the fence (first terminal offer wins),
  never double-delivered. A replica that is merely slow past
  ``hedge_after_s`` gets hedged: the next replica races it, the fence
  keeps delivery exactly-once either way;
- **runs the replica lifecycle** on a poller thread —
  :class:`~veles_tpu_torch.fleet.serve_plane.ServePlane` scrapes each
  replica's ``/healthz`` (goodput fraction, pool gauges, SLO burn —
  the same rows the fleet piggyback ships), names collapsed replicas
  with the leave-one-out detector, and drains/retires/adopts as
  ledger-visible governor actuations.

Failure honesty: when every replica is down the front answers 503 with
a ``Retry-After`` priced from the replicas' own most recent prices (or
the control plane's detection horizon) — never a dead-air hang, never
a bare 500. Non-retryable replica verdicts (400/413) pass through
untouched: a bad request does not deserve a failover tour.

Configuration: ``root.common.serve.router.*`` — the router-front keys
(:attr:`RouterConfig.KEYS`) and the control-plane keys
(:attr:`~veles_tpu_torch.fleet.serve_plane.ServePlaneConfig.KEYS`) share the
one subtree, each side skipping the other's keys.

Observability (docs/observability.md): ``veles_router_requests_total``
{outcome}, ``veles_router_retries_total``,
``veles_router_failovers_total``,
``veles_router_affinity_{hits,misses}_total``,
``veles_router_late_discards_total``, the
``veles_router_failover_seconds`` histogram, and per-replica
``veles_router_replica_{goodput,pressure,leases}`` gauge families
published at scrape time via the weak-bridge collector.
"""

import argparse
import bisect
import hashlib
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler

from veles_tpu_torch.core.httpd import (BodyTooLarge, QuietHandlerMixin,
                                        enable_metrics, read_body, reply,
                                        retry_after_headers, serve_health,
                                        serve_metrics, start_server)
from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.fleet.serve_plane import ServePlane, ServePlaneConfig
from veles_tpu_torch.observe.history import release_history_sampler

#: bounded windows: failover-latency samples / replica Retry-After
#: prices the all-down 503 consults
FAILOVER_WINDOW = 256
PRICE_WINDOW = 32

#: failover-latency histogram buckets (seconds)
FAILOVER_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class RouterConfig:
    """The router-front knobs (the control-plane knobs live in
    :class:`~veles_tpu_torch.fleet.serve_plane.ServePlaneConfig`; both read
    the one ``root.common.serve.router`` subtree).

    - ``max_inflight``: the fleet-level admission bound (None/0 =
      unbounded);
    - ``attempt_timeout_s``: per-attempt socket budget;
    - ``hedge_after_s``: how long a single attempt may stay silent
      before the next replica races it (the fence keeps delivery
      exactly-once);
    - ``max_attempts``: distinct replicas tried per request;
    - ``backoff_s``: base backoff between attempts when the failed
      replica supplied no ``Retry-After`` price;
    - ``page_size``: the prefix key's alignment quantum — MUST match
      the replicas' KV page size or affinity decays to random;
    - ``vnodes``: ring points per replica (affinity smoothness);
    - ``spill_pressure``: primary-owner pressure at which affinity
      yields to load.
    """

    KEYS = ("host", "port", "replicas", "standby", "max_inflight",
            "attempt_timeout_s", "hedge_after_s", "max_attempts",
            "backoff_s", "page_size", "vnodes", "spill_pressure")

    def __init__(self, host="127.0.0.1", port=0, replicas="",
                 standby="", max_inflight=64, attempt_timeout_s=30.0,
                 hedge_after_s=2.0, max_attempts=3, backoff_s=0.05,
                 page_size=16, vnodes=64, spill_pressure=0.9,
                 flag="root.common.serve.router"):
        self.host = str(host)
        self.port = int(port)
        self.replicas = replicas
        self.standby = standby
        self.max_inflight = None if max_inflight in (None, "", 0) \
            else int(max_inflight)
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError("%s: max_inflight must be >= 1 (or 0 for "
                             "unbounded)" % flag)
        self.attempt_timeout_s = float(attempt_timeout_s)
        if self.attempt_timeout_s <= 0:
            raise ValueError("%s: attempt_timeout_s must be > 0" % flag)
        self.hedge_after_s = float(hedge_after_s)
        if self.hedge_after_s <= 0:
            raise ValueError("%s: hedge_after_s must be > 0" % flag)
        self.max_attempts = int(max_attempts)
        if self.max_attempts < 1:
            raise ValueError("%s: max_attempts must be >= 1" % flag)
        self.backoff_s = float(backoff_s)
        if self.backoff_s < 0:
            raise ValueError("%s: backoff_s must be >= 0" % flag)
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError("%s: page_size must be >= 1" % flag)
        self.vnodes = int(vnodes)
        if self.vnodes < 1:
            raise ValueError("%s: vnodes must be >= 1" % flag)
        self.spill_pressure = float(spill_pressure)
        if not 0 < self.spill_pressure <= 1:
            raise ValueError("%s: spill_pressure must be in (0, 1]"
                             % flag)

    @classmethod
    def from_spec(cls, spec, flag="root.common.serve.router"):
        """Build from a config subtree dict or ``key=value,...``
        string; control-plane keys are skipped (the plane consumes
        them). None/"" -> defaults."""
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
        kwargs = {}
        for key, value in spec.items():
            if key in ServePlaneConfig.KEYS:
                continue  # the control plane's keys, not the front's
            if key not in cls.KEYS:
                raise ValueError(
                    "%s: unknown key %r (supported: %s)"
                    % (flag, key,
                       ", ".join(cls.KEYS + ServePlaneConfig.KEYS)))
            kwargs[key] = value
        for key in ("port", "max_inflight", "max_attempts",
                    "page_size", "vnodes"):
            if key in kwargs:
                kwargs[key] = int(kwargs[key])
        for key in ("attempt_timeout_s", "hedge_after_s", "backoff_s",
                    "spill_pressure"):
            if key in kwargs:
                kwargs[key] = float(kwargs[key])
        return cls(flag=flag, **kwargs)

    @classmethod
    def from_config(cls, flag="root.common.serve.router"):
        """Build from the live ``root.common.serve.router`` subtree."""
        from veles_tpu_torch.core.config import root
        cfg = root.common.serve.router
        kwargs = {}
        for key in cls.KEYS:
            value = cfg.get(key, None)
            if value is not None:
                kwargs[key] = value
        return cls(flag=flag, **kwargs)


class HashRing:
    """Consistent-hash ring over replica NAMES: each replica owns
    ``vnodes`` pseudo-random points; a key's owners are the distinct
    replicas met walking clockwise from the key's point. Adding or
    removing one replica remaps only the keys whose nearest points
    belonged to it — every other prefix keeps its owner, which is the
    whole reason affinity survives replica churn."""

    def __init__(self, names, vnodes=64):
        points = []
        for name in sorted(names):
            for i in range(vnodes):
                digest = hashlib.sha1(
                    ("%s#%d" % (name, i)).encode()).digest()
                points.append((int.from_bytes(digest[:8], "big"), name))
        points.sort()
        self._points = points
        self._keys = [point for point, _ in points]

    def owners(self, key):
        """Replica names in ring order from ``key``'s successor point,
        deduplicated — ``owners(k)[0]`` is the affinity primary, the
        rest are the spill order."""
        if not self._points:
            return []
        digest = hashlib.sha1(key).digest()
        start = bisect.bisect_right(
            self._keys, int.from_bytes(digest[:8], "big"))
        seen, order = set(), []
        n = len(self._points)
        for i in range(n):
            name = self._points[(start + i) % n][1]
            if name not in seen:
                seen.add(name)
                order.append(name)
        return order


def prefix_key(tokens, page_size):
    """The affinity key: the request's prompt truncated to the KV page
    boundary (only WHOLE pages are reusable across requests —
    ``kv_pool.PrefixCache`` keys the same way), hashed. None when the
    prompt has no complete page: nothing is reusable, so the request
    should chase load, not affinity."""
    aligned = (len(tokens) // page_size) * page_size
    if aligned <= 0:
        return None
    return hashlib.sha1(
        ",".join(str(int(t)) for t in tokens[:aligned]).encode()
    ).digest()


class Lease:
    """One routed request's delivery fence: attempts (original,
    failover, hedge) race to resolve it, and the FIRST terminal offer
    wins — every later one is counted and dropped, so a
    slow-then-recovered replica can never double-deliver. All state
    transitions sit under ``_lock`` (attempt threads + the dispatch
    loop share this object; ``shared.rmw`` doctrine)."""

    def __init__(self, key):
        self.key = key
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._resolved = False
        self._outstanding = 0
        #: (status, payload_bytes, replica_name) — the winning offer
        self.outcome = None
        self.winner = None
        #: late terminal offers discarded by the fence
        self.late = 0
        #: (replica, kind, retry_after_s|None) per failed attempt
        self.failures = []
        #: monotonic instant of the first attempt failure (failover
        #: latency = winner's arrival minus this)
        self.first_failure_at = None

    def launch(self):
        with self._lock:
            self._outstanding += 1

    def offer(self, replica, status, payload):
        """A terminal verdict (2xx success or a non-retryable
        pass-through). Returns True when this offer won the fence."""
        with self._lock:
            self._outstanding -= 1
            if self._resolved:
                self.late += 1
                self._cond.notify_all()
                return False
            self._resolved = True
            self.winner = replica
            self.outcome = (status, payload, replica)
            self._cond.notify_all()
            return True

    def fail(self, replica, kind, retry_after=None, now=None):
        """A retryable attempt failure (connection drop, timeout,
        replica 429/503/5xx)."""
        with self._lock:
            self._outstanding -= 1
            if not self._resolved:
                self.failures.append((replica, kind, retry_after))
                if self.first_failure_at is None:
                    self.first_failure_at = now if now is not None \
                        else time.monotonic()
            self._cond.notify_all()

    def wait(self, timeout):
        """Block until resolved, or until no attempt is outstanding,
        or ``timeout``. Returns (resolved, outstanding)."""
        with self._lock:
            self._cond.wait_for(
                lambda: self._resolved or self._outstanding == 0,
                timeout=timeout)
            return self._resolved, self._outstanding

    @property
    def resolved(self):
        with self._lock:
            return self._resolved

    def failure_count(self):
        with self._lock:
            return len(self.failures)

    def last_price(self):
        """The most recent failure's replica-supplied Retry-After
        price (None when the failure carried none)."""
        with self._lock:
            for _, _, price in reversed(self.failures):
                if price is not None:
                    return price
            return None


def _parse_retry_after(headers):
    try:
        value = headers.get("Retry-After")
        return float(value) if value is not None else None
    except (TypeError, ValueError):
        return None


def _http_post(url, body, headers, timeout):
    """Default attempt transport: POST ``body`` to ``url``; returns
    (status, headers_dict, payload_bytes). HTTP error statuses return
    normally (they are replica VERDICTS); only transport failures
    (connection refused/reset, timeout, half-stream EOF) raise."""
    request = urllib.request.Request(url, data=body, headers=headers,
                                     method="POST")
    try:
        with urllib.request.urlopen(request, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        with err:
            return err.code, dict(err.headers or {}), err.read()


class RouterHealth:
    """The fleet-level admission gate: delegates every counter to a
    real :class:`~veles_tpu_torch.serving.ServingHealth` (the SAME
    ``try_admit`` semantics each replica runs per-process) and extends
    the snapshot/readiness with the control plane's fleet view —
    ``/readyz`` is True only while at least one replica is routable."""

    def __init__(self, plane):
        import weakref

        from veles_tpu_torch.serving import ServingHealth
        self._health = ServingHealth(name="router")
        self._health.set_ready(True)
        self._plane_ref = weakref.ref(plane)

    def __getattr__(self, name):
        return getattr(self._health, name)

    @property
    def ready(self):
        plane = self._plane_ref()
        if plane is None or not self._health.ready:
            return False
        threshold = plane.config.fail_threshold
        return any(rep.routable(threshold) for rep in plane.replicas)

    def snapshot(self):
        snap = self._health.snapshot()
        plane = self._plane_ref()
        if plane is not None:
            snap["plane"] = plane.snapshot()
        return snap


class ElasticRouter(Logger):
    """The router front (see module docstring). Handler threads call
    :meth:`handle_generate`; one poller thread runs the control
    plane's lifecycle; attempt threads race inside each request's
    :class:`Lease`. Cross-thread tallies (counters, failover samples,
    replica prices) sit under ``self._lock``."""

    def __init__(self, plane, config=None, transport=None,
                 clock=time.monotonic, sleep=time.sleep):
        super().__init__(logger_name="serve.Router")
        self.config = config if config is not None else RouterConfig()
        self.plane = plane
        self.health = RouterHealth(plane)
        self._transport = transport if transport is not None \
            else _http_post
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._counters = {"requests": 0, "retries": 0, "failovers": 0,
                          "affinity_hits": 0, "affinity_misses": 0,
                          "late_discards": 0, "all_down": 0}
        import collections
        self._failover_s = collections.deque(maxlen=FAILOVER_WINDOW)
        self._prices = collections.deque(maxlen=PRICE_WINDOW)
        self._ring = HashRing((), vnodes=self.config.vnodes)
        self._ring_names = frozenset()
        self._httpd = None
        self.port = None
        self._stop = threading.Event()
        self._poller = None
        from veles_tpu_torch.observe.metrics import (bridge,
                                               get_metrics_registry)
        self._registry = get_metrics_registry()
        bridge(self._registry, self, _publish_router)

    # -- counters (handler + attempt threads) -----------------------------
    def _count(self, key, n=1):
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def counter(self, key):
        with self._lock:
            return self._counters.get(key, 0)

    def _note_failover_s(self, seconds):
        with self._lock:
            self._failover_s.append(float(seconds))
        self._registry.observe(
            "veles_router_failover_seconds", float(seconds),
            buckets=FAILOVER_BUCKETS,
            help="failed-attempt instant to winning failover response "
                 "(router.py)")

    def _note_price(self, seconds):
        if seconds is None:
            return
        with self._lock:
            self._prices.append(float(seconds))

    def failover_ms_samples(self):
        with self._lock:
            return [s * 1000.0 for s in self._failover_s]

    # -- ring + pick -------------------------------------------------------
    def _ring_for(self, names):
        """The current active set's ring, rebuilt only on membership
        change (so every unchanged prefix keeps its owner)."""
        names = frozenset(names)
        with self._lock:
            if names != self._ring_names:
                self._ring = HashRing(names,
                                      vnodes=self.config.vnodes)
                self._ring_names = names
            return self._ring

    def _pick(self, key, exclude):
        """One routing decision: (replica, affinity_primary) or
        (None, False) when no routable replica remains outside
        ``exclude``. Affinity first — the key's ring owners in order,
        skipping excluded/unroutable/over-pressure replicas — then
        least-pressure among the routable rest."""
        threshold = self.plane.config.fail_threshold
        active = [rep for rep in self.plane.replicas
                  if rep.state == "active"]
        routable = [rep for rep in active
                    if rep.routable(threshold)
                    and rep.name not in exclude]
        if not routable:
            return None, False
        if key is not None:
            ring = self._ring_for(rep.name for rep in active)
            by_name = {rep.name: rep for rep in routable}
            order = ring.owners(key)
            for rank, name in enumerate(order):
                rep = by_name.get(name)
                if rep is None:
                    continue
                pressure = rep.pressure
                if pressure is not None \
                        and pressure >= self.config.spill_pressure \
                        and len(routable) > 1:
                    continue
                return rep, rank == 0
            # every owner over-pressured: fall through to load
        rep = min(routable,
                  key=lambda r: ((r.pressure if r.pressure is not None
                                  else 0.0), r.leases, r.name))
        return rep, False

    # -- the lease/attempt machinery ---------------------------------------
    def _attempt(self, lease, rep, body, headers, deadline):
        """One replica attempt (runs on its own thread so a slow
        replica can be hedged). Terminal verdicts (2xx, 400/413) offer
        into the fence; busy verdicts (429/503) and transport failures
        fail the lease as retryable."""
        now = self._clock()
        timeout = min(self.config.attempt_timeout_s,
                      max(0.05, deadline - now))
        rep.note_dispatch()
        try:
            status, resp_headers, payload = self._transport(
                rep.url + "/generate", body, headers, timeout)
        except Exception as err:
            rep.note_done(False)
            self._count("failovers")
            lease.fail(rep.name, "transport:%s" % type(err).__name__,
                       now=self._clock())
            return
        if status in (429, 503):
            rep.note_done(True)  # the replica ANSWERED; it is busy,
            # not broken — its failure counter must not trip
            price = _parse_retry_after(resp_headers)
            self._note_price(price)
            self._count("retries")
            lease.fail(rep.name, "busy:%d" % status, retry_after=price,
                       now=self._clock())
            return
        if status >= 500:
            rep.note_done(False)
            self._count("failovers")
            lease.fail(rep.name, "status:%d" % status,
                       now=self._clock())
            return
        rep.note_done(True)
        won = lease.offer(rep.name, status, payload)
        if not won:
            self._count("late_discards")
        elif lease.first_failure_at is not None:
            self._note_failover_s(self._clock()
                                  - lease.first_failure_at)

    def dispatch(self, tokens, body, headers, deadline):
        """Route one admitted request: affinity pick, lease, failover
        and hedging until a terminal verdict or the replica set /
        deadline is exhausted. Returns the :class:`Lease`."""
        cfg = self.config
        key = prefix_key(tokens, cfg.page_size)
        lease = Lease(key)
        tried = set()
        attempts = 0
        while not lease.resolved:
            now = self._clock()
            if now >= deadline:
                break
            rep, primary = (None, False)
            if attempts < cfg.max_attempts:
                rep, primary = self._pick(key, tried)
            if rep is None:
                # nothing new to try: ride out any outstanding attempt
                resolved, outstanding = lease.wait(
                    min(1.0, max(0.05, deadline - now)))
                if resolved or outstanding == 0:
                    break
                continue
            if attempts > 0:
                # Retry-After-priced backoff: the failed replica's own
                # price when it gave one, else the base backoff —
                # never past the deadline
                pause = lease.last_price()
                if pause is None:
                    pause = cfg.backoff_s * attempts
                pause = min(pause, max(0.0, deadline - self._clock()))
                if pause > 0:
                    self._sleep(min(pause, 5.0))
            if key is not None:
                self._count("affinity_hits" if primary
                            else "affinity_misses")
            tried.add(rep.name)
            attempts += 1
            lease.launch()
            thread = threading.Thread(
                target=self._attempt,
                args=(lease, rep, body, headers, deadline),
                name="router-attempt-%s" % rep.name, daemon=True)
            thread.start()
            lease.wait(cfg.hedge_after_s)
        return lease

    # -- the HTTP surface --------------------------------------------------
    def handle_generate(self, handler, raw):
        """The routed ``POST /generate``: validate -> admit once ->
        dispatch -> relay the winning verdict (or the honest all-down
        503)."""
        self._count("requests")
        try:
            body = json.loads(raw.decode() or "{}")
        except (UnicodeDecodeError, ValueError):
            body = None
        tokens = body.get("tokens") if isinstance(body, dict) else None
        if not isinstance(tokens, list) or not tokens \
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in tokens):
            reply(handler, {"error": "body must be JSON with a "
                                     "non-empty integer 'tokens' "
                                     "list"}, code=400)
            self._registry.incr(
                "veles_router_requests_total",
                labels={"outcome": "bad_request"},
                help="routed requests by outcome (router.py)")
            return
        verdict = self.health.try_admit(self.config.max_inflight)
        if verdict is not None:
            kind = verdict[0] if isinstance(verdict, tuple) else verdict
            code = 503 if kind == "unready" else 429
            reply(handler, {"error": "router %s" % kind}, code=code,
                  headers=retry_after_headers(self.health))
            self._registry.incr("veles_router_requests_total",
                                labels={"outcome": "rejected"})
            return
        trace = handler.headers.get("X-Veles-Trace") \
            if handler.headers else None
        fwd_headers = {"Content-Type": "application/json"}
        for name in ("X-Veles-Trace", "X-Veles-Tenant"):
            value = handler.headers.get(name) if handler.headers \
                else None
            if value:
                fwd_headers[name] = value
        deadline_s = 30.0
        if isinstance(body, dict):
            try:
                deadline_s = float(body.get("deadline_s", deadline_s))
            except (TypeError, ValueError):
                pass
        deadline = self._clock() + max(0.05, min(deadline_s, 86400.0))
        lease = self.dispatch(tokens, raw, fwd_headers, deadline)
        echo = {"X-Veles-Trace": trace} if trace else {}
        if lease.outcome is not None:
            status, payload, replica = lease.outcome
            self.health.release("completed" if status < 400
                                else "errors")
            self._registry.incr(
                "veles_router_requests_total",
                labels={"outcome": "completed" if status < 400
                        else "passthrough_%d" % status})
            reply(handler, payload, code=status,
                  headers=dict(echo, **{"X-Veles-Replica": replica}))
            return
        # no terminal verdict: every routable replica is down or busy
        self._count("all_down")
        self.health.release("shed")
        self._registry.incr("veles_router_requests_total",
                            labels={"outcome": "unavailable"})
        reply(handler,
              {"error": "no replica available",
               "failures": [{"replica": name, "kind": kind}
                            for name, kind, _ in lease.failures]},
              code=503,
              headers=dict(echo, **self._down_retry_headers()))

    def _down_retry_headers(self):
        """The all-down 503's honest price: the replicas' own most
        recent Retry-After quotes when any exist, else the control
        plane's detection horizon (a dead replica is noticed within
        ``fail_threshold`` polls)."""
        with self._lock:
            prices = list(self._prices)
        if prices:
            seconds = max(prices)
        else:
            plane_cfg = self.plane.config
            seconds = plane_cfg.poll_interval_s \
                * plane_cfg.fail_threshold
        return {"Retry-After": "%d" % int(min(60, max(1,
                                                      round(seconds))))}

    def snapshot(self):
        with self._lock:
            counters = dict(self._counters)
            failover_ms = [s * 1000.0 for s in self._failover_s]
        return {"counters": counters, "failover_ms": failover_ms,
                "config": {key: getattr(self.config, key)
                           for key in ("max_inflight", "hedge_after_s",
                                       "max_attempts", "page_size",
                                       "spill_pressure")},
                "plane": self.plane.snapshot()}

    # -- lifecycle ---------------------------------------------------------
    def _poll_loop(self):
        while not self._stop.wait(self.plane.config.poll_interval_s):
            try:
                self.plane.poll()
            except Exception:
                self.exception("control-plane poll failed (swallowed)")

    def start(self):
        """Bind the HTTP front and start the control-plane poller.
        Returns self; ``router.port`` is the resolved port."""
        # this front holds the metric history's sampler until stop()
        enable_metrics(self)
        router = self

        class Handler(QuietHandlerMixin, BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?")[0]
                if serve_metrics(self):
                    return
                if path == "/debug/router":
                    reply(self, router.snapshot())
                    return
                if serve_health(self, router.health):
                    return
                reply(self, {"error": "unknown path %s" % path},
                      code=404)

            def do_POST(self):
                if self.path.split("?")[0] != "/generate":
                    reply(self, {"error": "unknown path"}, code=404)
                    return
                try:
                    raw = read_body(self)
                except BodyTooLarge:
                    return
                router.handle_generate(self, raw)

        self._httpd, self.port = start_server(
            Handler, self.config.host, self.config.port, name="router")
        self._stop.clear()
        self._poller = threading.Thread(target=self._poll_loop,
                                        name="router-poller",
                                        daemon=True)
        self._poller.start()
        self.info("router listening on %s:%d over %d replicas",
                  self.config.host, self.port,
                  len(self.plane.replicas))
        return self

    def stop(self):
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=5.0)
            self._poller = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        release_history_sampler(self)


def _publish_router(registry, router):
    """Scrape-time bridge: the router's cumulative tallies and the
    fleet's per-replica gauges."""
    with router._lock:
        counters = dict(router._counters)
    for key, metric in (("retries", "veles_router_retries_total"),
                        ("failovers", "veles_router_failovers_total"),
                        ("affinity_hits",
                         "veles_router_affinity_hits_total"),
                        ("affinity_misses",
                         "veles_router_affinity_misses_total"),
                        ("late_discards",
                         "veles_router_late_discards_total")):
        registry.counter_set(metric, counters.get(key, 0),
                             help="router %s (router.py)"
                                  % key.replace("_", " "))
    goodput, pressure, leases = [], [], []
    for rep in router.plane.replicas:
        labels = {"replica": rep.name, "state": rep.state}
        if rep.goodput is not None:
            goodput.append((labels, rep.goodput))
        if rep.pressure is not None:
            pressure.append((labels, rep.pressure))
        leases.append((labels, rep.leases))
    registry.set_gauge_family(
        "veles_router_replica_goodput", goodput,
        help="per-replica goodput the control plane scored "
             "(fleet/serve_plane.py)")
    registry.set_gauge_family(
        "veles_router_replica_pressure", pressure,
        help="per-replica queue/pool pressure (fleet/serve_plane.py)")
    registry.set_gauge_family(
        "veles_router_replica_leases", leases,
        help="in-flight router leases per replica (router.py)")


def build_router(replicas, standby=(), spec=None):
    """Construct (plane, router) from replica URL lists + an optional
    shared spec (dict or ``key=value,...``) covering both key sets."""
    plane_cfg = ServePlaneConfig.from_spec(spec)
    router_cfg = RouterConfig.from_spec(spec)
    plane = ServePlane(replicas, standby=standby, config=plane_cfg)
    return plane, ElasticRouter(plane, config=router_cfg)


def main(argv=None):
    """``veles_tpu_torch route --replicas URL,URL [...]`` — run the elastic
    front in the foreground."""
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch route",
        description="fault-tolerant router over N GenerateAPI "
                    "replicas (docs/elastic_serving.md)")
    parser.add_argument("--replicas", required=True,
                        help="comma-separated replica base URLs")
    parser.add_argument("--standby", default="",
                        help="comma-separated standby replica URLs "
                             "(adopted under sustained pressure)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8800)
    parser.add_argument(
        "--spec", default=None,
        help="key=value,... overrides for RouterConfig + "
             "ServePlaneConfig (e.g. 'hedge_after_s=1,retire_polls=5')")
    args = parser.parse_args(argv)
    replicas = [u.strip() for u in args.replicas.split(",")
                if u.strip()]
    standby = [u.strip() for u in args.standby.split(",") if u.strip()]
    plane, router = build_router(replicas, standby=standby,
                                 spec=args.spec)
    router.config.host = args.host
    router.config.port = args.port
    router.start()
    print("router listening on http://%s:%d (%d replicas, %d standby)"
          % (args.host, router.port, len(replicas), len(standby)))
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        router.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
