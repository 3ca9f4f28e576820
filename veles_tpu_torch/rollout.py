"""Blue-green rollout with SLO-burn auto-rollback.

The port of ``veles_tpu/rollout.py``: the deploy plane's second half
(the first is ``ContinuousDecoder.swap_params`` behind the driver's
drain seam). ``GenerateAPI.begin_rollout`` builds and probes a second
decode engine ("green") on the candidate weights while the primary
("blue") keeps serving; this module owns everything after that probe:

- **traffic shifting**: a tenant hashes to a fixed point in [0, 1)
  (``crc32(tenant) % 10000 / 10000``); the rollout's fraction is the cut
  line, so raising it only adds tenants to green and a tenant never flaps
  between engines. Blue's streams stay bit-identical to a run with no
  deploy;
- **the rollback predicate**: the green slice's burn and TTFT against
  the blue slice's concurrent baseline, never an absolute threshold (when
  blue burns too the regression is ambient: the rollback is suppressed,
  and the suppression is itself a ledger-visible actuation). Both feeds
  are recorded as ``veles_ctrl_deploy_*`` control series in the metric
  history;
- **hysteresis and cooldown**: ``breach_for`` consecutive bad ticks roll
  back; shifts wait ``max(hold_s, cooldown_s)``; a suppression notes at
  most once a cooldown. A rollback drains green first (every green
  request finishes on the candidate: nothing is shed), then the driver
  retires the engine;
- **incident artifacts**: a rollback (or a refused hot swap) fires a
  detector-owned anomaly rule (``external=True``: its state is synced
  here, never by the sampler), so the incident bundle names the leading
  indicator, burn or TTFT.

Configuration: ``root.common.serve.rollout.*``
(:meth:`RolloutConfig.from_config`).
"""

import collections
import time
import zlib

from veles_tpu_torch.core.logger import Logger

#: control-series names (recorded per tick, labels=(("version", role),))
BURN_SERIES = "veles_ctrl_deploy_burn"
TTFT_SERIES = "veles_ctrl_deploy_ttft_ms"
SWAP_SERIES = "veles_ctrl_deploy_swap_failed"

#: tenant-hash resolution: fractions are effectively quantized to
#: 1/10000, plenty for bounded tenant ids
_HASH_BUCKETS = 10000


class RolloutConfig:
    """Validated rollout knobs.

    - ``steps``: the traffic-fraction ladder (sorted, each in (0, 1];
      1.0 is appended when missing — a rollout always ends at full
      traffic or rolled back);
    - ``hold_s`` / ``cooldown_s``: minimum dwell per rung / minimum
      gap between ledger-visible actuations (shift, suppression);
    - ``window_s`` / ``min_requests``: the trend window and the
      zero-traffic guard — fewer green requests than ``min_requests``
      in the window means NO verdict (never a false rollback on an
      idle slice);
    - ``burn_ratio`` / ``burn_floor``: green rolls back when its burn
      >= ``burn_ratio * max(blue_burn, burn_floor)`` — the floor keeps
      a 0-burn blue baseline from making any green imperfection
      infinitely worse;
    - ``ttft_ratio`` / ``ttft_floor_s``: same shape for the TTFT mean;
    - ``blue_burn_veto``: blue burning at/above this suppresses
      rollback (the regression is ambient);
    - ``breach_for``: consecutive bad ticks before rolling back;
    - ``interval_s``: tick rate limit (rides the driver loop).
    """

    KEYS = ("steps", "hold_s", "cooldown_s", "window_s",
            "min_requests", "burn_ratio", "burn_floor", "ttft_ratio",
            "ttft_floor_s", "blue_burn_veto", "breach_for",
            "interval_s")

    def __init__(self, steps=(0.1, 0.5, 1.0), hold_s=20.0,
                 cooldown_s=30.0, window_s=120.0, min_requests=6,
                 burn_ratio=2.0, burn_floor=1.0, ttft_ratio=3.0,
                 ttft_floor_s=0.02, blue_burn_veto=6.0, breach_for=2,
                 interval_s=1.0, flag="root.common.serve.rollout"):
        if isinstance(steps, str):
            steps = tuple(float(s) for s in steps.split("+") if s)
        steps = tuple(float(s) for s in steps)
        if not steps:
            raise ValueError("%s: steps must not be empty" % flag)
        for frac in steps:
            if not 0.0 < frac <= 1.0:
                raise ValueError(
                    "%s: every step must be a traffic fraction in "
                    "(0, 1], got %r" % (flag, frac))
        if list(steps) != sorted(steps):
            raise ValueError("%s: steps %r must be ascending"
                             % (flag, steps))
        if steps[-1] < 1.0:
            steps = steps + (1.0,)
        self.steps = steps
        self.hold_s = float(hold_s)
        self.cooldown_s = float(cooldown_s)
        if self.hold_s < 0 or self.cooldown_s < 0:
            raise ValueError("%s: hold_s/cooldown_s must be >= 0"
                             % flag)
        self.window_s = float(window_s)
        if self.window_s <= 0:
            raise ValueError("%s: window_s must be > 0" % flag)
        self.min_requests = int(min_requests)
        if self.min_requests < 1:
            raise ValueError("%s: min_requests must be >= 1" % flag)
        self.burn_ratio = float(burn_ratio)
        self.ttft_ratio = float(ttft_ratio)
        if self.burn_ratio < 1.0 or self.ttft_ratio < 1.0:
            raise ValueError(
                "%s: burn_ratio/ttft_ratio must be >= 1 (green is "
                "compared AGAINST blue)" % flag)
        self.burn_floor = float(burn_floor)
        self.ttft_floor_s = float(ttft_floor_s)
        if self.burn_floor <= 0 or self.ttft_floor_s <= 0:
            raise ValueError(
                "%s: burn_floor/ttft_floor_s must be > 0 (the ratio "
                "needs a nonzero baseline)" % flag)
        self.blue_burn_veto = float(blue_burn_veto)
        if self.blue_burn_veto <= 0:
            raise ValueError("%s: blue_burn_veto must be > 0" % flag)
        self.breach_for = int(breach_for)
        if self.breach_for < 1:
            raise ValueError("%s: breach_for must be >= 1" % flag)
        self.interval_s = float(interval_s)
        if self.interval_s <= 0:
            raise ValueError("%s: interval_s must be > 0" % flag)

    @classmethod
    def from_config(cls, flag="root.common.serve.rollout"):
        """Build from ``root.common.serve.rollout.*`` (defaults apply
        for any unset key)."""
        from veles_tpu_torch.core.config import root
        cfg = root.common.serve.rollout
        kwargs = {}
        for key in cls.KEYS:
            value = cfg.get(key, None)
            if value is not None:
                kwargs[key] = value
        return cls(flag=flag, **kwargs)


def _history():
    """The process MetricHistory, or None (a rollout without one
    still shifts/rolls back — only the autopsy trail is thinner)."""
    try:
        from veles_tpu_torch.observe.history import get_metric_history
        return get_metric_history()
    except Exception:
        return None


def ensure_deploy_rules(history):
    """Register the detector-owned deploy anomaly rules (idempotent by
    name). ``external=True``: the ROLLOUT syncs their state and
    decides firing — the sampler never evaluates them (its window
    semantics would race the predicate's and double-fire)."""
    from veles_tpu_torch.observe.history import AnomalyRule

    have = {rule.name for rule in history.rules}
    specs = (
        ("deploy_green_burn", BURN_SERIES),
        ("deploy_green_ttft", TTFT_SERIES),
        ("deploy_swap_probe", SWAP_SERIES),
    )
    out = {}
    for name, series in specs:
        if name not in have:
            rule = AnomalyRule(name, series, kind="threshold",
                               op=">=", threshold=0.0, for_samples=1,
                               cooldown_s=5.0, exclude_labels=())
            rule.external = True
            history.add_rule(rule)
        out[name] = next(r for r in history.rules if r.name == name)
    return out


def _fire_rule(history, rule, value, labels, now, reason):
    """Manually fire one detector-owned rule (the servescope idiom):
    sync its breach state, bump the anomaly counters, note the flight
    ring, trigger the cooldown-limited incident artifact."""
    rule.last_value = value
    rule.streak = max(rule.streak, 1)
    if rule.breach_since is None:
        rule.breach_since = now
    rule.breach_value = value
    rule.breach_labels = tuple(labels)
    if rule.last_fired is not None \
            and now - rule.last_fired < rule.cooldown_s:
        return None
    rule.last_fired = now
    rule.fired_total += 1
    firing = {"rule": rule.name, "series": rule.series,
              "kind": rule.kind, "value": round(float(value), 6),
              "labels": [list(kv) for kv in (labels or ())],
              "breach_since": rule.breach_since, "mono": now,
              "reason": reason}
    history.anomalies_total += 1
    try:
        if history.registry.enabled:
            history.registry.incr(
                "veles_anomaly_fired_total",
                labels={"rule": rule.name},
                help="anomaly-rule firings (observe/history.py)")
    except Exception:
        pass
    try:
        from veles_tpu_torch.observe.flight import get_flight_recorder
        get_flight_recorder().note(
            "anomaly", rule=rule.name, series=rule.series,
            value=firing["value"], breach_since=rule.breach_since)
    except Exception:
        pass
    return history.incidents.trigger(history, rule, firing, now=now)


def _clear_rules(history):
    """Drop the deploy rules' breach state (terminal rollout states):
    a finished rollout must not keep polluting LATER incidents'
    leading-indicator ordering."""
    if history is None:
        return
    for rule in history.rules:
        if rule.name.startswith("deploy_"):
            rule.streak = 0
            rule.breach_since = None
            rule.breach_value = None
            rule.breach_labels = None


def note_swap_failure(reason, version=None, now=None):
    """Book a refused hot-swap (``GenerateAPI._apply_swap``'s failure
    path) into the observability plane: the ``deploy_swap_probe``
    rule fires and the incident artifact names the swap probe as the
    leading indicator. Never raises — a broken autopsy must not mask
    the (already handled) swap failure."""
    history = _history()
    if history is None:
        return None
    if now is None:
        now = time.monotonic()
    try:
        labels = (("version", str(version or "swap")),)
        history.record_control(SWAP_SERIES, 1.0, labels=labels,
                               now=now)
        rules = ensure_deploy_rules(history)
        path = _fire_rule(history, rules["deploy_swap_probe"], 1.0,
                          labels, now, reason)
        # one-shot event, not an ongoing breach: clear so the next
        # incident's leading indicator is not anchored here forever
        _clear_rules(history)
        return path
    except Exception:
        import logging
        logging.getLogger("serve.Rollout").exception(
            "swap-failure bookkeeping failed (swallowed)")
        return None


class BlueGreenRollout(Logger):
    """One rollout's controller. Owned by the GenerateAPI driver
    thread (``tick`` and every state transition run on it — no lock);
    the request-feed methods (:meth:`note_ttft`,
    :meth:`note_resolved`) only append to bounded deques, safe from
    the driver or a handler's backstop under the GIL.

    States: ``shifting`` -> ``promote_ready`` -> ``promoted`` on the
    happy path; ``rolling_back`` -> ``rolled_back`` when the
    predicate (or an engine failure / breaker trip) ends it.
    """

    def __init__(self, version, config=None, clock=time.monotonic):
        super().__init__(logger_name="serve.Rollout")
        self.version = str(version)
        self.config = config if config is not None else RolloutConfig()
        self._clock = clock
        self.state = "shifting"
        self.reason = None
        #: index into config.steps — the CURRENT fraction rung
        self.step_index = 0
        self.started_at = None
        self._last_shift = None
        self._last_tick = None
        self._last_suppress = None
        self._breaches = 0
        self.suppressed_total = 0
        #: per-role request feeds: (mono, value) / (mono, ok)
        self._ttft = {"green": collections.deque(maxlen=2048),
                      "blue": collections.deque(maxlen=2048)}
        self._resolved = {"green": collections.deque(maxlen=4096),
                          "blue": collections.deque(maxlen=4096)}

    # -- routing ----------------------------------------------------------
    @property
    def fraction(self):
        """The green traffic fraction in effect."""
        if self.state in ("promote_ready", "promoted"):
            return 1.0
        if self.state in ("rolling_back", "rolled_back"):
            return 0.0
        return self.config.steps[self.step_index]

    def routes_green(self, tenant):
        """Engine choice for one tenant: its FIXED hash point against
        the current fraction. Raising the fraction only ADDS tenants
        to green; a tenant never moves back to blue mid-ladder (and
        blue tenants' streams stay byte-identical to a no-deploy
        run)."""
        point = (zlib.crc32(str(tenant or "").encode("utf-8"))
                 % _HASH_BUCKETS) / float(_HASH_BUCKETS)
        return point < self.fraction

    # -- request feeds (any thread) ---------------------------------------
    def note_ttft(self, role, seconds, now=None):
        feed = self._ttft.get(role)
        if feed is not None:
            feed.append((now if now is not None else self._clock(),
                         float(seconds)))

    def note_resolved(self, role, ok, now=None):
        feed = self._resolved.get(role)
        if feed is not None:
            feed.append((now if now is not None else self._clock(),
                         bool(ok)))

    # -- the predicate (driver thread) ------------------------------------
    def _window_stats(self, role, now):
        """(total, failures, mean_ttft_s|None) over the trailing
        window for one role."""
        horizon = now - self.config.window_s
        total = fails = 0
        for stamp, ok in self._resolved[role]:
            if stamp >= horizon:
                total += 1
                if not ok:
                    fails += 1
        ttfts = [v for t, v in self._ttft[role] if t >= horizon]
        mean = sum(ttfts) / len(ttfts) if ttfts else None
        return total, fails, mean

    def _burn(self, api, role, total, fails):
        """The role's burn rate: the SLO engine's per-version slice
        when one is configured (the REAL objectives), else the raw
        failure share against an implied 99%% availability target.
        None = no traffic."""
        engine = getattr(api, "slo", None)
        if engine is not None:
            try:
                row = engine.version_burn(role)
            except Exception:
                row = None
            if row is not None:
                return float(row["burn_rate"])
        if not total:
            return None
        return (fails / float(total)) / 0.01

    def tick(self, api, now=None):
        """One predicate pass (rate-limited; rides the driver loop
        beside the governor's tick). Reads both slices, records the
        control series, syncs the detector-owned rules, and either
        shifts, holds, suppresses, or rolls back."""
        if self.state not in ("shifting", "promote_ready"):
            return
        if now is None:
            now = self._clock()
        if self._last_tick is not None \
                and now - self._last_tick < self.config.interval_s:
            return
        self._last_tick = now
        if self.started_at is None:
            self.started_at = now
            self._last_shift = now
        cfg = self.config
        g_total, g_fails, g_ttft = self._window_stats("green", now)
        b_total, b_fails, b_ttft = self._window_stats("blue", now)
        g_burn = self._burn(api, "green", g_total, g_fails)
        b_burn = self._burn(api, "blue", b_total, b_fails)
        history = _history()
        if history is not None:
            for role, burn, ttft in (("green", g_burn, g_ttft),
                                     ("blue", b_burn, b_ttft)):
                labels = (("version", role),)
                if burn is not None:
                    history.record_control(BURN_SERIES, burn,
                                           labels=labels, now=now)
                if ttft is not None:
                    history.record_control(TTFT_SERIES, ttft * 1000.0,
                                           labels=labels, now=now)
        if g_total < cfg.min_requests:
            # the zero-traffic guard: an idle green slice yields NO
            # verdict — neither a rollback nor a shift-justifying
            # clean bill; the streak resets so stale breaches from a
            # busier rung cannot roll back an idle one
            self._breaches = 0
            return
        burn_bad = g_burn is not None and g_burn >= cfg.burn_ratio \
            * max(b_burn if b_burn is not None else 0.0,
                  cfg.burn_floor)
        ttft_bad = g_ttft is not None and g_ttft >= cfg.ttft_ratio \
            * max(b_ttft if b_ttft is not None else 0.0,
                  cfg.ttft_floor_s)
        self._sync_rules(history, burn_bad, ttft_bad, g_burn, g_ttft,
                         now)
        if not burn_bad and not ttft_bad:
            self._breaches = 0
            self._maybe_shift(api, now)
            return
        if b_burn is not None and b_burn >= cfg.blue_burn_veto:
            # blue is burning too: the regression is ambient, not the
            # candidate's — suppress (and say so, cooldown-limited)
            self._breaches = 0
            self.suppressed_total += 1
            if self._last_suppress is None \
                    or now - self._last_suppress >= cfg.cooldown_s:
                self._last_suppress = now
                self._note(api, "deploy_rollback_suppressed",
                           reason="blue baseline burning (burn %.3g "
                           ">= veto %.3g) — green's regression is "
                           "ambient" % (b_burn, cfg.blue_burn_veto),
                           green_burn=g_burn, blue_burn=b_burn)
            return
        self._breaches += 1
        if self._breaches >= cfg.breach_for:
            which = "burn" if burn_bad else "ttft"
            detail = ("green burn %.3g vs blue %.3g (ratio %.3g)"
                      % (g_burn or 0.0, b_burn or 0.0, cfg.burn_ratio)
                      if burn_bad else
                      "green ttft %.1fms vs blue %.1fms (ratio %.3g)"
                      % ((g_ttft or 0.0) * 1000.0,
                         (b_ttft or 0.0) * 1000.0, cfg.ttft_ratio))
            self._rollback(api, which, detail, history,
                           g_burn, g_ttft, now)

    def _sync_rules(self, history, burn_bad, ttft_bad, g_burn, g_ttft,
                    now):
        """Mirror the predicate's per-plane verdicts onto the
        detector-owned rules so the incident's leading indicator
        orders burn vs ttft by who breached FIRST."""
        if history is None:
            return
        rules = ensure_deploy_rules(history)
        for name, bad, value in (
                ("deploy_green_burn", burn_bad, g_burn),
                ("deploy_green_ttft", ttft_bad,
                 (g_ttft or 0.0) * 1000.0)):
            rule = rules[name]
            if value is not None:
                rule.last_value = value
            if bad:
                rule.streak += 1
                if rule.breach_since is None:
                    rule.breach_since = now
                rule.breach_value = value
                rule.breach_labels = (("version", "green"),)
            else:
                rule.streak = 0
                rule.breach_since = None
                rule.breach_value = None
                rule.breach_labels = None

    def _maybe_shift(self, api, now):
        """Advance one rung (hysteresis: the dwell must have elapsed
        AND the window produced a clean verdict this tick)."""
        if self.state != "shifting":
            return
        if self._last_shift is not None and now - self._last_shift \
                < max(self.config.hold_s, self.config.cooldown_s):
            return
        self._last_shift = now
        if self.step_index + 1 < len(self.config.steps):
            self.step_index += 1
            self._note(api, "deploy_shift",
                       reason="slice healthy for the dwell",
                       fraction=self.fraction)
        else:
            self.state = "promote_ready"
            self._note(api, "deploy_promote_ready",
                       reason="full traffic healthy for the dwell")

    def _rollback(self, api, which, detail, history, g_burn, g_ttft,
                  now):
        """The auto-rollback: state flips NOW (the router stops
        sending green immediately); the driver finalizes once green
        drains — zero shed. The incident artifact names the leading
        plane."""
        self.state = "rolling_back"
        self.reason = "green %s regression: %s" % (which, detail)
        if history is not None:
            rules = ensure_deploy_rules(history)
            rule = rules["deploy_green_burn" if which == "burn"
                         else "deploy_green_ttft"]
            value = (g_burn if which == "burn"
                     else (g_ttft or 0.0) * 1000.0)
            _fire_rule(history, rule, value or 0.0,
                       (("version", "green"),), now, self.reason)
        self._note(api, "deploy_rollback", reason=self.reason,
                   green_burn=g_burn,
                   green_ttft_ms=(g_ttft or 0.0) * 1000.0)
        self.warning("rolling back %s: %s", self.version, self.reason)

    # -- lifecycle (driver thread) ----------------------------------------
    def start(self, api):
        self.started_at = self._clock()
        self._last_shift = self.started_at
        self._note(api, "deploy_start", reason="green probe passed",
                   fraction=self.fraction)

    def abort(self, reason, api=None):
        """Hard stop (engine failure / breaker trip): green's
        in-flight work was shed by the caller; the state machine
        lands terminal with the reason."""
        self.state = "rolled_back"
        self.reason = str(reason)
        _clear_rules(_history())
        if api is not None:
            self._note(api, "deploy_abort", reason=self.reason)

    def finish_rollback(self, api):
        self.state = "rolled_back"
        _clear_rules(_history())
        self._note(api, "deploy_rolled_back",
                   reason=self.reason or "")

    def finish_promote(self, api):
        self.state = "promoted"
        _clear_rules(_history())
        self._note(api, "deploy_promoted",
                   reason="green is the primary now")

    # -- bookkeeping -------------------------------------------------------
    def _note(self, api, action, reason="", **attrs):
        """Every shift/suppression/rollback/promote is a
        ledger-visible governor actuation; without a governor the
        flight ring still gets the entry under the same kind."""
        attrs.setdefault("version", self.version)
        attrs.setdefault("state", self.state)
        governor = getattr(api, "governor", None)
        if governor is not None:
            try:
                governor.note_deploy(action, api, reason=reason,
                                     **attrs)
                return
            except Exception:
                self.exception("governor deploy note failed (kept)")
        try:
            from veles_tpu_torch.observe.flight import get_flight_recorder
            get_flight_recorder().note("governor", action=action,
                                       reason=reason, **attrs)
        except Exception:
            pass
        self.info("rollout %s (%s)%s", action, self.version,
                  (": " + reason) if reason else "")

    def snapshot(self):
        """The /healthz + debug view."""
        return {"version": self.version, "state": self.state,
                "fraction": self.fraction,
                "step_index": self.step_index,
                "breaches": self._breaches,
                "suppressed_total": self.suppressed_total,
                "reason": self.reason}
