"""Closed-loop serving governor: SLO-driven graceful degradation.

The port of ``veles_tpu/observe/governor.py``: the control loop over
the serving hooks' sensors (the SLO burn, the pool's pages and release
rate, the rebuild-storm count, device memory), acting through four
actuators. It rides the ``GenerateAPI`` driver thread: one rate-limited
:meth:`ServingGovernor.tick` per drive pass, no thread of its own.

- **tier demotion/promotion** (actuator *a*): when the SLO engine's
  worst short-window burn rate crosses ``demote_burn``, new admissions
  demote one rung down the ladder (``bf16 -> int8 -> int8-kv``); when it
  falls back under ``recover_burn`` the tier promotes one rung. The band
  between the two thresholds and the ``cooldown_s`` dwell are the
  hysteresis: at most ONE transition per cooldown window. The swap is
  graceful: the driver stops admitting, drains the requests in flight at
  their admitted tier, then builds the decoder at the new tier behind a
  probe decode; nobody is shed.
- **admission resize and Retry-After pricing** (actuator *b*): the
  admission limit shrinks ``admit_factor`` per rung while demoted
  (floor ``min_admit``) and halves under page-pool pressure
  (``pool_high``); every 429/503 ``Retry-After`` is priced from the
  pool's page-release rate, clamped to [1, 60] s like the pool gate.
- **prewarm** (actuator *c*): prompt buckets trending hot
  (``prewarm_hot`` admitted requests within a window whose counts halve
  once per cooldown) get their admission programs readied ahead of need
  from the decoder's AOT bundle (``aot/loader.AotPrograms.
  prewarm_bucket``: the rows' kernel libraries loaded on a background
  thread). A decoder without a bundle (``aot`` None) keeps the trend and
  :meth:`ServingGovernor._maybe_prewarm` returns at once: the governor
  never triggers an ``nvcc`` build.
- **proactive breaker guard** (actuator *d*): a fresh rebuild storm
  (``CompileTracker.storm_total``), device memory above
  ``guard_memory_frac`` or a pool headroom forecast under
  ``headroom_guard_s`` trips the breaker now, shedding retryably and
  rebuilding behind the probe.

Every actuation is ledger-visible: demoted requests' ledger rows carry a
``demoted`` stage naming their tier (and ``quant`` naming what served
them), transitions go to the flight ring (kind ``governor``, replayed by
``python -m veles_tpu_torch observe slo BLACKBOX.json``), and
:func:`publish_governor` exports the ``veles_governor_*`` families on
every ``/metrics`` mount.

Configuration: ``root.common.serve.governor`` (a config subtree or a
``key=value,...`` string, the ``--serve-governor`` flag). Unset means no
governor: the serving hot path pays one attribute check.
"""

import collections
import threading
import time

from veles_tpu_torch.core.logger import Logger

#: the degradation ladder, full fidelity first: each demotion moves one
#: rung right, each promotion one rung left
TIER_RANK = {"bf16": 0, "int8": 1, "int8-kv": 2}

#: Retry-After clamp, matching the pool gate (kv_pool.retry_after)
RETRY_AFTER_MIN = 1.0
RETRY_AFTER_MAX = 60.0

#: bounded actuation history kept for /healthz + black-box replay
TRANSITION_CAP = 64


def _parse_bool(value, key, flag):
    if isinstance(value, bool):
        return value
    text = str(value).strip().lower()
    if text in ("1", "true", "yes", "on"):
        return True
    if text in ("0", "false", "no", "off"):
        return False
    raise ValueError("%s: %s needs a boolean, got %r" % (flag, key, value))


class GovernorConfig:
    """Validated governor knobs (see module docstring). Errors name
    ``flag`` so a CLI misconfiguration reads as the flag's fault."""

    #: keys accepted by the ``key=value,...`` spelling
    KEYS = ("demote_burn", "recover_burn", "cooldown_s", "interval_s",
            "ladder", "min_admit", "admit_factor", "pool_high",
            "prewarm", "prewarm_hot", "breaker_guard",
            "guard_memory_frac", "headroom_guard_s", "deploy_aware",
            "enabled")

    def __init__(self, demote_burn=2.0, recover_burn=1.0,
                 cooldown_s=10.0, interval_s=0.25, ladder=("int8",),
                 min_admit=2, admit_factor=0.5, pool_high=0.85,
                 prewarm=True, prewarm_hot=3, breaker_guard=True,
                 guard_memory_frac=0.97, headroom_guard_s=0.0,
                 deploy_aware=True,
                 flag="root.common.serve.governor"):
        self.demote_burn = float(demote_burn)
        self.recover_burn = float(recover_burn)
        if not 0 < self.recover_burn <= self.demote_burn:
            raise ValueError(
                "%s: need 0 < recover_burn <= demote_burn (the "
                "hysteresis band), got recover_burn=%r demote_burn=%r"
                % (flag, recover_burn, demote_burn))
        self.cooldown_s = float(cooldown_s)
        if self.cooldown_s <= 0:
            raise ValueError("%s: cooldown_s must be > 0, got %r"
                             % (flag, cooldown_s))
        self.interval_s = float(interval_s)
        if self.interval_s <= 0:
            raise ValueError("%s: interval_s must be > 0, got %r"
                             % (flag, interval_s))
        if isinstance(ladder, str):
            ladder = tuple(t for t in ladder.split("+") if t)
        self.ladder = tuple(ladder)
        for tier in self.ladder:
            if tier not in TIER_RANK or tier == "bf16":
                raise ValueError(
                    "%s: ladder tier %r is not a degraded tier "
                    "(supported: int8, int8-kv)" % (flag, tier))
        if list(self.ladder) != sorted(self.ladder,
                                       key=TIER_RANK.__getitem__):
            raise ValueError(
                "%s: ladder %r must be ordered toward deeper "
                "degradation (int8 before int8-kv)"
                % (flag, "+".join(self.ladder)))
        self.min_admit = int(min_admit)
        if self.min_admit < 1:
            raise ValueError("%s: min_admit must be >= 1, got %r"
                             % (flag, min_admit))
        self.admit_factor = float(admit_factor)
        if not 0 < self.admit_factor < 1:
            raise ValueError("%s: admit_factor must be in (0, 1), "
                             "got %r" % (flag, admit_factor))
        self.pool_high = float(pool_high)
        if not 0 < self.pool_high <= 1:
            raise ValueError("%s: pool_high must be in (0, 1], got %r"
                             % (flag, pool_high))
        self.prewarm = _parse_bool(prewarm, "prewarm", flag)
        self.prewarm_hot = int(prewarm_hot)
        if self.prewarm_hot < 1:
            raise ValueError("%s: prewarm_hot must be >= 1, got %r"
                             % (flag, prewarm_hot))
        self.breaker_guard = _parse_bool(breaker_guard, "breaker_guard",
                                         flag)
        self.guard_memory_frac = float(guard_memory_frac)
        if not 0 < self.guard_memory_frac <= 1:
            raise ValueError("%s: guard_memory_frac must be in (0, 1], "
                             "got %r" % (flag, guard_memory_frac))
        #: trip the breaker when memscope forecasts the KV pool
        #: exhausting within this many seconds at the current net
        #: admission rate (observe/memscope.py headroom forecast);
        #: 0 disables the guard — the forecast only warns on surfaces
        self.headroom_guard_s = float(headroom_guard_s)
        if self.headroom_guard_s < 0:
            raise ValueError("%s: headroom_guard_s must be >= 0, "
                             "got %r" % (flag, headroom_guard_s))
        #: suppress tier demotions whose burn is attributable to a
        #: ramping green slice rather than ambient load
        #: (``rollout.py``): the rollout predicate owns the
        #: bad-deploy response (rollback), and demoting the WHOLE
        #: surface for one slice's regression would punish blue
        #: traffic that is serving fine
        self.deploy_aware = _parse_bool(deploy_aware, "deploy_aware",
                                        flag)


def parse_governor_spec(spec, flag="root.common.serve.governor"):
    """Parse the governor config: a dict (config subtree), a
    ``key=value[,key=value...]`` string (the ``--serve-governor`` CLI
    flag; the ladder spells rungs ``ladder=int8+int8-kv``), or
    None/"" (no governor). Returns a :class:`GovernorConfig` or None;
    unknown keys and invalid values raise naming ``flag``."""
    if spec is None:
        return None
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
                raise ValueError("%s: %r is not key=value" % (flag, part))
            parsed[key.strip()] = value.strip()
        spec = parsed
    if not isinstance(spec, dict):
        raise ValueError("%s must be a dict or 'key=value,...' string, "
                         "got %r" % (flag, type(spec).__name__))
    if not spec:
        return None
    spec = dict(spec)
    for key in spec:
        if key not in GovernorConfig.KEYS:
            raise ValueError(
                "%s: unknown key %r (supported: %s)"
                % (flag, key, ", ".join(GovernorConfig.KEYS)))
    if not _parse_bool(spec.pop("enabled", True), "enabled", flag):
        return None
    numeric = ("demote_burn", "recover_burn", "cooldown_s",
               "interval_s", "admit_factor", "pool_high",
               "guard_memory_frac", "headroom_guard_s")
    for key in numeric:
        if key in spec:
            try:
                spec[key] = float(spec[key])
            except (TypeError, ValueError):
                raise ValueError("%s: %s needs a number, got %r"
                                 % (flag, key, spec[key]))
    for key in ("min_admit", "prewarm_hot"):
        if key in spec:
            try:
                spec[key] = int(spec[key])
            except (TypeError, ValueError):
                raise ValueError("%s: %s needs an integer, got %r"
                                 % (flag, key, spec[key]))
    return GovernorConfig(flag=flag, **spec)


class ServingGovernor(Logger):
    """The closed control loop (see module docstring). Owned by ONE
    driver thread: every mutator below runs on it, so the state machine
    needs no lock; the read-side surfaces (``snapshot``,
    ``retry_after_s``, :func:`publish_governor`) only read
    GIL-atomic scalars/copies. ``clock`` is injectable for the
    deterministic hysteresis tests."""

    def __init__(self, config, clock=time.monotonic):
        super().__init__(logger_name="serve.Governor")
        if isinstance(config, (dict, str)):
            config = parse_governor_spec(config)
            if config is None:
                raise ValueError(
                    "ServingGovernor: the spec parsed to a DISABLED "
                    "governor (empty or enabled=0) — construct only "
                    "from an enabling config, or use from_config() "
                    "which returns None instead")
        self.config = config
        self._clock = clock
        #: metric flight recorder (observe/history.py): when attached,
        #: every burn/pressure reading the loop acts on is recorded as
        #: a ``veles_ctrl_*`` history series — the incident autopsy
        #: replays exactly what the governor saw (no second
        #: bookkeeping path)
        self.history = None
        #: 0 = full fidelity; k = self._ladder[k - 1] is serving
        self.level = 0
        self.base_tier = "bf16"
        self._ladder = tuple(config.ladder)
        self.counters = {"ticks": 0, "demotions": 0, "promotions": 0,
                         "guard_trips": 0, "prewarms": 0,
                         "admit_resizes": 0,
                         "demotes_suppressed_deploy": 0}
        #: bounded actuation history: {action, tier, burn, reason, t,
        #: mono} — the /healthz + black-box replay payload
        self.transitions = collections.deque(maxlen=TRANSITION_CAP)
        self._last_tick = None
        self._now = None
        self._last_transition = None
        self._last_guard = None
        self._storm_baseline = None
        #: the effective admission bound last computed (None before the
        #: first tick / while no bound is configured)
        self.effective_limit = None
        #: None = no override; an int shrinks GenerateAPI's max_queue
        self.admit_limit = None
        self.last_burn = None
        #: the current honest Retry-After price (seconds, clamped)
        self.retry_price = RETRY_AFTER_MIN
        self._bucket_lock = threading.Lock()
        self._bucket_counts = {}
        self._bucket_decay_at = None
        self._prewarmed = set()
        self._prewarm_threads = []

    # -- wiring ------------------------------------------------------------
    def attach_history(self, history):
        """Wire the metric flight recorder: burn/pressure sensing runs
        through it (``MetricHistory.control_burn``/``record_control``)
        so the control plane and the incident autopsy read ONE trend
        store. None detaches (the summary() fallback)."""
        self.history = history
        return history

    def set_base_tier(self, base):
        """Pin the configured (full-fidelity) tier; ladder rungs at or
        above it are unreachable and drop out."""
        base = base or "bf16"
        self.base_tier = base
        self._ladder = tuple(t for t in self.config.ladder
                             if TIER_RANK[t] > TIER_RANK.get(base, 0))

    @property
    def demoted(self):
        return self.level > 0

    def tier_name(self):
        """The tier the governor currently WANTS admissions served at
        (the decoder reconciles toward it at the next graceful swap)."""
        if self.level == 0:
            return self.base_tier
        return self._ladder[self.level - 1]

    def observe_bucket(self, bucket):
        """Handler-thread feed: one ADMITTED request staged for
        ``bucket`` (the prewarm trend sensor). One small lock, never
        on the driver's token path. Counts decay exponentially once
        per cooldown window (:meth:`_decay_buckets`), so "trending
        hot" means recent admissions, not a lifetime total."""
        with self._bucket_lock:
            self._bucket_counts[bucket] = \
                self._bucket_counts.get(bucket, 0) + 1

    def _decay_buckets(self, now):
        """Halve the bucket counts once per cooldown window — the
        cheap exponential window behind the trend semantics."""
        if self._bucket_decay_at is None:
            self._bucket_decay_at = now
            return
        if now - self._bucket_decay_at < self.config.cooldown_s:
            return
        self._bucket_decay_at = now
        with self._bucket_lock:
            self._bucket_counts = {
                bucket: count // 2
                for bucket, count in self._bucket_counts.items()
                if count // 2 > 0}

    # -- the control loop (driver thread) ----------------------------------
    def tick(self, api, now=None):
        """One governor pass, rate-limited to ``interval_s``; called by
        the GenerateAPI driver once per drive pass. Returns True when a
        pass actually ran."""
        if now is None:
            now = self._clock()
        if self._last_tick is not None \
                and now - self._last_tick < self.config.interval_s:
            return False
        self._last_tick = now
        self.counters["ticks"] += 1
        burn = None
        if api.slo is not None:
            # an EMPTY window is no signal, not a healthy one: burn
            # stays None and the tier HOLDS. Decisions come from
            # device-truth numbers only — promoting on silence during
            # a resolution gap (e.g. while a swap drains) would flap
            # the ladder against a fault that never cleared.
            if self.history is not None:
                # the history-backed path: the reading is RECORDED as
                # the veles_ctrl_burn_rate series in the same motion —
                # demote decisions and incident autopsies share one
                # trend store by construction
                burn = self.history.control_burn(api.slo)
            else:
                summary = api.slo.summary()
                burn = summary["burn_rate"] if summary else None
        self.last_burn = burn
        #: the tick's decision instant — _note stamps transitions with
        #: it so the hysteresis window math holds under injected clocks
        self._now = now
        pool = api.decoder.pool
        pool_snap = pool.snapshot() if pool is not None else None
        if pool is not None:
            # feed the headroom forecast where the pool is already
            # being read — one GIL-atomic ring append per tick
            from veles_tpu_torch.observe.memscope import get_memscope
            get_memscope().note_pool(pool)
        if self.history is not None:
            if pool_snap is not None:
                # the pressure reading _resize_admission acts on,
                # recorded under the same ctrl namespace as the burn
                self.history.record_control(
                    "veles_ctrl_pool_pressure",
                    max(pool_snap["pages_used"],
                        pool_snap["reserved_pages"])
                    / max(1, pool_snap["pages_total"]))
            # FALLBACK sampling only: while the process sampler
            # thread is alive (every served /metrics mount starts
            # one), the driver never samples. Without a sampler
            # (library embedders), the rate-limited tick keeps the
            # trends alive DATA-ONLY — rule evaluation, and with it
            # any incident-artifact disk write, never runs on the
            # decode driver thread.
            from veles_tpu_torch.observe.history import history_sampler_alive
            if not history_sampler_alive():
                self.history.maybe_sample(check_rules=False)
        # transition FIRST so the resize/reprice below act on the new
        # rung in the same pass, not one interval late
        self._maybe_transition(api, burn, now)
        self._reconcile_tier(api)
        self._reprice(pool, pool_snap)
        self._resize_admission(api, pool_snap)
        if self.config.breaker_guard:
            self._guard_breaker(api, now)
        if self.config.prewarm:
            self._maybe_prewarm(api)
            self._decay_buckets(now)
        return True

    def note_deploy(self, action, api, reason="", **attrs):
        """Book a deploy-plane actuation (veles_tpu/rollout.py:
        traffic shifts, rollbacks, suppressions, promotes) through
        the SAME ledger as tier transitions — every rollout decision
        is a governor actuation, visible in /debug/governor and the
        flight ring beside the demotes it may have raced."""
        self.counters[action] = self.counters.get(action, 0) + 1
        self._note(action, api, reason=reason, **attrs)

    def _note(self, action, api, burn=None, reason="", **attrs):
        """Book one ledger-visible actuation: transition history,
        counters already bumped by the caller, flight-recorder ring."""
        from veles_tpu_torch.observe.flight import get_flight_recorder

        entry = {"action": action, "tier": self.tier_name(),
                 "level": self.level, "burn": burn, "reason": reason,
                 "t": time.time(),
                 "mono": self._now if self._now is not None
                 else self._clock()}
        entry.update(attrs)
        self.transitions.append(entry)
        get_flight_recorder().note("governor", **{
            k: v for k, v in entry.items() if k not in ("t", "mono")})
        self.info("governor %s -> tier %s (burn=%s%s)", action,
                  entry["tier"], burn,
                  (": " + reason) if reason else "")

    def _maybe_transition(self, api, burn, now):
        """The hysteresis band: demote at >= demote_burn, promote at
        <= recover_burn, hold in between — and never more than one
        transition per cooldown window."""
        if burn is None or not self._ladder:
            return
        if self._last_transition is not None \
                and now - self._last_transition < self.config.cooldown_s:
            return
        if burn >= self.config.demote_burn \
                and self.level < len(self._ladder):
            attributable = self._deploy_attributable(api, now)
            if attributable:
                # the burn is the ramping green slice's, not ambient
                # load: the rollout predicate owns the response
                # (rollback), so demoting the WHOLE surface would
                # punish healthy blue traffic. Ledger-visible and
                # cooldown-limited like a real transition.
                self.counters["demotes_suppressed_deploy"] += 1
                self._last_transition = now
                self._note("demote_suppressed_deploy", api, burn=burn,
                           reason=attributable)
                return
            self.level += 1
            self.counters["demotions"] += 1
            self._last_transition = now
            self._note("demote", api, burn=burn,
                       reason="burn %.3g >= %.3g"
                       % (burn, self.config.demote_burn))
        elif burn <= self.config.recover_burn and self.level > 0:
            self.level -= 1
            self.counters["promotions"] += 1
            self._last_transition = now
            self._note("promote", api, burn=burn,
                       reason="burn %.3g <= %.3g"
                       % (burn, self.config.recover_burn))

    def _deploy_attributable(self, api, now):
        """The rollout-interplay predicate (``rollout.py``):
        a truthy reason string when the surface-wide burn is
        attributable to a RAMPING green slice — a rollout is shifting,
        the green slice's burn is past the demote bar, and the blue
        (primary) slice's burn sits inside the recover band. Ambient
        load burns BOTH slices, so a healthy blue acquits it; a green
        regression is the rollout predicate's to roll back, not this
        loop's to demote. False otherwise (including with
        ``deploy_aware`` off, no live rollout, or no SLO engine — no
        slices, no attribution)."""
        if not self.config.deploy_aware:
            return False
        rollout = getattr(api, "_rollout", None)
        if rollout is None \
                or getattr(rollout, "state", None) != "shifting":
            return False
        engine = getattr(api, "slo", None)
        if engine is None:
            return False
        try:
            green = engine.version_burn("green", now=now)
            blue = engine.version_burn("blue", now=now)
        except Exception:
            return False
        if green is None:
            return False
        green_burn = float(green["burn_rate"])
        blue_burn = float(blue["burn_rate"]) if blue is not None \
            else 0.0
        if green_burn >= self.config.demote_burn \
                and blue_burn <= self.config.recover_burn:
            return ("green slice burn %.3g >= %.3g while blue holds "
                    "%.3g <= %.3g — deploy-attributable, rollout owns "
                    "the response"
                    % (green_burn, self.config.demote_burn, blue_burn,
                       self.config.recover_burn))
        return False

    def _reconcile_tier(self, api):
        """Ask the driver for a graceful swap whenever the decoder's
        live tier differs from the governed one (also re-asserts the
        tier after a breaker rebuild or a failed swap's backoff)."""
        desired = self.tier_name()
        current = api.decoder.quantize or "bf16"
        if desired != current:
            api.request_tier(desired)

    def _resize_admission(self, api, pool_snap):
        """Actuator (b), the limit half: shrink the effective admission
        bound while demoted (admit_factor per rung, floored at
        min_admit) and halve it again under page-pool pressure. A
        disabled bound (max_queue <= 0) stays disabled — load shedding
        off is the operator's explicit call."""
        base = api.max_queue
        if base is None or base <= 0:
            self.admit_limit = None
            self.effective_limit = None
            return
        limit = base
        if self.level > 0:
            limit = max(self.config.min_admit,
                        int(round(base
                                  * self.config.admit_factor
                                  ** self.level)))
        if pool_snap is not None:
            pressure = max(pool_snap["pages_used"],
                           pool_snap["reserved_pages"]) / max(
                               1, pool_snap["pages_total"])
            if pressure >= self.config.pool_high:
                limit = max(self.config.min_admit, limit // 2)
        # before the first tick the effective limit IS the configured
        # base — so an initial shrink books its actuation too (the
        # every-actuation-ledger-visible contract)
        previous = self.effective_limit \
            if self.effective_limit is not None else base
        self.effective_limit = limit
        self.admit_limit = None if limit == base else limit
        if limit != previous:
            self.counters["admit_resizes"] += 1
            self._note("admit_resize", api, burn=self.last_burn,
                       reason="limit %d -> %d" % (previous, limit),
                       limit=limit)

    def _reprice(self, pool, pool_snap):
        """Actuator (b), the price half: Retry-After from the pool's
        observed page-release rate — priced as the time for the
        release rate to clear the pressure OVERHANG above the
        ``pool_high`` gate (one page when the pool is healthy) — else
        a cooldown-scaled hint while demoted; clamped [1, 60] like the
        pool gate."""
        if pool is not None:
            need = 1
            if pool_snap is not None:
                pressure_pages = max(pool_snap["pages_used"],
                                     pool_snap["reserved_pages"])
                need = max(1, pressure_pages
                           - int(self.config.pool_high
                                 * pool_snap["pages_total"]))
            price = pool.retry_after(need)
        elif self.level > 0:
            price = min(RETRY_AFTER_MAX,
                        max(RETRY_AFTER_MIN, self.config.cooldown_s / 2))
        else:
            price = RETRY_AFTER_MIN
        self.retry_price = float(
            min(RETRY_AFTER_MAX, max(RETRY_AFTER_MIN, price)))

    def retry_after_s(self, need=1):
        """The priced Retry-After (seconds, clamped [1, 60]) — what
        ``ServingHealth.retry_after_s`` and every 429/503 header
        consult instead of the historical hardcoded ``"1"``."""
        return self.retry_price

    def _guard_breaker(self, api, now):
        """Actuator (d): trip-and-rebuild proactively when device truth
        predicts a stall — a fresh recompilation storm, or device
        memory above guard_memory_frac."""
        if self._last_guard is not None \
                and now - self._last_guard < self.config.cooldown_s:
            return
        reason = None
        from veles_tpu_torch.observe.xla_stats import get_compile_tracker
        tracker = get_compile_tracker()
        if tracker.enabled:
            storms = tracker.storm_total()
            if self._storm_baseline is None:
                self._storm_baseline = storms
            elif storms > self._storm_baseline:
                reason = ("recompile storm (%d total, was %d)"
                          % (storms, self._storm_baseline))
                self._storm_baseline = storms
        if reason is None:
            frac = self._device_memory_frac()
            if frac is not None and frac >= self.config.guard_memory_frac:
                reason = "device memory %.1f%% of limit" % (frac * 100)
        if reason is None and self.config.headroom_guard_s > 0:
            from veles_tpu_torch.observe.memscope import get_memscope
            headroom = get_memscope().headroom_forecast_s()
            if headroom is not None \
                    and headroom <= self.config.headroom_guard_s:
                reason = ("pool exhausts in ~%.0fs at current admission"
                          % headroom)
        if reason is None:
            return
        self._last_guard = now
        self.counters["guard_trips"] += 1
        self._note("guard_trip", api, burn=self.last_burn,
                   reason=reason)
        api.request_trip("governor breaker guard: " + reason)

    @staticmethod
    def _device_memory_frac():
        """Worst ``bytes_in_use / bytes_limit`` over the CUDA devices
        from the shared sampler (``xla_stats._sample_device_memory``:
        the caching allocator's bytes against the card's total), falling
        back to memscope's reconciled total over its byte budget, so the
        guard also applies where no allocator reports (the CPU). None
        only when no limit exists anywhere."""
        try:
            from veles_tpu_torch.observe.xla_stats import _sample_device_memory
            worst = None
            for stats in _sample_device_memory().values():
                limit = stats.get("bytes_limit")
                used = stats.get("bytes_in_use")
                if not limit or used is None:
                    continue
                frac = used / limit
                if worst is None or frac > worst:
                    worst = frac
            if worst is not None:
                return worst
            from veles_tpu_torch.observe.memscope import get_memscope
            return get_memscope().device_fraction()
        except Exception:
            return None

    def _maybe_prewarm(self, api):
        """Actuator (c): ready the admission programs of buckets trending
        hot on a background thread, from the decoder's AOT bundle; a
        decoder without one (``aot`` None) returns at once, as the JAX
        package does."""
        programs = api.decoder.aot
        if programs is None:
            return
        with self._bucket_lock:
            hot = [bucket for bucket, count in self._bucket_counts.items()
                   if count >= self.config.prewarm_hot
                   and bucket not in self._prewarmed]
        for bucket in hot:
            self._prewarmed.add(bucket)
            self.counters["prewarms"] += 1
            self._note("prewarm", api, burn=self.last_burn,
                       reason="bucket %d trending hot" % bucket,
                       bucket=bucket)
            # non-daemon, as in the JAX package: one bounded build
            # batch, joined by drain_prewarm
            thread = threading.Thread(
                target=self._prewarm_bucket, args=(programs, bucket),
                name="governor-prewarm-%d" % bucket)
            thread.start()
            self._prewarm_threads.append(thread)
        if hot:
            self._prewarm_threads = [t for t in self._prewarm_threads
                                     if t.is_alive()]

    def _prewarm_bucket(self, programs, bucket):
        try:
            programs.prewarm_bucket(bucket)
        except Exception:
            self.exception("prewarm of bucket %d failed", bucket)

    def drain_prewarm(self, timeout=5.0):
        """Join outstanding prewarm builds (server stop)."""
        deadline = time.monotonic() + timeout
        for thread in self._prewarm_threads:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
        self._prewarm_threads = [t for t in self._prewarm_threads
                                 if t.is_alive()]

    # -- views -------------------------------------------------------------
    def snapshot(self):
        """The /healthz + dashboard cell: tier, band state, actuation
        counters and the transition tail."""
        return {"tier": self.tier_name(),
                "base_tier": self.base_tier,
                "level": self.level,
                "demoted": self.demoted,
                "burn": self.last_burn,
                "admit_limit": self.admit_limit,
                "retry_after_s": round(self.retry_price, 3),
                "counters": dict(self.counters),
                "transitions": list(self.transitions)[-8:]}

    @classmethod
    def from_config(cls, **kwargs):
        """Build from ``root.common.serve.governor``; None when unset
        (no governor — the hot path keeps its static-flag shape). Raw
        attribute read, not ``get()`` — get() collapses Config subtrees
        to the default (the serve-mesh doctrine)."""
        from veles_tpu_torch.core.config import root

        try:
            spec = object.__getattribute__(root.common.serve, "governor")
        except AttributeError:
            return None
        config = parse_governor_spec(spec)
        if config is None:
            return None
        return cls(config, **kwargs)


def publish_governor(registry, governor):
    """Scrape-time bridge: the ``veles_governor_*`` families — tier
    level (0 = full fidelity), the demoted flag, the effective
    admission limit, the current Retry-After price, the last observed
    burn rate, and one actuation counter per action."""
    registry.set("veles_governor_tier_level", governor.level,
                 help="degradation-ladder rung in effect "
                      "(0 = full fidelity)")
    registry.set("veles_governor_demoted",
                 1 if governor.demoted else 0,
                 help="1 while admissions are governed below the "
                      "configured tier")
    if governor.effective_limit is not None:
        registry.set("veles_governor_admit_limit",
                     governor.effective_limit,
                     help="effective admission bound after governor "
                          "resizing")
    registry.set("veles_governor_retry_after",
                 round(governor.retry_price, 3),
                 help="current priced Retry-After in seconds (from "
                      "the pool page-release rate, clamped [1, 60])")
    if governor.last_burn is not None:
        registry.set("veles_governor_burn_rate",
                     governor.last_burn,
                     help="worst short-window SLO burn rate the "
                          "governor last acted on")
    for action in ("demotions", "promotions", "guard_trips",
                   "prewarms", "admit_resizes", "ticks"):
        registry.counter_set(
            "veles_governor_actuations_total",
            governor.counters.get(action, 0),
            labels={"action": action},
            help="governor actuations by kind (ledger-visible: each "
                 "also lands in the flight ring and, for demotions, "
                 "on the request rows)")


def format_governor_transitions(entries):
    """Render governor flight entries (kind ``governor``) as the
    autopsy CLI's actuation-replay lines."""
    lines = []
    for entry in entries:
        parts = ["%-12s" % entry.get("action", "?"),
                 "tier=%s" % entry.get("tier")]
        burn = entry.get("burn")
        if burn is not None:
            parts.append("burn=%.3g" % float(burn))
        reason = entry.get("reason")
        if reason:
            parts.append(str(reason))
        lines.append("  " + "  ".join(parts))
    return "\n".join(lines)
