"""Deterministic chaos harness for the serving path.

The port of ``veles_tpu/serving_chaos.py``: the seeded fault injector
that :class:`~veles_tpu_torch.serving.GenerateAPI`'s driver calls before
every decoder dispatch, the client-fault roll a test harness uses, the
replica fault planner and the recorded-traffic profile.

**Server-side (driver) faults**, through
:meth:`ServingChaosMonkey.before_step`:

- **step failure**: raise :class:`ChaosStepError` from a decoder step,
  standing in for a device or runtime error under the driver; this is
  what trips the circuit breaker. ``step_fail_max`` caps the injected
  failures, so a chaos run settles and every request completes.
- **slow step**: stretch a decode step by ``slow_step_ms``.

**Step-indexed profiles** (no RNG), each driving one sensor past its
threshold for a bounded window, the serving governor's and the rollout's
proving ground:

- **latency ramp**: ``latency_ramp_ms`` over ``latency_ramp_steps``,
  held ``latency_ramp_hold`` more steps or until :meth:`clear_ramp`;
- **pool flood**: ``pool_flood_pages`` reserved from the decoder's KV
  pool at step ``pool_flood_at`` for ``pool_flood_steps`` steps, or until
  :meth:`release_flood`;
- **compile storm**: ``compile_storm_at`` books a ``STORM_THRESHOLD``
  worth of builds named ``chaos.compile_storm`` into the process
  ``CompileTracker``, firing its storm count (the governor's breaker
  guard);
- **waste**: ``waste_cause``, ``waste_tokens``, ``waste_at`` and
  ``waste_steps`` book synthetic tokens of the named cause into the
  process serve scope each step of the window
  (``ServeScope.inject_waste``);
- **green ramp**: ``deploy_green_ramp_ms`` over
  ``deploy_green_ramp_steps``: only the steps of a decoder whose
  ``rollout_role`` is ``"green"`` stall, so the rollout predicate sees
  green's TTFT break from blue's;
- **poisoned swap**: ``deploy_poison_nan``: the first weight swap's first
  floating leaf becomes NaN (:meth:`maybe_poison_swap`);
- **pool leak**: ``leak_retain_pool_at``: a strong reference to the live
  KV pool is kept and the step fails, so the rebuilt pool coexists with
  the old one and memscope's edge diff names ``kv_pool``.

Inject and clear instants land in ``stamps``.

**Client-side faults**, rolled by the harness with
:meth:`roll_client_fault`: ``disconnect``, ``garbage_body`` and
``oversize_body``.

Each family draws from its own stream (driver faults from
``random.Random(seed)``, client faults from
``random.Random("client-<seed>")``), so a (seed, workload) pair replays
the JAX package's fault schedule draw for draw: a probability <= 0 never
advances a stream, and ``before_step`` rolls ``slow_step`` before
``step_fail``.

:class:`ReplicaChaosMonkey` is a pure, tick-indexed planner of replica
faults; a harness applies its actions to the replicas behind the
elastic router (``router.py``), whose serve plane names the victim.
:class:`RecordedTrafficProfile` replays a recorded trace as a traffic
profile (``observe/replay.py``).

Configuration: ``root.common.serve.chaos.*`` (:meth:`from_config`).
"""

import random
import time

import torch

from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.device import tree_leaves_with_path, tree_replace
from veles_tpu_torch.fleet.chaos import ChaosConfigBase, roll
from veles_tpu_torch.fleet.serve_plane import REPLICA_GOODPUT_SERIES

#: chaos config keys that are fault probabilities
PROBABILITY_KEYS = ("step_fail", "slow_step", "disconnect",
                    "garbage_body", "oversize_body")

#: client-side fault kinds, in their fixed roll order
CLIENT_FAULTS = ("disconnect", "garbage_body", "oversize_body")


class ChaosStepError(RuntimeError):
    """The injected decoder-step failure (stands in for a device /
    runtime error under the driver loop)."""


class ServingChaosConfig(ChaosConfigBase):
    """Validated serving-chaos knobs (probabilities in [0, 1])."""

    PROBABILITY_KEYS = PROBABILITY_KEYS

    def __init__(self, seed=1, step_fail=0.0, step_fail_max=None,
                 slow_step=0.0, slow_step_ms=20.0, disconnect=0.0,
                 garbage_body=0.0, oversize_body=0.0,
                 latency_ramp_ms=0.0, latency_ramp_steps=0,
                 latency_ramp_hold=0,
                 pool_flood_pages=0, pool_flood_at=0,
                 pool_flood_steps=0, compile_storm_at=None,
                 waste_cause=None, waste_tokens=0, waste_at=0,
                 waste_steps=0, deploy_green_ramp_ms=0.0,
                 deploy_green_ramp_steps=0, deploy_poison_nan=False,
                 leak_retain_pool_at=None):
        self._set_probabilities(
            step_fail=step_fail, slow_step=slow_step,
            disconnect=disconnect, garbage_body=garbage_body,
            oversize_body=oversize_body)
        if step_fail_max is not None:
            step_fail_max = int(step_fail_max)
            if step_fail_max < 0:
                raise ValueError("step_fail_max must be >= 0")
        self.step_fail_max = step_fail_max
        self.seed = int(seed)
        self.slow_step_ms = float(slow_step_ms)
        # burn-inducing profiles (deterministic, step-indexed)
        self.latency_ramp_ms = float(latency_ramp_ms)
        self.latency_ramp_steps = int(latency_ramp_steps)
        self.latency_ramp_hold = int(latency_ramp_hold)
        if self.latency_ramp_ms < 0 or self.latency_ramp_steps < 0 \
                or self.latency_ramp_hold < 0:
            raise ValueError("latency ramp knobs must be >= 0")
        self.pool_flood_pages = int(pool_flood_pages)
        self.pool_flood_at = int(pool_flood_at)
        self.pool_flood_steps = int(pool_flood_steps)
        if self.pool_flood_pages < 0 or self.pool_flood_at < 0 \
                or self.pool_flood_steps < 0:
            raise ValueError("pool flood knobs must be >= 0")
        if compile_storm_at is not None:
            compile_storm_at = int(compile_storm_at)
            if compile_storm_at < 0:
                raise ValueError("compile_storm_at must be >= 0")
        self.compile_storm_at = compile_storm_at
        if waste_cause is not None:
            from veles_tpu_torch.observe.servescope import WASTE_CAUSES
            if waste_cause not in WASTE_CAUSES:
                raise ValueError(
                    "waste_cause must be one of %s, got %r"
                    % (", ".join(WASTE_CAUSES), waste_cause))
        self.waste_cause = waste_cause
        self.waste_tokens = int(waste_tokens)
        self.waste_at = int(waste_at)
        self.waste_steps = int(waste_steps)
        if self.waste_tokens < 0 or self.waste_at < 0 \
                or self.waste_steps < 0:
            raise ValueError("waste profile knobs must be >= 0")
        # bad-deploy profiles (``rollout.py``): the blue-green
        # rollback predicate's proving ground
        self.deploy_green_ramp_ms = float(deploy_green_ramp_ms)
        self.deploy_green_ramp_steps = int(deploy_green_ramp_steps)
        if self.deploy_green_ramp_ms < 0 \
                or self.deploy_green_ramp_steps < 0:
            raise ValueError("deploy green ramp knobs must be >= 0")
        self.deploy_poison_nan = bool(deploy_poison_nan)
        # leak-injection profile (observe/memscope.py): at the given
        # step, retain a strong reference to the live KV pool and trip
        # the breaker — the rebuilt decoder's pool then COEXISTS with
        # the zombie, and memscope's lifecycle-edge diff must name
        # kv_pool as the grown owner in its incident artifact
        if leak_retain_pool_at is not None:
            leak_retain_pool_at = int(leak_retain_pool_at)
            if leak_retain_pool_at < 0:
                raise ValueError("leak_retain_pool_at must be >= 0")
        self.leak_retain_pool_at = leak_retain_pool_at

    @property
    def any_profile(self):
        """True when a burn-inducing, waste or bad-deploy profile is
        configured."""
        return bool((self.latency_ramp_ms and self.latency_ramp_steps)
                    or self.pool_flood_pages
                    or self.compile_storm_at is not None
                    or (self.waste_cause and self.waste_tokens
                        and self.waste_steps)
                    or (self.deploy_green_ramp_ms
                        and self.deploy_green_ramp_steps)
                    or self.deploy_poison_nan
                    or self.leak_retain_pool_at is not None)

    def expected_leading_series(self):
        """The metric series each configured burn profile is expected
        to breach FIRST (observe/history.py's leading-indicator
        acceptance): ``{profile: series_name}``. A latency ramp shows
        up in the serving latency windows before the burn rate
        crosses its threshold; a pool flood surges the reservation
        gauge; a compile storm books the storm counter. Tests and the
        bench assert the incident artifact's leading indicator against
        exactly this map — the injected fault must name itself."""
        out = {}
        if self.latency_ramp_ms and self.latency_ramp_steps:
            out["latency_ramp"] = "veles_serving_latency_ms"
        if self.pool_flood_pages:
            out["pool_flood"] = "veles_kv_pages_reserved"
        if self.compile_storm_at is not None:
            # the port's name of the JAX package's
            # veles_xla_recompile_storms_total (xla_stats.DIFFERING_FAMILIES)
            out["compile_storm"] = "veles_kernel_rebuild_storms_total"
        if self.waste_cause and self.waste_tokens and self.waste_steps:
            out["waste_profile"] = "veles_serve_waste_share"
        if self.deploy_green_ramp_ms and self.deploy_green_ramp_steps:
            # a latency-regressed candidate breaches the green ttft
            # plane before anything else (veles_tpu/rollout.py)
            from veles_tpu_torch.rollout import TTFT_SERIES
            out["deploy_green_ramp"] = TTFT_SERIES
        if self.deploy_poison_nan:
            from veles_tpu_torch.rollout import SWAP_SERIES
            out["deploy_poison"] = SWAP_SERIES
        if self.leak_retain_pool_at is not None:
            # the retained pool doubles the kv_pool owner's bytes —
            # the per-owner attribution family is where it shows first
            out["pool_leak"] = "veles_hbm_bytes"
        return out

    def expected_leading_cause(self):
        """The waste cause the configured waste profile injects — what
        the serving goodput observatory's incident artifact must name
        as ``dominant_cause`` (tests and the bench assert against
        exactly this), or None without a waste profile."""
        if self.waste_cause and self.waste_tokens and self.waste_steps:
            return self.waste_cause
        return None


class ServingChaosMonkey(Logger):
    """The serving-path fault injector (see module docstring)."""

    def __init__(self, config):
        super().__init__(logger_name="serve.Chaos")
        self.config = config
        # independent streams per fault family: the driver thread and
        # the harness's client thread must not race on one RNG (that
        # would make the schedule depend on OS scheduling)
        self._rng = random.Random(config.seed)
        self._rng_client = random.Random("client-%d" % config.seed)
        self.counters = {"steps_failed": 0, "steps_slowed": 0,
                         "disconnects": 0, "garbage_bodies": 0,
                         "oversize_bodies": 0, "ramp_stalls": 0,
                         "pool_floods": 0, "compile_storms": 0,
                         "waste_injections": 0, "pool_leaks": 0}
        #: driver-step index: the burn profiles are step-indexed, so a
        #: (config, workload) pair replays the same fault schedule
        self._step = 0
        #: green-engine step index (the deploy_green_ramp profile is
        #: indexed on GREEN steps only — the candidate regresses, the
        #: primary must stay untouched for the bit-identity contract)
        self._green_step = 0
        #: the poisoned-swap profile fires exactly once
        self._poison_done = False
        #: harness-forced end of the latency ramp (clear_ramp)
        self._ramp_cleared = False
        #: pages the pool-flood profile currently holds hostage; done
        #: latches after the release so the flood fires exactly once
        self._flood_pages = None
        self._flood_pool = None
        self._flood_done = False
        #: the leak-injection profile's zombie: a strong reference to
        #: the pool of the decoder the injected trip killed — held so
        #: the rebuilt pool coexists with it and memscope's edge diff
        #: has a real retention to name; release_leak() drops it
        self._leaked_pool = None
        #: fault-inject / fault-clear instants (monotonic): the bench's
        #: governor_demote_to_recover_ms measures from these
        self.stamps = {}

    @classmethod
    def from_config(cls):
        """Build from ``root.common.serve.chaos``; returns ``None`` when
        chaos is disabled (no probability set, or ``enabled = False``)."""
        from veles_tpu_torch.core.config import root
        cfg = root.common.serve.chaos
        config = ServingChaosConfig(
            seed=cfg.get("seed", 1),
            step_fail=cfg.get("step_fail", 0.0),
            step_fail_max=cfg.get("step_fail_max", None),
            slow_step=cfg.get("slow_step", 0.0),
            slow_step_ms=cfg.get("slow_step_ms", 20.0),
            disconnect=cfg.get("disconnect", 0.0),
            garbage_body=cfg.get("garbage_body", 0.0),
            oversize_body=cfg.get("oversize_body", 0.0),
            latency_ramp_ms=cfg.get("latency_ramp_ms", 0.0),
            latency_ramp_steps=cfg.get("latency_ramp_steps", 0),
            latency_ramp_hold=cfg.get("latency_ramp_hold", 0),
            pool_flood_pages=cfg.get("pool_flood_pages", 0),
            pool_flood_at=cfg.get("pool_flood_at", 0),
            pool_flood_steps=cfg.get("pool_flood_steps", 0),
            compile_storm_at=cfg.get("compile_storm_at", None),
            waste_cause=cfg.get("waste_cause", None),
            waste_tokens=cfg.get("waste_tokens", 0),
            waste_at=cfg.get("waste_at", 0),
            waste_steps=cfg.get("waste_steps", 0),
            deploy_green_ramp_ms=cfg.get("deploy_green_ramp_ms", 0.0),
            deploy_green_ramp_steps=cfg.get("deploy_green_ramp_steps",
                                            0),
            deploy_poison_nan=cfg.get("deploy_poison_nan", False),
            leak_retain_pool_at=cfg.get("leak_retain_pool_at", None))
        if not cfg.get("enabled",
                       config.any_enabled or config.any_profile):
            return None
        monkey = cls(config)
        monkey.info(
            "serving chaos enabled (seed=%d): %s", config.seed,
            ", ".join("%s=%.3g" % (key, getattr(config, key))
                      for key in PROBABILITY_KEYS
                      if getattr(config, key) > 0.0))
        return monkey

    # -- server-side (driver) faults ------------------------------------------
    def before_step(self, decoder=None):
        """Called by the GenerateAPI driver before each decoder dispatch
        (including rebuild-probe decodes): maybe stretch the step, maybe
        raise the injected device failure. Each stream advances in a
        fixed call order on its own thread -> deterministic fault
        schedule for a deterministic workload. ``decoder`` (the live
        driver passes it; probe decodes don't) is the burn-profile
        seam — the pool-flood profile allocates its hostage pages from
        the decoder's own KV pool."""
        self._run_profiles(decoder)
        if roll(self._rng, self.config.slow_step):
            self.counters["steps_slowed"] += 1
            time.sleep(self.config.slow_step_ms / 1000.0)
        if self.config.step_fail_max is not None \
                and self.counters["steps_failed"] \
                >= self.config.step_fail_max:
            return
        if roll(self._rng, self.config.step_fail):
            self.counters["steps_failed"] += 1
            self.warning("chaos: injecting decoder-step failure (#%d)",
                         self.counters["steps_failed"])
            raise ChaosStepError("chaos: injected decoder-step failure")

    # -- burn-inducing profiles (deterministic, step-indexed) -----------------
    def _run_profiles(self, decoder):
        """Advance the step index and fire whichever burn profiles the
        current step falls inside (see module docstring)."""
        cfg = self.config
        step = self._step
        self._step += 1
        if cfg.deploy_green_ramp_ms and cfg.deploy_green_ramp_steps \
                and getattr(decoder, "rollout_role", None) == "green":
            # bad-deploy profile: ONLY the green candidate's steps
            # stall (linear ramp to the peak, then hold) — the rollout
            # predicate must see green's ttft break from blue's
            # untouched baseline and roll back on its own
            gstep = self._green_step
            self._green_step += 1
            if gstep == 0:
                self.stamps["green_ramp_start"] = time.monotonic()
            stall = cfg.deploy_green_ramp_ms \
                * min(1.0, (gstep + 1) / cfg.deploy_green_ramp_steps)
            self.counters["green_ramp_stalls"] = \
                self.counters.get("green_ramp_stalls", 0) + 1
            time.sleep(stall / 1000.0)
        if cfg.latency_ramp_ms and cfg.latency_ramp_steps \
                and not self._ramp_cleared:
            window = cfg.latency_ramp_steps + cfg.latency_ramp_hold
            if step < window:
                if step == 0:
                    self.stamps["ramp_start"] = time.monotonic()
                # linear ramp toward the peak stall (burn builds up
                # instead of arriving as one cliff), then hold the
                # peak for latency_ramp_hold steps — a PERSISTENT
                # fault the governor must stay demoted under
                stall = cfg.latency_ramp_ms \
                    * min(1.0, (step + 1) / cfg.latency_ramp_steps)
                self.counters["ramp_stalls"] += 1
                time.sleep(stall / 1000.0)
            elif step == window:
                self.stamps["ramp_clear"] = time.monotonic()
        if cfg.pool_flood_pages and decoder is not None \
                and decoder.pool is not None and not self._flood_done:
            # >=, not ==: the scheduled step can land on a probe
            # decode's before_step() (no decoder) or on a try_reserve
            # race — retry until the flood actually engages
            if step >= cfg.pool_flood_at and self._flood_pages is None:
                # flood the RESERVATION plane (what the admission gate
                # sums), not the raw free list: admitted requests keep
                # their no-deadlock page promise while new arrivals
                # see a pool promised to capacity — exactly the
                # exhaustion signature the governor resizes against
                if decoder.pool.try_reserve(cfg.pool_flood_pages):
                    self._flood_pages = cfg.pool_flood_pages
                    self._flood_pool = decoder.pool
                    self.counters["pool_floods"] += 1
                    self.stamps["flood_start"] = time.monotonic()
                    self.warning("chaos: flooding KV pool (%d pages "
                                 "reserved)", cfg.pool_flood_pages)
            elif self._flood_pages is not None \
                    and step >= cfg.pool_flood_at + cfg.pool_flood_steps:
                self.release_flood()
        if cfg.waste_cause and cfg.waste_tokens and cfg.waste_steps:
            if cfg.waste_at <= step < cfg.waste_at + cfg.waste_steps:
                # synthetic waste of the NAMED cause into the process
                # ServeScope (the compile-storm injection idiom): the
                # waste-share rule must breach and the incident must
                # name exactly this cause — deterministic per step
                from veles_tpu_torch.observe.servescope import \
                    get_serve_scope
                get_serve_scope().inject_waste(cfg.waste_cause,
                                               cfg.waste_tokens)
                self.counters["waste_injections"] += 1
                if step == cfg.waste_at:
                    self.stamps["waste_start"] = time.monotonic()
            elif step == cfg.waste_at + cfg.waste_steps:
                self.stamps.setdefault("waste_clear", time.monotonic())
        if cfg.leak_retain_pool_at is not None \
                and self._leaked_pool is None and decoder is not None \
                and getattr(decoder, "pool", None) is not None \
                and step >= cfg.leak_retain_pool_at:
            # >=, not ==: the scheduled step can land on a probe
            # decode's before_step() (no decoder) — retry until a real
            # driver step carries the pool. Hold the strong ref FIRST,
            # then trip: the breaker rebuild replaces the decoder, the
            # zombie pool keeps reporting under kv_pool, and the edge
            # diff must name it
            self._leaked_pool = decoder.pool
            self.counters["pool_leaks"] += 1
            self.stamps["leak_at"] = time.monotonic()
            self.warning("chaos: retaining KV pool across the trip "
                         "(injected leak)")
            raise ChaosStepError(
                "chaos: injected trip with retained KV pool")
        if cfg.compile_storm_at is not None \
                and step == cfg.compile_storm_at:
            from veles_tpu_torch.observe.xla_stats import get_compile_tracker
            tracker = get_compile_tracker()
            if tracker.enabled:
                # a threshold-worth of same-name compiles inside the
                # window fires the storm detector — the governor's
                # proactive breaker guard sees exactly what a real
                # shape-churning storm would produce
                for _ in range(tracker.STORM_THRESHOLD):
                    tracker.record_compile("chaos.compile_storm", 0.001)
                self.counters["compile_storms"] += 1
                self.stamps["storm_at"] = time.monotonic()
                self.warning("chaos: injected recompile storm")

    def maybe_poison_swap(self, params):
        """The poisoned-checkpoint profile (``deploy_poison_nan``): the
        FIRST swap's first floating leaf (in the JAX package's flatten
        order) becomes NaN, which ``GenerateAPI``'s non-finite gate must
        refuse. Fires once; returns ``params``, poisoned or as given."""
        if not self.config.deploy_poison_nan or self._poison_done:
            return params
        self._poison_done = True
        for path, leaf in tree_leaves_with_path(params):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                params = tree_replace(params, path,
                                      torch.full_like(leaf, float("nan")))
                break
        self.counters["poisoned_swaps"] = \
            self.counters.get("poisoned_swaps", 0) + 1
        self.stamps["poison_at"] = time.monotonic()
        self.warning("chaos: poisoning swap checkpoint with NaNs")
        return params

    def clear_ramp(self):
        """End the latency ramp NOW (the harness clears a held fault;
        idempotent)."""
        if not self._ramp_cleared:
            self._ramp_cleared = True
            self.stamps.setdefault("ramp_clear", time.monotonic())

    def release_flood(self):
        """Drop the flood's reservation (the fault clears; also safe
        to call from the harness at teardown)."""
        self._flood_done = True
        if self._flood_pages is None:
            return
        pool, reserved = self._flood_pool, self._flood_pages
        self._flood_pages = None
        self._flood_pool = None
        try:
            pool.unreserve(reserved)
        finally:
            self.stamps["flood_clear"] = time.monotonic()

    def release_leak(self):
        """Drop the retained zombie pool (the injected leak clears;
        safe to call from the harness at teardown — the NEXT lifecycle
        edge diff then sees kv_pool shrink back)."""
        if self._leaked_pool is not None:
            self._leaked_pool = None
            self.stamps["leak_clear"] = time.monotonic()

    # -- client-side faults (rolled by the harness's chaos client) ------------
    def roll_client_fault(self):
        """One fault decision for the next client request: returns
        ``None`` (behave) or one of ``CLIENT_FAULTS``. Rolls every fault
        kind each call — fixed rng call order keeps the schedule
        deterministic — and fires the first that hits."""
        fired = None
        for kind in CLIENT_FAULTS:
            if roll(self._rng_client, getattr(self.config, kind)) \
                    and fired is None:
                fired = kind
        if fired is not None:
            self.counters[{"disconnect": "disconnects",
                           "garbage_body": "garbage_bodies",
                           "oversize_body": "oversize_bodies"}[fired]] += 1
        return fired


# -- replica-level chaos (the elastic router's proving ground) ---------------

#: the replica fault profiles the elastic serving acceptance drives
REPLICA_PROFILES = ("replica_kill", "replica_slow", "replica_flap",
                    "poison_healthz")

# every replica profile leads with the serve plane's per-replica goodput
# control series (REPLICA_GOODPUT_SERIES, ``fleet/serve_plane.py``),
# which the router (``router.py``) records on its poller


class ReplicaChaosConfig:
    """Deterministic, TICK-indexed replica fault schedule — the burn
    profiles' step-indexed idiom lifted to the fleet level (no RNG:
    a (config, workload) pair replays the same schedule). A tick is
    one harness control-loop pass (typically one router poll).

    - ``kill_at``/``kill_index`` — kill -9 replica ``kill_index`` at
      tick ``kill_at`` (mid-stream death: in-flight leases must fail
      over with bit-identical tokens);
    - ``slow_at``/``slow_ticks``/``slow_index`` — SIGSTOP the replica
      for ``slow_ticks`` ticks, then SIGCONT (slow-then-recovered: its
      late responses must be fence-discarded, never double-delivered);
    - ``flap_period``/``flap_index`` — toggle pause/resume every
      ``flap_period`` ticks (a flapping replica must not thrash the
      lifecycle: hysteresis + cooldown hold);
    - ``poison_healthz_at``/``poison_index`` — make the replica's
      ``/healthz`` lie (claims healthy while goodput collapses): the
      leave-one-out detector must name it anyway, because it scores
      RELATIVE goodput, not self-reported readiness.
    """

    def __init__(self, kill_at=None, kill_index=0, slow_at=None,
                 slow_ticks=0, slow_index=0, flap_period=0,
                 flap_index=0, poison_healthz_at=None, poison_index=0):
        if kill_at is not None and int(kill_at) < 0:
            raise ValueError("kill_at must be >= 0")
        self.kill_at = None if kill_at is None else int(kill_at)
        self.kill_index = int(kill_index)
        if slow_at is not None and int(slow_at) < 0:
            raise ValueError("slow_at must be >= 0")
        self.slow_at = None if slow_at is None else int(slow_at)
        self.slow_ticks = int(slow_ticks)
        if self.slow_ticks < 0:
            raise ValueError("slow_ticks must be >= 0")
        self.slow_index = int(slow_index)
        self.flap_period = int(flap_period)
        if self.flap_period < 0:
            raise ValueError("flap_period must be >= 0")
        self.flap_index = int(flap_index)
        if poison_healthz_at is not None and int(poison_healthz_at) < 0:
            raise ValueError("poison_healthz_at must be >= 0")
        self.poison_healthz_at = None if poison_healthz_at is None \
            else int(poison_healthz_at)
        self.poison_index = int(poison_index)

    @property
    def any_profile(self):
        return (self.kill_at is not None or self.slow_at is not None
                or self.flap_period > 0
                or self.poison_healthz_at is not None)

    def expected_leading_series(self):
        """Every replica profile collapses the named replica's goodput
        relative to the rest of the fleet, so the incident artifact's
        leading indicator is always the per-replica goodput control
        series (``fleet/serve_plane.py``)."""
        out = {}
        if self.kill_at is not None:
            out["replica_kill"] = REPLICA_GOODPUT_SERIES
        if self.slow_at is not None:
            out["replica_slow"] = REPLICA_GOODPUT_SERIES
        if self.flap_period > 0:
            out["replica_flap"] = REPLICA_GOODPUT_SERIES
        if self.poison_healthz_at is not None:
            out["poison_healthz"] = REPLICA_GOODPUT_SERIES
        return out


class ReplicaChaosMonkey(Logger):
    """The replica fault PLANNER: the harness owns the replica
    processes (it spawned them), so the monkey only decides — each
    :meth:`actions` call returns the (action, replica_index) pairs due
    at that tick and the harness executes them (``kill`` -> SIGKILL,
    ``pause``/``resume`` -> SIGSTOP/SIGCONT, ``poison_healthz`` -> flip
    the replica's health endpoint to lie). Fault instants land in
    ``stamps`` so the bench prices failover latency from the kill
    instant, not from detection."""

    #: the actions a harness must implement
    ACTIONS = ("kill", "pause", "resume", "poison_healthz")

    def __init__(self, config):
        super().__init__(logger_name="serve.ReplicaChaos")
        self.config = config
        self.counters = {"kills": 0, "pauses": 0, "resumes": 0,
                         "healthz_poisons": 0}
        self.stamps = {}
        self._flap_paused = False

    def actions(self, tick):
        """The (action, replica_index) pairs due at ``tick`` — fixed
        order: kill, slow, flap, poison."""
        cfg = self.config
        due = []
        if cfg.kill_at is not None and tick == cfg.kill_at:
            due.append(("kill", cfg.kill_index))
            self.counters["kills"] += 1
            self.stamps["kill_at"] = time.monotonic()
            self.warning("chaos: kill -9 replica %d", cfg.kill_index)
        if cfg.slow_at is not None:
            if tick == cfg.slow_at:
                due.append(("pause", cfg.slow_index))
                self.counters["pauses"] += 1
                self.stamps["slow_start"] = time.monotonic()
            elif tick == cfg.slow_at + cfg.slow_ticks:
                due.append(("resume", cfg.slow_index))
                self.counters["resumes"] += 1
                self.stamps["slow_clear"] = time.monotonic()
        if cfg.flap_period > 0 and tick > 0 \
                and tick % cfg.flap_period == 0:
            action = "resume" if self._flap_paused else "pause"
            self._flap_paused = not self._flap_paused
            due.append((action, cfg.flap_index))
            self.counters["pauses" if action == "pause"
                          else "resumes"] += 1
            self.stamps.setdefault("flap_start", time.monotonic())
        if cfg.poison_healthz_at is not None \
                and tick == cfg.poison_healthz_at:
            due.append(("poison_healthz", cfg.poison_index))
            self.counters["healthz_poisons"] += 1
            self.stamps["poison_healthz_at"] = time.monotonic()
        return due


# -- artifact faults (harness-side helper) -----------------------------------

def tear_file(path, frac=0.5):
    """Truncate ``path`` to ``frac`` of its bytes (a torn write / a
    crashed copy) WITHOUT touching any sidecar — the persistent
    executable cache's sha256 check must refuse the entry and fall
    back to a live nvcc build (aot/exec_cache.py). Returns the new
    size."""
    import os

    size = os.path.getsize(path)
    keep = max(0, int(size * float(frac)))
    with open(path, "rb+") as fobj:
        fobj.truncate(keep)
    return keep


# -- recorded-traffic chaos profiles (observe/replay.py) ---------------------

class RecordedTrafficProfile:
    """A RECORDED trace as a first-class chaos traffic profile
    (``observe/replay.py``): where the synthetic profiles above fault
    the server from inside, this one replays a captured adversarial
    traffic shape — a real burst, a tenant stampede, a long-context
    wave — against the surface under test, open-loop and seeded, so
    the same incident is reproducible on demand.

    Deterministic by construction: the arrival plan is fixed by
    (trace, seed, warp knobs) before a single request is sent
    (``plan()`` is pure; ``fingerprint()`` pins it), which is what
    makes a recorded incident a regression test instead of an
    anecdote. ``drive()`` accepts the replayer's ``poster`` injection,
    so chaos tests can script the transport with zero sockets."""

    def __init__(self, trace_path, warp=1.0, seed=0,
                 tenant_weights=None, long_context_skew=0.0,
                 burst_compress=0.0):
        from veles_tpu_torch.observe.replay import load_trace

        self.trace_path = str(trace_path)
        self.header, self.rows = load_trace(trace_path)
        self.warp = float(warp)
        self.seed = int(seed)
        self.warp_kw = {"tenant_weights": dict(tenant_weights or {}),
                        "long_context_skew": float(long_context_skew),
                        "burst_compress": float(burst_compress)}

    def plan(self):
        """The deterministic arrival plan (pure in trace + knobs)."""
        from veles_tpu_torch.observe.replay import warp_plan

        return warp_plan(self.rows, warp=self.warp, seed=self.seed,
                         **self.warp_kw)

    def fingerprint(self):
        """sha256 of the plan — two runs of one profile are THE SAME
        experiment iff their fingerprints match."""
        from veles_tpu_torch.observe.replay import plan_fingerprint

        return plan_fingerprint(self.plan())

    def expected_mix(self):
        """Tenant-hash -> arrival share of the PLANNED traffic (after
        reweighting) — what an acceptance asserts the replay held."""
        from veles_tpu_torch.observe.replay import tenant_mix

        return tenant_mix(self.plan())

    def drive(self, url=None, poster=None, **replay_kw):
        """Replay the profile against ``url`` (or a scripted
        ``poster``); returns the replay summary dict."""
        from veles_tpu_torch.observe.replay import replay

        return replay(self.plan(), url=url, poster=poster,
                      seed=self.seed, **replay_kw)
