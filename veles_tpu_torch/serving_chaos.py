"""Deterministic chaos harness for the serving path.

The port of ``veles_tpu/serving_chaos.py:87-517``: the seeded fault
injector that :class:`~veles_tpu_torch.serving.GenerateAPI`'s driver
calls before every decoder dispatch, and the client-fault roll a test
harness uses. Two fault families:

**Server-side (driver) faults**, through
:meth:`ServingChaosMonkey.before_step`:

- **step failure** — raise :class:`ChaosStepError` from a decoder step,
  standing in for a device or runtime error under the driver; this is
  what trips the circuit breaker. ``step_fail_max`` caps the injected
  failures, so a chaos run settles and every request completes.
- **slow step** — stretch a decode step by ``slow_step_ms``.

**Step-indexed profiles** (no RNG): the **latency ramp**
(``latency_ramp_ms`` over ``latency_ramp_steps``, held for
``latency_ramp_hold`` more steps or until :meth:`clear_ramp`), the
**pool flood** (``pool_flood_pages`` reserved from the decoder's KV pool
at step ``pool_flood_at`` for ``pool_flood_steps`` steps, or until
:meth:`release_flood`) and the **poisoned swap** (``deploy_poison_nan``:
the first weight swap's first floating leaf becomes NaN,
:meth:`maybe_poison_swap`). Their inject and clear instants land in
``stamps``.

**Client-side faults**, rolled by the harness with
:meth:`roll_client_fault`: ``disconnect``, ``garbage_body`` and
``oversize_body``.

Each family draws from its own stream — driver faults from
``random.Random(seed)``, client faults from
``random.Random("client-<seed>")`` — so a (seed, workload) pair replays
the JAX package's fault schedule draw for draw: a probability <= 0
never advances a stream, and ``before_step`` rolls ``slow_step`` before
``step_fail``.

The JAX package's compile-storm, waste, green-ramp and pool-leak
profiles feed what acts on the observe plane's hooks (the serve and
memory scopes, the governor's storm sensing) and its blue-green rollout,
which arrive with ROADMAP A7 (c): a knob of one of them raises
ValueError naming the profile.

Configuration: ``root.common.serve.chaos.*`` (:meth:`from_config`).
"""

import random
import time

import torch

from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.device import tree_leaves_with_path, tree_replace
from veles_tpu_torch.fleet.chaos import ChaosConfigBase, roll

#: chaos config keys that are fault probabilities
PROBABILITY_KEYS = ("step_fail", "slow_step", "disconnect",
                    "garbage_body", "oversize_body")

#: client-side fault kinds, in their fixed roll order
CLIENT_FAULTS = ("disconnect", "garbage_body", "oversize_body")


class ChaosStepError(RuntimeError):
    """The injected decoder-step failure (stands in for a device or
    runtime error under the driver loop)."""


class ServingChaosConfig(ChaosConfigBase):
    """Validated serving-chaos knobs (probabilities in [0, 1]). The
    signature is the JAX package's; a knob of a profile the port has
    not ported (``compile_storm_at``, ``waste_*``,
    ``deploy_green_ramp_*``, ``leak_retain_pool_at``) raises
    ValueError when set."""

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
        unported = {
            "compile storm (compile_storm_at)": compile_storm_at
            is not None,
            "waste (waste_cause, waste_tokens, waste_at, waste_steps)":
            waste_cause is not None or any((waste_tokens, waste_at,
                                            waste_steps)),
            "green ramp (deploy_green_ramp_ms, deploy_green_ramp_steps)":
            bool(deploy_green_ramp_ms or deploy_green_ramp_steps),
            "pool leak (leak_retain_pool_at)": leak_retain_pool_at
            is not None}
        for profile, set_ in unported.items():
            if set_:
                raise ValueError(
                    "the %s chaos profile is not yet ported: it feeds "
                    "the observe plane's scopes or the blue-green "
                    "rollout (ROADMAP A7 (c))" % profile)
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
        self.deploy_poison_nan = bool(deploy_poison_nan)

    @property
    def any_profile(self):
        """True when a step-indexed profile is configured."""
        return bool((self.latency_ramp_ms and self.latency_ramp_steps)
                    or self.pool_flood_pages or self.deploy_poison_nan)


class ServingChaosMonkey(Logger):
    """The serving-path fault injector (see the module docstring)."""

    def __init__(self, config):
        super().__init__(logger_name="serve.Chaos")
        self.config = config
        # one stream per fault family: the driver thread and the
        # harness's client thread never share an RNG
        self._rng = random.Random(config.seed)
        self._rng_client = random.Random("client-%d" % config.seed)
        self.counters = {"steps_failed": 0, "steps_slowed": 0,
                         "disconnects": 0, "garbage_bodies": 0,
                         "oversize_bodies": 0, "ramp_stalls": 0,
                         "pool_floods": 0}
        #: driver-step index of the step-indexed profiles
        self._step = 0
        self._poison_done = False
        self._ramp_cleared = False
        #: the flood's reserved pages and their pool; done latches after
        #: the release, so the flood fires once
        self._flood_pages = None
        self._flood_pool = None
        self._flood_done = False
        #: fault inject / clear instants (monotonic)
        self.stamps = {}

    @classmethod
    def from_config(cls):
        """Build from ``root.common.serve.chaos``; returns None when
        chaos is off (no probability or profile set, or ``enabled =
        False``)."""
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
            deploy_green_ramp_steps=cfg.get("deploy_green_ramp_steps", 0),
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

    # -- server-side (driver) faults ------------------------------------
    def before_step(self, decoder=None):
        """Called by the GenerateAPI driver before each decoder dispatch
        (and by probe decodes, without a decoder): maybe stretch the
        step, maybe raise the injected device failure. ``decoder`` is
        the pool flood's seat: it reserves pages from the decoder's
        pool."""
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

    def _run_profiles(self, decoder):
        """Advance the step index and fire whichever step-indexed
        profiles the step falls inside."""
        cfg = self.config
        step = self._step
        self._step += 1
        if cfg.latency_ramp_ms and cfg.latency_ramp_steps \
                and not self._ramp_cleared:
            window = cfg.latency_ramp_steps + cfg.latency_ramp_hold
            if step < window:
                if step == 0:
                    self.stamps["ramp_start"] = time.monotonic()
                # a linear ramp to the peak stall, then the peak held
                stall = cfg.latency_ramp_ms \
                    * min(1.0, (step + 1) / cfg.latency_ramp_steps)
                self.counters["ramp_stalls"] += 1
                time.sleep(stall / 1000.0)
            elif step == window:
                self.stamps["ramp_clear"] = time.monotonic()
        if cfg.pool_flood_pages and decoder is not None \
                and decoder.pool is not None and not self._flood_done:
            # >=: the scheduled step may land on a probe decode (no
            # decoder) or lose a reservation race; retry until it holds
            if step >= cfg.pool_flood_at and self._flood_pages is None:
                # the reservation plane, which the admission gate sums:
                # admitted requests keep their pages, new arrivals see a
                # pool promised to capacity
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
        """End the latency ramp now (idempotent)."""
        if not self._ramp_cleared:
            self._ramp_cleared = True
            self.stamps.setdefault("ramp_clear", time.monotonic())

    def release_flood(self):
        """Drop the flood's reservation (also safe at teardown)."""
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

    # -- client-side faults (rolled by the harness) ---------------------
    def roll_client_fault(self):
        """One fault decision for the next client request: None (behave)
        or one of :data:`CLIENT_FAULTS`. Every kind is rolled each call,
        in a fixed order, and the first that hits fires."""
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
