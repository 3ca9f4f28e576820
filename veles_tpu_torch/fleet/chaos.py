"""Deterministic fault injection for the fleet (and the roll every chaos
monkey shares).

The port's copy of ``veles_tpu/fleet/chaos.py``: :class:`ChaosMonkey`
wraps a slave's post-handshake frame traffic and job loop and injects
frame delays and drops, slow jobs, duplicate update replays and
mid-job deaths, each decision a :func:`roll` on ONE seeded
``random.Random`` stream advanced in the same call order as the JAX
package's, so equal seeds give equal fault schedules in both packages.
The serving chaos harness (``serving_chaos.py``) builds on :func:`roll`
and :class:`ChaosConfigBase`.
"""

import asyncio
import os
import random

from veles_tpu_torch.core.logger import Logger

#: chaos config keys that are fault probabilities
PROBABILITY_KEYS = ("frame_delay", "frame_drop", "slow_job",
                    "duplicate_update", "death")


def roll(rng, probability):
    """One seeded fault decision: a probability <= 0 never fires and
    never advances the stream, so a schedule with a fault switched off
    draws exactly as one without it."""
    return probability > 0.0 and rng.random() < probability


class ChaosConfigBase:
    """Shared validation for seeded fault-probability configs: each
    subclass lists its fault knobs in ``PROBABILITY_KEYS`` and feeds
    them through :meth:`_set_probabilities` (all must lie in [0, 1]);
    ``any_enabled`` is the default-on trigger ``from_config`` uses."""

    PROBABILITY_KEYS = ()

    def _set_probabilities(self, **values):
        for name, value in values.items():
            value = float(value)
            if not 0.0 <= value <= 1.0:
                raise ValueError("chaos %s probability %r outside [0, 1]"
                                 % (name, value))
            setattr(self, name, value)

    @property
    def any_enabled(self):
        return any(getattr(self, key) > 0.0
                   for key in self.PROBABILITY_KEYS)


class ChaosConfig(ChaosConfigBase):
    """Validated fleet chaos knobs (all probabilities in [0, 1])."""

    PROBABILITY_KEYS = PROBABILITY_KEYS

    def __init__(self, seed=1, frame_delay=0.0, frame_delay_ms=20.0,
                 frame_drop=0.0, slow_job=0.0, slow_job_ms=50.0,
                 duplicate_update=0.0, death=0.0, death_mode="disconnect"):
        self._set_probabilities(
            frame_delay=frame_delay, frame_drop=frame_drop,
            slow_job=slow_job, duplicate_update=duplicate_update,
            death=death)
        if death_mode not in ("disconnect", "exit"):
            raise ValueError("chaos death_mode must be 'disconnect' or "
                             "'exit', got %r" % (death_mode,))
        self.seed = int(seed)
        self.frame_delay_ms = float(frame_delay_ms)
        self.slow_job_ms = float(slow_job_ms)
        self.death_mode = death_mode


class ChaosMonkey(Logger):
    """The client-side fault injector (see module docstring)."""

    def __init__(self, config):
        super().__init__(logger_name="fleet.Chaos")
        self.config = config
        self._rng = random.Random(config.seed)
        self.counters = {"frames_delayed": 0, "frames_dropped": 0,
                         "jobs_slowed": 0, "updates_duplicated": 0,
                         "deaths": 0}

    @classmethod
    def from_config(cls):
        """Build from ``root.common.fleet.chaos``; returns ``None`` when
        chaos is disabled (no probability set, or ``enabled = False``)."""
        from veles_tpu_torch.core.config import root
        cfg = root.common.fleet.chaos
        config = ChaosConfig(
            seed=cfg.get("seed", 1),
            frame_delay=cfg.get("frame_delay", 0.0),
            frame_delay_ms=cfg.get("frame_delay_ms", 20.0),
            frame_drop=cfg.get("frame_drop", 0.0),
            slow_job=cfg.get("slow_job", 0.0),
            slow_job_ms=cfg.get("slow_job_ms", 50.0),
            duplicate_update=cfg.get("duplicate_update", 0.0),
            death=cfg.get("death", 0.0),
            death_mode=cfg.get("death_mode", "disconnect"))
        if not cfg.get("enabled", config.any_enabled):
            return None
        monkey = cls(config)
        monkey.info(
            "chaos enabled (seed=%d): %s", config.seed,
            ", ".join("%s=%.3g" % (key, getattr(config, key))
                      for key in PROBABILITY_KEYS
                      if getattr(config, key) > 0.0))
        return monkey

    def _roll(self, probability):
        # one rng stream, always advanced in the same call order ->
        # deterministic fault schedule for a deterministic workload
        return roll(self._rng, probability)

    # -- frame-level faults ---------------------------------------------------
    async def read_frame(self, reader, key, **kwargs):
        from veles_tpu_torch.fleet.protocol import read_frame
        await self._maybe_delay()
        self._maybe_drop(None)
        return await read_frame(reader, key, **kwargs)

    async def write_frame(self, writer, message, key, shm_threshold=None):
        from veles_tpu_torch.fleet.protocol import write_frame
        await self._maybe_delay()
        self._maybe_drop(writer)
        if message.get("type") == "update":
            # stamp the running fault tallies into every update so the
            # master-side dashboard can prove each fault fired
            message["chaos"] = dict(self.counters)
        await write_frame(writer, message, key,
                          shm_threshold=shm_threshold)
        if message.get("type") == "update" \
                and self._roll(self.config.duplicate_update):
            self.counters["updates_duplicated"] += 1
            self.warning("chaos: replaying duplicate update (job_id=%r)",
                         message.get("job_id"))
            message["chaos"] = dict(self.counters)
            await write_frame(writer, message, key,
                              shm_threshold=shm_threshold)
        return None

    async def _maybe_delay(self):
        if self._roll(self.config.frame_delay):
            self.counters["frames_delayed"] += 1
            await asyncio.sleep(self.config.frame_delay_ms / 1000.0)

    def _maybe_drop(self, writer):
        if self._roll(self.config.frame_drop):
            self.counters["frames_dropped"] += 1
            self.warning("chaos: dropping frame (connection reset)")
            if writer is not None:
                writer.close()
            raise ConnectionResetError("chaos: injected frame drop")

    # -- job-level faults -----------------------------------------------------
    async def stretch_job(self):
        """Slow-slave fault: called by the client around ``_do_job``."""
        if self._roll(self.config.slow_job):
            self.counters["jobs_slowed"] += 1
            await asyncio.sleep(self.config.slow_job_ms / 1000.0)

    def maybe_die(self, writer=None):
        """The reference mid-job death, post-compute pre-ship."""
        if not self._roll(self.config.death):
            return
        self.counters["deaths"] += 1
        if self.config.death_mode == "exit":
            self.warning("chaos: dying mid-job (os._exit)")
            os._exit(1)
        self.warning("chaos: dying mid-job (disconnect)")
        if writer is not None:
            writer.close()
        raise ConnectionResetError("chaos: injected mid-job death")
