"""The seeded fault roll every chaos monkey shares.

The port's own copy of ``veles_tpu/fleet/chaos.py:43-70``: :func:`roll`
and :class:`ChaosConfigBase`, which the serving chaos harness
(``serving_chaos.py``) builds on. The fleet's own monkey (frame delays
and drops, slow slaves, replays, deaths) belongs to the fleet plane,
which the port does not have.
"""


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
