"""Timing helpers (reference: ``veles/timeit2.py:43``)."""

import functools
import time


def timeit(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` and return ``(result, seconds)``."""
    start = time.perf_counter()
    result = fn(*args, **kwargs)
    return result, time.perf_counter() - start


class Timer:
    """Cumulative wall-clock timer with call counting.

    Used for the per-unit timers that wrap every ``run()`` in the reference
    (``veles/units.py:124-126,805-817``).
    """

    __slots__ = ("total", "calls", "_start")

    def __init__(self):
        self.total = 0.0
        self.calls = 0
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._start
        self.calls += 1
        self._start = None
        return False

    @property
    def average(self):
        return self.total / self.calls if self.calls else 0.0

    def reset(self):
        self.total = 0.0
        self.calls = 0


def timed(method):
    """Decorator accumulating wall time into
    ``self.timers[method.__name__]``."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        timers = getattr(self, "timers", None)
        if timers is None:
            return method(self, *args, **kwargs)
        timer = timers.setdefault(method.__name__, Timer())
        with timer:
            return method(self, *args, **kwargs)
    return wrapper
