"""Reproducible named random streams.

The port's counterpart of ``veles_tpu/core/prng.py`` (reference
``veles/prng/random_generator.py``). Each named ``RandomGenerator`` owns:

- a numpy ``Generator`` over ``PCG64(seed)`` for host-side randomness
  (the loaders' index shuffles). It is the JAX package's stream bit for
  bit: the same seed gives the same shuffles in both packages;
- a counter for device-side draws: :meth:`fill_uniform` seeds an explicit
  ``torch.Generator`` from (seed, counter) for every draw, so a draw is a
  pure function of two integers, as a JAX key is. The numbers differ from
  JAX's threefry stream; weights that must agree across the two packages
  are carried across (``veles_tpu_torch.convert``).

Unlike the JAX package, ``seed(None)`` takes fresh entropy and persists
nothing: the port reads and writes no file outside its checkout.

A global keyed registry (``get(key)``) mirrors reference
``random_generator.py:289``. A stream pickles as its seed, its counter
and its numpy ``PCG64`` state (the lock is rebuilt on load), and
``streams_state`` / ``restore_streams`` carry every named stream through
a workflow snapshot, as the JAX package's ``prng.py:146-190`` do.
"""

import hashlib
import os
import threading

import numpy
import torch

from veles_tpu_torch.core.logger import Logger


class RandomGenerator(Logger):
    """A named reproducible random stream (reference
    ``prng/random_generator.py:64``)."""

    def __init__(self, key):
        super().__init__(logger_name="prng.%s" % key)
        self.key = key
        self._lock = threading.Lock()
        self.seed(None)

    def seed(self, seed):
        """Seed this stream from an int, bytes, a numpy array (hashed) or
        None (fresh entropy)."""
        if seed is None:
            seed = int.from_bytes(os.urandom(8), "little")
        elif isinstance(seed, (bytes, bytearray)):
            seed = self._hash_to_int(numpy.frombuffer(seed, numpy.uint8))
        elif isinstance(seed, numpy.ndarray):
            seed = self._hash_to_int(seed)
        self.initial_seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self._counter = 0
        self._numpy = numpy.random.Generator(
            numpy.random.PCG64(self.initial_seed))
        return self

    @staticmethod
    def _hash_to_int(array):
        return int.from_bytes(
            hashlib.sha256(array.tobytes()).digest()[:8], "little")

    # -- device-side (torch) --------------------------------------------------
    def next_generator(self, device):
        """A fresh ``torch.Generator`` on ``device`` seeded from (seed,
        counter); advances the stream counter."""
        with self._lock:
            self._counter += 1
            counter = self._counter
        digest = hashlib.sha256(b"%d:%d" % (self.initial_seed, counter))
        gen = torch.Generator(device=device)
        gen.manual_seed(int.from_bytes(digest.digest()[:8], "little")
                        & 0x7FFFFFFFFFFFFFFF)
        return gen

    def fill_uniform(self, shape, vle, device, dtype=torch.float32):
        """Device-side symmetric uniform fill U(-vle, vle) — the Znicz
        weight-init pattern — drawn on ``device`` from this stream's next
        generator."""
        gen = self.next_generator(device)
        return (torch.rand(shape, generator=gen, device=device, dtype=dtype)
                * (2 * vle) - vle)

    # -- host-side (numpy) ----------------------------------------------------
    @property
    def numpy_rng(self):
        return self._numpy

    def shuffle(self, arr):
        with self._lock:
            self._numpy.shuffle(arr)

    def randint(self, low, high=None, size=None):
        """Integers in [low, high) from the host stream (numpy's
        ``Generator.integers``, as the JAX package draws them)."""
        with self._lock:
            return self._numpy.integers(low, high, size)

    def normal(self, loc=0.0, scale=1.0, size=None):
        """Normal draws from the host stream (numpy's ``Generator.normal``,
        as the JAX package draws them: the Kohonen map's initial
        weights)."""
        with self._lock:
            return self._numpy.normal(loc, scale, size)

    def permutation(self, n):
        """A permutation of ``range(n)`` (or of an array) from the host
        stream."""
        with self._lock:
            return self._numpy.permutation(n)

    def random_sample(self, size=None):
        """Uniform draws in [0, 1) from the host stream (numpy's
        ``Generator.random``, as the JAX package draws them: the GA's
        members, crossovers and mutations)."""
        with self._lock:
            return self._numpy.random(size)

    def fill(self, arr, vmin=-1.0, vmax=1.0):
        """Fill the numpy array ``arr`` in place with uniform draws in
        [vmin, vmax) (reference ``random_generator.py`` fill)."""
        with self._lock:
            arr[...] = self._numpy.uniform(vmin, vmax, arr.shape)

    # -- snapshot support -------------------------------------------------------
    def __getstate__(self):
        with self._lock:
            return {"key": self.key, "initial_seed": self.initial_seed,
                    "counter": self._counter,
                    "numpy_state": self._numpy.bit_generator.state}

    def __setstate__(self, state):
        Logger.__init__(self, logger_name="prng.%s" % state["key"])
        self.key = state["key"]
        self._lock = threading.Lock()
        self.seed(state["initial_seed"])
        self._counter = state["counter"]
        self._numpy.bit_generator.state = state["numpy_state"]


_registry = {}
_registry_lock = threading.Lock()


def get(key="default"):
    """Global keyed stream registry (reference
    ``random_generator.py:289``)."""
    with _registry_lock:
        rg = _registry.get(key)
        if rg is None:
            rg = _registry[key] = RandomGenerator(key)
        return rg


def streams_state():
    """Every named stream's state, for a whole-workflow snapshot."""
    with _registry_lock:
        return {key: rg.__getstate__() for key, rg in _registry.items()}


def restore_streams(state):
    """Rebind the named streams to ``state`` (``streams_state()``'s
    output), in place: a holder of ``get(key)`` sees the restored
    stream."""
    with _registry_lock:
        for key, stream_state in state.items():
            rg = _registry.get(key)
            if rg is None:
                rg = _registry[key] = RandomGenerator.__new__(
                    RandomGenerator)
            rg.__setstate__(stream_state)
