"""Array: the framework's tensor slot.

The port's counterpart of ``veles_tpu/memory.py`` (reference
``veles/memory.py``). An Array holds one value: a numpy array on the host
or a torch tensor, which carries its own device. Units treat it as a
*slot*: producers assign ``.data`` each tick, consumers read it, so a data
link always sees the current value. ``to_device(device)`` moves the value
to an explicit device (``veles_tpu_torch.device.resolve_device`` names
it); ``mem`` is a host numpy view. :class:`Watcher` keeps the
high-water mark of the tensor bytes live Arrays hold (the JAX package's
``memory.py:41-73``, reference ``memory.py:56-107``): a torch tensor
counts, on whatever device it lies, as a ``jax.Array`` counts in the JAX
package; a numpy value does not. The reference's map/unmap coherency
protocol has no caller in the port and is left out.
"""

import threading

import numpy
import torch

from veles_tpu_torch.core.pickling import Pickleable


class Watcher:
    """The process-wide count of tensor bytes held by live Arrays and its
    high-water mark (the JAX package's ``Watcher``).

    An Array's finalizer releases its bytes through :meth:`release`, which
    never blocks: a garbage collection may run the finalizer on a thread
    that holds the lock (inside :meth:`add`), where waiting for it would
    deadlock that thread. Bytes released while the lock is held wait in
    ``_deferred`` and are taken off under the lock by the next call."""

    _lock = threading.Lock()
    _current = 0
    _peak = 0
    _deferred = []

    @classmethod
    def _drain(cls):
        """Take the deferred releases off the count (under the lock)."""
        while cls._deferred:
            cls._current -= cls._deferred.pop()

    @classmethod
    def add(cls, nbytes):
        with cls._lock:
            cls._drain()
            cls._current += nbytes
            cls._peak = max(cls._peak, cls._current)

    @classmethod
    def remove(cls, nbytes):
        with cls._lock:
            cls._drain()
            cls._current -= nbytes

    @classmethod
    def release(cls, nbytes):
        """:meth:`remove` for a finalizer: defers where the lock is held."""
        if not cls._lock.acquire(blocking=False):
            cls._deferred.append(nbytes)
            return
        try:
            cls._drain()
            cls._current -= nbytes
        finally:
            cls._lock.release()

    @classmethod
    def max_mem_in_use(cls):
        return cls._peak

    @classmethod
    def mem_in_use(cls):
        with cls._lock:
            cls._drain()
            return cls._current

    @classmethod
    def reset(cls):
        with cls._lock:
            del cls._deferred[:]
            cls._current = 0
            cls._peak = 0


def _tensor_bytes(value):
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return 0


class Array(Pickleable):
    """Host or device tensor slot (reference ``memory.py:110``)."""

    def __init__(self, value=None, dtype=None):
        super().__init__()
        self._data = None
        if value is not None:
            self.reset(value, dtype=dtype)

    def init_unpickled(self):
        super().init_unpickled()
        self._lock_ = threading.RLock()
        self._device_bytes_ = 0
        # an unpickled Array holds its tensor again: count it
        self._account(self.__dict__.get("_data"))

    def _account(self, value):
        """Move this Array's share of :class:`Watcher`'s count to
        ``value``'s tensor bytes."""
        nbytes = _tensor_bytes(value)
        if nbytes != self._device_bytes_:
            if self._device_bytes_:
                Watcher.remove(self._device_bytes_)
            if nbytes:
                Watcher.add(nbytes)
            self._device_bytes_ = nbytes

    def __del__(self):
        nbytes = self.__dict__.get("_device_bytes_")
        if nbytes:
            Watcher.release(nbytes)

    # -- value access ---------------------------------------------------------
    @property
    def data(self):
        """The current backing value (numpy array or torch tensor)."""
        return self._data

    @data.setter
    def data(self, value):
        with self._lock_:
            self._account(value)
            self._data = value

    @property
    def mem(self):
        """Host numpy view of the value (reference ``Array.mem``). A device
        tensor is copied to the host."""
        if self._data is None or isinstance(self._data, numpy.ndarray):
            return self._data
        return self._data.detach().cpu().numpy()

    def __bool__(self):
        return self._data is not None

    def reset(self, value=None, dtype=None):
        """Replace the backing value (reference ``Array.reset``): a tensor
        is kept as it is, anything else becomes a numpy array."""
        with self._lock_:
            if isinstance(value, Array):
                value = value.data
            if value is not None and not isinstance(value, torch.Tensor):
                value = numpy.asarray(value, dtype=dtype)
            self._account(value)
            self._data = value
            return self

    # -- shape/dtype ----------------------------------------------------------
    @property
    def shape(self):
        return None if self._data is None else tuple(self._data.shape)

    @property
    def dtype(self):
        return None if self._data is None else self._data.dtype

    def __len__(self):
        return 0 if self._data is None else self.shape[0]

    def __repr__(self):
        if self._data is None:
            return "<Array (empty)>"
        return "<Array %s %s %s>" % (self.shape, self.dtype, self.device)

    # -- device residency -----------------------------------------------------
    @property
    def device(self):
        """The value's torch device; numpy values live on the CPU."""
        if isinstance(self._data, torch.Tensor):
            return self._data.device
        return torch.device("cpu")

    def to_device(self, device):
        """Make the value a torch tensor on ``device`` (numpy values are
        wrapped, then moved). Raises what torch raises when the device
        cannot hold it: the port never falls back to the host quietly."""
        if self._data is None:
            return self
        with self._lock_:
            value = self._data
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(numpy.ascontiguousarray(value))
            value = value.to(device)
            self._account(value)
            self._data = value
        return self


def assert_addr(*arrays):
    """Raise ValueError unless every Array holds the same value object
    (the JAX package's ``assert_addr``, reference ``memory.py``: the
    arrays share one buffer)."""
    first = arrays[0]
    for array in arrays[1:]:
        if array.data is not first.data:
            raise ValueError("Arrays do not share the same backing value")
