"""Array: the framework's tensor slot.

The port's counterpart of ``veles_tpu/memory.py`` (reference
``veles/memory.py``). An Array holds one value: a numpy array on the host
or a torch tensor, which carries its own device. Units treat it as a
*slot*: producers assign ``.data`` each tick, consumers read it, so a data
link always sees the current value. ``to_device(device)`` moves the value
to an explicit device (``veles_tpu_torch.device.resolve_device`` names
it); ``mem`` is a host numpy view. The reference's map/unmap coherency
protocol and the JAX package's device-bytes watcher have no caller in the
port and are left out.
"""

import threading

import numpy
import torch

from veles_tpu_torch.core.pickling import Pickleable


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

    # -- value access ---------------------------------------------------------
    @property
    def data(self):
        """The current backing value (numpy array or torch tensor)."""
        return self._data

    @data.setter
    def data(self, value):
        with self._lock_:
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
            self._data = value.to(device)
        return self
