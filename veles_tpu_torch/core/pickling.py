"""Pickling base: trailing-underscore attribute stripping + rebuild hook.

The port's copy of ``veles_tpu/core/pickling.py`` (reference
``veles/distributable.py:48-133``). Attributes whose names end with ``_``
are volatile (locks, loggers, live tensors of an engine) — excluded from
pickles and rebuilt in ``init_unpickled()`` after load. Torch tensors are
moved to the host on ``__getstate__`` so snapshots are device-independent.
"""

import pickle

import torch

from veles_tpu_torch.core.logger import Logger

best_protocol = pickle.HIGHEST_PROTOCOL


def tensor_to_host(value):
    """Move torch tensors (possibly nested in containers) to the CPU."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: tensor_to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(tensor_to_host(v) for v in value)
    return value


class Pickleable(Logger):
    """Base with the trailing-underscore pickling contract
    (reference ``distributable.py:48``)."""

    def __init__(self, **kwargs):
        self.stripped_pickle = False
        super().__init__(**kwargs)
        self.init_unpickled()

    def init_unpickled(self):
        """Rebuild volatile (``*_``-named) state; called from ``__init__``
        and after unpickling (reference ``distributable.py:60-67``)."""
        self.stripped_pickle = False

    def __getstate__(self):
        state = {}
        for key, value in self.__dict__.items():
            if key.endswith("_") and not (key.startswith("__")
                                          and key.endswith("__")):
                continue
            state[key] = tensor_to_host(value)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._logger_ = None
        self.init_unpickled()
