"""Avatar: run a sub-graph on a frozen copy of other units' state.

The port of ``veles_tpu/avatar.py`` (reference ``veles/avatar.py:22-129``):
an Avatar registers (unit, attrs) pairs with :meth:`link_clones`; each
``run()`` (or an explicit :meth:`clone`) copies those attributes onto
itself. An Array's tensor is cloned into a buffer of its own on the same
device: the port updates tensors in place (the JAX package's arrays are
immutable, so it publishes the reference), and a snapshot must not move
with the live unit. A host numpy value is copied, a Bool keeps its value,
immutable scalars are shared and anything else is deep-copied. Consumers
link from the Avatar instead of the live units and so see a stale but
consistent snapshot, a plotter or an exporter running beside training.
"""

import copy

import numpy
import torch

from veles_tpu_torch.core.mutable import Bool
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.memory import Array


class Avatar(Unit):
    """State-cloning proxy unit (reference ``Avatar``, ``avatar.py:22``)."""

    VIEW_GROUP = "LOADER"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.reals = {}

    def link_clones(self, unit, *attrs):
        """Declare which attributes of ``unit`` this Avatar mirrors."""
        self.reals.setdefault(unit, []).extend(attrs)

    def clone(self):
        for unit, attrs in self.reals.items():
            for attr in attrs:
                value = getattr(unit, attr)
                if isinstance(value, Array):
                    mine = getattr(self, attr, None)
                    if not isinstance(mine, Array):
                        mine = Array()
                        setattr(self, attr, mine)
                    if isinstance(value.data, torch.Tensor):
                        mine.data = value.data.detach().clone()
                    elif value.data is not None:
                        mine.reset(numpy.array(value.data))
                elif isinstance(value, Bool):
                    mine = getattr(self, attr, None)
                    if isinstance(mine, Bool):
                        mine.set(bool(value))
                    else:
                        setattr(self, attr, Bool(bool(value)))
                elif isinstance(value, (int, float, str, bytes, tuple,
                                        type(None))):
                    setattr(self, attr, value)
                else:
                    setattr(self, attr, copy.deepcopy(value))

    def initialize(self, **kwargs):
        self.clone()

    def run(self):
        self.clone()
