"""JitUnit and ForwardUnit: the bases of the compute units.

The port of ``veles_tpu/nn/jit_unit.py:30-119``. A JitUnit writes one
``compute(*tensors)`` over the tensors of its INPUT slots and returns one
tensor per OUTPUT slot; ``run()`` gathers the inputs, calls the unit's
program and scatters the results back into the OUTPUT slots (Array
containers shared with the consumers by ``link_attrs``), so the units
downstream see the new values. That is graph mode (``fused=False``), and
the segment and sweep tiers (``parallel/segments.py``, ``sweep.py``)
compose the same computes.

PyTorch runs eagerly, so there is nothing to trace or compile: the
program is ``compute`` itself, run under ``torch.no_grad()`` (a unit that
needs gradients, a GD unit of a block, turns them on inside its own
compute). ``install_program`` is the seam where a caller puts another
program in its place. The port's AOT bundles (``aot/``) ship kernel
libraries, not programs, so its loader leaves this seam alone.

Contract:

- ``INPUTS``/``OUTPUTS`` name Array-slot attributes on the unit;
- ``compute(*tensors)`` is pure: hyperparameters that change between
  calls come in as tensors (the GD units' ``_hyper`` slot).
"""

import torch

from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.memory import Array


class JitUnit(Unit):
    """Base for units whose run() is one computation over Array slots."""

    hide_from_registry = True

    INPUTS = ()
    OUTPUTS = ()

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        for name in self.OUTPUTS:
            if getattr(self, name, None) is None:
                setattr(self, name, Array())

    def init_unpickled(self):
        super().init_unpickled()
        self._program_ = None

    # -- the pure computation -------------------------------------------------
    def compute(self, *tensors):
        """Pure function of the INPUT tensors; returns one tensor per OUTPUT
        (or a single tensor when there is one OUTPUT)."""
        raise NotImplementedError

    def install_program(self, fn):
        """Adopt a caller-provided program as this unit's compute: ``run()``
        calls it in place of :meth:`compute`, unchanged otherwise."""
        self._program_ = fn
        return self

    @property
    def program(self):
        """What ``run()`` calls: the installed program, else
        :meth:`compute` under ``torch.no_grad()``."""
        if self._program_ is None:
            self._program_ = torch.no_grad()(self.compute)
        return self._program_

    # -- slot plumbing --------------------------------------------------------
    def gather_inputs(self):
        values = []
        for name in self.INPUTS:
            slot = getattr(self, name)
            if isinstance(slot, Array):
                if slot.data is None:
                    raise ValueError(
                        "%s: input slot %r is empty" % (self.name, name))
                values.append(slot.data)
            else:
                values.append(slot)
        return values

    def scatter_outputs(self, results):
        if len(self.OUTPUTS) == 1:
            results = (results,)
        for name, value in zip(self.OUTPUTS, results):
            slot = getattr(self, name)
            if isinstance(slot, Array):
                slot.data = value
            else:
                setattr(self, name, value)

    def run(self):
        self.scatter_outputs(self.program(*self.gather_inputs()))


class ForwardUnit(JitUnit):
    """Marker base for forward-propagation units (the Znicz ``Forward``
    contract: ``input``/``output`` + ``weights``/``bias`` slots)."""

    hide_from_registry = True

    VIEW_GROUP = "WORKER"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.demand("input")
