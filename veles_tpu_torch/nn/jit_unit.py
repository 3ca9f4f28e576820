"""JitUnit and ForwardUnit: the bases of the compute units.

The port's counterpart of ``veles_tpu/nn/jit_unit.py``. In the JAX package
a JitUnit's ``run()`` is one jitted ``compute()`` over its INPUT slots;
PyTorch runs eagerly, so there is nothing to compile. In this slice the
units are the composition API and the weight owners, and the fused tick
(``parallel/fused.py``) runs the whole chain: a unit's own ``compute()``
(graph mode, ``fused=False``) is a later slice and raises.
"""

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

    def run(self):
        raise NotImplementedError(
            "%s: graph mode (a unit's own compute, fused=False) is a later "
            "slice of the port; the fused tick runs the chain"
            % type(self).__name__)


class ForwardUnit(JitUnit):
    """Marker base for forward-propagation units (the Znicz ``Forward``
    contract: ``input``/``output`` + ``weights``/``bias`` slots)."""

    hide_from_registry = True

    VIEW_GROUP = "WORKER"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.demand("input")
