"""Pooling: the plain functions and the units (Znicz MaxPooling,
AvgPooling, MaxAbsPooling and their GD twin).

The port of ``veles_tpu/nn/pooling.py:17-115``. Activations are NHWC, the
window (ky, kx), the stride ``sliding`` (the window by default), no
padding ("VALID": a ragged edge is dropped). One set of functions serves
the units and the fused tick (``parallel/fused.py``):

- :func:`max_pool`, ``torch.nn.functional.max_pool2d`` on the NCHW view;
- :func:`avg_pool`, the window sum, added in row-major window order as
  XLA's ``reduce_window`` adds, over ky * kx;
- :func:`maxabs_pool`, the signed value of the largest magnitude, built
  from two max pools as the JAX package builds it from the max and min
  windows: ``where(|mx| >= |mn|, mx, mn)`` with ``mn = -max_pool(-x)``
  (a +x / -x tie keeps +x).

The gradients are autograd's (:class:`GDPooling` pulls the error back
through the pool, as the JAX unit through ``jax.vjp``). On a tie a max
pool's gradient goes to the first element of the window in row-major
order: JAX's select-and-scatter rule, and ``max_pool2d``'s. The pools are
plain torch ops on either device; the JAX package runs XLA's
``reduce_window`` here, no TPU kernel.
"""

import torch
import torch.nn.functional as F

from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.gd import vjp
from veles_tpu_torch.nn.jit_unit import ForwardUnit


def max_pool(x, window, sliding):
    """The max over each (ky, kx) window of NHWC ``x``, stride
    ``sliding``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), tuple(window),
                        stride=tuple(sliding)).permute(0, 2, 3, 1)


def avg_pool(x, window, sliding):
    """The mean of each window: its sum in row-major window order, then
    divided by ky * kx."""
    ky, kx = window
    sy, sx = sliding
    oh = (x.shape[1] - ky) // sy + 1
    ow = (x.shape[2] - kx) // sx + 1
    total = None
    for i in range(ky):
        for j in range(kx):
            part = x[:, i:i + (oh - 1) * sy + 1:sy,
                     j:j + (ow - 1) * sx + 1:sx, :]
            total = part if total is None else total + part
    return total / (kx * ky)


def maxabs_pool(x, window, sliding):
    """The signed element of largest magnitude in each window (+x where
    +x and -x tie)."""
    mx = max_pool(x, window, sliding)
    mn = -max_pool(-x, window, sliding)
    return torch.where(mx.abs() >= mn.abs(), mx, mn)


#: the fused tick's pooling kinds (``fused.py:60-61``)
POOLS = {"max": max_pool, "avg": avg_pool, "maxabs": maxabs_pool}


class Pooling(ForwardUnit):
    """Base pooling over NHWC, window (ky, kx), stride = sliding."""

    #: the key of :data:`POOLS` the fused tick runs
    KIND = None

    INPUTS = ("input",)
    OUTPUTS = ("output",)

    def __init__(self, workflow, kx=2, ky=2, sliding=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.kx, self.ky = kx, ky
        self.sliding = tuple(sliding) if sliding else (ky, kx)
        self.input = None

    @property
    def window(self):
        return (self.ky, self.kx)

    def initialize(self, **kwargs):
        if self.input is None or (isinstance(self.input, Array)
                                  and self.input.data is None):
            return True
        if self.output.data is None:
            n, height, width, channels = self.input.shape
            oh = (height - self.ky) // self.sliding[0] + 1
            ow = (width - self.kx) // self.sliding[1] + 1
            self.output.data = torch.zeros((n, oh, ow, channels),
                                           device=self.workflow.device)

    def _pool(self, x):
        return POOLS[self.KIND](x, self.window, self.sliding)

    def compute(self, x):
        return self._pool(x)


class MaxPooling(Pooling):
    KIND = "max"


class AvgPooling(Pooling):
    KIND = "avg"


class MaxAbsPooling(Pooling):
    """Znicz's max-by-absolute-value pooling."""
    KIND = "maxabs"


class GDPooling(Unit):
    """The backward twin of any :class:`Pooling`: no parameters, only the
    error routed back through the pool (a host unit to the lower fusion
    tiers, as in the JAX package: it has no compute of its own)."""

    VIEW_GROUP = "TRAINER"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.forward_unit = None
        self.err_output = None
        self.input = None
        self.err_input = Array()
        self.demand("err_output", "input")

    def link_pooling(self, pooling_unit, err_source):
        from veles_tpu_torch.nn.gd import link_err_output
        self.forward_unit = pooling_unit
        self.link_attrs(pooling_unit, "input")
        link_err_output(self, err_source)
        return self

    def run(self):
        with torch.no_grad():
            self.err_input.data, = vjp(self.forward_unit._pool,
                                       (self.input.data,),
                                       self.err_output.data)
