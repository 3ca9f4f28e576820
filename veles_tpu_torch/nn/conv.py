"""Convolutional units (Znicz Conv and its GD twin): weight owners.

The port of ``veles_tpu/nn/conv.py:26-138``. Activations are NHWC and
weights HWIO (ky, kx, C, n_kernels), as in the JAX package, so a JAX
workflow's conv leaves carry over unchanged
(``veles_tpu_torch.convert.unit_params_from_jax``). The weights are drawn
U(-1/sqrt(ky kx C), 1/sqrt(ky kx C)) (or ``weights_stddev``) from the
unit's PRNG stream, the bias is zeros; the numbers are torch's, not
threefry's, so runs that must agree carry weights across.

The layer math, ``act(conv2d(x, w) + b)`` through ``ops/gemm.conv2d``
(the precision policy, XLA's "SAME" padding), runs in the fused tick
(``parallel/fused.py``) and in the units' own computes (graph mode and
the lower fusion tiers, ``conv.py:79-128``). The backward is autograd of
the paired forward's pre-activation (``nn/gd.vjp``), where the JAX
package calls ``jax.vjp``: the conv's own backward (cuDNN on the card,
TF32 off at levels 1 and 2). The GD units own the velocities and the
hyper slots, as the dense ones do.
"""

import math

import torch

from veles_tpu_torch.core.prng import get as get_rng
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.gd import GradientDescent, vjp
from veles_tpu_torch.nn.jit_unit import ForwardUnit
from veles_tpu_torch.ops import activations
from veles_tpu_torch.ops.gemm import conv2d, conv_output_hw


class Conv(ForwardUnit):
    """2-D convolution + activation."""

    ACTIVATION = "linear"

    INPUTS = ("input", "weights", "bias")
    OUTPUTS = ("output",)

    def __init__(self, workflow, n_kernels=None, kx=3, ky=3,
                 sliding=(1, 1), padding="SAME", **kwargs):
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        self.prng_key = kwargs.pop("prng_key", "default")
        super().__init__(workflow, **kwargs)
        if n_kernels is None:
            raise ValueError("%s needs n_kernels" % self.name)
        self.n_kernels = n_kernels
        self.kx, self.ky = kx, ky
        self.sliding = tuple(sliding)
        self.padding = padding
        self.weights = Array()
        self.bias = Array()
        self.input = None

    def initialize(self, **kwargs):
        if self.input is None or (isinstance(self.input, Array)
                                  and self.input.data is None):
            return True
        in_shape = tuple(self.input.shape)
        if len(in_shape) != 4:
            raise ValueError("%s expects NHWC input, got %s"
                             % (self.name, (in_shape,)))
        device = self.workflow.device
        channels = in_shape[3]
        if self.weights.data is None:
            fan_in = self.kx * self.ky * channels
            stddev = self.weights_stddev or 1.0 / math.sqrt(fan_in)
            self.weights.data = get_rng(self.prng_key).fill_uniform(
                (self.ky, self.kx, channels, self.n_kernels), stddev,
                device)
            self.bias.data = torch.zeros(self.n_kernels, device=device)
        if self.output.data is None:
            oh, ow = conv_output_hw(in_shape[1:3], (self.ky, self.kx),
                                    self.sliding, self.padding)
            self.output.data = torch.zeros(
                (in_shape[0], oh, ow, self.n_kernels), device=device)

    def _pre_activation(self, x, weights, bias):
        return conv2d(x, weights, self.sliding, self.padding) + bias

    def compute(self, x, weights, bias):
        act = activations.ACTIVATIONS[self.ACTIVATION][0]
        return act(self._pre_activation(x, weights, bias))


class ConvTanh(Conv):
    ACTIVATION = "tanh"


class ConvRELU(Conv):
    ACTIVATION = "relu"


class ConvStrictRELU(Conv):
    ACTIVATION = "strict_relu"


class GDConv(GradientDescent):
    """Backward unit for :class:`Conv`: the exact adjoint by autograd of
    the paired forward's pre-activation, and the update."""

    def link_conv(self, conv_unit, err_source):
        """Wire this GD unit to its conv twin and the error source."""
        return self.link_forward(conv_unit, err_source)

    def compute(self, err_output, x, y, weights, bias, vel_w, vel_b,
                *rest):
        upd, hyper, (sec_w, sec_b), extras = self._unpack_solver(rest)
        lr, lr_b, l2, l1 = hyper[0], hyper[1], hyper[2], hyper[3]
        err_pre = err_output * activations.ACTIVATIONS[self.ACTIVATION][1](y)
        err_input, grad_w, grad_b = vjp(self.forward_unit._pre_activation,
                                        (x, weights, bias), err_pre)
        grad_w = grad_w + l2 * weights + l1 * torch.sign(weights)
        new_w, new_vel_w, new_sec_w = upd(weights, grad_w, vel_w, sec_w,
                                          lr)
        new_b, new_vel_b, new_sec_b = upd(bias, grad_b, vel_b, sec_b,
                                          lr_b)
        return (err_input, new_w, new_b, new_vel_w, new_vel_b) \
            + extras((new_sec_w, new_sec_b))


class GDConvTanh(GDConv):
    ACTIVATION = "tanh"


class GDConvRELU(GDConv):
    ACTIVATION = "relu"


class GDConvStrictRELU(GDConv):
    ACTIVATION = "strict_relu"
