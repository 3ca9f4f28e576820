"""Self-attention, feed-forward and layer-norm units: the sequence-model
tier's weight owners.

The port of ``veles_tpu/nn/attention.py:25-269``. Inputs and outputs are
(B, T, E). :class:`SelfAttention` owns the fused qkv projection (E, 3E)
and the out projection (E, E) with their biases; :class:`TokenFFN` the
expansion (E, ratio E) and contraction (ratio E, E) projections in the
same slot names (``weights``/``bias``, ``out_weights``/``out_bias``), so
the GD and fused-tick leaf contracts are shared; :class:`LayerNorm` the
scale (ones) and shift (zeros) of a normalization over the last axis with
the population variance and ``rsqrt(var + eps)``. The projections are
drawn U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from the unit's PRNG stream in
the JAX package's order, the biases are zeros; the numbers are torch's,
not threefry's, so runs that must agree carry weights across
(``veles_tpu_torch.convert.unit_params_from_jax``).

The math runs in the fused tick through ``ops/attention.attention_block``
and ``ffn_block`` (``parallel/fused.py``). The GD units own the
velocities of all four leaves (two for the layer norm) and the hyper
slots. Graph mode, the units' own computes and backward, is a later
slice, as it is for the dense units.
"""

import math

import torch

from veles_tpu_torch.core.prng import get as get_rng
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.gd import GradientDescent
from veles_tpu_torch.nn.jit_unit import ForwardUnit
from veles_tpu_torch.ops.attention import _FFN_ACTIVATIONS


def _missing(slot):
    return slot is None or (isinstance(slot, Array) and slot.data is None)


class SelfAttention(ForwardUnit):
    """Multi-head self-attention block: fused qkv projection, attention
    (``heads`` heads, ``causal`` or not), out projection, and with
    ``residual`` the block input added."""

    INPUTS = ("input", "weights", "bias", "out_weights", "out_bias")
    OUTPUTS = ("output",)

    def __init__(self, workflow, heads=8, causal=False, residual=False,
                 **kwargs):
        self.prng_key = kwargs.pop("prng_key", "default")
        super().__init__(workflow, **kwargs)
        self.heads = heads
        self.causal = causal
        self.residual = residual
        self.weights = Array()
        self.bias = Array()
        self.out_weights = Array()
        self.out_bias = Array()
        self.input = None

    def initialize(self, **kwargs):
        if _missing(self.input):
            return True  # retry after the provider initializes
        embed = self.input.shape[-1]
        if embed % self.heads:
            raise ValueError("%s: embed %d not divisible by %d heads"
                             % (self.name, embed, self.heads))
        device = self.workflow.device
        if self.weights.data is None:
            rng = get_rng(self.prng_key)
            stddev = 1.0 / math.sqrt(embed)
            self.weights.data = rng.fill_uniform((embed, 3 * embed), stddev,
                                                 device)
            self.bias.data = torch.zeros(3 * embed, device=device)
            self.out_weights.data = rng.fill_uniform((embed, embed), stddev,
                                                     device)
            self.out_bias.data = torch.zeros(embed, device=device)
        if self.output.data is None:
            self.output.data = torch.zeros(self.input.shape, device=device)


class TokenFFN(ForwardUnit):
    """Position-wise feed-forward block ``act(x @ w1 + b1) @ w2 + b2``
    (+ ``x`` with ``residual``, the default) over every token."""

    INPUTS = ("input", "weights", "bias", "out_weights", "out_bias")
    OUTPUTS = ("output",)

    def __init__(self, workflow, ratio=4, activation="gelu",
                 residual=True, **kwargs):
        self.prng_key = kwargs.pop("prng_key", "default")
        super().__init__(workflow, **kwargs)
        if activation not in _FFN_ACTIVATIONS:
            raise ValueError(
                "%s: unknown ffn activation %r (one of %s)"
                % (self.name, activation,
                   "/".join(sorted(_FFN_ACTIVATIONS))))
        self.ratio = ratio
        self.activation = activation
        self.residual = residual
        self.weights = Array()
        self.bias = Array()
        self.out_weights = Array()
        self.out_bias = Array()
        self.input = None

    def initialize(self, **kwargs):
        if _missing(self.input):
            return True
        embed = self.input.shape[-1]
        hidden = int(self.ratio * embed)
        device = self.workflow.device
        if self.weights.data is None:
            rng = get_rng(self.prng_key)
            self.weights.data = rng.fill_uniform(
                (embed, hidden), 1.0 / math.sqrt(embed), device)
            self.bias.data = torch.zeros(hidden, device=device)
            self.out_weights.data = rng.fill_uniform(
                (hidden, embed), 1.0 / math.sqrt(hidden), device)
            self.out_bias.data = torch.zeros(embed, device=device)
        if self.output.data is None:
            self.output.data = torch.zeros(self.input.shape, device=device)


class LayerNorm(ForwardUnit):
    """Layer normalization over the last axis with a learned scale and
    shift."""

    INPUTS = ("input", "weights", "bias")
    OUTPUTS = ("output",)

    def __init__(self, workflow, eps=1e-5, **kwargs):
        super().__init__(workflow, **kwargs)
        self.eps = eps
        self.weights = Array()
        self.bias = Array()
        self.input = None

    def initialize(self, **kwargs):
        if _missing(self.input):
            return True
        dim = self.input.shape[-1]
        device = self.workflow.device
        if self.weights.data is None:
            self.weights.data = torch.ones(dim, device=device)
            self.bias.data = torch.zeros(dim, device=device)
        if self.output.data is None:
            self.output.data = torch.zeros(self.input.shape, device=device)


class GDSelfAttention(GradientDescent):
    """The optimizer state of a :class:`SelfAttention`: the velocities
    (and second moments) of both projections and both biases. In the
    fused tick every leaf takes the weight decay, the biases at
    ``learning_rate_bias`` (``parallel/fused._ATTN_LEAVES``)."""

    LEAVES = (("weights", "_velocity_w"), ("bias", "_velocity_b"),
              ("out_weights", "_velocity_ow"), ("out_bias", "_velocity_ob"))
    INPUTS = ("err_output", "input", "weights", "bias", "out_weights",
              "out_bias", "_velocity_w", "_velocity_b", "_velocity_ow",
              "_velocity_ob", "_hyper")
    OUTPUTS = ("err_input", "weights", "bias", "out_weights", "out_bias",
               "_velocity_w", "_velocity_b", "_velocity_ow", "_velocity_ob")

    #: the JAX package's name for the wiring of all four leaves
    link_attention = GradientDescent.link_forward


class GDTokenFFN(GDSelfAttention):
    """The optimizer state of a :class:`TokenFFN`: the same four-leaf
    slot contract as :class:`GDSelfAttention`."""

    link_ffn = GradientDescent.link_forward


class GDLayerNorm(GradientDescent):
    """The optimizer state of a :class:`LayerNorm`: scale and shift; in
    the fused tick the scale takes the weight decay and the shift does
    not (``_WB_LEAVES``)."""
