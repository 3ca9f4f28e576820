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

The math runs through ``ops/attention.attention_block`` and ``ffn_block``
in the fused tick (``parallel/fused.py``) and in the units' own computes
(graph mode and the lower fusion tiers, ``attention.py:77-269``): at T >=
4096 positions with 128-wide heads on the card the attention is the flash
kernel K7. The GD units own the velocities of all four leaves (two for
the layer norm) and the hyper slots; their backward is autograd of the
forward unit's own function (``nn/gd.vjp``, where the JAX package calls
``jax.vjp``), which recomputes the forward (K7 again) and runs the flash
backward K8 and K9 through the flash attention's autograd function.
"""

import math

import torch

from veles_tpu_torch.core.prng import get as get_rng
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.gd import GradientDescent, vjp
from veles_tpu_torch.nn.jit_unit import ForwardUnit
from veles_tpu_torch.ops.attention import (_FFN_ACTIVATIONS,
                                           attention_block, ffn_block)


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

    def _forward(self, x, w_qkv, b_qkv, w_out, b_out):
        # the fused tick's block math, residual included
        return attention_block(x, w_qkv, b_qkv, w_out, b_out, self.heads,
                               self.causal, self.residual)

    def compute(self, x, w_qkv, b_qkv, w_out, b_out):
        return self._forward(x, w_qkv, b_qkv, w_out, b_out)


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

    def _forward(self, x, w1, b1, w2, b2):
        return ffn_block(x, w1, b1, w2, b2, self.activation, self.residual)

    def compute(self, x, w1, b1, w2, b2):
        return self._forward(x, w1, b1, w2, b2)


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

    def _forward(self, x, scale, shift):
        # the population variance, as jnp.var
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + self.eps) * scale + shift

    def compute(self, x, scale, shift):
        return self._forward(x, scale, shift)


class GDSelfAttention(GradientDescent):
    """Backward for :class:`SelfAttention` by autograd of its forward:
    updates both projections and both biases, each leaf with the weight
    decay, the biases at ``learning_rate_bias`` (the fused tick's
    ``_ATTN_LEAVES``)."""

    LEAVES = (("weights", "_velocity_w"), ("bias", "_velocity_b"),
              ("out_weights", "_velocity_ow"), ("out_bias", "_velocity_ob"))
    INPUTS = ("err_output", "input", "weights", "bias", "out_weights",
              "out_bias", "_velocity_w", "_velocity_b", "_velocity_ow",
              "_velocity_ob", "_hyper")
    OUTPUTS = ("err_input", "weights", "bias", "out_weights", "out_bias",
               "_velocity_w", "_velocity_b", "_velocity_ow", "_velocity_ob")

    #: the JAX package's name for the wiring of all four leaves
    link_attention = GradientDescent.link_forward

    def compute(self, err_output, x, w_qkv, b_qkv, w_out, b_out,
                vel_w, vel_b, vel_ow, vel_ob, *rest):
        solver_upd, hyper, secs, extras = self._unpack_solver(
            rest, n_leaves=4)
        lr, lr_b, l2, l1 = hyper[0], hyper[1], hyper[2], hyper[3]
        err_input, g_qkv, g_bqkv, g_out, g_bout = vjp(
            self.forward_unit._forward, (x, w_qkv, b_qkv, w_out, b_out),
            err_output)

        def upd(w, g, v, sec, rate):
            g = g + l2 * w + l1 * torch.sign(w)
            return solver_upd(w, g, v, sec, rate)

        w_qkv, vel_w, sec_w = upd(w_qkv, g_qkv, vel_w, secs[0], lr)
        b_qkv, vel_b, sec_b = upd(b_qkv, g_bqkv, vel_b, secs[1], lr_b)
        w_out, vel_ow, sec_ow = upd(w_out, g_out, vel_ow, secs[2], lr)
        b_out, vel_ob, sec_ob = upd(b_out, g_bout, vel_ob, secs[3], lr_b)
        return (err_input, w_qkv, b_qkv, w_out, b_out,
                vel_w, vel_b, vel_ow, vel_ob) \
            + extras((sec_w, sec_b, sec_ow, sec_ob))


class GDTokenFFN(GDSelfAttention):
    """Backward for :class:`TokenFFN`: :class:`GDSelfAttention`'s
    four-leaf update (the same slot contract)."""

    link_ffn = GradientDescent.link_forward


class GDLayerNorm(GradientDescent):
    """Backward for :class:`LayerNorm` by autograd of its forward: trains
    the scale (with the weight decay) and the shift (without), and routes
    the input error."""

    def compute(self, err_output, x, y, scale, shift, vel_w, vel_b,
                *rest):
        upd, hyper, (sec_w, sec_b), extras = self._unpack_solver(rest)
        lr, lr_b, l2, l1 = hyper[0], hyper[1], hyper[2], hyper[3]
        err_input, g_scale, g_shift = vjp(self.forward_unit._forward,
                                          (x, scale, shift), err_output)
        g_scale = g_scale + l2 * scale + l1 * torch.sign(scale)
        new_w, new_vel_w, new_sec_w = upd(scale, g_scale, vel_w, sec_w, lr)
        new_b, new_vel_b, new_sec_b = upd(shift, g_shift, vel_b, sec_b,
                                          lr_b)
        return (err_input, new_w, new_b, new_vel_w, new_vel_b) \
            + extras((new_sec_w, new_sec_b))
