"""All2All: fully-connected forward units, the weight owners.

The port of ``veles_tpu/nn/all2all.py`` (the Znicz All2All family). Weight
layout is (in_features, out_features). Weights are initialized
U(-stddev, stddev) on the workflow's device from the unit's named PRNG
stream, ``1/sqrt(fan_in)`` unless ``weights_stddev`` is given; the
numbers differ from the JAX package's (torch's generator, not threefry),
so runs that must agree carry weights across
(``veles_tpu_torch.convert.unit_params_from_jax``). The layer math,
``act(x @ W + b)``, runs in the fused tick through ``ops/gemm.dense_layer``
and in the unit's own :meth:`All2All.compute` (graph mode and the lower
fusion tiers, ``all2all.py:97-121``) through ``ops/gemm.matmul``, so an
eligible product runs K5 with ``root.common.engine.use_pallas`` on, as
the JAX unit reaches ``pallas_matmul``. The softmax head emits logits (and
their argmax); the softmax lives in the evaluator's cross-entropy.
"""

import math

import torch

from veles_tpu_torch.core.prng import get as get_rng
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.jit_unit import ForwardUnit
from veles_tpu_torch.ops import activations
from veles_tpu_torch.ops.gemm import matmul


class All2All(ForwardUnit):
    """Linear layer: output = act(input @ weights + bias)."""

    ACTIVATION = "linear"

    INPUTS = ("input", "weights", "bias")
    OUTPUTS = ("output",)

    def __init__(self, workflow, output_sample_shape=None, **kwargs):
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        self.bias_stddev = kwargs.pop("bias_stddev", None)
        self.include_bias = kwargs.pop("include_bias", True)
        self.prng_key = kwargs.pop("prng_key", "default")
        super().__init__(workflow, **kwargs)
        if output_sample_shape is None:
            raise ValueError("%s needs output_sample_shape" % self.name)
        if isinstance(output_sample_shape, int):
            output_sample_shape = (output_sample_shape,)
        self.output_sample_shape = tuple(output_sample_shape)
        self.weights = Array()
        self.bias = Array()
        self.input = None

    @property
    def neurons_number(self):
        return int(math.prod(self.output_sample_shape))

    def initialize(self, **kwargs):
        if self.input is None or (isinstance(self.input, Array)
                                  and self.input.data is None):
            return True  # retry after the provider initializes
        device = self.workflow.device
        in_features = int(math.prod(self.input.shape[1:]))
        out_features = self.neurons_number
        if self.weights.data is None:
            stddev = self.weights_stddev or 1.0 / math.sqrt(in_features)
            rng = get_rng(self.prng_key)
            self.weights.data = rng.fill_uniform(
                (in_features, out_features), stddev, device)
            self.bias.data = rng.fill_uniform(
                (out_features,), self.bias_stddev or stddev, device) \
                if self.include_bias else torch.zeros(out_features,
                                                      device=device)
        if self.output.data is None:
            # the output slot's shape lets the next unit initialize
            # before the first tick
            batch = self.input.shape[0]
            self.output.data = torch.zeros(
                (batch,) + self.output_sample_shape, device=device)

    def compute(self, x, weights, bias):
        x = x.reshape(x.shape[0], -1)
        pre = matmul(x, weights, out_dtype=torch.float32) + bias
        out = activations.ACTIVATIONS[self.ACTIVATION][0](pre)
        if len(self.output_sample_shape) > 1:
            out = out.reshape((x.shape[0],) + self.output_sample_shape)
        return out


class All2AllTanh(All2All):
    """Scaled-tanh dense layer (Znicz All2AllTanh, 1.7159·tanh(0.6666x))."""
    ACTIVATION = "tanh"


class All2AllRELU(All2All):
    """Softplus dense layer (Znicz All2AllRELU is log(1+e^x))."""
    ACTIVATION = "relu"


class All2AllStrictRELU(All2All):
    """max(0, x) dense layer."""
    ACTIVATION = "strict_relu"


class All2AllSigmoid(All2All):
    ACTIVATION = "sigmoid"


class All2AllSoftmax(All2All):
    """Classifier head. Emits **logits** in ``output`` plus their argmax
    in ``max_idx``; the softmax lives fused inside the evaluator's
    cross-entropy."""

    ACTIVATION = "linear"
    OUTPUTS = ("output", "max_idx")

    def compute(self, x, weights, bias):
        logits = super().compute(x, weights, bias)
        return logits, logits.argmax(dim=-1)
