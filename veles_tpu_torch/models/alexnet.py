"""AlexNet topology: the BASELINE's ImageNet-AlexNet configuration.

The port of ``veles_tpu/models/alexnet.py:24-58``: the layer stack of
Krizhevsky et al. 2012 as StandardWorkflow specs, single tower, without
local response normalization or dropout (the JAX package's deltas), plus
a ``scale`` knob that shrinks every kernel and channel count so the same
topology trains on small inputs in the tests. Pair it with a full-batch
loader and ``normalization_type="mean_disp"`` for the BASELINE
configuration. On the card its convolutions and pools run as torch ops
(cuDNN) and its three dense layers through ``ops/gemm.dense_layer`` (K6
forward and K5 backward where the engine knobs and the gate allow).
"""

from veles_tpu_torch.models.standard import StandardWorkflow


def alexnet_layers(n_classes=1000, scale=1.0):
    """The AlexNet spec list; ``scale`` shrinks widths for smoke runs."""
    def ch(n):
        return max(4, int(n * scale))

    def units(n):
        return max(16, int(n * scale))

    return [
        {"type": "conv_relu", "n_kernels": ch(96), "kx": 11, "ky": 11,
         "sliding": (4, 4), "padding": "SAME"},
        {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": "conv_relu", "n_kernels": ch(256), "kx": 5, "ky": 5},
        {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": "conv_relu", "n_kernels": ch(384), "kx": 3, "ky": 3},
        {"type": "conv_relu", "n_kernels": ch(384), "kx": 3, "ky": 3},
        {"type": "conv_relu", "n_kernels": ch(256), "kx": 3, "ky": 3},
        {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": "all2all_relu", "output_sample_shape": units(4096)},
        {"type": "all2all_relu", "output_sample_shape": units(4096)},
        {"type": "softmax", "output_sample_shape": n_classes},
    ]


class AlexNetWorkflow(StandardWorkflow):
    """AlexNet through the standard declarative workflow (the JAX
    package's defaults: lr 0.01, moment 0.9, weight decay 5e-4)."""

    def __init__(self, workflow, n_classes=1000, scale=1.0, **kwargs):
        kwargs.setdefault("layers", alexnet_layers(n_classes, scale))
        kwargs.setdefault("learning_rate", 0.01)
        kwargs.setdefault("gradient_moment", 0.9)
        kwargs.setdefault("weights_decay", 5e-4)
        super().__init__(workflow, **kwargs)
