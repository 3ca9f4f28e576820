"""Activation functions and their output-form derivatives.

The port of ``veles_tpu/ops/activations.py``: the Znicz forward units
(All2AllTanh/Sigmoid/RELU/StrictRELU/Softmax) apply these after the GEMM,
and the derivatives are written in terms of the activation OUTPUT, so a
backward needs only the forward result. The fused dense kernel
(``csrc/dense_epilogue.cu``) computes the same five functions on its f32
accumulator.
"""

import torch

TANH_A = 1.7159
TANH_B = 0.6666


def linear(x):
    return x


def linear_deriv(y):
    return torch.ones_like(y)


def tanh(x):
    """Scaled tanh: ``1.7159 * tanh(0.6666 x)`` (Znicz All2AllTanh)."""
    return TANH_A * torch.tanh(TANH_B * x)


def tanh_deriv(y):
    # d/dx A*tanh(Bx) = A*B*(1 - tanh^2) = B/A * (A^2 - y^2)
    return (y * y - TANH_A * TANH_A) * (-TANH_B / TANH_A)


def sigmoid(x):
    return torch.sigmoid(x)


def sigmoid_deriv(y):
    return y * (1.0 - y)


def relu(x):
    """Znicz RELU is the smooth variant ``log(1 + exp(x))`` (softplus),
    written as JAX's ``logaddexp(x, 0)``: no threshold cut-over."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def relu_deriv(y):
    # y = log(1+e^x) => dy/dx = 1 - e^-y
    return 1.0 - torch.exp(-y)


def strict_relu(x):
    return torch.relu(x)


def strict_relu_deriv(y):
    return (y > 0).to(y.dtype)


def softmax(x):
    """Softmax over the last axis (the JAX package's ``softmax``)."""
    return torch.softmax(x, dim=-1)


ACTIVATIONS = {
    "linear": (linear, linear_deriv),
    "tanh": (tanh, tanh_deriv),
    "sigmoid": (sigmoid, sigmoid_deriv),
    "relu": (relu, relu_deriv),
    "strict_relu": (strict_relu, strict_relu_deriv),
}
