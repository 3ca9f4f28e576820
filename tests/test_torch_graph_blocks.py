"""Graph mode in the port for the structured layers: the digits convnet
of tests/test_fused.py:125 (conv_tanh, max pooling, softmax on 8 x 8 x 1
images) and the transformer stacks of :209 and :255 (layer norm,
self-attention, feed-forward on (8, 16) sequences) against the JAX
package's graph mode on the CPU, from its initial state carried across,
and graph mode against the port's fused tick for these and the MLP.
Integer outputs (per-epoch n_err, epoch counts, the best epoch) must be
equal; weights agree within 1e-5 at level 2 (f32: summation order only).
The helpers are tests/test_torch_graph.py's."""

import numpy
import pytest
import torch

from veles_tpu.models.standard import StandardWorkflow as JStandardWorkflow
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.models.standard import StandardWorkflow

from test_torch_graph import (LEVEL2_ATOL, _digits, _port,
                              _record_epochs, compare_leaves, engine,
                              mlp_kwargs, pair, run_and_compare)

torch.set_num_threads(1)


def _sequences(seed):
    """tests/test_fused.py:209's two-class sequences: (300, 8, 16)."""
    rng = numpy.random.RandomState(seed)
    n, t, e = 300, 8, 16
    x = rng.randn(n, t, e).astype(numpy.float32) * 0.1
    y = rng.randint(0, 2, n).astype(numpy.int32)
    for i in range(n):
        x[i, : t // 2 if y[i] == 0 else t, 0] += 1.0
    return x, y


def test_digits_convnet_graph_mode_matches_jax(engine):
    """tests/test_fused.py:125's convnet (conv_tanh 8, max pooling 2x2,
    softmax) in graph mode, level 2: GDConv's autograd against jax.vjp,
    GDPooling as a host unit."""
    engine(precision_level=2)
    x, y = _digits(images=True)
    kwargs = dict(
        layers=[{"type": "conv_tanh", "n_kernels": 8, "kx": 3, "ky": 3},
                {"type": "max_pooling", "kx": 2, "ky": 2},
                {"type": "softmax", "output_sample_shape": (10,)}],
        loader_kwargs=dict(data=x[:600], labels=y[:600],
                           class_lengths=[0, 100, 500], minibatch_size=100,
                           normalization_type="linear"),
        learning_rate=0.05, fused=False,
        decision_kwargs=dict(max_epochs=2), name="graph-conv")
    jwf, twf = pair(JStandardWorkflow, StandardWorkflow, seeds=(99, 77),
                    **kwargs)
    epochs = run_and_compare(jwf, twf, LEVEL2_ATOL)
    assert len(epochs) == 2


TRANSFORMER_LAYERS = {
    "attention": [{"type": "layer_norm"},
                  {"type": "self_attention", "heads": 4},
                  {"type": "softmax", "output_sample_shape": (2,)}],
    "block": [{"type": "layer_norm"},
              {"type": "self_attention", "heads": 4, "residual": True},
              {"type": "layer_norm"},
              {"type": "ffn", "ratio": 2},
              {"type": "softmax", "output_sample_shape": (2,)}],
}


def transformer_kwargs(kind, fused):
    x, y = _sequences(0 if kind == "attention" else 1)
    return dict(layers=TRANSFORMER_LAYERS[kind],
                loader_kwargs=dict(data=x, labels=y,
                                   class_lengths=[0, 50, 250],
                                   minibatch_size=50),
                learning_rate=0.05, weights_decay=1e-4, fused=fused,
                decision_kwargs=dict(max_epochs=1), name="graph-attn")


@pytest.mark.parametrize("kind", ["attention", "block"])
def test_transformer_graph_mode_matches_jax(engine, kind):
    """tests/test_fused.py:209 and :255: the layer norm, self-attention
    and feed-forward GD units take their gradients from autograd of the
    forward (the JAX package's jax.vjp), every leaf decayed but the norm
    shifts; level 2."""
    engine(precision_level=2)
    jwf, twf = pair(JStandardWorkflow, StandardWorkflow, seeds=(11, 12),
                    **transformer_kwargs(kind, False))
    run_and_compare(jwf, twf, LEVEL2_ATOL)


@pytest.mark.parametrize("topology", ["mlp", "conv", "block"])
def test_graph_mode_matches_the_fused_tick(engine, topology):
    """Inside the port: graph mode and the fused tick from the same
    seeds give the same per-epoch n_err and weights within 1e-5 at level
    2 (the fused tick runs dense_layer and autograd of the whole loss,
    graph mode each unit's compute)."""
    engine(precision_level=2)
    if topology == "mlp":
        kwargs, cls = mlp_kwargs(), MLPWorkflow
    elif topology == "conv":
        x, y = _digits(images=True)
        kwargs = dict(
            layers=[{"type": "conv_tanh", "n_kernels": 8, "kx": 3, "ky": 3},
                    {"type": "max_pooling", "kx": 2, "ky": 2},
                    {"type": "softmax", "output_sample_shape": (10,)}],
            loader_kwargs=dict(data=x[:600], labels=y[:600],
                               class_lengths=[0, 100, 500],
                               minibatch_size=100,
                               normalization_type="linear"),
            learning_rate=0.05, decision_kwargs=dict(max_epochs=2))
        cls = StandardWorkflow
    else:
        kwargs = transformer_kwargs("block", None)
        kwargs.pop("fused")
        cls = StandardWorkflow
    # one after the other: the loader stream is global, and a workflow
    # draws each epoch's shuffle from it as it goes
    graph = _port(kwargs, False, cls=cls)
    gepochs = _record_epochs(graph)
    graph.run()
    fused = _port(kwargs, True, cls=cls)
    fepochs = _record_epochs(fused)
    fused.run()
    assert graph.fused_tick is None and fused.fused_tick is not None
    assert gepochs == fepochs
    assert graph.decision.best_n_err[VALID] == fused.decision.best_n_err[
        VALID]
    compare_leaves(fused, graph, LEVEL2_ATOL)
