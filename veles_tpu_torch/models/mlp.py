"""Fully-connected classifier workflows (the Znicz MNIST784 family).

The port of ``veles_tpu/models/mlp.py``. Reference MNIST784:
784→100(tanh)→10(softmax), SGD; the repo's wide MLP (``bench.py:306``,
``:508``) is 784→4096(tanh)→10(softmax) at minibatch 4096, where every
hidden-layer product is large enough for the hand-written GEMM kernels.
"""

from veles_tpu_torch.models.standard import StandardWorkflow


class MLPWorkflow(StandardWorkflow):
    """An N-layer tanh MLP with a softmax head (reference MNIST784 when
    ``layers=[100, 10]`` over 784-feature input)."""

    def __init__(self, workflow, layers=(100, 10), loader_kwargs=None,
                 learning_rate=0.03, weights_decay=0.0, gradient_moment=0.0,
                 max_epochs=None, fail_iterations=50, loader_cls=None,
                 **kwargs):
        specs = [{"type": "all2all_tanh", "output_sample_shape": (w,)}
                 for w in layers[:-1]]
        specs.append({"type": "softmax",
                      "output_sample_shape": (layers[-1],)})
        decision_kwargs = dict(kwargs.pop("decision_kwargs", None) or {})
        decision_kwargs.setdefault("max_epochs", max_epochs)
        decision_kwargs.setdefault("fail_iterations", fail_iterations)
        super().__init__(
            workflow, layers=specs, loader_kwargs=loader_kwargs,
            loader_cls=loader_cls, learning_rate=learning_rate, weights_decay=weights_decay,
            gradient_moment=gradient_moment,
            decision_kwargs=decision_kwargs, **kwargs)
