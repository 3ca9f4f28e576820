"""Gradient-descent units: the owners of the optimizer state.

The port of ``veles_tpu/nn/gd.py`` as the fused tick uses it. Each GD unit
mirrors one forward unit, links its ``weights``/``bias`` slots, and owns
the per-leaf velocities, the second moments and step count of the
stateful solvers, and ``_hyper``, the hyperparameter vector the tick
reads every step (so ``set_learning_rate`` anneals without rebuilding
anything). The per-leaf update is :func:`make_updater`, the JAX package's
``gd.py:44-74``:

    momentum: v ← μ·v − λ·g;  W ← W + v
    adagrad:  s ← s + g²;  W ← W − λ·g / (√s + ε)
    adam:     m ← β₁·m + (1−β₁)·g;  s ← β₂·s + (1−β₂)·g²;
              W ← W − λ·(m/(1−β₁ᵗ)) / (√(s/(1−β₂ᵗ)) + ε)

with ``g`` already regularized (``+ Λ₂·W + Λ₁·sign(W)`` where the leaf's
policy says so). The units' own backward (graph mode) and the fleet
payloads are later slices.
"""

import torch

from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.jit_unit import JitUnit

SOLVERS = ("momentum", "adam", "adagrad")


def make_updater(solver, hyper, step):
    """The per-leaf update: ``upd(w, grad, vel, second, rate) -> (new_w,
    new_vel, new_second)``. ``hyper`` is the 8-vector of ``_hyper``;
    ``step`` the ALREADY incremented step count (1-based) for Adam's
    bias correction."""
    if solver == "momentum":
        moment = hyper[4]

        def upd(w, grad, vel, second, rate):
            v2 = moment * vel - rate * grad
            return w + v2, v2, second
        return upd
    if solver == "adagrad":
        eps = hyper[7]

        def upd(w, grad, vel, second, rate):
            s = second + grad * grad
            return w - rate * grad / (torch.sqrt(s) + eps), vel, s
        return upd
    beta1, beta2, eps = hyper[5], hyper[6], hyper[7]

    def upd(w, grad, vel, second, rate):
        m = beta1 * vel + (1.0 - beta1) * grad
        s = beta2 * second + (1.0 - beta2) * grad * grad
        m_hat = m / (1.0 - beta1 ** step)
        s_hat = s / (1.0 - beta2 ** step)
        return w - rate * m_hat / (torch.sqrt(s_hat) + eps), m, s
    return upd


class GradientDescent(JitUnit):
    """Optimizer-state owner paired with an All2All (linear activation)."""

    ACTIVATION = "linear"
    VIEW_GROUP = "TRAINER"
    #: (parameter slot, velocity slot) of every leaf the unit updates;
    #: the stateful solvers' second moments sit in ``_second_*`` beside
    #: each velocity
    LEAVES = (("weights", "_velocity_w"), ("bias", "_velocity_b"))

    INPUTS = ("err_output", "input", "output", "weights", "bias",
              "_velocity_w", "_velocity_b", "_hyper")
    OUTPUTS = ("err_input", "weights", "bias", "_velocity_w", "_velocity_b")

    def __init__(self, workflow, **kwargs):
        self.learning_rate = kwargs.pop("learning_rate", 0.01)
        self.learning_rate_bias = kwargs.pop("learning_rate_bias", None)
        self.weights_decay = kwargs.pop("weights_decay", 0.0)
        self.l1_vs_l2 = kwargs.pop("l1_vs_l2", 0.0)
        self.gradient_moment = kwargs.pop("gradient_moment", 0.0)
        self.include_bias = kwargs.pop("include_bias", True)
        self.solver = kwargs.pop("solver", "momentum")
        if self.solver not in SOLVERS:
            raise ValueError("unknown solver %r (use %s)"
                             % (self.solver, "/".join(SOLVERS)))
        self.adam_beta1 = kwargs.pop("adam_beta1", 0.9)
        self.adam_beta2 = kwargs.pop("adam_beta2", 0.999)
        self.adam_epsilon = kwargs.pop("adam_epsilon", 1e-8)
        super().__init__(workflow, **kwargs)
        if self.solver != "momentum":
            self._step = Array()
        # linked from the paired forward unit:
        self.input = None
        self.output = None
        for param, velocity in self.LEAVES:
            setattr(self, param, None)
            setattr(self, velocity, Array())
            if self.solver != "momentum":
                setattr(self, _second(velocity), Array())
        # linked from the next unit up (evaluator or deeper GD):
        self.err_output = None
        self.demand("err_output", "input", "output", "weights", "bias")
        self._hyper = Array()

    def link_forward(self, forward_unit, err_source):
        """Wire this GD unit to its forward twin (input, output and every
        leaf of :attr:`LEAVES`) + the error source."""
        self.link_attrs(forward_unit, "input", "output",
                        *(param for param, _ in self.LEAVES))
        link_err_output(self, err_source)
        return self

    def initialize(self, **kwargs):
        if self.weights is None or self.weights.data is None:
            return True
        for param, velocity in self.LEAVES:
            slots = [velocity]
            if self.solver != "momentum":
                slots.append(_second(velocity))
            for name in slots:
                slot = getattr(self, name)
                if slot.data is None:
                    slot.data = torch.zeros_like(getattr(self, param).data)
        if self.solver != "momentum":
            if self._step.data is None:
                self._step.data = torch.zeros(
                    (), device=self.weights.data.device)
        self._refresh_hyper()

    def _refresh_hyper(self):
        lr_bias = (self.learning_rate_bias
                   if self.learning_rate_bias is not None
                   else self.learning_rate)
        self._hyper.data = torch.tensor(
            [self.learning_rate, lr_bias, self.weights_decay,
             self.l1_vs_l2, self.gradient_moment, self.adam_beta1,
             self.adam_beta2, self.adam_epsilon], dtype=torch.float32,
            device=self.weights.data.device)

    def set_learning_rate(self, value):
        """Anneal: the tick reads the refreshed ``_hyper`` next step."""
        self.learning_rate = value
        self._refresh_hyper()

    def scale_learning_rate(self, factor):
        """Multiply BOTH rates (weights and bias) — the plateau-decay
        entry point."""
        self.learning_rate *= factor
        if self.learning_rate_bias is not None:
            self.learning_rate_bias *= factor
        self._refresh_hyper()


def _second(velocity):
    """The second-moment slot beside a velocity slot."""
    return velocity.replace("_velocity", "_second")


def link_err_output(gd_unit, err_source):
    """Wire ``gd_unit.err_output`` to the upstream error: a backward unit
    exposes ``err_input``, an evaluator exposes ``err_output``."""
    if hasattr(err_source, "err_input"):
        gd_unit.link_attrs(err_source, ("err_output", "err_input"))
    else:
        gd_unit.link_attrs(err_source, "err_output")
    return gd_unit


class GDTanh(GradientDescent):
    ACTIVATION = "tanh"


class GDRELU(GradientDescent):
    ACTIVATION = "relu"


class GDStrictRELU(GradientDescent):
    ACTIVATION = "strict_relu"


class GDSigmoid(GradientDescent):
    ACTIVATION = "sigmoid"


class GDSoftmax(GradientDescent):
    """Paired with All2AllSoftmax: the evaluator's error is already
    d(loss)/d(logits)."""
    ACTIVATION = "linear"
