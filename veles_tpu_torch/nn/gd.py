"""Gradient-descent units: the backward chain and the optimizer state.

The port of ``veles_tpu/nn/gd.py`` (the Znicz GradientDescent family).
Each GD unit mirrors one forward unit, links its ``weights``/``bias``
slots, and owns the per-leaf velocities, the second moments and step
count of the stateful solvers, and ``_hyper``, the hyperparameter vector
read every step (so ``set_learning_rate`` anneals without rebuilding
anything). In graph mode and the lower fusion tiers a unit's own
:meth:`GradientDescent.compute` runs the layer's whole backward step
(``gd.py:207-228``): the activation derivative, the weight gradient
``x.T @ err`` and the error product ``err @ W.T`` through
``ops/gemm.matmul`` (K5 where the engine knobs and the gate allow), and
the update; the fused tick runs the same per-leaf math. The units whose
forward has no hand-written adjoint (conv, the blocks, the layer norm)
take their gradients from :func:`vjp`, autograd of the forward unit's
own function, where the JAX package calls ``jax.vjp``. The per-leaf
update is :func:`make_updater`, the JAX package's ``gd.py:44-74``:

    momentum: v ← μ·v − λ·g;  W ← W + v
    adagrad:  s ← s + g²;  W ← W − λ·g / (√s + ε)
    adam:     m ← β₁·m + (1−β₁)·g;  s ← β₂·s + (1−β₂)·g²;
              W ← W − λ·(m/(1−β₁ᵗ)) / (√(s/(1−β₂ᵗ)) + ε)

with ``g`` already regularized (``+ Λ₂·W + Λ₁·sign(W)`` where the leaf's
policy says so). The fleet payloads are a later slice.
"""

import torch

from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.jit_unit import JitUnit
from veles_tpu_torch.ops import activations
from veles_tpu_torch.ops.gemm import matmul

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


def vjp(fn, primals, cotangent):
    """The gradients of ``fn(*primals)`` against each primal, pulled back
    from ``cotangent`` (``jax.vjp``'s pullback): autograd of the forward,
    which it recomputes, under ``torch.enable_grad()``."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in primals]
        return torch.autograd.grad(fn(*leaves), leaves, cotangent)


class GradientDescent(JitUnit):
    """Backward unit for All2All (linear activation)."""

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
            # second moments and the shared step count as extra slots:
            # instance INPUTS/OUTPUTS extend the class tuples (compute and
            # the lower fusion tiers read self.INPUTS)
            self._second_slots_ = tuple(_second(velocity)
                                        for _, velocity in self.LEAVES)
            self._step = Array()
            extra = self._second_slots_ + ("_step",)
            base_in = type(self).INPUTS
            self.INPUTS = base_in[:-1] + extra + base_in[-1:]
            self.OUTPUTS = type(self).OUTPUTS + extra
        # linked from the paired forward unit:
        self.forward_unit = None
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
        self.forward_unit = forward_unit
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

    def _unpack_solver(self, rest, n_leaves=2):
        """Split a compute()'s trailing args into (updater, hyper,
        seconds, extra_outputs_fn): momentum's ``rest`` is ``(hyper,)``
        and its seconds are Nones; adam's and adagrad's is ``(*seconds,
        step, hyper)``, the step incremented here."""
        if self.solver != "momentum":
            *seconds, step, hyper = rest
            step = step + 1.0
            return (make_updater(self.solver, hyper, step), hyper,
                    tuple(seconds),
                    lambda new_seconds: tuple(new_seconds) + (step,))
        (hyper,) = rest
        return (make_updater("momentum", hyper, None), hyper,
                (None,) * n_leaves, lambda new_seconds: ())

    def compute(self, err_output, x, y, weights, bias, vel_w, vel_b,
                *rest):
        upd, hyper, (sec_w, sec_b), extras = self._unpack_solver(rest)
        lr, lr_b, l2, l1 = hyper[0], hyper[1], hyper[2], hyper[3]
        deriv = activations.ACTIVATIONS[self.ACTIVATION][1]
        n = err_output.shape[0]
        err_pre = err_output.reshape(n, -1) * deriv(y.reshape(n, -1))
        x2 = x.reshape(x.shape[0], -1)
        grad_w = matmul(x2.T, err_pre, out_dtype=torch.float32)
        grad_w = grad_w + l2 * weights + l1 * torch.sign(weights)
        err_input = matmul(err_pre, weights.T,
                           out_dtype=torch.float32).reshape(x.shape)
        grad_b = err_pre.sum(dim=0)
        new_w, new_vel_w, new_sec_w = upd(weights, grad_w, vel_w, sec_w,
                                          lr)
        new_b, new_vel_b, new_sec_b = upd(bias, grad_b, vel_b, sec_b,
                                          lr_b)
        return (err_input, new_w, new_b, new_vel_w, new_vel_b) \
            + extras((new_sec_w, new_sec_b))


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
    """Backward for All2AllSoftmax: the evaluator's error is already
    d(loss)/d(logits) (the softmax folded into the cross-entropy's
    gradient), so the activation derivative is the identity."""
    ACTIVATION = "linear"
