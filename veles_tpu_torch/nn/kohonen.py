"""Kohonen self-organizing map units.

The port of ``veles_tpu/nn/kohonen.py:31-162`` (the Znicz SOM units). The
whole SOM step over a minibatch is one batch update: the squared
distances of every sample to every neuron (``||x||^2 - 2 x.w + ||w||^2``,
a product, not a (B, N, D) difference), each sample's best-matching unit
(the argmin, the first on a tie, as ``jnp.argmin``), the grid
neighbourhood ``exp(-d_grid^2 / (2 sigma^2))`` of each winner, and the
weights pulled toward the neighbourhood-weighted mean of the samples
(batch SOM, equal to the sample-at-a-time SOM in the small-rate limit).
The steps are plain torch ops on the workflow's device: the JAX package
runs XLA here, no TPU kernel.

- :class:`KohonenForward`: the winner index of each sample;
- :class:`KohonenTrainer`: one batch update a run, the learning rate and
  the neighbourhood radius decayed exponentially with the steps.

The initial weights are N(0, 0.1) from the ``"kohonen"`` stream's numpy
generator, which is the JAX package's PCG64 stream: seeded alike, both
packages start from the same weights.
"""

import numpy
import torch

from veles_tpu_torch.core import prng
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.jit_unit import JitUnit


def grid_coords(shape, device):
    """The (gy * gx, 2) float32 grid coordinates of the neurons, row by
    row."""
    gy, gx = shape
    ys, xs = torch.meshgrid(torch.arange(gy, device=device),
                            torch.arange(gx, device=device), indexing="ij")
    return torch.stack([ys.reshape(-1), xs.reshape(-1)], dim=1).float()


def best_matching_units(batch, weights):
    """The best-matching unit of each sample: the argmax of ``x.w -
    0.5 ||w||^2`` (the argmin of the squared distance; the ``||x||^2``
    term cannot move it)."""
    scores = batch @ weights.T - 0.5 * (weights * weights).sum(dim=1)
    return scores.argmax(dim=1)


def som_step(weights, batch, lr, sigma, coords):
    """One batch-SOM update: ``(new_weights, winners, quantization
    error)``; the error is the mean distance of the samples to their
    winners. ``lr`` and ``sigma`` are f32 scalars."""
    x = batch.reshape(batch.shape[0], -1)
    d2 = ((x * x).sum(dim=1)[:, None] - 2.0 * (x @ weights.T)
          + (weights * weights).sum(dim=1)[None, :]).clamp(min=0.0)
    winners = d2.argmin(dim=1)
    qerr = d2.min(dim=1).values.sqrt().mean()
    win_xy = coords[winners]                                    # (B, 2)
    grid_d2 = ((win_xy[:, None, :] - coords[None, :, :]) ** 2).sum(dim=2)
    h = torch.exp(-grid_d2 / (2.0 * sigma * sigma))            # (B, N)
    num = h.T @ x                                               # (N, D)
    den = h.sum(dim=0)[:, None]                                 # (N, 1)
    target = num / den.clamp(min=1e-8)
    moved = weights + lr * (target - weights)
    active = (den > 1e-8).float()
    return weights * (1 - active) + moved * active, winners, qerr


class KohonenForward(JitUnit):
    """Winner lookup: output[i] = the BMU index of sample i."""

    INPUTS = ("input", "weights")
    OUTPUTS = ("output",)

    def compute(self, batch, weights):
        return best_matching_units(batch.reshape(batch.shape[0], -1),
                                   weights)


class KohonenTrainer(Unit):
    """One batch-SOM update per run.

    Attributes: ``shape`` (gy, gx) neuron grid; ``weights`` (gy * gx, D);
    decayed ``sigma`` / ``learning_rate``; ``quantization_error``, the
    mean distance of the samples to their BMU (a device scalar), the
    SOM's convergence metric; ``winners``, the minibatch's BMUs.
    """

    VIEW_GROUP = "TRAINER"

    def __init__(self, workflow, **kwargs):
        self.shape = tuple(kwargs.pop("shape", (8, 8)))
        self.learning_rate = kwargs.pop("learning_rate", 0.5)
        self.sigma = kwargs.pop("sigma", max(self.shape) / 2.0)
        self.decay = kwargs.pop("decay", 0.05)
        self.prng_key = kwargs.pop("prng_key", "kohonen")
        super().__init__(workflow, **kwargs)
        self.weights = Array()
        self.winners = Array()
        self.quantization_error = None
        self.steps = 0
        self.demand("input")

    def init_unpickled(self):
        super().init_unpickled()
        self._coords_ = None

    @property
    def n_neurons(self):
        return self.shape[0] * self.shape[1]

    @property
    def device(self):
        return getattr(self.workflow, "device", None) or torch.device("cpu")

    def initialize(self, **kwargs):
        raw = self.input.data if isinstance(self.input, Array) \
            else self.input
        if raw is None:
            raise ValueError(
                "%s: linked input has no data at initialize time: "
                "initialize the loader first" % self.name)
        dim = int(numpy.prod(tuple(raw.shape[1:])))
        if self.weights.data is None:
            init = prng.get(self.prng_key).normal(
                0.0, 0.1, size=(self.n_neurons, dim))
            self.weights.reset(init.astype(numpy.float32))
            self.weights.to_device(self.device)

    def run(self):
        batch = self.input.data if isinstance(self.input, Array) \
            else self.input
        weights = self.weights.data
        if not isinstance(batch, torch.Tensor):
            batch = torch.as_tensor(numpy.asarray(batch, numpy.float32))
        batch = batch.to(weights.device)
        if self._coords_ is None or self._coords_.device != weights.device:
            self._coords_ = grid_coords(self.shape, weights.device)
        # the decayed rate and radius in f32, as the JAX package's
        decay = numpy.float32(numpy.exp(-self.decay * self.steps))
        lr = numpy.float32(self.learning_rate) * decay
        sigma = max(numpy.float32(self.sigma) * decay, numpy.float32(0.5))
        #: the step's decayed rate and radius (f32 scalars)
        self.last_rates = tuple(
            torch.tensor(v, dtype=torch.float32, device=weights.device)
            for v in (lr, sigma))
        with torch.no_grad():
            new_w, winners, qerr = som_step(weights, batch, *self.last_rates,
                                            self._coords_)
        self.weights.data = new_w
        self.winners.data = winners
        self.quantization_error = qerr  # a device scalar
        self.steps += 1

    # -- results --------------------------------------------------------------
    def get_metric_names(self):
        return ["quantization_error"]

    def get_metric_values(self):
        return [float(self.quantization_error)
                if self.quantization_error is not None else None]
