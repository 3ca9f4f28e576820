"""The Kohonen SOM in the port (veles_tpu_torch/nn/kohonen.py,
models/kohonen.py): the contract of tests/test_som_alexnet.py:22-71 (the
quantization error falls, the best-matching units separate two clusters,
the workflow runs end to end) and the JAX package's SOM from the same
data and seeds: the same initial weights from the "kohonen" numpy
stream, the same winners at every step (bit for bit), the same epoch
count, and weights within 1e-5 (f32 on both sides; the distance product
and the neighbourhood sums differ in summation order only)."""

import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.models.kohonen import KohonenWorkflow as JKohonenWorkflow
from veles_tpu.nn.kohonen import KohonenTrainer as JKohonenTrainer
from veles_tpu_torch.convert import som_weights_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.models.kohonen import KohonenWorkflow
from veles_tpu_torch.nn.kohonen import KohonenForward, KohonenTrainer

torch.set_num_threads(1)

ATOL = 1e-5


def two_blobs(n=200, dim=6, seed=0):
    rng = numpy.random.RandomState(seed)
    a = rng.normal(-2.0, 0.3, (n // 2, dim))
    b = rng.normal(+2.0, 0.3, (n // 2, dim))
    x = numpy.concatenate([a, b]).astype(numpy.float32)
    labels = numpy.array([0] * (n // 2) + [1] * (n // 2))
    perm = rng.permutation(n)
    return x[perm], labels[perm]


def _trainer(x, seed=5):
    prng.get("kohonen").seed(seed)
    trainer = KohonenTrainer(DummyWorkflow(), shape=(4, 4),
                             learning_rate=0.5)
    trainer.input = torch.from_numpy(x)
    trainer.initialize()
    return trainer


def test_trainer_reduces_quantization_error():
    x, _ = two_blobs()
    trainer = _trainer(x)
    errors = []
    for _ in range(15):
        trainer.run()
        errors.append(float(trainer.quantization_error))
    assert errors[-1] < errors[0] * 0.5, errors
    assert trainer.steps == 15


def test_bmu_separates_clusters():
    x, labels = two_blobs()
    trainer = _trainer(x)
    for _ in range(20):
        trainer.run()
    fwd = KohonenForward(DummyWorkflow())
    fwd.input = torch.from_numpy(x)
    fwd.weights = trainer.weights.data
    fwd.run()
    winners = fwd.output.mem
    assert not (set(winners[labels == 0].tolist())
                & set(winners[labels == 1].tolist()))
    # the forward's winners are the trainer's best-matching units
    trainer.run()
    assert numpy.array_equal(trainer.winners.mem, winners)


def test_workflow_end_to_end():
    x, _ = two_blobs()
    wf = KohonenWorkflow(
        DummyLauncher(), shape=(4, 4), device="cpu",
        loader_kwargs=dict(data=x, class_lengths=[0, 0, len(x)],
                           minibatch_size=50),
        max_epochs=5, name="som")
    wf.initialize()
    wf.run()
    results = wf.gather_results()
    assert results["epochs"] == 5
    assert results["quantization_error"] < 1.0
    assert wf.trainer.steps == 5 * 4


def test_initial_weights_are_the_jax_packages():
    """The "kohonen" numpy stream is the JAX package's PCG64 stream:
    seeded alike, both trainers draw the same N(0, 0.1) weights, so no
    transfer is needed."""
    x, _ = two_blobs()
    jprng.get("kohonen").seed(5)
    jtrainer = JKohonenTrainer(JDummyWorkflow(), shape=(4, 4))
    jtrainer.input = x
    jtrainer.initialize()
    trainer = _trainer(x)
    assert numpy.array_equal(trainer.weights.mem,
                             numpy.asarray(jtrainer.weights.mem))


def _record_steps(trainer):
    """Each step's winners and quantization error, in order."""
    seen = []
    run = trainer.run

    def recorded():
        run()
        seen.append((numpy.asarray(trainer.winners.mem).copy(),
                     float(trainer.quantization_error)))

    trainer.run = recorded
    return seen


@pytest.mark.parametrize("carried", [False, True],
                         ids=["same-seed", "carried"])
def test_workflow_matches_jax(carried):
    """KohonenWorkflow against the JAX package's, (4, 4) grid, minibatch
    64 over 200 samples (a short last minibatch), 3 epochs: the same
    loader shuffles, equal winners at every step, quantization errors and
    weights within 1e-5. ``carried`` starts the port from the JAX
    workflow's weights (``convert.som_weights_from_jax``) instead of the
    seeded stream."""
    x, _ = two_blobs()
    kwargs = dict(shape=(4, 4),
                  loader_kwargs=dict(data=x, class_lengths=[0, 0, len(x)],
                                     minibatch_size=64),
                  max_epochs=3, name="som")
    jprng.get("kohonen").seed(5)
    jprng.get("loader").seed(6)
    jwf = JKohonenWorkflow(JDummyLauncher(), **kwargs)
    jwf.initialize()
    prng.get("kohonen").seed(99 if carried else 5)
    prng.get("loader").seed(6)
    twf = KohonenWorkflow(DummyLauncher(), device="cpu", **kwargs)
    if carried:
        som_weights_from_jax(twf, numpy.asarray(jwf.trainer.weights.mem))
    twf.initialize()
    assert numpy.array_equal(twf.trainer.weights.mem,
                             numpy.asarray(jwf.trainer.weights.mem))
    jsteps, tsteps = _record_steps(jwf.trainer), _record_steps(twf.trainer)
    jwf.run()
    twf.run()
    assert len(tsteps) == len(jsteps) == 3 * 4
    for (jwin, jerr), (twin, terr) in zip(jsteps, tsteps):
        assert numpy.array_equal(twin, jwin)
        assert abs(terr - jerr) <= ATOL * max(1.0, abs(jerr))
    assert twf.gather_results()["epochs"] == jwf.gather_results()["epochs"]
    numpy.testing.assert_allclose(twf.trainer.weights.mem,
                                  numpy.asarray(jwf.trainer.weights.mem),
                                  atol=ATOL, rtol=0)


def test_som_weights_from_jax_checks_the_grid():
    x, _ = two_blobs()
    twf = KohonenWorkflow(DummyLauncher(), shape=(4, 4), device="cpu",
                          loader_kwargs=dict(data=x, minibatch_size=50))
    with pytest.raises(ValueError):
        som_weights_from_jax(twf, numpy.zeros((15, 6), numpy.float32))
