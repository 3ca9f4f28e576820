"""The port's in-tick augmentation (ops/augment.py) and the loader's
augmentation seeds (loader/base.py, loader/fullbatch.py) against the JAX
package on the CPU.

The JAX package draws each sample's flip or shift with threefry inside the
jitted tick; the port draws from an integer counter hash of (seed,
sample). The applies are held against ``mirror_batch`` and
``shift1_batch`` given JAX's own draws (computed here with
``jax.random``): exact. The loader's shuffles and seeds must be JAX's bit
for bit, and a two-epoch digits convnet with ``shift1`` (``parity.py``'s
``digits_conv`` topology), whose port draws are patched to JAX's, must
match the JAX package's run: per-epoch n_err equal, every weight within
2e-3 (the JAX package's own fused-vs-graph convnet bound, level 2).
"""

import jax
import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.models.standard import StandardWorkflow as JStandardWorkflow
from veles_tpu.ops import augment as jaugment
from veles_tpu.parity import DIGITS_TOPOLOGIES
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.ops import augment

from test_torch_conv import run_pair

torch.set_num_threads(1)


def jax_mirror_draw(seed, n):
    """``mirror_batch``'s flips (augment.py:13-22), as numpy."""
    return numpy.array(jax.random.bernoulli(jax.random.key(seed), 0.5,
                                            (n,)))


def jax_shift1_draw(seed, n):
    """``shift_batch``'s (dh, dw) at max_shift 1 (augment.py:25-40)."""
    kh, kw = jax.random.split(jax.random.key(seed))
    return tuple(numpy.array(jax.random.randint(k, (n,), -1, 2))
                 for k in (kh, kw))


def _batch(seed=0, shape=(16, 7, 9, 3)):
    return numpy.random.RandomState(seed).randn(*shape).astype(
        numpy.float32)


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 2])
def test_mirror_apply_matches_mirror_batch(seed):
    batch = _batch(seed % 7)
    want = numpy.asarray(jaugment.mirror_batch(batch, seed))
    flip = torch.from_numpy(jax_mirror_draw(seed, len(batch)))
    got = augment.mirror_apply(torch.from_numpy(batch), flip)
    numpy.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 2])
def test_shift_apply_matches_shift1_batch(seed):
    batch = _batch(seed % 5)
    want = numpy.asarray(jaugment.shift1_batch(batch, seed))
    dh, dw = (torch.from_numpy(d).long()
              for d in jax_shift1_draw(seed, len(batch)))
    got = augment.shift_apply(torch.from_numpy(batch), dh, dw)
    numpy.testing.assert_array_equal(got.numpy(), want)


def test_draws_are_a_hash_of_seed_and_sample():
    """A sample's draw depends on (seed, its index) alone: the first rows
    of a longer minibatch draw the same; both values of a flip and all
    nine shifts occur; another seed draws otherwise."""
    flips = augment.mirror_draw(7, 64, "cpu")
    assert torch.equal(augment.mirror_draw(7, 16, "cpu"), flips[:16])
    assert 0 < int(flips.sum()) < 64
    dh, dw = augment.shift1_draw(7, 256, "cpu")
    assert set((3 * dh + dw).tolist()) == set(range(-4, 5))
    assert not torch.equal(augment.mirror_draw(8, 64, "cpu"), flips)
    batch = torch.from_numpy(_batch())
    assert torch.equal(augment.TRANSFORMS["shift1"](batch, 3),
                       augment.shift_apply(
                           batch, *augment.shift1_draw(3, 16, "cpu")))


def _digits_conv(epochs, transform="shift1", sweep=True):
    from veles_tpu.parity import digits_dataset
    x, y = digits_dataset(flat=False)
    _, layers, trainer, _ = [t for t in DIGITS_TOPOLOGIES
                             if t[0] == "digits_conv"][0]
    trainer = dict(trainer)
    minibatch = trainer.pop("minibatch_size")
    for key in ("max_epochs", "fail_iterations", "flat"):
        trainer.pop(key)
    return dict(layers=layers,
                loader_kwargs=dict(data=x, labels=y,
                                   class_lengths=[0, 297, 1500],
                                   minibatch_size=minibatch,
                                   normalization_type="linear",
                                   train_transform=transform),
                decision_kwargs=dict(max_epochs=epochs),
                fused_sweep=sweep, name="digits_conv", **trainer)


@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "minibatch"])
def test_loader_shuffles_and_seeds_match_jax(sweep):
    """Two epochs of serving with ``train_transform``: the served indices
    and each TRAIN minibatch's augmentation seed equal JAX's (the seeds
    are drawn from the loader stream between the shuffles)."""
    kwargs = _digits_conv(2, sweep=sweep)
    jprng.get("loader").seed(31)
    jwf = JStandardWorkflow(JDummyLauncher(), **kwargs)
    jwf.loader.initialize()
    prng.get("loader").seed(31)
    twf = StandardWorkflow(DummyLauncher(), device="cpu", **kwargs)
    twf.loader.initialize()
    assert twf.loader.jit_transform == "shift1"
    assert twf.loader.has_fill_transforms
    for loader in (jwf.loader, twf.loader):
        loader.fill_data = False
        loader.sweep_serving = sweep
    seeds = 0
    for _ in range(4 if sweep else 2 * (3 + 15)):
        jwf.loader.run()
        twf.loader.run()
        assert twf.loader.minibatch_class == jwf.loader.minibatch_class
        numpy.testing.assert_array_equal(
            twf.loader.minibatch_indices.data,
            numpy.asarray(jwf.loader.minibatch_indices.data))
        if sweep:
            want = jwf.loader.sweep_transform_seeds
            got = twf.loader.sweep_transform_seeds
            assert (got is None) == (want is None)
            if want is not None:
                numpy.testing.assert_array_equal(got, want)
                seeds += len(want)
        else:
            assert twf.loader.minibatch_transform_seed \
                == jwf.loader.minibatch_transform_seed
            seeds += twf.loader.minibatch_class == TRAIN
    assert seeds == 2 * 15


def test_digits_conv_with_shift1_matches_jax(monkeypatch):
    """``digits_conv`` (conv_tanh 32, maxabs 2x2, conv_tanh 64, tanh 128,
    softmax) with ``shift1`` on the 8 x 8 digits, 2 epochs at level 2,
    the port's draw patched to return JAX's for each seed."""
    for cfg in (jroot, root):
        monkeypatch.setattr(cfg.common.engine, "precision_level", 2,
                            raising=False)
    seen = []

    def draw(seed, n, device):
        seen.append(seed)
        return tuple(torch.from_numpy(d).long().to(device)
                     for d in jax_shift1_draw(seed, n))

    monkeypatch.setattr(augment, "shift1_draw", draw)
    kwargs = _digits_conv(2)

    def build_jax():
        jprng.get("default").seed(1234)
        jprng.get("loader").seed(5678)
        return JStandardWorkflow(JDummyLauncher(), **kwargs)

    def build_port():
        prng.get("loader").seed(5678)
        return StandardWorkflow(DummyLauncher(), device="cpu", **kwargs)

    twf = run_pair(build_jax, build_port)
    assert len(seen) == 2 * 15 and len(set(seen)) == len(seen)
    assert [s["kind"] for s in twf.fused_tick._specs_] == [
        "conv", "maxabs", "conv", "dense", "dense"]
