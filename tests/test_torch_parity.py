"""The port's accuracy-parity harness (veles_tpu_torch/parity.py) and its
committed digits data against the JAX package and scikit-learn on the
CPU.

- ``data/digits.csv.gz`` read by ``parity.digits_dataset`` (gzip and
  numpy, no scikit-learn) equals ``sklearn.datasets.load_digits()`` bit
  for bit, and the canonical split (the RandomState(0) permutation,
  [0, 297, 1500]) equals the JAX package's, pinned by its SHA-256;
- the three digits families for two epochs, each from the JAX package's
  initial weights (``convert.unit_params_from_jax``) with the JAX
  package's ``shift1`` draws patched into the port (the two packages draw
  them from different generators): per-epoch n_err equal, every weight
  and bias within the stated tolerance. Level 2 (f32) for all three, and
  digits784 at level 0 (bf16 operands, the harness's own level) too; the
  convnets at level 0 round their conv outputs through bf16 in another
  order than XLA's CPU convolution and part by one validation error in
  the first two epochs, so they are held at level 2 only;
- ``PARITY.json``'s form, exit 1 on a miss, and the ``parity``
  subcommand, on short tables."""

import hashlib
import json

import numpy
import pytest
import torch

from veles_tpu import parity as jparity
from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.models.standard import StandardWorkflow as JStandardWorkflow
from veles_tpu_torch import parity
from veles_tpu_torch.__main__ import main as cli_main
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core.config import root
from veles_tpu_torch.ops import augment

from test_torch_augment import jax_shift1_draw
from test_torch_conv import _record_epochs, carry_weights

torch.set_num_threads(1)

#: SHA-256 of the canonical split's arrays (float32 pixels (1797, 64),
#: int32 labels), as scikit-learn's load_digits gives them
X_SHA256 = "b2b3b36b3126b74f5094139fa9c0003e55d3d445c07baad388e96d594dfb658d"
Y_SHA256 = "145cd6a20c97931d1ca61b3a4ccd37c02bbc5f3516cf28e86802301870144436"
#: two epochs from the same weights: f32 differs by summation order only;
#: bf16 operands move a weight by a bf16 step where a sum lands on the
#: other side of a rounding boundary (tests/test_torch_training.py); the
#: convnets' bound is the JAX package's own fused-vs-graph convnet bound
ATOL = {("digits784", 2): 1e-5, ("digits784", 0): 1e-3,
        ("digits_caffe", 2): 2e-3, ("digits_conv", 2): 2e-3}


def test_committed_digits_equal_sklearns():
    from sklearn.datasets import load_digits
    digits = load_digits()
    pixels, labels = parity.read_digits()
    assert pixels.dtype == digits.data.dtype
    numpy.testing.assert_array_equal(pixels, digits.data)
    numpy.testing.assert_array_equal(labels, digits.target)
    numpy.testing.assert_array_equal(pixels.reshape(-1, 8, 8),
                                     digits.images)


@pytest.mark.parametrize("flat", [True, False])
def test_canonical_split_equals_jaxs(flat):
    x, y = parity.digits_dataset(flat)
    jx, jy = jparity.digits_dataset(flat)
    assert x.dtype == jx.dtype == numpy.float32
    assert y.dtype == jy.dtype == numpy.int32
    assert x.shape == ((1797, 64) if flat else (1797, 8, 8, 1))
    numpy.testing.assert_array_equal(x, jx)
    numpy.testing.assert_array_equal(y, jy)
    assert hashlib.sha256(x.tobytes()).hexdigest() == X_SHA256
    assert hashlib.sha256(y.tobytes()).hexdigest() == Y_SHA256
    assert sum(parity.DIGITS_CLASS_LENGTHS) == len(x)


def test_topologies_are_jaxs():
    assert parity.DIGITS_CLASS_LENGTHS == jparity.DIGITS_CLASS_LENGTHS
    assert parity.DIGITS_TOPOLOGIES == jparity.DIGITS_TOPOLOGIES
    assert parity.MNIST_TOPOLOGIES == jparity.MNIST_TOPOLOGIES


def _jax_workflow(name, layers, trainer):
    """The JAX harness's workflow (``parity.py:123-161``), not run."""
    trainer = dict(trainer)
    flat = trainer.pop("flat")
    minibatch_size = trainer.pop("minibatch_size")
    max_epochs = trainer.pop("max_epochs")
    fail_iterations = trainer.pop("fail_iterations")
    jprng.get("default").seed(1234)
    jprng.get("loader").seed(5678)
    x, y = jparity.digits_dataset(flat)
    loader_kwargs = dict(data=x, labels=y,
                         class_lengths=jparity.DIGITS_CLASS_LENGTHS,
                         minibatch_size=minibatch_size,
                         normalization_type="linear")
    if not flat:
        loader_kwargs["train_transform"] = "shift1"
    return JStandardWorkflow(
        JDummyLauncher(), layers=layers, loader_kwargs=loader_kwargs,
        decision_kwargs=dict(max_epochs=max_epochs,
                             fail_iterations=fail_iterations),
        name=name, **trainer)


def equal_draws_run(name, level, epochs=None):
    """One digits family in both packages from the JAX package's initial
    weights, JAX's ``shift1`` draws patched into the port, at precision
    ``level`` for ``epochs`` (None: the family's own max_epochs and
    fail_iterations). Returns both workflows, run, and their per-epoch
    (test, valid, train) n_err."""
    for cfg in (jroot, root):
        cfg.common.engine.precision_level = level
    real_draw = augment.shift1_draw
    augment.shift1_draw = lambda seed, n, device: tuple(
        torch.from_numpy(d).long().to(device)
        for d in jax_shift1_draw(seed, n))
    try:
        _, layers, trainer, _ = [t for t in jparity.DIGITS_TOPOLOGIES
                                 if t[0] == name][0]
        if epochs is not None:
            trainer = dict(trainer, max_epochs=epochs)
        jwf = _jax_workflow(name, layers, trainer)
        jwf.initialize()
        twf = parity.build_workflow(name, layers, trainer, None,
                                    device="cpu")
        unit_params_from_jax(twf, carry_weights(jwf))
        twf.initialize()
        jepochs, tepochs = _record_epochs(jwf), _record_epochs(twf)
        jwf.run()
        twf.run()
    finally:
        augment.shift1_draw = real_draw
    return jwf, twf, jepochs, tepochs


@pytest.mark.parametrize("name,level", sorted(ATOL))
def test_family_two_epochs_matches_jax(monkeypatch, name, level):
    for cfg in (jroot, root):
        monkeypatch.setattr(cfg.common.engine, "precision_level", level,
                            raising=False)
    jwf, twf, jepochs, tepochs = equal_draws_run(name, level, epochs=2)
    assert len(tepochs) == 2 and tepochs == jepochs
    assert twf.decision.best_n_err == jwf.decision.best_n_err
    leaves = 0
    for jf, tf in zip(jwf.forwards, twf.forwards):
        if getattr(jf, "weights", None) is None:
            continue
        for key in ("weights", "bias"):
            numpy.testing.assert_allclose(
                getattr(tf, key).data.numpy(),
                numpy.asarray(getattr(jf, key).data),
                atol=ATOL[name, level], rtol=0)
            leaves += 1
    layers = [t[1] for t in jparity.DIGITS_TOPOLOGIES if t[0] == name][0]
    assert leaves == 2 * sum("pooling" not in spec["type"]
                             for spec in layers)


def _short_table(bound=3.0):
    """digits784 for one epoch under ``bound``."""
    name, layers, trainer, _ = jparity.DIGITS_TOPOLOGIES[0]
    return ((name, layers, dict(trainer, max_epochs=1), bound),)


def test_parity_json_has_the_jax_form(tmp_path, monkeypatch):
    """The verdict and the file carry the JAX package's keys, in the same
    mode and with the same anchors; plotting and snapshotting are
    restored after the run."""
    table = _short_table(100.0)
    for cfg in (jroot, root):
        monkeypatch.setattr(cfg.common.disable, "plotting", False,
                            raising=False)
    want = jparity.run_parity(out=str(tmp_path / "jax.json"),
                              topologies=table)
    got = parity.run_parity(out=str(tmp_path / "port.json"),
                            topologies=table, device="cpu")
    assert root.common.disable.plotting is False
    assert json.load(open(tmp_path / "port.json")) == got
    assert set(got) == set(want)
    assert (got["mode"], got["anchors"], got["pass"]) \
        == (want["mode"], want["anchors"], want["pass"]) \
        == ("real-digits-8x8", want["anchors"], True)
    assert [set(r) for r in got["results"]] \
        == [set(r) for r in want["results"]]
    entry = got["results"][0]
    assert (entry["name"], entry["epochs"], entry["bound_pct"]) \
        == ("digits784", 1, 100.0)
    assert 0.0 <= entry["val_error_pct"] <= 100.0


def test_a_miss_fails_the_verdict(tmp_path, monkeypatch):
    """A family over its bound fails the verdict and the subcommand
    exits 1; within it exits 0. The subcommand writes ``--out``."""
    out = str(tmp_path / "PARITY.json")
    monkeypatch.setattr(parity, "DIGITS_TOPOLOGIES", _short_table(0.0))
    assert cli_main(["parity", "--device", "cpu", "--out", out]) == 1
    verdict = json.load(open(out))
    assert verdict["pass"] is False
    assert verdict["results"][0]["pass"] is False
    monkeypatch.setattr(parity, "DIGITS_TOPOLOGIES", _short_table(100.0))
    assert cli_main(["parity", "--device", "cpu", "--out", out]) == 0
    assert json.load(open(out))["pass"] is True


def test_a_failing_family_is_reported_not_hidden(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise ValueError("broken family")

    monkeypatch.setattr(parity, "_train_one", broken)
    verdict = parity.run_parity(out=None, topologies=_short_table(),
                                device="cpu")
    assert verdict["pass"] is False
    assert verdict["results"][0]["error"] == "ValueError: broken family"


def test_parity_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "PARITY.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.run_parity(out=str(out), topologies=_short_table())
    assert not out.exists()


def test_the_subcommand_is_ported():
    from veles_tpu_torch.__main__ import COMMANDS, DEFERRED_COMMANDS
    assert {"parity", "autotune"} <= set(COMMANDS)
    assert not {"parity", "autotune"} & set(DEFERRED_COMMANDS)


def test_the_harness_seeds_the_loader_stream():
    """The harness seeds the loader stream itself: two builds of one
    family draw the same minibatch shift seeds, whatever drew before."""
    name, layers, trainer, _ = jparity.DIGITS_TOPOLOGIES[2]
    seeds = []
    for _ in range(2):
        wf = parity.build_workflow(name, layers, trainer, None,
                                   device="cpu")
        wf.loader.initialize()
        seeds.append(wf.loader.draw_transform_seeds(4).tolist())
    assert seeds[0] == seeds[1]


def main(argv=None):
    """``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_parity.py
    [family] [level]``: the equal-draws run of one digits family (default
    digits784 at level 0) for all its epochs, as one JSON line: both
    packages' best n_err, best epoch and epochs, and the first epoch
    whose (test, valid, train) n_err differ (None: none)."""
    import sys
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "digits784"
    level = int(argv[1]) if len(argv) > 1 else 0
    torch.set_num_threads(2)
    jwf, twf, jepochs, tepochs = equal_draws_run(name, level)
    first = next((i for i, (a, b) in enumerate(zip(jepochs, tepochs))
                  if a != b), None)
    print(json.dumps({
        "name": name, "level": level,
        "jax": [jwf.decision.best_n_err[1], jwf.decision.best_epoch,
                jwf.decision.epochs_done],
        "port": [twf.decision.best_n_err[1], twf.decision.best_epoch,
                 twf.decision.epochs_done],
        "first_differing_epoch": first}))


if __name__ == "__main__":
    main()
