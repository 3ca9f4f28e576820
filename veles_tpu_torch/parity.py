"""Accuracy-parity harness: a pass/fail artifact against the reference
anchors.

The port of ``veles_tpu/parity.py``. The reference publishes three MNIST
validation-error anchors (``docs/source/manualrst_veles_example.rst:
55-66``):

    MNIST784 (784→100 tanh→10 softmax)   1.92%  → bound 2.2%
    mnist "caffe" (LeNet-style convnet)   0.86%  → bound 1.0%
    mnist conv (tanh convnet)             0.73%  → bound 0.9%

``run_parity(mnist_dir=...)`` trains the three topologies with the
reference hyperparameters on real idx files and asserts those bounds.

Without MNIST the harness runs the same three topology families on the
UCI handwritten digits (1797 8x8 scans, ``data/digits.csv.gz``, the file
behind scikit-learn's ``load_digits``, committed with its provenance in
``data/DIGITS.md``), 1500 train / 297 validation, with the JAX package's
absolute bounds:

    digits784 MLP                         bound 3.0%
    digits "caffe" (relu convnet)         bound 0.7%
    digits conv (tanh convnet)            bound 0.7%

All three digits families train on NHWC data with the ``shift1``
augmentation (``ops/augment.py``). The port draws each sample's shift
from a counter hash where the JAX package draws it with threefry, and
its initial weights from its own generator, so the two packages train
the same families from different random draws under the same seeds.
Either way the outcome is written to ``PARITY.json`` in the JAX
package's form.

One command: ``python -m veles_tpu_torch parity [--mnist-dir DIR]
[--out F] [--device cuda|cpu]``.
"""

import gzip
import json
import os
import time

import numpy

from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.loader.base import VALID

#: (name, layer specs for 28x28x1 MNIST, trainer kwargs, bound %)
MNIST_TOPOLOGIES = (
    ("mnist784", [
        {"type": "all2all_tanh", "output_sample_shape": (100,)},
        {"type": "softmax", "output_sample_shape": (10,)},
    ], dict(learning_rate=0.03, gradient_moment=0.9, minibatch_size=100,
            max_epochs=50, fail_iterations=25, flat=True), 2.2),
    ("mnist_caffe", [
        {"type": "conv", "n_kernels": 20, "kx": 5, "ky": 5},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "conv", "n_kernels": 50, "kx": 5, "ky": 5},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "all2all_relu", "output_sample_shape": (500,)},
        {"type": "softmax", "output_sample_shape": (10,)},
    ], dict(learning_rate=0.01, gradient_moment=0.9, weights_decay=5e-4,
            minibatch_size=100, max_epochs=40, fail_iterations=20,
            flat=False), 1.0),
    ("mnist_conv", [
        {"type": "conv_tanh", "n_kernels": 32, "kx": 5, "ky": 5},
        {"type": "maxabs_pooling", "kx": 2, "ky": 2},
        {"type": "conv_tanh", "n_kernels": 64, "kx": 5, "ky": 5},
        {"type": "maxabs_pooling", "kx": 2, "ky": 2},
        {"type": "all2all_tanh", "output_sample_shape": (100,)},
        {"type": "softmax", "output_sample_shape": (10,)},
    ], dict(learning_rate=0.02, gradient_moment=0.9, minibatch_size=100,
            max_epochs=40, fail_iterations=20, flat=False), 0.9),
)

#: the same families on the 8x8 UCI digits (297 validation samples; 1
#: error = 0.337%); bounds are absolute
DIGITS_TOPOLOGIES = (
    ("digits784", [
        {"type": "all2all_tanh", "output_sample_shape": (100,)},
        {"type": "softmax", "output_sample_shape": (10,)},
    ], dict(learning_rate=0.03, gradient_moment=0.9, minibatch_size=100,
            max_epochs=170, fail_iterations=60, flat=False), 3.0),
    ("digits_caffe", [
        {"type": "conv", "n_kernels": 32, "kx": 3, "ky": 3},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "conv", "n_kernels": 64, "kx": 3, "ky": 3},
        {"type": "all2all_relu", "output_sample_shape": (128,)},
        {"type": "softmax", "output_sample_shape": (10,)},
    ], dict(learning_rate=0.01, gradient_moment=0.9, weights_decay=5e-4,
            minibatch_size=100, max_epochs=150, fail_iterations=60,
            flat=False), 0.7),
    ("digits_conv", [
        {"type": "conv_tanh", "n_kernels": 32, "kx": 3, "ky": 3},
        {"type": "maxabs_pooling", "kx": 2, "ky": 2},
        {"type": "conv_tanh", "n_kernels": 64, "kx": 3, "ky": 3},
        {"type": "all2all_tanh", "output_sample_shape": (128,)},
        {"type": "softmax", "output_sample_shape": (10,)},
    ], dict(learning_rate=0.02, gradient_moment=0.9, minibatch_size=100,
            max_epochs=220, fail_iterations=110, flat=False), 0.7),
)

#: the canonical digits split: the committed digits, RandomState(0)
#: permutation, [test=0, valid=297, train=1500]
DIGITS_CLASS_LENGTHS = [0, 297, 1500]

#: the committed copy of scikit-learn's digits.csv.gz (data/DIGITS.md)
DIGITS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "digits.csv.gz")


def read_digits():
    """``(pixels float64 (1797, 64), labels int64 (1797,))`` in the
    file's order: :data:`DIGITS_PATH` read as ``load_digits`` reads it
    (its ``data`` and ``target``)."""
    with gzip.open(DIGITS_PATH, "rt") as fin:
        table = numpy.loadtxt(fin, delimiter=",")
    return table[:, :-1], table[:, -1].astype(numpy.int64)


def digits_dataset(flat=True):
    """``(X float32 (1797, 64) or (1797, 8, 8, 1), y int32 (1797,))``:
    the digits of :func:`read_digits` in the RandomState(0)
    permutation."""
    pixels, labels = read_digits()
    X = pixels.astype(numpy.float32)
    y = labels.astype(numpy.int32)
    perm = numpy.random.RandomState(0).permutation(len(X))
    X, y = X[perm], y[perm]
    if not flat:
        X = X.reshape(-1, 8, 8, 1)
    return X, y


def build_workflow(name, layers, trainer, mnist_dir, device=None):
    """The StandardWorkflow of one topology, seeded and not initialized:
    the "default" stream seeded 1234 and the "loader" stream 5678, the
    digits (or MNIST's idx files) behind a linear normalizer, ``shift1``
    on the digits convnets' NHWC data."""
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.standard import StandardWorkflow

    trainer = dict(trainer)
    flat = trainer.pop("flat")
    minibatch_size = trainer.pop("minibatch_size")
    max_epochs = trainer.pop("max_epochs")
    fail_iterations = trainer.pop("fail_iterations")
    prng.get("default").seed(1234)
    prng.get("loader").seed(5678)
    if mnist_dir:
        from veles_tpu_torch.loader.mnist import MNISTLoader
        loader_cls = MNISTLoader
        loader_kwargs = dict(directory=mnist_dir, url_base=None,
                             flat=flat, minibatch_size=minibatch_size,
                             normalization_type="linear")
    else:
        from veles_tpu_torch.loader.fullbatch import FullBatchLoader
        X, y = digits_dataset(flat)
        loader_cls = FullBatchLoader
        loader_kwargs = dict(data=X, labels=y,
                             class_lengths=DIGITS_CLASS_LENGTHS,
                             minibatch_size=minibatch_size,
                             normalization_type="linear")
        if not flat:
            loader_kwargs["train_transform"] = "shift1"
    return StandardWorkflow(
        DummyLauncher(), layers=layers, loader_cls=loader_cls,
        loader_kwargs=loader_kwargs,
        decision_kwargs=dict(max_epochs=max_epochs,
                             fail_iterations=fail_iterations),
        name=name, device=device, **trainer)


def _train_one(name, layers, trainer, mnist_dir, log, device=None):
    """Train one topology; returns (val_error_pct, epochs, best_epoch)."""
    wf = build_workflow(name, layers, trainer, mnist_dir, device)
    wf.initialize()
    wf.run()
    decision = wf.decision
    n_valid = max(wf.loader.effective_class_lengths[VALID], 1)
    best = decision.best_n_err[VALID]
    error_pct = 100.0 * best / n_valid if best is not None else 100.0
    log.info("%s: best validation error %.2f%% (%s/%d) at epoch %d "
             "after %d epochs", name, error_pct, best, n_valid,
             decision.best_epoch, decision.epochs_done)
    return error_pct, decision.epochs_done, decision.best_epoch


def run_parity(mnist_dir=None, out="PARITY.json", topologies=None,
               device=None):
    """Train the parity set on ``device`` (None means the card) and write
    the verdict artifact. Returns the verdict dict; ``pass`` is the
    overall outcome."""
    from veles_tpu_torch.device import resolve_device
    device = resolve_device(device)  # no card: raise, write nothing
    log = Logger(logger_name="parity")
    if mnist_dir is None:
        mnist_dir = os.environ.get("VELES_TPU_MNIST_DIR") or None
    mode = "real-mnist" if mnist_dir else "real-digits-8x8"
    table = topologies or (MNIST_TOPOLOGIES if mnist_dir
                           else DIGITS_TOPOLOGIES)
    if not mnist_dir:
        log.warning("no MNIST directory (set VELES_TPU_MNIST_DIR or "
                    "pass --mnist-dir): running the real-data 8x8 "
                    "digits tier (UCI handwritten scans) with absolute "
                    "bounds")
    saved = (root.common.disable.get("plotting", False),
             root.common.disable.get("snapshotting", False))
    root.common.disable.plotting = True
    root.common.disable.snapshotting = True
    results = []
    try:
        for name, layers, trainer, bound in table:
            start = time.time()
            try:
                error_pct, epochs, best_epoch = _train_one(
                    name, layers, trainer, mnist_dir, log, device)
                entry = {"name": name,
                         "val_error_pct": round(error_pct, 3),
                         "bound_pct": bound, "pass": error_pct <= bound,
                         "epochs": epochs, "best_epoch": best_epoch}
            except Exception as exc:  # one failure must not hide the rest
                log.exception("%s failed", name)
                entry = {"name": name, "error": "%s: %s"
                         % (type(exc).__name__, exc), "pass": False,
                         "bound_pct": bound}
            entry["seconds"] = round(time.time() - start, 1)
            results.append(entry)
    finally:
        # callers (a pytest session, a notebook) keep their own plotting
        # and snapshotting behaviour after the harness returns
        root.common.disable.plotting, \
            root.common.disable.snapshotting = saved
    verdict = {
        "mode": mode,
        "anchors": "docs/source/manualrst_veles_example.rst:55-66 "
                   "(1.92% / 0.86% / 0.73%)",
        "results": results,
        "pass": all(r["pass"] for r in results),
    }
    if out:
        with open(out, "w") as fout:
            json.dump(verdict, fout, indent=1)
        log.info("parity verdict (%s): %s -> %s", mode,
                 "PASS" if verdict["pass"] else "FAIL", out)
    return verdict


def main(argv=None):
    """``python -m veles_tpu_torch parity`` entry."""
    import argparse
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch parity",
        description="train the reference parity topologies and write "
                    "a pass/fail PARITY.json")
    parser.add_argument("--mnist-dir", default=None,
                        help="directory with the 4 MNIST idx(.gz) files "
                             "(default: $VELES_TPU_MNIST_DIR, else the "
                             "8x8 digits families run)")
    parser.add_argument("--out", default="PARITY.json")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="where the families train (default: the "
                             "card; there is no CPU fallback)")
    args = parser.parse_args(argv)
    from veles_tpu_torch.core.logger import setup_logging
    setup_logging()
    verdict = run_parity(mnist_dir=args.mnist_dir, out=args.out,
                         device=args.device)
    print(json.dumps(verdict, indent=1))
    return 0 if verdict["pass"] else 1
