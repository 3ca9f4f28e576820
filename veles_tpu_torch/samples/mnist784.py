"""MNIST784: the reference accuracy-parity workflow.

Reproduces the znicz MNIST784 sample — 784 → 100 (scaled tanh) → 10
(softmax head), SGD, minibatch 100 — whose published anchor is 1.92%
validation error (reference ``docs/source/manualrst_veles_example.rst:55,62``).

Run:  python -m veles_tpu_torch veles_tpu_torch/samples/mnist784.py \
      samples/mnist784_config.py  [--device cpu]

The port's copy of ``samples/mnist784.py``; the repository's
``samples/mnist784_config.py`` configures it unchanged. Data: the 4
idx(.gz) files are read from ``root.mnist784.directory`` (default
``mnist`` under ``root.common.dirs.datasets``). Missing files are
fetched only from a ``root.mnist784.url_base`` the user sets (the
downloader: ``file://`` or ``http(s)://``); without one ``MNISTLoader``
raises, where the JAX package's sample defaults to a public mirror.
"""

from veles_tpu_torch.core.config import root
from veles_tpu_torch.loader.mnist import MNISTLoader
from veles_tpu_torch.models.mlp import MLPWorkflow

root.mnist784.update({
    "layers": [100, 10],
    "minibatch_size": 100,
    "learning_rate": 0.03,
    "gradient_moment": 0.9,
    "max_epochs": 50,
    "fail_iterations": 25,
    "directory": None,
    # None: the idx files must be in the directory. A url (file://,
    # http(s)://) fetches the missing ones through the downloader; the
    # port leaves the choice of host to the user (root.mnist784.url_base=URL)
    "url_base": None,
})


def run(load, main):
    cfg = root.mnist784
    load(MLPWorkflow,
         name="MNIST784",
         layers=tuple(cfg.layers),
         loader_cls=MNISTLoader,
         loader_kwargs=dict(
             directory=cfg.get("directory"),
             url_base=cfg.get("url_base"),
             minibatch_size=cfg.minibatch_size,
             normalization_type="linear"),
         learning_rate=cfg.learning_rate,
         gradient_moment=cfg.gradient_moment,
         max_epochs=cfg.max_epochs,
         fail_iterations=cfg.fail_iterations)
    main()
