"""Convolutional MNIST: the reference's mnist_conv / mnist_caffe parity
workflows.

The reference ships two convolutional MNIST configurations whose
published anchors are 0.73% (conv) and 0.86% (caffe) validation error
(``docs/source/manualrst_veles_example.rst:56-57,84-90`` — the snapshot
names encode the results). The layer configs themselves live in the
znicz submodule, absent from the reference snapshot, so:

- ``caffe`` here is the LeNet definition that config name refers to
  (caffe's ``lenet_train``): conv20 5x5 -> pool2 -> conv50 5x5 -> pool2
  -> 500 ReLU -> softmax 10, VALID padding;
- ``conv`` is the deeper tanh variant: conv-tanh 64 5x5 -> pool2 ->
  conv-tanh 87 5x5 -> pool2 -> 100 tanh -> softmax 10, SAME padding.

Run:  python -m veles_tpu_torch veles_tpu_torch/samples/mnist_conv.py \
      samples/mnist_conv_config.py  [--device cpu]
Pick the topology with ``root.mnist_conv.topology=caffe`` (or ``conv``).

Both fuse into the fused tick (conv and pooling layers are fusible).
The port's copy of ``samples/mnist_conv.py``; the repository's config
file configures it unchanged. The idx files are read from
``root.mnist_conv.directory``; missing ones are fetched only from a
``root.mnist_conv.url_base`` the user sets (the downloader), and without
one ``MNISTLoader`` raises.
"""

from veles_tpu_torch.core.config import root
from veles_tpu_torch.loader.mnist import MNISTLoader
from veles_tpu_torch.models.standard import StandardWorkflow

TOPOLOGIES = {
    "conv": [
        {"type": "conv_tanh", "n_kernels": 64, "kx": 5, "ky": 5,
         "padding": "SAME"},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "conv_tanh", "n_kernels": 87, "kx": 5, "ky": 5,
         "padding": "SAME"},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "all2all_tanh", "output_sample_shape": (100,)},
        {"type": "softmax", "output_sample_shape": (10,)},
    ],
    "caffe": [
        {"type": "conv", "n_kernels": 20, "kx": 5, "ky": 5,
         "padding": "VALID"},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "conv", "n_kernels": 50, "kx": 5, "ky": 5,
         "padding": "VALID"},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "all2all_strict_relu", "output_sample_shape": (500,)},
        {"type": "softmax", "output_sample_shape": (10,)},
    ],
}

root.mnist_conv.update({
    "topology": "conv",
    "minibatch_size": 100,
    "learning_rate": 0.03,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "max_epochs": 50,
    "fail_iterations": 25,
    "directory": None,
    # None: the idx files must be in the directory. A url (file://,
    # http(s)://) fetches the missing ones through the downloader; the
    # port leaves the choice of host to the user (root.mnist_conv.url_base=URL)
    "url_base": None,
})


def run(load, main):
    cfg = root.mnist_conv
    load(StandardWorkflow,
         name="MNISTConv-%s" % cfg.topology,
         layers=TOPOLOGIES[cfg.topology],
         loader_cls=MNISTLoader,
         loader_kwargs=dict(
             directory=cfg.get("directory"),
             url_base=cfg.get("url_base"),
             minibatch_size=cfg.minibatch_size,
             normalization_type="linear",
             flat=False),
         learning_rate=cfg.learning_rate,
         gradient_moment=cfg.gradient_moment,
         weights_decay=cfg.weights_decay,
         decision_kwargs=dict(max_epochs=cfg.max_epochs,
                              fail_iterations=cfg.fail_iterations))
    main()
