"""Minibatch gather from a device-resident full-batch dataset.

The port of ``veles_tpu/ops/gather.py`` (reference
``cuda/fullbatch_loader.cu``): the dataset stays on the device and a
minibatch is ``index_select`` along axis 0. Unlike ``jnp.take``, which
clamps, ``index_select`` raises on an index out of range, so the loader
pads short index blocks with an index that exists (0).
"""


def gather_minibatch(data, indices, labels=None):
    """Gather ``data[indices]`` (+ ``labels[indices]``); ``indices`` is an
    int64 tensor on the data's device."""
    batch = data.index_select(0, indices)
    if labels is None:
        return batch
    return batch, labels.index_select(0, indices)
