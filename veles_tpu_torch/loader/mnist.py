"""MNIST loader: the idx-format pipeline behind the MNIST784 workflow.

The port of ``veles_tpu/loader/mnist.py``. It parses the LeCun idx1
(labels) and idx3 (images) files, gzipped or raw, into a device-resident
FullBatchLoader with the reference's split: the 10k test set serves as
VALIDATION and the 60k train set as TRAIN (class lengths [0, 10000,
60000]). ``flat=True`` serves (N, 784) rows, ``flat=False`` (N, 28, 28, 1)
NHWC.

The port reads files from ``directory`` only (default: ``mnist`` under
``root.common.dirs.datasets`` where that is set): fetching them from
``url_base`` is the downloader's, a later slice of the port, and a
loader whose files are missing raises.
"""

import gzip
import os
import struct

import numpy

from veles_tpu_torch.core.config import root
from veles_tpu_torch.loader.base import register_loader
from veles_tpu_torch.loader.fullbatch import FullBatchLoader

FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}

#: idx payloads are big-endian
IDX_DTYPES = {0x08: ">u1", 0x09: ">i1", 0x0B: ">i2",
              0x0C: ">i4", 0x0D: ">f4", 0x0E: ">f8"}


def read_idx(path):
    """Parse one idx file (``.gz`` accepted) into a numpy array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fin:
        zero, dtype_code, ndim = struct.unpack(">HBB", fin.read(4))
        if zero != 0 or dtype_code not in IDX_DTYPES:
            raise ValueError("%s: not an idx file" % path)
        shape = struct.unpack(">" + "I" * ndim, fin.read(4 * ndim))
        data = numpy.frombuffer(fin.read(), IDX_DTYPES[dtype_code])
    return data.reshape(shape).astype(data.dtype.newbyteorder("="))


@register_loader("mnist")
class MNISTLoader(FullBatchLoader):
    """MNIST via idx files (the MNIST784 data pipeline)."""

    def __init__(self, workflow, directory=None, url_base=None, flat=True,
                 **kwargs):
        kwargs.setdefault("normalization_type", "linear")
        super().__init__(workflow, **kwargs)
        datasets = root.common.dirs.get("datasets", None)
        self.directory = directory or (
            os.path.join(datasets, "mnist") if datasets else None)
        self.url_base = url_base
        self.flat = flat

    def _resolve(self, stem):
        if self.directory is None:
            return None
        for name in (stem, stem + ".gz"):
            path = os.path.join(self.directory, name)
            if os.path.exists(path):
                return path
        return None

    def load_data(self):
        missing = [stem for stem in FILES.values()
                   if self._resolve(stem) is None]
        if missing:
            if self.url_base is None:
                raise FileNotFoundError(
                    "%s: idx files not found in %s and no url_base given"
                    % (self.name, self.directory))
            raise FileNotFoundError(
                "%s: %s missing from %s; fetching them from %s needs the "
                "downloader, a later slice of the port (ROADMAP A9): put "
                "the idx files there" % (self.name, ", ".join(missing),
                                         self.directory, self.url_base))
        train_x = read_idx(self._resolve(FILES["train_images"]))
        train_y = read_idx(self._resolve(FILES["train_labels"]))
        test_x = read_idx(self._resolve(FILES["test_images"]))
        test_y = read_idx(self._resolve(FILES["test_labels"]))
        n_valid, n_train = len(test_x), len(train_x)
        shape = (-1,) if self.flat else (28, 28, 1)
        data = numpy.concatenate([
            test_x.reshape((n_valid,) + shape).astype(numpy.float32),
            train_x.reshape((n_train,) + shape).astype(numpy.float32)])
        labels = numpy.concatenate([
            test_y.astype(numpy.int32), train_y.astype(numpy.int32)])
        self._provided_data = data
        self._provided_labels = labels
        self._provided_lengths = [0, n_valid, n_train]
        super().load_data()
