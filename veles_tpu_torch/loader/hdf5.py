"""HDF5 dataset loaders.

The port of ``veles_tpu/loader/hdf5.py`` (reference
``veles/loader_hdf5.py:48-151``): one HDF5 file per sample class with a
``data`` dataset and an optional ``label`` dataset.

- :class:`FullBatchHDF5Loader` reads every class file into the
  device-resident full-batch path (``loader/fullbatch.py``);
- :class:`HDF5Loader` streams: it keeps the datasets open and reads each
  minibatch's rows from disk on the host, then moves the minibatch to the
  workflow's device, for datasets larger than the card and the host RAM.

h5py is imported when a file is opened; without it the loader raises
ImportError naming h5py.
"""

import numpy
import torch

from veles_tpu_torch.loader.base import (Loader, TEST, VALID, TRAIN,
                                        register_loader)
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.loader.normalization import make_normalizer


def _open_class_file(path, expect_labels):
    """Open one class file: ``(h5file, data, labels or None)``."""
    try:
        import h5py
    except ImportError:
        raise ImportError("the HDF5 loaders need h5py, which is not "
                          "installed (reading %s)" % path) from None
    h5f = h5py.File(path, "r")
    data = h5f["data"]
    labels = h5f["label"] if "label" in h5f else None
    if expect_labels is not None and (labels is None) == expect_labels:
        h5f.close()
        raise ValueError("%s: some class files have labels and some do not"
                         % path)
    if labels is not None and len(labels) != len(data):
        h5f.close()
        raise ValueError("%s: data and label lengths differ" % path)
    return h5f, data, labels


class HDF5PathsMixin:
    def _pop_paths(self, kwargs):
        self.class_paths = (kwargs.pop("test_path", None),
                            kwargs.pop("validation_path", None),
                            kwargs.pop("train_path", None))


@register_loader("full_batch_hdf5")
class FullBatchHDF5Loader(HDF5PathsMixin, FullBatchLoader):
    """The whole HDF5 dataset resident on the device (reference
    ``FullBatchHDF5Loader``, ``loader_hdf5.py:127-151``)."""

    def __init__(self, workflow, **kwargs):
        self._pop_paths(kwargs)
        super().__init__(workflow, **kwargs)

    def load_data(self):
        datas, labels, lengths = [], [], []
        expect_labels = None
        for path in self.class_paths:
            if not path:
                lengths.append(0)
                continue
            h5f, data, labs = _open_class_file(path, expect_labels)
            try:
                expect_labels = labs is not None
                lengths.append(len(data))
                datas.append(numpy.asarray(data[:], numpy.float32))
                if labs is not None:
                    labels.append(numpy.asarray(labs[:]))
            finally:
                h5f.close()
        if not datas:
            raise ValueError("%s: no HDF5 paths given" % self.name)
        self._provided_data = numpy.concatenate(datas)
        self._provided_labels = (numpy.concatenate(labels)
                                 if labels else None)
        self._provided_lengths = lengths
        super().load_data()


@register_loader("hdf5")
class HDF5Loader(HDF5PathsMixin, Loader):
    """Streaming HDF5 loader: each minibatch's rows read from disk
    (reference ``HDF5Loader``, ``loader_hdf5.py:94-124``). The normalizer
    analyses the train split on the host in minibatch-size blocks."""

    def __init__(self, workflow, **kwargs):
        self._pop_paths(kwargs)
        self.normalization_type = kwargs.pop("normalization_type", "none")
        self.normalization_parameters = kwargs.pop(
            "normalization_parameters", {})
        super().__init__(workflow, **kwargs)
        self.normalizer = None
        self.sample_shape = None
        self._raw_labels = None

    def init_unpickled(self):
        super().init_unpickled()
        self._datasets_ = [None, None, None]
        self._h5_files_ = []

    def stop(self):
        for h5f in self._h5_files_:
            h5f.close()
        self._h5_files_ = []

    def load_data(self):
        expect_labels = None
        raw_label_parts = []
        for klass, path in enumerate(self.class_paths):
            if not path:
                continue
            h5f, data, labs = _open_class_file(path, expect_labels)
            self._h5_files_.append(h5f)
            expect_labels = labs is not None
            self._datasets_[klass] = (data, labs)
            self.class_lengths[klass] = len(data)
            if labs is not None:
                raw_label_parts.append(numpy.asarray(labs[:]))
            shape = tuple(data.shape[1:])
            if self.sample_shape not in (None, shape):
                raise ValueError("%s: class sample shapes differ"
                                 % self.name)
            self.sample_shape = shape
        if raw_label_parts:
            self._raw_labels = numpy.concatenate(raw_label_parts)
        self.normalizer = make_normalizer(self.normalization_type,
                                          **self.normalization_parameters)
        if not self.normalizer.STATELESS:
            data, _ = self._datasets_[TRAIN] or (None, None)
            if data is not None:
                step = max(1, self.max_minibatch_size)
                for start in range(0, len(data), step):
                    self.normalizer.analyze(
                        numpy.asarray(data[start:start + step],
                                      numpy.float32))

    def get_raw_labels(self):
        return self._raw_labels

    def create_minibatch_data(self):
        size = self.max_minibatch_size
        self.minibatch_data.reset(numpy.zeros(
            (size,) + self.sample_shape, numpy.float32))
        if self._raw_labels is not None:
            self.minibatch_labels.reset(numpy.zeros(size, numpy.int32))
        self.minibatch_indices.reset(numpy.zeros(size, numpy.int64))
        self.sample_mask.reset(numpy.zeros(size, numpy.float32))

    def _row(self, global_index):
        for klass in (TEST, VALID, TRAIN):
            offset = self.class_offset(klass)
            if global_index < offset + self.class_lengths[klass]:
                return klass, global_index - offset
        raise IndexError(global_index)

    def fill_minibatch(self, indices, valid):
        batch = numpy.zeros(self.minibatch_data.shape, numpy.float32)
        raw = []
        for i, gi in enumerate(indices[:valid]):
            klass, row = self._row(int(gi))
            data, labs = self._datasets_[klass]
            batch[i] = data[row]
            if labs is not None:
                raw.append(labs[row])
        batch = self.normalizer.normalize(batch)
        device = self.device
        mask = (numpy.arange(len(indices)) < valid).astype(numpy.float32)
        self.minibatch_data.data = torch.from_numpy(
            numpy.ascontiguousarray(batch, numpy.float32)).to(device)
        if self._raw_labels is not None:
            labels = numpy.zeros(len(indices), numpy.int32)
            labels[:valid] = self.map_labels(raw)
            self.minibatch_labels.data = torch.from_numpy(labels).to(device)
        self.sample_mask.data = torch.from_numpy(mask).to(device)
        self.minibatch_indices.data = numpy.asarray(indices)
