"""Minibatch stream saver and replay loader.

The port of ``veles_tpu/loader/saver.py`` (reference
``veles/loader/saver.py:69-296``, MinibatchesSaver / MinibatchesLoader):
a Unit linked after any Loader records every served minibatch to a
compressed stream file; the companion loader replays that file as a
dataset.

The stream format is the JAX package's, byte for byte, so a file either
package writes is read by the other: ``pickle(header) | chunk* |
pickle(offset_table) | uint64 tail``, where each chunk is a ``<Q`` length
and an independently compressed pickle of ``(klass, valid, data,
labels)`` as numpy arrays, the table lists ``(klass, offset)`` pairs and
the tail points at it. Codecs: raw, gz, bz2, xz. Unpickling runs code:
replay only files this program or a trusted one wrote.
"""

import bz2
import gzip
import io
import lzma
import pickle
import struct

import numpy
import torch

from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.loader.base import Loader, register_loader

CODECS = {
    "raw": (lambda b: b, lambda b: b),
    "gz": (gzip.compress, gzip.decompress),
    "bz2": (bz2.compress, bz2.decompress),
    "xz": (lzma.compress, lzma.decompress),
}


class MinibatchesSaver(Unit):
    """Dump every served minibatch to a stream file (reference
    ``MinibatchesSaver``, ``saver.py:69-174``). Link it after the loader:
    ``saver.link_from(loader)`` + ``saver.link_attrs(loader, ...)``.
    ``file_name`` is required (the port keeps no cache directory).

    The loader must have shuffling disabled (``shuffle_limit=0``) so the
    recorded epoch is deterministic, as the reference checks."""

    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow, **kwargs):
        self.file_name = kwargs.pop("file_name")
        self.compression = kwargs.pop("compression", "gz")
        if self.compression not in CODECS:
            raise ValueError("unknown compression %r (have %s)"
                             % (self.compression, sorted(CODECS)))
        super().__init__(workflow, **kwargs)
        self.offset_table = []
        self.demand("minibatch_data", "minibatch_labels", "minibatch_class",
                    "minibatch_valid_size", "class_lengths",
                    "max_minibatch_size")

    def init_unpickled(self):
        super().init_unpickled()
        self._file_ = None

    def initialize(self, **kwargs):
        loader = getattr(self.workflow, "loader", None)
        if loader is not None and loader.shuffle_limit != 0:
            raise ValueError(
                "disable shuffling in the loader (shuffle_limit=0) so the "
                "recorded stream is deterministic")
        self._file_ = open(self.file_name, "wb")
        header = {
            "compression": self.compression,
            "class_lengths": list(self.class_lengths),
            "max_minibatch_size": int(self.max_minibatch_size),
            "data_shape": tuple(self.minibatch_data.shape),
            "labels_shape": (tuple(self.minibatch_labels.shape)
                             if self.minibatch_labels else None),
            "labels_mapping": dict(getattr(
                loader, "labels_mapping", {}) or {}),
        }
        pickle.dump(header, self._file_, protocol=4)

    def run(self):
        data = self.minibatch_data.mem
        labels = (self.minibatch_labels.mem
                  if self.minibatch_labels else None)
        payload = (int(self.minibatch_class),
                   int(self.minibatch_valid_size), data, labels)
        blob = CODECS[self.compression][0](
            pickle.dumps(payload, protocol=4))
        # (class, offset) pairs: replay builds its chunk directory from
        # the table alone, without decompressing any chunk
        self.offset_table.append(
            (int(self.minibatch_class), self._file_.tell()))
        self._file_.write(struct.pack("<Q", len(blob)))
        self._file_.write(blob)

    def stop(self):
        if self._file_ is None or self._file_.closed:
            return
        table_pos = self._file_.tell()
        pickle.dump(self.offset_table, self._file_, protocol=4)
        self._file_.write(struct.pack("<Q", table_pos))
        self._file_.close()
        self.info("wrote %s (%d minibatches)", self.file_name,
                  len(self.offset_table))


@register_loader("minibatches")
class MinibatchesLoader(Loader):
    """Replay a recorded minibatch stream as a dataset (reference
    ``MinibatchesLoader``, ``saver.py:182-296``), its minibatches as
    tensors on the workflow's device.

    Serving is index-exact: chunk ``i`` of a class holds rows
    ``[i*mb, (i+1)*mb)`` of that class (shuffling was disabled when
    recording), so any global sample index maps straight to (chunk,
    row). A one-chunk cache keeps sequential replay cheap."""

    def __init__(self, workflow, **kwargs):
        self.file_name = kwargs.pop("file_name")
        super().__init__(workflow, **kwargs)
        self.shuffle_limit = 0  # replay preserves recorded order

    def init_unpickled(self):
        super().init_unpickled()
        self._file_ = None
        self._chunk_index_ = None
        self._cache_ = (None, None)

    def load_data(self):
        self._file_ = open(self.file_name, "rb")
        self._header = pickle.load(self._file_)
        self.class_lengths = list(self._header["class_lengths"])
        if self.minibatch_size != self._header["max_minibatch_size"]:
            self.info("minibatch_size %d -> %d (recorded)",
                      self.minibatch_size,
                      self._header["max_minibatch_size"])
            self.minibatch_size = self._header["max_minibatch_size"]
        self.labels_mapping.update(self._header.get("labels_mapping", {}))
        self._reversed_labels_mapping = sorted(self.labels_mapping)
        # chunk directory: per class, ordered file offsets
        self._file_.seek(-8, io.SEEK_END)
        table_pos, = struct.unpack("<Q", self._file_.read(8))
        self._file_.seek(table_pos)
        offsets = pickle.load(self._file_)
        self._chunk_index_ = {0: [], 1: [], 2: []}
        for klass, off in offsets:
            self._chunk_index_[klass].append(off)

    def stop(self):
        if self._file_ is not None:
            self._file_.close()

    def _read_chunk(self, offset):
        self._file_.seek(offset)
        size, = struct.unpack("<Q", self._file_.read(8))
        blob = self._file_.read(size)
        return pickle.loads(
            CODECS[self._header["compression"]][1](blob))

    def _chunk(self, offset):
        if self._cache_[0] != offset:
            self._cache_ = (offset, self._read_chunk(offset))
        return self._cache_[1]

    def create_minibatch_data(self):
        mb = self.max_minibatch_size
        self.minibatch_data.reset(numpy.zeros(
            (mb,) + tuple(self._header["data_shape"][1:]), numpy.float32))
        if self._header["labels_shape"] is not None:
            self.minibatch_labels.reset(numpy.zeros(mb, numpy.int32))
        self.minibatch_indices.reset(numpy.zeros(mb, numpy.int64))
        self.sample_mask.reset(numpy.zeros(mb, numpy.float32))

    def fill_minibatch(self, indices, valid):
        mb = self.max_minibatch_size
        batch = numpy.zeros(self.minibatch_data.shape, numpy.float32)
        labels = numpy.zeros(len(indices), numpy.int32)
        for i, gi in enumerate(indices[:valid]):
            gi = int(gi)
            for klass in (0, 1, 2):
                offset = self.class_offset(klass)
                if gi < offset + self.class_lengths[klass]:
                    local = gi - offset
                    break
            chunk_off = self._chunk_index_[klass][local // mb]
            _, _, data, labs = self._chunk(chunk_off)
            batch[i] = data[local % mb]
            if labs is not None:
                labels[i] = labs[local % mb]
        device = self.device
        mask = (numpy.arange(len(indices)) < valid).astype(numpy.float32)
        self.minibatch_data.data = torch.from_numpy(batch).to(device)
        if self._header["labels_shape"] is not None:
            self.minibatch_labels.data = torch.from_numpy(labels).to(device)
        self.sample_mask.data = torch.from_numpy(mask).to(device)
        self.minibatch_indices.data = numpy.asarray(indices)
