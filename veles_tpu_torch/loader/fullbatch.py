"""FullBatchLoader: the whole dataset resident on the device, minibatches
by gather.

The port of ``veles_tpu/loader/fullbatch.py`` (reference
``veles/loader/fullbatch.py``): the dataset lives in the
``original_data``/``original_labels`` Arrays as tensors on the workflow's
device (``workflow.device``), and a minibatch is one ``index_select`` plus
the normalizer. The JAX package keeps the originals on the host when the
device runs out of memory (``fullbatch.py:84-90``); the port raises
instead: a dataset that does not fit is an error, not a quiet host path.

Callers pass the dataset as ``data=``/``labels=`` kwargs; class splits
come from ``class_lengths`` or the ``validation_ratio`` resplit.
``train_transform`` names an augmentation of ``ops/augment.TRANSFORMS``
("mirror", "shift1") applied to TRAIN minibatches after normalization;
it needs NHWC data.
"""

import numpy
import torch

from veles_tpu_torch.loader.base import Loader, TRAIN, VALID
from veles_tpu_torch.loader.normalization import (make_normalizer,
                                                  state_tensors)
from veles_tpu_torch.memory import Array
from veles_tpu_torch.ops.augment import TRANSFORMS
from veles_tpu_torch.ops.gather import gather_minibatch


class FullBatchLoader(Loader):
    """Device-resident full-batch loader (reference ``fullbatch.py:79``)."""

    def __init__(self, workflow, **kwargs):
        #: TRAIN-minibatch augmentation by name (ops/augment.TRANSFORMS)
        self.train_transform = kwargs.pop("train_transform", None)
        if self.train_transform is not None \
                and self.train_transform not in TRANSFORMS:
            raise ValueError("unknown train_transform %r (known: %s)"
                             % (self.train_transform,
                                ", ".join(sorted(TRANSFORMS))))
        self.normalization_type = kwargs.pop("normalization_type", "none")
        self.normalization_parameters = kwargs.pop(
            "normalization_parameters", {})
        self.validation_ratio = kwargs.pop("validation_ratio", None)
        data = kwargs.pop("data", None)
        labels = kwargs.pop("labels", None)
        lengths = kwargs.pop("class_lengths", None)
        super().__init__(workflow, **kwargs)
        self.original_data = Array()
        self.original_labels = Array()
        self._provided_data = data
        self._provided_labels = labels
        self._provided_lengths = lengths
        self._raw_labels = None
        self.normalizer = None

    @property
    def device(self):
        """Where the originals live: the workflow's device."""
        return self.workflow.device

    # -- ILoader --------------------------------------------------------------
    def load_data(self):
        if self._provided_data is None:
            raise NotImplementedError(
                "%s: override load_data() or pass data=" % self.name)
        data = numpy.asarray(self._provided_data, numpy.float32)
        if self.train_transform is not None and data.ndim != 4:
            raise ValueError("train_transform %r needs NHWC data, got "
                             "shape %s" % (self.train_transform, data.shape))
        self.original_data.reset(data)
        if self._provided_labels is not None:
            self._raw_labels = numpy.asarray(self._provided_labels)
        if self._provided_lengths is not None:
            self.class_lengths = list(self._provided_lengths)
        else:
            self.class_lengths = [0, 0, len(data)]
        if self.validation_ratio:
            self._resplit_validation()
        self._analyze_normalization()
        self.original_data.to_device(self.device)

    def get_raw_labels(self):
        return self._raw_labels

    def analyze_dataset(self):
        """Label mapping first (base), then the int32 label array the
        gather uses, on the device."""
        super().analyze_dataset()
        if self._raw_labels is not None:
            self.original_labels.reset(self.map_labels(self._raw_labels))
            self.original_labels.to_device(self.device)

    def _resplit_validation(self):
        """Move the tail of TRAIN into VALID (reference
        ``validation_ratio`` resplit)."""
        n_valid = int(self.class_lengths[TRAIN] * self.validation_ratio)
        valid_end = self.class_offset(TRAIN)
        total = self.total_samples
        self.class_lengths[VALID] += n_valid
        self.class_lengths[TRAIN] -= n_valid
        perm = numpy.concatenate([
            numpy.arange(valid_end),
            numpy.arange(total - n_valid, total),
            numpy.arange(valid_end, total - n_valid)])
        self.original_data.reset(self.original_data.mem[perm])
        if self._raw_labels is not None:
            self._raw_labels = self._raw_labels[perm]

    def _analyze_normalization(self):
        """One host pass over the train set accumulating the normalizer's
        statistics (reference ``loader/base.py:755-802``)."""
        self.normalizer = make_normalizer(self.normalization_type,
                                          **self.normalization_parameters)
        if self.normalizer.STATELESS:
            return
        start = self.class_offset(TRAIN)
        train = self.original_data.mem[
            start:start + self.class_lengths[TRAIN]]
        if not len(train):  # no train split (e.g. pure evaluation runs)
            train = self.original_data.mem
        self.normalizer.analyze(train)

    def create_minibatch_data(self):
        size = self.max_minibatch_size
        sample_shape = self.original_data.shape[1:]
        self.minibatch_data.reset(
            numpy.zeros((size,) + sample_shape, numpy.float32))
        if self.original_labels:
            self.minibatch_labels.reset(numpy.zeros(size, numpy.int32))
        self.minibatch_indices.reset(numpy.zeros(size, numpy.int64))
        self.sample_mask.reset(numpy.zeros(size, numpy.float32))

    #: the fused tick's contract: a fill-time transform keeps fusion on
    #: only where the tick applies it itself (``fullbatch.py:160-165``)
    @property
    def has_fill_transforms(self):
        return self.train_transform is not None

    @property
    def jit_transform(self):
        return self.train_transform

    def labels_for_gather(self):
        """The label lane the fused tick gathers from: the device labels,
        or a dataset-length zeros placeholder for a label-less set."""
        if self.original_labels:
            return self.original_labels.data
        return torch.zeros(len(self.original_data), dtype=torch.int32,
                           device=self.device)

    def fill_minibatch(self, indices, valid):
        """Gather and normalize the minibatch into the slots, on the
        device."""
        device = self.device
        index = torch.from_numpy(numpy.asarray(indices, numpy.int64)).to(
            device)
        batch, lab = gather_minibatch(self.original_data.data, index,
                                      self.labels_for_gather())
        batch = self.normalizer.apply_state(
            batch, state_tensors(self.normalizer.jit_state(), device))
        if self.train_transform and self.minibatch_class == TRAIN:
            batch = TRANSFORMS[self.train_transform](
                batch, int(self.draw_transform_seeds(1)[0]))
        self.minibatch_data.data = batch
        self.minibatch_labels.data = lab
        self.sample_mask.data = (torch.arange(len(indices), device=device)
                                 < valid).float()
        self.minibatch_indices.data = indices
