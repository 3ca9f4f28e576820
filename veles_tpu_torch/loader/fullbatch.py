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
it needs NHWC data. The normalizer analyses the train split on the
device, where the originals already are. ``FullBatchLoaderMSE`` keeps
regression targets beside the data (``original_targets``), normalized by
their own normalizer and gathered by the same indices.

``normalizer_state`` (and the MSE loader's ``target_normalizer_state``),
set before ``initialize()``, makes the loader build its normalizer from
that state instead of analysing: the seam ``convert`` uses to start the
port from a JAX loader's statistics.
"""

import numpy
import torch

from veles_tpu_torch.loader.base import (Loader, LoaderMSEMixin, TRAIN,
                                        VALID, register_loader)
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
        self.normalizer_state = None

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
        self.original_data.to_device(self.device)
        self.normalizer = self._analyzed_normalizer(
            self.original_data.data, self.normalization_type,
            self.normalization_parameters, self.normalizer_state)

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
        self._apply_resplit(perm)

    def _apply_resplit(self, perm):
        """Apply the resplit permutation to every per-sample array; the MSE
        loader extends this to keep the targets row-aligned."""
        self.original_data.reset(self.original_data.mem[perm])
        if self._raw_labels is not None:
            self._raw_labels = self._raw_labels[perm]

    def _analyzed_normalizer(self, rows, name, parameters, state):
        """A normalizer built from ``state``, or one pass over the train
        rows of ``rows`` (all of them without a train split) accumulating
        its statistics (reference ``loader/base.py:755-802``)."""
        if state is not None:
            return make_normalizer(name, state=state)
        normalizer = make_normalizer(name, **parameters)
        if not normalizer.STATELESS:
            start = self.class_offset(TRAIN)
            train = rows[start:start + self.class_lengths[TRAIN]]
            normalizer.analyze(train if len(train) else rows)
        return normalizer

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


@register_loader("full_batch_mse")
class FullBatchLoaderMSE(LoaderMSEMixin, FullBatchLoader):
    """Full-batch loader with regression targets (reference
    ``loader/fullbatch.py`` FullBatchLoaderMSE + ``base.py:1147``): the
    targets live beside the data as the device tensor ``original_targets``,
    normalized by the target normalizer (analysed over the train split),
    and a minibatch's targets are gathered by its indices."""

    def __init__(self, workflow, **kwargs):
        targets = kwargs.pop("targets", None)
        super().__init__(workflow, **kwargs)
        self.original_targets = Array()
        self._provided_targets = targets
        self.target_normalizer_state = None

    def _apply_resplit(self, perm):
        super()._apply_resplit(perm)
        # targets must stay row-aligned with the respliced data
        self._provided_targets = self._provided_targets[perm]

    def load_data(self):
        if self._provided_targets is None:
            raise NotImplementedError(
                "%s: override load_data() or pass targets=" % self.name)
        self._provided_targets = numpy.asarray(
            self._provided_targets, numpy.float32)
        super().load_data()
        targets = self._provided_targets
        if len(targets) != self.total_samples:
            raise ValueError(
                "targets length %d != total samples %d"
                % (len(targets), self.total_samples))
        self.original_targets.reset(targets)
        self.original_targets.to_device(self.device)
        raw = self.original_targets.data
        self.target_normalizer = self._analyzed_normalizer(
            raw, self.target_normalization_type,
            self.target_normalization_parameters,
            self.target_normalizer_state)
        self.original_targets.data = self.target_normalizer.apply_state(
            raw, state_tensors(self.target_normalizer.jit_state(),
                               self.device))
        if not self.targets_shape:
            self.targets_shape = targets.shape[1:]

    def create_minibatch_data(self):
        super().create_minibatch_data()
        self.minibatch_targets.reset(numpy.zeros(
            (self.max_minibatch_size,) + tuple(self.targets_shape),
            numpy.float32))

    def fill_minibatch(self, indices, valid):
        super().fill_minibatch(indices, valid)
        targets = self.original_targets.data
        self.minibatch_targets.data = targets.index_select(
            0, torch.from_numpy(numpy.asarray(indices, numpy.int64)).to(
                targets.device))
