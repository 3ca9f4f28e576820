"""Loader base: the minibatch server.

The port of ``veles_tpu/loader/base.py`` (reference
``veles/loader/base.py``) for standalone training. Kept semantics:

- three sample classes TEST(0)/VALID(1)/TRAIN(2) with per-class lengths
  and a fixed serving order TEST → VALID → TRAIN inside each epoch;
- train-set reshuffling each epoch from the named "loader" PRNG stream
  (numpy PCG64, bit for bit the JAX package's), bounded by
  ``shuffle_limit``;
- epoch flags consumed by Decision/GD gating: ``minibatch_class``,
  ``last_minibatch``, ``epoch_ended_for_class``, ``epoch_ended``,
  ``epoch_number``;
- static minibatch shapes: a short final minibatch keeps
  ``max_minibatch_size`` rows, padded with index 0, and exposes
  ``minibatch_valid_size``;
- sweep serving (``serve_next_class_sweep``): a whole class sweep as one
  (n_batches, minibatch) index matrix, for the fused tick;
- augmentation seeds (``draw_transform_seeds``): with a ``jit_transform``,
  one seed per TRAIN minibatch from the "loader" stream, drawn where the
  JAX package draws them (after the sweep's or minibatch's indices, before
  the next epoch's shuffle), so every later shuffle stays the JAX
  package's.

``register_loader`` keeps the name -> class registry; ``LoaderMSEMixin``
adds the regression targets (``FullBatchLoaderMSE``). Left out: the
fleet distribution (master/slave payloads, requeue of a dropped slave's
minibatches) and the metrics bridge (the observe plane is a later slice).
"""

import collections

import numpy

from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.mutable import Bool
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.core.verified import ILOADER, verify_interface
from veles_tpu_torch.loader.normalization import normalizer_registry
from veles_tpu_torch.memory import Array

TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAMES = ("test", "validation", "train")

#: Name -> loader-class map (reference ``loader/base.py:83``
#: UserLoaderRegistry); populated by the @register_loader decorator.
loader_registry = {}


def register_loader(name):
    def wrap(cls):
        loader_registry[name] = cls
        return cls
    return wrap


class Loader(Unit):
    """Minibatch server base (reference ``loader/base.py:120``)."""

    hide_from_registry = True
    VIEW_GROUP = "LOADER"

    def __init__(self, workflow, **kwargs):
        self.minibatch_size = kwargs.pop("minibatch_size", 100)
        self.train_ratio = kwargs.pop(
            "train_ratio", root.common.get("train_ratio", 1.0))
        self.shuffle_limit = kwargs.pop(
            "shuffle_limit", root.common.loader.get("shuffle_limit", None))
        self.prng_key = kwargs.pop("prng_key", "loader")
        super().__init__(workflow, **kwargs)
        #: raw label -> contiguous class index (reference
        #: ``loader/base.py:925-944`` auto-mapping)
        self.labels_mapping = {}
        self._reversed_labels_mapping = []
        self.class_lengths = [0, 0, 0]
        self.epoch_number = 0
        self.samples_served = 0
        self.minibatch_class = TRAIN
        self.minibatch_epoch = 0
        self.minibatch_valid_size = 0
        self.minibatch_offset = 0
        self.last_minibatch = Bool(False)
        self.epoch_ended = Bool(False)
        self.epoch_ended_for_class = Bool(False)
        self.complete = Bool(False)
        # served tensors (static-shape slots):
        self.minibatch_data = Array()
        self.minibatch_labels = Array()
        self.minibatch_indices = Array()
        self.sample_mask = Array()
        self.shuffled_indices = [None, None, None]
        self._position = [0, 0, 0]

    # -- the ILoader contract (reference loader/base.py:100-115) -------------
    def load_data(self):
        """Populate class_lengths and dataset storage. Abstract."""
        raise NotImplementedError

    def create_minibatch_data(self):
        """Allocate the static-shape minibatch slots. Abstract."""
        raise NotImplementedError

    def fill_minibatch(self, indices, valid):
        """Fill minibatch slots for ``indices`` (global sample ids);
        entries beyond ``valid`` are padding. Abstract."""
        raise NotImplementedError

    # -- derived sizes --------------------------------------------------------
    @property
    def total_samples(self):
        return int(sum(self.class_lengths))

    @property
    def max_minibatch_size(self):
        return self.minibatch_size

    def class_offset(self, klass):
        return int(sum(self.class_lengths[:klass]))

    @property
    def effective_class_lengths(self):
        """class_lengths with --train-ratio applied to TRAIN."""
        lengths = list(self.class_lengths)
        if self.train_ratio < 1.0:
            lengths[TRAIN] = max(1, int(lengths[TRAIN] * self.train_ratio))
        return lengths

    # -- lifecycle ------------------------------------------------------------
    def initialize(self, **kwargs):
        verify_interface(self, ILOADER, "ILoader")
        self.load_data()
        if self.total_samples == 0:
            raise ValueError("%s loaded an empty dataset" % self.name)
        self.info("dataset: test=%d validation=%d train=%d",
                  *self.class_lengths)
        for klass in (TEST, VALID, TRAIN):
            self.shuffled_indices[klass] = (
                numpy.arange(self.class_lengths[klass], dtype=numpy.int64)
                + self.class_offset(klass))
        self._shuffle_train()
        self.analyze_dataset()
        self.create_minibatch_data()

    # -- label analysis (reference loader/base.py:925-1018) ------------------
    def get_raw_labels(self):
        """Full-length label array aligned with the [test|valid|train] row
        layout, or None when the dataset has no labels."""
        return None

    @property
    def reversed_labels_mapping(self):
        """index -> raw label (for denormalizing predictions)."""
        return self._reversed_labels_mapping

    def map_labels(self, raw):
        """Raw labels -> contiguous int32 indices via labels_mapping."""
        raw = numpy.asarray(raw)
        if not self.labels_mapping:
            return raw.astype(numpy.int32)
        return numpy.fromiter(
            (self.labels_mapping[l] for l in raw.tolist()),
            numpy.int32, count=len(raw))

    def analyze_dataset(self):
        """Build the label auto-mapping from the train split and check the
        test/validation labels are a subset of it."""
        raw = self.get_raw_labels()
        if raw is None:
            return
        counters = []
        for klass in (TEST, VALID, TRAIN):
            start = self.class_offset(klass)
            counters.append(collections.Counter(numpy.asarray(
                raw[start:start + self.class_lengths[klass]]).tolist()))
        test_counts, valid_counts, train_counts = counters
        if not self.labels_mapping:
            source = sorted(train_counts) if train_counts else sorted(
                set(test_counts) | set(valid_counts))
            self.labels_mapping.update(
                {k: i for i, k in enumerate(source)})
            self._reversed_labels_mapping = sorted(self.labels_mapping)
        for klass, counts in ((TEST, test_counts), (VALID, valid_counts)):
            if not self.class_lengths[klass] or not train_counts:
                continue
            unknown = set(counts) - set(self.labels_mapping)
            if unknown:
                raise ValueError(
                    "%s: %s labels missing from the training set: %s"
                    % (self.name, CLASS_NAMES[klass], sorted(unknown)))

    def draw_transform_seeds(self, n):
        """``n`` augmentation seeds from the loader's stream, one per
        TRAIN minibatch, in the JAX package's order and range
        (``loader/base.py:295-302``)."""
        gen = prng.get(self.prng_key)
        return numpy.asarray(
            [int(gen.randint(0, 2 ** 31 - 1)) for _ in range(n)],
            numpy.int64)

    def _shuffle_train(self):
        if self.shuffle_limit is not None \
                and self.epoch_number >= self.shuffle_limit:
            return
        prng.get(self.prng_key).shuffle(self.shuffled_indices[TRAIN])

    # -- serving --------------------------------------------------------------
    def _next_block(self):
        """Compute the next (class, start, size) to serve, advancing epoch
        state. Returns None when a full epoch just completed."""
        lengths = self.effective_class_lengths
        for klass in (TEST, VALID, TRAIN):
            pos = self._position[klass]
            if pos < lengths[klass]:
                size = min(self.max_minibatch_size, lengths[klass] - pos)
                self._position[klass] = pos + size
                return klass, pos, size
        return None

    def _roll_epoch(self):
        self.epoch_number += 1
        self._position = [0, 0, 0]
        self._shuffle_train()

    def serve_next_minibatch(self):
        """Pick the next minibatch: returns (klass, indices, valid_size,
        last_of_class, last_of_epoch, epoch)."""
        block = self._next_block()
        if block is None:
            self._roll_epoch()
            block = self._next_block()
        klass, pos, valid = block
        # copy, not view: the epoch reshuffle mutates shuffled_indices
        indices = self.shuffled_indices[klass][pos:pos + valid].copy()
        lengths = self.effective_class_lengths
        last_of_class = self._position[klass] >= lengths[klass]
        last_of_epoch = last_of_class and all(
            self._position[k] >= lengths[k] or lengths[k] == 0
            for k in (TEST, VALID, TRAIN))
        return (klass, indices, valid, last_of_class, last_of_epoch,
                self.epoch_number)

    def serve_next_class_sweep(self):
        """Serve one ENTIRE sample-class sweep at once (the fused tick
        runs its minibatches in one call). Returns (klass,
        index_matrix(n_batches, mb), valid_sizes (n_batches,),
        total_valid, last_of_epoch, epoch); padded entries hold index
        0."""
        lengths = self.effective_class_lengths
        klass = next((k for k in (TEST, VALID, TRAIN)
                      if self._position[k] < lengths[k]), None)
        if klass is None:
            self._roll_epoch()
            klass = next(k for k in (TEST, VALID, TRAIN) if lengths[k])
        mb = self.max_minibatch_size
        start = self._position[klass]
        n = lengths[klass] - start
        n_batches = (n + mb - 1) // mb
        idx = self.shuffled_indices[klass][start:start + n]
        matrix = numpy.zeros((n_batches, mb), dtype=numpy.int64)
        matrix.reshape(-1)[:n] = idx
        valid_sizes = numpy.full(n_batches, mb, dtype=numpy.int32)
        if n % mb:
            valid_sizes[-1] = n % mb
        self._position[klass] = lengths[klass]
        last_of_epoch = all(self._position[k] >= lengths[k]
                            or lengths[k] == 0
                            for k in (TEST, VALID, TRAIN))
        return (klass, matrix, valid_sizes, n, last_of_epoch,
                self.epoch_number)

    def run(self):
        """Pick the next indices (a minibatch, or with ``sweep_serving`` a
        class sweep) and publish them, filling the minibatch slots unless
        the fused tick gathers itself (``fill_data`` False)."""
        if getattr(self, "sweep_serving", False):
            (klass, matrix, valid_sizes, total, last_of_epoch,
             epoch) = self.serve_next_class_sweep()
            self._publish_flags(klass, matrix.reshape(-1), total, True,
                                last_of_epoch, epoch)
            self.minibatch_indices.data = matrix
            self.sweep_valid_sizes = valid_sizes
            # one augmentation seed per TRAIN minibatch, drawn in the
            # order per-minibatch serving draws them
            if klass == TRAIN and getattr(self, "jit_transform", None):
                self.sweep_transform_seeds = self.draw_transform_seeds(
                    len(matrix))
            else:
                self.sweep_transform_seeds = None
            self._account_served(total, last_of_epoch)
            return
        (klass, indices, valid, last_of_class,
         last_of_epoch, epoch) = self.serve_next_minibatch()
        self._publish_flags(klass, indices, valid, last_of_class,
                            last_of_epoch, epoch)
        padded = self._pad_indices(indices)
        if getattr(self, "fill_data", True):
            self.fill_minibatch(padded, valid)
        else:
            # fused-tick mode: the tick gathers from the originals; the
            # loader only publishes the served indices (host numpy)
            self.minibatch_indices.data = padded
            if klass == TRAIN and getattr(self, "jit_transform", None):
                self.minibatch_transform_seed = int(
                    self.draw_transform_seeds(1)[0])
            else:
                self.minibatch_transform_seed = 0
        self._account_served(valid, last_of_epoch)

    def _publish_flags(self, klass, indices, valid, last_of_class,
                       last_of_epoch, epoch):
        """The serve-side state every consumer reads — single source for
        both per-minibatch and sweep serving."""
        self.minibatch_class = klass
        self.minibatch_epoch = epoch
        self.minibatch_valid_size = valid
        self.minibatch_offset = int(indices[0]) if len(indices) else 0
        self.last_minibatch.set(last_of_class)
        self.epoch_ended_for_class.set(last_of_class)
        self.epoch_ended.set(last_of_epoch)

    def _account_served(self, valid, last_of_epoch):
        self.samples_served += valid
        if last_of_epoch:
            self.event("epoch", "single", number=self.epoch_number)

    def _pad_indices(self, indices):
        """Static shapes: pad short index blocks with index 0 (in range for
        ``index_select``); the mask zeroes their contribution."""
        padded = numpy.zeros(self.max_minibatch_size, dtype=numpy.int64)
        padded[:len(indices)] = indices
        return padded

    # -- results --------------------------------------------------------------
    def get_metric_names(self):
        return ["total_samples"]

    def get_metric_values(self):
        return [self.total_samples]


class LoaderMSEMixin:
    """Adds regression targets to a Loader (reference
    ``loader/base.py:1034-1155`` LoaderMSEMixin/LoaderMSE).

    Serves ``minibatch_targets`` beside data and labels, normalized by a
    *separate* target normalizer whose state supports ``denormalize()``:
    stateless normalizers other than "none" are refused, because the
    network output could never be mapped back to target units (reference
    ``base.py:1100-1111``)."""

    def __init__(self, workflow, **kwargs):
        self.targets_shape = kwargs.pop("targets_shape", ())
        self.target_normalization_type = kwargs.pop(
            "target_normalization_type",
            kwargs.get("normalization_type", "none"))
        self.target_normalization_parameters = kwargs.pop(
            "target_normalization_parameters",
            kwargs.get("normalization_parameters", {}))
        super().__init__(workflow, **kwargs)
        cls = normalizer_registry.get(self.target_normalization_type)
        if cls is None:
            raise ValueError("unknown target_normalization_type %r"
                             % self.target_normalization_type)
        if not cls.INVERTIBLE_FROM_STATE:
            raise ValueError(
                "target normalization %r needs per-sample stats to invert: "
                "test-time forward propagation could not be denormalized"
                % self.target_normalization_type)
        self.minibatch_targets = Array()
        self.target_normalizer = None
