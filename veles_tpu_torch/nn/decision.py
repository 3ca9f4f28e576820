"""DecisionGD: epoch accounting and stop decisions.

The port of ``veles_tpu/nn/decision.py`` (the Znicz Decision unit): it
watches the loader's epoch flags and the evaluator's metrics, accumulates
per-class error counts, decides whether the validation error improved,
and raises ``complete`` when training should stop (max epochs reached or
no improvement for ``fail_iterations`` epochs).

Host-side by design: it runs once per tick but does only flag checks;
the metrics stay device tensors until an epoch (or, per-minibatch, a
class) ends. In pipelined mode (``pipeline_depth`` 1, the fused tick's
default) each epoch's metrics are copied to the host asynchronously when
the epoch ends and read one epoch later, so the read never waits for the
card. ``DecisionMSE`` tracks the best validation MSE in place of the
error count. Left out: the fleet epoch buckets (a later slice).
"""

import numpy
import torch

from veles_tpu_torch.core.mutable import Bool
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.loader.base import CLASS_NAMES, TEST, TRAIN, VALID


class DecisionGD(Unit):
    """Training-loop decision unit (the Znicz Decision contract)."""

    VIEW_GROUP = "TRAINER"

    def __init__(self, workflow, **kwargs):
        self.max_epochs = kwargs.pop("max_epochs", None)
        self.fail_iterations = kwargs.pop("fail_iterations", 100)
        # plateau annealing: factor in (0, 1), applied to every GD unit
        # after each `lr_decay_patience` epochs without improvement
        self.lr_decay = kwargs.pop("lr_decay", None)
        self.lr_decay_patience = kwargs.pop("lr_decay_patience", 5)
        if self.lr_decay is not None \
                and not 0.0 < self.lr_decay < 1.0:
            raise ValueError("lr_decay must be in (0, 1), got %r"
                             % (self.lr_decay,))
        if self.lr_decay is not None and self.lr_decay_patience < 1:
            raise ValueError("lr_decay_patience must be >= 1, got %r"
                             % (self.lr_decay_patience,))
        super().__init__(workflow, **kwargs)
        # linked from the loader:
        self.loader = None
        # linked from the evaluator (device scalars, read at epoch end):
        self.evaluator = None
        self.demand("loader", "evaluator")
        self.complete = Bool(False)
        self.improved = Bool(False)
        self.train_ended = Bool(False)
        self.epoch_ended = Bool(False)
        # gate for the GD chain: True on non-train minibatches so the
        # backward units gate_skip (run nothing, still propagate the tick)
        self.gd_skipped = Bool(False)
        # accumulated per-class stats, indexed TEST/VALID/TRAIN:
        self.epoch_n_err = [0, 0, 0]
        self.epoch_samples = [0, 0, 0]
        self.epoch_loss = [0.0, 0.0, 0.0]
        self.best_n_err = [None, None, None]
        self.best_epoch = 0
        self.snapshot_suffix = ""
        # frozen copies of the LAST finished epoch (plotter/publisher feed)
        self.last_epoch_n_err = [0, 0, 0]
        self.last_epoch_samples = [0, 0, 0]
        self.last_epoch_loss = [0.0, 0.0, 0.0]
        self.last_epoch_confusion = None
        self._epoch_confusion = None
        self._epochs_without_improvement = 0
        self._epochs_done = 0
        # sweep serving: classes whose sweep finished but whose
        # accumulators are still lazy device values (materialized in one
        # batched transfer at the epoch boundary)
        self._pending_classes = []
        # (the volatile per-tick accumulators — _dev_acc_,
        # _dev_confusion_ — are created in init_unpickled, which
        # Pickleable.__init__ already ran)
        # pipelined fused mode: materialize each epoch's metrics this
        # many epochs LATE — by then the device has finished computing
        # them, so the batched read never stalls the dispatch pipeline.
        # 0 = read at the epoch's own boundary (the default)
        self.pipeline_depth = 0
        self._lagged_epochs_ = []

    def link_from_workflow(self, loader, evaluator):
        self.loader = loader
        self.evaluator = evaluator
        return self

    def initialize(self, **kwargs):
        if self.loader is None or self.evaluator is None:
            return True

    def run(self):
        self.improved.unset()
        self.epoch_ended.unset()
        klass = self.loader.minibatch_class
        self.gd_skipped.set(klass != TRAIN)
        # accumulate metrics as device tensors — a host read here would
        # wait for the card every tick; conversion to Python numbers
        # happens only at class/epoch boundaries
        size = int(self.loader.minibatch_valid_size)
        n_err_slot = getattr(self.evaluator, "n_err", None)
        sweep = getattr(self.loader, "sweep_serving", False)
        self.epoch_samples[klass] += size
        cm_data = None
        if klass == VALID:
            cm = getattr(self.evaluator, "confusion_matrix", None)
            cm_data = getattr(cm, "data", None)
        if sweep:
            # one tick per class sweep: device-side accumulate is one
            # cheap lazy op and the values ride the epoch pipeline
            if n_err_slot is not None:
                self.epoch_n_err[klass] = (self.epoch_n_err[klass]
                                           + n_err_slot.data)
            self.epoch_loss[klass] = (self.epoch_loss[klass]
                                      + self.evaluator.loss.data * size)
            if cm_data is not None:
                self._epoch_confusion = (cm_data
                                         if self._epoch_confusion is None
                                         else self._epoch_confusion
                                         + cm_data)
        else:
            # per-minibatch serving: the running sums stay on the device;
            # they are read once at the class boundary
            n_err_val = (n_err_slot.data if n_err_slot is not None
                         else 0)
            n_err_acc, loss_acc = self._dev_acc_[klass] or (0, 0.0)
            self._dev_acc_[klass] = (
                n_err_acc + n_err_val,
                loss_acc + self.evaluator.loss.data * size)
            if cm_data is not None:
                self._dev_confusion_ = (
                    cm_data if self._dev_confusion_ is None
                    else self._dev_confusion_ + cm_data)
        if not self.loader.epoch_ended_for_class:
            return
        if sweep:
            # sweep mode: a host read here would wait for the in-flight
            # sweep once per class. Defer ALL materialization to the
            # epoch boundary (and, in pipelined mode, a further
            # ``pipeline_depth`` epochs late).
            self._pending_classes.append(klass)
            if self.loader.epoch_ended:
                self._queue_epoch()
                self._drain_epochs()
            return
        # one sample class finished: settle the device accumulators
        if self._dev_acc_[klass] is not None:
            n_err, loss = self._dev_acc_[klass]
            self._dev_acc_[klass] = None
            self.epoch_n_err[klass] += int(n_err)
            self.epoch_loss[klass] += float(loss)
        if klass == VALID and self._dev_confusion_ is not None:
            total = _host(self._dev_confusion_)
            self._dev_confusion_ = None
            self._epoch_confusion = (
                total if self._epoch_confusion is None
                else self._epoch_confusion + total)
        self._on_class_ended(klass)
        if self.loader.epoch_ended:
            self._on_epoch_ended()

    def _queue_epoch(self):
        """Park the finished epoch's (still-lazy) accumulators and reset
        the live ones for the next epoch."""
        entry = {
            "n_err": self.epoch_n_err, "loss": self.epoch_loss,
            "samples": self.epoch_samples,
            "confusion": self._epoch_confusion,
            "classes": self._pending_classes,
        }
        if self.pipeline_depth:
            # start the device->host copies NOW: they complete during
            # the next epoch's compute, so the lagged materialization
            # pays neither the compute wait nor the transfer round trip
            for key in ("n_err", "loss"):
                entry[key] = [_start_copy(v) for v in entry[key]]
            entry["confusion"] = _start_copy(entry["confusion"])
        self._lagged_epochs_.append(entry)
        self.epoch_n_err = [0, 0, 0]
        self.epoch_loss = [0.0, 0.0, 0.0]
        self.epoch_samples = [0, 0, 0]
        self._epoch_confusion = None
        self._pending_classes = []

    def _drain_epochs(self):
        """Materialize queued epochs down to ``pipeline_depth`` — or ALL
        of them when the serving side has reached ``max_epochs`` (an
        exact stop: nothing speculative is in flight then). A lagged
        no-improvement stop drops the younger, speculatively-trained
        epochs and rolls the fused params back, making the run's outputs
        identical to the unpipelined ones."""
        served = self._epochs_done + len(self._lagged_epochs_)
        drain_all = (self.max_epochs is not None
                     and served >= self.max_epochs)
        # whichever engine owns the pipelined params history (the fused
        # tick or the sweep tier) gets the advance/rollback hooks
        tick = (getattr(self.workflow, "fused_tick", None)
                or getattr(self.workflow, "sweep_unit", None))
        first = True
        while self._lagged_epochs_ and (
                drain_all
                or len(self._lagged_epochs_) > self.pipeline_depth):
            entry = self._lagged_epochs_.pop(0)
            if not first and tick is not None:
                # two epochs materialize on this tick but the tick's
                # one-slot params history rotated only once: if the
                # SECOND epoch is about to take 'improved' (peek its
                # prefetched valid error), advance the unit Arrays to
                # the params it evaluated so a snapshot-on-improved
                # stays exact; if not, leave them on the older epoch's
                # evaluated state — the improvement that stands
                if self._is_improvement(VALID, self._peek_metric(entry)):
                    tick.advance_eval_params()
            first = False
            self._materialize_entry(entry)
            if self.complete and self._lagged_epochs_:
                dropped = len(self._lagged_epochs_)
                self._lagged_epochs_ = []
                if tick is not None:
                    tick.rollback_speculative()
                self.info("dropped %d speculative epoch(s) after the "
                          "lagged stop decision", dropped)
                break

    def _materialize_entry(self, entry):
        """One batched device->host transfer for one epoch's
        accumulators (error counts, loss sums, confusion), then the
        class summaries in serving order and the epoch summary."""
        self.epoch_n_err = [int(_host(v)) for v in entry["n_err"]]
        self.epoch_loss = [float(_host(v)) for v in entry["loss"]]
        self.epoch_samples = list(entry["samples"])
        self._epoch_confusion = _host(entry["confusion"])
        for klass in entry["classes"]:
            self._on_class_ended(klass)
        self._on_epoch_ended()

    # -- epoch boundary logic -------------------------------------------------
    def _metric(self, n_err, samples, loss_sum):
        """The tracked improvement metric for one class sweep: the error
        COUNT. Smaller is better."""
        return n_err

    def _peek_metric(self, entry):
        """The VALID metric of a still-lazy epoch entry (the pipelined
        drain's advance-peek)."""
        return int(_host(entry["n_err"][VALID]))

    def _improvement_suffix(self, metric, n_err, samples):
        return "validation_%.2fpt" % (100.0 * n_err / max(samples, 1))

    def _class_summary(self, klass, n_err, samples, loss_sum, epoch):
        """One sample-class sweep of one epoch finished."""
        samples = max(samples, 1)
        error_pct = 100.0 * n_err / samples
        self.info(
            "epoch %d %s: errors %d/%d (%.2f%%) avg loss %.6f",
            epoch, CLASS_NAMES[klass], n_err, samples, error_pct,
            loss_sum / samples)
        if klass == VALID:
            metric = self._metric(n_err, samples, loss_sum)
            self._track_improvement(
                VALID, metric, epoch,
                self._improvement_suffix(metric, n_err, samples))

    def _is_improvement(self, klass, metric):
        """THE improvement predicate — _track_improvement and the
        pipelined drain's advance-peek must never diverge."""
        best = self.best_n_err[klass]
        return best is None or metric < best

    def _track_improvement(self, klass, metric, epoch, suffix):
        if self._is_improvement(klass, metric):
            self.best_n_err[klass] = metric
            self.best_epoch = epoch
            self.improved.set()
            self._epochs_without_improvement = 0
            self.snapshot_suffix = suffix
        else:
            self._epochs_without_improvement += 1
            self._maybe_decay_lr()

    def _maybe_decay_lr(self):
        """Plateau annealing (the Znicz lr-adjuster role, additive knob):
        with ``lr_decay`` set, every ``lr_decay_patience`` epochs without
        improvement multiply each GD unit's learning rate by the factor.
        ``scale_learning_rate`` refreshes the hyper vector the fused tick
        reads every step."""
        if not self.lr_decay:
            return
        if self._epochs_without_improvement % self.lr_decay_patience:
            return
        workflow = self.workflow
        gds = [gd for gd in getattr(workflow, "gds", [])
               if gd is not None and hasattr(gd, "scale_learning_rate")]
        for gd in gds:
            gd.scale_learning_rate(self.lr_decay)
        lrs = sorted({round(gd.learning_rate, 10) for gd in gds})
        self.info("no improvement for %d epochs: learning rate decayed "
                  "x%g (now %s)", self._epochs_without_improvement,
                  self.lr_decay, lrs)

    @property
    def epochs_done(self):
        """Completed-epoch count (the published 'epochs' metric)."""
        return self._epochs_done

    def _epoch_summary(self, stats, epoch):
        """All classes of ``epoch`` accounted: decide whether to stop.
        ``stats[klass]`` is (n_err, samples, loss_sum)."""
        # STABLE per-epoch snapshots for side-band consumers (plotters,
        # publishers): the live accumulators are zeroed right after this
        self.last_epoch_n_err = [s[0] for s in stats]
        self.last_epoch_samples = [s[1] for s in stats]
        self.last_epoch_loss = [s[2] for s in stats]
        self.epoch_ended.set()
        self._epochs_done += 1
        # when there is no validation set, improvement tracks train error
        if stats[VALID][1] == 0 and stats[TRAIN][1] > 0:
            n_err, samples, loss_sum = stats[TRAIN]
            self._track_improvement(
                TRAIN, self._metric(n_err, samples, loss_sum), epoch,
                "train_%.2fpt" % (100.0 * n_err / max(samples, 1)))
        stop = False
        if self.max_epochs is not None \
                and self._epochs_done >= self.max_epochs:
            self.info("stopping: reached max_epochs=%d", self.max_epochs)
            stop = True
        if self._epochs_without_improvement >= self.fail_iterations:
            self.info("stopping: no improvement for %d epochs",
                      self.fail_iterations)
            stop = True
        if stop:
            self.complete.set()
            self.train_ended.set()

    def _on_class_ended(self, klass):
        self._class_summary(klass, self.epoch_n_err[klass],
                            self.epoch_samples[klass],
                            self.epoch_loss[klass], self._epochs_done)

    def _on_epoch_ended(self):
        stats = [(self.epoch_n_err[k], self.epoch_samples[k],
                  self.epoch_loss[k]) for k in (TEST, VALID, TRAIN)]
        self._epoch_summary(stats, self._epochs_done)
        if self._epoch_confusion is not None:
            self.last_epoch_confusion = numpy.asarray(
                _host(self._epoch_confusion))
            self._epoch_confusion = None
        for klass in (TEST, VALID, TRAIN):
            self.epoch_n_err[klass] = 0
            self.epoch_samples[klass] = 0
            self.epoch_loss[klass] = 0.0

    def init_unpickled(self):
        super().init_unpickled()
        if not hasattr(self, "_pending_classes"):
            self._pending_classes = []
        if not hasattr(self, "pipeline_depth"):
            self.pipeline_depth = 0
        if not hasattr(self, "lr_decay"):  # pre-knob snapshots
            self.lr_decay = None
            self.lr_decay_patience = 5
        self._lagged_epochs_ = []
        self._dev_acc_ = [None, None, None]
        self._dev_confusion_ = None

    # -- results (IResultProvider) -------------------------------------------
    def get_metric_names(self):
        return ["best_validation_errors", "best_epoch", "epochs"]

    def get_metric_values(self):
        return [self.best_n_err[VALID] if self.best_n_err[VALID] is not None
                else self.best_n_err[TRAIN],
                self.best_epoch, self._epochs_done]


class DecisionMSE(DecisionGD):
    """Decision for regression workflows: improvement tracks the minimum
    validation MSE instead of the error count (the Znicz DecisionMSE
    role, ``veles_tpu/nn/decision.py:467-502``). Works with
    :class:`~veles_tpu_torch.nn.evaluator.EvaluatorMSE`, which publishes
    ``loss`` and ``max_err`` but no ``n_err``."""

    def _metric(self, n_err, samples, loss_sum):
        return loss_sum / max(samples, 1)

    def _peek_metric(self, entry):
        loss_sum = float(_host(entry["loss"][VALID]))
        return loss_sum / max(entry["samples"][VALID], 1)

    def _improvement_suffix(self, metric, n_err, samples):
        return "validation_mse_%.6f" % metric

    def _class_summary(self, klass, n_err, samples, loss_sum, epoch):
        samples = max(samples, 1)
        self.info("epoch %d %s: avg mse %.6f", epoch,
                  CLASS_NAMES[klass], loss_sum / samples)
        if klass == VALID:
            metric = self._metric(n_err, samples, loss_sum)
            self._track_improvement(
                VALID, metric, epoch,
                self._improvement_suffix(metric, n_err, samples))

    @property
    def best_mse(self):
        """Alias: ``best_n_err`` stores the tracked metric, which for
        this decision is the average MSE."""
        return self.best_n_err

    def get_metric_names(self):
        return ["best_validation_mse", "best_epoch", "epochs"]


class _Copy:
    """A device->host copy in flight: the host tensor and the event that
    marks its completion."""

    def __init__(self, value):
        self.host = value.to("cpu", non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()


def _start_copy(value):
    """Start the device->host copy of a CUDA tensor; anything else is
    already on the host."""
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        return _Copy(value)
    return value


def _host(value):
    """The host value of a metric: a finished copy, a tensor (read now) or
    a plain number."""
    if isinstance(value, _Copy):
        value.event.synchronize()
        value = value.host
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return value
