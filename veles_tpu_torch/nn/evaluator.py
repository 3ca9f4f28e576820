"""Evaluator units: loss, error signal and metrics.

The port of ``veles_tpu/nn/evaluator.py`` (the Znicz EvaluatorSoftmax
and EvaluatorMSE contracts): the unit consumes the last forward's
``output`` and the loader's labels and mask, emits ``err_output`` for the
gradient chain and the metric slots (``loss``, ``n_err``,
``confusion_matrix``) the Decision reads at epoch boundaries, as device
tensors. The softmax, the cross-entropy and its gradient are one masked
computation over the logits (``ops/losses.masked_softmax_xent``); the
0/1 ``sample_mask`` zeroes the padded rows of a short final minibatch.
In the fused tick the tick fills the same slots. ``EvaluatorMSE`` takes
the loader's targets in place of the labels and publishes ``loss`` (the
mean over the valid rows of the summed squared error) and ``max_err``,
no ``n_err`` (``ops/losses.masked_mse``).
"""

import torch

from veles_tpu_torch.nn.jit_unit import JitUnit
from veles_tpu_torch.ops import losses


class EvaluatorBase(JitUnit):

    hide_from_registry = True
    VIEW_GROUP = "EVALUATOR"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.input = None          # forward output (linked)
        self.sample_mask = None    # loader-provided validity mask (linked)
        self.demand("input")


class EvaluatorSoftmax(EvaluatorBase):
    """Softmax cross-entropy evaluator (Znicz EvaluatorSoftmax)."""

    INPUTS = ("input", "labels", "sample_mask")
    OUTPUTS = ("err_output", "loss", "n_err", "max_err_output_sum",
               "confusion_matrix")

    def __init__(self, workflow, **kwargs):
        self.compute_confusion = kwargs.pop("compute_confusion", True)
        super().__init__(workflow, **kwargs)
        self.labels = None  # linked from loader.minibatch_labels
        self.demand("labels")

    def compute(self, logits, labels, mask):
        n_classes = logits.shape[-1]
        valid = mask.sum().clamp(min=1.0)
        err, loss_sum, n_err, _ = losses.masked_softmax_xent(
            logits, labels, mask, valid)
        if self.compute_confusion:
            cm = losses.confusion_matrix(logits, labels, n_classes, mask)
        else:
            cm = torch.zeros((n_classes, n_classes), dtype=torch.int32,
                             device=logits.device)
        return err, loss_sum / valid, n_err, err.abs().max(), cm


class EvaluatorMSE(EvaluatorBase):
    """Mean-squared-error evaluator (Znicz EvaluatorMSE)."""

    INPUTS = ("input", "target", "sample_mask")
    OUTPUTS = ("err_output", "loss", "max_err")

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.target = None  # linked from loader.minibatch_targets
        self.demand("target")

    def compute(self, output, target, mask):
        valid = mask.sum().clamp(min=1.0)
        err, loss_sum, max_err = losses.masked_mse(output, target, mask,
                                                   valid)
        return err, loss_sum / valid, max_err
