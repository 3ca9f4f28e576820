"""EvaluatorSoftmax: the loss and metric slots of the softmax path.

The port of ``veles_tpu/nn/evaluator.py`` as the fused tick uses it: the
unit links the last forward's ``output`` and the loader's labels and
mask, and owns the ``loss``, ``n_err`` and ``confusion_matrix`` slots
that the tick fills and the Decision reads (device tensors, read on the
host only at epoch boundaries). Its own compute (graph mode) is a later
slice; the MSE evaluator too.
"""

from veles_tpu_torch.nn.jit_unit import JitUnit


class EvaluatorSoftmax(JitUnit):
    """Softmax cross-entropy evaluator (Znicz EvaluatorSoftmax)."""

    VIEW_GROUP = "EVALUATOR"

    INPUTS = ("input", "labels", "sample_mask")
    OUTPUTS = ("err_output", "loss", "n_err", "max_err_output_sum",
               "confusion_matrix")

    def __init__(self, workflow, **kwargs):
        self.compute_confusion = kwargs.pop("compute_confusion", True)
        super().__init__(workflow, **kwargs)
        self.input = None          # forward output (linked)
        self.sample_mask = None    # loader-provided validity mask (linked)
        self.labels = None         # linked from loader.minibatch_labels
        self.demand("input", "labels")
