"""Ensemble combiner stage: stack member-model outputs as a dataset; the
port of ``veles_tpu/ensemble/combiner.py``.

A re-design of reference ``veles/loader/ensemble.py:46-143``:
after ``--ensemble-train``/``--ensemble-test``, each member model's
per-sample output becomes a feature row and a *combiner* (stacking) model
trains on top.

The wire format matches the reference's models-JSON:
``{"models": [{"id": ..., "Output": [[...]...], "Labels": [...]}, ...],
"winners": [...]}`` — ``Output`` is (n_samples, dim) per model,
``Labels`` the model's reversed labels mapping (outputs are re-mapped
when members disagree on label order, reference ``ensemble.py:100-123``),
``winners`` the true labels.

:class:`OutputDumper` is the producer side: linked after an evaluator it
accumulates per-sample outputs across an epoch (keyed by the loader's
served indices) and emits a models-JSON entry.
"""

import json

import numpy
import torch

from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.loader.base import TEST, TRAIN, register_loader
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.memory import Array


@register_loader("ensemble")
class EnsembleLoader(FullBatchLoader):
    """Dataset = stacked member outputs (reference ``EnsembleLoader``,
    ``loader/ensemble.py:94-131``). Sample shape is (n_models, dim);
    ``testing=True`` serves TEST instead of TRAIN."""

    def __init__(self, workflow, **kwargs):
        self.file = kwargs.pop("file")
        self.testing = kwargs.pop("testing", False)
        super().__init__(workflow, **kwargs)

    def load_data(self):
        with open(self.file, "r") as fin:
            data = json.load(fin)
        models = data["models"]
        if not models:
            raise ValueError("%s: no models in %s" % (self.name, self.file))
        reference_labels = list(models[0].get("Labels") or [])
        outputs = []
        for model in models:
            out = numpy.asarray(model["Output"], numpy.float32)
            if outputs and out.shape != outputs[0].shape:
                raise ValueError(
                    "model %s output shape %s != %s"
                    % (model.get("id"), out.shape, outputs[0].shape))
            labels = list(model.get("Labels") or [])
            if labels and reference_labels and labels != reference_labels:
                if len(labels) != len(reference_labels):
                    raise ValueError(
                        "model %s has incompatible labels" % model.get("id"))
                # remap columns into the first model's label order
                self.warning("model %s: remapping label order",
                             model.get("id"))
                order = [labels.index(l) for l in reference_labels]
                out = out[:, order]
            outputs.append(out)
        stacked = numpy.stack(outputs, axis=1)  # (samples, models, dim)
        self._provided_data = stacked
        winners = data.get("winners")
        if winners is not None and not self.testing:
            if reference_labels:
                mapping = {l: i for i, l in enumerate(reference_labels)}
                winners = [mapping.get(w, w) for w in winners]
            self._provided_labels = numpy.asarray(winners)
        klass = TEST if self.testing else TRAIN
        lengths = [0, 0, 0]
        lengths[klass] = len(stacked)
        self._provided_lengths = lengths
        super().load_data()


def _host(value):
    """An Array's, a tensor's or an array's values as a numpy array (a
    device tensor is copied to the host)."""
    if isinstance(value, Array):
        value = value.data
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.is_floating_point():
            value = value.float()
        value = value.cpu().numpy()
    return numpy.asarray(value)


class OutputDumper(Unit):
    """Accumulates per-sample model outputs over an epoch and emits a
    models-JSON entry (the producer side of the combiner; plays the role
    of the reference's ensemble results collection,
    ``ensemble/test_workflow.py:50-107``).

    Link after the evaluator: ``dumper.link_attrs(evaluator, "output")``
    and ``dumper.link_attrs(loader, "minibatch_indices",
    "minibatch_valid_size", "minibatch_class")``."""

    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow, **kwargs):
        self.klass = kwargs.pop("klass", TRAIN)
        self.model_id = kwargs.pop("model_id", "model")
        super().__init__(workflow, **kwargs)
        self.rows = {}
        self.demand("output", "minibatch_indices", "minibatch_valid_size",
                    "minibatch_class")

    def wire(self, workflow):
        """Wire into a StandardWorkflow-shaped graph IN the control
        chain: evaluator → dumper → decision (AND-gated), so the next
        tick cannot serve a new minibatch while we are still reading this
        one. A leaf link (evaluator → dumper only) races the repeater
        loop — the dumper would read the NEXT tick's loader state."""
        self.link_attrs(workflow.forwards[-1], "output")
        self.link_attrs(workflow.loader, "minibatch_indices",
                        "minibatch_valid_size", "minibatch_class")
        self.link_from(workflow.evaluator)
        workflow.decision.link_from(self)
        return self

    def run(self):
        if self.minibatch_class != self.klass:
            return
        out = _host(self.output)
        idx = _host(self.minibatch_indices)
        for i in range(int(self.minibatch_valid_size)):
            self.rows[int(idx[i])] = out[i].tolist()

    def entry(self, labels=None):
        """models-JSON entry with rows ordered by sample index."""
        ordered = [self.rows[k] for k in sorted(self.rows)]
        return {"id": self.model_id, "Output": ordered,
                "Labels": list(labels or [])}


def build_combiner_file(entries, winners, path):
    """Assemble the models-JSON the EnsembleLoader consumes."""
    with open(path, "w") as fout:
        json.dump({"models": list(entries),
                   "winners": list(winners)}, fout)
    return path
