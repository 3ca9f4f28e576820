"""Pickled-dataset loader.

The port of ``veles_tpu/loader/pickles.py`` (reference
``veles/loader/pickles.py:55-148``): each sample class is fed by a list of
pickle files; every pickle holds a ``(data, labels)`` tuple, a
``{"data": ..., "labels": ...}`` dict, or a bare sample array (no
labels). The per-class arrays are concatenated and handed to the
device-resident FullBatchLoader, so after loading the gather path is any
full-batch dataset's. ``reshape``/``transform_data`` are the reference's
subclass hooks (``pickles.py:79-84``). Unpickling runs code: load only
files this program or a trusted one wrote.
"""

import pickle

import numpy

from veles_tpu_torch.loader.base import register_loader
from veles_tpu_torch.loader.fullbatch import FullBatchLoader


@register_loader("pickles")
class PicklesLoader(FullBatchLoader):
    """Samples from per-class pickle file lists (reference
    ``PicklesLoader``, ``pickles.py:55``)."""

    def __init__(self, workflow, **kwargs):
        self.test_pickles = list(kwargs.pop("test_pickles", []))
        self.validation_pickles = list(kwargs.pop("validation_pickles", []))
        self.train_pickles = list(kwargs.pop("train_pickles", []))
        super().__init__(workflow, **kwargs)

    # -- extension hooks (reference pickles.py:79-84) -------------------------
    def reshape(self, shape):
        return shape

    def transform_data(self, data):
        return data

    @staticmethod
    def _split_payload(payload):
        if isinstance(payload, dict):
            return payload["data"], payload.get("labels")
        if isinstance(payload, (tuple, list)) and len(payload) == 2:
            return payload
        return payload, None

    def load_data(self):
        per_class_data, per_class_labels = [], []
        has_labels = None
        for pickles in (self.test_pickles, self.validation_pickles,
                        self.train_pickles):
            datas, labels = [], []
            for path in pickles:
                with open(path, "rb") as fin:
                    data, labs = self._split_payload(pickle.load(fin))
                if has_labels is not None \
                        and (labs is not None) != has_labels:
                    raise ValueError(
                        "%s: some pickles have labels and some do not"
                        % self.name)
                has_labels = labs is not None
                datas.append(self.transform_data(
                    numpy.asarray(data, numpy.float32)))
                if labs is not None:
                    labels.append(numpy.asarray(labs))
            per_class_data.append(
                numpy.concatenate(datas) if datas else None)
            per_class_labels.append(
                numpy.concatenate(labels) if labels else None)
        shapes = {d.shape[1:] for d in per_class_data if d is not None}
        if len(shapes) > 1:
            raise ValueError("%s: sample shapes differ between classes: %s"
                             % (self.name, sorted(shapes)))
        if not shapes:
            raise ValueError("%s: no pickles given" % self.name)
        lengths = [0 if d is None else len(d) for d in per_class_data]
        data = numpy.concatenate(
            [d for d in per_class_data if d is not None])
        shape = self.reshape(data.shape[1:])
        self._provided_data = data.reshape((len(data),) + tuple(shape))
        if has_labels:
            self._provided_labels = numpy.concatenate(
                [l for l in per_class_labels if l is not None])
        self._provided_lengths = lengths
        super().load_data()
