"""InputJoiner: concatenate several minibatch tensors into one.

The port of ``veles_tpu/nn/joiner.py:21-72`` (reference
``veles/input_joiner.py:49-212``): the inputs' trailing dimensions are
flattened and joined along the sample axis by one ``torch.cat``, over the
rows all inputs have. ``offset_N``/``length_N`` (element offsets into the
joined sample) are published after ``initialize()``, as the reference
publishes them, so a unit downstream can slice its part back out.
"""

import torch

from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.memory import Array


class InputJoiner(Unit):
    """Joins N input Arrays along the sample axis (reference
    ``InputJoiner``, ``input_joiner.py:49``)."""

    def __init__(self, workflow, **kwargs):
        inputs = kwargs.pop("inputs", None)
        super().__init__(workflow, **kwargs)
        self.output = Array()
        self.inputs = list(inputs) if inputs else []

    @property
    def num_inputs(self):
        return len(self.inputs)

    def initialize(self, **kwargs):
        if not self.inputs:
            raise ValueError("%s: no inputs to join" % self.name)
        offset = 0
        for i, inp in enumerate(self.inputs):
            length = 1
            for dim in inp.shape[1:]:
                length *= dim
            setattr(self, "offset_%d" % i, offset)
            setattr(self, "length_%d" % i, length)
            offset += length

    def run(self):
        tensors = []
        for inp in self.inputs:
            value = inp.data if isinstance(inp, Array) else inp
            if value is None:
                raise ValueError("%s: empty input" % self.name)
            if not isinstance(value, torch.Tensor):
                value = torch.as_tensor(value)
            tensors.append(value)
        n = min(int(t.shape[0]) for t in tensors)
        self.output.data = torch.cat(
            [t[:n].reshape(n, -1) for t in tensors], dim=1)
