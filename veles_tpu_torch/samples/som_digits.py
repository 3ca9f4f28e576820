"""Kohonen SOM over the 8x8 UCI digits — self-contained sample.

Run: ``python -m veles_tpu_torch veles_tpu_torch/samples/som_digits.py
[--device cpu]``
Optional config values: ``root.som.shape`` (grid), ``root.som.epochs``.

The port's copy of ``samples/som_digits.py``; it reads the committed
digits (``parity.read_digits``) in the file's own order, as
``load_digits`` gives them.
"""

import numpy

from veles_tpu_torch.core.config import root
from veles_tpu_torch.models.kohonen import KohonenWorkflow
from veles_tpu_torch.parity import read_digits


def run(load, main):
    pixels, _ = read_digits()
    data = (pixels / 16.0).astype(numpy.float32)
    shape = tuple(root.som.get("shape", (8, 8)))
    load(KohonenWorkflow,
         shape=shape,
         loader_kwargs=dict(data=data,
                            class_lengths=[0, 0, len(data)],
                            minibatch_size=256),
         max_epochs=int(root.som.get("epochs", 10)))
    main()
