"""Kohonen SOM over sklearn digits — self-contained sample.

Run: ``python -m veles_tpu_torch veles_tpu_torch/samples/som_digits.py
[--device cpu]``
Optional config values: ``root.som.shape`` (grid), ``root.som.epochs``.

The port's copy of ``samples/som_digits.py``; it needs sklearn's
digits data.
"""

import numpy

from veles_tpu_torch.core.config import root
from veles_tpu_torch.models.kohonen import KohonenWorkflow


def run(load, main):
    from sklearn.datasets import load_digits

    digits = load_digits()
    data = (digits.data / 16.0).astype(numpy.float32)
    shape = tuple(root.som.get("shape", (8, 8)))
    load(KohonenWorkflow,
         shape=shape,
         loader_kwargs=dict(data=data,
                            class_lengths=[0, 0, len(data)],
                            minibatch_size=256),
         max_epochs=int(root.som.get("epochs", 10)))
    main()
