"""Sample workflow: MNIST784-topology MLP on the 8x8 UCI digits.

Run:  python -m veles_tpu_torch veles_tpu_torch/samples/digits_mlp.py \
      samples/digits_config.py  [--device cpu]

The module follows the reference workflow contract
(``docs: manualrst_veles_workflow_creation``): define ``run(load, main)``;
the framework calls ``load`` to build (or resume) the workflow and ``main``
to initialize + run it.

The port's copy of ``samples/digits_mlp.py``; it reads the committed
digits (``parity.digits_dataset``, the canonical permutation).
"""

from veles_tpu_torch.core.config import root
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.parity import digits_dataset

root.digits.update({
    "layers": [64, 10],
    "minibatch_size": 100,
    "learning_rate": 0.1,
    "max_epochs": 10,
    "validation_samples": 297,
})


def run(load, main):
    X, y = digits_dataset(flat=True)
    n_valid = root.digits.validation_samples
    load(MLPWorkflow,
         name="digits-mlp",
         layers=tuple(root.digits.layers),
         loader_kwargs=dict(
             data=X, labels=y,
             class_lengths=[0, n_valid, len(X) - n_valid],
             minibatch_size=root.digits.minibatch_size,
             normalization_type="linear"),
         learning_rate=root.digits.learning_rate,
         max_epochs=root.digits.max_epochs)
    main()
