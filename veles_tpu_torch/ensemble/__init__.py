"""veles_tpu_torch.ensemble: train and test model ensembles (reference
``veles/ensemble/``), the port of ``veles_tpu/ensemble/``. Every instance
is a ``python -m veles_tpu_torch`` child, on the card unless ``--device
cpu`` is passed through.

``--ensemble-train N:r``: N independent trainings of the same workflow,
each a subprocess with ``--train-ratio r`` and a random seed, collecting
snapshots + metrics into one JSON (reference ``base_workflow.py:59-176``).
``--ensemble-test file``: re-runs each stored snapshot in evaluation mode,
collecting outputs for a downstream combiner model
(``test_workflow.py:50-107`` + ``loader/ensemble.py``).
"""

from veles_tpu_torch.ensemble.combiner import (  # noqa: F401
    EnsembleLoader, OutputDumper, build_combiner_file)
from veles_tpu_torch.ensemble.runner import (  # noqa: F401
    EnsembleTester, EnsembleTrainer)
