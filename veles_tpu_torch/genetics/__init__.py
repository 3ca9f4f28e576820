"""veles_tpu_torch.genetics: the GA hyperparameter search (reference
``veles/genetics/``), the port of ``veles_tpu/genetics/``.

Config values wrapped in :class:`Range` become genes; each chromosome is
a whole training run in a subprocess (``python -m veles_tpu_torch``, on
the card unless ``--device cpu`` is passed through) whose result file's
fitness drives selection, crossover and mutation. Evaluations run
``max_parallel`` local processes at a time, or as jobs of the fleet's
task farm (``--optimize-fleet``). The GA's draws come from the host
stream ``prng.get("genetics")``, numpy's PCG64 as in the JAX package, so
both packages evolve the same populations from the same seed.
"""

from veles_tpu_torch.genetics.config import (  # noqa: F401
    Range, fix_config, process_config)
from veles_tpu_torch.genetics.core import Chromosome, Population  # noqa: F401
from veles_tpu_torch.genetics.optimizer import GeneticsOptimizer  # noqa: F401
