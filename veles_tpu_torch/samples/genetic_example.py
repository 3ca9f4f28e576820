"""GeneticExample: the reference's GA demo sample
(``veles/samples/GeneticExample/genetics.py``: a one-unit fitness
workflow driven by ``--optimize``), the port's copy of
``samples/GeneticExample/genetic_example.py``. The fitness is host
arithmetic: nothing here touches the card, so ``--device cpu`` runs it
anywhere.

The Optimizer unit computes a fitness from two config knobs wrapped in
``Range`` (see ``genetic_config.py``); the GA spawns a full run per
chromosome and reads ``EvaluationFitness`` from the result file.

Run:  python -m veles_tpu_torch veles_tpu_torch/samples/genetic_example.py \\
          veles_tpu_torch/samples/genetic_config.py --optimize 20:10 \\
          --device cpu
"""

from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.core.workflow import Workflow


class Optimizer(Unit):
    """Computes the fitness value (reference ``genetics.py`` Optimizer)."""

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.fitness = 0.0

    def initialize(self, **kwargs):
        pass

    def run(self):
        x = root.test.x
        y = root.test.y
        value = (x - 0.33) ** 2 * (y - 0.27) ** 2
        # positive and maximized at the optimum: roulette selection is
        # fitness-proportionate, so a negative fitness (the reference
        # sample returned -value) would clamp to ~0 and remove all
        # selection pressure
        self.fitness = 1.0 / (1.0 + value)

    def get_metric_names(self):
        return ["EvaluationFitness"]

    def get_metric_values(self):
        return [self.fitness]


class TestWorkflow(Workflow):
    """One run of fitness computation."""

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.optimizer = Optimizer(self)
        self.optimizer.link_from(self.start_point)
        self.end_point.link_from(self.optimizer)


def run(load, main):
    load(TestWorkflow)
    main()
