"""GeneticsOptimizer: drives subprocess evaluations of chromosomes; the
port of ``veles_tpu/genetics/optimizer.py``.

Each evaluation is ``python -m veles_tpu_torch WORKFLOW CONFIG
overrides... --result-file F [--seed N] --device D``: a child started on
the card runs on the card (``device``, default ``"cuda"``, is passed
through; there is no CPU fallback).

Reference ``genetics/optimization_workflow.py:70-283``: each chromosome's
fitness comes from a FULL training run in a subprocess (pickled config +
result-file read-back). Kept here: the subprocess-per-evaluation contract
(CLI override strings instead of pickled configs — same layering),
generation loop with no-improvement early stop, and parallel evaluation
(a local process pool plays the slave-fleet role; fleet distribution hands
the same subprocess commands to slaves).

Fitness: the result JSON's ``EvaluationFitness`` if present, else
``-best_validation_errors`` (maximized either way).
"""

import json
import os
import subprocess
import sys
import tempfile

from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.genetics.core import Population


class GeneticsOptimizer(Logger):
    """Population-parallel hyperparameter search (reference
    ``GeneticsOptimizer``)."""

    def __init__(self, workflow_file, config_file=None, genes=(),
                 population_size=12, generations=5, max_parallel=2,
                 no_improvement_limit=3, extra_args=(), seed=None,
                 fleet=None, representation="numeric", device="cuda",
                 overrides=()):
        super().__init__(logger_name="GeneticsOptimizer")
        self.workflow_file = workflow_file
        self.config_file = config_file
        self.population = Population(list(genes), size=population_size,
                                     representation=representation)
        self.generations = generations
        self.max_parallel = max_parallel
        self.no_improvement_limit = no_improvement_limit
        self.extra_args = list(extra_args)
        #: root.path=value strings every child takes after the config
        #: file (the command line's own), before the chromosome's
        self.overrides = list(overrides)
        self.device = device
        self.seed = seed
        self.best_fitness_history = []
        #: every evaluated generation's members: [[(values, fitness),
        #: ...], ...] (what a replay of the population from its seed and
        #: these fitnesses must reproduce)
        self.populations = []
        # fleet mode (reference optimization_workflow.py:179-279):
        # chromosome evaluations are jobs served to fleet slaves
        self._farm = self._farm_server = None
        if fleet is not None:
            from veles_tpu_torch.fleet.farm import TaskFarmMaster
            from veles_tpu_torch.fleet.server import Server
            self._farm = TaskFarmMaster("genetics")
            self._farm_server = Server(fleet, self._farm).start()
            self._farm.on_new_tasks = self._farm_server.kick

    # -- one evaluation --------------------------------------------------------
    def _command(self, chromosome, result_file=None):
        cmd = [sys.executable, "-m", "veles_tpu_torch", self.workflow_file,
               self.config_file or "-"]
        cmd += self.overrides + chromosome.config_overrides()
        if result_file is not None:
            cmd += ["--result-file", result_file]
        if self.seed is not None:
            cmd += ["--seed", str(self.seed)]
        cmd += ["--device", self.device] + self.extra_args
        return cmd

    @staticmethod
    def fitness_from_results(results):
        if "EvaluationFitness" in results:
            return float(results["EvaluationFitness"])
        if results.get("best_validation_errors") is not None:
            return -float(results["best_validation_errors"])
        raise ValueError("result file carries neither EvaluationFitness "
                         "nor best_validation_errors")

    def _evaluate_fleet(self):
        """Submit the generation's evaluations to the task farm; fleet
        slaves run them (reference slaves evaluated chromosomes the same
        way, optimization_workflow.py:216-279)."""
        pending = [m for m in self.population.members
                   if m.fitness is None]
        tags = {}
        for i, member in enumerate(pending):
            task_id = "gen%d-%d" % (self.population.generation, i)
            tags[task_id] = member
            self._farm.submit(task_id, self._command(member))
        results = self._farm.wait_batch()
        self._farm.take_results()
        for task_id, member in tags.items():
            update = results.get(task_id, {})
            if update.get("rc") or "results" not in update:
                self.warning("fleet evaluation failed: %s", update)
                member.fitness = -1e30
            else:
                member.fitness = self.fitness_from_results(
                    update["results"])
                self.info("evaluated %s -> %.4f", member.values,
                          member.fitness)

    def evaluate_generation(self):
        """Run all unevaluated members, ``max_parallel`` at a time."""
        if self._farm is not None:
            return self._evaluate_fleet()
        pending = [m for m in self.population.members
                   if m.fitness is None]
        env = dict(os.environ)
        running = []  # (member, proc, result_file)

        def harvest(block):
            nonlocal running
            still = []
            for member, proc, result_file in running:
                if block:
                    proc.wait()
                if proc.poll() is None:
                    still.append((member, proc, result_file))
                    continue
                if proc.returncode != 0:
                    self.warning("evaluation failed (rc=%d): %s",
                                 proc.returncode, member)
                    member.fitness = -1e30
                else:
                    with open(result_file) as fin:
                        member.fitness = self.fitness_from_results(
                            json.load(fin))
                    self.info("evaluated %s -> %.4f", member.values,
                              member.fitness)
                os.unlink(result_file)
            running = still

        for member in pending:
            while len(running) >= self.max_parallel:
                harvest(block=True)
            fd, result_file = tempfile.mkstemp(suffix=".json",
                                               prefix="genetics_")
            os.close(fd)
            proc = subprocess.Popen(
                self._command(member, result_file), env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            running.append((member, proc, result_file))
        while running:
            harvest(block=True)

    # -- the optimization loop -------------------------------------------------
    def run(self):
        best_ever = None
        stale = 0
        try:
            for generation in range(self.generations):
                self.evaluate_generation()
                self.populations.append(
                    [(list(m.values), m.fitness)
                     for m in self.population.members])
                best = self.population.best
                self.best_fitness_history.append(best.fitness)
                self.info("generation %d best: %s fitness=%.4f",
                          generation, best.values, best.fitness)
                if best_ever is None or best.fitness > best_ever.fitness:
                    best_ever = best
                    stale = 0
                else:
                    stale += 1
                    if stale >= self.no_improvement_limit:
                        self.info("stopping: no improvement for %d "
                                  "generations", stale)
                        break
                if generation + 1 < self.generations:
                    self.population.evolve()
        finally:
            if self._farm is not None:
                self._farm.close()
                self._farm_server.kick()  # let idle slaves drain + exit
                self._farm_server.drain()  # 'no more jobs' must flush
                self._farm_server.stop()
        return best_ever
