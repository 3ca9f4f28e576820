"""Ensemble train/test runners (reference ``ensemble/model_workflow.py`` /
``test_workflow.py``), the port of ``veles_tpu/ensemble/runner.py``: a
``python -m veles_tpu_torch`` subprocess per instance, with ``--device``
passed through (a child started on the card runs on the card), and the
metrics and snapshot paths gathered into an ensemble JSON."""

import json
import os
import subprocess
import sys
import tempfile

from veles_tpu_torch.core import prng
from veles_tpu_torch.core.logger import Logger


class EnsembleTrainer(Logger):
    """Train N instances (reference ``--ensemble-train N:r``)."""

    def __init__(self, workflow_file, config_file=None, instances=4,
                 train_ratio=0.8, output="ensemble.json", extra_args=(),
                 max_parallel=2, device="cuda", overrides=()):
        super().__init__(logger_name="EnsembleTrainer")
        self.workflow_file = workflow_file
        self.config_file = config_file
        self.instances = instances
        self.train_ratio = train_ratio
        self.output = output
        self.extra_args = ["--device", device] + list(extra_args)
        #: root.path=value strings every instance takes after the config
        self.overrides = list(overrides)
        self.max_parallel = max_parallel

    def run(self):
        rng = prng.get("ensemble")
        jobs = []
        for index in range(self.instances):
            fd, result_file = tempfile.mkstemp(suffix=".json",
                                               prefix="ensemble_")
            os.close(fd)
            seed = int(rng.randint(1, 2 ** 31))
            cmd = [sys.executable, "-m", "veles_tpu_torch",
                   self.workflow_file,
                   self.config_file or "-"] + self.overrides + [
                   "--result-file", result_file,
                   "--seed", str(seed),
                   "--train-ratio", str(self.train_ratio)]
            cmd += self.extra_args
            jobs.append({"index": index, "seed": seed,
                         "result_file": result_file, "cmd": cmd})

        results = []
        running = []

        def harvest():
            nonlocal running
            job, proc = running.pop(0)
            proc.wait()
            entry = {"index": job["index"], "seed": job["seed"],
                     "returncode": proc.returncode}
            if proc.returncode == 0:
                with open(job["result_file"]) as fin:
                    entry["results"] = json.load(fin)
            else:
                self.warning("instance %d failed (rc=%d)", job["index"],
                             proc.returncode)
            os.unlink(job["result_file"])
            results.append(entry)

        for job in jobs:
            while len(running) >= self.max_parallel:
                harvest()
            self.info("training instance %d (seed=%d)", job["index"],
                      job["seed"])
            running.append((job, subprocess.Popen(
                job["cmd"], stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)))
        while running:
            harvest()

        payload = {"workflow": self.workflow_file,
                   "train_ratio": self.train_ratio,
                   "instances": results}
        with open(self.output, "w") as fout:
            json.dump(payload, fout, indent=1, default=str)
        self.info("ensemble summary written to %s", self.output)
        return payload


class EnsembleTester(Logger):
    """Re-evaluate stored ensemble snapshots (reference
    ``--ensemble-test``)."""

    def __init__(self, ensemble_file, workflow_file=None, config_file=None,
                 extra_args=(), device="cuda", overrides=()):
        super().__init__(logger_name="EnsembleTester")
        self.ensemble_file = ensemble_file
        self.workflow_file = workflow_file
        self.config_file = config_file
        self.extra_args = ["--device", device] + list(extra_args)
        self.overrides = list(overrides)

    def run(self):
        with open(self.ensemble_file) as fin:
            ensemble = json.load(fin)
        workflow_file = self.workflow_file or ensemble["workflow"]
        outputs = []
        for entry in ensemble["instances"]:
            snapshot = (entry.get("results") or {}).get("Snapshot")
            if not snapshot or not os.path.exists(str(snapshot)):
                self.warning("instance %d has no snapshot; skipping",
                             entry["index"])
                continue
            fd, result_file = tempfile.mkstemp(suffix=".json",
                                               prefix="enstest_")
            os.close(fd)
            cmd = [sys.executable, "-m", "veles_tpu_torch", workflow_file,
                   self.config_file or "-"] + self.overrides + [
                   "-w", str(snapshot),
                   "--result-file", result_file] + self.extra_args
            proc = subprocess.run(cmd, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL)
            entry_out = {"index": entry["index"],
                         "returncode": proc.returncode}
            if proc.returncode == 0:
                with open(result_file) as fin:
                    entry_out["results"] = json.load(fin)
            os.unlink(result_file)
            outputs.append(entry_out)
        return {"ensemble": self.ensemble_file, "tests": outputs}
