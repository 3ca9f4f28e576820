"""Launcher: the process runner of a standalone run.

The port of ``veles_tpu/launcher.py:33-290`` (reference
``veles/launcher.py``) in standalone mode: the launcher owns the thread
pool the workflow's units run on, initializes and runs the workflow,
writes the ``--result-file`` and shuts the pool down. The master and
slave modes, their node spawning and ``discover_yarn_nodes`` belong to
the fleet, a later slice of the port (ROADMAP A9): asking for them
raises ``NotImplementedError``. The plotting server and the web status
notifier wait for the observe plane's dashboards (ROADMAP A7 (d)).
"""

import json
import threading

from veles_tpu_torch.core.executor import ThreadPool
from veles_tpu_torch.core.logger import Logger

_FLEET = "the fleet (master and slave modes) is a later slice of the " \
    "port (ROADMAP A9)"


def discover_yarn_nodes(rm_address, timeout=10.0):
    """The fleet's YARN node discovery: not ported (ROADMAP A9)."""
    raise NotImplementedError(_FLEET)


class Launcher(Logger):
    """Workflow process runner (reference ``launcher.py:100``), standalone
    only."""

    def __init__(self, listen_address=None, master_address=None,
                 result_file=None, nodes=None, **kwargs):
        super().__init__(logger_name="Launcher")
        if listen_address is not None or master_address is not None \
                or nodes:
            raise NotImplementedError(_FLEET)
        self.result_file = result_file
        self.thread_pool = ThreadPool(name="launcher")
        self.workflow = None
        self._units = []
        self._finished = threading.Event()
        self.stopped = False

    # -- mode flags (reference launcher.py:333-342) --------------------------
    is_master = False
    is_slave = False
    is_standalone = True
    mode = "standalone"

    # -- workflow containment -------------------------------------------------
    def add_ref(self, unit):
        self._units.append(unit)
        self.workflow = unit

    def del_ref(self, unit):
        if unit in self._units:
            self._units.remove(unit)

    # -- lifecycle ------------------------------------------------------------
    def initialize(self, **kwargs):
        if self.workflow is None:
            raise ValueError("no workflow attached to the launcher")
        self.info("launcher mode: %s", self.mode)
        self.workflow.initialize(**kwargs)
        return self

    def run(self):
        """Run the workflow to its end, then write the results."""
        self.workflow.run()
        self._write_results()
        return self

    def on_workflow_finished(self):
        """Called by the workflow's EndPoint chain."""
        self._finished.set()

    def stop(self):
        if self.stopped:
            return
        self.stopped = True
        self.thread_pool.shutdown()
        self._finished.set()

    # -- results (reference --result-file) ------------------------------------
    def _write_results(self):
        if not self.result_file:
            return
        results = self.workflow.gather_results()
        with open(self.result_file, "w") as fout:
            json.dump(results, fout, indent=1, default=str)
        self.info("results written to %s", self.result_file)
