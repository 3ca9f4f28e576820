"""Launcher: the process runner of a standalone run.

The port of ``veles_tpu/launcher.py:33-290`` (reference
``veles/launcher.py``) in standalone mode: the launcher owns the thread
pool the workflow's units run on, builds the configured mesh into the
workflow (``--mesh`` / ``root.common.mesh.axes``, ``parallel/mesh.py``:
the data-parallel fused tick, one process per device), starts the
dashboards — the GraphicsServer that renders the workflow's plotters
(``plotting/``) and the StatusNotifier that pushes to a WebStatusServer
(``web_status.py``, ``root.common.web.enabled``) — on the primary process
(rank 0) only, initializes and runs the workflow, writes the
``--result-file`` (rank 0 only) and shuts it all down. The JAX launcher
starts its GraphicsServer for every run; this one starts it where the
workflow holds a plotter, because the card's host has no matplotlib.
The master and slave modes, their node spawning and
``discover_yarn_nodes`` belong to the fleet, a later slice of the port
(ROADMAP A9): asking for them raises ``NotImplementedError``.
"""

import json
import threading

from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.executor import ThreadPool
from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.parallel.mesh import (build_mesh, is_primary,
                                           mesh_configured)

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
        self.graphics_server = None
        self.status_notifier = None
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
        primary = is_primary()
        if not root.common.disable.get("plotting", False) and primary \
                and self._has_plotters():
            from veles_tpu_torch.plotting.server import GraphicsServer
            self.graphics_server = GraphicsServer()
        if root.common.web.get("enabled", False) and primary:
            from veles_tpu_torch.web_status import StatusNotifier
            self.status_notifier = StatusNotifier(self).start()
        if mesh_configured():
            self._build_mesh()
        self.workflow.initialize(**kwargs)
        return self

    def _has_plotters(self):
        from veles_tpu_torch.plotting.units import Plotter
        return any(isinstance(unit, Plotter)
                   for unit in getattr(self.workflow, "units", ()))

    def _build_mesh(self):
        """Build the configured mesh into the workflow before it
        initializes (the fused-tick splice reads it there). A workflow
        supports a mesh when it carries the ``mesh_`` slot — or, after a
        snapshot resume, a fused tick (``mesh_`` is not pickled)."""
        wf = self.workflow
        if not (hasattr(wf, "mesh_") or hasattr(wf, "fused_tick")):
            self.warning("a device mesh is configured but %s has no mesh "
                         "support — the mesh is ignored", type(wf).__name__)
            return
        if getattr(wf, "mesh_", None) is not None:
            return
        mesh = build_mesh()
        wf.mesh_ = mesh
        tick = getattr(wf, "fused_tick", None)
        if tick is not None:
            # resumed snapshot: the tick builds its steps at initialize
            tick.mesh_ = mesh
        self.info("pod mode: %s, rank %d", mesh, mesh.rank)

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
        if self.status_notifier is not None:
            self.status_notifier.stop()
        if self.graphics_server is not None:
            self.graphics_server.flush()
            self.graphics_server.shutdown()
        self.thread_pool.shutdown()
        self._finished.set()

    # -- results (reference --result-file) ------------------------------------
    def _write_results(self):
        if not self.result_file or not is_primary():
            return  # one result file per world, owned by rank 0
        results = self.workflow.gather_results()
        with open(self.result_file, "w") as fout:
            json.dump(results, fout, indent=1, default=str)
        self.info("results written to %s", self.result_file)
