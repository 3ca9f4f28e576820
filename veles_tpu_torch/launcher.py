"""Launcher: the process runner of standalone, master and slave runs.

The port of ``veles_tpu/launcher.py:33-290`` (reference
``veles/launcher.py``). The mode follows the CLI contract
(``launcher.py:333-342``): ``listen_address`` makes a fleet master,
``master_address`` a slave, neither a standalone run. The launcher owns
the thread pool the workflow's units run on, builds the configured mesh
into a standalone workflow (``--mesh`` / ``root.common.mesh.axes``,
``parallel/mesh.py``: the data-parallel fused tick, one process per
device), starts the dashboards — the GraphicsServer that renders the
workflow's plotters (``plotting/``) and the StatusNotifier that pushes to
a WebStatusServer (``web_status.py``, ``root.common.web.enabled``) — on
the primary process (rank 0) of a run that is not a slave, initializes
and runs the workflow, writes the ``--result-file`` (never on a slave)
and shuts it all down. The JAX launcher starts its GraphicsServer for
every run; this one starts it where the workflow holds a plotter,
because the card's host has no matplotlib.

A master starts the fleet ``Server`` after the workflow initializes and
spawns a slave on every ``--nodes`` host (``yarn://`` specs resolve
through :func:`discover_yarn_nodes`) through the respawn spawner, its
own argv turned into the slave's; a slave starts its ``Client`` in
:meth:`Launcher.run`. Either waits until the agent reports the job
stream done. A master with a mesh configured warns and ignores it
(``launcher.py:105-110``). A slave with a mesh builds it into its
workflow, as a standalone run does: the fleet x pod composition
(``launcher.py:111-140``, ``fleet/pod.py``). Its rank 0 alone starts the
``Client``, which hands each event on to the other ranks, and every other
rank starts a ``Follower``; where the slave's topology cannot run the
meshed fused tick, rank 0 runs a per-unit graph slave on its device and
the other ranks are released (exit 0). A follower that lost its world
makes :meth:`Launcher.run` raise.
"""

import json
import threading

from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.executor import ThreadPool
from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.parallel.mesh import (build_mesh, is_primary,
                                           mesh_configured)

def discover_yarn_nodes(rm_address, timeout=10.0):
    """Resolve a Hadoop/YARN ResourceManager address to the cluster's
    RUNNING node hostnames through its REST API (reference YARN
    discovery, ``launcher.py:887-906``)."""
    from urllib.request import urlopen

    url = "http://%s/ws/v1/cluster/nodes?states=RUNNING" % rm_address
    with urlopen(url, timeout=timeout) as resp:
        payload = json.load(resp)
    nodes = (payload.get("nodes") or {}).get("node") or []
    return [n["nodeHostName"] for n in nodes if n.get("nodeHostName")]


class Launcher(Logger):
    """Workflow process runner (reference ``launcher.py:100``)."""

    def __init__(self, listen_address=None, master_address=None,
                 result_file=None, slave_power=1.0, async_slave=False,
                 slave_death_probability=0.0, respawn=False, nodes=None,
                 chaos=None, **kwargs):
        super().__init__(logger_name="Launcher")
        self.respawn = respawn
        #: chaos-harness overrides, merged into root.common.fleet.chaos
        #: on a slave at initialize (fleet/chaos.py)
        self.chaos = dict(chaos or {})
        #: hosts to spawn slaves on at master startup (reference ``-n``)
        self.nodes = list(nodes or [])
        self.listen_address = listen_address
        self.master_address = master_address
        self.result_file = result_file
        self.slave_power = slave_power
        self.async_slave = async_slave
        self.slave_death_probability = slave_death_probability
        self.thread_pool = ThreadPool(name="launcher")
        self.workflow = None
        self.agent = None  # the fleet Server or Client
        self.graphics_server = None
        self.status_notifier = None
        self._units = []
        self._finished = threading.Event()
        self.stopped = False

    # -- mode flags (reference launcher.py:333-342) --------------------------
    @property
    def is_master(self):
        return self.listen_address is not None

    @property
    def is_slave(self):
        return self.master_address is not None

    @property
    def is_standalone(self):
        return not self.is_master and not self.is_slave

    @property
    def mode(self):
        return ("master" if self.is_master else
                "slave" if self.is_slave else "standalone")

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
        primary = is_primary() and not self.is_slave
        if not root.common.disable.get("plotting", False) and primary \
                and self._has_plotters():
            from veles_tpu_torch.plotting.server import GraphicsServer
            self.graphics_server = GraphicsServer()
        if root.common.web.get("enabled", False) and primary:
            from veles_tpu_torch.web_status import StatusNotifier
            self.status_notifier = StatusNotifier(self).start()
        if mesh_configured() and self.is_master:
            self.warning(
                "a device mesh is configured (--mesh / "
                "root.common.mesh.axes) but the master does not run the "
                "compute tick — the mesh is ignored here; configure it "
                "on the slaves (fleet x pod composition)")
        elif mesh_configured():
            self._build_mesh()
        self.workflow.initialize(**kwargs)
        if self.is_master:
            self._start_master()
        elif self.is_slave:
            self._start_slave()
        return self

    def _start_master(self):
        from veles_tpu_torch.fleet.server import Server
        from veles_tpu_torch.nn.gd import fleet_merge_mode
        fleet_merge_mode()  # fail fast on a merge-mode typo
        self.agent = Server(
            self.listen_address, self.workflow,
            job_timeout=root.common.fleet.get("job_timeout", 120.0),
            respawn=self.respawn)
        self.agent.on_finished = self._on_agent_finished
        self.agent.start()
        if self.nodes:
            self._launch_nodes()

    def _start_slave(self):
        mesh = getattr(self.workflow, "mesh_", None)
        pod = mesh is not None and mesh.size > 1
        fused = getattr(self.workflow, "fused_tick", None) is not None
        if pod and mesh.rank != 0:
            if not fused:
                # rank 0 runs the per-unit graph slave on its own device
                self.info("rank %d released: this slave's topology runs "
                          "no meshed tick", mesh.rank)
                self._finished.set()
                return
            from veles_tpu_torch.fleet.pod import Follower
            self.agent = Follower(self.workflow, group=mesh.group)
            self.agent.on_finished = self._on_agent_finished
            self.info("pod follower, rank %d of %d", mesh.rank, mesh.size)
            return
        if self.chaos:
            # launcher-level chaos knobs land in the config tree the
            # Client builds its ChaosMonkey from
            root.common.fleet.chaos.update(self.chaos)
        from veles_tpu_torch.fleet.client import Client
        leader = None
        if pod and fused:
            from veles_tpu_torch.fleet.pod import PodLeader
            leader = PodLeader(group=mesh.group)
        self.agent = Client(
            self.master_address, self.workflow,
            power=self.slave_power, async_mode=self.async_slave,
            death_probability=self.slave_death_probability,
            enable_respawn=self.respawn,
            max_reconnect_attempts=root.common.fleet.get(
                "max_reconnect_attempts", 7), pod=leader)
        self.agent.on_finished = self._on_agent_finished

    def _launch_nodes(self):
        """Spawn a slave on every ``--nodes`` host at master startup
        (reference ``launcher.py:617-660``): this process's argv becomes
        the slave's (``-l``/``-n``/``--result-file``/``-b`` dropped in
        every form, ``-m <master>`` added) and runs through the respawn
        spawner: ssh for remote hosts, a detached subprocess locally."""
        import socket
        from veles_tpu_torch.fleet.respawn import (build_command,
                                                   default_spawner,
                                                   respawn_recipe,
                                                   spawn_env)

        recipe = respawn_recipe()
        host_part = self.agent.host
        if host_part in ("", "0.0.0.0", "::"):
            host_part = socket.gethostname()
        master = "%s:%d" % (host_part, self.agent.port)
        command = build_command(recipe["executable"],
                                slave_argv(recipe["argv"], master))
        env = spawn_env(recipe["pythonpath"]) or {}
        # secrets from the environment or an explicit argument do not
        # travel with the workflow source: forward them
        env.update(getattr(self.agent, "secret_spawn_env", dict)())
        for host in self._expand_node_specs(self.nodes):
            self.info("launching slave on %s", host)
            default_spawner(host, command, cwd=recipe["cwd"], env=env)

    def _expand_node_specs(self, specs):
        """``yarn://rm-host:port`` entries expand to the cluster's RUNNING
        nodes; plain hosts pass through. A failed discovery logs and
        skips the spec (the fleet is elastic)."""
        hosts = []
        for spec in specs:
            if spec.startswith("yarn://"):
                try:
                    found = discover_yarn_nodes(spec[len("yarn://"):])
                    self.info("yarn discovery %s: %d node(s)", spec,
                              len(found))
                    hosts.extend(found)
                except Exception as e:
                    self.warning("yarn discovery %s failed: %s", spec, e)
            else:
                hosts.append(spec)
        return hosts

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
        """Run the workflow to its end (standalone), or wait until the
        fleet agent reports the job stream done; then write the results.
        ``_finished`` is never cleared: the agent may finish before
        run() is called."""
        if self.is_standalone:
            self.workflow.run()
            self._write_results()
            return self
        if self.is_slave and self.agent is not None:
            self.agent.start()
        self._finished.wait()
        if hasattr(self.agent, "failure"):  # a pod follower
            self.agent.join()
            failure = self.agent.failure
            if failure is not None:
                raise RuntimeError("the pod follower stopped: %s: %s"
                                   % (type(failure).__name__, failure))
        self._write_results()
        return self

    def on_workflow_finished(self):
        """Called by the workflow's EndPoint chain."""
        self._finished.set()

    def _on_agent_finished(self):
        self._finished.set()

    def stop(self):
        if self.stopped:
            return
        self.stopped = True
        if self.agent is not None:
            self.agent.stop()
        if self.status_notifier is not None:
            self.status_notifier.stop()
        if self.graphics_server is not None:
            self.graphics_server.flush()
            self.graphics_server.shutdown()
        self.thread_pool.shutdown()
        self._finished.set()

    # -- results (reference --result-file) ------------------------------------
    def _write_results(self):
        if not self.result_file or self.is_slave or not is_primary():
            return  # one result file per world, owned by rank 0
        results = self.workflow.gather_results()
        with open(self.result_file, "w") as fout:
            json.dump(results, fout, indent=1, default=str)
        self.info("results written to %s", self.result_file)


#: master-only options dropped from the argv a spawned slave runs, with
#: their value (the master's ``--result-file`` belongs to the master)
_MASTER_ONLY = ("-l", "--listen", "-n", "--nodes", "--result-file")


def slave_argv(argv, master):
    """The master's argv turned into a slave's (``launcher.py:197-222``):
    ``-l``/``--listen``, ``-n``/``--nodes`` and ``--result-file`` go in
    their space-separated, ``=`` and fused (``-lVALUE``) forms, ``-b`` /
    ``--background`` goes (the spawner detaches), ``--respawn`` stays (the
    slave then ships its relaunch recipe), and ``-m <master>`` is
    appended."""
    out = []
    skip = False
    for arg in argv:
        if skip:
            skip = False
            continue
        if arg in _MASTER_ONLY:
            skip = True
            continue
        if arg.startswith(tuple(o + "=" for o in _MASTER_ONLY)) \
                or (arg[:2] in ("-l", "-n") and len(arg) > 2
                    and not arg.startswith("--")):
            continue
        if arg in ("-b", "--background"):
            continue
        out.append(arg)
    return out + ["-m", master]
