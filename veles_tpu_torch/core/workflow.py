"""Workflow: a container Unit holding the dataflow graph.

The port's copy of ``veles_tpu/core/workflow.py`` (reference
``veles/workflow.py``), with the ``workflow.run`` span framing the
units' ``unit.run`` spans while the tracer is on, and the flight
recorder's ``unit_exception`` dump in :meth:`Workflow.on_error`
(``observe/``). A Workflow owns the
unit graph between its auto-created StartPoint and EndPoint, initializes
units in dependency order with partial-init retry, runs the event-driven hot
loop, aggregates fleet-mode job/update payloads across units in dependency
order, gathers IResultProvider metrics, renders the graph as DOT, and
reports per-unit timing statistics.

The distributed aggregation contract mirrors reference
``workflow.py:474-611``: a *job* is the list of every unit's
``generate_data_for_slave`` payload (for the Loader that is just minibatch
indices); an *update* is the list of every unit's
``generate_data_for_master`` payload, merged back by
``apply_data_from_slave``. ``False``-valued readiness answers trigger
backpressure; exhaustion raises NoMoreJobsError.
"""

import hashlib
import inspect
import threading
import time

from veles_tpu_torch.core.errors import NoMoreJobsError, VelesError
from veles_tpu_torch.core.executor import ThreadPool
from veles_tpu_torch.core.plumbing import EndPoint, StartPoint
from veles_tpu_torch.core.units import Container, Unit
from veles_tpu_torch.observe.tracing import get_tracer


class Workflow(Container):
    """The workflow graph container (reference ``workflow.py:83``)."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self._units = []
        self._sync_event_ = threading.Event()
        super().__init__(workflow, **kwargs)
        self.start_point = StartPoint(self)
        self.end_point = EndPoint(self)
        self._finished = False
        self._no_more_jobs = False
        self.run_time = 0.0
        self._run_start = None
        self.result_file = kwargs.get("result_file", None)
        self._job_callback_ = None

    def init_unpickled(self):
        super().init_unpickled()
        self._sync_event_ = threading.Event()
        self._job_callback_ = None
        self._job_in_flight_ = False
        self._restored_from_snapshot_ = False
        # a mid-run snapshot pickles a live _run_start; that stamp is
        # another process's perf_counter epoch — meaningless after resume
        self._run_start = None

    def __getstate__(self):
        state = super().__getstate__()
        if not isinstance(self._workflow, Unit):
            # the top-level workflow's parent is the launcher (live threads,
            # sockets) — snapshots never carry it; the resume path
            # re-parents via ``workflow.workflow = launcher``
            # (reference __main__.py:616)
            state["_workflow"] = None
        return state

    # -- containment ---------------------------------------------------------
    def add_ref(self, unit):
        if unit is not self and unit not in self._units:
            self._units.append(unit)

    def del_ref(self, unit):
        if unit in self._units:
            self._units.remove(unit)

    def change_unit(self, old, new):
        """Live graph surgery (reference ``workflow.py:973``): replace
        ``old`` with ``new`` in the control graph. All inbound and
        outbound control links move to ``new``, ``old`` keeps its data
        and leaves the graph (it stays in the container until
        ``del_ref``). Gates move too — workflow-assigned control Bools
        keep gating the successor. Quiesce the workflow first (pause
        between ticks / hold ``old``'s run lock) when swapping mid-run;
        data links are the caller's to re-wire (``link_attrs``).

        ``old`` may be a unit or a unit name."""
        if isinstance(old, str):
            old = self[old]
        if new.workflow is not self:
            new.workflow = self
        for provider in list(old.links_from):
            new.link_from(provider)
        for consumer in list(old.links_to):
            consumer.link_from(new)
        old.unlink_all()
        new.gate_block = old.gate_block
        new.gate_skip = old.gate_skip
        new.ignores_gate = old.ignores_gate
        self.info("change_unit: %s -> %s", old.name, new.name)
        return new

    @property
    def units(self):
        return list(self._units)

    def __getitem__(self, name):
        for unit in self._units:
            if unit.name == name:
                return unit
        raise KeyError(name)

    def __iter__(self):
        return iter(self._units)

    def __len__(self):
        return len(self._units)

    # -- mode flags come from the parent (launcher or outer workflow) --------
    @property
    def is_standalone(self):
        return self.workflow.is_standalone

    @property
    def is_master(self):
        return self.workflow.is_master

    @property
    def is_slave(self):
        return self.workflow.is_slave

    @property
    def thread_pool(self):
        pool = getattr(self.workflow, "thread_pool", None)
        if pool is None:
            pool = getattr(self, "_own_pool_", None)
            if pool is None:
                pool = self._own_pool_ = ThreadPool(name=self.name)
        if self.on_error not in pool.failure_callbacks:
            pool.failure_callbacks.append(self.on_error)
        return pool

    @property
    def restored_from_snapshot(self):
        return getattr(self, "_restored_from_snapshot_", False)

    # -- dependency order -----------------------------------------------------
    def units_in_dependency_order(self):
        """BFS from the StartPoint over control links, each unit once;
        unlinked units follow in insertion order (reference
        ``workflow.py:474-507`` iterates the same way for job payloads)."""
        seen = {self.start_point}
        order = [self.start_point]
        frontier = [self.start_point]
        while frontier:
            nxt = []
            for unit in frontier:
                for consumer in unit.links_to:
                    if consumer not in seen:
                        seen.add(consumer)
                        order.append(consumer)
                        nxt.append(consumer)
            frontier = nxt
        for unit in self._units:
            if unit not in seen:
                seen.add(unit)
                order.append(unit)
        return order

    # -- lifecycle ------------------------------------------------------------
    def initialize(self, **kwargs):
        """Initialize units in dependency order, re-queueing partial
        initializers (reference ``workflow.py:299-345``). Every unit is
        interface-verified first — IUnit always, IDistributable when the
        run is not standalone (reference ``verified.py:36-66`` +
        ``workflow.py:322`` semantics)."""
        from veles_tpu_torch.core.verified import (IDISTRIBUTABLE, IUNIT,
                                             verify_interface)
        for unit in self._units:
            verify_interface(unit, IUNIT, "IUnit")
            if not self.is_standalone:
                verify_interface(unit, IDISTRIBUTABLE, "IDistributable")
        queue = self.units_in_dependency_order()
        max_rounds = len(queue) + 1
        for _ in range(max_rounds):
            retry = []
            for unit in queue:
                if unit._initialize_wrapper(**kwargs):
                    retry.append(unit)
            if not retry:
                break
            if len(retry) == len(queue):
                raise VelesError(
                    "Deadlocked initialization: %s could not initialize"
                    % ", ".join(u.name for u in retry))
            queue = retry
        else:
            raise VelesError("Initialization did not converge")
        self._initialized = True
        self._finished = False
        self._no_more_jobs = False
        return self

    def run(self):
        """Fire the StartPoint and block until the EndPoint finishes the
        workflow (reference ``workflow.py:347-365``)."""
        self._sync_event_.clear()
        self._sync_error_ = None
        self._finished = False
        self.thread_pool  # ensure failure routing is wired
        for unit in self._units:
            unit.stopped = False
            unit._pending_runs_ = 0  # stale tokens from a previous run
        self.stopped = False
        self._run_start = time.perf_counter()
        self.event("workflow run", "begin", workflow=self.name)
        # the traced twin of the begin/end pair: trace ids and monotonic
        # stamps, so the run frames the unit.run spans in a Chrome trace
        with get_tracer().span("workflow.run", workflow=self.name):
            self.start_point.run_dependent()
            self._sync_event_.wait()
            # quiesce: finish is signalled by the EndPoint, but sibling
            # units may still be running on pool threads — don't return
            # to the caller until every run() is out of flight
            for unit in self._units:
                lock = getattr(unit, "_run_lock_", None)
                if lock is not None:
                    with lock:
                        pass
        self.event("workflow run", "end", workflow=self.name)
        if self._sync_error_ is not None:
            exc, tb = self._sync_error_
            raise exc
        return self

    _sync_error_ = None

    def on_error(self, exc, tb):
        """Worker exception: stop everything (reference thread-pool errback
        semantics, ``thread_pool.py:59-68``). The flight recorder dumps
        its black box first: an unhandled unit exception is the moment
        the last spans and dispatches are worth keeping."""
        self._sync_error_ = (exc, tb)
        from veles_tpu_torch.observe.flight import get_flight_recorder
        get_flight_recorder().dump(
            "unit_exception",
            extra={"error": repr(exc), "workflow": self.name})
        self.on_workflow_finished()

    def on_workflow_finished(self):
        if self._finished:
            return
        self._finished = True
        self._sync_error_ = getattr(self, "_sync_error_", None)
        if self._run_start is not None:
            self.run_time += time.perf_counter() - self._run_start
            self._run_start = None
        for unit in self._units:
            unit.stopped = True
            try:
                unit.stop()
            except Exception:
                self.exception("%s.stop() failed", unit.name)
        self.stopped = True
        callback = self._job_callback_
        in_job, self._job_in_flight_ = self._job_in_flight_, False
        if callback is not None and self._sync_error_ is None:
            # slave: one JOB finished, not the training — ship the update
            # and do NOT tell the launcher to shut down (that made a CLI
            # slave exit after its first job; reference workflow.py:393-396
            # routes to exactly one of the two). A job that ERRORED must
            # never masquerade as a successful update — fall through to
            # the shutdown path instead.
            self._job_callback_ = None
            callback(self.generate_data_for_master())
        elif in_job and self._sync_error_ is None:
            pass  # a pod follower's job: no update and no shutdown
        else:
            parent = self.workflow
            if parent is not None and hasattr(parent,
                                              "on_workflow_finished"):
                parent.on_workflow_finished()
        self._sync_event_.set()

    def stop(self):
        self.on_workflow_finished()

    # -- distributed aggregation (reference workflow.py:474-611) -------------
    @property
    def has_data_for_slave(self):
        return all(u.has_data_for_slave for u in self._units)

    def has_more_jobs(self):
        return not self._no_more_jobs

    def distribution_order(self):
        """Unit order for job/update payload lists: CONSTRUCTION order, not
        link order — the slave rewires its control links (one-tick graph),
        but both sides build units in the same sequence, so indices align.
        EPHEMERAL engine splices (FusedTick/FusedSegment) are excluded:
        they exist on one side only (e.g. a pod slave under a graph-mode
        master) and carry no distributable state of their own.
        """
        return [u for u in self._units
                if not getattr(u, "EPHEMERAL", False)]

    def generate_data_for_slave(self, slave=None):
        """Collect per-unit job payloads. Returns the payload list,
        ``False`` if some unit isn't ready (backpressure), or ``None`` when
        there are no more jobs."""
        if self._no_more_jobs:
            return None
        order = self.distribution_order()
        if not all(u.has_data_for_slave for u in order):
            return False
        data = []
        try:
            for unit in order:
                data.append(unit.generate_data_for_slave(slave))
        except NoMoreJobsError:
            self._no_more_jobs = True
            return None
        return data

    def apply_data_from_master(self, data):
        order = self.distribution_order()
        if len(data) != len(order):
            raise VelesError(
                "Job payload has %d entries for %d units — master/slave "
                "workflow mismatch" % (len(data), len(order)))
        for unit, payload in zip(order, data):
            if payload is not None:
                unit.apply_data_from_master(payload)

    def generate_data_for_master(self):
        return [u.generate_data_for_master()
                for u in self.distribution_order()]

    def apply_data_from_slave(self, data, slave=None):
        order = self.distribution_order()
        if len(data) != len(order):
            raise VelesError(
                "Update payload has %d entries for %d units — master/slave "
                "workflow mismatch" % (len(data), len(order)))
        for unit, payload in zip(order, data):
            if payload is not None:
                unit.lock_data()
                try:
                    unit.apply_data_from_slave(payload, slave)
                finally:
                    unit.unlock_data()
        return True

    def drop_slave(self, slave=None):
        for unit in self._units:
            unit.drop_slave(slave)

    def generate_initial_data_for_slave(self, slave=None):
        # the handshake hook defaults to generate_data_for_slave, so
        # pre-existing negotiating units are unchanged; control-plane
        # units (GradientDescent) override it to ship their FULL state
        # once while the per-job payload omits weights
        return [u.generate_handshake_data(slave)
                for u in self._units if u.negotiates_on_connect]

    def apply_initial_data_from_master(self, data):
        targets = [u for u in self._units if u.negotiates_on_connect]
        for unit, payload in zip(targets, data):
            if payload is not None:
                unit.apply_data_from_master(payload)

    # -- control-plane fleet (docs/compiler_fleet.md) -------------------------
    def take_fence_sync(self):
        """Slave side, control-plane mode: after a job that ended an
        epoch, collect the bulk weight-sync payload (per-unit
        ``generate_sync_for_master``) the client ships in a ``sync``
        frame. ``None`` between fences (or when no unit carries
        distributable weights)."""
        loader = getattr(self, "loader", None)
        if loader is None or not bool(getattr(loader, "epoch_ended",
                                              False)):
            return None
        payload = [u.generate_sync_for_master()
                   for u in self.distribution_order()]
        return payload if any(p is not None for p in payload) else None

    def apply_sync_from_slave(self, data, slave=None):
        """Master side: apply an epoch-fence weight sync. Always an
        OVERWRITE (the slave replica is canonical between fences —
        unlike per-job updates there is nothing meaningful to merge)."""
        order = self.distribution_order()
        if len(data) != len(order):
            raise VelesError(
                "Sync payload has %d entries for %d units — "
                "master/slave workflow mismatch" % (len(data),
                                                    len(order)))
        for unit, payload in zip(order, data):
            if payload is not None:
                unit.lock_data()
                try:
                    unit.apply_sync_from_slave(payload, slave)
                finally:
                    unit.unlock_data()
        return True

    def rollback_job(self):
        """Slave side, control-plane mode: undo the LAST job's local
        application (the master re-issued work whose update never
        arrived). Delegates to the fused tick's one-slot rollback;
        returns True when state was actually restored."""
        tick = getattr(self, "fused_tick", None)
        if tick is not None and hasattr(tick, "rollback_job"):
            return bool(tick.rollback_job())
        return False

    def do_job(self, data, callback=None):
        """Slave side: apply the job, run the whole graph locally, then call
        back with the update (reference ``workflow.py:554-569``). Without
        a callback (a pod follower, ``fleet/pod.py``) the job finishes
        without producing an update; ``_sync_event_`` marks its end."""
        self.apply_data_from_master(data)
        self._job_callback_ = callback
        self._job_in_flight_ = True
        for unit in self._units:
            unit.stopped = False
            unit._pending_runs_ = 0
        self.stopped = False
        self._finished = False
        self._sync_event_.clear()
        self._run_start = time.perf_counter()
        self.start_point.run_dependent()

    # -- results (reference workflow.py:823-845) ------------------------------
    def gather_results(self):
        results = {}
        for unit in [self] + self._units:
            names = getattr(unit, "get_metric_names", None)
            values = getattr(unit, "get_metric_values", None)
            if callable(names) and callable(values):
                metrics = dict(zip(names(), values()))
                results.update(metrics)
        return results

    def get_metric_names(self):
        return ["run_time", "units"]

    def get_metric_values(self):
        return [self.run_time, len(self._units)]

    # -- compatibility checksum (reference workflow.py:847-862) ---------------
    @property
    def checksum(self):
        try:
            source = inspect.getsourcefile(type(self))
            with open(source, "rb") as fin:
                payload = fin.read()
        except (OSError, TypeError):
            payload = type(self).__name__.encode()
        sha = hashlib.sha1(payload)
        # EPHEMERAL units (engine splices: FusedTick, FusedSegment) are
        # execution strategy, not topology — a pod slave whose tick is
        # fused must still checksum-match a graph-mode master
        sha.update(b"%d" % sum(
            1 for u in self._units
            if not getattr(u, "EPHEMERAL", False)))
        return sha.hexdigest()

    # -- graph rendering (reference workflow.py:624-750) ----------------------
    def generate_graph(self, with_data_links=True):
        """Render the unit DAG as Graphviz DOT text (no pydot dependency)."""
        lines = ["digraph %s {" % self.name.replace(" ", "_"),
                 '  rankdir=TB;',
                 '  node [shape=box, style=filled, fillcolor=lightgray];']
        ids = {}
        for i, unit in enumerate([self.start_point, self.end_point]
                                 + [u for u in self._units
                                    if u not in (self.start_point,
                                                 self.end_point)]):
            ids[unit] = "u%d" % i
            lines.append('  %s [label="%s\\n(%s)"];'
                         % (ids[unit], unit.name, type(unit).__name__))
        for unit in ids:
            for consumer in unit.links_to:
                if consumer in ids:
                    lines.append("  %s -> %s;" % (ids[unit], ids[consumer]))
        if with_data_links:
            for unit in ids:
                for key, value in list(unit.__dict__.items()):
                    if key.startswith("_linkable_") and value is not None \
                            and isinstance(value, tuple):
                        provider = value[0]
                        if provider in ids:
                            lines.append(
                                '  %s -> %s [style=dashed, color=blue];'
                                % (ids[provider], ids[unit]))
        lines.append("}")
        return "\n".join(lines)

    def graph_snapshot(self):
        """The unit DAG as plain JSON for the live dashboard
        (``web_status.py`` renders it as SVG — the reference pushed the
        same structure to its viz.js page, ``web_status.py:113-165``):
        ``{"nodes": [{id, label, cls, group, runs}], "edges": [[a,b]]}``
        with ``runs`` = the unit's run_calls counter, so the viewer can
        highlight activity between refreshes."""
        units = [self.start_point, self.end_point] + [
            u for u in self._units
            if u not in (self.start_point, self.end_point)]
        ids = {unit: "u%d" % i for i, unit in enumerate(units)}
        nodes = [{"id": ids[u], "label": u.name,
                  "cls": type(u).__name__,
                  "group": getattr(u, "view_group", "PLUMBING"),
                  "runs": getattr(u, "run_calls", 0)} for u in units]
        edges = [[ids[u], ids[c]] for u in units
                 for c in u.links_to if c in ids]
        return {"nodes": nodes, "edges": edges}

    # -- stats (reference workflow.py:425-450, 763-821) -----------------------
    def print_stats(self, top=5):
        stats = []
        for unit in self._units:
            timer = unit.timers.get("run")
            if timer is not None and timer.calls:
                stats.append((timer.total, timer.calls, unit.name))
        stats.sort(reverse=True)
        self.info("Run time: %.3f s; top units:", self.run_time)
        for total, calls, name in stats[:top]:
            self.info("  %-30s %8.3f s  (%d calls, %.3f ms/call)",
                      name, total, calls, 1000 * total / calls)
        return stats
