"""Unit: the node of the workflow dataflow graph.

The port's copy of ``veles_tpu/core/units.py`` (reference
``veles/units.py``), with the ``unit.run`` span around ``run()`` while
the tracer is on (``observe/tracing.py``). A Unit:

- fires successors through **control links** (``link_from``) guarded by the
  **gate protocol**: a unit runs when *all* incoming links have fired since
  its last run (AND-gate, reference ``units.py:524-543``), modulated by the
  ``gate_block`` (don't run, don't propagate) / ``gate_skip`` (don't run, do
  propagate) / ``ignores_gate`` Bools (reference ``units.py:139-141``);
- shares state through **data links** (``link_attrs``), which install
  pointer-semantics descriptors so consumers always read the provider's
  current value (reference ``units.py:638-656``) — essential here because
  producers rebind their outputs every tick;
- declares required inputs with ``demand()``, checked at initialize
  (reference ``units.py:682-699``);
- participates in fleet-mode distribution via the Distributable contract.

Execution is event-driven: ``run_dependent()`` notifies successors, fanning
out onto the workflow's thread pool with an inline fast path for a single
successor (reference ``units.py:485-505``). Re-entrant notifications while a
``run()`` is still in flight are dropped via a non-blocking run lock
(reference ``units.py:782-803``).
"""

import threading
import time
import uuid as uuid_module

from veles_tpu_torch.core.config import root, validate_kwargs
from veles_tpu_torch.core.distributable import Distributable
from veles_tpu_torch.core.errors import AttributeMissingError
from veles_tpu_torch.core.mutable import Bool, link as link_attr
from veles_tpu_torch.core.registry import UnitCommandLineArgumentsRegistry
from veles_tpu_torch.core.timing import Timer
from veles_tpu_torch.observe.tracing import get_tracer


class Unit(Distributable, metaclass=UnitCommandLineArgumentsRegistry):
    """Workflow graph node (reference ``units.py:108``)."""

    hide_from_registry = True

    #: Sweep-transparency contract (``parallel/sweep.py``): a host unit
    #: in the repeater cycle may declare True to promise its ``run()``
    #: never reads or writes device Array slots — pure host-side
    #: bookkeeping (counters, logging, triggers). The sweep fusion tier
    #: then scans the device chain over whole class sweeps and fires
    #: this unit once per tick between the scanned chunks; without the
    #: declaration the workflow stays on the per-tick segment tier,
    #: where the unit sees exact per-minibatch slot state.
    sweep_transparent = False

    def __init__(self, workflow, **kwargs):
        name = kwargs.pop("name", None)
        view_group = kwargs.pop("view_group", None)
        self._uuid = str(uuid_module.uuid4())
        super().__init__(**{k: v for k, v in kwargs.items()
                            if k == "logger_name"})
        validate_kwargs(self, **kwargs)
        type(self).check_kwargs(self.logger, **kwargs)
        self._name = name
        self.view_group = view_group or getattr(
            type(self), "VIEW_GROUP", "PLUMBING")
        self.links_from = {}   # provider Unit -> fired flag
        self.links_to = {}     # consumer Unit -> True
        self.gate_block = Bool(False)
        self.gate_skip = Bool(False)
        self.ignores_gate = Bool(False)
        # birth gates: lets the partial-fusion engine distinguish a
        # unit's untouched default gates from workflow-assigned control
        # Bools (identity comparison; pickling preserves the identity
        # through the memo table)
        self._born_gate_skip = self.gate_skip
        self._born_gate_block = self.gate_block
        self._demanded = []
        self._initialized = False
        self._stopped = False
        self.timers = {}
        self.run_calls = 0
        self._workflow = None
        self.workflow = workflow
        self.timings = kwargs.get("timings", root.common.get("timings", False))

    def init_unpickled(self):
        super().init_unpickled()
        self._gate_lock_ = threading.Lock()
        self._run_lock_ = threading.Lock()
        self._pending_runs_ = 0
        # a snapshot loaded in a fresh process carries link targets in the
        # instance dict, but the LinkableAttribute descriptors live on the
        # CLASS and were installed dynamically — reinstall them
        for key, value in list(self.__dict__.items()):
            if key.startswith("_linkable_") and isinstance(value, tuple):
                link_attr(self, key[len("_linkable_"):], value[0], value[1],
                          two_way=value[2])

    # -- identity -----------------------------------------------------------
    @property
    def id(self):
        return self._uuid

    @property
    def name(self):
        if self._name is not None:
            return self._name
        return type(self).__name__

    @name.setter
    def name(self, value):
        self._name = value

    def __repr__(self):
        return '<%s "%s">' % (type(self).__name__, self.name)

    # -- workflow containment -----------------------------------------------
    @property
    def workflow(self):
        return self._workflow

    @workflow.setter
    def workflow(self, value):
        if value is not None and self._workflow is not None:
            self._workflow.del_ref(self)
        self._workflow = value
        if value is not None:
            value.add_ref(self)

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
    def initialized(self):
        return self._initialized

    @property
    def stopped(self):
        return self._stopped

    @stopped.setter
    def stopped(self, value):
        self._stopped = value

    # -- control links ------------------------------------------------------
    def link_from(self, *providers):
        """Add control edges provider→self (reference ``units.py:554-568``).
        Cycles are legal — the Repeater closes the epoch loop — because gate
        flags, not recursion, drive execution."""
        for provider in providers:
            self.links_from[provider] = False
            provider.links_to[self] = True
        return self

    def unlink_from(self, *providers):
        for provider in providers:
            self.links_from.pop(provider, None)
            provider.links_to.pop(self, None)
        return self

    def unlink_all(self):
        for provider in list(self.links_from):
            self.unlink_from(provider)
        for consumer in list(self.links_to):
            consumer.unlink_from(self)
        return self

    # -- data links ----------------------------------------------------------
    def link_attrs(self, other, *names, two_way=False):
        """Link attributes so ``self.mine`` always reads ``other.theirs``
        (reference ``units.py:638-656``). Each name is a string or a
        ``(mine, theirs)`` tuple."""
        for name in names:
            if isinstance(name, tuple):
                mine, theirs = name
            else:
                mine = theirs = name
            link_attr(self, mine, other, theirs, two_way=two_way)
        return self

    def demand(self, *attrs):
        """Declare attributes that must be linked before initialize()
        (reference ``units.py:682-699``)."""
        self._demanded.extend(attrs)

    def verify_demands(self):
        missing = []
        for attr in self._demanded:
            # a live data link satisfies the demand even before the provider
            # has produced a value (reference units.py:682-699 checks
            # linkage, not current value)
            if self.__dict__.get("_linkable_%s" % attr) is not None:
                continue
            if not hasattr(self, attr) or getattr(self, attr) is None:
                missing.append(attr)
        if missing:
            raise AttributeMissingError(self, missing)

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, **kwargs):
        """Override in subclasses. Returning True means "couldn't fully
        initialize yet, retry after others" (reference ``workflow.py:299-345``
        re-queue semantics)."""
        return None

    def _initialize_wrapper(self, **kwargs):
        self.verify_demands()
        result = self.initialize(**kwargs)
        if not result:
            self._initialized = True
        return result

    def run(self):
        """Override in subclasses: the unit's work for one tick."""

    def stop(self):
        """Called when the workflow finishes; release resources."""

    # -- gate protocol -------------------------------------------------------
    def open_gate(self, src):
        """AND-gate over incoming control links (reference
        ``units.py:524-543``): mark ``src`` fired; if all links have fired,
        reset them and open."""
        with self._gate_lock_:
            if bool(self.ignores_gate):
                return True
            if src is not None and src in self.links_from:
                self.links_from[src] = True
            if all(self.links_from.values()):
                for key in self.links_from:
                    self.links_from[key] = False
                return True
            return False

    def _check_gate_and_run(self, src):
        """Gate check + run + propagate (reference ``units.py:782-803``)."""
        if bool(self.gate_block):
            return
        if not self.open_gate(src):
            return
        if bool(self.gate_skip):
            self.run_dependent()
            return
        # Each opened gate is one run token. Tokens, not a flag, so that the
        # holder/deferrer handoff cannot lose a firing (a notification that
        # arrives while run() is in flight must cause exactly one more run —
        # losing it would hang the graph, double-consuming would over-run).
        with self._gate_lock_:
            self._pending_runs_ += 1
        self._drain_run_tokens(src)

    def _drain_run_tokens(self, src=None):
        """Consume pending run tokens while the run lock can be taken.
        Callers that held ``_run_lock_`` directly (snapshot quiesce) call
        this after releasing so deferred firings aren't stranded."""
        while True:
            if not self._run_lock_.acquire(blocking=False):
                # the current holder re-checks the token count after its
                # run, so our token will be consumed by it (or by whoever
                # acquires next)
                return
            try:
                with self._gate_lock_:
                    if not self._pending_runs_:
                        return  # tokens already consumed by another thread
                    self._pending_runs_ -= 1
                if self.stopped or (self.workflow is not None
                                    and self.workflow.stopped):
                    return
                if root.common.trace.get("run", False):
                    self.debug("-> run (from %s)",
                               src.name if src else "start")
                timer = self.timers.setdefault("run", Timer())
                tracer = get_tracer()
                if tracer.enabled:
                    # a span a tick only while tracing is ON (the check
                    # is the whole disabled-path cost): unit runs are
                    # the training loop's hot path
                    with tracer.span("unit.run", unit=self.name,
                                     cls=type(self).__name__), timer:
                        self.run()
                else:
                    with timer:
                        self.run()
                self.run_calls += 1
                if self.timings:
                    self.info("%s run: %.3f ms", self.name,
                              1000 * timer.total / timer.calls)
            finally:
                self._run_lock_.release()
            self.run_dependent()
            with self._gate_lock_:
                if not self._pending_runs_:
                    return
            # more tokens arrived while we ran: loop to consume them

    _dispatch_local_ = threading.local()

    def run_dependent(self):
        """Notify successors; fan out on the pool, single successor inline
        (reference ``units.py:485-505``). Inline dispatch runs through a
        per-thread trampoline queue, not recursion — a Repeater cycle makes
        the tick chain arbitrarily long and would blow the stack."""
        consumers = [u for u in self.links_to
                     if not bool(u.gate_block)]
        if not consumers:
            return
        pool = self.workflow.thread_pool if self.workflow else None
        if pool is not None and len(consumers) > 1:
            for consumer in consumers[1:]:
                pool.call_in_thread(consumer._check_gate_and_run, self)
            inline = consumers[:1]
        else:
            inline = consumers  # no pool: every consumer runs inline
        local = Unit._dispatch_local_
        queue = getattr(local, "queue", None)
        if queue is not None:
            # already inside this thread's dispatch loop: enqueue and let
            # the outermost frame process it iteratively
            queue.extend((c, self) for c in inline)
            return
        local.queue = queue = [(c, self) for c in inline]
        try:
            while queue:
                consumer, src = queue.pop(0)
                consumer._check_gate_and_run(src)
        finally:
            local.queue = None

    # -- introspection -------------------------------------------------------
    def describe(self):
        return {
            "name": self.name,
            "class": type(self).__name__,
            "id": self.id,
            "view_group": self.view_group,
            "links_from": [u.name for u in self.links_from],
            "links_to": [u.name for u in self.links_to],
        }


class TrivialUnit(Unit):
    """A unit that does nothing (reference ``units.py:917``)."""

    def run(self):
        pass


class Container(Unit):
    """Marker base for units containing other units (reference
    ``units.py:925``)."""
