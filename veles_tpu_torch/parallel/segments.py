"""Partial fusion: runs of the tick chain as one composite unit each.

The port of ``veles_tpu/parallel/segments.py:41-334``, the second fusion
tier. The fused tick (:mod:`veles_tpu_torch.parallel.fused`) recognizes
the standard forward/GD topology; a workflow it declines would otherwise
fire every unit of its chain apart (graph mode). This tier serves any
workflow whose compute units are
:class:`~veles_tpu_torch.nn.jit_unit.JitUnit`\\ s:

- the repeater cycle is read out as a linear unit chain (:func:`chain_of`);
- maximal runs of consecutive JitUnits with the same gates collapse into
  one :class:`FusedSegment` each, one unit firing a tick that calls the
  members' ``compute()`` functions in chain order over the shared Array
  slots, instead of one firing per unit;
- host units (a custom unit spliced into the chain, the Decision) stay
  between the segments and fire as in graph mode.

Members may join a segment only with the IDENTICAL ``(gate_skip,
gate_block)`` signature: the same workflow-assigned Bool objects, or both
untouched birth gates, so the tick's gate decision applies to the whole
segment at once, as the shared Bool gates every member in graph mode.

The numbers are graph mode's by construction: the composite calls the
same bound ``compute()`` methods on the same inputs in the same order.
Under eager PyTorch there is no compiled program to share, so what a
segment saves is the per-unit firing (gate checks, locks, slot traffic),
not kernel launches.
"""

import torch

from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.jit_unit import JitUnit


def chain_of(workflow):
    """The repeater cycle as an ordered unit list, starting at the unit
    the loader fires (the loader itself stays host). Returns None when
    the cycle is not a linear chain (fan-out inside the cycle)."""
    loader = getattr(workflow, "loader", None)
    repeater = getattr(workflow, "repeater", None)
    if loader is None or repeater is None:
        return None
    # the units that reach the repeater without passing through the
    # loader: one reverse walk from the repeater over links_from that
    # never expands through the loader
    reaches = {repeater}
    frontier = [repeater]
    while frontier:
        node = frontier.pop()
        if node is loader:
            continue  # the loader may start a path, never sit inside one
        for prev in node.links_from:
            if prev not in reaches:
                reaches.add(prev)
                frontier.append(prev)
    chain = []
    current = loader
    while True:
        successors = [u for u in current.links_to
                      if u is not repeater and u in reaches]
        if current.links_to.get(repeater) and not successors:
            return chain  # closed the cycle
        if len(successors) != 1:
            return None  # fan-out inside the cycle (or a dead end)
        current = successors[0]
        if current in chain or current is loader:
            return None  # inner cycle that is not the repeater loop
        chain.append(current)


def _default_skip(unit):
    """True when the unit still carries its untouched birth gate: the
    workflow never assigned a control Bool, so in graph mode nothing
    would flip it between ticks (identity, not value: a shared control
    Bool like ``decision.gd_skipped`` is False at ``enable()`` time but
    toggles every tick). :meth:`FusedSegment.run` still catches a birth
    gate ``.set()`` later."""
    return unit.gate_skip is getattr(unit, "_born_gate_skip", None)


def _default_block(unit):
    return unit.gate_block is getattr(unit, "_born_gate_block", None)


def _gate_signature(unit):
    return (None if _default_skip(unit) else id(unit.gate_skip),
            None if _default_block(unit) else id(unit.gate_block))


def _fusible(unit):
    """A unit a composite can call: a JitUnit with a compute() of its own
    and declared slots (custom JitUnits qualify)."""
    return (isinstance(unit, JitUnit)
            and type(unit).compute is not JitUnit.compute
            and not getattr(unit, "no_fusion", False))


def partition(chain):
    """Split the chain into runs: ``[("segment", [units...]) |
    ("host", unit), ...]``. A segment extends while members are fusible
    and their gate signatures are equal; a run of one stays a host
    unit."""
    result = []
    run = []
    run_sig = None

    def flush():
        nonlocal run, run_sig
        if len(run) >= 2:
            result.append(("segment", run))
        else:
            result.extend(("host", u) for u in run)
        run, run_sig = [], None

    for unit in chain:
        if not _fusible(unit):
            flush()
            result.append(("host", unit))
            continue
        sig = _gate_signature(unit)
        if run and sig != run_sig:
            # exact signature match only: a default-gate unit in a run
            # that adopts a neighbour's control Bool would be skipped when
            # that Bool fires, where graph mode would have run it
            flush()
        run.append(unit)
        run_sig = sig
    flush()
    return result


class FusedSegment(Unit):
    """One composite of a run of consecutive JitUnits.

    The members stay constructed (they own the weights and remain the
    user's composition API) but leave the control graph; this unit takes
    their place and calls their chained computes in one firing. Slot
    traffic is kept: outside inputs are read from the members' Array slots
    at call time, and the results are scattered back into the members'
    output slots, so everything outside the segment (the Decision's
    accumulators, monitors) sees exactly the graph-mode state.
    """

    hide_from_registry = True
    VIEW_GROUP = "WORKER"
    #: execution strategy, not topology
    EPHEMERAL = True

    def __init__(self, workflow, members, **kwargs):
        kwargs.setdefault("name", "segment[%s..%s]"
                          % (members[0].name, members[-1].name))
        super().__init__(workflow, **kwargs)
        self.members = list(members)
        self.calls = 0

    def init_unpickled(self):
        super().init_unpickled()
        self._plan_ = None

    def _build_plan(self):
        """The dataflow plan over the members' slot graph. Array slots are
        keyed by object identity: ``link_attrs`` shares the Array objects,
        so a producer's output slot IS the consumer's input slot."""
        ext = []        # (unit, attr) read at call time
        ext_index = {}  # id(Array) | (unit id, attr) -> ext position
        produced = {}   # id(Array) -> value position (last writer)
        steps = []      # (unit, in_refs, out_positions)
        n_values = 0
        for unit in self.members:
            in_refs = []
            for name in unit.INPUTS:
                slot = getattr(unit, name)
                if isinstance(slot, Array):
                    key = id(slot)
                    if key in produced:
                        in_refs.append((True, produced[key]))
                        continue
                else:
                    key = (id(unit), name)
                if key not in ext_index:
                    ext_index[key] = len(ext)
                    ext.append((unit, name))
                in_refs.append((False, ext_index[key]))
            outs = []
            for name in unit.OUTPUTS:
                slot = getattr(unit, name)
                pos = n_values
                n_values += 1
                if isinstance(slot, Array):
                    produced[id(slot)] = pos
                outs.append(pos)
            steps.append((unit, in_refs, outs))
        # the FINAL value of every written slot, once per slot (a slot
        # rewritten later in the chain scatters its last value)
        scatter = []
        seen = set()
        for unit, _, outs in steps:
            for name, pos in zip(unit.OUTPUTS, outs):
                slot = getattr(unit, name)
                key = id(slot) if isinstance(slot, Array) else (id(unit),
                                                                name)
                if isinstance(slot, Array) and produced[key] != pos:
                    continue  # overwritten later in the segment
                if key in seen:
                    continue
                seen.add(key)
                scatter.append((unit, name, pos))
        self._plan_ = (ext, steps, scatter, n_values)

    def _composite(self, ext_values):
        _, steps, scatter, n_values = self._plan_
        env = [None] * n_values
        for unit, in_refs, outs in steps:
            args = [env[i] if internal else ext_values[i]
                    for internal, i in in_refs]
            res = unit.compute(*args)
            if len(outs) == 1:
                res = (res,)
            for pos, val in zip(outs, res):
                env[pos] = val
        return [env[pos] for _, _, pos in scatter]

    def run(self):
        for member in self.members:
            if (_default_skip(member) and bool(member.gate_skip)) or (
                    _default_block(member) and bool(member.gate_block)):
                # somebody .set() a birth gate the partition took for
                # constant: graph semantics on the slow path
                if not getattr(self, "_warned_slow_", False):
                    self.warning("%s: a member's default gate was mutated "
                                 "after fusion; running per unit",
                                 self.name)
                    self._warned_slow_ = True
                for unit in self.members:
                    if bool(unit.gate_block):
                        return
                    if not bool(unit.gate_skip):
                        unit.run()
                return
        if self._plan_ is None:
            self._build_plan()
        ext, _, scatter, _ = self._plan_
        values = []
        for unit, name in ext:
            slot = getattr(unit, name)
            if isinstance(slot, Array):
                if slot.data is None:
                    raise ValueError("%s: input slot %s.%s is empty"
                                     % (self.name, unit.name, name))
                values.append(slot.data)
            else:
                values.append(slot)
        with torch.no_grad():
            results = self._composite(values)
        for (unit, name, _), value in zip(scatter, results):
            slot = getattr(unit, name)
            if isinstance(slot, Array):
                slot.data = value
            else:
                setattr(unit, name, value)
        self.calls += 1


def enable(workflow):
    """Splice FusedSegments into the workflow's repeater cycle. Returns
    the list of segments ([] when nothing fused: not a linear cycle, or no
    run of 2+ compatible JitUnits). Call between construction and
    ``initialize()`` (StandardWorkflow does when the fused tick
    declines)."""
    chain = chain_of(workflow)
    if not chain:
        return []
    parts = partition(chain)
    segments = []
    for kind, members in parts:
        if kind != "segment":
            continue
        member_set = set(members)
        segment = FusedSegment(workflow, members)
        # the segment's gates are the members' shared non-default ones
        # (the partition gave every member the same pair)
        for member in members:
            if not _default_skip(member):
                segment.gate_skip = member.gate_skip
            if not _default_block(member):
                segment.gate_block = member.gate_block
        # rewire every outside link of every member, not only the chain's
        # ends: a monitor off a mid-segment member still fires (after the
        # segment, its data final then), and an outside provider into a
        # mid-segment member still holds the segment's AND gate
        predecessors, successors = [], []
        for member in members:
            predecessors.extend(u for u in member.links_from
                                if u not in member_set
                                and u not in predecessors)
            successors.extend(u for u in list(member.links_to)
                              if u not in member_set
                              and u not in successors)
        segment.link_from(*predecessors)
        for successor in successors:
            successor.link_from(segment)
        for member in members:
            member.unlink_all()
        segments.append(segment)
    return segments
