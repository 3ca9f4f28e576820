"""Sweep-tier partial fusion: ANY JitUnit chain over whole class sweeps.

The port of ``veles_tpu/parallel/sweep.py:72-683``, the third fusion
tier. The fused tick (:mod:`veles_tpu_torch.parallel.fused`) recognizes
the standard forward/GD topology; the segment tier
(:mod:`veles_tpu_torch.parallel.segments`) serves any JitUnit chain but
still serves and fires per minibatch. This tier takes any linear
repeater cycle whose compute units are JitUnits, custom layers included,
composes the units' OWN ``compute()`` functions into one per-minibatch
body (the dataflow read from the shared Array slots, as the segment
planner reads it) and runs that body over a whole class sweep in one unit
firing:

- the loader switches to sweep serving (one index matrix per class per
  epoch, the fused tick's serving mode);
- the body gathers and normalizes each minibatch as the loader's fill
  does (``FullBatchLoader.fill_minibatch``);
- slots written by one minibatch and read by the next (weights,
  velocities, Adam's moments: whatever the slot graph says) carry over;
  everything else is dataflow within the minibatch;
- TRAIN sweeps include the units gated on ``decision.gd_skipped``; eval
  sweeps run a plan without them, the class-constant decision graph mode
  makes per tick;
- the Decision reads the sweep's summed metrics through its sweep-serving
  branch (the fused tick's contract).

Where the JAX package scans the body with ``lax.scan`` in one XLA dispatch
per chunk, the port runs a Python loop over the chunk's minibatches:
eager PyTorch queues each minibatch's kernels on the card, and the host
walks on. Host units in the cycle still fire once per minibatch, between
chunks of ``root.common.engine.sweep_chunk`` minibatches; that matches
graph mode only when they read and write no device slot, so they must
say so: ``sweep_transparent = True`` (see
:class:`veles_tpu_torch.core.units.Unit`). A host unit that does not makes
the workflow fall back to the per-tick segment tier.

The weights follow every other tier: the stopping epoch's last TRAIN
minibatch applies its update before the run finishes (graph mode holds
the EndPoint's AND-gate behind the gd chain for it). The metrics are
graph mode's: every metric of a sweep precedes its updates.
"""

import numpy
import torch

from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.loader.normalization import state_tensors
from veles_tpu_torch.memory import Array
from veles_tpu_torch.ops.gather import gather_minibatch
from veles_tpu_torch.parallel.segments import (_default_block, _default_skip,
                                               _fusible, chain_of)

#: loader slot attr -> lane name produced inside the body
_LANES = (("minibatch_data", "data"), ("minibatch_labels", "labels"),
          ("minibatch_targets", "targets"), ("sample_mask", "mask"),
          ("minibatch_indices", "indices"))


def classify(workflow):
    """Sweep eligibility: ``(members, hosts)`` or None.

    ``members`` is the ordered list of ``(unit, train_only)`` compute
    steps (the Decision left out: it leaves the cycle and reads the
    sweep's sums); ``hosts`` the ordered transparent host units. Gates: a
    member keeps its birth gates, or the standard Decision wiring
    (``gate_skip is decision.gd_skipped``: TRAIN-only; ``gate_block is
    decision.complete``: stop-gated, which the sweep subsumes by stopping
    the serving loop)."""
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader

    loader = getattr(workflow, "loader", None)
    decision = getattr(workflow, "decision", None)
    if decision is None or not isinstance(loader, FullBatchLoader):
        return None
    if loader.has_fill_transforms:
        # the fill's augmentation draws per-minibatch randomness the sweep
        # body does not replicate
        return None
    if isinstance(getattr(loader, "minibatch_targets", None), Array) \
            and not isinstance(getattr(loader, "original_targets", None),
                               Array):
        # the body gathers targets from original_targets only; a loader
        # that fills its target slot otherwise belongs to the segment
        # tier (the JAX package's body fails on such a lane)
        return None
    chain = chain_of(workflow)
    if not chain or decision not in chain:
        return None
    allowed = set(chain) | {loader, workflow.repeater, decision}
    members, hosts = [], []
    for unit in chain:
        if unit is decision:
            continue
        # the EndPoint hangs off the LAST chain unit (its AND-gate holds
        # the final update before finish); the splice subsumes that, and
        # disable() restores exactly this link. An end_point link from any
        # other unit is custom finish wiring: the segment tier keeps it
        permitted = allowed | ({workflow.end_point}
                               if unit is chain[-1] else set())
        outside = [u for u in list(unit.links_from) + list(unit.links_to)
                   if u not in permitted]
        if outside:
            # a monitor or provider off a cycle unit: per-sweep firing
            # would change when it fires
            return None
        if _fusible(unit):
            if any(not isinstance(getattr(unit, n), Array)
                   for n in unit.OUTPUTS):
                return None  # a non-Array output cannot carry over
            train_only = False
            if not _default_skip(unit):
                if unit.gate_skip is decision.gd_skipped:
                    train_only = True
                else:
                    return None
            if not _default_block(unit) \
                    and unit.gate_block is not decision.complete:
                return None
            members.append((unit, train_only))
        elif getattr(unit, "sweep_transparent", False):
            if not (_default_skip(unit) and _default_block(unit)):
                return None
            hosts.append(unit)
        else:
            return None
    if not members:
        return None
    evaluator = getattr(workflow, "evaluator", None)
    if evaluator is None or evaluator not in (u for u, _ in members):
        return None  # the Decision's sweep branch needs the sums
    return members, hosts


def _lane_ids(loader):
    lanes = {}
    for attr, lane in _LANES:
        slot = getattr(loader, attr, None)
        if isinstance(slot, Array):
            lanes[id(slot)] = lane
    return lanes


class _Plan:
    """The dataflow plan of one gate variant (train or eval).

    ``steps``: ``(unit, in_refs, outs)`` in chain order, each compute
    argument tagged ``("env", pos)`` (this minibatch's), ``("lane",
    name)`` (the loader's), ``("carry", idx)`` (the previous minibatch's
    write) or ``("const", idx)`` (read once a sweep). ``writes``: every
    slot the body produces as ``(unit, attr)``, once per Array (the carry
    and the scatter after the sweep). ``carry_reads``: positions in
    ``writes`` whose value must be real before the first minibatch.
    ``consts``: ``(unit, attr)`` read once a sweep (the weights in the eval
    plan, the hyper vectors)."""

    def __init__(self, members, lanes):
        written = {}  # id(Array) -> write index
        writes = []
        for unit, _ in members:
            for name in unit.OUTPUTS:
                key = id(getattr(unit, name))
                if key not in written:
                    written[key] = len(writes)
                    writes.append((unit, name))
        consts, const_index = [], {}
        steps = []
        produced = {}  # id(Array) -> env position (this minibatch)
        carry_read_set = {}
        n_values = 0
        for unit, _ in members:
            in_refs = []
            for name in unit.INPUTS:
                slot = getattr(unit, name)
                if isinstance(slot, Array):
                    key = id(slot)
                    if key in produced:
                        in_refs.append(("env", produced[key]))
                        continue
                    if key in lanes:
                        in_refs.append(("lane", lanes[key]))
                        continue
                    if key in written:
                        # read before this minibatch's write: the previous
                        # minibatch's value carries over
                        idx = carry_read_set.setdefault(key, written[key])
                        in_refs.append(("carry", idx))
                        continue
                else:
                    key = (id(unit), name)
                if key not in const_index:
                    const_index[key] = len(consts)
                    consts.append((unit, name))
                in_refs.append(("const", const_index[key]))
            outs = []
            for name in unit.OUTPUTS:
                slot = getattr(unit, name)
                pos = n_values
                n_values += 1
                produced[id(slot)] = pos
                outs.append((pos, written[id(slot)]))
            steps.append((unit, in_refs, outs))
        self.steps = steps
        self.writes = writes
        self.written = written
        self.carry_reads = sorted(set(carry_read_set.values()))
        self.consts = consts
        self.n_values = n_values


class FusedSweep(Unit):
    """One class sweep of the whole repeater cycle, in chunks, over the
    units' own computes.

    Spliced as the fused tick is: ``loader -> FusedSweep -> decision ->
    repeater``; the member units stay constructed (their Array slots get
    the final values after every sweep) but leave the control graph.
    ``chunk_calls`` counts the chunks run.
    """

    hide_from_registry = True
    VIEW_GROUP = "WORKER"
    #: execution strategy, not topology
    EPHEMERAL = True

    def __init__(self, workflow, members, hosts, chain_units,
                 pipelined=False, **kwargs):
        kwargs.setdefault("name", "sweep[%d units]" % len(members))
        super().__init__(workflow, **kwargs)
        self.members = list(members)  # [(unit, train_only)]
        self.hosts = list(hosts)
        #: the original linear cycle (the Decision included): what
        #: disable() restores
        self.chain_units = list(chain_units)
        self.chunk = int(root.common.engine.get("sweep_chunk", 64))
        #: pipelined epochs (the fused tick's design): the Decision reads
        #: the metrics one epoch late; the sweep keeps a one-slot history
        #: so the unit Arrays hold the weights the metrics being
        #: attributed scored, and a lagged stop rolls the one speculative
        #: epoch back: outputs equal to the unpipelined run's
        self.pipelined = pipelined
        self.ticks = 0
        self.chunk_calls = 0

    def initialize(self, **kwargs):
        wf = self.workflow
        if self.pipelined:
            if wf.loader.effective_class_lengths[VALID] == 0:
                # lagged improvement tracking needs a VALID sweep
                self.warning("pipelined sweeps need a validation split: "
                             "disabling pipelining")
                self.pipelined = False
            wf.decision.pipeline_depth = 1 if self.pipelined else 0

    def disable(self):
        """Undo the splice: relink the original linear cycle (classify
        found no outside link but the EndPoint gate, so a relink in order
        plus the finish gate restores it all)."""
        wf = self.workflow
        loader = wf.loader
        self.unlink_all()
        wf.repeater.unlink_from(wf.decision)  # the splice's loop-back
        prev = loader
        for unit in self.chain_units:
            unit.link_from(prev)
            prev = unit
        wf.repeater.link_from(prev)
        # the finish gate as it was at enable(): a StandardWorkflow chain
        # had the EndPoint AND-gated on the last gd; a custom chain gated
        # on the decision alone must not gain an input it never fires
        if self.restore_finish_link:
            wf.end_point.link_from(prev)
        saved = self.saved_loader_gate
        loader.gate_block = (saved if saved is not None
                             else wf.decision.complete)
        loader.fill_data = True
        loader.sweep_serving = False
        if getattr(wf, "sweep_unit", None) is self:
            wf.sweep_unit = None
        wf.del_ref(self)

    def init_unpickled(self):
        super().init_unpickled()
        self._plans_ = None
        self._norm_ = None
        #: the true current value of every written slot, by id(Array):
        #: reads prefer it to slot.data, so the Arrays can lag one epoch
        #: in pipelined mode
        self._state_ = {}
        self._eval_stash_ = None
        self._stashed_this_epoch_ = False
        self._wrote_eval_params_ = False

    # -- the plans ------------------------------------------------------------
    def _build(self):
        loader = self.workflow.loader
        lanes = _lane_ids(loader)
        self._plans_ = {True: _Plan(self.members, lanes),
                        False: _Plan([(u, t) for u, t in self.members
                                      if not t], lanes)}
        self._norm_ = state_tensors(loader.normalizer.jit_state(),
                                    loader.device)
        evaluator = self.workflow.evaluator
        self._metric_slots_ = {
            name: id(getattr(evaluator, name))
            for name in evaluator.OUTPUTS
            if name in ("loss", "n_err", "confusion_matrix")
            and isinstance(getattr(evaluator, name), Array)}
        self._with_confusion_ = (
            "confusion_matrix" in self._metric_slots_
            and getattr(evaluator, "compute_confusion", True))

    def _body(self, plan, writes, consts, data, labels, targets, row,
              valid, with_cm):
        """One minibatch: the loader's fill (gather, normalize, mask, and
        the regression targets where the loader has them), then the
        members' computes in chain order. Returns the updated writes and
        the minibatch's (loss sum, n_err, confusion)."""
        loader = self.workflow.loader
        batch, lab = gather_minibatch(data, row, labels)
        batch = loader.normalizer.apply_state(batch, self._norm_)
        mask = (torch.arange(row.shape[0], device=row.device)
                < valid).float()
        lane_vals = {"data": batch, "labels": lab, "mask": mask,
                     "indices": row}
        if targets is not None:
            lane_vals["targets"] = targets.index_select(0, row)
        env = [None] * plan.n_values
        writes = list(writes)
        for unit, in_refs, outs in plan.steps:
            args = []
            for tag, ref in in_refs:
                if tag == "env":
                    args.append(env[ref])
                elif tag == "lane":
                    args.append(lane_vals[ref])
                elif tag == "carry":
                    args.append(writes[ref])
                else:
                    args.append(consts[ref])
            res = unit.compute(*args)
            if len(outs) == 1:
                res = (res,)
            for (pos, widx), val in zip(outs, res):
                env[pos] = val
                writes[widx] = val
        metric = self._metric_slots_
        loss_w = plan.written.get(metric.get("loss"))
        err_w = plan.written.get(metric.get("n_err"))
        cm_w = plan.written.get(metric.get("confusion_matrix"))
        loss_sum = writes[loss_w] * float(valid) if loss_w is not None \
            else 0.0
        n_err = writes[err_w] if err_w is not None else 0
        cm = writes[cm_w] if with_cm and cm_w is not None else None
        return writes, (loss_sum, n_err, cm)

    def _run_chunk(self, plan, reads, consts, data, labels, targets, rows,
                   valids, with_cm):
        """The minibatches of one chunk in order: ``reads`` seed only the
        carried slots; the first minibatch fills the whole write set."""
        writes = [None] * len(plan.writes)
        for i, idx in enumerate(plan.carry_reads):
            writes[idx] = reads[i]
        loss = n_err = cm = None
        for row, valid in zip(rows, valids):
            writes, (part, err, c) = self._body(
                plan, writes, consts, data, labels, targets, row,
                int(valid), with_cm)
            loss = part if loss is None else loss + part
            n_err = err if n_err is None else n_err + err
            if c is not None:
                cm = c if cm is None else cm + c
        self.chunk_calls += 1
        return writes, (loss, n_err, cm)

    # -- one sweep ------------------------------------------------------------
    def _gates_mutated(self):
        for unit, _ in self.members:
            if (_default_skip(unit) and bool(unit.gate_skip)) or \
                    (_default_block(unit) and bool(unit.gate_block)):
                return True
        return any(bool(unit.gate_skip) or bool(unit.gate_block)
                   for unit in self.hosts)

    def run(self):
        wf = self.workflow
        loader = wf.loader
        if self._plans_ is None:
            self._build()
        training = loader.minibatch_class == TRAIN
        matrix = numpy.asarray(loader.minibatch_indices.data)
        valids = numpy.asarray(loader.sweep_valid_sizes, numpy.int64)
        total_valid = max(int(loader.minibatch_valid_size), 1)
        if self._gates_mutated():
            if not getattr(self, "_warned_slow_", False):
                self.warning("%s: a member's default gate was mutated "
                             "after the sweep splice; running per unit",
                             self.name)
                self._warned_slow_ = True
            # the slow path runs the units against their SLOTS: flush the
            # (possibly lagging) state first, and drop pipelining for good
            # (the slots are current from here on, and a later advance or
            # rollback must not scatter a stale stash)
            self._scatter_state(self._state_)
            self._state_ = {}
            self._eval_stash_ = None
            self._stashed_this_epoch_ = False
            self._wrote_eval_params_ = False
            if self.pipelined:
                self.pipelined = False
                wf.decision.pipeline_depth = 0
            self._run_slow(matrix, valids, training, total_valid)
            self.ticks += 1
            return
        plan = self._plans_[training]
        data = loader.original_data.data
        labels = loader.labels_for_gather()
        targets = getattr(getattr(loader, "original_targets", None),
                          "data", None)
        state = self._state_

        def current(pairs):
            return [state.get(id(getattr(u, n)), getattr(u, n).data)
                    if isinstance(getattr(u, n), Array) else getattr(u, n)
                    for u, n in pairs]

        consts = current(plan.consts)
        reads = current([plan.writes[i] for i in plan.carry_reads])
        for value, (unit, name) in zip(
                consts + reads,
                plan.consts + [plan.writes[i] for i in plan.carry_reads]):
            if value is None:
                raise ValueError("%s: slot %s.%s is empty"
                                 % (self.name, unit.name, name))
        rows_all = torch.from_numpy(matrix).to(data.device)
        with_cm = not training and self._with_confusion_
        chunk = max(self.chunk if self.hosts else len(matrix), 1)
        loss_sum = n_err_sum = cm_sum = None
        writes = None
        with torch.no_grad():
            for start in range(0, len(matrix), chunk):
                writes, (loss, err, cm) = self._run_chunk(
                    plan, reads, consts, data, labels, targets,
                    rows_all[start:start + chunk],
                    valids[start:start + chunk], with_cm)
                reads = [writes[i] for i in plan.carry_reads]
                loss_sum = loss if loss_sum is None else loss_sum + loss
                n_err_sum = err if n_err_sum is None else n_err_sum + err
                if cm is not None:
                    cm_sum = cm if cm_sum is None else cm_sum + cm
                # host units fire once a minibatch, between chunks; the
                # card works on the chunk's queued kernels meanwhile
                for _ in range(len(valids[start:start + chunk])):
                    for host in self.hosts:
                        host.run()
        for (unit, name), value in zip(plan.writes, writes):
            state[id(getattr(unit, name))] = value
        if not self.pipelined:
            # every written slot's final value into the unit Arrays: graph
            # mode's state at every sweep boundary
            for (unit, name), value in zip(plan.writes, writes):
                getattr(unit, name).data = value
        else:
            self._rotate_pipelined(loader, training)
        self._publish_metrics(training, loss_sum, n_err_sum, cm_sum,
                              total_valid)
        self.ticks += 1

    def _rotate_pipelined(self, loader, training):
        """Pipelined Array semantics (the fused tick's one-slot history):
        the unit Arrays lag one epoch and hold the weights the metrics
        being attributed scored."""
        if not training and loader.epoch_ended_for_class:
            if not self._stashed_this_epoch_:
                current = dict(self._state_)
                if self._eval_stash_ is not None:
                    self._scatter_state(self._eval_stash_)
                self._eval_stash_ = current
                self._stashed_this_epoch_ = True
            self._wrote_eval_params_ = True
        if loader.epoch_ended:
            eval_covers = (self._wrote_eval_params_ and
                           loader.effective_class_lengths[VALID] > 0)
            if training and not eval_covers:
                self._scatter_state(self._state_)
            self._wrote_eval_params_ = False
            self._stashed_this_epoch_ = False

    def _scatter_state(self, state):
        """Write a state snapshot into the unit Arrays (the train plan's
        writes are every written slot)."""
        if not state or self._plans_ is None:
            return
        for unit, name in self._plans_[True].writes:
            slot = getattr(unit, name)
            value = state.get(id(slot))
            if value is not None:
                slot.data = value

    def advance_eval_params(self):
        """The Decision's drain hook (as the fused tick's): a multi-epoch
        drain is about to attribute an improvement to the NEWER epoch, so
        the Arrays advance to the state its eval scored."""
        if self._eval_stash_ is not None:
            self._scatter_state(self._eval_stash_)
            self._eval_stash_ = None

    def rollback_speculative(self):
        """A lagged stop arrived after one more epoch was trained: the
        state goes back to the stopping epoch's evaluated weights (the
        one-slot stash holds them)."""
        if self._eval_stash_ is not None:
            self._state_ = self._eval_stash_
            self._eval_stash_ = None

    def sync_params(self):
        """The workflow finished: the final (post-train) state lands in
        the unit Arrays."""
        self._scatter_state(self._state_)

    def _publish_metrics(self, training, loss_sum, n_err_sum, cm_sum,
                         total_valid):
        """The Decision's sweep-serving contract (the fused tick's):
        ``loss`` holds the sweep's average, ``n_err`` and the confusion
        matrix its sums."""
        evaluator = self.workflow.evaluator
        if "loss" in self._metric_slots_:
            evaluator.loss.data = loss_sum / total_valid
        if "n_err" in self._metric_slots_:
            evaluator.n_err.data = n_err_sum
        if not training and self._with_confusion_ and cm_sum is not None:
            evaluator.confusion_matrix.data = cm_sum

    def _run_slow(self, matrix, valids, training, total_valid):
        """Per minibatch, the live gates honoured (a birth gate was
        mutated after the splice): graph-mode unit firing, the sweep's
        summed metrics for the Decision. A TRAIN-only member runs in
        TRAIN sweeps, as ``decision.gd_skipped`` lets it in graph mode:
        the Decision does not run between these minibatches, so the Bool
        still holds the previous sweep's class. (The JAX package reads
        the Bool here, ``sweep.py:623-630``, and so never runs the GD
        units in a TRAIN sweep of this path.)"""
        loader = self.workflow.loader
        evaluator = self.workflow.evaluator
        # the cycle's order saved at enable(): chain_of would walk the
        # spliced graph here
        host_set = set(self.hosts)
        train_only = dict((id(u), t) for u, t in self.members)
        order = [u for u in self.chain_units
                 if u is not self.workflow.decision]
        loss_sum = n_err_sum = cm_sum = None
        for row, valid in zip(matrix, valids):
            loader.fill_minibatch(numpy.asarray(row), int(valid))
            for unit in order:
                if bool(unit.gate_block):
                    break
                if unit not in host_set and train_only[id(unit)]:
                    if not training:
                        continue
                elif bool(unit.gate_skip):
                    continue
                unit.run()
            if "loss" in self._metric_slots_:
                part = evaluator.loss.data * float(valid)
                loss_sum = part if loss_sum is None else loss_sum + part
            if "n_err" in self._metric_slots_:
                n_err_sum = (evaluator.n_err.data if n_err_sum is None
                             else n_err_sum + evaluator.n_err.data)
            if not training and self._with_confusion_:
                cm = evaluator.confusion_matrix.data
                cm_sum = cm if cm_sum is None else cm_sum + cm
        self._publish_metrics(training, loss_sum, n_err_sum, cm_sum,
                              total_valid)


def enable(workflow, pipelined=False):
    """Splice a FusedSweep over the repeater cycle. Returns the unit, or
    None when the workflow is not sweep-eligible (the caller then tries
    the segment tier). Call between construction and ``initialize()``."""
    info = classify(workflow)
    if info is None:
        return None
    members, hosts = info
    loader = workflow.loader
    decision = workflow.decision
    chain = chain_of(workflow)
    sweep = FusedSweep(workflow, members, hosts, chain, pipelined=pipelined)
    # what disable() must put back: whether the last chain unit held the
    # EndPoint's finish gate, and the loader's own stop gate
    sweep.restore_finish_link = workflow.end_point in chain[-1].links_to
    sweep.saved_loader_gate = loader.gate_block
    # detaching every chain unit but the Decision also clears its links
    # into the repeater and the Decision (unlink_all is both ways); the
    # repeater keeps its start_point provider, the Decision its outward
    # links (the end_point gate)
    for unit in chain:
        if unit is not decision:
            unit.unlink_all()
    # the cycle becomes start -> repeater -> loader -> sweep -> decision
    # -> repeater (end_point keeps its decision link and gate)
    sweep.link_from(loader)
    decision.link_from(sweep)
    workflow.repeater.link_from(decision)
    loader.gate_block = decision.complete
    loader.fill_data = False
    loader.sweep_serving = True
    workflow.sweep_unit = sweep
    return sweep
