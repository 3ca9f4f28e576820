"""StandardWorkflow: declarative model assembly from a layer-spec list.

The port of ``veles_tpu/models/standard.py`` (the Znicz StandardWorkflow
pattern): a topology is a list of layer dicts, and the workflow wires
loader → forwards → evaluator → decision → gds, then splices the fused
tick (``parallel/fused.py``) in place of the compute chain. Layer types
ported so far:

    {"type": "all2all_tanh", "output_sample_shape": 100, ...}
    {"type": "softmax", "output_sample_shape": 10}
    {"type": "layer_norm"}
    {"type": "self_attention", "heads": 8, "causal": True,
     "residual": True}
    {"type": "ffn", "ratio": 4, "activation": "gelu"}
    {"type": "conv_relu", "n_kernels": 32, "kx": 3, "ky": 3, ...}
    {"type": "max_pooling", "kx": 2, "ky": 2}

(``all2all``, ``all2all_tanh``, ``all2all_relu``,
``all2all_strict_relu``, ``all2all_sigmoid``, ``softmax``, and since
the long-context slice the sequence-model tier: ``self_attention``,
``ffn`` and ``layer_norm`` over (N, T, E) samples, whose attention runs
the flash kernels on the card at T >= 4096 with 128-wide heads, and since
the conv slice ``conv``, ``conv_tanh``, ``conv_relu``,
``conv_strict_relu``, ``max_pooling``, ``avg_pooling`` and
``maxabs_pooling`` over NHWC samples). Per-layer trainer kwargs
(learning_rate, weights_decay, gradient_moment, l1_vs_l2, solver, ...)
may be embedded in each spec under "trainer"; workflow-level defaults
apply otherwise.

Execution: ``fused="auto"`` (the default) splices the fused tick
(``parallel/fused.py``) where ``fused.supports()`` holds and otherwise
the lower fusion tiers: the sweep tier (``parallel/sweep.py``) where every
host unit in the cycle is sweep-transparent, else the segment tier
(``parallel/segments.py``), else graph mode, as the JAX package's
``standard.py:232-307`` does. ``fused=True`` raises ValueError where the
fused tick does not support the topology; ``fused=False`` is graph mode:
every unit fires its own compute.

``evaluator="mse"`` builds the regression family (EvaluatorMSE and
DecisionMSE, ``FullBatchLoaderMSE`` by default); ``loader_cls`` names the
loader class (a class, as in the JAX package: ``MNISTLoader``, the file
loaders, ...), which takes ``loader_kwargs``.

``mesh=`` (``parallel/mesh.build_mesh``; the launcher builds it from
``--mesh``) runs the fused tick data-parallel over the mesh's ``data``
axis, as the JAX package's pod mode does (``standard.py:233-251``): where
the fused tick declines the topology under the mesh (a minibatch that
does not divide by the data axis, a fill-time transform) the run warns
and takes the lower tiers on one device. :meth:`add_standard_plotters`
attaches the stock plotters (``plotting/``).

In a fleet (``fleet/``) the master serves jobs and merges updates and
never runs the chain; a slave runs ONE tick per job
(``standard.py:123-222``): the repeater's loop-back is cut and the
EndPoint fires after the tick. Where the fused tick supports the
topology, a slave's tick is the fused tick (:meth:`_enable_fused_slave`,
K6 forward and K5 backward with the engine knobs on); the control plane
requires it, since its parameters stay resident on the device between
epoch fences with a one-job rollback. A slave with a mesh (the fleet x
pod composition, ``standard.py:124-208``) runs the fused tick over it,
data-parallel across the ranks of its world (``fleet/pod.py``); where
the topology cannot run the meshed tick it warns, as the JAX package
does, and takes the per-unit graph on one device.

``device=None`` means "cuda" and raises without a card unless the caller
passes ``device="cpu"``. A mesh shards the fused tick over its ``data``
axis; every other axis replicates it, as the JAX package's ``shard_map``
over ``data`` does.
"""

from veles_tpu_torch.core.plumbing import Repeater
from veles_tpu_torch.core.workflow import Workflow
from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.loader.fullbatch import (FullBatchLoader,
                                              FullBatchLoaderMSE)
from veles_tpu_torch.nn.all2all import (
    All2All, All2AllRELU, All2AllSigmoid, All2AllSoftmax,
    All2AllStrictRELU, All2AllTanh)
from veles_tpu_torch.nn.attention import (
    GDLayerNorm, GDSelfAttention, GDTokenFFN, LayerNorm, SelfAttention,
    TokenFFN)
from veles_tpu_torch.nn.conv import (
    Conv, ConvRELU, ConvStrictRELU, ConvTanh, GDConv, GDConvRELU,
    GDConvStrictRELU, GDConvTanh)
from veles_tpu_torch.nn.decision import DecisionGD, DecisionMSE
from veles_tpu_torch.nn.evaluator import EvaluatorMSE, EvaluatorSoftmax
from veles_tpu_torch.nn.gd import (
    GDRELU, GDSigmoid, GDSoftmax, GDStrictRELU, GDTanh, GradientDescent)
from veles_tpu_torch.nn.pooling import (
    AvgPooling, GDPooling, MaxAbsPooling, MaxPooling)

FORWARD_TYPES = {
    "all2all": (All2All, GradientDescent),
    "all2all_tanh": (All2AllTanh, GDTanh),
    "all2all_relu": (All2AllRELU, GDRELU),
    "all2all_strict_relu": (All2AllStrictRELU, GDStrictRELU),
    "all2all_sigmoid": (All2AllSigmoid, GDSigmoid),
    "softmax": (All2AllSoftmax, GDSoftmax),
    "self_attention": (SelfAttention, GDSelfAttention),
    "ffn": (TokenFFN, GDTokenFFN),
    "layer_norm": (LayerNorm, GDLayerNorm),
    "conv": (Conv, GDConv),
    "conv_tanh": (ConvTanh, GDConvTanh),
    "conv_relu": (ConvRELU, GDConvRELU),
    "conv_strict_relu": (ConvStrictRELU, GDConvStrictRELU),
    "max_pooling": (MaxPooling, GDPooling),
    "maxabs_pooling": (MaxAbsPooling, GDPooling),
    "avg_pooling": (AvgPooling, GDPooling),
}

TRAINER_KEYS = ("learning_rate", "learning_rate_bias", "weights_decay",
                "l1_vs_l2", "gradient_moment", "solver", "adam_beta1",
                "adam_beta2", "adam_epsilon")


class StandardWorkflow(Workflow):
    """Declarative topology workflow (the Znicz StandardWorkflow role)."""

    def __init__(self, workflow, layers=(), loader_kwargs=None,
                 loader_cls=None, decision_kwargs=None, device=None,
                 **kwargs):
        self.layer_defaults = {k: kwargs.pop(k) for k in TRAINER_KEYS
                               if k in kwargs}
        #: fused tick mode: True, False (graph mode) or "auto" (the fused
        #: tick where the topology supports it, else the lower tiers)
        self.fused = kwargs.pop("fused", "auto")
        #: sweep serving: one tick per class sweep instead of one per
        #: minibatch
        self.fused_sweep = kwargs.pop("fused_sweep", True)
        #: pipelined epochs (default): metrics are read one epoch late,
        #: so the per-epoch read overlaps the next epoch's compute;
        #: outputs are identical, including the stop paths
        self.fused_pipeline = kwargs.pop("fused_pipeline", True)
        #: the data-parallel mesh; the trailing underscore keeps it out
        #: of snapshots (the launcher builds it again on resume)
        self.mesh_ = kwargs.pop("mesh", None)
        #: "softmax" (classification) or "mse" (regression): selects the
        #: evaluator/decision pair and the default loader
        self.evaluator_kind = kwargs.pop("evaluator", "softmax")
        if self.evaluator_kind not in ("softmax", "mse"):
            raise ValueError("evaluator must be 'softmax' or 'mse', got "
                             "%r" % self.evaluator_kind)
        for spec in layers:
            if spec["type"] not in FORWARD_TYPES:
                raise ValueError("unknown layer type %r" % spec["type"])
        self.device = resolve_device(device)
        self.fused_tick = None
        self.sweep_unit = None
        super().__init__(workflow, **kwargs)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)
        loader_cls = loader_cls or (
            FullBatchLoaderMSE if self.evaluator_kind == "mse"
            else FullBatchLoader)
        self.loader = loader_cls(self, **(loader_kwargs or {}))
        self.loader.link_from(self.repeater)
        self.forwards = []
        self.gds = []
        self._specs = [dict(spec) for spec in layers]
        self._build_forwards()
        self._build_evaluator_and_decision(decision_kwargs or {})
        self._build_gds()
        self.repeater.link_from(self.gds[0])
        self.end_point.link_from(self.decision)
        self.end_point.link_from(self.gds[0])
        self.end_point.gate_block = ~self.decision.complete
        self.loader.gate_block = self.decision.complete
        self.loader.complete = self.decision.complete

    def initialize(self, **kwargs):
        if self.is_slave:
            self._splice_slave()
        elif self.fused and self.is_standalone:
            self._enable_fused()
        return super().initialize(**kwargs)

    def _splice_slave(self):
        """Rewire the graph for one tick per job (``standard.py:123-170``):
        fusibility is decided on the INTACT graph (the chain check needs
        the repeater cycle), then the loop-back is cut and the EndPoint
        fires right after the backward chain, or after the fused tick
        (over the slave's mesh, if it has one)."""
        from veles_tpu_torch.parallel import fused

        if self.fused_tick is not None:
            return  # already spliced (a re-initialize)
        mesh = getattr(self, "mesh_", None)
        use_fused = bool(self.fused) and fused.supports(self, mesh)
        if bool(self.fused) and not use_fused:
            if self.fused is True:
                raise ValueError("fused=True but the topology/loader is "
                                 "not fusible on this slave")
            if mesh is not None:
                self.warning(
                    "a device mesh is configured but this slave's "
                    "topology/loader cannot run the sharded fused tick "
                    "(see parallel/fused.py supports()) — falling back "
                    "to per-unit graph mode on one device")
        from veles_tpu_torch.fleet import fleet_control_plane
        if fleet_control_plane() and not use_fused:
            # the control-plane wire carries no weights: they live in the
            # fused tick with its one-job rollback; graph-mode units
            # would double-apply a re-issued job
            raise ValueError(
                "control-plane fleet mode (root.common.fleet.plane="
                "control) requires the fused tick on the slave, but this "
                "topology/loader is not fusible (see parallel/fused.py "
                "supports()): use the data plane")
        self.repeater.unlink_from(self.gds[0])
        self.end_point.unlink_from(self.decision)
        self.end_point.link_from(self.gds[0])
        from veles_tpu_torch.core.mutable import Bool
        self.end_point.gate_block = Bool(False)
        if use_fused:
            self._enable_fused_slave(mesh)

    def apply_initial_data_from_master(self, data):
        """Handshake application: on the control plane a (re)handshake
        with initial weights makes the next tick read its parameters
        from the unit Arrays again instead of its resident replica."""
        super().apply_initial_data_from_master(data)
        tick = self.fused_tick
        if data and tick is not None:
            tick.reset_residency()

    def _enable_fused_slave(self, mesh=None):
        """The slave's one-tick job as the fused tick (``standard.py:
        190-209``): loader → FusedTick → EndPoint, data-parallel over the
        slave's own ``mesh`` when it has one."""
        from veles_tpu_torch.parallel import fused

        self.fused_tick = fused.FusedTick(self, mesh=mesh,
                                          name="fused_tick",
                                          pipelined=False)
        self.forwards[0].unlink_from(self.loader)
        self.end_point.unlink_from(self.gds[0])
        self.fused_tick.link_from(self.loader)
        self.end_point.link_from(self.fused_tick)
        self.loader.fill_data = False
        self.info("slave fused tick on %s%s", self.device,
                  "" if mesh is None else " over local mesh %s" % mesh)

    def _disable_fused_slave(self):
        """Reverse the slave splice: the per-unit chain fires again."""
        tick = self.fused_tick
        if tick is None:
            return
        self.fused_tick = None
        tick.unlink_from(self.loader)
        self.end_point.unlink_from(tick)
        self.del_ref(tick)
        self.forwards[0].link_from(self.loader)
        self.end_point.link_from(self.gds[0])
        self.loader.fill_data = True

    def _enable_fused(self):
        """Splice the FusedTick in place of the per-unit compute chain:
        loader → FusedTick → decision (see parallel/fused.py); where the
        fused tick does not support the topology, ``fused=True`` raises
        and ``"auto"`` takes the lower tiers (:meth:`_enable_segments`).
        The units stay constructed: they own the weights."""
        from veles_tpu_torch.parallel import fused

        if self.fused_tick is not None:
            return
        mesh = getattr(self, "mesh_", None)
        if not fused.supports(self, mesh):
            if self.fused is True:
                raise ValueError(
                    "fused=True but the topology/loader is not fusible "
                    "(see parallel/fused.py supports())")
            if mesh is not None:
                # the user asked for a mesh: say so rather than run on
                # one device at 1/Nth of the speed unannounced
                self.warning(
                    "a device mesh is configured but this topology/"
                    "loader cannot run the sharded fused tick "
                    "(minibatch size must divide by the data axis; see "
                    "parallel/fused.py supports()) — falling back to "
                    "partial fusion on one device")
            self._enable_segments()
            return
        self.fused_tick = fused.FusedTick(
            self, mesh=mesh, name="fused_tick",
            pipelined=bool(self.fused_pipeline and self.fused_sweep))
        # detach the graph-mode compute chain from the control path
        self.forwards[0].unlink_from(self.loader)
        self.decision.unlink_from(self.evaluator)
        self.gds[-1].unlink_from(self.decision)
        self.repeater.unlink_from(self.gds[0])
        # the detached chain can't fire the EndPoint's AND-gate; the
        # decision link alone finishes the fused run
        self.end_point.unlink_from(self.gds[0])
        self.fused_tick.link_from(self.loader)
        self.decision.link_from(self.fused_tick)
        self.repeater.link_from(self.decision)
        self.loader.gate_block = self.decision.complete
        self.loader.fill_data = False
        self.loader.sweep_serving = bool(self.fused_sweep)
        self.info("fused tick mode: %d-layer chain, one step per %s on %s%s",
                  len(self.forwards),
                  "class sweep" if self.loader.sweep_serving
                  else "minibatch", self.device,
                  "" if mesh is None else " over mesh %s" % mesh)

    def _enable_segments(self):
        """The lower fusion tiers for chains the fused tick declines (an
        unknown or custom layer, a custom unit spliced into the chain):

        - the sweep tier (``parallel/sweep.py``): the whole cycle run over
          class sweeps where every host unit in the cycle is
          sweep-transparent (``fused_sweep=False`` opts out);
        - the segment tier (``parallel/segments.py``): runs of consecutive
          JitUnits as one composite unit each, where a host unit needs
          per-tick slot access.

        Where neither applies the chain stays in graph mode."""
        from veles_tpu_torch.parallel import segments as seg_mod
        from veles_tpu_torch.parallel import sweep as sweep_mod

        if any(isinstance(u, (seg_mod.FusedSegment, sweep_mod.FusedSweep))
               for u in self.units):
            return  # the splice is already in place
        swept = None
        if self.fused_sweep:
            swept = sweep_mod.enable(self,
                                     pipelined=bool(self.fused_pipeline))
        if swept is not None:
            self.info("sweep-tier fusion: %d compute unit(s) run per class "
                      "sweep (%d host unit(s) fire per tick)",
                      len(swept.members), len(swept.hosts))
            return
        created = seg_mod.enable(self)
        if created:
            self.info("partial fusion: %d segment(s): %s", len(created),
                      ", ".join(s.name for s in created))

    def _disable_fused(self):
        """Reverse the FusedTick splice: the per-unit chain fires again."""
        tick = self.fused_tick
        if tick is None:
            return
        self.fused_tick = None
        tick.unlink_from(self.loader)
        self.decision.unlink_from(tick)
        self.repeater.unlink_from(self.decision)
        self.del_ref(tick)
        self.forwards[0].link_from(self.loader)
        self.decision.link_from(self.evaluator)
        self.gds[-1].link_from(self.decision)
        self.repeater.link_from(self.gds[0])
        self.end_point.link_from(self.gds[0])
        self.loader.gate_block = self.decision.complete
        self.loader.fill_data = True
        self.loader.sweep_serving = False

    def add_standard_plotters(self, confusion=True, weights=False):
        """Attach the stock live-training plotters (``standard.py:309-
        330``): the validation error curve, optionally the confusion
        matrix and a weights multi-histogram, each firing at epoch ends.
        Call BEFORE initialize(); the launcher's GraphicsServer renders
        them. Raises ImportError naming matplotlib where it is missing
        (the card's host), unless ``root.common.disable.plotting``."""
        from veles_tpu_torch.plotting import (AccumulatingPlotter,
                                              MatrixPlotter, MultiHistogram)

        self.plotters = []
        err = AccumulatingPlotter(self, name="%s: validation errors"
                                  % self.name, last=0)
        # last_epoch_* are per-epoch snapshots: the live accumulators
        # are zeroed when a plotter fires
        err.link_attrs(self.decision, ("input", "last_epoch_n_err"))
        err.input_field = 1  # VALID class
        err.gate_skip = ~self.decision.epoch_ended
        err.link_from(self.decision)
        self.plotters.append(err)
        if confusion:
            cm = MatrixPlotter(self, name="%s: confusion" % self.name)
            cm.link_attrs(self.decision, ("input", "last_epoch_confusion"))
            cm.link_attrs(self.loader, "reversed_labels_mapping")
            cm.gate_skip = ~self.decision.epoch_ended
            cm.link_from(self.decision)
            self.plotters.append(cm)
        if weights:
            # at the epoch tick the unit Arrays hold the weights the
            # epoch's metrics were measured on
            wh = MultiHistogram(self, name="%s: weights" % self.name)
            wh.link_attrs(self.forwards[0], ("input", "weights"))
            wh.gate_skip = ~self.decision.epoch_ended
            wh.link_from(self.decision)
            self.plotters.append(wh)
        return self.plotters

    def run(self):
        if bool(self.decision.complete):
            # the loader gate is blocked, so firing the start point would
            # hang: finish cleanly instead
            self.warning("workflow is already complete; nothing to run")
            self._finished = False
            self.on_workflow_finished()
            return self
        return super().run()

    def on_workflow_finished(self):
        # the fused tick and the sweep tier write unit-Array weights back
        # on EVAL ticks (the evaluated state); the final post-train state
        # lands here, from whichever unit owns the params
        sync_owner = self.fused_tick or self.sweep_unit
        if sync_owner is not None:
            try:
                sync_owner.sync_params()
            except Exception:
                # also reached via on_error: a raise here would swallow
                # _sync_event_.set() and hang run() forever, masking the
                # original failure
                self.exception("final fused param sync failed")
        super().on_workflow_finished()

    def _build_forwards(self):
        src = self.loader
        for i, spec in enumerate(self._specs):
            spec = dict(spec)
            ltype = spec.pop("type")
            spec.pop("trainer", None)
            fwd_cls, _ = FORWARD_TYPES[ltype]
            fwd = fwd_cls(self, name="fwd%d" % i, **spec)
            fwd.link_from(src)
            if i == 0:
                fwd.link_attrs(self.loader, ("input", "minibatch_data"))
            else:
                fwd.link_attrs(self.forwards[-1], ("input", "output"))
            self.forwards.append(fwd)
            src = fwd

    def _build_evaluator_and_decision(self, decision_kwargs):
        mse = self.evaluator_kind == "mse"
        self.evaluator = (EvaluatorMSE if mse else EvaluatorSoftmax)(self)
        self.evaluator.link_from(self.forwards[-1])
        self.evaluator.link_attrs(self.forwards[-1], ("input", "output"))
        self.evaluator.link_attrs(
            self.loader, ("target", "minibatch_targets") if mse
            else ("labels", "minibatch_labels"), "sample_mask")
        self.decision = (DecisionMSE if mse else DecisionGD)(
            self, **decision_kwargs)
        self.decision.link_from(self.evaluator)
        self.decision.loader = self.loader
        self.decision.evaluator = self.evaluator

    def _build_gds(self):
        self.gds = [None] * len(self.forwards)
        err_src = self.evaluator
        prev = self.decision
        for i in reversed(range(len(self.forwards))):
            spec = self._specs[i]
            _, gd_cls = FORWARD_TYPES[spec["type"]]
            trainer = dict(self.layer_defaults)
            trainer.update(spec.get("trainer", {}))
            if gd_cls is GDPooling:
                gd = GDPooling(self, name="gd%d" % i)
                gd.link_pooling(self.forwards[i], err_src)
            elif issubclass(gd_cls, GDSelfAttention):
                # covers GDTokenFFN too (the same four-leaf slot contract)
                gd = gd_cls(self, name="gd%d" % i, **trainer)
                gd.link_attention(self.forwards[i], err_src)
            elif issubclass(gd_cls, GDConv):
                gd = gd_cls(self, name="gd%d" % i, **trainer)
                gd.link_conv(self.forwards[i], err_src)
            else:
                gd = gd_cls(self, name="gd%d" % i, **trainer)
                gd.link_forward(self.forwards[i], err_src)
            gd.link_from(prev)
            gd.gate_skip = self.decision.gd_skipped
            self.gds[i] = gd
            err_src = gd
            prev = gd
