"""FusedTick: the product path of a training workflow.

The port of ``veles_tpu/parallel/fused.py`` for a single device: dense
layers, since the long-context slice the sequence-model tier
(self-attention, feed-forward and layer-norm blocks, ``fused.py:57-259``),
and since the conv slice convolutions, the max, average and max-abs pools
(layers with no parameters: an empty parameter dict and no leaves) and
the loader's in-tick augmentation.
``StandardWorkflow`` builds its unit graph (the units are the
composition API and the weight owners), then splices a :class:`FusedTick`
in place of the compute chain:

    start → repeater → loader → FusedTick → decision → {repeater, end}

One tick is one train or eval step over the loader's served minibatch —
or, with sweep serving (the default), over a whole class sweep: a Python
loop over the rows of the index matrix with the same per-row math as the
JAX package's ``lax.scan``. Each step gathers from the device-resident
originals, normalizes, applies the TRAIN augmentation
(``ops/augment.TRANSFORMS``, keyed by the loader's seed for that
minibatch), runs the layer chain (dense layers through
``ops/gemm.dense_layer``, K6 forward and K5 weight gradient where the
engine knobs and the gate allow; attention and feed-forward blocks
through ``ops/attention.attention_block`` and ``ffn_block``, whose
attention runs the flash kernels K7 forward and K8/K9 backward on the
card at T >= 4096 with 128-wide heads; layer norms in plain torch;
convolutions through ``ops/gemm.conv2d`` (cuDNN on the card) and pools
through ``nn/pooling.POOLS``, NHWC throughout; a dense layer after a
block or a conv flattens its input, in H, W, C order for NHWC), computes
the masked softmax cross-entropy (or, for the regression family, the
masked MSE against the targets, which ride the labels lane: gathered
from the loader's ``original_targets`` by the same indices), takes the
gradients with
``torch.autograd`` of that loss (the JAX package uses
``jax.value_and_grad`` of the same loss), and applies each GD unit's
exact update (``nn/gd.make_updater``) leaf by leaf: the weight decay
reaches every attention and feed-forward leaf, biases included
(``_ATTN_LEAVES``), but only the weights of a dense or layer-norm layer
(``_WB_LEAVES``). Metrics stay device tensors for the Decision to read at
epoch boundaries.

The step never updates a tensor in place: it returns new parameter
tensors, so the unit Arrays, the tick's state and the pipelined mode's
one-slot history share tensors without copies (the JAX package copies
because its step donates its input buffers).

A topology the tick does not support falls to the lower fusion tiers
(``parallel/sweep.py``, ``parallel/segments.py``) or to graph mode, which
run the units' own computes.

With a mesh (``parallel/mesh.py``, the JAX package's pod mode) the tick
runs data-parallel: every rank of the ``torch.distributed`` world holds
the whole dataset and the same weights, steps on its block of each
minibatch, and merges gradients and metrics through
``parallel/mapreduce.reduce_sum`` (:func:`build_tick`), so every rank
applies the same update. The tick shards over the ``data`` axis alone:
over a mesh that also sizes another axis (``model``, ``seq``, ``pipe``,
``expert``) each rank takes the block of its data coordinate and merges
over its line along ``data`` (``Mesh.axis_group``), so the ranks of the
other axes compute the same values, as the JAX package's ``shard_map``
over ``data`` does (``fused.py:529-545``).

On a fleet slave (``fused.py:29-38``, ``:720-790``) the tick runs one
step per job. Data plane: it reads the parameters the master's job
wrote into the unit Arrays and writes the trained ones back for the
update. Control plane: the parameters stay resident between jobs, the
tick keeps the pre-job parameters as a one-slot rollback for a
re-issued job (:meth:`FusedTick.rollback_job`), and it writes the unit
Arrays only at epoch fences, which feed the fence sync. No copy is
needed for the stash: the step never updates a tensor in place. On a pod
slave (a slave with a mesh, ``fleet/pod.py``) these rules hold on every
rank: each applies the job rank 0 hands on, steps its block of the
minibatch and reduces over the slave's world.
"""

import torch

from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.loader.normalization import (normalizer_registry,
                                                  state_tensors)
from veles_tpu_torch.nn.gd import make_updater
from veles_tpu_torch.nn.pooling import POOLS
from veles_tpu_torch.ops import activations as act_lib
from veles_tpu_torch.ops import losses
from veles_tpu_torch.ops.attention import attention_block, ffn_block
from veles_tpu_torch.ops.augment import TRANSFORMS
from veles_tpu_torch.ops.gather import gather_minibatch
from veles_tpu_torch.ops.gemm import conv2d, dense_layer
from veles_tpu_torch.parallel.segments import chain_of

_DENSE = "dense"
_CONV = "conv"
_ATTN = "attention"
_FFN = "ffn"
_NORM = "layer_norm"

#: per-leaf update policy: (leaf key, forward attr, gd velocity attr,
#: uses learning_rate_bias, gets l2/l1 decay) — each GD unit's exact
#: update math (``fused.py:67-68``)
_WB_LEAVES = (("w", "weights", "_velocity_w", False, True),
              ("b", "bias", "_velocity_b", True, False))
#: the attention and feed-forward blocks' leaves (``fused.py:69-72``):
#: unlike ``_WB_LEAVES``, the biases take the weight decay too
_ATTN_LEAVES = (("w", "weights", "_velocity_w", False, True),
                ("b", "bias", "_velocity_b", True, True),
                ("ow", "out_weights", "_velocity_ow", False, True),
                ("ob", "out_bias", "_velocity_ob", True, True))


def extract_model_spec(workflow):
    """Static per-layer config from the workflow's forwards/gds chains.
    Returns a spec list, or None when a layer is not one the tick fuses
    (or a subclass carries math of its own). A pooling layer's spec has
    no ``"leaves"``: it has no parameters and its GD unit no optimizer
    state."""
    from veles_tpu_torch.nn.all2all import All2All, All2AllSoftmax
    from veles_tpu_torch.nn.attention import (GDLayerNorm, GDSelfAttention,
                                              GDTokenFFN, LayerNorm,
                                              SelfAttention, TokenFFN)
    from veles_tpu_torch.nn.conv import Conv, GDConv
    from veles_tpu_torch.nn.gd import GradientDescent
    from veles_tpu_torch.nn.pooling import GDPooling, Pooling

    known = {(getattr(cls, "compute", None), cls.run) for cls in (
        All2All, All2AllSoftmax, Conv, SelfAttention, TokenFFN, LayerNorm,
        Pooling, GradientDescent, GDConv, GDSelfAttention, GDTokenFFN,
        GDLayerNorm, GDPooling)}

    def modified(unit):
        """A subclass that overrides compute() (or run()) carries math the
        spec tables cannot express: fusing it by isinstance would run the
        BASE math. Such chains belong to the sweep and segment tiers,
        which compose the units' own computes."""
        return unit is not None and (
            getattr(type(unit), "compute", None), type(unit).run) \
            not in known

    specs = []
    for i, fwd in enumerate(workflow.forwards):
        gd = workflow.gds[i] if workflow.gds else None
        if modified(fwd) or modified(gd):
            return None
        if isinstance(fwd, All2All):
            spec = {"kind": _DENSE, "activation": fwd.ACTIVATION,
                    "leaves": _WB_LEAVES}
        elif isinstance(fwd, Conv):
            spec = {"kind": _CONV, "activation": fwd.ACTIVATION,
                    "sliding": fwd.sliding, "padding": fwd.padding,
                    "leaves": _WB_LEAVES}
        elif isinstance(fwd, Pooling) and fwd.KIND in POOLS:
            specs.append({"kind": fwd.KIND, "window": fwd.window,
                          "sliding": fwd.sliding})
            continue
        elif isinstance(fwd, SelfAttention):
            spec = {"kind": _ATTN, "heads": fwd.heads, "causal": fwd.causal,
                    "residual": fwd.residual, "leaves": _ATTN_LEAVES}
        elif isinstance(fwd, TokenFFN):
            spec = {"kind": _FFN, "activation": fwd.activation,
                    "residual": fwd.residual, "leaves": _ATTN_LEAVES}
        elif isinstance(fwd, LayerNorm):
            spec = {"kind": _NORM, "eps": fwd.eps, "leaves": _WB_LEAVES}
        else:
            return None
        if gd is None or not hasattr(gd, "learning_rate"):
            return None
        spec.update(has_params=True, solver=gd.solver)
        specs.append(spec)
    return specs


def get_hypers(workflow):
    """Per-layer hyperparameter vectors, read fresh from the GD units'
    ``_hyper`` slots each tick, so ``set_learning_rate()`` anneals (None
    for a layer without parameters)."""
    return [gd._hyper.data if hasattr(gd, "_hyper") else None
            for gd in workflow.gds]


def get_params(workflow, specs):
    """The unit chain's weights as the per-layer tree: ``{"p": {leaf:
    tensor}, "v": {leaf: velocity}}`` per layer, plus ``"s"`` second
    moments and ``"t"`` the step count for the stateful solvers; ``{}``
    for a layer without parameters."""
    params = []
    for fwd, gd, spec in zip(workflow.forwards, workflow.gds, specs):
        if "leaves" not in spec:
            params.append({})
            continue
        p, v = {}, {}
        entry = {"p": p, "v": v}
        stateful = spec["solver"] != "momentum"
        if stateful:
            entry["s"] = {}
            entry["t"] = gd._step.data
        for leaf, fwd_attr, vel_attr, _, _ in spec["leaves"]:
            p[leaf] = getattr(fwd, fwd_attr).data
            v[leaf] = getattr(gd, vel_attr).data
            if stateful:
                entry["s"][leaf] = getattr(
                    gd, vel_attr.replace("_velocity", "_second")).data
        params.append(entry)
    return params


def set_params(workflow, params, specs):
    """Write the tick's parameters back into the unit Array slots (so
    results and anything reading the units see them)."""
    for fwd, gd, p, spec in zip(workflow.forwards, workflow.gds, params,
                                specs):
        if not p:
            continue
        stateful = spec["solver"] != "momentum"
        for leaf, fwd_attr, vel_attr, _, _ in spec["leaves"]:
            getattr(fwd, fwd_attr).data = p["p"][leaf]
            getattr(gd, vel_attr).data = p["v"][leaf]
            if stateful:
                getattr(gd, vel_attr.replace("_velocity", "_second")
                        ).data = p["s"][leaf]
        if stateful:
            gd._step.data = p["t"]


def _layer_forward(spec):
    """Pure forward for one layer (``fused.py:190-281``)."""
    kind = spec["kind"]
    if kind in POOLS:
        pool, window, sliding = POOLS[kind], spec["window"], spec["sliding"]
        return lambda p, x: pool(x, window, sliding)
    if kind == _CONV:
        act = act_lib.ACTIVATIONS[spec["activation"]][0]
        sliding, padding = spec["sliding"], spec["padding"]

        def fwd(p, x):
            return act(conv2d(x, p["w"], sliding, padding) + p["b"])
        return fwd
    if kind == _ATTN:
        heads, causal = spec["heads"], spec["causal"]
        residual = spec["residual"]

        def fwd(p, x):
            return attention_block(x, p["w"], p["b"], p["ow"], p["ob"],
                                   heads, causal, residual)
        return fwd
    if kind == _FFN:
        activation, residual = spec["activation"], spec["residual"]

        def fwd(p, x):
            return ffn_block(x, p["w"], p["b"], p["ow"], p["ob"],
                             activation, residual)
        return fwd
    if kind == _NORM:
        eps = spec["eps"]

        def fwd(p, x):
            # the population variance, as jnp.var
            mean = x.mean(dim=-1, keepdim=True)
            var = x.var(dim=-1, keepdim=True, correction=0)
            return (x - mean) * torch.rsqrt(var + eps) * p["w"] + p["b"]
        return fwd
    activation = spec["activation"]

    def fwd(p, x):
        x = x.reshape(x.shape[0], -1)
        return dense_layer(x, p["w"], p["b"], activation=activation,
                           out_dtype=torch.float32)
    return fwd


def forward_chain(workflow):
    """The workflow's trained forward chain as one function of a
    normalized batch, for serving it: the fused tick's per-layer math
    (dense layers through ``ops/gemm.dense_layer``, so K6 on the card
    with the engine knobs on where the gate holds) over the forward
    units' weights as they are at each call. The function returns what
    the last forward unit's ``output`` holds: for an ``All2AllSoftmax``
    head its logits, as the JAX package's head emits them (its softmax
    lives in the evaluator's cross-entropy). The exported package's head
    is retagged softmax, so the native runtime gives the softmax of this
    output. Raises ValueError for a chain the fused tick does not
    support."""
    specs = extract_model_spec(workflow)
    if specs is None:
        raise ValueError("%s: the forward chain is not one the fused "
                         "tick runs" % workflow.name)
    layer_fwds = [_layer_forward(spec) for spec in specs]

    def forward(x):
        params = get_params(workflow, specs)
        with torch.no_grad():
            for fwd, p in zip(layer_fwds, params):
                x = fwd(p["p"] if p else {}, x)
        return x
    return forward


def tick_config(workflow):
    """What the fused tick of ``workflow`` is built from: ``(specs,
    norm_type, kwargs)``, ``kwargs`` the ``with_confusion``, ``augment``
    and ``loss_kind`` knobs. ONE copy for :class:`FusedTick` and the AOT
    seam (``aot/loader.install_workflow_tick``), which keys installed
    steps by them; readable before ``initialize()``."""
    from veles_tpu_torch.nn.evaluator import EvaluatorMSE

    loader = workflow.loader
    loss_kind = ("mse" if isinstance(workflow.evaluator, EvaluatorMSE)
                 else "softmax")
    return extract_model_spec(workflow), loader.normalization_type, dict(
        with_confusion=getattr(workflow.evaluator, "compute_confusion",
                               True),
        augment=loader.jit_transform or "none", loss_kind=loss_kind)


def _freeze(obj):
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


#: (frozen specs, knobs, mesh id) -> an installed step tuple: the AOT
#: seam (``install_tick_steps``). Eager steps cost nothing to build, so
#: :func:`build_tick` stores nothing here itself; it only consults it.
_TICK_CACHE = {}


def _tick_key(specs, norm_type, with_confusion, augment, loss_kind,
              grad_reduce, mesh):
    """The tick cache key: the topology and every engine knob the steps
    read (``fused.py:297-309``). ONE copy: :func:`build_tick` and
    :func:`install_tick_steps` must agree on it exactly, or installed
    steps would shadow (or miss) the live ones."""
    from veles_tpu_torch.core.config import root
    return (_freeze(specs), norm_type, with_confusion, augment,
            loss_kind, grad_reduce, None if mesh is None else id(mesh),
            root.common.engine.get("precision_level", 0),
            str(root.common.engine.get("compute_dtype", "bfloat16")),
            str(root.common.engine.get("use_pallas", "tuned")),
            bool(root.common.engine.get("pallas_epilogue", False)))


def install_tick_steps(steps, specs, norm_type="none", mesh=None,
                       with_confusion=True, augment="none",
                       loss_kind="softmax", grad_reduce="f32"):
    """Seed the tick cache for this topology with caller-provided steps
    (``fused.py:312-325``), the seam the AOT loader
    (``aot/loader.install_fused_tick``) slots a bundle's steps into: a
    later :func:`build_tick` with the same key returns THESE, so
    ``FusedTick`` runs them unchanged. Returns the previous entry (None
    when none was installed)."""
    key = _tick_key(specs, norm_type, with_confusion, augment,
                    loss_kind, grad_reduce, mesh)
    previous = _TICK_CACHE.get(key)
    _TICK_CACHE[key] = tuple(steps)
    return previous


def build_tick(specs, norm_type="none", with_confusion=True,
               augment="none", loss_kind="softmax", mesh=None,
               grad_reduce="f32", cached=True):
    """The fused engine: ``(train_step, eval_step, train_sweep,
    eval_sweep)``, as the JAX package's ``build_tick``. With ``cached``
    the steps :func:`install_tick_steps` installed for this key are
    returned instead of new ones:

    - ``train_step(params, hypers, norm, data, labels, indices, valid,
      seed) -> (params, (loss, n_err))`` — one minibatch: gather →
      normalize → [augment, ``augment`` a name of
      ``ops/augment.TRANSFORMS``, keyed by ``seed``] → forward → masked
      softmax xent (``loss_kind="mse"``: masked MSE against the float
      targets ``labels`` then holds, ``n_err`` 0) → gradients → per-layer
      update;
    - ``eval_step(params, norm, data, labels, indices, valid) -> (loss,
      n_err, confusion)``;
    - ``train_sweep(params, hypers, norm, data, labels, index_matrix,
      valid_sizes, total_valid, seeds) -> (params, (loss, n_err))`` — a
      whole class sweep, the per-row math of ``train_step`` (row i keyed
      by ``seeds[i]``), metrics summed;
    - ``eval_sweep(...)`` likewise without updates.

    ``indices`` (and each row of ``index_matrix``) is an int64 tensor on
    the data's device; ``valid`` a float; ``norm`` the normalizer's state
    with arrays as device tensors.

    With a ``mesh`` whose ``data`` axis is above 1 (``parallel/mesh.py``)
    every rank takes its block of each minibatch's indices, the rows
    JAX's ``P("data")`` gives its device (``fused.py:529-545``), masks by
    the global position, and merges gradients, ``loss_sum``, ``n_err``
    and the confusion matrix through ``mapreduce.reduce_sum`` over the
    group of this rank's line along ``data`` (``Mesh.axis_group``) before
    the update: the gradients at ``grad_reduce``, the metrics exact. Every
    other axis of the mesh replicates the step. At a data axis of 1 the
    steps are the unsharded ones."""
    if cached:
        installed = _TICK_CACHE.get(_tick_key(
            specs, norm_type, with_confusion, augment, loss_kind,
            grad_reduce, mesh))
        if installed is not None:
            return installed
    layer_fwds = [_layer_forward(s) for s in specs]
    norm_cls = normalizer_registry[norm_type]
    with_confusion = with_confusion and loss_kind == "softmax"
    data_ax = int(mesh.shape.get("data", 1)) if mesh is not None else 1
    if data_ax > 1:
        from veles_tpu_torch.parallel.mapreduce import reduce_sum
        shard, group = mesh.axis_index("data"), mesh.axis_group("data")

    def local_rows(indices):
        """This rank's block of a minibatch's indices and the global
        position of its first row."""
        if data_ax == 1:
            return indices, 0
        rows = indices.shape[0] // data_ax
        return indices[shard * rows:(shard + 1) * rows], shard * rows

    transform = TRANSFORMS.get(augment)

    def gather_norm(data, labels, indices, norm):
        batch, lab = gather_minibatch(data, indices, labels)
        return norm_cls.apply_state(batch, norm), lab

    def model_forward(wb, x):
        for fwd, p in zip(layer_fwds, wb):
            x = fwd(p, x)
        return x

    def metrics_of(wb, batch, lab, valid, offset=0):
        mask = (torch.arange(offset, offset + batch.shape[0],
                             device=batch.device) < valid).float()
        logits = model_forward(wb, batch)
        if loss_kind == "mse":
            _, loss_sum, _ = losses.masked_mse(logits, lab, mask, valid)
            return (loss_sum, torch.zeros((), dtype=torch.int32,
                                          device=logits.device),
                    logits, mask)
        _, loss_sum, n_err, _ = losses.masked_softmax_xent(
            logits, lab, mask, valid)
        return loss_sum, n_err, logits, mask

    def core_train(params, hypers, norm, data, labels, indices, valid,
                   seed):
        indices, offset = local_rows(indices)
        batch, lab = gather_norm(data, labels, indices, norm)
        if transform is not None:
            batch = transform(batch, seed)
        wb = [{k: t.detach().requires_grad_(True)
               for k, t in p["p"].items()} if p else {} for p in params]
        with torch.enable_grad():
            loss_sum, n_err, _, _ = metrics_of(wb, batch, lab, valid,
                                               offset)
            leaves = [t for layer in wb for t in layer.values()]
            flat = torch.autograd.grad(loss_sum / valid, leaves)
        loss_sum = loss_sum.detach()
        if data_ax > 1:
            # the data-parallel merge (fused.py:428-436): the gradients
            # at the configured wire tier, the metrics exact; at f32 all
            # of it rides one reduce
            if grad_reduce == "f32":
                flat, loss_sum, n_err = reduce_sum(
                    (list(flat), loss_sum, n_err), group=group)
            else:
                flat = reduce_sum(list(flat), precision=grad_reduce,
                                  group=group)
                loss_sum, n_err = reduce_sum((loss_sum, n_err),
                                             group=group)
        grads = iter(flat)
        new = []
        with torch.no_grad():
            for p, layer, hyper, spec in zip(params, wb, hypers, specs):
                if not p:
                    new.append({})
                    continue
                g = {k: next(grads) for k in layer}
                lr, lr_b, l2, l1 = hyper[0], hyper[1], hyper[2], hyper[3]
                solver = spec["solver"]
                step = p["t"] + 1.0 if solver != "momentum" else None
                upd = make_updater(solver, hyper, step)
                entry = {"p": {}, "v": {}}
                if solver != "momentum":
                    entry["s"], entry["t"] = {}, step
                for leaf, _, _, use_lr_b, decay in spec["leaves"]:
                    w, gw, vel = p["p"][leaf], g[leaf], p["v"][leaf]
                    if decay:
                        gw = gw + l2 * w + l1 * torch.sign(w)
                    w2, v2, s2 = upd(w, gw, vel,
                                     p["s"][leaf] if solver != "momentum"
                                     else None,
                                     lr_b if use_lr_b else lr)
                    entry["p"][leaf] = w2
                    entry["v"][leaf] = v2
                    if solver != "momentum":
                        entry["s"][leaf] = s2
                new.append(entry)
        return new, (loss_sum, n_err)

    def core_eval(params, norm, data, labels, indices, valid):
        with torch.no_grad():
            indices, offset = local_rows(indices)
            batch, lab = gather_norm(data, labels, indices, norm)
            wb = [p["p"] if p else {} for p in params]
            loss_sum, n_err, logits, mask = metrics_of(wb, batch, lab,
                                                       valid, offset)
            cm = (losses.confusion_matrix(logits, lab, logits.shape[-1],
                                          mask)
                  if with_confusion
                  else torch.zeros((1, 1), dtype=torch.int32,
                                   device=logits.device))
        if data_ax > 1:
            # fused.py:478-481: the eval metrics merge exact
            loss_sum, n_err, cm = reduce_sum((loss_sum, n_err, cm),
                                             group=group)
        return loss_sum, n_err, cm

    def train_step(params, hypers, norm, data, labels, indices, valid,
                   seed=0):
        new, (loss_sum, n_err) = core_train(params, hypers, norm, data,
                                            labels, indices, valid, seed)
        return new, (loss_sum / valid, n_err)

    def eval_step(params, norm, data, labels, indices, valid):
        loss_sum, n_err, cm = core_eval(params, norm, data, labels,
                                        indices, valid)
        return loss_sum / valid, n_err, cm

    def train_sweep(params, hypers, norm, data, labels, index_matrix,
                    valid_sizes, total_valid, seeds=None):
        if seeds is None:
            seeds = [0] * len(valid_sizes)
        loss_total = n_err_total = 0
        for indices, valid, seed in zip(index_matrix, valid_sizes, seeds):
            params, (loss_sum, n_err) = core_train(
                params, hypers, norm, data, labels, indices, float(valid),
                int(seed))
            loss_total = loss_total + loss_sum
            n_err_total = n_err_total + n_err
        return params, (loss_total / total_valid, n_err_total)

    def eval_sweep(params, norm, data, labels, index_matrix, valid_sizes,
                   total_valid):
        loss_total = n_err_total = cm_total = 0
        for indices, valid in zip(index_matrix, valid_sizes):
            loss_sum, n_err, cm = core_eval(params, norm, data, labels,
                                            indices, float(valid))
            loss_total = loss_total + loss_sum
            n_err_total = n_err_total + n_err
            cm_total = cm_total + cm
        return loss_total / total_valid, n_err_total, cm_total

    return train_step, eval_step, train_sweep, eval_sweep


def supports(workflow, mesh=None):
    """True when the workflow's compute chain can run as a fused tick:
    a full-batch loader (whose fill-time transform, if any, is one the
    tick applies itself, and none under a ``mesh``: its per-sample draws
    span the global minibatch, ``fused.py:567-575``), the softmax
    evaluator, or the MSE evaluator over ``FullBatchLoaderMSE``
    (``fused.py:560-564``), layers of the kinds :func:`extract_model_spec`
    knows, exactly the standard topology (a custom unit spliced into the
    cycle would be dropped by the splice), and under a ``mesh`` a
    minibatch that divides by its data axis."""
    from veles_tpu_torch.loader.fullbatch import (FullBatchLoader,
                                                  FullBatchLoaderMSE)
    from veles_tpu_torch.nn.evaluator import EvaluatorMSE, EvaluatorSoftmax

    loader = getattr(workflow, "loader", None)
    if not isinstance(loader, FullBatchLoader):
        return False
    if loader.has_fill_transforms \
            and (loader.jit_transform not in TRANSFORMS
                 or mesh is not None):
        return False
    evaluator = getattr(workflow, "evaluator", None)
    if isinstance(evaluator, EvaluatorMSE):
        # the regression tick gathers the targets from original_targets
        if not isinstance(loader, FullBatchLoaderMSE):
            return False
    elif not isinstance(evaluator, EvaluatorSoftmax):
        return False
    if extract_model_spec(workflow) is None:
        return False
    expected = (list(workflow.forwards) + [workflow.evaluator,
                                           workflow.decision]
                + list(reversed(workflow.gds)))
    if chain_of(workflow) != expected:
        return False
    return mesh is None \
        or loader.max_minibatch_size % mesh.shape.get("data", 1) == 0


class FusedTick(Unit):
    """One workflow tick as one fused train or eval step.

    Reads the loader's served indices and epoch flags, runs the step for
    the tick's sample class, writes the metrics into the evaluator's
    slots (device tensors — the Decision reads them at epoch
    boundaries), and writes weights back into the unit Arrays at epoch
    boundaries. ``minibatch_counts`` counts the minibatches stepped per
    class (TEST, VALID, TRAIN).
    """

    hide_from_registry = True
    VIEW_GROUP = "WORKER"
    #: execution strategy, not topology
    EPHEMERAL = True

    def __init__(self, workflow, mesh=None, pipelined=False, **kwargs):
        super().__init__(workflow, **kwargs)
        #: the data-parallel mesh (``parallel/mesh.py``); the trailing
        #: underscore keeps it out of snapshots (a process group does not
        #: pickle): a resumed run gets it from the launcher again
        self.mesh_ = mesh
        #: pipelined epoch mode: the Decision materializes each epoch's
        #: metrics one epoch late (pipeline_depth=1). The tick then keeps
        #: a one-slot params history so (a) the unit Arrays always hold
        #: the weights the CURRENTLY-ATTRIBUTED metrics scored and (b) a
        #: lagged no-improvement stop can roll back the one
        #: speculatively-trained epoch — outputs stay identical to the
        #: unpipelined run.
        self.pipelined = pipelined
        self.ticks = 0
        self.minibatch_counts = [0, 0, 0]

    @property
    def mesh(self):
        return self.mesh_

    def init_unpickled(self):
        super().init_unpickled()
        if not hasattr(self, "mesh_"):
            self.mesh_ = None
        self._params_ = None
        self._steps_ = None
        self._norm_ = None
        self._specs_ = None
        self._loss_kind_ = "softmax"
        #: control-plane fleet: the parameters before the last TRAIN
        #: tick; a re-issued job (lost update) rolls back to them
        self._rollback_ = None
        self._wrote_eval_params_ = False
        self._eval_stash_ = None  # params evaluated one epoch ago
        self._stashed_this_epoch_ = False

    def initialize(self, **kwargs):
        wf = self.workflow
        loader = wf.loader
        if self.mesh_ is not None:
            # a resumed snapshot can acquire a mesh the build never
            # validated (supports() runs before the splice only):
            # fused.py:664-673
            data_ax = self.mesh_.shape.get("data", 1)
            if loader.max_minibatch_size % data_ax:
                self.warning(
                    "minibatch size %d does not divide by the mesh data "
                    "axis %d — running the fused tick single-device",
                    loader.max_minibatch_size, data_ax)
                self.mesh_ = None
        for fwd in wf.forwards:
            weights = getattr(fwd, "weights", None)
            if weights is not None and weights.data is None:
                return True  # retry after the forwards initialize
        if self.pipelined:
            if (not getattr(loader, "sweep_serving", False)
                    or loader.effective_class_lengths[VALID] == 0):
                # lagged improvement tracking needs a VALID sweep
                self.warning("pipelined mode needs sweep serving and a "
                             "validation split: disabling")
                self.pipelined = False
            wf.decision.pipeline_depth = 1 if self.pipelined else 0
        self._specs_, _, kwargs = tick_config(wf)
        self._loss_kind_ = kwargs["loss_kind"]
        self._norm_ = state_tensors(loader.normalizer.jit_state(),
                                    loader.device)
        if self.mesh_ is not None:
            # the data-parallel steps, instrumented and reduced at the
            # configured wire tier (parallel/mapreduce.py)
            from veles_tpu_torch.parallel.mapreduce import fleet_train_step
            self._steps_ = fleet_train_step(
                self.mesh_, self._specs_, loader.normalization_type,
                **kwargs)
        else:
            self._steps_ = build_tick(self._specs_,
                                      loader.normalization_type, **kwargs)

    def run(self):
        wf = self.workflow
        loader = wf.loader
        control = wf.is_slave and self._control_plane()
        if self._params_ is None or (wf.is_slave and not control):
            # a data-plane SLAVE reads the unit Arrays every tick: the
            # master's job overwrote them (apply_data_from_master)
            self._params_ = get_params(wf, self._specs_)
        train_step, eval_step, train_sweep, eval_sweep = self._steps_
        norm = self._norm_
        data = loader.original_data.data
        mse = self._loss_kind_ == "mse"
        # regression: the labels lane carries the float targets
        labels = (loader.original_targets.data if mse
                  else loader.labels_for_gather())
        indices = torch.from_numpy(loader.minibatch_indices.data).to(
            data.device)
        valid = float(max(loader.minibatch_valid_size, 1))
        klass = loader.minibatch_class
        training = klass == TRAIN
        if control:
            # one-slot rollback: a re-issued job replays from exactly the
            # pre-job parameters; eval ticks change nothing
            self._rollback_ = self._params_ if training else None
        if getattr(loader, "sweep_serving", False):
            sizes = loader.sweep_valid_sizes
            self.minibatch_counts[klass] += len(sizes)
            if training:
                self._params_, (loss, n_err) = train_sweep(
                    self._params_, get_hypers(wf), norm, data, labels,
                    indices, sizes, valid,
                    getattr(loader, "sweep_transform_seeds", None))
            else:
                loss, n_err, cm = eval_sweep(self._params_, norm, data,
                                             labels, indices, sizes, valid)
        else:
            self.minibatch_counts[klass] += 1
            if training:
                self._params_, (loss, n_err) = train_step(
                    self._params_, get_hypers(wf), norm, data, labels,
                    indices, valid,
                    getattr(loader, "minibatch_transform_seed", 0))
            else:
                loss, n_err, cm = eval_step(self._params_, norm, data,
                                            labels, indices, valid)
        evaluator = wf.evaluator
        evaluator.loss.data = loss
        if not mse:
            evaluator.n_err.data = n_err
            if not training and getattr(evaluator, "compute_confusion",
                                        True):
                evaluator.confusion_matrix.data = cm
        self.ticks += 1
        if wf.is_slave:
            if control:
                # the unit Arrays change only at EPOCH FENCES: they feed
                # the fence sync; per-job updates carry scalars only
                if bool(loader.epoch_ended):
                    set_params(wf, self._params_, self._specs_)
            elif training:
                # data plane: the update ships the trained parameters;
                # the epoch accounting lives on the master
                set_params(wf, self._params_, self._specs_)
            return
        if not training and loader.epoch_ended_for_class:
            # write the EVALUATED weights into the unit Arrays now — they
            # stay untouched through the upcoming train sweep
            if self.pipelined:
                # metrics are attributed one epoch late: the Arrays lag
                # the same way. Rotate the one-slot history — write the
                # params the PREVIOUS epoch evaluated, stash the ones
                # this epoch's eval sweep is scoring right now.
                if not self._stashed_this_epoch_:
                    if self._eval_stash_ is not None:
                        set_params(wf, self._eval_stash_, self._specs_)
                    self._eval_stash_ = self._params_
                    self._stashed_this_epoch_ = True
            else:
                set_params(wf, self._params_, self._specs_)
            self._wrote_eval_params_ = True
        if loader.epoch_ended:
            # the eval-tick write stands in for the epoch-end one ONLY
            # when a VALID class exists — improvement then tracks the
            # eval metric; otherwise the Arrays follow the post-train
            # state
            eval_covers = (self._wrote_eval_params_
                           and loader.effective_class_lengths[VALID] > 0)
            if training and not eval_covers:
                set_params(wf, self._params_, self._specs_)
            self._wrote_eval_params_ = False
            self._stashed_this_epoch_ = False

    @staticmethod
    def _control_plane():
        from veles_tpu_torch.fleet import fleet_control_plane
        return fleet_control_plane()

    def rollback_job(self):
        """Control-plane fleet: undo the LAST job's local application.
        True when parameters were restored (the last job trained); False
        when there was nothing to undo (an eval tick). The fleet client
        calls it when the master re-issues work whose update never
        arrived."""
        if self._rollback_ is None:
            return False
        self._params_ = self._rollback_
        self._rollback_ = None
        return True

    def reset_residency(self):
        """Drop the resident parameters so the next tick reads the unit
        Arrays: after a handshake applied the master's weights (first
        join, or a master restart)."""
        self._params_ = None
        self._rollback_ = None

    def advance_eval_params(self):
        """Write the one-slot history's evaluated params into the unit
        Arrays — the Decision calls this when a multi-epoch drain is about
        to attribute an improvement to the NEWER epoch."""
        if self._eval_stash_ is not None:
            set_params(self.workflow, self._eval_stash_, self._specs_)
            self._eval_stash_ = None

    def rollback_speculative(self):
        """A lagged stop decision arrived AFTER one more epoch was
        speculatively dispatched: restore the params to the stopping
        epoch's post-train state (the one-slot stash holds exactly it)."""
        if self._eval_stash_ is not None:
            self._params_ = self._eval_stash_
            self._eval_stash_ = None

    def sync_params(self):
        """Write the CURRENT (post-train) params into the unit Arrays —
        called when the workflow finishes."""
        if self._params_ is not None and self._specs_ is not None:
            set_params(self.workflow, self._params_, self._specs_)
