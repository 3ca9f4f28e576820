"""Pipeline parallelism over the mesh's ``pipe`` axis.

The port of ``veles_tpu/parallel/pipeline.py``: a GPipe-style
microbatch pipeline. Each rank of the ``pipe`` axis holds one stage's
weights (:func:`shard_stage_weights`) and runs the classic
``n_micro + n_stages - 1`` fill and drain schedule: at step t stage 0
feeds itself microbatch t, every other stage takes what the stage before
it handed on at step t - 1 (``collectives.ppermute`` around the axis),
and the last stage's outputs from step ``n_stages - 1`` on are the
batch's, which a masked ``psum`` hands to every stage.

The train step differentiates the schedule with autograd: the backward
of each ``ppermute`` is the reverse ``ppermute``, so the gradients run
from the last stage to the first in the mirrored schedule, and
``remat=True`` recomputes each stage in the backward
(``torch.utils.checkpoint``) instead of keeping its activations. As in
the JAX package every stage computes at every step, the bubbles
included (on zeros or a repeated microbatch; their results reach no
output), and picks its input with a ``where``: every rank then builds
the same graph, so every rank issues the same collectives in the same
order in the backward, which a rank-dependent graph would not (autograd
runs only the nodes on a path to the gradients asked for). An optional
``data`` axis composes pp x dp: rows split over it, gradients averaged.

The stage function is uniform, ``stage_fn(w, x) -> y`` with ``x`` and
``y`` of one shape (microbatch, ...), and ``w`` one stage's weights.
"""

import torch
from torch.utils.checkpoint import checkpoint

from veles_tpu_torch.device import tree_leaves_with_path, tree_rebuild
from veles_tpu_torch.parallel import collectives


def _leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def _map(fn, tree):
    return tree_rebuild(tree, iter([fn(leaf) for leaf in _leaves(tree)]))


def _pipeline_body(mesh, stage_fn, n_stages, n_microbatches, remat):
    """The pipelined forward of this rank's stage: ``forward(w_local,
    batch)`` gives the whole batch's outputs on every stage."""
    stage = mesh.axis_index("pipe") if n_stages > 1 else 0
    n_steps = n_microbatches + n_stages - 1
    if n_stages > 1:
        mesh.axis_group("pipe")

    def run(w, x):
        if remat:
            return checkpoint(stage_fn, w, x, use_reentrant=False)
        return stage_fn(w, x)

    def forward(w_local, batch):
        w = _map(lambda a: a[0], w_local)  # this stage's weights
        micro = batch.reshape((n_microbatches, -1) + tuple(batch.shape[1:]))
        first = torch.tensor(stage == 0, device=batch.device)
        last = torch.tensor(stage == n_stages - 1, device=batch.device)
        incoming = torch.zeros_like(micro[0])
        ys = []
        for t in range(n_steps):
            feed = micro[min(t, n_microbatches - 1)]
            y = run(w, torch.where(first, feed, incoming))
            ys.append(y)
            if t < n_steps - 1:   # the last step's hand-off feeds nothing
                incoming, = collectives.ppermute((y,), mesh, "pipe")
        outputs = torch.stack(ys[n_stages - 1:])
        # only the last stage holds real outputs: the psum of the masked
        # buffers hands them to every stage
        outputs = collectives.psum(
            torch.where(last, outputs, torch.zeros_like(outputs)), mesh,
            "pipe")
        return outputs.reshape((batch.shape[0],) + tuple(outputs.shape[2:]))

    return forward


def make_pipeline(mesh, stage_fn, n_microbatches, remat=False):
    """The pipelined forward (``pipeline.py:75-100``):
    ``pipeline(stage_weights, batch)`` with ``stage_weights`` this rank's
    block (:func:`shard_stage_weights`: leading dimension 1) and
    ``batch`` whole, split into ``n_microbatches`` along dimension 0;
    returns the whole batch's outputs on every rank."""
    n_stages = int(mesh.shape["pipe"])
    forward = _pipeline_body(mesh, stage_fn, n_stages, n_microbatches,
                             remat)

    def pipeline(stage_weights, batch):
        _validate(stage_weights, batch, n_stages, n_microbatches)
        return forward(stage_weights, batch)

    return pipeline


def _validate(stage_weights, batch, n_stages, n_microbatches, data_ax=1):
    """Fail here with the constraint's names (``pipeline.py:103-121``):
    (a) this rank's block holds one stage's weights (leading dimension
    1: a whole tree would run stage 0's weights on every rank); (b) the
    batch shards over ``data`` and each shard splits into
    microbatches."""
    for leaf in _leaves(stage_weights):
        if leaf.shape[0] != 1:
            raise ValueError(
                "stage weights leading dim %d != 1: a rank takes its "
                "block of the pipe axis %d (shard_stage_weights)"
                % (leaf.shape[0], n_stages))
    rows = batch.shape[0]
    if rows % data_ax:
        raise ValueError(
            "batch size %d does not shard over data axis %d"
            % (rows, data_ax))
    if (rows // data_ax) % n_microbatches:
        raise ValueError(
            "batch size %d (per data shard: %d) does not divide into "
            "%d microbatches" % (rows, rows // data_ax, n_microbatches))


def shard_stage_weights(weights, mesh):
    """This rank's stage of stage-major weights (``pipeline.py:124-127``):
    each leaf's row at its ``pipe`` coordinate, leading dimension kept.
    Every leaf's leading dimension must be the pipe axis's size."""
    n_stages = int(mesh.shape["pipe"])
    for leaf in _leaves(weights):
        if leaf.shape[0] != n_stages:
            raise ValueError(
                "stage weights leading dim %d != pipe axis %d"
                % (leaf.shape[0], n_stages))
    stage = mesh.axis_index("pipe")
    return _map(lambda a: a[stage:stage + 1].contiguous(), weights)


def make_pipeline_train_step(mesh, stage_fn, n_microbatches, loss_fn,
                             learning_rate=0.01, remat=True):
    """A pipelined train step (``pipeline.py:130-179``): the forward's
    fill and drain, the backward's mirrored schedule through the reverse
    ``ppermute``\\ s (each stage recomputed with ``remat``), and SGD.
    ``loss_fn(outputs, targets) -> scalar`` reads the batch's outputs.
    With a ``data`` axis above 1, each rank takes its block of the rows
    of ``batch`` and ``targets`` (both whole here), the loss is averaged
    over the axis and the gradients too (pp x dp).

    Returns ``step(stage_weights, batch, targets) -> (new_weights,
    loss)``, the weights this rank's stage block."""
    n_stages = int(mesh.shape["pipe"])
    data_ax = collectives.axis_size(mesh, "data")
    if data_ax > 1:
        mesh.axis_group("data")
    forward = _pipeline_body(mesh, stage_fn, n_stages, n_microbatches,
                             remat)

    def rows(a):
        if data_ax == 1:
            return a
        size = a.shape[0] // data_ax
        return a[mesh.axis_index("data") * size:][:size]

    def train_step(stage_weights, batch, targets):
        _validate(stage_weights, batch, n_stages, n_microbatches, data_ax)
        batch, targets = rows(batch), rows(targets)
        leaves = [leaf.detach().requires_grad_(True)
                  for leaf in _leaves(stage_weights)]
        with torch.enable_grad():
            outputs = forward(tree_rebuild(stage_weights, iter(leaves)),
                              batch)
            loss = collectives.pmean(loss_fn(outputs, targets), mesh,
                                     "data")
            grads = torch.autograd.grad(loss, leaves)
        # the loss is replicated over pipe by the masked psum, whose
        # backward (psum) sums every stage's seed: normalize back
        grads = [g / n_stages for g in grads]
        if data_ax > 1:
            # each data shard's gradients are of its rows: average them
            grads = [g / data_ax for g in collectives.psum_flat(
                grads, mesh, "data")]
        with torch.no_grad():
            new = [w - learning_rate * g for w, g in zip(leaves, grads)]
        return tree_rebuild(stage_weights, iter(new)), loss.detach()

    return train_step


def sequential_reference(stage_fn, stage_weights, batch):
    """One process's reference of the same pipeline: the stages of the
    whole stage-major weights applied in order (``pipeline.py:182-190``)."""
    x = batch
    n_stages = _leaves(stage_weights)[0].shape[0]
    for i in range(n_stages):
        x = stage_fn(_map(lambda a, i=i: a[i], stage_weights), x)
    return x
