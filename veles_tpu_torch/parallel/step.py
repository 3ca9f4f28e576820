"""The fused SPMD train step of a unit-chain MLP over ``data`` x ``model``.

The port of ``veles_tpu/parallel/step.py``: the static layer spec is
extracted from a workflow's forwards and gradient-descent units, and one
step runs the forward, the softmax evaluator, the explicit backward and
the momentum update, with no autograd, as the JAX package's step does.

Over a mesh each rank holds its shards (:func:`shard_params`,
:func:`shard_batch`):

- ``data``: its block of the batch rows; the gradients, the loss sum,
  ``n_err`` and the count of valid rows sum over the axis;
- ``model``: Megatron-style column sharding of every layer's weights,
  bias and velocities: each layer's output columns are gathered
  (``collectives.all_gather``) before its bias and activation, each rank
  computes the weight gradient of its own columns, and the input error's
  partial sums over the column shards are summed (``collectives.psum``).

The products run through ``ops.gemm.matmul``: with
``root.common.engine.use_pallas`` on, every product the kernel gate
admits (``gemm._kernel_eligible``) runs K5. Parameters are a dict
``{"w": [...], "b": [...], "vw": [...], "vb": [...]}`` of this rank's
shards; the step returns new tensors and updates none in place (the
JAX step's ``donate`` has no counterpart).
"""

import torch

from veles_tpu_torch.ops import activations as act_lib, losses
from veles_tpu_torch.ops.gemm import matmul
from veles_tpu_torch.parallel import collectives


def extract_layer_spec(workflow):
    """Static per-layer config from a workflow's forwards/gds chains."""
    spec = []
    for i, fwd in enumerate(workflow.forwards):
        gd = workflow.gds[i] if workflow.gds else None
        spec.append({
            "activation": fwd.ACTIVATION,
            "learning_rate": gd.learning_rate if gd else 0.0,
            "learning_rate_bias": (
                gd.learning_rate_bias if gd and gd.learning_rate_bias
                is not None else (gd.learning_rate if gd else 0.0)),
            "weights_decay": gd.weights_decay if gd else 0.0,
            "l1_vs_l2": gd.l1_vs_l2 if gd else 0.0,
            "gradient_moment": gd.gradient_moment if gd else 0.0,
        })
    return spec


def get_params(workflow):
    """Snapshot the unit chain's weights into the step's parameter dict
    (zero velocities where a unit has none yet)."""
    def velocity(array, like):
        return array.data if array.data is not None \
            else torch.zeros_like(like)
    return {
        "w": [fwd.weights.data for fwd in workflow.forwards],
        "b": [fwd.bias.data for fwd in workflow.forwards],
        "vw": [velocity(gd._velocity_w, fwd.weights.data)
               for gd, fwd in zip(workflow.gds, workflow.forwards)],
        "vb": [velocity(gd._velocity_b, fwd.bias.data)
               for gd, fwd in zip(workflow.gds, workflow.forwards)],
    }


def set_params(workflow, params):
    """Write the step's results back into the unit Arrays."""
    for i, fwd in enumerate(workflow.forwards):
        fwd.weights.data = params["w"][i]
        fwd.bias.data = params["b"][i]
        workflow.gds[i]._velocity_w.data = params["vw"][i]
        workflow.gds[i]._velocity_b.data = params["vb"][i]


def build_train_step(layer_spec, mesh=None):
    """The fused train step ``step(params, batch, labels, mask) ->
    (params, (loss, n_err))`` (``step.py:82-168``). With a mesh,
    ``params`` are this rank's column shards and ``batch``, ``labels``
    and ``mask`` its block of rows; the loss and ``n_err`` come back the
    same on every rank."""
    n_layers = len(layer_spec)
    acts = [act_lib.ACTIVATIONS[s["activation"]] for s in layer_spec]
    hyper = [(s["learning_rate"], s["learning_rate_bias"],
              s["weights_decay"], s["l1_vs_l2"], s["gradient_moment"])
             for s in layer_spec]
    data_ax = collectives.axis_size(mesh, "data")
    model_ax = collectives.axis_size(mesh, "model")
    for axis, size in (("data", data_ax), ("model", model_ax)):
        if size > 1:   # every rank makes the groups, in this order
            mesh.axis_group(axis)

    def model_shard(err):
        """This rank's column block of a full-width error."""
        if model_ax == 1:
            return err
        cols = err.shape[1] // model_ax
        return err.narrow(1, mesh.axis_index("model") * cols, cols)

    @torch.no_grad()
    def step(params, batch, labels, mask):
        # forward, saving activations
        x = batch.reshape(batch.shape[0], -1)
        saved = [x]
        for i in range(n_layers):
            y = matmul(x, params["w"][i], out_dtype=torch.float32)
            # columns sharded: assemble the full width and bias
            y = collectives.all_gather(y, mesh, "model", 1) \
                + collectives.all_gather(params["b"][i], mesh, "model", 0)
            if i < n_layers - 1:
                y = acts[i][0](y)
            saved.append(y)
            x = y
        logits = saved[-1]

        # the evaluator: softmax cross-entropy over the global batch
        valid = torch.clamp(collectives.psum(mask.sum(), mesh, "data"),
                            min=1.0)
        err, loss_sum, n_err, _ = losses.masked_softmax_xent(
            logits, labels, mask, valid)
        loss_sum = collectives.psum(loss_sum, mesh, "data")
        n_err = collectives.psum(n_err, mesh, "data")
        loss = loss_sum / valid

        # backward + update, deepest layer first
        new = {key: list(params[key]) for key in ("w", "b", "vw", "vb")}
        for i in reversed(range(n_layers)):
            lr, lr_b, l2, l1, moment = hyper[i]
            w, b = params["w"][i], params["b"][i]
            if i < n_layers - 1:
                err = err * acts[i][1](saved[i + 1])
            err_local = model_shard(err)
            grad_w = matmul(saved[i].T, err_local, out_dtype=torch.float32)
            grad_b = err_local.sum(dim=0)
            grad_w = collectives.psum(grad_w, mesh, "data")
            grad_b = collectives.psum(grad_b, mesh, "data")
            grad_w = grad_w + l2 * w + l1 * torch.sign(w)
            if i > 0:
                err = matmul(err_local, w.T, out_dtype=torch.float32)
                # partial over the column shards
                err = collectives.psum(err, mesh, "model")
            vw = moment * new["vw"][i] - lr * grad_w
            vb = moment * new["vb"][i] - lr_b * grad_b
            new["w"][i] = w + vw
            new["b"][i] = b + vb
            new["vw"][i] = vw
            new["vb"][i] = vb
        return new, (loss, n_err)

    return step


def _block(t, mesh, axis, dim):
    n = int(mesh.shape.get(axis, 1))
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.axis_index(axis) * size, size).contiguous()


def shard_params(params, mesh):
    """This rank's shards of a whole parameter dict: the columns of each
    weight and velocity, the entries of each bias, by its ``model``
    coordinate (``step.py:185-194``)."""
    return {"w": [_block(w, mesh, "model", 1) for w in params["w"]],
            "b": [_block(b, mesh, "model", 0) for b in params["b"]],
            "vw": [_block(v, mesh, "model", 1) for v in params["vw"]],
            "vb": [_block(v, mesh, "model", 0) for v in params["vb"]]}


def shard_batch(arrays, mesh):
    """This rank's rows of ``(batch, labels, mask)`` by its ``data``
    coordinate (``step.py:197-199``)."""
    return [_block(a, mesh, "data", 0) for a in arrays]
