"""Expert parallelism over the mesh's ``expert`` axis.

The port of ``veles_tpu/parallel/expert.py``: a GShard-style top-1
mixture-of-experts feed-forward. Each rank holds ``n_experts / n`` of the
experts (:func:`shard_moe_params`; the gate whole on every rank) and its
block of the tokens, and the tokens move to their experts by
``collectives.all_to_all``:

    gate (whole) -> top-1 route -> capacity-bounded dense dispatch ->
    all_to_all (tokens to the experts' ranks) -> expert FFN (batched
    products) -> all_to_all back -> combine weighted by the gate
    probability.

Tokens past an expert's capacity are dropped (GShard semantics), and the
dropped fraction is averaged over the axis. The train step
differentiates through the dispatch, both ``all_to_all``\\ s (their
backward is the inverse ``all_to_all``) and the gate probability of the
combine; the gate's gradient, of this rank's tokens, is summed over the
axis as ``shard_map`` sums the cotangent of an input it replicates.
"""

import torch
import torch.nn.functional as F

from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.parallel import collectives


def init_moe_params(rng, n_experts, d_model, d_hidden, device=None):
    """Gate and per-expert FFN weights from the numpy RandomState ``rng``
    (``expert.py:28-40``: gate, then w1, then w2, in float32), as float32
    tensors on ``device``."""
    device = resolve_device(device)
    scale = 1.0 / (d_model ** 0.5)

    def tensor(a):
        return torch.from_numpy(a.astype("float32")).to(device)

    gate = tensor(rng.randn(d_model, n_experts) * scale)
    w1 = tensor(rng.randn(n_experts, d_model, d_hidden) * scale)
    b1 = torch.zeros((n_experts, d_hidden), device=device)
    w2 = tensor(rng.randn(n_experts, d_hidden, d_model) * scale)
    b2 = torch.zeros((n_experts, d_model), device=device)
    return {"gate": gate, "w1": w1, "b1": b1, "w2": w2, "b2": b2}


def shard_moe_params(params, mesh):
    """This rank's experts (``expert.py:43-48``): each expert leaf's block
    of its leading dimension at the rank's ``expert`` coordinate; the
    gate whole."""
    n = collectives.axis_size(mesh, "expert")
    index = mesh.axis_index("expert") if n > 1 else 0

    def block(name, a):
        if name == "gate" or n == 1:
            return a
        size = a.shape[0] // n
        return a[index * size:(index + 1) * size].contiguous()
    return {name: block(name, a) for name, a in params.items()}


def make_moe_ffn(mesh, n_experts, capacity_factor=2.0):
    """``moe(params, x) -> (y, dropped)`` over ``mesh``
    (``expert.py:51-110``): ``params`` this rank's shard
    (:func:`shard_moe_params`), ``x`` its block of the tokens (T_local,
    d_model) in axis order, ``y`` the block's outputs and ``dropped``
    the fraction of tokens past capacity, averaged over the axis."""
    ep = collectives.axis_size(mesh, "expert")
    if n_experts % ep:
        raise ValueError("n_experts must divide the expert axis")
    e_local = n_experts // ep
    if ep > 1:
        mesh.axis_group("expert")

    def moe(p, x_local):
        t_local, d_model = x_local.shape
        capacity = max(1, int(t_local * capacity_factor / n_experts))
        # route: each rank gates its own tokens
        probs = torch.softmax(x_local @ p["gate"], dim=1)       # (T, E)
        choice = probs.argmax(dim=1)                              # (T,)
        gate_val = probs.amax(dim=1)                              # (T,)
        onehot = F.one_hot(choice, n_experts).to(x_local.dtype)   # (T, E)
        # position of each token within its expert's queue
        position = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
        kept = (position < capacity) * onehot                     # (T, E)
        dropped = 1.0 - kept.sum(dim=1)
        pos = (position * kept).sum(dim=1).long()
        # dense dispatch (T, E, C)
        dispatch = kept[:, :, None] * F.one_hot(pos, capacity).to(
            x_local.dtype)[:, None, :]
        # (E, C, D): each expert's padded token buffer from this rank
        expert_in = torch.einsum("tec,td->ecd", dispatch, x_local)
        # (E, C, D) -> (e_local, ep * C, D): the experts gather their
        # tokens from every rank
        expert_in = expert_in.reshape(ep, e_local, capacity, d_model)
        expert_in = collectives.all_to_all(expert_in, mesh, "expert", 0, 0,
                                           tiled=False)  # (ep, eL, C, D)
        expert_in = expert_in.transpose(0, 1).reshape(
            e_local, ep * capacity, d_model)
        # the expert FFN, batched over the local experts
        h = torch.relu(torch.einsum("ecd,edh->ech", expert_in, p["w1"])
                       + p["b1"][:, None, :])
        out = torch.einsum("ech,ehd->ecd", h, p["w2"]) \
            + p["b2"][:, None, :]
        # back to the tokens' ranks
        out = out.reshape(e_local, ep, capacity, d_model).transpose(0, 1)
        out = collectives.all_to_all(out, mesh, "expert", 0, 0,
                                     tiled=False)
        out = out.reshape(n_experts, capacity, d_model)          # (E, C, D)
        y = torch.einsum("tec,ecd->td", dispatch, out) * gate_val[:, None]
        return y, collectives.pmean(dropped.mean().detach(), mesh,
                                    "expert")

    return moe


def make_moe_train_step(mesh, n_experts, capacity_factor=2.0,
                        learning_rate=0.01):
    """A train step through the sharded MoE (``expert.py:113-139``): the
    MSE of the outputs against per-token targets, SGD.
    ``step(params, x, targets) -> (new_params, loss)`` with ``params``
    this rank's shard and ``x``, ``targets`` its block of the tokens; the
    loss is the mean over every rank's tokens, the gate's update the same
    on every rank."""
    moe = make_moe_ffn(mesh, n_experts, capacity_factor)
    ep = collectives.axis_size(mesh, "expert")

    def step(params, x, targets):
        names = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        with torch.enable_grad():
            y, _ = moe(dict(zip(names, leaves)), x)
            # this rank's share of the mean over every rank's tokens
            loss = ((y - targets) ** 2).sum() / (y.numel() * ep)
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        grads["gate"] = collectives.psum(grads["gate"], mesh, "expert")
        loss = collectives.psum(loss.detach(), mesh, "expert")
        with torch.no_grad():
            new = {k: params[k] - learning_rate * grads[k] for k in names}
        return new, loss

    return step


def reference_moe(params, x):
    """One process's dense reference with no capacity drops
    (``expert.py:142-152``): every token through its argmax expert,
    weighted by its gate probability. The JAX package gathers a
    (d_model, d_hidden) matrix a token; this groups the tokens by expert
    instead (the same per-token products, in memory that a full-width
    token count can afford)."""
    probs = torch.softmax(x @ params["gate"], dim=1)
    choice = probs.argmax(dim=1)
    gate_val = probs.amax(dim=1)
    out = x.new_zeros((x.shape[0], params["w2"].shape[2]))
    for e in range(params["gate"].shape[1]):
        rows = torch.nonzero(choice == e).squeeze(1)
        if rows.numel():
            h = torch.relu(x[rows] @ params["w1"][e] + params["b1"][e])
            out = out.index_copy(0, rows, h @ params["w2"][e]
                                 + params["b2"][e])
    return out * gate_val[:, None]
