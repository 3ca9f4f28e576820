"""The causal-LM toy model (pre-LN blocks, tanh-GELU MLP, vocab head)
and its sequence-parallel train step.

The port of ``veles_tpu/parallel/transformer_step.py``. Parameters are a
dict of tensors with the JAX pytree's shape, drawn from the same numpy
``RandomState`` sequence, so one seed gives the same weights in both
packages. The sublayers are shared by the prefill, the dense decode, the
paged decode and the train step, as in the JAX package.

:func:`build_transformer_train_step` is the long-context training step
under a ``data`` x ``seq`` mesh: each rank holds its block of the batch
rows (``data``) and of the positions (``seq``), attention runs
sequence-parallel (Ulysses all-to-all or ring attention,
``ops/attention.py``), every other sublayer is token-local, and the
gradients, the loss and ``n_err`` are summed over ``data`` and then over
``seq``, so every rank applies the same update. A mesh axis the step
does not name (``model``, ``pipe``, ``expert``) replicates it, as
``shard_map`` does for an axis its specs leave out.
"""

import math

import torch
import torch.nn.functional as F

from veles_tpu_torch.device import (resolve_device, tree_leaves_with_path,
                                    tree_rebuild)
from veles_tpu_torch.ops.attention import (attention, ring_attention,
                                           ulysses_attention)
from veles_tpu_torch.ops.quant import matmul_any


def init_transformer_params(rng, n_blocks, embed, heads, vocab,
                            mlp_ratio=4, dtype=torch.float32, device=None):
    """Parameter dict; ``rng`` is a numpy RandomState, drawn exactly as
    the JAX package draws it (float32 ``randn / sqrt(fan_in)``), then
    cast to ``dtype`` on ``device``."""
    device = resolve_device(device)

    def mat(a, b):
        w = rng.randn(a, b).astype("float32") / math.sqrt(a)
        return torch.from_numpy(w).to(device=device, dtype=dtype)

    def const(value, n):
        return torch.full((n,), value, dtype=dtype, device=device)

    hidden = embed * mlp_ratio
    blocks = []
    for _ in range(n_blocks):
        blocks.append({
            "ln1_w": const(1.0, embed), "ln1_b": const(0.0, embed),
            "wqkv": mat(embed, 3 * embed), "bqkv": const(0.0, 3 * embed),
            "wout": mat(embed, embed), "bout": const(0.0, embed),
            "ln2_w": const(1.0, embed), "ln2_b": const(0.0, embed),
            "w1": mat(embed, hidden), "b1": const(0.0, hidden),
            "w2": mat(hidden, embed), "b2": const(0.0, embed),
        })
    return {"blocks": blocks,
            "lnf_w": const(1.0, embed), "lnf_b": const(0.0, embed),
            "head": mat(embed, vocab)}


def _ln(x, w, b, eps=1e-5):
    """Layer norm with the biased variance, as ``jnp.var``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def _block_qkv(blk, x, heads):
    """Pre-LN qkv projection: (B, T, E) -> three (B, T, H, D). The split
    is by the projection's own width, a third of its columns each: on a
    rank of the tensor-parallel engine (``parallel/tp_engine.py``) the
    projection holds [q | k | v] of that rank's ``heads`` alone
    (``decode.shard_slot_params``), and splitting by the embedding width
    would mix q, k and v across heads."""
    batch, t, _ = x.shape
    h = _ln(x, blk["ln1_w"], blk["ln1_b"])
    qkv = matmul_any(h, blk["wqkv"]) + blk["bqkv"]
    width = qkv.shape[-1] // 3
    q, k, v = torch.split(qkv, width, dim=-1)
    shape = (batch, t, heads, width // heads)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _attn_out(blk, x, att, reduce=None):
    """The attention sublayer's residual: ``x + att @ wout + bout`` with
    ``att`` (B, T, H, D) flattened over its heads. ``reduce`` completes a
    head-sharded out-projection (the rows of this rank's heads; the
    tensor-parallel engine passes its all-reduce), and ``bout`` is added
    after it, as ``_mlp`` adds ``b2``."""
    y = matmul_any(att.reshape(att.shape[0], att.shape[1], -1),
                   blk["wout"])
    if reduce is not None:
        y = reduce(y)
    return x + y + blk["bout"]


def _mlp(blk, x, reduce=None):
    """Pre-LN residual MLP with the tanh GELU (``jax.nn.gelu``'s
    default). ``reduce`` completes a sharded contraction (the
    tensor-parallel engine's all-reduce over ``w1``'s column and ``w2``'s
    row shards); ``b2`` is added after it, so it stays whole — one copy
    of the math for one rank or many, as the JAX package's ``_mlp``
    (``veles_tpu/parallel/transformer_step.py:74-86``)."""
    h = _ln(x, blk["ln2_w"], blk["ln2_b"])
    y = matmul_any(
        F.gelu(matmul_any(h, blk["w1"]) + blk["b1"], approximate="tanh"),
        blk["w2"])
    if reduce is not None:
        y = reduce(y)
    return x + y + blk["b2"]


def _head(params, x):
    """Final layer norm + vocab projection."""
    return matmul_any(_ln(x, params["lnf_w"], params["lnf_b"]),
                      params["head"])


def _forward(params, x, heads, mesh, seq_ax, sp_strategy):
    """The logits of this rank's tokens (``transformer_step.py:95-108``):
    ``x`` (B, T_local, E), attention over the ``seq`` axis when it is
    above 1."""
    for blk in params["blocks"]:
        q, k, v = _block_qkv(blk, x, heads)
        if seq_ax > 1 and sp_strategy == "ring":
            att = ring_attention(q, k, v, mesh, "seq", causal=True)
        elif seq_ax > 1:
            att = ulysses_attention(q, k, v, mesh, "seq", causal=True)
        else:
            att = attention(q, k, v, causal=True)
        x = _mlp(blk, _attn_out(blk, x, att))
    return _head(params, x)


def build_transformer_train_step(heads, mesh=None, learning_rate=0.1,
                                 sp_strategy="ulysses"):
    """``step(params, x, labels) -> (params, (loss, n_err))``
    (``transformer_step.py:111-151``): per-token causal-LM softmax
    cross-entropy over the global token count, SGD. With a mesh, ``x``
    and ``labels`` are this rank's (data, seq) blocks
    (:func:`shard_tokens`), the parameters whole on every rank; the
    gradients, the loss and ``n_err`` sum over ``data`` and then over
    ``seq``, so the returned parameters hold the same bits on every rank.
    ``sp_strategy`` picks "ulysses" (all-to-all) or "ring" attention."""
    from veles_tpu_torch.parallel import collectives

    if sp_strategy not in ("ulysses", "ring"):
        raise ValueError("sp_strategy must be 'ulysses' or 'ring', got %r"
                         % (sp_strategy,))
    data_ax = collectives.axis_size(mesh, "data")
    seq_ax = collectives.axis_size(mesh, "seq")
    axes = [axis for axis, size in (("data", data_ax), ("seq", seq_ax))
            if size > 1]
    for axis in axes:   # every rank makes the groups, in this order
        mesh.axis_group(axis)

    def step(params, x, labels):
        n_tokens = float(x.shape[0] * x.shape[1] * data_ax * seq_ax)
        leaves = [t.detach().requires_grad_(True)
                  for _, t in tree_leaves_with_path(params)]
        with torch.enable_grad():
            logits = _forward(tree_rebuild(params, iter(leaves)), x, heads,
                              mesh, seq_ax, sp_strategy)
            logp = torch.log_softmax(logits, dim=-1)
            picked = logp.gather(-1, labels[..., None].long())[..., 0]
            loss = -picked.sum().float() / n_tokens
            grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        n_err = (logits.detach().argmax(-1) != labels).sum()
        for axis in axes:
            grads = collectives.psum_flat(grads, mesh, axis)
            loss, n_err = (collectives.psum(t, mesh, axis)
                           for t in (loss, n_err))
        with torch.no_grad():
            new = [p - learning_rate * g for p, g in zip(leaves, grads)]
        return tree_rebuild(params, iter(new)), (loss, n_err)

    return step


def shard_tokens(arrays, mesh):
    """This rank's block of ``(x, labels)`` under (data, seq)
    (``transformer_step.py:154-160``): ``x`` (B, T, E) and ``labels``
    (B, T), rows split over ``data`` and positions over ``seq``."""
    out = []
    for a in arrays:
        for dim, axis in ((0, "data"), (1, "seq")):
            n = int(mesh.shape.get(axis, 1))
            if n > 1:
                size = a.shape[dim] // n
                a = a.narrow(dim, mesh.axis_index(axis) * size, size)
        out.append(a.contiguous())
    return out
