"""The causal-LM toy model's parameters and sublayers (pre-LN blocks,
tanh-GELU MLP, vocab head).

The port of ``veles_tpu/parallel/transformer_step.py:31-92``. Parameters
are a dict of tensors with the JAX pytree's shape, drawn from the same
numpy ``RandomState`` sequence, so one seed gives the same weights in
both packages. The sublayers are shared by the prefill, the dense decode
and the paged decode, as in the JAX package.
"""

import math

import torch
import torch.nn.functional as F

from veles_tpu_torch.device import resolve_device
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
