"""Causal prefill attention.

The port of ``veles_tpu/ops/attention.py``'s ``attention`` (``:26-39``)
for the prompt lengths the serving slice runs: below 4096 positions the
JAX package computes it with XLA, not with a kernel of its own, and here
it is plain PyTorch in f32. At 4096 positions and more the JAX package
switches to the Pallas flash-attention kernel; its port is a later slice,
so a CUDA call at that length raises instead of running the plain
version.
"""

import math

import torch

#: the JAX package's flash-attention threshold (``attention.py:58``)
FLASH_MIN_T = 4096


def attention(q, k, v, causal=False):
    """Single-device attention over (B, T, H, D) tensors, scaled by
    1/sqrt(D), computed in f32 and returned in q's dtype."""
    t_q, t_k = q.shape[1], k.shape[1]
    if q.device.type == "cuda" and t_q >= FLASH_MIN_T \
            and t_k >= FLASH_MIN_T:
        raise NotImplementedError(
            "attention at T >= %d runs the flash-attention kernel, which "
            "is not ported yet (the flash-attention slice)" % FLASH_MIN_T)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones((t_q, t_k), dtype=torch.bool,
                          device=q.device).tril(t_k - t_q)
        scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
