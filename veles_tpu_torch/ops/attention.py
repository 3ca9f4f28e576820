"""Causal prefill attention.

The port of ``veles_tpu/ops/attention.py``'s ``attention`` (``:26-59``).
The JAX package computes it with XLA, not with a kernel of its own,
except where :func:`uses_flash` holds: at 4096 positions and more on
both sides with a head width that is a multiple of 128, it runs the
Pallas flash-attention kernel. Everywhere else the port computes it in
plain PyTorch in f32; the flash kernel's port is a later slice, so a
CUDA call that the rule sends to it raises instead of running the plain
version.
"""

import math

import torch

#: the JAX package's flash-attention threshold (``attention.py:58``)
FLASH_MIN_T = 4096
#: the flash kernel tiles head_dim onto 128-wide blocks
#: (``attention.py:59``)
FLASH_HEAD_MULTIPLE = 128


def uses_flash(t_q, t_k, head_dim):
    """The JAX package's rule for the flash kernel
    (``_use_pallas_flash``, its backend check left aside): ``t_q`` and
    ``t_k`` at least :data:`FLASH_MIN_T` and ``head_dim`` a multiple of
    :data:`FLASH_HEAD_MULTIPLE`."""
    return (t_q >= FLASH_MIN_T and t_k >= FLASH_MIN_T
            and head_dim % FLASH_HEAD_MULTIPLE == 0)


def plain_attention(q, k, v, causal=False):
    """Attention over (B, T, H, D) tensors in f32, scaled by 1/sqrt(D),
    returned in q's dtype. ``causal`` aligns the query rows with the
    LAST ``t_q`` key positions: query j sees keys up to ``t_k - t_q +
    j``, which is the prefix-offset mask of a tail prefill."""
    t_q, t_k = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones((t_q, t_k), dtype=torch.bool,
                          device=q.device).tril(t_k - t_q)
        scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attention(q, k, v, causal=False):
    """Single-device attention over (B, T, H, D) tensors, scaled by
    1/sqrt(D), computed in f32 and returned in q's dtype. Raises
    NotImplementedError on CUDA where :func:`uses_flash` holds."""
    if q.device.type == "cuda" and uses_flash(q.shape[1], k.shape[1],
                                              q.shape[-1]):
        raise NotImplementedError(
            "attention at T >= %d with head_dim %% %d == 0 runs the "
            "flash-attention kernel, which is not ported yet (ROADMAP "
            "queue item A3)" % (FLASH_MIN_T, FLASH_HEAD_MULTIPLE))
    return plain_attention(q, k, v, causal)
