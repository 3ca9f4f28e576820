"""In-tick data augmentation: per-sample mirrors and shifts of an NHWC
batch.

The port of ``veles_tpu/ops/augment.py:1-53``, under the JAX names
(``mirror_batch``, ``shift_batch``, ``shift1_batch``) and the port's
earlier ones (``mirror``, ``shift1``). The JAX package draws each
sample's flip or shift inside the jitted tick with threefry, keyed by a
scalar seed the loader draws; no torch generator repeats those bits (and
torch's CPU and CUDA generators disagree with each other). So each
transform is a draw and an apply:

- the draw is a pure integer counter hash of (seed, sample): the key
  ``mix32(seed)`` folded with the sample's index (``parallel/decode.
  fold_in``, the sampling hash), so the same bits on the CPU and on the
  card;
- the apply, :func:`mirror_apply` and :func:`shift_apply`, is the JAX
  functions' arithmetic given those draws: exact, whatever drew them.

The tick applies a transform after normalization, as the JAX package
does (``parallel/fused.py:416-418``), so a shift's zero fill is a
normalized zero.
"""

import torch

from veles_tpu_torch.parallel.decode import _MASK32, _mix32, fold_in


def _sample_bits(seed, n, device, stream):
    """(n,) int64 hash bits of samples 0..n-1 for ``seed``, one stream
    of bits per ``stream`` index."""
    key = _mix32(torch.tensor(int(seed), dtype=torch.long,
                              device=device) & _MASK32)
    index = torch.arange(n, dtype=torch.long, device=device)
    return fold_in(fold_in(key, torch.tensor(stream, device=device)), index)


def mirror_draw(seed, n, device):
    """(n,) bool: which samples of the minibatch flip, each with
    probability 1/2."""
    return (_sample_bits(seed, n, device, 0) & 1).bool()


def shift_draw(seed, n, device, max_shift=1):
    """(n,) int64 row and column shifts in [-max_shift, max_shift]."""
    span = 2 * int(max_shift) + 1
    return tuple(_sample_bits(seed, n, device, stream) % span
                 - int(max_shift) for stream in (1, 2))


def shift1_draw(seed, n, device):
    """(n,) int64 row and column shifts in {-1, 0, 1}."""
    return shift_draw(seed, n, device, 1)


def mirror_apply(batch, flip):
    """Flip the samples ``flip`` marks along W (``mirror_batch``)."""
    return torch.where(flip[:, None, None, None], batch.flip(2), batch)


def shift_apply(batch, dh, dw):
    """Translate each sample by (dh, dw) pixels, zero-filled
    (``shift_batch``): output pixel (r, c) reads (r - dh, c - dw)."""
    n, height, width = batch.shape[:3]
    device = batch.device
    rows = torch.arange(height, device=device)[None, :] - dh[:, None]
    cols = torch.arange(width, device=device)[None, :] - dw[:, None]
    row_ok = (rows >= 0) & (rows < height)
    col_ok = (cols >= 0) & (cols < width)
    rows = rows.clamp(0, height - 1)
    cols = cols.clamp(0, width - 1)
    out = batch[torch.arange(n, device=device)[:, None, None],
                rows[:, :, None], cols[:, None, :], :]
    mask = (row_ok[:, :, None] & col_ok[:, None, :])[..., None]
    return torch.where(mask, out, torch.zeros((), dtype=batch.dtype,
                                              device=device))


def mirror_batch(batch, seed):
    """Per-sample random horizontal mirror of NHWC ``batch`` for the
    loader's ``seed`` (``augment.py:13-22``)."""
    return mirror_apply(batch, mirror_draw(seed, batch.shape[0],
                                           batch.device))


def shift_batch(batch, seed, max_shift=1):
    """Per-sample random translation of NHWC ``batch`` by up to
    ``max_shift`` pixels in H and W, zero-filled (``augment.py:25-47``)."""
    dh, dw = shift_draw(seed, batch.shape[0], batch.device, max_shift)
    return shift_apply(batch, dh, dw)


def shift1_batch(batch, seed):
    """Per-sample random translation by up to one pixel in H and W (the
    "shift1" transform; draws through :func:`shift1_draw`)."""
    dh, dw = shift1_draw(seed, batch.shape[0], batch.device)
    return shift_apply(batch, dh, dw)


#: the transforms under the port's earlier names
mirror = mirror_batch
shift1 = shift1_batch

#: transform name -> (batch, seed) fn: the loaders' ``train_transform``
#: names resolve here (``augment.py:50-53``)
TRANSFORMS = {"mirror": mirror_batch, "shift1": shift1_batch}
