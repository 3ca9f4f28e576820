"""The causal-LM tier (transformer sublayers, dense reference decode and
the paged KV pool) and the training execution tiers (the fused tick, the
sweep and segment tiers)."""

from veles_tpu_torch.parallel.step import build_train_step  # noqa: F401
