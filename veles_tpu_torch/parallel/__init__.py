"""The causal-LM tier (transformer sublayers, dense reference decode and
the paged KV pool) and the training execution tiers (the fused tick, the
sweep and segment tiers)."""
