"""The causal-LM tier: transformer sublayers, dense reference decode and
the paged KV pool."""
