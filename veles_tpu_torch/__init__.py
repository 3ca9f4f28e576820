"""veles_tpu_torch: the PyTorch/CUDA port of veles_tpu for NVIDIA Hopper.

The JAX package ``veles_tpu`` stays the reference; this package imports
``torch``, ``numpy`` and the standard library only, never ``jax`` and
never ``veles_tpu``. Its module names follow the JAX package, so each
counterpart is found under the same path:

- ``parallel/transformer_step.py``, ``parallel/decode.py``,
  ``parallel/kv_pool.py``: the causal-LM tier, dense reference decode
  and the paged KV pool;
- ``ops/quant.py`` (W8A16 int8 matvec) and ``ops/paged_attention.py``
  (fused paged decode attention): each a hand-written sm_90a CUDA
  kernel (``ops/csrc/``) beside its plain PyTorch version;
- ``serving.py``: ``ContinuousDecoder`` and the ``GenerateAPI`` HTTP
  front on the paged pool.

Entry points take ``device=None``, which means ``"cuda"``; without a
card they raise unless the caller asks for ``device="cpu"``
(``device.resolve_device``).
"""
