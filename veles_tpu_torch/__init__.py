"""veles_tpu_torch: the PyTorch/CUDA port of veles_tpu for NVIDIA Hopper.

The JAX package ``veles_tpu`` stays the reference; this package imports
``torch``, ``numpy`` and the standard library only, never ``jax`` and
never ``veles_tpu``. Its module names follow the JAX package, so each
counterpart is found under the same path:

- ``parallel/transformer_step.py``, ``parallel/decode.py``,
  ``parallel/kv_pool.py``: the causal-LM tier, the dense reference
  decode with the dense slot slab, and the paged KV pool;
- ``ops/quant.py`` (W8A16 int8 matvec, dense int8-KV attention) and
  ``ops/paged_attention.py`` (fused paged decode attention): each a
  hand-written sm_90a CUDA kernel (``ops/csrc/``) beside its plain
  PyTorch version;
- ``serving.py``: ``ContinuousDecoder`` and the ``GenerateAPI`` HTTP
  front on the dense slot slab (the default) or the paged pool;
- the training path: ``models/mlp.py`` and ``models/standard.py`` over
  the engine of ``core/`` (units, workflow, config, PRNG streams),
  ``loader/``, ``nn/`` (dense layers, GD state, evaluator, decision)
  and the fused tick (``parallel/fused.py``), with the blocked GEMM and
  the fused dense layer (``ops/gemm.py``) as hand-written kernels.

Entry points take ``device=None``, which means ``"cuda"``; without a
card they raise unless the caller asks for ``device="cpu"``
(``device.resolve_device``).
"""
