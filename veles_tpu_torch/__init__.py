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

- the entry points (``__main__.py``, ``launcher.py``, ``cli.py``):
  ``python -m veles_tpu_torch <workflow.py> <config.py> [root.x=y ...]``,
  or the package called as a function, ``veles_tpu_torch("wf.py",
  "cfg.py", seed=1, device="cpu")``; ``snapshotter.py`` (checkpoint and
  resume), ``export.py`` and ``inference.py`` (the package that the C++
  runtime under ``native/`` reads), and the per-tick REST front
  (``serving.RESTfulAPI`` with ``RestfulLoader``).

Entry points take ``device=None``, which means ``"cuda"``; without a
card they raise unless the caller asks for ``device="cpu"``
(``device.resolve_device``).
"""

import sys


def __run__(workflow_file, config_file=None, **kwargs):
    from veles_tpu_torch.cli import run_workflow_file
    return run_workflow_file(workflow_file, config_file, **kwargs)


#: the discovered plugin modules, filled by :func:`scan_plugins`
__plugins__ = None


def scan_plugins():
    """Import the installed plugins and return them: the entry points of
    the ``veles_tpu_torch.plugins`` group (reference ``veles.__plugins__``,
    ``__init__.py:191-215``). Importing a plugin registers its units and
    loaders by name. A plugin that fails to import is reported on stderr
    and skipped. The CLI scans once at startup."""
    global __plugins__
    if __plugins__ is not None:
        return __plugins__
    from importlib.metadata import entry_points

    plugins = []
    for ep in entry_points(group="veles_tpu_torch.plugins"):
        try:
            plugins.append(ep.load())
        except Exception as exc:  # noqa: BLE001 - one bad plugin only
            sys.stderr.write("veles_tpu_torch: plugin entry point %s "
                             "failed: %s\n" % (ep.name, exc))
    __plugins__ = plugins
    return plugins


class _CallableModule(sys.modules[__name__].__class__):
    """The package is callable (reference ``VelesModule``,
    ``__init__.py:126``): ``veles_tpu_torch(...)`` runs a workflow file
    as the command line does."""

    def __call__(self, workflow_file, config_file=None, **kwargs):
        return __run__(workflow_file, config_file, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
