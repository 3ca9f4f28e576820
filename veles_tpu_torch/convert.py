"""Carry parameter trees between the JAX package and the port.

A JAX parameter tree (``veles_tpu.parallel.transformer_step.
init_transformer_params``, or ``decode.quantize_params``'s int8 tier with
its ``{"q8", "scale"}`` leaves) has the same nesting as the port's dict
of tensors, so the conversion is leaf by leaf. Leaves arrive as numpy
arrays (or anything ``numpy.asarray`` reads, JAX arrays included); this
module never imports JAX.
"""

import numpy
import torch

from veles_tpu_torch.device import resolve_device, tree_to


def _leaf_from_numpy(value):
    array = numpy.array(value)   # a writable copy: JAX hands read-only views
    if str(array.dtype) == "bfloat16":
        # ml_dtypes' bfloat16, which torch cannot wrap: widen exactly to
        # f32 and narrow back
        return torch.from_numpy(array.astype(numpy.float32)).to(
            torch.bfloat16)
    return torch.from_numpy(array)


def _from_tree(tree):
    if isinstance(tree, dict):
        return {key: _from_tree(val) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_from_tree(val) for val in tree]
    return _leaf_from_numpy(tree)


def params_from_jax(tree, device=None, dtype=None):
    """The port's parameter dict from a JAX tree of arrays, on ``device``
    (None means "cuda"). Leaves keep their type (bfloat16 included)
    unless ``dtype`` is given, which floating leaves are cast to except
    the int8 tier's f32 ``scale`` leaves; int8 ``q8`` leaves stay
    int8."""
    return tree_to(_from_tree(tree), resolve_device(device), dtype)


def params_to_numpy(params):
    """The same nesting with numpy leaves (bfloat16 widened exactly to
    float32, which numpy lacks)."""
    if isinstance(params, dict):
        return {key: params_to_numpy(val) for key, val in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(val) for val in params]
    tensor = params.detach().cpu()
    if tensor.dtype == torch.bfloat16:
        tensor = tensor.float()
    return tensor.numpy()
