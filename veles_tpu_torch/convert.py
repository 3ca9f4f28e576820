"""Carry parameters between the JAX package and the port.

Serving: a JAX parameter tree (``veles_tpu.parallel.transformer_step.
init_transformer_params``, or ``decode.quantize_params``'s int8 tier with
its ``{"q8", "scale"}`` leaves) has the same nesting as the port's dict
of tensors, so the conversion is leaf by leaf. Leaves arrive as numpy
arrays (or anything ``numpy.asarray`` reads, JAX arrays included); this
module never imports JAX.

Training: :func:`unit_params_from_jax` puts a JAX workflow's unit
parameters (weights, biases, and the GD units' state: velocities, the
stateful solvers' second moments and step count, as numpy arrays) into
the port's units before ``initialize()``, which then draws nothing, so
both packages train from the same state; :func:`unit_state_of` reads
those dicts off either package's workflow. :func:`som_weights_from_jax`
does the same for a Kohonen map's weights.

Normalizers: :func:`normalizer_state` reads a normalizer's accumulated
statistics (its ``state``, the attributes ``jit_state()`` derives from,
under the JAX package's names) from either package as numpy, and
:func:`normalizers_from_jax` hands a JAX loader's normalizer and MSE
target normalizer to a port loader before ``initialize()``, which then
builds them with ``state=`` instead of analysing.
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


#: the per-layer keys :func:`unit_params_from_jax` reads: (key, unit,
#: attribute); the unit is the forward ("fwd") or its GD twin ("gd"). The
#: out_* keys are the self-attention and feed-forward units' second
#: projection
UNIT_PARAM_SLOTS = (("weights", "fwd", "weights"), ("bias", "fwd", "bias"),
                    ("out_weights", "fwd", "out_weights"),
                    ("out_bias", "fwd", "out_bias"),
                    ("velocity_w", "gd", "_velocity_w"),
                    ("velocity_b", "gd", "_velocity_b"),
                    ("velocity_ow", "gd", "_velocity_ow"),
                    ("velocity_ob", "gd", "_velocity_ob"),
                    ("second_w", "gd", "_second_w"),
                    ("second_b", "gd", "_second_b"),
                    ("second_ow", "gd", "_second_ow"),
                    ("second_ob", "gd", "_second_ob"),
                    ("step", "gd", "_step"))


def unit_params_from_jax(workflow, layers):
    """Fill a port ``StandardWorkflow``'s unit slots before
    ``initialize()``. ``layers`` has one dict per forward layer with
    numpy (or numpy-readable) ``"weights"``, ``"bias"`` and optionally
    ``"velocity_w"``/``"velocity_b"`` (a conv layer's HWIO weights as
    the JAX package holds them); a self-attention or feed-forward layer
    also ``"out_weights"``/``"out_bias"`` and optionally
    ``"velocity_ow"``/``"velocity_ob"``; with the adam or adagrad solver
    optionally ``"second_*"`` beside each velocity and ``"step"``; a
    pooling layer, which has no parameters, ``{}``. Each becomes an f32 tensor on the
    workflow's device. A slot left out is drawn (weights) or zeroed
    (velocities) by ``initialize()`` as usual; a key the layer's units
    have no slot for raises."""
    if len(layers) != len(workflow.forwards):
        raise ValueError("%d layer dicts for %d forward units"
                         % (len(layers), len(workflow.forwards)))
    for fwd, gd, layer in zip(workflow.forwards, workflow.gds, layers):
        units = {"fwd": fwd, "gd": gd}
        slots = {key: (units[unit], attr)
                 for key, unit, attr in UNIT_PARAM_SLOTS
                 if hasattr(units[unit], attr)}
        unknown = set(layer) - set(slots)
        if unknown:
            raise ValueError("%s has no slot for %s"
                             % (fwd.name, sorted(unknown)))
        for key, value in layer.items():
            unit, attr = slots[key]
            getattr(unit, attr).data = _leaf_from_numpy(value).float().to(
                workflow.device)


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return numpy.array(value)


def unit_state_of(workflow):
    """The layer dicts :func:`unit_params_from_jax` reads, from either
    package's ``StandardWorkflow`` (JAX arrays or tensors, read as numpy):
    every slot of :data:`UNIT_PARAM_SLOTS` the layer's units hold a value
    in."""
    layers = []
    for fwd, gd in zip(workflow.forwards, workflow.gds):
        units = {"fwd": fwd, "gd": gd}
        layer = {}
        for key, unit, attr in UNIT_PARAM_SLOTS:
            slot = getattr(units[unit], attr, None)
            value = getattr(slot, "data", None)
            if value is not None:
                layer[key] = _host(value)
        layers.append(layer)
    return layers


def som_weights_from_jax(workflow, weights):
    """Put a JAX Kohonen map's (gy * gx, D) weights into the port
    ``KohonenWorkflow``'s trainer before ``initialize()`` (which then
    draws nothing), as f32 on the workflow's device."""
    trainer = workflow.trainer
    expected = trainer.n_neurons
    value = _leaf_from_numpy(weights).float()
    if value.dim() != 2 or value.shape[0] != expected:
        raise ValueError("%s wants (%d, D) weights, got %s"
                         % (trainer.name, expected, tuple(value.shape)))
    trainer.weights.data = value.to(workflow.device)


def normalizer_state(normalizer):
    """The ``state`` dict of either package's normalizer with its arrays
    (numpy, JAX or torch) as numpy arrays: what ``make_normalizer(name,
    state=...)`` takes."""
    return {key: (_host(val) if hasattr(val, "shape") else val)
            for key, val in normalizer.state.items()}


def normalizers_from_jax(loader, normalizer, target_normalizer=None):
    """Make a port ``FullBatchLoader`` (``FullBatchLoaderMSE`` with
    ``target_normalizer``) build its normalizers from the JAX loader's
    ``normalizer`` (and ``target_normalizer``) state at ``initialize()``
    instead of analysing its train split. Call before
    ``initialize()``."""
    for attr, source in (("normalizer_state", normalizer),
                         ("target_normalizer_state", target_normalizer)):
        if source is None:
            continue
        if not hasattr(loader, attr):
            raise ValueError("%s has no %s" % (loader.name, attr))
        setattr(loader, attr, normalizer_state(source))
