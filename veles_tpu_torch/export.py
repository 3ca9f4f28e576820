"""Workflow package export for the native inference runtime.

The port of ``veles_tpu/export.py`` (reference ``Workflow.package_export``,
``workflow.py:864-971``). The package is the JAX package's format, which
the dependency-free C++ runtime under ``native/`` reads: an uncompressed
ustar tar holding

- ``contents.json``: the workflow's name and checksum and the forward
  chain, each unit with its type, config and array references
  (``@name.npy``);
- one C-order ``.npy`` per parameter array, float32 or (``precision=16``)
  float16, which the runtime widens back to f32 at load.

For the same weights the package equals the JAX package's member for
member and byte for byte, apart from ``checksum``, which hashes each
package's own workflow source (``core/workflow.py``'s ``checksum``).
An Array on the card reaches the package through its host view
(``Array.mem``).
"""

import io
import json
import os
import tarfile
import time

import numpy


def _export_stamp():
    """Deterministic export timestamp: epoch 0 unless ``SOURCE_DATE_EPOCH``
    is set (the reproducible-builds convention), so two exports of the
    same state are byte-identical; tar member mtimes are 0 already."""
    try:
        epoch = int(os.environ.get("SOURCE_DATE_EPOCH", "0"))
    except ValueError:
        epoch = 0
    return time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(epoch))


def _npy_bytes(array, dtype=numpy.float32):
    buf = io.BytesIO()
    numpy.save(buf, numpy.ascontiguousarray(array, dtype))
    return buf.getvalue()


def _unit_spec(unit, arrays):
    """Describe one forward unit; register its arrays in ``arrays``."""
    from veles_tpu_torch.nn.all2all import All2All
    from veles_tpu_torch.nn.attention import (LayerNorm, SelfAttention,
                                              TokenFFN)
    from veles_tpu_torch.nn.conv import Conv
    from veles_tpu_torch.nn.pooling import (AvgPooling, MaxAbsPooling,
                                            MaxPooling, Pooling)

    spec = {"name": unit.name, "type": None, "config": {}, "arrays": {}}

    def ref(label, value):
        key = "%s_%s" % (unit.name, label)
        arrays[key] = value.mem
        spec["arrays"][label] = "@%s.npy" % key

    if isinstance(unit, All2All):
        spec["type"] = "all2all"
        spec["config"] = {"activation": unit.ACTIVATION,
                          "out_features": unit.neurons_number}
        ref("weights", unit.weights)
        ref("bias", unit.bias)
    elif isinstance(unit, Conv):
        spec["type"] = "conv"
        spec["config"] = {"activation": unit.ACTIVATION,
                          "n_kernels": unit.n_kernels,
                          "kx": unit.kx, "ky": unit.ky,
                          "stride_y": unit.sliding[0],
                          "stride_x": unit.sliding[1],
                          "padding": unit.padding}
        ref("weights", unit.weights)
        ref("bias", unit.bias)
    elif isinstance(unit, Pooling):
        if isinstance(unit, MaxAbsPooling):
            spec["type"] = "maxabs_pooling"
        elif isinstance(unit, AvgPooling):
            spec["type"] = "avg_pooling"
        elif isinstance(unit, MaxPooling):
            spec["type"] = "max_pooling"
        else:
            raise ValueError("cannot export pooling %r (%s)"
                             % (unit.name, type(unit).__name__))
        spec["config"] = {"kx": unit.kx, "ky": unit.ky,
                          "stride_y": unit.sliding[0],
                          "stride_x": unit.sliding[1]}
    elif isinstance(unit, SelfAttention):
        spec["type"] = "self_attention"
        # causal/residual as 0/1: the runtime's JSON reader is numeric
        spec["config"] = {"heads": unit.heads,
                          "causal": int(unit.causal),
                          "residual": int(getattr(unit, "residual",
                                                  False))}
        ref("weights", unit.weights)
        ref("bias", unit.bias)
        ref("out_weights", unit.out_weights)
        ref("out_bias", unit.out_bias)
    elif isinstance(unit, TokenFFN):
        spec["type"] = "ffn"
        spec["config"] = {"activation": unit.activation,
                          "residual": int(unit.residual)}
        ref("weights", unit.weights)
        ref("bias", unit.bias)
        ref("out_weights", unit.out_weights)
        ref("out_bias", unit.out_bias)
    elif isinstance(unit, LayerNorm):
        spec["type"] = "layer_norm"
        spec["config"] = {"eps": unit.eps}
        ref("weights", unit.weights)
        ref("bias", unit.bias)
    else:
        raise ValueError("cannot export unit %r (%s)"
                         % (unit.name, type(unit).__name__))
    return spec


def package_export(workflow, path, precision=32):
    """Export ``workflow``'s forward chain to a tar package at ``path``.

    ``precision``: 32 (float32 arrays) or 16 (float16: about half the
    package; the runtime widens back to f32 at load, so inference pays
    one rounding of the parameters)."""
    from veles_tpu_torch.nn.all2all import All2AllSoftmax

    if precision not in (16, 32):
        raise ValueError("only 16- and 32-bit float export is supported "
                         "(got %r)" % (precision,))
    dtype = numpy.float16 if precision == 16 else numpy.float32
    arrays = {}
    units = [_unit_spec(unit, arrays) for unit in workflow.forwards]
    if workflow.forwards and isinstance(workflow.forwards[-1],
                                        All2AllSoftmax):
        units[-1]["config"]["activation"] = "softmax"
    contents = {
        "workflow": workflow.name,
        "checksum": workflow.checksum,
        "exported": _export_stamp(),
        "precision": precision,
        "input_shape": list(workflow.loader.minibatch_data.shape[1:]),
        "units": units,
    }
    payload = json.dumps(contents, indent=1).encode()
    with tarfile.open(path, "w") as tar:  # uncompressed ustar
        info = tarfile.TarInfo("contents.json")
        info.size = len(payload)
        tar.addfile(info, io.BytesIO(payload))
        for key, value in arrays.items():
            blob = _npy_bytes(value, dtype)
            info = tarfile.TarInfo("%s.npy" % key)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return path
