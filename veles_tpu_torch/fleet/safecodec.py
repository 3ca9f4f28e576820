"""Pickle-free job/update serialization for the fleet wire.

The port's copy of ``veles_tpu/fleet/safecodec.py``: the same message
encodes to the JAX package's bytes. Payloads hold numpy arrays: a torch
tensor is refused at encode time (a unit hands the wire
``tensor.cpu().numpy()``).

The default fleet codec is pickle (the reference shipped pickles on its
ZeroMQ data plane too, ``network_common.py``), authenticated by the
frame HMAC — but a *leaked secret* then means remote code execution in
both directions. Setting ``root.common.fleet.codec = "safe"`` on every
host switches the wire to THIS codec: a closed, data-only format whose
decoder can execute nothing — a compromised secret is then worth at most
bogus training data.

Format: ``[4-byte big-endian header length][JSON header][raw blobs...]``
where the header describes a tree of supported values and arrays refer
to contiguous byte ranges in the blob section. Supported: ``None``,
``bool``, ``int``, ``float``, ``str``, ``bytes``, ``list``, ``tuple``,
``dict`` (any encodable keys), numpy scalars and arrays. Anything else
raises at ENCODE time with the offending type, so a workflow whose
job/update payloads need richer objects fails loudly on the sender and
can stay on the pickle codec deliberately.
"""

import json
import struct

import numpy

_LEN = struct.Struct(">I")


class UnsupportedType(TypeError):
    """Payload contains an object the safe codec refuses to carry."""


def _dtype_tag(dtype):
    if dtype == object:
        raise UnsupportedType(
            "object-dtype arrays cannot ride the safe fleet codec")
    if dtype.kind == "V":
        # ml_dtypes scalars (bfloat16, fp8...) present as anonymous
        # void in .str; their registered NAME round-trips. True
        # structured dtypes have fields and are refused.
        if dtype.fields is not None:
            raise UnsupportedType(
                "structured arrays cannot ride the safe fleet codec")
        return dtype.name
    return dtype.str


def _coerce_key(key):
    """Dict keys must round-trip hashable: numpy scalars become their
    python equivalents (same hash/equality, so lookups behave), tuples
    recurse, everything else simple — or fail at ENCODE time."""
    if isinstance(key, numpy.generic):
        key = key.item()
    if isinstance(key, tuple):
        return tuple(_coerce_key(k) for k in key)
    if key is None or isinstance(key, (bool, int, float, str, bytes)):
        return key
    raise UnsupportedType(
        "dict key of type %s cannot ride the safe fleet codec"
        % type(key).__name__)


def _encode(obj, blobs, offset):
    """Returns (header_node, new_offset)."""
    if obj is None or isinstance(obj, (bool, str)):
        return obj, offset
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        # JSON carries them natively; NaN/inf are handled by json's
        # default (non-strict) encoder and parsed back by float()
        return obj, offset
    if isinstance(obj, bytes):
        blobs.append(obj)
        node = {"t": "b", "o": offset, "n": len(obj)}
        return node, offset + len(obj)
    if isinstance(obj, numpy.generic):  # numpy scalar: own tag — the
        # receiver rebuilds the SAME scalar type, not a 0-d array
        arr = numpy.asarray(obj)
        data = arr.tobytes()
        blobs.append(data)
        node = {"t": "s", "d": _dtype_tag(arr.dtype),
                "o": offset, "n": len(data)}
        return node, offset + len(data)
    if isinstance(obj, numpy.ndarray):
        data = numpy.ascontiguousarray(obj).tobytes()
        blobs.append(data)
        node = {"t": "a", "d": _dtype_tag(obj.dtype),
                "s": list(obj.shape), "o": offset, "n": len(data)}
        return node, offset + len(data)
    if isinstance(obj, (list, tuple)):
        items = []
        for item in obj:
            node, offset = _encode(item, blobs, offset)
            items.append(node)
        return {"t": "l" if isinstance(obj, list) else "u",
                "v": items}, offset
    if isinstance(obj, dict):
        items = []
        for key, value in obj.items():
            # fail-loudly-at-the-sender contract: keys are validated
            # (and numpy scalars coerced) HERE, so nothing encodes that
            # the receiver would have to reject
            knode, offset = _encode(_coerce_key(key), blobs, offset)
            vnode, offset = _encode(value, blobs, offset)
            items.append([knode, vnode])
        return {"t": "d", "v": items}, offset
    raise UnsupportedType(
        "%s cannot ride the safe fleet codec (supported: None/bool/int/"
        "float/str/bytes/list/tuple/dict/numpy arrays); set "
        "root.common.fleet.codec = 'pickle' if this payload is "
        "intentional" % type(obj).__name__)


def _decode(node, blob, memo_tuple=tuple):
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    kind = node["t"]
    if kind == "b":
        return bytes(blob[node["o"]:node["o"] + node["n"]])
    if kind == "a":
        dtype = _dtype_of(node["d"])
        if dtype.hasobject:  # defense in depth: never trust the header
            raise UnsupportedType("object dtype in safe frame")
        raw = blob[node["o"]:node["o"] + node["n"]]
        return numpy.frombuffer(raw, dtype=dtype).reshape(
            node["s"]).copy()
    if kind == "s":  # numpy scalar, exact type restored
        dtype = _dtype_of(node["d"])
        if dtype.hasobject:
            raise UnsupportedType("object dtype in safe frame")
        raw = blob[node["o"]:node["o"] + node["n"]]
        return numpy.frombuffer(raw, dtype=dtype)[0]
    if kind == "l":
        return [_decode(v, blob) for v in node["v"]]
    if kind == "u":
        return memo_tuple(_decode(v, blob) for v in node["v"])
    if kind == "d":
        return {_hashable(_decode(k, blob)): _decode(v, blob)
                for k, v in node["v"]}
    raise UnsupportedType("unknown safe-codec node %r" % kind)


def _dtype_of(tag):
    if not isinstance(tag, str):
        raise UnsupportedType("bad dtype tag %r" % (tag,))
    try:
        return numpy.dtype(tag)
    except TypeError:
        pass
    # ml_dtypes names (bfloat16, float8_*) resolve via the package
    try:
        import ml_dtypes
    except ImportError:
        raise UnsupportedType("dtype %r needs ml_dtypes, which this host "
                              "lacks" % tag)
    scalar = getattr(ml_dtypes, tag, None)
    if scalar is None:
        raise UnsupportedType("unknown dtype %r in safe frame" % tag)
    return numpy.dtype(scalar)


def _hashable(key):
    # decoded lists (from tuple-typed keys they are already tuples) —
    # JSON round-trips only these key kinds anyway
    if isinstance(key, numpy.ndarray):
        raise UnsupportedType("array dict keys in safe frame")
    return key


def dumps(message):
    blobs = []
    header, _ = _encode(message, blobs, 0)
    head = json.dumps(header, separators=(",", ":")).encode()
    return _LEN.pack(len(head)) + head + b"".join(blobs)


def loads(data):
    if len(data) < _LEN.size:
        raise UnsupportedType("truncated safe frame")
    (head_len,) = _LEN.unpack_from(data)
    head_end = _LEN.size + head_len
    if head_end > len(data):
        raise UnsupportedType("truncated safe frame header")
    try:
        header = json.loads(data[_LEN.size:head_end].decode())
    except (ValueError, UnicodeDecodeError) as exc:
        raise UnsupportedType("bad safe frame header: %s" % exc)
    return _decode(header, memoryview(data)[head_end:])
