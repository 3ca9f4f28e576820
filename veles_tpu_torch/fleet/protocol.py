"""Wire protocol: length-prefixed, HMAC-authenticated pickled frames.

The port's copy of ``veles_tpu/fleet/protocol.py``: the frames are
the JAX package's byte for byte, so each package reads the other's.

Replaces the reference's two-plane fabric (Twisted JSON-lines control +
ZeroMQ streaming-pickle data, ``network_common.py`` + ``txzmq/``) with one
asyncio stream. Frames:

    [4-byte big-endian length][1-byte codec][32-byte HMAC-SHA256][payload]

codec 0 = raw pickle, 1 = gzip pickle (auto-chosen by size, mirroring the
reference's pluggable chunk compression), 2 = safe (pickle-free, see
``fleet/safecodec.py``), 3 = gzip safe. Messages are dicts with a "type"
key; job/update payloads ride inside them (the units' generate/apply
contracts define their content).

Message schema (master <-> slave, after the hello/welcome handshake):

- ``welcome``: ``id`` (slave id), ``shm`` (shared-memory negotiated),
  ``epoch`` (the master's per-start fencing UUID), ``initial``;
- ``job``: ``job`` (payload list, ``None`` = no more jobs), ``job_id``
  (monotonic lease id, see ``fleet/ledger.py``), ``epoch``, ``paused``;
- ``update``: ``job_id`` + ``epoch`` echoed from the job (the master
  fences mismatches instead of applying them), optional ``chaos``
  (fault-injection tallies, ``fleet/chaos.py``). Payload by wire
  plane (``root.common.fleet.plane``, docs/compiler_fleet.md):
  ``update`` (the data-plane per-unit payload list, weights included)
  or — control plane — ``results`` (scalar metrics list) + ``tick``
  (the slave's local applied-job counter; a control-plane master
  REJECTS frames carrying an ``update`` key). Observability freight
  rides along (observe/fleetscope.py; every field validated + bounded
  at ingestion, the hostile-slave doctrine): ``mono`` ([job-receipt,
  update-send] slave monotonic stamps — the slave half of the
  master's NTP-style clock alignment), ``job_ms`` (the workflow's own
  job wall, so the master can split compute from host residence),
  ``spans`` (completed-span summary rows ``[name, trace_id, span_id,
  parent_id, t0, dur_ms, tid]``, at most SPAN_SHIP_MAX_ROWS per
  frame), ``rollback_ms`` (cumulative rollback-discarded compute —
  wasted-work accounting), plus the pre-existing ``metrics`` /
  ``history`` snapshot piggybacks;
- ``update_ack``: optional ``fenced`` (the rejection verdict — the
  slave must not answer a fenced ack with another job_request);
- ``sync`` (control plane only): ``sync`` (per-unit epoch-fence weight
  payload), ``job_id`` (the accepted fence job it chases), ``epoch``,
  ``tick`` — the only post-handshake frames that carry weights;
  answered by ``sync_ack`` (optional ``fenced``);
- ``job`` additionally carries ``acked`` in control-plane mode (the
  master's highest accepted slave tick — the rollback protocol);
- ``hello`` carries ``plane``; the master fails the handshake on a
  mismatch;
- ``job_request`` / ``power`` / ``bye``: as in the reference.

Security: EVERY frame — including the pre-handshake hello — is
authenticated with a shared-secret HMAC verified *before* any
decompression or deserialization; a peer without the secret cannot reach
``pickle.loads``. The secret comes from (in priority order) an explicit
argument, ``$VELES_TPU_FLEET_SECRET``, ``root.common.fleet.secret``, or
defaults to the workflow checksum — which both sides must share anyway
(the reference's compatibility check, ``workflow.py:847-862``), so
possession of the workflow file is the minimum bar. Masters bind
127.0.0.1 unless an interface is given.

Defense in depth: ``root.common.fleet.codec = "safe"`` (set on EVERY
host — the wire codec is not negotiable, by design: a negotiation could
be downgraded) moves the whole wire to the pickle-free codec and makes
the receiver REJECT pickle frames outright, so even a leaked secret is
no longer remote code execution — at worst bogus data. The default stays
"pickle" for payload-generality parity with the reference's wire.
"""

import gzip
import hashlib
import zlib
import hmac as hmac_lib
import os
import pickle
import struct
import uuid

COMPRESS_THRESHOLD = 64 * 1024
MAX_FRAME = 1 << 30

_HEADER = struct.Struct(">IB")
_MAC_SIZE = hashlib.sha256().digest_size


class ProtocolError(Exception):
    """Malformed or unauthenticated frame."""


def resolve_secret(workflow=None, secret=None, with_source=False):
    """The shared fleet secret as bytes (see module docstring). With
    ``with_source=True`` returns ``(secret, source)`` where source is one
    of "explicit"/"env"/"config"/"checksum"."""
    source = "explicit"
    if secret is None:
        secret = os.environ.get("VELES_TPU_FLEET_SECRET")
        source = "env"
    if secret is None:
        from veles_tpu_torch.core.config import root
        secret = root.common.fleet.get("secret")
        source = "config"
    if secret is None and workflow is not None:
        secret = getattr(workflow, "checksum", None)
        source = "checksum"
    if secret is None:
        raise ProtocolError(
            "no fleet secret: pass secret=, set VELES_TPU_FLEET_SECRET "
            "or root.common.fleet.secret, or give the workflow a checksum")
    if isinstance(secret, str):
        secret = secret.encode()
    return (secret, source) if with_source else secret


def _mac(key, codec, payload):
    return hmac_lib.new(key, bytes([codec]) + payload,
                        hashlib.sha256).digest()


def _wire_codec():
    """The configured serialization family: "pickle" (default) or
    "safe". Read per frame so tests/configs can flip it live."""
    from veles_tpu_torch.core.config import root
    codec = root.common.fleet.get("codec", "pickle")
    if codec not in ("pickle", "safe"):
        raise ProtocolError(
            "root.common.fleet.codec must be 'pickle' or 'safe', got %r"
            % (codec,))
    return codec


def _serialize(message):
    if _wire_codec() == "safe":
        from veles_tpu_torch.fleet import safecodec
        return safecodec.dumps(message), 2
    return pickle.dumps(message, protocol=pickle.HIGHEST_PROTOCOL), 0


def _deserialize(payload, codec):
    if codec in (0, 1):
        if _wire_codec() != "pickle":
            raise ProtocolError(
                "received a pickle frame but this host is configured "
                "with the safe fleet codec — set root.common.fleet."
                "codec identically on every fleet host")
        return pickle.loads(payload)
    from veles_tpu_torch.fleet import safecodec
    try:
        return safecodec.loads(payload)
    except (safecodec.UnsupportedType, KeyError, ValueError, TypeError,
            IndexError, RecursionError, struct.error) as exc:
        # ANY malformed-but-authenticated frame must surface as a
        # protocol violation (the session handlers drop the peer and
        # keep the fleet alive) — never as a raw exception that would
        # kill the client/server loop: safe mode's threat model says a
        # secret holder gets at most bogus data, not a DoS
        raise ProtocolError("bad safe frame: %s: %s"
                            % (type(exc).__name__, exc))


def encode_frame(message, key, shm_threshold=None):
    """``shm_threshold``: when set (same-host connections, negotiated at
    handshake by machine id — reference ``server.py:721-732``), payloads
    at least that large move through a shared-memory segment
    (``fleet/sharedio.py``) and only a descriptor frame hits the wire."""
    payload, codec = _serialize(message)
    if shm_threshold is not None and len(payload) >= shm_threshold:
        from veles_tpu_torch.fleet import sharedio
        desc = sharedio.put(payload, key)
        payload, codec = _serialize({"__shm__": desc})
    if len(payload) > MAX_FRAME:
        # bound the UNCOMPRESSED size too: the receiver enforces the
        # limit on the decompressed payload (_bounded_gunzip), so a
        # compressible >1 GiB payload that fit on the wire would be
        # rejected at the far end — fail here with the clear message
        raise ProtocolError(
            "outgoing %r frame is %d bytes uncompressed (limit %d): "
            "shrink the job/update payload"
            % (message.get("type", "?"), len(payload), MAX_FRAME))
    if len(payload) >= COMPRESS_THRESHOLD:
        compressed = gzip.compress(payload, compresslevel=1)
        if len(compressed) < len(payload):
            payload, codec = compressed, codec + 1
    return (_HEADER.pack(len(payload), codec) + _mac(key, codec, payload)
            + payload)


def _bounded_gunzip(payload, max_frame):
    """Decompress a gzip member with the frame limit applied to the
    DECOMPRESSED size too: MAX_FRAME on the wire length alone would let
    an authenticated peer detonate a ~1000x gzip bomb in memory, which
    contradicts the safe codec's "a leaked secret yields at most bogus
    data, not a DoS" threat model. wbits=31 selects the gzip container
    (the sender uses gzip.compress)."""
    decompressor = zlib.decompressobj(wbits=31)
    try:
        data = decompressor.decompress(payload, max_frame + 1)
    except zlib.error as exc:
        raise ProtocolError("bad gzip frame: %s" % exc)
    if len(data) > max_frame or decompressor.unconsumed_tail:
        raise ProtocolError(
            "decompressed frame exceeds limit %d" % max_frame)
    if not decompressor.eof or decompressor.unused_data:
        # keep gzip.decompress's strictness: a truncated member or
        # trailing garbage is a protocol violation, not partial data
        raise ProtocolError("malformed gzip frame (truncated or "
                            "trailing data)")
    return data


async def read_frame(reader, key, max_frame=MAX_FRAME):
    """``max_frame`` caps the pre-verification buffer: servers read the
    pre-auth hello with a small cap so an unauthenticated peer cannot make
    us buffer a giant bogus payload before the MAC check rejects it."""
    header = await reader.readexactly(_HEADER.size)
    length, codec = _HEADER.unpack(header)
    if length > max_frame:
        raise ProtocolError("frame length %d exceeds limit %d"
                            % (length, max_frame))
    mac = await reader.readexactly(_MAC_SIZE)
    payload = await reader.readexactly(length)
    if not hmac_lib.compare_digest(mac, _mac(key, codec, payload)):
        raise ProtocolError("frame failed HMAC authentication")
    if codec not in (0, 1, 2, 3):
        raise ProtocolError("unknown frame codec %d" % codec)
    if codec in (1, 3):
        payload = _bounded_gunzip(payload, max_frame)
        codec -= 1
    message = _deserialize(payload, codec)
    if isinstance(message, dict) and "__shm__" in message:
        from veles_tpu_torch.fleet import sharedio
        try:
            payload = sharedio.get(message["__shm__"], key)
        except (OSError, ValueError) as exc:
            raise ProtocolError("bad shared-memory frame: %s" % exc)
        message = _deserialize(payload, codec)
    return message


async def write_frame(writer, message, key, shm_threshold=None):
    writer.write(encode_frame(message, key, shm_threshold))
    await writer.drain()


def decode_frame_bytes(data, key, max_frame=MAX_FRAME):
    """Synchronous decode of ONE encoded frame (the buffer twin of
    :func:`read_frame`, same MAC/codec/bounds rules) — for benches and
    tests that hold the whole frame in memory instead of a stream."""
    if len(data) < _HEADER.size + _MAC_SIZE:
        raise ProtocolError("truncated frame")
    length, codec = _HEADER.unpack(data[:_HEADER.size])
    if length > max_frame:
        raise ProtocolError("frame length %d exceeds limit %d"
                            % (length, max_frame))
    mac = data[_HEADER.size:_HEADER.size + _MAC_SIZE]
    payload = data[_HEADER.size + _MAC_SIZE:]
    if len(payload) != length:
        raise ProtocolError("frame length mismatch")
    if not hmac_lib.compare_digest(mac, _mac(key, codec, payload)):
        raise ProtocolError("frame failed HMAC authentication")
    if codec not in (0, 1, 2, 3):
        raise ProtocolError("unknown frame codec %d" % codec)
    if codec in (1, 3):
        payload = _bounded_gunzip(payload, max_frame)
        codec -= 1
    return _deserialize(payload, codec)


def machine_id():
    """Stable per-host identity (reference ``network_common.py:72-118``
    derived it from dbus + MAC; /etc/machine-id is the modern source)."""
    for path in ("/etc/machine-id", "/var/lib/dbus/machine-id"):
        try:
            with open(path) as fin:
                return fin.read().strip()
        except OSError:
            continue
    return hashlib.sha1(uuid.getnode().to_bytes(6, "big")).hexdigest()


def endpoint_id():
    return "%s/%d" % (machine_id(), os.getpid())
