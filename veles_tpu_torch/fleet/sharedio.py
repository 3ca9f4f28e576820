"""Same-host shared-memory data plane (reference ``txzmq/sharedio.py:44-105``).

The port's copy of ``veles_tpu/fleet/sharedio.py``.

When master and slave share a machine, large job/update payloads skip the
TCP socket: the sender writes the pickled payload into a one-shot segment
under ``/dev/shm`` (POSIX shared memory — tmpfs, a memory copy, never
disk) and ships only a tiny descriptor frame; the receiver maps the
segment, verifies its HMAC, and unlinks it. The reference negotiated the
same optimization by machine-id/pid at handshake and moved payloads over
``SharedIO`` (posix_ipc + mmap) instead of the ZMQ socket
(``server.py:721-732``).

Security model: the descriptor arrives inside an authenticated frame, but
a compromised authenticated peer must still not be able to point us at an
arbitrary filesystem path — segments live in one directory, carry a
mandatory name prefix, and the content MAC (keyed by the fleet secret) is
verified before the segment is consumed; the unlink happens only after
every check passes.
"""

import hashlib
import hmac as hmac_lib
import os
import uuid

#: tmpfs on every Linux; the tempdir fallback keeps macOS/tests working
#: (payloads then ride the page cache — still no socket serialization)
_SHM_DIRS = ("/dev/shm", None)
_PREFIX = "veles-shm-"


def shm_dir():
    for d in _SHM_DIRS:
        if d is None:
            import tempfile
            return tempfile.gettempdir()
        if os.path.isdir(d) and os.access(d, os.W_OK):
            return d


def owner_uid():
    """Segments are 0o600: peers running as different users on the same
    host cannot read each other's segments, so the handshake negotiates
    shm only between same-uid peers."""
    return os.getuid() if hasattr(os, "getuid") else -1


def _mac(key, payload):
    return hmac_lib.new(key, payload, hashlib.sha256).hexdigest()


def put(payload, key):
    """Write one payload into a fresh private segment; returns the
    descriptor dict to ship over the wire."""
    name = _PREFIX + uuid.uuid4().hex
    path = os.path.join(shm_dir(), name)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    try:
        os.write(fd, payload)
    finally:
        os.close(fd)
    return {"name": name, "size": len(payload), "mac": _mac(key, payload)}


def get(desc, key):
    """Read, verify and unlink a segment by descriptor. Raises
    ``ValueError`` on any containment or authenticity failure (the
    segment is left in place unless it verified)."""
    name = desc.get("name", "")
    if os.path.basename(name) != name or not name.startswith(_PREFIX):
        raise ValueError("shm descriptor name %r escapes the segment "
                         "namespace" % name)
    path = os.path.join(shm_dir(), name)
    with open(path, "rb") as fin:
        payload = fin.read()
    if len(payload) != desc.get("size") \
            or not hmac_lib.compare_digest(_mac(key, payload),
                                           str(desc.get("mac"))):
        raise ValueError("shm segment %s failed verification" % name)
    os.unlink(path)
    return payload


def cleanup_stale(max_age=3600.0):
    """Best-effort GC of segments orphaned by a crashed receiver."""
    import time
    base = shm_dir()
    removed = 0
    try:
        names = os.listdir(base)
    except OSError:
        return 0
    for name in names:
        if not name.startswith(_PREFIX):
            continue
        path = os.path.join(base, name)
        try:
            if time.time() - os.stat(path).st_mtime > max_age:
                os.unlink(path)
                removed += 1
        except OSError:
            continue
    return removed
