"""Persistent store of built kernel libraries: skip ``nvcc`` at boot.

The port of ``veles_tpu/aot/exec_cache.py``. What the port compiles is
its kernel libraries (``ops/_build.py``: one ``nvcc`` build of each
``ops/csrc/<name>.cu`` into a shared library), so an entry here is one
built library, kept in a directory (conventionally ``<bundle>.xcache/``
beside an AOT bundle). The loader (``aot/loader.py``) stages a bundle's
libraries through it, and ``ops/_build.stage`` then serves the verified
entry's path: a matching machine loads instead of building.

Gating: the key digests the library's source digest (the hash
``ops/_build.source_digest`` takes over the ``.cu``, every ``.cuh`` and
the flags) with the device fingerprint, ``torch.__version__``,
``torch.version.cuda`` and :data:`CACHE_SCHEMA`. Any drift changes the
key, so a stale library is never found (a miss, never a wrong load).

Torn writes: each entry lands by temp file and ``os.replace``, with a
``.sha256`` sidecar hashed on the write path and renamed FIRST. A
truncated, bit-flipped or sidecar-less entry is refused with one warning
per entry (logger ``aot.ExecCache``), unlinked and counted in
``rejects`` and ``misses``; the caller then builds that library live
with ``nvcc`` (the same kernel). The sidecar defends against torn writes
and bit rot, not against someone who can already write to the cache
directory: trust it as the bundle itself.
"""

import hashlib
import json
import logging
import os
import threading

from veles_tpu_torch.observe.regress import sha256_of
from veles_tpu_torch.snapshotter import _HashingWriter

logger = logging.getLogger("aot.ExecCache")

#: bump when the entry layout changes (part of every key)
CACHE_SCHEMA = 1

#: entry filename suffix (content-addressed: ``<key>.so``)
ENTRY_SUFFIX = ".so"

#: warn-once memory: one line per (reason, entry)
_WARNED = set()
_WARNED_LOCK = threading.Lock()

#: process-lifetime tallies: the counters publish from here, so a cache
#: collected with its bundle never makes an exported counter decrease
_XC_TOTALS = {"hits": 0, "misses": 0, "writes": 0, "rejects": 0}
_XC_LOCK = threading.Lock()


def totals():
    """The process-lifetime hit/miss/write/reject tallies (monotone;
    ``loader.publish_aot_stats`` exports them)."""
    with _XC_LOCK:
        return dict(_XC_TOTALS)


def _warn_once(key, message, *args):
    with _WARNED_LOCK:
        if key in _WARNED:
            return
        _WARNED.add(key)
    logger.warning(message, *args)


def cache_fingerprint(mesh=None):
    """The environment half of every key: a built library is specific to
    torch's CUDA and to the card, so all of it is in the address."""
    import torch

    from veles_tpu_torch.observe.regress import device_fingerprint

    fp = device_fingerprint()
    return {
        "schema": CACHE_SCHEMA,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": fp.get("backend"),
        "device_kind": fp.get("device_kind"),
        "device_count": fp.get("device_count"),
        "mesh": dict(mesh.shape) if mesh is not None else None,
    }


def entry_key(row, fingerprint):
    """The content address of one library: its source stem and digest
    (the bundle's library row) and the environment, digested
    canonically."""
    doc = {"name": row.get("name"), "source": row.get("digest"),
           "env": fingerprint}
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


class ExecutableCache:
    """One cache directory. Thread-safe for the loader's prefetch
    workers: a load only reads; a store writes unique temp names and
    renames behind a write lock, so two threads storing the SAME key
    never cross one's entry with the other's sidecar."""

    def __init__(self, directory):
        self.directory = str(directory)
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.writes = 0
        #: refused entries (each also a miss: the caller built live)
        self.rejects = 0

    def _count(self, field):
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)
        with _XC_LOCK:
            _XC_TOTALS[field] += 1

    def path(self, key):
        return os.path.join(self.directory, key + ENTRY_SUFFIX)

    # -- read path --------------------------------------------------------
    def load(self, key):
        """The path of the verified library under ``key``, or None (a
        miss, or a refused entry: the caller builds live). A torn,
        bit-flipped or sidecar-less entry warns ONCE and is unlinked, so
        the next store repairs it."""
        path = self.path(key)
        if not os.path.isfile(path):
            self._count("misses")
            return None
        sidecar = path + ".sha256"
        try:
            with open(sidecar, "r") as fin:
                want = [line.split()[0] for line in fin
                        if line.strip() and not line.startswith("#")]
            if not want or sha256_of(path) not in want:
                raise ValueError(
                    "sha256 mismatch against sidecar %s" % sidecar)
        except (OSError, ValueError) as exc:
            # never load bytes the sidecar does not vouch for
            self._count("rejects")
            self._count("misses")
            _warn_once(
                ("reject", path),
                "executable cache entry %s refused (%s: %s) - falling back "
                "to a live nvcc build; the entry is stored again on the "
                "next load", path, type(exc).__name__, exc)
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        self._count("hits")
        return path

    # -- write path -------------------------------------------------------
    def store(self, key, blob):
        """Write the library bytes ``blob`` under ``key``: temp file and
        ``os.replace``, the ``.sha256`` sidecar renamed FIRST, so
        whichever rename a crash interrupts no reader sees unvouched
        bytes. Returns the entry's path, or None when the directory is
        not writable (the next boot builds again)."""
        path = self.path(key)
        name = os.path.basename(path)
        tmp = "%s.tmp%d.%d" % (path, os.getpid(), threading.get_ident())
        try:
            os.makedirs(self.directory, exist_ok=True)
            with open(tmp, "wb") as raw:
                tee = _HashingWriter(raw)
                tee.write(bytes(blob))
            sidecar_tmp = tmp + ".sha256"
            with open(sidecar_tmp, "w") as fout:
                fout.write("%s  %s\n" % (tee.hexdigest(), name))
            with self._write_lock:
                os.replace(sidecar_tmp, path + ".sha256")
                os.replace(tmp, path)
        except OSError as exc:
            _warn_once(
                ("store", self.directory),
                "executable cache %s not writable (%s) - boots keep "
                "staging or building live", self.directory, exc)
            for leftover in (tmp, tmp + ".sha256"):
                try:
                    os.remove(leftover)
                except OSError:
                    pass
            return None
        self._count("writes")
        return path

    def stats(self):
        with self._lock:
            return {"directory": self.directory, "hits": self.hits,
                    "misses": self.misses, "writes": self.writes,
                    "rejects": self.rejects}


def resolve_cache(exec_cache, bundle_path):
    """Resolve ``load_bundle(exec_cache=...)``:

    - ``None``: ``root.common.serve.aot_cache`` (a string is that
      directory, a bare truthy value the conventional sibling, unset or
      falsy disabled);
    - ``False``: disabled;
    - ``True``: the ``<bundle>.xcache`` sibling;
    - a string: that directory;
    - an :class:`ExecutableCache`: used as is.
    """
    if exec_cache is None:
        from veles_tpu_torch.core.config import root
        exec_cache = root.common.serve.get("aot_cache", None)
        if not exec_cache:
            return None
    if exec_cache is False:
        return None
    if isinstance(exec_cache, ExecutableCache):
        return exec_cache
    if exec_cache is True or not isinstance(exec_cache, str):
        if bundle_path is None:
            return None
        exec_cache = str(bundle_path) + ".xcache"
    return ExecutableCache(exec_cache)
