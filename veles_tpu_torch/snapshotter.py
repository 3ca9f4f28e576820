"""Snapshotter: periodic whole-workflow checkpoint and resume.

The port of ``veles_tpu/snapshotter.py`` (reference
``veles/snapshotter.py``). Kept semantics:

- whole-workflow pickling (units, links, gates, the loader's epoch state
  and shuffled order, the named PRNG streams), not just weights;
- the interval gate, the wall-time gate and the ``skip`` Bool
  (reference ``snapshotter.py:159-174``), and the snapshot taken under
  every sibling unit's run lock (``_quiesced``);
- the none, gz, bz2 and xz codecs; ``<prefix>_<suffix>.<ver>.pickle.<ext>``
  naming, write-then-rename, a SHA-256 sidecar that also vouches for the
  previous generation, and an atomic ``<prefix>_current.lnk``;
- ``import_()`` verifying the sidecar and falling back to the newest
  intact sibling of the same prefix, then marking the workflow restored
  (``_restored_from_snapshot_``: loaders keep their order);
- ``SnapshotterToDB`` over the standard library's sqlite3
  (``sqlite://db#prefix[/suffix]``) and the ``Snapshotter`` factory.

Tensors are written as host tensors whatever device they lived on, so a
snapshot loads on any host. ``import_(..., device=None)`` puts every
tensor the workflow holds, and every ``torch.device`` it names, on the
device it is given (``None`` means the card, and raises without one):
the unit Arrays, the loader's originals, the normalizer's statistics and
the GD units' solver state, which the fused tick reads back at
``initialize``. In a data-parallel world (``parallel/mesh.py``) rank 0
alone writes snapshots; in a fleet, the master (a slave never does).
"""

import bz2
import contextlib
import glob
import gzip
import hashlib
import io
import logging
import lzma
import os
import pickle
import time
import types

import numpy
import torch

from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.mutable import Bool
from veles_tpu_torch.core.pickling import Pickleable
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.device import resolve_device

CODECS = {
    None: lambda path, mode: open(path, mode + "b"),
    "": lambda path, mode: open(path, mode + "b"),
    "gz": lambda path, mode: gzip.open(path, mode + "b", compresslevel=6),
    "bz2": lambda path, mode: bz2.open(path, mode + "b", compresslevel=6),
    # preset only on write: lzma.open raises if it is passed for read
    "xz": lambda path, mode: lzma.open(
        path, mode + "b", **({"preset": 6} if "w" in mode else {})),
}

#: codec wrappers over an already-open binary stream (the write path
#: tees through a hasher; the path-based CODECS stay for reading)
_STREAM_CODECS = {
    None: lambda f: f,
    "": lambda f: f,
    "gz": lambda f: gzip.GzipFile(fileobj=f, mode="wb", compresslevel=6),
    "bz2": lambda f: bz2.BZ2File(f, "wb", compresslevel=6),
    "xz": lambda f: lzma.LZMAFile(f, "wb", preset=6),
}


class SnapshotCorruptError(Exception):
    """The snapshot's SHA-256 sidecar does not match its bytes."""


class _HashingWriter:
    """File-object tee feeding SHA-256 with every written block, so the
    sidecar digest costs no second full-file read."""

    def __init__(self, fileobj):
        self._file = fileobj
        self._digest = hashlib.sha256()

    def write(self, data):
        self._digest.update(data)
        return self._file.write(data)

    def flush(self):
        self._file.flush()

    def tell(self):
        return self._file.tell()

    def hexdigest(self):
        return self._digest.hexdigest()


class _HostPickler(pickle.Pickler):
    """Pickles a tensor on any device as the host tensor it copies to:
    objects that are not Pickleable (a normalizer's statistics) may hold
    device tensors too."""

    def __init__(self, stream, protocol):
        super().__init__(stream, protocol=protocol)
        self._protocol = protocol

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu().__reduce_ex__(self._protocol)
        return NotImplemented


def dump(payload, stream, protocol=pickle.HIGHEST_PROTOCOL):
    """Pickle ``payload`` into ``stream`` with every tensor on the
    host."""
    _HostPickler(stream, protocol=protocol).dump(payload)


def _sha256_of(path):
    digest = hashlib.sha256()
    with open(path, "rb") as fin:
        for block in iter(lambda: fin.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


#: values the placement walk never looks into
_ATOMS = (str, bytes, bytearray, int, float, complex, bool, type(None),
          numpy.ndarray, numpy.generic, type, types.ModuleType,
          types.FunctionType, types.BuiltinFunctionType, types.MethodType)


def place(obj, device):
    """Move every tensor reachable from ``obj`` to ``device`` and point
    every ``torch.device`` value at it, in place: through dicts, lists,
    tuples, the port's objects (units, Arrays, Bools, normalizers) and
    any Pickleable. Numpy values stay on the host. Returns ``obj``."""
    seen = set()

    def visit(value):
        if isinstance(value, torch.Tensor):
            return value.to(device)
        if isinstance(value, torch.device):
            return device
        if isinstance(value, _ATOMS) or id(value) in seen:
            return value
        seen.add(id(value))
        if isinstance(value, dict):
            for key in list(value):
                value[key] = visit(value[key])
        elif isinstance(value, list):
            value[:] = [visit(item) for item in value]
        elif isinstance(value, tuple):
            items = [visit(item) for item in value]
            if any(a is not b for a, b in zip(items, value)):
                return (tuple(items) if type(value) is tuple
                        else type(value)(*items))
        elif isinstance(value, Pickleable) or type(
                value).__module__.startswith("veles_tpu_torch"):
            state = getattr(value, "__dict__", None)
            if state is not None:
                for key in list(state):
                    state[key] = visit(state[key])
        return value

    return visit(obj)


class SnapshotterBase(Unit):
    """Periodic checkpoint unit (reference ``snapshotter.py:84``)."""

    hide_from_registry = True
    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow, **kwargs):
        self.prefix = kwargs.pop("prefix", "wf")
        self.directory = kwargs.pop(
            "directory", root.common.dirs.get("snapshots", "snapshots"))
        self.compression = kwargs.pop("compression", "gz")
        self.interval = kwargs.pop("interval", 1)
        self.time_interval = kwargs.pop("time_interval", 15)
        super().__init__(workflow, **kwargs)
        self.skip = Bool(False)
        self.suffix = ""
        self.destination = None
        #: seconds spent in export(), summed over this unit's snapshots
        self.export_seconds = 0.0
        self._counter = 0
        self._last_snapshot_time = 0.0

    def initialize(self, **kwargs):
        self._last_snapshot_time = time.time()

    def run(self):
        """Gated by the interval count AND the minimum wall-time window
        (reference ``snapshotter.py:159-174``)."""
        if self.is_slave or bool(self.skip) \
                or root.common.disable.get("snapshotting", False):
            return  # a fleet's snapshots are the master's
        from veles_tpu_torch.parallel.mesh import is_primary
        if not is_primary():
            return  # one snapshot per world, written by rank 0
        self._counter += 1
        if self._counter < self.interval:
            return
        self._counter = 0
        if time.time() - self._last_snapshot_time < self.time_interval:
            return
        self._last_snapshot_time = time.time()
        started = time.perf_counter()
        self.export()
        self.export_seconds += time.perf_counter() - started

    def export(self):
        raise NotImplementedError

    def _quiesced(self, write):
        """Run ``write(payload_dict)`` while every sibling unit's run
        lock is held, so the snapshot cannot tear mid-update or race a
        mutating run(); the run tokens that piled up meanwhile are
        drained after release."""
        held = [u for u in self.workflow
                if u is not self and getattr(u, "_run_lock_", None)]
        for unit in held:
            unit._run_lock_.acquire()
        try:
            return write({
                "workflow": self.workflow,
                "prng": prng.streams_state(),
                "timestamp": time.time(),
            })
        finally:
            for unit in held:
                unit._run_lock_.release()
            for unit in held:
                unit._drain_run_tokens()

    @staticmethod
    def _restore(payload, device):
        """Shared resume tail: rebind the PRNG streams, put the state on
        ``device``, flag the workflow."""
        workflow = place(payload["workflow"], device)
        prng.restore_streams(payload.get("prng", {}))
        workflow._restored_from_snapshot_ = True
        return workflow

    def get_metric_names(self):
        return ["Snapshot"]

    def get_metric_values(self):
        return [self.destination]


class SnapshotterToFile(SnapshotterBase):
    """Pickle-to-file snapshotter (reference ``snapshotter.py:360``)."""

    WRITE_PROTOCOL = pickle.HIGHEST_PROTOCOL

    def export(self):
        ext = self.compression or ""
        name = "%s_%s.%d.pickle%s" % (
            self.prefix, self.suffix or "current", self.WRITE_PROTOCOL,
            ("." + ext) if ext else "")
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp%d" % os.getpid()

        def write(payload):
            # write-then-rename: a reader (or a crash) never sees a
            # partly written snapshot; the tee hashes the bytes as they
            # land
            with open(tmp, "wb") as raw:
                tee = _HashingWriter(raw)
                codec = _STREAM_CODECS[ext](tee)
                try:
                    dump(payload, codec, self.WRITE_PROTOCOL)
                finally:
                    if codec is not tee:
                        codec.close()  # flush the compressed tail
            return tee.hexdigest()

        digest = self._quiesced(write)
        # the sidecar lands FIRST and keeps the previous generation's
        # digest: whichever generation of the data file a crash between
        # the two renames leaves behind, the sidecar vouches for it. Its
        # comment records the prefix, which the file name alone cannot
        # split from the suffix.
        sidecar = path + ".sha256"
        lines = ["%s  %s" % (digest, name)]
        try:
            with open(sidecar, "r") as fin:
                first = fin.readline().split()
            if first and first[0] != digest:
                lines.append("%s  %s" % (
                    first[0], first[1] if len(first) > 1 else name))
        except OSError:
            pass
        digest_tmp = "%s.sha256.tmp%d" % (path, os.getpid())
        with open(digest_tmp, "w") as fout:
            fout.write("\n".join(lines) + "\n# prefix: %s\n" % self.prefix)
        os.replace(digest_tmp, sidecar)
        os.replace(tmp, path)
        self.destination = path
        size = os.path.getsize(path)
        if size > 200 * 1024 * 1024:  # reference 200 MB warning threshold
            self.warning("snapshot %s is large: %d MB", path, size >> 20)
        self.info("snapshot: %s (%d KB)", path, size >> 10)
        link = os.path.join(self.directory, "%s_current.lnk" % self.prefix)
        try:
            # the resume pointer is replaced, never removed and recreated:
            # a crash cannot leave no pointer at all
            tmp_link = "%s.tmp%d" % (link, os.getpid())
            if os.path.lexists(tmp_link):
                os.remove(tmp_link)
            os.symlink(name, tmp_link)
            os.replace(tmp_link, link)
        except OSError:
            pass

    @staticmethod
    def _sidecar_prefix(path):
        """The prefix recorded in a snapshot's sidecar, or None."""
        try:
            with open(path + ".sha256", "r") as fin:
                for line in fin:
                    if line.startswith("# prefix:"):
                        return line[len("# prefix:"):].strip()
        except OSError:
            pass
        return None

    @staticmethod
    def _load_verified(path, device):
        """Unpickle one snapshot onto ``device``, checking its SHA-256
        sidecar first where one exists; any digest the sidecar lists is
        accepted (the crash-window contract). Raises on corruption."""
        sidecar = path + ".sha256"
        if os.path.isfile(sidecar):
            with open(sidecar, "r") as fin:
                want = [line.split()[0] for line in fin
                        if line.strip() and not line.startswith("#")]
            got = _sha256_of(path)
            if want and got not in want:
                raise SnapshotCorruptError(
                    "%s: sha256 %s not among sidecar digests %s"
                    % (path, got, want))
        ext = ""
        for candidate in ("gz", "bz2", "xz"):
            if path.endswith("." + candidate):
                ext = candidate
        with CODECS[ext](path, "r") as fin:
            payload = pickle.load(fin)
        return SnapshotterBase._restore(payload, device)

    @staticmethod
    def import_(path, device=None):
        """Resume: unpickle the snapshot at ``path`` (a file or the
        ``_current.lnk`` link) onto ``device`` (None: the card) and mark
        it restored. Returns the workflow.

        A truncated, corrupt or mismatching snapshot falls back, with a
        warning, to the newest sibling of the same prefix that
        verifies."""
        device = resolve_device(device)
        if os.path.islink(path):
            path = os.path.join(os.path.dirname(path), os.readlink(path))
        log = logging.getLogger("Snapshotter")
        try:
            return SnapshotterToFile._load_verified(path, device)
        except Exception as exc:
            log.warning("snapshot %s is unusable (%s); looking for an "
                        "intact previous version", path, exc)
            directory = os.path.dirname(os.path.abspath(path))
            # the SAME prefix only: a shared directory must never resume
            # another experiment. Without a sidecar, the broken file's
            # first "_" segment at least never crosses a leading name.
            want_prefix = SnapshotterToFile._sidecar_prefix(path)
            base = os.path.basename(path)
            stem = base.split("_", 1)[0] + "_" if "_" in base else ""
            siblings = [
                p for p in glob.glob(
                    os.path.join(directory, "%s*.pickle*" % stem))
                if not p.endswith((".sha256", ".lnk"))
                and ".tmp" not in os.path.basename(p)
                and os.path.abspath(p) != os.path.abspath(path)
                and (want_prefix is None
                     or SnapshotterToFile._sidecar_prefix(p)
                     == want_prefix)]
            siblings.sort(key=os.path.getmtime, reverse=True)
            for candidate in siblings:
                try:
                    workflow = SnapshotterToFile._load_verified(
                        candidate, device)
                except Exception:
                    continue
                log.warning("falling back to intact snapshot %s",
                            candidate)
                return workflow
            raise

    def export_weights(self, path=None):
        """Plain interchange dump: an ``.npz`` of every forward unit's
        weights and bias under the JAX package's keys
        (``<unit>_weights``, ``<unit>_bias``); layers without parameters
        (poolings) are skipped."""
        from veles_tpu_torch.nn.jit_unit import ForwardUnit
        path = path or os.path.join(
            self.directory, "%s_weights.npz" % self.prefix)
        arrays = {}
        for unit in self.workflow:
            if isinstance(unit, ForwardUnit) \
                    and getattr(unit, "weights", None) is not None:
                arrays["%s_weights" % unit.name] = unit.weights.mem
                arrays["%s_bias" % unit.name] = unit.bias.mem
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        numpy.savez(path, **arrays)
        return path


class SnapshotterToDB(SnapshotterBase):
    """Database-backed snapshot store (reference ``SnapshotterToDB``,
    ``snapshotter.py:428-518``; the standard library's sqlite3 here).

    Rows: (prefix, suffix, protocol, timestamp, codec, pickle BLOB
    compressed per ``compression``). ``destination`` is a
    ``sqlite://<db-path>#<prefix>`` URI that :meth:`import_` and the
    CLI's ``-w`` accept; import picks the newest row for the prefix (or
    an exact ``#prefix/suffix``)."""

    WRITE_PROTOCOL = pickle.HIGHEST_PROTOCOL
    TABLE = "veles_snapshots"

    _BLOB_CODECS = {
        "": (lambda b: b, lambda b: b),
        "gz": (lambda b: gzip.compress(b, 6), gzip.decompress),
        "bz2": (lambda b: bz2.compress(b, 6), bz2.decompress),
        "xz": (lambda b: lzma.compress(b, preset=6), lzma.decompress),
    }

    def __init__(self, workflow, **kwargs):
        self.database = kwargs.pop("database")
        kwargs.setdefault("compression", "gz")
        super().__init__(workflow, **kwargs)
        if (self.compression or "") not in self._BLOB_CODECS:
            raise ValueError("unsupported DB snapshot compression %r"
                             % self.compression)

    @classmethod
    def _ensure_table(cls, conn):
        conn.execute(
            "CREATE TABLE IF NOT EXISTS %s ("
            "id INTEGER PRIMARY KEY AUTOINCREMENT, "
            "prefix TEXT, suffix TEXT, protocol INTEGER, "
            "timestamp REAL, codec TEXT DEFAULT 'gz', payload BLOB)"
            % cls.TABLE)

    def export(self):
        import sqlite3

        def write(payload):
            buf = io.BytesIO()
            dump(payload, buf, self.WRITE_PROTOCOL)
            return buf.getvalue()

        codec = self.compression or ""
        blob = self._BLOB_CODECS[codec][0](self._quiesced(write))
        os.makedirs(os.path.dirname(os.path.abspath(self.database)),
                    exist_ok=True)
        # closing() as well: `with connection` only manages the
        # transaction
        with contextlib.closing(sqlite3.connect(self.database)) as conn, \
                conn:
            self._ensure_table(conn)
            conn.execute(
                "INSERT INTO %s (prefix, suffix, protocol, timestamp, "
                "codec, payload) VALUES (?, ?, ?, ?, ?, ?)" % self.TABLE,
                (self.prefix, self.suffix or "current",
                 self.WRITE_PROTOCOL, time.time(), codec, blob))
        self.destination = "sqlite://%s#%s" % (self.database, self.prefix)
        self.info("snapshot: %s (%d KB)", self.destination,
                  len(blob) >> 10)

    @staticmethod
    def import_(uri, device=None):
        """Load the newest snapshot for ``sqlite://db#prefix`` (or the
        exact ``sqlite://db#prefix/suffix``) onto ``device``."""
        import sqlite3
        device = resolve_device(device)
        if uri.startswith("sqlite://"):
            uri = uri[len("sqlite://"):]
        database, _, selector = uri.partition("#")
        prefix, _, suffix = selector.partition("/")
        if not os.path.exists(database):
            # sqlite3.connect would create an empty database here
            raise FileNotFoundError("no such database: %s" % database)
        query = ("SELECT payload, codec FROM %s WHERE prefix = ?"
                 % SnapshotterToDB.TABLE)
        args = [prefix]
        if suffix:
            query += " AND suffix = ?"
            args.append(suffix)
        # insert order, not wall clock: shared-storage writers may skew
        query += " ORDER BY id DESC LIMIT 1"
        with contextlib.closing(sqlite3.connect(database)) as conn, conn:
            SnapshotterToDB._ensure_table(conn)
            row = conn.execute(query, args).fetchone()
        if row is None:
            raise FileNotFoundError(
                "no snapshot for prefix %r in %s" % (prefix, database))
        blob, codec = row
        payload = pickle.loads(
            SnapshotterToDB._BLOB_CODECS[codec or ""][1](blob))
        return SnapshotterBase._restore(payload, device)


def Snapshotter(workflow, **kwargs):
    """Dispatching constructor (reference ``snapshotter.py:521-535``):
    ``database=`` (a sqlite file path) selects :class:`SnapshotterToDB`,
    otherwise :class:`SnapshotterToFile`."""
    if kwargs.get("database"):
        return SnapshotterToDB(workflow, **kwargs)
    return SnapshotterToFile(workflow, **kwargs)
