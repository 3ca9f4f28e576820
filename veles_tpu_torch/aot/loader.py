"""AOT bundle loader: gate, stage the libraries, serve every dispatch.

The port of ``veles_tpu/aot/loader.py``. :func:`load_bundle` reads a
bundle (``artifact.py``), gates it strictly against this process
(:func:`check_compat`: schema, torch and CUDA versions, the kernels'
source digests, the device fingerprint, the mesh; any mismatch raises
:class:`AotCompatError` naming the stale field, and serving boots live,
loudly), then stages its libraries: each is written through the
executable cache (``exec_cache.py``; a process-private directory when
none is configured), verified against its sidecar, and registered with
``ops/_build.stage`` under the tree's source digest. A later
``ops/_build.function(name, ...)`` loads the staged library and never
runs ``nvcc`` for it. A refused cache entry stages nothing: that library
is built live by ``nvcc`` (the same kernel), once, loudly.

:meth:`AotPrograms.bind` attaches the bundle to a
:class:`~veles_tpu_torch.serving.ContinuousDecoder` after checking its
geometry field by field. The decoder looks each dispatch up by its
program name and key: a covered dispatch readies its row's libraries
(the ``ctypes`` loads, usually done already by the prefetch threads) and
books a hit under the program's ``observe/xla_stats`` name; an uncovered
one books a miss. Either way the same code runs the same kernels: the
bundle changes where the libraries come from, never what computes. The
zero-retrace proof is the compile tracker's flat ``<stem>.cu`` build
count across the warm-up (``veles_kernel_builds_total``).
"""

import atexit
import logging
import os
import shutil
import tempfile
import threading
import time
import weakref

import torch

from veles_tpu_torch.aot.artifact import (SCHEMA_VERSION, fingerprint_for,
                                          read_bundle)


class AotCompatError(ValueError):
    """A bundle refused by the gate; ``field`` names what is stale
    (schema / torch / cuda / kernels / fingerprint / mesh / a geometry
    key), so the operator knows what to rebuild."""

    def __init__(self, field, message):
        super().__init__(message)
        self.field = field


#: live AotPrograms instances, for the /metrics collector
_LOADED = weakref.WeakSet()
_LOADED_LOCK = threading.Lock()

#: process-lifetime tallies (hits and misses per program, load wall):
#: the counters publish from here, so a bundle collected after a reload
#: never makes an exported counter decrease
_TOTALS = {"hits": {}, "misses": {}, "wall": 0.0}
_TOTALS_LOCK = threading.Lock()


def _tally(kind, name):
    with _TOTALS_LOCK:
        store = _TOTALS[kind]
        store[name] = store.get(name, 0) + 1


def _tally_wall(seconds):
    with _TOTALS_LOCK:
        _TOTALS["wall"] += float(seconds)


def _stop_all_prefetchers():
    """Interpreter-exit hook: stop every bundle's prefetch workers after
    the library each is loading."""
    with _LOADED_LOCK:
        loaded = list(_LOADED)
    for programs in loaded:
        programs.stop_prefetch()


# threading's own exit hook runs BEFORE non-daemon threads are joined;
# plain atexit runs after, which would wait out the whole warm-up queue
threading._register_atexit(_stop_all_prefetchers)


def _device_of(manifest):
    """The device a bundle was built for: the CPU for a CPU bundle, else
    the card."""
    backend = (manifest.get("fingerprint") or {}).get("backend")
    return torch.device("cpu" if backend == "cpu" else "cuda")


def check_compat(manifest, mesh=None, device=None):
    """The strict gate. Raises :class:`AotCompatError` naming the first
    stale field; returns None when the bundle may load here for
    ``device`` (default: the device the bundle names)."""
    from veles_tpu_torch.ops import _build

    schema = manifest.get("schema")
    if schema != SCHEMA_VERSION:
        raise AotCompatError(
            "schema", "bundle schema %r != supported %d - rebuild the "
            "bundle with this veles_tpu_torch" % (schema, SCHEMA_VERSION))
    for field, current in (("torch", torch.__version__),
                           ("cuda", torch.version.cuda)):
        recorded = manifest.get(field)
        if recorded != current:
            raise AotCompatError(
                field, "bundle was built under %s %s but this process "
                "runs %s - refusing stale libraries; rebuild with "
                "`python -m veles_tpu_torch aot build`"
                % (field, recorded, current))
    for stem, digest in sorted((manifest.get("kernels") or {}).items()):
        current = (_build.source_digest(stem)
                   if stem in _build.KERNELS else None)
        if digest != current:
            raise AotCompatError(
                "kernels", "bundle library %s.cu was built from sources "
                "%s..., this tree's are %s - rebuild the bundle"
                % (stem, str(digest)[:16],
                   "%s..." % current[:16] if current else "absent"))
    recorded = manifest.get("fingerprint") or {}
    current = fingerprint_for(device if device is not None
                              else _device_of(manifest))
    for key in ("backend", "device_kind", "device_count"):
        if recorded.get(key) != current.get(key):
            raise AotCompatError(
                "fingerprint", "bundle device fingerprint %s=%r does not "
                "match this machine's %r - built libraries are "
                "device-specific; rebuild on matching hardware"
                % (key, recorded.get(key), current.get(key)))
    bundle_mesh = manifest.get("mesh")
    if bundle_mesh is None:
        if mesh is not None:
            raise AotCompatError(
                "mesh", "bundle holds single-chip programs but a mesh "
                "%r was requested — rebuild with --mesh"
                % dict(mesh.shape))
    else:
        if mesh is None:
            raise AotCompatError(
                "mesh", "bundle holds programs for mesh axes %r but no "
                "serving mesh was configured (--serve-mesh)"
                % bundle_mesh.get("axes"))
        if _wide(bundle_mesh.get("axes")) != _wide(mesh.shape):
            raise AotCompatError(
                "mesh", "bundle mesh axes %r != serving mesh %r"
                % (bundle_mesh.get("axes"), dict(mesh.shape)))


def _wide(axes):
    """The axes of a mesh sized above 1 (a mesh names its size-1 axes or
    leaves them out: the same layout)."""
    return {name: int(size) for name, size in dict(axes or {}).items()
            if int(size) != 1}


class _Library:
    """One library of the bundle: staged at load (its path registered
    with ``ops/_build.stage``), loaded on first use or by a prefetch
    worker. ``origin`` says where it came from: ``"cache"`` (a verified
    entry of the persistent cache), ``"bundle"`` (written from the
    bundle's member this process) or ``"live"`` (the entry was refused:
    ``nvcc`` builds it)."""

    __slots__ = ("name", "bytes", "origin", "loaded", "lock")

    def __init__(self, name, nbytes, origin):
        self.name = name
        self.bytes = nbytes
        self.origin = origin
        self.loaded = False
        self.lock = threading.Lock()

    def get(self):
        if self.loaded:
            return
        with self.lock:
            if not self.loaded:
                from veles_tpu_torch.ops import _build

                t0 = time.perf_counter()
                _build.load(self.name)
                _tally_wall(time.perf_counter() - t0)
                self.loaded = True


class _Entry:
    """One program row: ready once every library it launches is
    loaded."""

    __slots__ = ("row", "libraries", "compiled", "compile_seconds")

    def __init__(self, row, libraries):
        self.row = row
        self.libraries = libraries
        self.compiled = False
        self.compile_seconds = 0.0

    @property
    def from_cache(self):
        return bool(self.libraries) and all(
            lib.origin == "cache" for lib in self.libraries)

    @property
    def live(self):
        return any(lib.origin == "live" for lib in self.libraries)

    def get(self):
        if not self.compiled:
            t0 = time.perf_counter()
            for lib in self.libraries:
                lib.get()
            self.compile_seconds = time.perf_counter() - t0
            self.compiled = True
        return self


class AotPrograms:
    """A loaded bundle: its program rows keyed by (name, key), the
    libraries they launch, dispatch stats and the decoder binding."""

    def __init__(self, manifest, entries, libraries=None, path=None,
                 load_seconds=0.0, exec_cache=None):
        self.manifest = manifest
        self.path = path
        self.geometry = manifest.get("geometry")
        self.chunk = manifest.get("chunk")
        self._entries = entries         # (name, key tuple) -> _Entry
        self._libraries = libraries or {}   # stem -> _Library
        self.load_seconds = load_seconds
        #: the persistent cache the libraries were staged through, or None
        self.exec_cache = exec_cache
        self._lock = threading.Lock()
        self._prefetchers = []
        self._prefetch_stop = threading.Event()
        self.hits = {}
        self.misses = {}
        #: tuning verdicts adopted from the bundle (``_adopt_verdicts``)
        self.verdicts = 0
        with _LOADED_LOCK:
            _LOADED.add(self)
        # memscope's per-owner attribution: the staged libraries' bytes
        # under "aot_executables" while this bundle lives
        try:
            from veles_tpu_torch.observe.memscope import get_memscope
            get_memscope().register(
                "aot_executables", self,
                lambda programs: programs.footprint_bytes())
        except Exception:   # noqa: BLE001 - attribution is best-effort
            pass

    def __len__(self):
        return len(self._entries)

    def footprint_bytes(self):
        """The bytes of the libraries this bundle staged (the loaded
        code's size; lock-free, the map is written once at load)."""
        return sum(lib.bytes for lib in self._libraries.values())

    def libraries(self):
        """``{stem: origin}`` of the bundle's libraries."""
        return {stem: lib.origin for stem, lib in self._libraries.items()}

    def prefetch(self, workers=None):
        """Load every staged library on background threads (the
        ``ctypes`` loads overlap the decoder build); a dispatch that
        needs one first loads it itself under its lock. Non-daemon
        threads, stopped at exit after the library in hand."""
        import os

        if workers is None:
            workers = max(1, min(4, os.cpu_count() or 1))
        queue = sorted(self._libraries.values(), key=lambda lib: lib.name)
        index = {"next": 0}
        index_lock = threading.Lock()

        def worker():
            while not self._prefetch_stop.is_set():
                with index_lock:
                    i = index["next"]
                    index["next"] = i + 1
                if i >= len(queue):
                    return
                try:
                    queue[i].get()
                except Exception:   # noqa: BLE001 - a dispatch retries
                    logging.getLogger("aot").exception(
                        "prefetch load failed for %s", queue[i].name)

        self._prefetchers = [
            threading.Thread(target=worker, name="aot-prefetch-%d" % i)
            for i in range(min(workers, max(1, len(queue))))]
        for thread in self._prefetchers:
            thread.start()
        return self

    def stop_prefetch(self):
        self._prefetch_stop.set()
        for thread in self._prefetchers:
            if thread.is_alive():
                thread.join()
        self._prefetchers = []

    def compile_all(self):
        """Ready every program now, blocking (the pre-warmed boot)."""
        t0 = time.perf_counter()
        for entry in self._entries.values():
            entry.get()
        for thread in self._prefetchers:
            thread.join()
        self.load_seconds += time.perf_counter() - t0
        return self

    def program(self, name, key):
        """The readied entry of ``(name, key)``, or None when the bundle
        does not cover it."""
        entry = self._entries.get((name, tuple(key)))
        if entry is None:
            return None
        return entry.get()

    def keys(self):
        return sorted(self._entries)

    def prewarm_bucket(self, bucket):
        """Ready every admission row whose key names ``bucket`` (the
        serving governor's hot-bucket actuator). The match is
        positional, key[1], as in the JAX package: a bucket equal to
        another row's element elsewhere warms nothing unrelated.
        Returns the number of rows readied."""
        warmed = 0
        for (name, key), entry in sorted(self._entries.items()):
            if "admit" not in name or len(key) < 2 or key[1] != bucket:
                continue
            if not entry.compiled:
                entry.get()
                warmed += 1
        return warmed

    # -- bookkeeping ------------------------------------------------------
    def _book_hit(self, name):
        with self._lock:
            self.hits[name] = self.hits.get(name, 0) + 1
        _tally("hits", name)

    def _book_miss(self, name):
        with self._lock:
            self.misses[name] = self.misses.get(name, 0) + 1
        _tally("misses", name)

    def stats(self):
        entries = list(self._entries.values())
        compiled = sum(1 for e in entries if e.compiled)
        with self._lock:
            out = {"programs": len(entries),
                   "compiled": compiled,
                   # rows whose libraries all came from the persistent
                   # cache, and rows that needed a live nvcc build
                   "from_cache": sum(1 for e in entries
                                     if e.compiled and e.from_cache),
                   "compiled_live": sum(1 for e in entries
                                        if e.compiled and e.live),
                   "compile_seconds": round(sum(e.compile_seconds
                                                for e in entries), 4),
                   "load_seconds": round(self.load_seconds, 4),
                   "hits": dict(self.hits),
                   "misses": dict(self.misses),
                   "libraries": self.libraries(),
                   "verdicts": self.verdicts}
        if self.exec_cache is not None:
            out["exec_cache"] = self.exec_cache.stats()
        return out

    # -- serving facade ---------------------------------------------------
    def bind(self, decoder):
        """Check ``decoder``'s geometry against the bundle's and return
        the bound dispatch facade. Raises :class:`AotCompatError` naming
        the first mismatching field; the decoder then serves live with a
        loud warning."""
        from veles_tpu_torch.aot.artifact import decoder_geometry

        if self.geometry is None:
            raise AotCompatError(
                "geometry", "bundle %r holds no serving geometry (not a "
                "serving bundle)" % (self.path,))
        live = decoder_geometry(decoder)
        for field in sorted(set(self.geometry) | set(live)):
            if self.geometry.get(field) != live.get(field):
                raise AotCompatError(
                    field, "bundle geometry %s=%r does not match the "
                    "serving configuration's %r - rebuild the bundle or "
                    "align the serving flags"
                    % (field, self.geometry.get(field), live.get(field)))
        return _BoundAot(self)


class _BoundAot:
    """A decoder's view of the bundle: :meth:`dispatch` before each
    program call."""

    def __init__(self, programs):
        self._programs = programs
        #: (program, served from the bundle) of the latest dispatch: the
        #: request ledger's aot/live attribution
        self.last_dispatch = None

    def dispatch(self, name, key):
        """Look the dispatch up: a covered one readies its row and books
        a hit, an uncovered one books a miss. Returns True when the
        bundle served it."""
        entry = self._programs._entries.get((name, key))
        if entry is None:
            self._programs._book_miss(name)
            self.last_dispatch = (name, False)
            return False
        entry.get()
        self._programs._book_hit(name)
        self.last_dispatch = (name, True)
        return True


def _avals_match(row, args):
    """True when a call's tensor operands have the recorded shapes and
    dtypes: a mismatched call is a miss."""
    from veles_tpu_torch.aot.artifact import _aval_rows

    return (row.get("in_avals") or []) == _aval_rows(args)


def _tick_dispatch(programs, name, key_head, live_fn, mb_arg, n_args):
    """A fused-tick step that books matching-shape calls as bundle hits
    (their libraries readied) and runs the live step either way."""
    def dispatch(*args):
        mb = int(args[mb_arg].shape[0])
        entry = programs._entries.get((name, (key_head, mb)))
        if entry is None or not _avals_match(entry.row, args[:n_args]):
            programs._book_miss(name)
        else:
            entry.get()
            programs._book_hit(name)
        return live_fn(*args)

    dispatch.__wrapped__ = live_fn
    return dispatch


def install_fused_tick(programs, specs, norm_type="none", mesh=None,
                       with_confusion=True, augment="none",
                       loss_kind="softmax", grad_reduce="f32"):
    """Slot a bundle's fused-tick rows into ``parallel/fused``'s tick
    cache (``install_tick_steps``): a later ``build_tick`` (or
    ``FusedTick``) with this topology and these engine knobs steps
    through the bundle's libraries, booking each train and eval step as
    a hit or a miss; the sweeps run the live steps over the same staged
    libraries. Returns the installed step tuple."""
    from veles_tpu_torch.parallel import fused

    live = fused.build_tick(specs, norm_type, mesh=mesh,
                            with_confusion=with_confusion,
                            augment=augment, loss_kind=loss_kind,
                            grad_reduce=grad_reduce, cached=False)
    steps = (_tick_dispatch(programs, "fused.train_step", "train_step",
                            live[0], mb_arg=5, n_args=7),
             _tick_dispatch(programs, "fused.eval_step", "eval_step",
                            live[1], mb_arg=4, n_args=6),
             live[2], live[3])
    fused.install_tick_steps(steps, specs, norm_type=norm_type,
                             mesh=mesh, with_confusion=with_confusion,
                             augment=augment, loss_kind=loss_kind,
                             grad_reduce=grad_reduce)
    return steps


def install_workflow_tick(programs, workflow):
    """:func:`install_fused_tick` for the fused tick ``workflow`` will
    build: its topology and knobs (``parallel/fused.tick_config``) read
    from the constructed workflow, so call it before ``initialize()``."""
    from veles_tpu_torch.parallel.fused import tick_config

    specs, norm_type, kwargs = tick_config(workflow)
    return install_fused_tick(programs, specs, norm_type=norm_type,
                              **kwargs)


#: process-private staging directories (no persistent cache configured),
#: removed at exit
_PRIVATE_DIRS = []


def _remove_private_dirs():
    for directory in _PRIVATE_DIRS:
        shutil.rmtree(directory, ignore_errors=True)


atexit.register(_remove_private_dirs)


def _stage_libraries(manifest, members, cache, path):
    """Stage every library member: through ``cache`` (a verified hit is
    taken as is; a miss is written from the member; a refused entry
    stages nothing, so ``nvcc`` builds that library live), or, without
    one, written into a process-private directory. Returns ``{stem:
    _Library}``."""
    from veles_tpu_torch.aot.exec_cache import (ExecutableCache,
                                                cache_fingerprint,
                                                entry_key)
    from veles_tpu_torch.ops import _build

    rows = [row for row in manifest.get("libraries", ())
            if row.get("member")]
    out = {}
    if not rows:
        return out
    private = cache is None
    if private:
        directory = tempfile.mkdtemp(prefix="veles-aot-")
        _PRIVATE_DIRS.append(directory)
        cache = ExecutableCache(directory)
    fingerprint = cache_fingerprint()
    for row in rows:
        key = entry_key(row, fingerprint)
        name = row["name"]
        present = os.path.isfile(cache.path(key))
        staged = None if private else cache.load(key)
        origin = "cache"
        if staged is None and present and not private:
            # refused (torn, bit-flipped, sidecar-less; warned once by the
            # cache): never trust it, and never substitute quietly
            logging.getLogger("aot").warning(
                "library %s.cu of bundle %s not staged (its cache entry "
                "was refused): nvcc builds it live", name, path)
            _build.unstage(name)
            out[name] = _Library(name, row["bytes"], "live")
            continue
        if staged is None:
            staged, origin = cache.store(key, members[row["member"]]), \
                "bundle"
        if staged is None:
            logging.getLogger("aot").warning(
                "library %s.cu of bundle %s could not be staged: nvcc "
                "builds it live", name, path)
            _build.unstage(name)
            out[name] = _Library(name, row["bytes"], "live")
            continue
        _build.stage(name, staged, row["digest"])
        out[name] = _Library(name, row["bytes"], origin)
    return out


def _adopt_verdicts(manifest, members):
    """Merge the bundle's tuning verdicts into this process's tuning
    cache (``ops/gemm._load_cache``, in memory: the file stays as it is)
    where the cache has none of its own for the key: a verdict measured
    on this card wins. Returns the number adopted."""
    row = manifest.get("verdicts")
    if not row:
        return 0
    import json

    from veles_tpu_torch.ops import gemm

    cache = gemm._load_cache()
    adopted = 0
    for key, entry in json.loads(members[row["member"]].decode()).items():
        if key not in cache and gemm._sane_entry(entry):
            cache[key] = entry
            adopted += 1
    return adopted


def load_bundle(path, mesh=None, eager=False, prefetch=True,
                exec_cache=None, device=None):
    """Read, gate and stage a bundle; returns :class:`AotPrograms`.
    Raises :class:`AotCompatError` (a stale field, named) or
    ``ValueError`` (a tampered or torn bundle, the member named); then
    nothing is staged.

    By default the libraries load on background prefetch threads and on
    demand at the first dispatch; ``eager=True`` loads them all first
    (the pre-warmed replica), ``prefetch=False`` leaves them to the
    dispatches. ``exec_cache``: ``True`` stages through the conventional
    ``<bundle>.xcache`` directory, a string through that directory,
    ``False`` through a process-private one, ``None`` (default) as
    ``root.common.serve.aot_cache`` says. ``device`` is the device the
    bundle must match: None means the card, and raises without one unless
    the caller passes ``"cpu"``."""
    from veles_tpu_torch.aot.exec_cache import resolve_cache
    from veles_tpu_torch.device import resolve_device

    device = resolve_device(device)
    t0 = time.perf_counter()
    manifest, members = read_bundle(path)
    check_compat(manifest, mesh=mesh, device=device)
    cache = resolve_cache(exec_cache, path)
    libraries = _stage_libraries(manifest, members, cache, path)
    verdicts = _adopt_verdicts(manifest, members)
    entries = {}
    for row in manifest.get("programs", ()):
        entries[(row["name"], tuple(row["key"]))] = _Entry(
            row, [libraries[stem] for stem in row.get("libraries", ())
                  if stem in libraries])
    load_seconds = time.perf_counter() - t0
    _tally_wall(load_seconds)
    programs = AotPrograms(manifest, entries, libraries=libraries,
                           path=str(path), load_seconds=load_seconds,
                           exec_cache=cache)
    programs.verdicts = verdicts
    if eager:
        programs.compile_all()
    elif prefetch:
        programs.prefetch()
    return programs


def publish_aot_stats(registry):
    """Scrape-time collector (through ``observe/xla_stats``'s device-truth
    collector): the loaded-program gauge, the load wall and the hit and
    miss tallies whose flat-build twin proves the bundle served."""
    with _LOADED_LOCK:
        loaded = list(_LOADED)
    with _TOTALS_LOCK:
        hits = dict(_TOTALS["hits"])
        misses = dict(_TOTALS["misses"])
        wall = _TOTALS["wall"]
    if not loaded and not hits and not misses and not wall:
        return
    registry.set("veles_aot_programs_loaded",
                 sum(len(programs) for programs in loaded),
                 help="compiled programs held by live AOT bundles")
    registry.counter_set(
        "veles_aot_load_seconds_total", round(wall, 6),
        help="wall seconds spent loading + compiling AOT bundles")
    for name, count in hits.items():
        registry.counter_set(
            "veles_aot_hits_total", count, labels={"program": name},
            help="dispatches served by AOT-loaded programs")
    for name, count in misses.items():
        registry.counter_set(
            "veles_aot_misses_total", count, labels={"program": name},
            help="dispatches that fell back to live compilation")
    from veles_tpu_torch.aot.exec_cache import totals as xc_totals
    xc = xc_totals()
    if any(xc.values()):
        registry.counter_set(
            "veles_aot_exec_cache_hits_total", xc["hits"],
            help="executables deserialized from the persistent "
                 "executable cache instead of XLA-compiled")
        registry.counter_set(
            "veles_aot_exec_cache_misses_total", xc["misses"],
            help="persistent-executable-cache lookups that fell "
                 "back to live XLA compilation")
        registry.counter_set(
            "veles_aot_exec_cache_writes_total", xc["writes"],
            help="executables serialized into the persistent "
                 "executable cache")
        registry.counter_set(
            "veles_aot_exec_cache_rejects_total", xc["rejects"],
            help="torn/tampered persistent-cache entries refused "
                 "by the sha256 sidecar check")
