"""Device truth on CUDA: kernel builds, program calls, device memory and
online MFU.

The port's counterpart of ``veles_tpu/observe/xla_stats.py:57-567``. It
keeps the module's name so a reader finds it at the same path; it holds
the port's device-truth plane on CUDA, and no XLA is involved. Four
parts:

- **kernel builds**: eager PyTorch compiles nothing per call, so the
  port's compile events are the ``nvcc`` builds and library loads of
  ``ops/_build.py``: ``build()`` books each source it compiles with its
  wall seconds (:meth:`CompileTracker.record_compile`), ``function()``
  each library it loads (:meth:`CompileTracker.record_hit`). They
  happen once per process, usually before any ``/metrics`` surface
  mounts, so the tracker keeps them even while it is disabled (no hot
  path reaches them). Each keeps its wall window, so the request ledger
  names a build or load that stalled a request
  (:meth:`CompileTracker.compiles_overlapping`). ``STORM_THRESHOLD`` builds of one source inside
  ``STORM_WINDOW`` seconds is a rebuild storm, warned once and counted;
- **program calls**: :func:`instrument` stamps ``program_name`` on the
  serving programs (``parallel/decode.py``, ``parallel/kv_pool.py``:
  ``decode.generate``, ``decode.admit``, ``decode.step``,
  ``decode.dispatch``, ``paged.admit``, ...) and, while the tracker is
  enabled, counts their calls and host wall seconds; a disabled
  tracker's wrapper is pure delegation. No ``decode.*`` compile is
  booked: there is none;
- **online MFU**: torch has no ``cost_analysis``, so a program's FLOPs
  are counted from its shapes (``parallel/decode.dispatch_flops`` and
  ``prefill_flops``) and pinned by the serving decoder through
  :meth:`CompileTracker.set_program_flops`; the decoder's chunk cadence
  feeds :meth:`CompileTracker.observe_step`, and
  ``veles_mfu_ratio{program=}`` is the FLOPs over the cadence's EMA over
  the card's bf16 peak (:func:`peak_tflops`);
- **device gauges**: :func:`publish_device_stats` maps
  ``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit`` onto
  ``torch.cuda.memory_stats()`` (``allocated_bytes.all.current`` and
  ``.peak``) and ``torch.cuda.mem_get_info()`` (the device's total), and
  adds ``bytes_reserved`` (the caching allocator's
  ``reserved_bytes.all.current``). JAX's ``largest_alloc_size`` has no
  CUDA counterpart and is not published. Without an initialised card
  the gauge reports ``live_bytes`` of device ``cpu``: the bytes of the
  tensors the port's owners hold (:func:`track_owner`; the serving
  decoder registers its weights and state), as the JAX package's
  live-buffer fallback does.

Families that differ from the JAX package's (:data:`DIFFERING_FAMILIES`
maps each JAX name to the port's, None where the port has none):
``veles_xla_compiles_total{program}`` is ``veles_kernel_builds_total
{kernel}``, ``veles_xla_compile_seconds_total`` is
``veles_kernel_build_seconds_total``, ``veles_xla_cache_hits_total`` is
``veles_kernel_loads_total``, ``veles_xla_recompile_storms_total`` is
``veles_kernel_rebuild_storms_total``, ``veles_xla_program_flops`` is
``veles_program_flops``; the port adds ``veles_program_calls_total``,
``veles_program_seconds_total`` and a serving mesh's ``veles_tp_*``
(:data:`PORT_FAMILIES`). Kept as in
JAX: ``veles_device_memory_bytes{device,kind}``,
``veles_device_memory_limit_bytes{device}``,
``veles_device_peak_bf16_tflops``,
``veles_program_flops_per_second{program}``, ``veles_mfu_ratio{program}``,
the active mesh's gauges ``veles_mesh_axis_size{axis}`` and
``veles_mesh_devices`` (``parallel/mesh.py``) and the reduce plane
(``parallel/mapreduce.publish_reduce_stats``) and the AOT families
(``veles_aot_*``, ``aot/loader.publish_aot_stats``). An AOT-booted
replica's proof is the flat ``veles_kernel_builds_total`` across its
warm-up while ``veles_aot_hits_total`` grows.

Everything but the build records is disabled by default: an instrumented
program costs one attribute check until a ``/metrics`` surface mounts
(:func:`ensure_registered`, called by ``core/httpd.py``).
"""

import functools
import logging
import threading
import time
import weakref
from collections import deque

import torch

#: published dense bf16 peaks (TFLOP/s, NVIDIA's data sheets, without
#: sparsity) by device name, most specific first: "H100 PCIe" must claim
#: its own peak before the plain "H100" (the SXM part) does
PEAK_BF16_TFLOPS = (
    ("H100 PCIe", 756.0),
    ("H100 NVL", 835.0),
    ("H100", 989.0),
    ("H200", 989.0),
    ("A100", 312.0),
)

#: the JAX package's device-truth families the port names otherwise
DIFFERING_FAMILIES = {
    "veles_xla_compiles_total": "veles_kernel_builds_total",
    "veles_xla_compile_seconds_total": "veles_kernel_build_seconds_total",
    "veles_xla_cache_hits_total": "veles_kernel_loads_total",
    "veles_xla_recompile_storms_total":
        "veles_kernel_rebuild_storms_total",
    "veles_xla_program_flops": "veles_program_flops",
}

#: families the port publishes that the JAX package has no counterpart of:
#: the programs' calls and seconds, and a serving mesh's hand-offs and
#: collectives (``observe/metrics.publish_tp``; the JAX package's mesh is
#: one SPMD program and hands nothing on)
PORT_FAMILIES = ("veles_program_calls_total",
                 "veles_program_seconds_total",
                 "veles_tp_handoff_calls_total",
                 "veles_tp_handoff_bytes_total",
                 "veles_tp_handoff_seconds_total",
                 "veles_tp_collective_calls_total",
                 "veles_tp_collective_bytes_total",
                 "veles_tp_collective_seconds_total")


def peak_tflops(device_name=None):
    """The bf16 peak of ``device_name`` (default: CUDA device 0), or
    ``root.common.observe.peak_tflops`` when set (the override for an
    unlisted card, and for CPU runs that want an MFU denominator). None
    when unknown."""
    from veles_tpu_torch.core.config import root

    override = root.common.observe.get("peak_tflops", None)
    if override:
        try:
            return float(override)
        except (TypeError, ValueError):
            pass
    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    for name, tflops in PEAK_BF16_TFLOPS:
        if name.lower() in str(device_name).lower():
            return tflops
    return None


class CompileTracker:
    """Thread-safe bookkeeping of kernel builds and loads, storms,
    program calls, FLOPs and step cadence."""

    #: a storm = this many builds of the SAME kernel source...
    STORM_THRESHOLD = 5
    #: ...within this sliding window (seconds)
    STORM_WINDOW = 60.0
    #: step-seconds EMA weight of the newest observation
    STEP_EMA = 0.2

    def __init__(self, enabled=False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._compiles = {}         # kernel -> builds
        self._compile_seconds = {}  # kernel -> total build seconds
        self._hits = {}             # kernel -> library loads
        self._storms = {}           # kernel -> storms
        self._stamps = {}           # kernel -> recent build stamps
        self._storm_warned = set()
        self._calls = {}            # program -> calls
        self._call_seconds = {}     # program -> host wall seconds
        self._flops = {}            # program -> latest FLOPs
        self._step_ema = {}         # program -> EMA of step seconds
        #: recent build and load windows (kernel, start_mono, end_mono):
        #: the request ledger names the ones that overlapped a request
        self._windows = deque(maxlen=256)

    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    # -- recording --------------------------------------------------------
    def record_compile(self, name, seconds):
        """One ``nvcc`` build of kernel source ``name`` that took
        ``seconds`` of wall time. Booked whether or not the tracker is
        enabled."""
        warn = False
        with self._lock:
            self._compiles[name] = self._compiles.get(name, 0) + 1
            self._compile_seconds[name] = \
                self._compile_seconds.get(name, 0.0) + float(seconds)
            stamps = self._stamps.get(name)
            if stamps is None:
                stamps = self._stamps[name] = deque(
                    maxlen=self.STORM_THRESHOLD)
            now = time.monotonic()
            self._windows.append((name, now - float(seconds), now))
            stamps.append(now)
            if len(stamps) == self.STORM_THRESHOLD \
                    and now - stamps[0] <= self.STORM_WINDOW:
                self._storms[name] = self._storms.get(name, 0) + 1
                stamps.clear()  # re-arm: count whole storms, not tails
                warn = name not in self._storm_warned
                self._storm_warned.add(name)
        if warn:
            logging.getLogger("CompileTracker").warning(
                "rebuild storm: kernel %r built %d times within %.0fs "
                "(reported once per kernel; "
                "veles_kernel_rebuild_storms_total keeps counting)",
                name, self.STORM_THRESHOLD, self.STORM_WINDOW)

    def record_hit(self, name, seconds=0.0):
        """One library load of kernel source ``name`` that took
        ``seconds`` of wall time (booked whether or not the tracker is
        enabled)."""
        now = time.monotonic()
        with self._lock:
            self._hits[name] = self._hits.get(name, 0) + 1
            if seconds > 0:
                self._windows.append((name, now - float(seconds), now))

    def compiles_overlapping(self, t0, t1):
        """Build and load windows intersecting the monotonic interval
        ``[t0, t1]`` as ``[(kernel source, overlap_seconds)]``: how the
        request ledger names the stall that stretched a request
        (``observe/reqledger.py``). Lock-free: one GIL-atomic copy of the
        bounded ring."""
        out = []
        for name, start, end in list(self._windows):
            overlap = min(end, t1) - max(start, t0)
            if overlap > 0:
                out.append((name, overlap))
        return out

    def record_call(self, name, seconds):
        """One call of program ``name`` that held the host ``seconds``
        (on the card: the enqueue, not the device time)."""
        with self._lock:
            self._calls[name] = self._calls.get(name, 0) + 1
            self._call_seconds[name] = \
                self._call_seconds.get(name, 0.0) + float(seconds)

    def observe_step(self, name, seconds):
        """Feed one measured step wall time for ``name`` (the serving
        driver's chunk cadence); the MFU gauge divides the program's
        FLOPs by this EMA."""
        seconds = float(seconds)
        if seconds <= 0:
            return
        with self._lock:
            ema = self._step_ema.get(name)
            self._step_ema[name] = seconds if ema is None else (
                (1 - self.STEP_EMA) * ema + self.STEP_EMA * seconds)

    def set_program_flops(self, name, flops):
        """Pin a program's FLOPs (the analytic counts of
        ``parallel/decode.py``)."""
        if flops and flops > 0:
            with self._lock:
                self._flops[name] = float(flops)

    # -- views ------------------------------------------------------------
    def storm_total(self):
        """The rebuild storms of every kernel source together: the
        serving governor's stall predictor (``observe/governor.py``), one
        lock, cheap enough for a read every control tick."""
        with self._lock:
            return sum(self._storms.values())

    def snapshot(self):
        """Plain-dict view for black-box dumps: the JAX package's keys
        (``compiles``, ``compile_seconds``, ``hits``, ``storms`` keyed by
        kernel source; ``flops``, ``mfu`` by program) plus ``calls`` and
        ``call_seconds`` by program."""
        peak = peak_tflops()
        with self._lock:
            mfu = {}
            for name, flops in self._flops.items():
                ema = self._step_ema.get(name)
                if ema:
                    fps = flops / ema
                    mfu[name] = {"flops_per_sec": fps}
                    if peak:
                        mfu[name]["mfu"] = fps / (peak * 1e12)
            return {"compiles": dict(self._compiles),
                    "compile_seconds": {
                        k: round(v, 4)
                        for k, v in self._compile_seconds.items()},
                    "hits": dict(self._hits),
                    "storms": dict(self._storms),
                    "calls": dict(self._calls),
                    "call_seconds": {
                        k: round(v, 6)
                        for k, v in self._call_seconds.items()},
                    "flops": dict(self._flops),
                    "mfu": mfu}

    def publish(self, registry):
        """Scrape-time re-publication into ``registry`` (the bridge
        contract: the tracker stays the source of truth)."""
        with self._lock:
            compiles = dict(self._compiles)
            seconds = dict(self._compile_seconds)
            hits = dict(self._hits)
            storms = dict(self._storms)
            calls = dict(self._calls)
            call_seconds = dict(self._call_seconds)
            flops = dict(self._flops)
            step_ema = dict(self._step_ema)
        for name, count in compiles.items():
            registry.counter_set(
                "veles_kernel_builds_total", count,
                labels={"kernel": name},
                help="nvcc builds per kernel source")
        for name, total in seconds.items():
            registry.counter_set(
                "veles_kernel_build_seconds_total", round(total, 6),
                labels={"kernel": name},
                help="wall seconds spent building per kernel source")
        for name, count in hits.items():
            registry.counter_set(
                "veles_kernel_loads_total", count,
                labels={"kernel": name},
                help="kernel library loads per kernel source")
        for name, count in storms.items():
            registry.counter_set(
                "veles_kernel_rebuild_storms_total", count,
                labels={"kernel": name},
                help="rebuild storms (N builds of one source in a "
                     "sliding window)")
        for name, count in calls.items():
            registry.counter_set(
                "veles_program_calls_total", count,
                labels={"program": name},
                help="calls per instrumented program")
            registry.counter_set(
                "veles_program_seconds_total",
                round(call_seconds.get(name, 0.0), 6),
                labels={"program": name},
                help="host wall seconds per instrumented program (the "
                     "enqueue on the card)")
        peak = peak_tflops()
        for name, value in flops.items():
            registry.set("veles_program_flops", value,
                         labels={"program": name},
                         help="analytic FLOPs of the program's latest "
                              "call, counted from its shapes")
            ema = step_ema.get(name)
            if ema:
                fps = value / ema
                registry.set(
                    "veles_program_flops_per_second", fps,
                    labels={"program": name},
                    help="program FLOPs over the measured step-time EMA")
                if peak:
                    registry.set(
                        "veles_mfu_ratio", fps / (peak * 1e12),
                        labels={"program": name},
                        help="model FLOPs utilization vs the device "
                             "bf16 peak")


_tracker = CompileTracker(enabled=False)


def get_compile_tracker():
    return _tracker


#: set while an instrumented program runs on this thread: a program
#: called from inside another (slot_step inside slot_step_many) is part
#: of its caller, as it is inside a jitted program in the JAX package
_inside = threading.local()


def instrument(name, fn):
    """Wrap a program so its calls book into the process tracker under
    ``name`` (stamped as ``program_name``). A disabled tracker's wrapper
    delegates after one attribute check."""
    tracker = get_compile_tracker()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not tracker.enabled or getattr(_inside, "active", False):
            return fn(*args, **kwargs)
        _inside.active = True
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
        finally:
            _inside.active = False
        tracker.record_call(name, time.perf_counter() - t0)
        return out

    wrapper.program_name = name
    return wrapper


# -- device gauges ----------------------------------------------------------

#: owner -> callable giving the bytes of the tensors it holds (weakly
#: keyed: an owner that goes away drops out)
_owners = weakref.WeakKeyDictionary()


def track_owner(owner, nbytes):
    """Count ``nbytes(owner)`` into the live-bytes fallback of
    :func:`publish_device_stats` while ``owner`` lives."""
    _owners[owner] = nbytes


def _live_owner_bytes():
    """The bytes the tracked owners hold (the fallback without a
    card)."""
    total = 0
    for owner, nbytes in list(_owners.items()):
        try:
            total += int(nbytes(owner))
        except Exception:   # noqa: BLE001 - a half-built owner counts 0
            continue
    return total


def _sample_device_memory():
    """``{device: stats}``: per initialised CUDA device its allocator's
    counters, else ``{"cpu": {"live_bytes": n}}``. ONE copy of the
    sampling for the gauges and the summary."""
    if not torch.cuda.is_initialized():
        return {"cpu": {"live_bytes": _live_owner_bytes()}}
    out = {}
    for index in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(index)
        _, total = torch.cuda.mem_get_info(index)
        out[str(index)] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "bytes_limit": int(total)}
    return out


def publish_device_stats(registry):
    """Per-device memory gauges and the bf16 peak, at scrape time."""
    for dev_id, stats in _sample_device_memory().items():
        for kind, value in stats.items():
            registry.set(
                "veles_device_memory_bytes", value,
                labels={"device": dev_id, "kind": kind},
                help="device allocator stats per local device")
        if stats.get("bytes_limit"):
            registry.set(
                "veles_device_memory_limit_bytes", stats["bytes_limit"],
                labels={"device": dev_id},
                help="device allocator byte budget per local device")
    peak = peak_tflops()
    if peak:
        registry.set("veles_device_peak_bf16_tflops", peak,
                     help="published bf16 peak of the bench device")
    # the active mesh shape (parallel/mesh.py): which layout this process
    # computes under, scraped beside the memory gauges
    from veles_tpu_torch.parallel.mesh import active_mesh_info
    mesh = active_mesh_info()
    if mesh:
        for axis, size in mesh["axes"].items():
            registry.set("veles_mesh_axis_size", size,
                         labels={"axis": axis},
                         help="active device-mesh axis sizes")
        registry.set("veles_mesh_devices", mesh["devices"],
                     help="devices spanned by the active mesh")


def publish_xla_stats(registry):
    """The device-truth collector: build, load and call counters, FLOPs
    and MFU, the memory and mesh gauges, the data-parallel reduce plane
    (``parallel/mapreduce.py``: reduce steps and bytes per precision tier
    and the idle-fraction gauge) and memscope's per-owner attribution
    (``observe/memscope.py``) and the AOT bundles' hits, misses and
    loads (``aot/loader.publish_aot_stats``, ``xla_stats.py:473-483``)."""
    get_compile_tracker().publish(registry)
    publish_device_stats(registry)
    from veles_tpu_torch.parallel.mapreduce import publish_reduce_stats
    publish_reduce_stats(registry)
    from veles_tpu_torch.observe.memscope import publish_memscope
    publish_memscope(registry)
    from veles_tpu_torch.aot.loader import publish_aot_stats
    publish_aot_stats(registry)


def ensure_registered(registry=None):
    """Idempotently attach the device-truth collector to ``registry``
    (default: the process-global one) and enable the tracker — called by
    every ``/metrics`` mount (``core/httpd.py``), so processes that never
    serve HTTP keep the disabled fast path."""
    from veles_tpu_torch.observe.metrics import get_metrics_registry

    if registry is None:
        registry = get_metrics_registry()
    tracker = get_compile_tracker()
    tracker.enabled = True
    collector = getattr(registry, "_xla_stats_collector", None)
    if collector is None:
        def collector():
            publish_xla_stats(registry)
        registry._xla_stats_collector = collector
    # registry.reset() (test isolation) clears collectors, so membership
    # is re-checked per mount rather than remembered
    if collector not in registry._collectors:
        registry.add_collector(collector)
    return registry


def device_summary():
    """One compact dict for the web-status dashboard: memory per device,
    build totals, storms, the active mesh's label, the best live MFU."""
    from veles_tpu_torch.parallel.mesh import mesh_shape_label
    snap = get_compile_tracker().snapshot()
    memory = {}
    for dev_id, stats in _sample_device_memory().items():
        if stats.get("bytes_in_use") is not None:
            memory[dev_id] = {
                "bytes_in_use": stats.get("bytes_in_use"),
                "bytes_limit": stats.get("bytes_limit")}
    mfu = None
    for entry in snap["mfu"].values():
        ratio = entry.get("mfu")
        if ratio is not None and (mfu is None or ratio > mfu):
            mfu = ratio
    return {"memory": memory,
            "compiles": sum(snap["compiles"].values()),
            "compile_seconds": round(
                sum(snap["compile_seconds"].values()), 3),
            "storms": sum(snap["storms"].values()),
            "mesh": mesh_shape_label(),
            "mfu": round(mfu, 4) if mfu is not None else None}


def format_device_stats(device):
    """A ``device_summary()`` dict as one dashboard table cell (the
    device twin of ``web_status.format_serving_health``); empty for
    masters that report none. ``compiles`` counts kernel builds here."""
    if not isinstance(device, dict):
        return ""
    parts = []
    memory = device.get("memory")
    if isinstance(memory, dict) and memory:
        used = sum(m.get("bytes_in_use") or 0 for m in memory.values()
                   if isinstance(m, dict))
        limit = sum(m.get("bytes_limit") or 0 for m in memory.values()
                    if isinstance(m, dict))
        if limit:
            parts.append("hbm %.1f/%.1f GiB"
                         % (used / 2 ** 30, limit / 2 ** 30))
        elif used:
            parts.append("hbm %.1f GiB" % (used / 2 ** 30))
    mesh = device.get("mesh")
    if mesh:
        parts.append("mesh %s" % mesh)
    compiles = device.get("compiles")
    if compiles:
        parts.append("%d compiles (%.1fs)"
                     % (compiles, device.get("compile_seconds") or 0.0))
    storms = device.get("storms")
    if storms:
        parts.append("%d RECOMPILE STORMS" % storms)
    mfu = device.get("mfu")
    if mfu is not None:
        parts.append("mfu %.2f" % mfu)
    return " · ".join(parts)

