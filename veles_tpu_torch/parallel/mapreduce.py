"""Data-parallel aggregation: the mapreduce primitives over
``torch.distributed``.

The port of ``veles_tpu/parallel/mapreduce.py``. The JAX package runs
``reduce_sum`` / ``reduce_mean`` inside one compiled SPMD program over
the mesh's ``"data"`` axis; here every rank is a process of the
``torch.distributed`` world (``parallel/mesh.py``) and the reduce is a
collective on a process group (default: the whole world), called where
the JAX program called it, between the backward and the update of the
fused tick (``parallel/fused.py``).

Reduce precision tiers (``root.common.fleet.reduce``):

- ``f32`` (default) — an ``all_reduce`` sum. The leaves of one dtype
  travel as one flat buffer, so a gradient tree costs one collective;
- ``bf16`` — float leaves cast to bfloat16 for the wire, summed by the
  collective, widened back: half the bytes of f32;
- ``int8`` — the two-stage quantized all-reduce with per-leaf scales: a
  global per-leaf scale (the ``all_reduce(MAX)`` of the local amax)
  quantizes the leaf to int8, an ``all_to_all_single`` exchanges chunk
  shards, each rank sums its chunk exactly in int32, and a second
  global-scale int8 ``all_gather`` replicates the result. Its codes,
  scales and results are the JAX package's bit for bit: the same f32
  operations on the same bytes.

Non-float leaves (error counts, confusion increments) always take the
exact sum. Byte accounting follows the JAX package's convention (total
bytes on the wire across all devices): a ring all-reduce of an
``E``-element tensor moves ``2*(n-1)*E*itemsize`` bytes; the int8 tier
moves ``(n-1)*E`` (all_to_all) + ``(n-1)*E`` (all_gather) int8 bytes
plus two scalar rounds per leaf.

Observability: :func:`fleet_train_step` instruments the tick's steps
under ``observe/xla_stats`` (programs ``mapreduce.fleet_*``) and books
wire bytes and the step cadence into :class:`ReduceStats`, published on
every ``/metrics`` mount as ``veles_fleet_reduce_steps_total``,
``veles_fleet_reduce_bytes_total``, ``veles_fleet_reduce_seconds`` and
``veles_fleet_chip_idle_fraction``.
"""

import threading
import time

import numpy
import torch
from torch import distributed as dist

#: valid gradient-reduce precisions
REDUCE_PRECISIONS = ("f32", "bf16", "int8")

#: int8 quantization range (symmetric)
_Q_MAX = 127.0

#: a gap this long between steps re-arms the idle-fraction window (a
#: training lull is not booked as idleness)
CADENCE_RESET = 60.0


def reduce_precision_of(value=None):
    """Validate/resolve the configured reduce tier
    (``root.common.fleet.reduce``); raises naming the knob."""
    if value is None:
        from veles_tpu_torch.core.config import root
        value = root.common.fleet.get("reduce", "f32")
    if value not in REDUCE_PRECISIONS:
        raise ValueError(
            "root.common.fleet.reduce / --fleet-reduce must be one of "
            "%s, got %r" % ("/".join(REDUCE_PRECISIONS), value))
    return value


# -- trees ------------------------------------------------------------------

def _flatten(tree):
    """The tensor leaves of a tree of dicts, lists and tuples, in order,
    and a function that rebuilds the tree from new leaves."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[key]) for key in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(value) for value in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    leaves = [leaf for part, _ in parts for leaf in part]
    counts = [len(part) for part, _ in parts]

    def rebuild(new):
        out, at = [], 0
        for (_, sub), count in zip(parts, counts):
            out.append(sub(new[at:at + count]))
            at += count
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)
    return leaves, rebuild


def _tree_map(fn, tree):
    leaves, rebuild = _flatten(tree)
    return rebuild([fn(leaf) for leaf in leaves])


# -- primitives ---------------------------------------------------------------

def broadcast(tree):
    """DrJAX ``broadcast``: place a host value on every shard. Every rank
    holds the replicated value already, so this is the identity — kept
    so that step code reads as mapreduce."""
    return tree


def _all_reduce_flat(leaves, group, wire_dtype=None):
    """Sum ``leaves`` over ``group``: the leaves of one dtype and device
    as one flat buffer (cast to ``wire_dtype`` for the wire when given,
    widened back), one collective per buffer. Returns new tensors; the
    inputs are untouched."""
    out = [None] * len(leaves)
    buckets = {}
    for i, leaf in enumerate(leaves):
        buckets.setdefault((leaf.dtype, leaf.device), []).append(i)
    for (dtype, _), members in buckets.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in members])
        if wire_dtype is not None:
            flat = flat.to(wire_dtype)
        dist.all_reduce(flat, group=group)
        at = 0
        for i in members:
            size = leaves[i].numel()
            out[i] = flat[at:at + size].to(dtype).reshape(leaves[i].shape)
            at += size
    return out


def _scale_of(x, group):
    """The global per-leaf scale: the ``all_reduce(MAX)`` of the local
    amax over ``_Q_MAX``, never below 1e-30 / ``_Q_MAX``."""
    amax = x.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return torch.clamp(amax, min=1e-30) / _Q_MAX


def _quantize(x, scale):
    return torch.clamp(torch.round(x / scale), -_Q_MAX, _Q_MAX) \
        .to(torch.int8)


def _int8_allreduce_leaf(x, group):
    """Two-stage quantized all-reduce of one leaf (module docstring):
    exact int32 accumulation between the two rounding stages; both
    scales are global, so every rank computes identical bytes."""
    n = dist.get_world_size(group)
    flat = x.to(torch.float32).reshape(-1)
    size = flat.numel()
    pad = (-size) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    scale = _scale_of(flat, group)
    chunks = _quantize(flat, scale).reshape(n, -1)
    peers = torch.empty_like(chunks)
    try:
        # rank i ends with every peer's chunk i: (n, chunk) int8
        dist.all_to_all_single(peers, chunks, group=group)
    except RuntimeError as exc:
        raise NotImplementedError(
            "the int8 reduce tier needs all_to_all_single, which backend "
            "%s refused for %s tensors: %s"
            % (dist.get_backend(group), x.device.type, exc)) from exc
    reduced = peers.to(torch.int32).sum(dim=0).to(torch.float32) * scale
    scale2 = _scale_of(reduced, group)
    gathered = torch.empty(n * reduced.numel(), dtype=torch.int8,
                           device=x.device)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(gathered, _quantize(reduced, scale2), group=group)
    out = gathered.to(torch.float32) * scale2
    if pad:
        out = out[:size]
    return out.reshape(x.shape).to(x.dtype)


def reduce_sum(tree, axis="data", precision="f32", group=None):
    """All-reduce-sum of ``tree``'s tensor leaves over the ``axis`` of
    the mesh, the process group ``group`` (default: the whole world).
    ``precision`` selects the wire tier (module docstring); non-float
    leaves always take the exact sum. Returns a new tree; every rank
    gets the same values."""
    if precision not in REDUCE_PRECISIONS:
        raise ValueError("reduce precision must be one of %s, got %r"
                         % ("/".join(REDUCE_PRECISIONS), precision))
    leaves, rebuild = _flatten(tree)
    floats = [i for i, leaf in enumerate(leaves)
              if leaf.is_floating_point() and precision != "f32"]
    exact = [i for i in range(len(leaves)) if i not in floats]
    out = list(leaves)
    for i, value in zip(exact, _all_reduce_flat(
            [leaves[i] for i in exact], group)):
        out[i] = value
    if precision == "bf16":
        for i, value in zip(floats, _all_reduce_flat(
                [leaves[i] for i in floats], group,
                wire_dtype=torch.bfloat16)):
            out[i] = value
    elif precision == "int8":
        for i in floats:
            out[i] = _int8_allreduce_leaf(leaves[i], group)
    return rebuild(out)


def reduce_mean(tree, axis="data", precision="f32", group=None):
    """All-reduce-mean over ``axis`` (sum / the axis size; integer
    leaves floor-divide, as ``//``)."""
    summed = reduce_sum(tree, axis=axis, precision=precision, group=group)
    n = dist.get_world_size(group)
    return _tree_map(
        lambda x: x / n if x.is_floating_point()
        else torch.div(x, n, rounding_mode="floor"), summed)


# -- wire-byte accounting -----------------------------------------------------

def _leaf_layout(leaf):
    """(elements, itemsize, is_float) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel(), leaf.element_size(), leaf.is_floating_point()
    dtype = numpy.dtype(getattr(leaf, "dtype", numpy.float32))
    size = 1
    for dim in getattr(leaf, "shape", ()):
        size *= int(dim)
    return size, dtype.itemsize, numpy.issubdtype(dtype, numpy.floating)


def reduce_wire_bytes(tree, n_devices, precision="f32"):
    """Analytic bytes on the wire (total across all devices) of one
    :func:`reduce_sum` of ``tree`` over ``n_devices`` ranks. Zero when
    nothing crosses the wire (n=1)."""
    n = int(n_devices)
    if n <= 1:
        return 0
    total = 0
    for leaf in _flatten(tree)[0]:
        size, itemsize, is_float = _leaf_layout(leaf)
        if precision == "f32" or not is_float:
            total += 2 * (n - 1) * size * itemsize
        elif precision == "bf16":
            total += 2 * (n - 1) * size * 2
        else:  # int8: a2a + all_gather int8 payloads + 2 scalar maxes
            padded = size + ((-size) % n)
            total += 2 * (n - 1) * padded + 2 * 2 * (n - 1) * 4
    return total


# -- runtime stats (the /metrics plane) ---------------------------------------

class ReduceStats:
    """Per-precision reduce bookkeeping: steps, wire bytes, and the
    host-cadence idle fraction — the share of data-parallel training wall
    time the training loop spends outside the step. Thread-safe; fed by the
    :func:`fleet_train_step` wrappers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tiers = {}          # precision -> {"steps", "bytes"}
        self._busy = 0.0          # seconds inside the step
        self._span_start = None   # cadence window start (monotonic)
        self._last_end = None

    def note(self, precision, wire_bytes=0, busy=0.0, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            tier = self._tiers.setdefault(precision,
                                          {"steps": 0, "bytes": 0})
            tier["steps"] += 1
            tier["bytes"] += int(wire_bytes)
            if self._last_end is None \
                    or now - self._last_end > CADENCE_RESET:
                # a lull re-arms the window: idle between runs is not
                # protocol overhead
                self._span_start = now - busy
                self._busy = 0.0
            self._busy += float(busy)
            self._last_end = now

    def idle_fraction(self):
        with self._lock:
            if self._span_start is None or self._last_end is None:
                return None
            span = self._last_end - self._span_start
            if span <= 0 or self._busy <= 0:
                return None
            return min(max(1.0 - self._busy / span, 0.0), 1.0)

    def snapshot(self):
        with self._lock:
            return {precision: dict(entry)
                    for precision, entry in self._tiers.items()}

    def reset(self):
        with self._lock:
            self._tiers.clear()
            self._busy = 0.0
            self._span_start = None
            self._last_end = None


_stats = ReduceStats()


def get_reduce_stats():
    return _stats


def publish_reduce_stats(registry):
    """Scrape-time re-publication, wired into
    ``observe/xla_stats.publish_xla_stats`` so every ``/metrics`` mount
    carries the reduce plane."""
    snap = _stats.snapshot()
    for precision, entry in snap.items():
        registry.counter_set(
            "veles_fleet_reduce_steps_total", entry["steps"],
            labels={"precision": precision},
            help="data-parallel reduce steps executed")
        registry.counter_set(
            "veles_fleet_reduce_bytes_total", entry["bytes"],
            labels={"precision": precision},
            help="analytic collective wire bytes moved by gradient "
                 "reduces (total across devices)")
    idle = _stats.idle_fraction()
    if idle is not None:
        registry.set(
            "veles_fleet_chip_idle_fraction", round(idle, 4),
            help="share of data-parallel training wall time spent "
                 "outside the step")


# -- the fleet train step -----------------------------------------------------

def _grad_bytes(params, n, precision):
    """Wire bytes of one train-step gradient reduce: the grad tree
    mirrors the per-layer ``"p"`` leaves."""
    grads = [entry.get("p", {}) for entry in params
             if isinstance(entry, dict)]
    return reduce_wire_bytes(grads, n, precision)


def _synchronize(out):
    """Wait for the card to finish the metrics of a step's output."""
    metrics = out[1] if isinstance(out, tuple) and len(out) == 2 else out
    leaves = [leaf for leaf in _flatten(metrics)[0]
              if isinstance(leaf, torch.Tensor) and leaf.is_cuda]
    if leaves:
        torch.cuda.synchronize(leaves[0].device)


def _wrap_step(name, fn, precision, bytes_of, sync_for_stats=False):
    """Instrument one step: calls via ``xla_stats.instrument``, per-call
    wire bytes and busy time into :class:`ReduceStats`, the cadence into
    the MFU tracker and the ``veles_fleet_reduce_seconds`` histogram. A
    disabled tracker costs one attribute check.

    ``sync_for_stats``: wait for the step's metrics before stamping the
    busy window (CUDA launches are asynchronous, so the raw call wall
    would book a card-bound run as idle) — on for the per-minibatch
    steps; the sweeps book steps and bytes only, never busy."""
    from veles_tpu_torch.observe.xla_stats import (get_compile_tracker,
                                                   instrument)

    inst = instrument(name, fn)
    tracker = get_compile_tracker()
    state = {"last": None}

    def call(*args, **kwargs):
        if not tracker.enabled:
            return inst(*args, **kwargs)
        t0 = time.perf_counter()
        out = inst(*args, **kwargs)
        busy = 0.0
        if sync_for_stats:
            _synchronize(out)
            busy = time.perf_counter() - t0
        t1 = time.perf_counter()
        last = state["last"]
        state["last"] = t1
        _stats.note(precision, wire_bytes=bytes_of(args), busy=busy)
        if last is not None and t1 - last <= CADENCE_RESET:
            cadence = t1 - last
            tracker.observe_step(name, cadence)
            from veles_tpu_torch.observe.metrics import get_metrics_registry
            get_metrics_registry().observe(
                "veles_fleet_reduce_seconds", cadence,
                labels={"program": name, "precision": precision},
                help="wall seconds per data-parallel step (the reduce "
                     "runs inside the step)")
        return out

    call.program_name = name
    call.__wrapped__ = fn
    return call


def fleet_train_step(mesh, specs, norm_type="none", with_confusion=True,
                     augment="none", loss_kind="softmax",
                     reduce_precision=None):
    """The data-parallel fused step: ``parallel/fused.build_tick`` over
    ``mesh``'s ``"data"`` axis, the gradients merged by
    :func:`reduce_sum` at ``reduce_precision`` (default: the configured
    ``root.common.fleet.reduce`` tier), instrumented under
    ``observe/xla_stats`` (programs ``mapreduce.fleet_{train,eval}_{step,
    sweep}``). Returns the ``(train_step, eval_step, train_sweep,
    eval_sweep)`` tuple of ``build_tick``."""
    from veles_tpu_torch.parallel import fused

    precision = reduce_precision_of(reduce_precision)
    steps = fused.build_tick(specs, norm_type, mesh=mesh,
                             with_confusion=with_confusion,
                             augment=augment, loss_kind=loss_kind,
                             grad_reduce=precision)
    n = int(mesh.shape.get("data", 1)) if mesh is not None else 1
    train_step, eval_step, train_sweep, eval_sweep = steps

    def train_bytes(args):
        return _grad_bytes(args[0], n, precision)

    def sweep_bytes(args):
        return len(args[5]) * _grad_bytes(args[0], n, precision)

    # eval reduces scalars (+ the confusion increment): book the scalar
    # pair; the tier never compresses ints anyway
    scalar_wire = reduce_wire_bytes(
        (numpy.zeros((), numpy.float32), numpy.zeros((), numpy.int32)),
        n, "f32")

    def metric_bytes(args):
        return scalar_wire

    return (
        _wrap_step("mapreduce.fleet_train_step", train_step, precision,
                   train_bytes, sync_for_stats=True),
        _wrap_step("mapreduce.fleet_eval_step", eval_step, precision,
                   metric_bytes, sync_for_stats=True),
        _wrap_step("mapreduce.fleet_train_sweep", train_sweep,
                   precision, sweep_bytes),
        _wrap_step("mapreduce.fleet_eval_sweep", eval_sweep, precision,
                   metric_bytes),
    )
