"""Logical device mesh over ``torch.distributed``.

The port of ``veles_tpu/parallel/mesh.py``. Axes, sized from
``root.common.mesh.axes`` (-1 absorbs the remaining devices):

- ``data``  — batch (data parallel): each rank takes its rows of the
  minibatch and the gradients merge by ``parallel/mapreduce.reduce_sum``;
- ``model`` — tensor parallelism: the sharded serving engine
  (``parallel/tp_engine.py``, ``serving.build_serve_mesh``) splits every
  block's heads, FFN columns and the vocab head over it,
  and the model-axis train step (``parallel/step.py``) splits every
  layer's columns over it;
- ``seq``, ``pipe``, ``expert`` — sequence (``parallel/
  transformer_step.py``, ring and Ulysses attention), pipeline
  (``parallel/pipeline.py``) and expert (``parallel/expert.py``)
  parallelism, their collectives in ``parallel/collectives.py``.

:func:`build_mesh` builds any axes whose sizes multiply to the world's
size. A workflow, the fused tick and a fleet pod slave shard over the
``data`` axis alone and replicate the step over every other axis, as
the JAX package's ``shard_map`` over ``data`` does.

The JAX package's mesh is one SPMD process over every device. The port's
is a ``torch.distributed`` world, one process per device: the mesh's
devices are the world's ranks, laid out in :data:`AXIS_ORDER` like
``numpy.arange(world).reshape(sizes)``, and a rank's coordinate on an
axis is its index there (for a data-only mesh, its rank). A multi-rank
mesh needs the process group first: :func:`initialize_distributed`
(``--coordinator``, ``--num-processes``, ``--process-id``), NCCL for a
card and gloo for ``device="cpu"``, or the backend the caller or
``root.common.mesh.backend`` names.
"""

import datetime
import threading

import numpy
import torch

from veles_tpu_torch.core.config import root

AXIS_ORDER = ("pipe", "data", "expert", "seq", "model")

#: seconds a rank waits in the rendezvous or a collective before it fails
#: (``root.common.mesh.timeout`` overrides it): a rank whose peer died
#: must not wait out gloo's 30-minute default; a fleet pod's follower
#: waits this long at most for rank 0's next event (``fleet/pod.py``)
DEFAULT_TIMEOUT = 300.0


def _distributed():
    """True when this process has joined a ``torch.distributed`` world."""
    return torch.distributed.is_available() \
        and torch.distributed.is_initialized()


def mesh_axes():
    cfg = root.common.mesh.axes
    if hasattr(cfg, "__content__"):
        cfg = cfg.__content__()
    return {name: int(cfg.get(name, 1)) for name in AXIS_ORDER}


def mesh_configured():
    """True when the config asks for a non-trivial mesh (any axis != 1,
    a -1 wildcard included): ``--mesh data=2`` or
    ``root.common.mesh.axes`` sets it, and the launcher then builds the
    mesh into the workflow."""
    return any(v != 1 for v in mesh_axes().values())


def initialize_distributed(coordinator, num_processes, process_id,
                           device="cuda", backend=None, timeout=None):
    """Join the world of ``num_processes`` processes as rank
    ``process_id``, the rendezvous at ``coordinator`` (``HOST:PORT``,
    served by rank 0): ``torch.distributed.init_process_group`` over
    ``backend`` (default: ``root.common.mesh.backend``, else NCCL for a
    card and gloo for ``device="cpu"``). On a card the process takes
    device ``process_id`` modulo the host's device count (one process
    per device). NCCL takes one rank per device; ranks that share a card
    name gloo, which then moves CUDA tensors itself. ``timeout``
    (seconds; default ``root.common.mesh.timeout``, else
    :data:`DEFAULT_TIMEOUT`) bounds the rendezvous and every
    collective."""
    kind = torch.device(device).type
    if backend is None:
        backend = root.common.mesh.get("backend") \
            or ("nccl" if kind == "cuda" else "gloo")
    if kind == "cuda":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    if timeout is None:
        timeout = root.common.mesh.get("timeout") or DEFAULT_TIMEOUT
    torch.distributed.init_process_group(
        backend, init_method="tcp://%s" % coordinator,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout)))


def finalize_distributed():
    """Leave the world :func:`initialize_distributed` joined (a no-op
    outside one)."""
    if _distributed():
        torch.distributed.destroy_process_group()


def is_primary():
    """True on the process that owns the singleton side effects
    (snapshots, plots, web status, result files): rank 0 of the world,
    or the only process."""
    return not _distributed() or torch.distributed.get_rank() == 0


def axis_size(axis_name="data", group=None):
    """The size of a mesh axis as the collectives see it: the world size
    of ``group`` (default: the whole world), 1 outside a world."""
    if not _distributed():
        return 1
    return torch.distributed.get_world_size(group)


def parse_axes(spec, flag="--mesh"):
    """Parse an ``AXIS=N[,AXIS=N...]`` mesh string into an override
    dict — ONE parser for ``--mesh`` and ``--serve-mesh``. Raises
    ``ValueError`` naming ``flag``; :func:`build_mesh` owns the size
    checks."""
    overrides = {}
    for part in str(spec).split(","):
        axis, eq, size = part.partition("=")
        axis = axis.strip()
        if not eq or axis not in AXIS_ORDER:
            raise ValueError(
                "%s expects AXIS=N[,AXIS=N...] with axes from %s, "
                "got %r" % (flag, ", ".join(AXIS_ORDER), spec))
        try:
            overrides[axis] = int(size)
        except ValueError:
            raise ValueError("%s: size %r of axis %s is not an integer"
                             % (flag, size, axis))
    return overrides


class PartitionSpec(tuple):
    """How a tensor lies over a mesh: one entry a dimension, the mesh
    axis that shards it (a name, a tuple of names for a dimension sharded
    by several axes, major first) or None where it is whole; missing
    trailing entries are None. The port's counterpart of
    ``jax.sharding.PartitionSpec``, printed as that is."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "PartitionSpec(%s)" % ", ".join(repr(e) for e in self)

    __str__ = __repr__


class Mesh:
    """A device mesh over the world: ``shape`` maps each axis of
    :data:`AXIS_ORDER` to its size (as the JAX mesh's ``shape``),
    ``devices`` holds the ranks in that layout, ``rank`` is this
    process's, ``group`` the process group the collectives run on
    (None outside a world)."""

    def __init__(self, shape, rank=0, group=None):
        self.shape = {name: int(shape.get(name, 1)) for name in AXIS_ORDER}
        self.axis_names = AXIS_ORDER
        self.rank = int(rank)
        self.group = group

    @property
    def size(self):
        return int(numpy.prod(list(self.shape.values())))

    @property
    def devices(self):
        return numpy.arange(self.size).reshape(tuple(self.shape.values()))

    def axis_index(self, axis_name):
        """This process's coordinate along ``axis_name``."""
        coords = numpy.unravel_index(self.rank, tuple(self.shape.values()))
        return int(coords[AXIS_ORDER.index(axis_name)])

    def axis_group(self, axis_name):
        """The process group of this rank's line along ``axis_name``: the
        ranks whose coordinates differ on that axis alone, in axis order
        (the world's group when the axis spans the world; None outside a
        world). Every rank of the world must ask for the same axes in the
        same order: ``torch.distributed.new_group`` is collective."""
        if self.group is None:
            return None
        if self.shape[axis_name] == self.size:
            return self.group
        groups = self.__dict__.setdefault("_axis_groups", {})
        if axis_name not in groups:
            lines = numpy.moveaxis(self.devices,
                                   AXIS_ORDER.index(axis_name), -1)
            for line in lines.reshape(-1, self.shape[axis_name]):
                group = torch.distributed.new_group(
                    [int(r) for r in line])
                if self.rank in line:
                    groups[axis_name] = group
        return groups[axis_name]

    def __repr__(self):
        return "Mesh(%s, rank=%d)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()), self.rank)


def build_mesh(devices=None, flag="root.common.mesh.axes / --mesh",
               **overrides):
    """Build a :class:`Mesh` over ``devices`` (a count or a sequence; by
    default the world's size, 1 outside a world) with the configured
    axis sizes, validated with the JAX package's errors naming ``flag``:
    the sizes multiply to the device count, and a single -1 axis absorbs
    the remainder. Inside a world the mesh must span it."""
    if devices is None:
        n = torch.distributed.get_world_size() if _distributed() else 1
    elif isinstance(devices, int):
        n = devices
    else:
        n = len(devices)
    sizes = mesh_axes()
    for key, value in overrides.items():
        if key not in sizes:
            raise ValueError(
                "unknown mesh axis %r (valid: %s) — check %s"
                % (key, ", ".join(AXIS_ORDER), flag))
        sizes[key] = value
    for key, value in sizes.items():
        try:
            as_int = int(value)
        except (TypeError, ValueError):
            as_int = None
        if as_int is None or as_int != value or (
                as_int < 1 and as_int != -1):
            raise ValueError(
                "mesh axis %s=%r is invalid: sizes must be positive "
                "integers (or -1 to absorb the remaining devices) — "
                "check %s" % (key, value, flag))
        sizes[key] = as_int
    wildcard = [k for k, v in sizes.items() if v == -1]
    fixed = int(numpy.prod([v for v in sizes.values() if v != -1]))
    if len(wildcard) > 1:
        raise ValueError("only one mesh axis may be -1, got %s" % wildcard)
    if wildcard:
        if n % fixed:
            raise ValueError(
                "mesh axes %s: the fixed sizes multiply to %d, which "
                "does not divide the %d available devices — check %s"
                % (sizes, fixed, n, flag))
        sizes[wildcard[0]] = n // fixed
    elif fixed != n:
        raise ValueError(
            "mesh axes %s multiply to %d but %d devices present — "
            "check %s" % (sizes, fixed, n, flag))
    mesh = Mesh(sizes)
    if _distributed():
        world = torch.distributed.get_world_size()
        if world != n:
            raise ValueError("a mesh of %d devices in a world of %d "
                             "processes — check %s" % (n, world, flag))
        mesh.rank = torch.distributed.get_rank()
        mesh.group = torch.distributed.group.WORLD
    note_active_mesh(mesh)
    return mesh


# -- active-mesh registry ----------------------------------------------------
#
# The LAST mesh built in this process, kept as plain data: the /metrics
# mesh gauges and the web-status device column read it.

_active_lock = threading.Lock()
_active_mesh = None


def note_active_mesh(mesh):
    """Record ``mesh`` as the process's active mesh (called by
    :func:`build_mesh`)."""
    global _active_mesh
    info = {"axes": {name: int(size)
                     for name, size in dict(mesh.shape).items()},
            "devices": int(mesh.size)}
    with _active_lock:
        _active_mesh = info


def active_mesh_info():
    """``{"axes": {name: size}, "devices": n}`` of the last mesh built
    in this process, or None when nothing meshed yet."""
    with _active_lock:
        return None if _active_mesh is None else {
            "axes": dict(_active_mesh["axes"]),
            "devices": _active_mesh["devices"]}


def mesh_shape_label(info=None):
    """Compact ``data2`` string of the non-trivial axes (the label of
    the dashboard's device cell); None when no mesh is active or every
    axis is 1."""
    if info is None:
        info = active_mesh_info()
    if not info:
        return None
    parts = ["%s%d" % (name, size)
             for name in AXIS_ORDER
             for size in [info["axes"].get(name, 1)] if size != 1]
    return ".".join(parts) or None


def mesh_coordinate_labels():
    """``{"process": rank, "mesh": "data2"}`` of this process: merged into
    the metric rows a fleet slave piggybacks on its update frames, so a
    master scrape tells a meshed slave's ranks apart
    (``mesh.py:253-266``). Empty when no mesh is active."""
    label = mesh_shape_label()
    if label is None:
        return {}
    rank = torch.distributed.get_rank() if _distributed() else 0
    return {"process": str(rank), "mesh": label}

