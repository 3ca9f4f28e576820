"""Train <-> serve resharding over the world: collective schedules.

The port of ``veles_tpu/parallel/reshard.py``. One checkpoint has two
natural layouts: the fused train step wants the parameters whole on
every rank (its gradients merge over ``data``), the tensor-parallel
serving engine wants them split over ``model`` by heads, FFN columns and
vocabulary (``decode.slot_param_specs``). Any change of
:class:`~veles_tpu_torch.parallel.mesh.PartitionSpec` decomposes into a
short schedule of portable collectives (arxiv 2112.01075), planned
exactly as the JAX package plans it:

- a mesh axis that moves BETWEEN tensor dims (``P(None, "model")`` to
  ``P("model", None)``) is one all-to-all: each rank keeps ``1/n`` of its
  shard and exchanges the rest, never holding the whole tensor;
- an axis only in the SOURCE spec is an all-gather along its dim;
- an axis only in the DESTINATION spec is a local slice at the rank's
  index on the axis (zero bytes on the wire).

The JAX package runs one SPMD program whose arrays carry their sharding.
The port's mesh is a ``torch.distributed`` world, one process per device
(``parallel/mesh.py``): a tree here is THIS rank's local shards, every
rank of the world calls :func:`reshard` with its own shards and the same
specs, and the steps run as ``torch.distributed`` collectives over each
axis's group (``Mesh.axis_group``). A tensor carries no sharding, so
``src_specs=None`` means whole (replicated) leaves: a host checkpoint.
Values are moved, never computed, so a round trip is bit-exact. Every
call books ``veles_reshard_bytes_total`` and ``veles_reshard_seconds``
under its ``label``.
"""

import time

import numpy
import torch

from veles_tpu_torch.device import tree_leaves_with_path, tree_rebuild
from veles_tpu_torch.parallel.mesh import PartitionSpec

#: reshard-latency histogram buckets (seconds), the JAX package's
RESHARD_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _axis_dims(spec, ndim):
    """{mesh axis name: tensor dim} of a spec (tuple entries, several
    axes sharding one dim, map each axis to that dim)."""
    out = {}
    for dim, entry in enumerate(tuple(spec)[:ndim]):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            out[name] = dim
    return out


def _normalize_spec(spec):
    """Canonical spec: unsharded entries become None and trailing Nones
    are stripped, so specs that spell one layout differently
    (``P("model")`` and ``P("model", None)``, ``P()`` and ``P(None)``, a
    1-tuple entry and the bare name) compare equal."""
    if spec is None:
        return PartitionSpec()
    entries = []
    for entry in tuple(spec):
        if isinstance(entry, tuple):
            entry = entry[0] if len(entry) == 1 else (entry or None)
        entries.append(entry)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def _divisible(shape, spec, sizes):
    for dim, entry in enumerate(tuple(spec)[:len(shape)]):
        if entry is None:
            continue
        total = 1
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            total *= sizes[name]
        if shape[dim] % total:
            return False
    return True


def _dim_entries(spec, ndim):
    """Per-dim tuple of sharding axes (major to minor), length ndim."""
    out = []
    entries = tuple(spec)[:ndim]
    for dim in range(ndim):
        entry = entries[dim] if dim < len(entries) else None
        if entry is None:
            out.append(())
        elif isinstance(entry, tuple):
            out.append(tuple(entry))
        else:
            out.append((entry,))
    return out


class LeafPlan:
    """The collective schedule for ONE tensor's spec change, the JAX
    package's op for op (``veles_tpu/parallel/reshard.py:99-239``).

    ``steps`` is a list of ``(kind, axis, src_dim, dst_dim)`` with kind
    in ``all_to_all`` / ``all_gather`` / ``slice`` / ``keep``. An axis
    moving between dims rides ONE all-to-all when the move is clean (the
    axis alone on its source and destination dim, the destination dim
    unsharded in the source); any other change lowers to gathers (per
    dim, minor axis first) then slices (major axis first). ``bytes`` is
    the total crossing the interconnect, summed over the mesh's devices
    (all-to-all: ``(n-1)/n`` of each device's shard; all-gather: ``n-1``
    shards received a device; slice and keep: zero)."""

    __slots__ = ("shape", "dtype", "src", "dst", "steps", "bytes")

    def __init__(self, shape, dtype, itemsize, src, dst, sizes, n_devices):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.src = src
        self.dst = dst
        self.steps = []
        self.bytes = 0
        nbytes = int(numpy.prod(shape, dtype=numpy.int64)
                     * itemsize) if shape else itemsize
        if src == dst:
            self.steps.append(("keep", None, None, None))
            return
        for name, spec in (("source", src), ("destination", dst)):
            if not _divisible(shape, spec, sizes):
                raise ValueError(
                    "reshard: shape %s cannot shard as %s spec %s — "
                    "every sharded dim must divide by its mesh axis "
                    "size(s) %s" % (list(shape), name, spec,
                                    dict(sizes)))
        ndim = len(shape)
        s_dims = _dim_entries(src, ndim)
        d_dims = _dim_entries(dst, ndim)
        s = _axis_dims(src, ndim)
        d = _axis_dims(dst, ndim)
        live = {ax: sizes[ax] for ax in s}

        def local_bytes():
            return nbytes // int(numpy.prod(
                list(live.values()) or [1], dtype=numpy.int64))

        a2a = []
        for ax in sorted(set(s) & set(d)):
            if s[ax] == d[ax]:
                continue
            if (s_dims[s[ax]] == (ax,) and d_dims[d[ax]] == (ax,)
                    and not s_dims[d[ax]]):
                n = sizes[ax]
                self.bytes += n_devices * local_bytes() * (n - 1) // n
                self.steps.append(("all_to_all", ax, s[ax], d[ax]))
                a2a.append(ax)
        gathers, slices = [], []
        for dim in range(ndim):
            leaving = tuple(ax for ax in s_dims[dim]
                            if ax not in a2a
                            and (ax not in d or d[ax] != dim))
            arriving = tuple(ax for ax in d_dims[dim]
                             if ax not in a2a
                             and (ax not in s or s[ax] != dim))
            if not leaving and not arriving:
                continue
            src_stay = tuple(ax for ax in s_dims[dim]
                             if ax not in leaving and ax not in a2a)
            dst_stay = tuple(ax for ax in d_dims[dim]
                             if ax not in arriving and ax not in a2a)
            suffix_ok = (
                src_stay == dst_stay
                and s_dims[dim][:len(src_stay)] == src_stay
                and d_dims[dim][:len(dst_stay)] == dst_stay)
            if suffix_ok:
                gathers.append((dim, leaving))
                slices.append((dim, arriving))
            else:
                gathers.append((dim, tuple(
                    ax for ax in s_dims[dim] if ax not in a2a)))
                slices.append((dim, tuple(
                    ax for ax in d_dims[dim] if ax not in a2a)))
        for dim, leaving in gathers:
            for ax in reversed(leaving):
                n = sizes[ax]
                self.bytes += n_devices * local_bytes() * (n - 1)
                self.steps.append(("all_gather", ax, dim, None))
                del live[ax]
        for dim, arriving in slices:
            for ax in arriving:
                self.steps.append(("slice", ax, None, dim))
        if not self.steps:
            self.steps.append(("keep", None, None, None))

    def describe(self):
        return {"shape": list(self.shape), "dtype": self.dtype,
                "src": str(self.src), "dst": str(self.dst),
                "bytes": self.bytes,
                "steps": [{"op": op, "axis": ax,
                           "src_dim": sd, "dst_dim": dd}
                          for op, ax, sd, dd in self.steps]}


class ReshardPlan:
    """The whole tree's transition: one :class:`LeafPlan` a leaf in
    flatten order, the total wire bytes, and the tally of step kinds."""

    def __init__(self, leaves):
        self.leaves = leaves
        self.bytes = sum(leaf.bytes for leaf in leaves)

    def counts(self):
        out = {}
        for leaf in self.leaves:
            for op, *_ in leaf.steps:
                out[op] = out.get(op, 0) + 1
        return out

    def describe(self):
        return {"bytes": self.bytes, "counts": self.counts(),
                "leaves": [leaf.describe() for leaf in self.leaves]}


def _is_spec(node):
    return node is None or isinstance(node, PartitionSpec)


def _spec_list(specs, tree):
    """One normalized spec a leaf of ``tree`` (in flatten order):
    ``specs`` is a matching tree of specs, or one spec that every leaf
    below it takes."""
    out = []
    for path, _ in tree_leaves_with_path(tree):
        node = specs
        for key in path:
            if _is_spec(node):
                break
            node = node[key]
        out.append(_normalize_spec(node))
    return out


def _leaf_meta(leaf):
    """``(shape, dtype name, itemsize)`` of a tensor leaf."""
    return (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""),
            leaf.element_size())


def _global_shape(shape, spec, sizes):
    """The whole tensor's shape from a local shard's under ``spec``."""
    shape = list(shape)
    for dim, entry in enumerate(tuple(spec)[:len(shape)]):
        for name in (() if entry is None else
                     entry if isinstance(entry, tuple) else (entry,)):
            shape[dim] *= sizes[name]
    return tuple(shape)


def _build_plan(leaves, src_list, dst_list, mesh, local=False):
    """The plan of moving ``leaves`` from ``src_list`` to ``dst_list``;
    with ``local`` the leaves are this rank's shards under their source
    specs (the plan is of the whole tensors)."""
    sizes = dict(mesh.shape)
    plans = []
    for leaf, src, dst in zip(leaves, src_list, dst_list):
        shape, dtype, itemsize = _leaf_meta(leaf)
        if local:
            shape = _global_shape(shape, src, sizes)
        plans.append(LeafPlan(shape, dtype, itemsize, src, dst, sizes,
                              mesh.size))
    return ReshardPlan(plans)


def plan_reshard(tree, mesh, dst_specs, src_specs, local=False):
    """The :class:`ReshardPlan` of moving the WHOLE tensors of ``tree``
    from ``src_specs`` to ``dst_specs`` over ``mesh`` (specs: a matching
    tree of :class:`PartitionSpec`, or one spec for every leaf); with
    ``local`` the leaves are this rank's shards under ``src_specs``."""
    leaves = [leaf for _, leaf in tree_leaves_with_path(tree)]
    return _build_plan(leaves, _spec_list(src_specs, tree),
                       _spec_list(dst_specs, tree), mesh, local=local)


def _all_gather(x, group, n, dim):
    parts = [torch.empty_like(x) for _ in range(n)]
    torch.distributed.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _all_to_all(x, group, n, src_dim, dst_dim):
    """The tiled all-to-all: split ``x`` into ``n`` blocks along
    ``dst_dim``, send block j to the axis's rank j, and concatenate what
    arrives along ``src_dim`` in axis order."""
    blocks = torch.stack(torch.chunk(x, n, dim=dst_dim)).contiguous()
    out = torch.empty_like(blocks)
    torch.distributed.all_to_all_single(out, blocks, group=group)
    return torch.cat(list(out.unbind(0)), dim=src_dim)


def apply_plan(x, plan, mesh):
    """One rank's side of a leaf's schedule: ``x`` is this rank's shard
    under ``plan.src``; returns its shard under ``plan.dst``,
    contiguous. A slice needs no world; a gather or an all-to-all runs
    over the axis's group."""
    sizes = dict(mesh.shape)
    for kind, ax, src_dim, dst_dim in plan.steps:
        if kind == "slice":
            chunk = x.shape[dst_dim] // sizes[ax]
            x = x.narrow(dst_dim, mesh.axis_index(ax) * chunk, chunk)
        elif kind in ("all_gather", "all_to_all"):
            group = mesh.axis_group(ax)
            if group is None:
                raise RuntimeError(
                    "reshard: a %s over axis %r needs the mesh's world "
                    "(parallel/mesh.initialize_distributed)" % (kind, ax))
            x = x.contiguous()
            if kind == "all_gather":
                x = _all_gather(x, group, sizes[ax], src_dim)
            else:
                x = _all_to_all(x, group, sizes[ax], src_dim, dst_dim)
    return x.contiguous()


def reshard(tree, mesh, dst_specs, src_specs=None, label="reshard",
            registry=None):
    """Move ``tree`` (this rank's local shards) from ``src_specs`` to
    ``dst_specs`` by the collective schedule; returns ``(new_tree,
    stats)``. Every rank of the mesh's world calls it with the same
    specs. ``src_specs=None``: the leaves are whole (a host checkpoint),
    so a sharded destination is slice-only. ``stats``: ``{"bytes",
    "seconds", "counts"}``, also booked as ``veles_reshard_bytes_total``
    and ``veles_reshard_seconds`` labelled by ``label``. Every step is a
    data movement, so a round trip returns the values exactly."""
    leaves = [leaf for _, leaf in tree_leaves_with_path(tree)]
    src_list = _spec_list(src_specs, tree)
    dst_list = _spec_list(dst_specs, tree)
    plan = _build_plan(leaves, src_list, dst_list, mesh, local=True)
    t0 = time.perf_counter()
    moved = [apply_plan(leaf, leaf_plan, mesh)
             for leaf, leaf_plan in zip(leaves, plan.leaves)]
    for leaf in moved:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            break
    seconds = time.perf_counter() - t0
    out = tree_rebuild(tree, iter(moved))
    stats = {"bytes": plan.bytes, "seconds": seconds,
             "counts": plan.counts()}
    if registry is None:
        from veles_tpu_torch.observe.metrics import get_metrics_registry
        registry = get_metrics_registry()
    registry.incr("veles_reshard_bytes_total", plan.bytes,
                  labels={"transition": label},
                  help="interconnect bytes moved by reshard() schedules")
    registry.observe("veles_reshard_seconds", seconds,
                     labels={"transition": label},
                     buckets=RESHARD_BUCKETS,
                     help="wall seconds per reshard() transition")
    return out, stats


def naive_reshard(tree, mesh, dst_specs):
    """The baseline formulation :func:`reshard` replaces: gather every
    leaf whole on every rank (from ``dst``'s point of view, the leaves
    arrive whole), then slice this rank's shard. ``tree`` holds whole
    leaves; returns ``(new_tree, seconds)``."""
    leaves = [leaf for _, leaf in tree_leaves_with_path(tree)]
    dst_list = _spec_list(dst_specs, tree)
    plan = _build_plan(leaves, [PartitionSpec()] * len(leaves), dst_list,
                       mesh)
    t0 = time.perf_counter()
    moved = []
    for leaf, leaf_plan in zip(leaves, plan.leaves):
        if mesh.group is not None:
            leaf = leaf.contiguous().clone()
            torch.distributed.broadcast(leaf, src=0, group=mesh.group)
        moved.append(apply_plan(leaf, leaf_plan, mesh))
    return tree_rebuild(tree, iter(moved)), time.perf_counter() - t0
