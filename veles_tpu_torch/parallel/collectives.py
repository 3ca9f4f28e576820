"""Differentiable collectives over one axis of the mesh.

The JAX package's training paths over the ``seq``, ``pipe``, ``expert``
and ``model`` axes run inside ``shard_map`` on ``lax.ppermute``,
``lax.all_to_all``, ``lax.psum`` and ``lax.all_gather``, and
``jax.grad`` differentiates through them by their transposes. The port's
mesh is a ``torch.distributed`` world, one process per device
(``parallel/mesh.py``), so each of those is a collective over the
process group of this rank's line along the axis (``Mesh.axis_group``),
and the differentiable ones are ``torch.autograd.Function``s whose
backward is the JAX transpose:

- :func:`ppermute` sends each tensor to the rank ``shift`` further along
  the axis and receives from the rank as far behind (every send and
  receive of a call paired in one ``batch_isend_irecv``, so no rank
  blocks in a send while its peer sends); its backward is the reverse
  ``ppermute``;
- :func:`all_to_all` splits one dimension into the axis's blocks, sends
  block j to the axis's rank j and concatenates what arrives along
  another dimension in axis order (``lax.all_to_all``, tiled or not);
  its backward is the inverse ``all_to_all``;
- :func:`psum` is the all-reduce sum; its backward is ``psum`` again, as
  JAX transposes it (a loss replicated over the axis and seeded on every
  rank then gives the axis size times the gradient: the pipeline
  divides by it, as the JAX package does);
- :func:`all_gather` (no backward: the model-axis step's backward is
  explicit) and :func:`psum_flat`, one all-reduce for a list of tensors.

An axis of size 1 is the identity and issues no collective. Ranks that
share one card run gloo, which takes no CUDA tensor for a send, a
receive or an all-to-all: there every collective stages its operands
through host memory explicitly, and its seconds count the copies. No
compute moves to the CPU. Each mesh books every call in
:func:`collective_stats`: calls, operand bytes and wall seconds by op
(a staged call synchronizes the card first, so its seconds are the
copies and the collective, not the work queued before it).
"""

import time

import torch
import torch.distributed as dist


def collective_stats(mesh):
    """``{op: [calls, operand bytes, seconds]}`` of the collectives run
    over ``mesh`` since it was built."""
    return mesh.__dict__.setdefault("_collective_stats", {})


def collective_seconds(mesh):
    """The wall seconds of every collective run over ``mesh``."""
    return sum(row[2] for row in collective_stats(mesh).values())


def axis_size(mesh, axis):
    return int(mesh.shape.get(axis, 1)) if mesh is not None else 1


def _line(mesh, axis):
    """``(group, size, index)`` of this rank's line along ``axis``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return None, 1, 0
    group = mesh.axis_group(axis)
    if group is None:
        raise RuntimeError(
            "a %r axis of %d needs the mesh's world: join it first "
            "(parallel/mesh.initialize_distributed)" % (axis, n))
    return group, n, mesh.axis_index(axis)


def _peer(group, index):
    """The global rank of the axis line's rank ``index``."""
    if group is dist.GroupMember.WORLD:
        return index
    return dist.get_global_rank(group, index)


class _Call:
    """One collective's staging and booking: ``stage(t)`` gives the
    operand the backend takes (a host copy where gloo meets a CUDA
    tensor), ``back(t)`` returns a result to the operand's device."""

    def __init__(self, mesh, op, group, like):
        self.mesh, self.op = mesh, op
        self.device = like.device
        self.staged = like.is_cuda and dist.get_backend(group) == "gloo"
        if self.staged:
            torch.cuda.synchronize(self.device)
        self.nbytes = 0
        self.started = time.perf_counter()

    def stage(self, t):
        t = t.contiguous()
        self.nbytes += t.numel() * t.element_size()
        return t.cpu() if self.staged else t

    def back(self, t):
        return t.to(self.device) if self.staged else t

    def done(self):
        row = collective_stats(self.mesh).setdefault(self.op, [0, 0, 0.0])
        row[0] += 1
        row[1] += self.nbytes
        row[2] += time.perf_counter() - self.started


# -- raw collectives ----------------------------------------------------------

def _ppermute(tensors, mesh, axis, shift):
    group, n, index = _line(mesh, axis)
    if n == 1:
        return tuple(tensors)
    dst = _peer(group, (index + shift) % n)
    src = _peer(group, (index - shift) % n)
    call = _Call(mesh, "ppermute", group, tensors[0])
    ops, received = [], []
    for t in tensors:
        send = call.stage(t)
        recv = torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send, dst, group))
        ops.append(dist.P2POp(dist.irecv, recv, src, group))
        received.append(recv)
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    out = tuple(call.back(t) for t in received)
    call.done()
    return out


def _all_to_all(x, mesh, axis, split_axis, concat_axis, tiled):
    group, n, _ = _line(mesh, axis)
    if n == 1:
        return x
    shape = list(x.shape)
    if tiled:
        if shape[split_axis] % n:
            raise ValueError(
                "all_to_all over %r: dimension %d of %s does not split into "
                "%d blocks" % (axis, split_axis, tuple(shape), n))
        x = x.reshape(shape[:split_axis] + [n, shape[split_axis] // n]
                      + shape[split_axis + 1:])
    elif shape[split_axis] != n:
        raise ValueError(
            "all_to_all over %r (not tiled): dimension %d of %s must be "
            "the axis size %d" % (axis, split_axis, tuple(shape), n))
    call = _Call(mesh, "all_to_all", group, x)
    blocks = call.stage(x.movedim(split_axis, 0))
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=group)
    out = call.back(out)
    call.done()
    # out[i] came from the axis's rank i: its blocks go to concat_axis in
    # axis order (tiled: merged into that dimension, major)
    rest = list(out.shape[1:])
    out = out.movedim(0, concat_axis)
    if not tiled:
        return out
    return out.reshape(rest[:concat_axis] + [n * rest[concat_axis]]
                       + rest[concat_axis + 1:])


def _psum(x, mesh, axis):
    group, n, _ = _line(mesh, axis)
    if n == 1:
        return x
    call = _Call(mesh, "psum", group, x)
    buf = call.stage(x)
    if not call.staged:
        buf = buf.clone()   # all_reduce writes its operand
    dist.all_reduce(buf, group=group)
    out = call.back(buf)
    call.done()
    return out


# -- differentiable ones ------------------------------------------------------

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, shift, *tensors):
        ctx.args = (mesh, axis, shift)
        return _ppermute(tensors, mesh, axis, shift)

    @staticmethod
    def backward(ctx, *grads):
        mesh, axis, shift = ctx.args
        return (None, None, None) + _ppermute(grads, mesh, axis, -shift)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis, tiled):
        ctx.args = (mesh, axis, split_axis, concat_axis, tiled)
        return _all_to_all(x, mesh, axis, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, split_axis, concat_axis, tiled = ctx.args
        return (_all_to_all(grad, mesh, axis, concat_axis, split_axis,
                            tiled), None, None, None, None, None)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return (_psum(grad, *ctx.args), None, None)


def ppermute(tensors, mesh, axis, shift=1):
    """``lax.ppermute`` with the ring permutation ``i -> i + shift``
    along ``axis``: each tensor of the sequence ``tensors`` goes to the
    axis's rank ``index + shift`` and the one from ``index - shift``
    comes back (modulo the axis size). Returns a tuple; differentiable."""
    if axis_size(mesh, axis) == 1:
        return tuple(tensors)
    return _PPermute.apply(mesh, axis, shift, *tensors)


def all_to_all(x, mesh, axis, split_axis, concat_axis, tiled=True):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled)``:
    tiled, dimension ``split_axis`` splits into the axis's blocks and
    block j goes to its rank j, which concatenates what arrives along
    ``concat_axis`` in axis order; not tiled, ``split_axis`` has the
    axis's size, is removed, and the source index is a new dimension at
    ``concat_axis``. Differentiable (the inverse ``all_to_all``)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis, tiled)


def psum(x, mesh, axis):
    """``lax.psum``: the sum of every rank's ``x`` along ``axis``, the
    same bits on each; differentiable (its backward is ``psum``)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _PSum.apply(x, mesh, axis)


def pmean(x, mesh, axis):
    """``lax.pmean``: :func:`psum` over the axis size."""
    n = axis_size(mesh, axis)
    return x if n == 1 else psum(x, mesh, axis) / n


def all_gather(x, mesh, axis, dim):
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: every rank's
    ``x`` concatenated along ``dim`` in axis order. Not differentiable."""
    group, n, _ = _line(mesh, axis)
    if n == 1:
        return x
    call = _Call(mesh, "all_gather", group, x)
    send = call.stage(x)
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    out = call.back(torch.cat(parts, dim=dim))
    call.done()
    return out


def psum_flat(tensors, mesh, axis):
    """:func:`psum` of every tensor of ``tensors`` (one dtype and
    device), as one flat buffer and one all-reduce, the sum in float32
    (a bf16 gradient rounds once, after the sum, as one rank's would)
    and returned in the tensors' type. Not differentiable; returns a
    list."""
    if axis_size(mesh, axis) == 1 or not tensors:
        return list(tensors)
    flat = _psum(torch.cat([t.reshape(-1).float() for t in tensors]), mesh,
                 axis)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out
