"""The sharded serving engine over a world: tensor parallelism written out.

The JAX package has no counterpart of this module and needs none: its
sharded slot and paged engines are the single-chip programs jitted under
a head-sharded layout (``veles_tpu/parallel/decode.py:1090-1161``,
``kv_pool.py:515-570``), and XLA's partitioner inserts the collectives.
The port's mesh is a ``torch.distributed`` world, one process per device
(``parallel/mesh.py``), so what ``sharded_slot_fns`` and
``sharded_paged_fns`` return there is this module here:

- :class:`TensorParallel` is the arithmetic's side: the all-reduce that
  completes a head-sharded out-projection and a row-sharded FFN-down
  product (two a block), and the all-gather of each rank's vocab slice of
  the logits (one a step), so every rank picks the same token. The
  partial sums reduce in float32 whatever the serving type (a bf16
  product's partials are widened first and the sum rounded once to bf16),
  where the JAX package's partitioner sums in the serving type.
- :class:`ShardEngine` is one rank's shard: its slice of the parameters
  (``decode.shard_slot_params``), the whole embedding table, and a slot
  slab or page pool holding its heads alone (``decode.slot_state_specs``,
  ``kv_pool.paged_state_specs``). :meth:`ShardEngine.apply` runs one
  device call on it from host operands: the slab's admission and
  dispatch, the pool's cold, tail and hit admissions and dispatch, the
  capture of prefix pages for a breaker rebuild and their restore, and a
  weight swap.
- The host side (HTTP, admission, the page table, the prefix cache) runs
  on rank 0 alone. Rank 0's decoder (``serving.ContinuousDecoder(mesh=)``)
  hands each device call on over the world (:class:`WorldLink`: the op and
  its small host operands, pickled and broadcast from rank 0) before it
  applies the call itself; every other rank runs :func:`follow`, which
  applies the same calls in the same order. The reduces inside the math
  keep the ranks in step. Lifecycle events ride the same channel: the
  build of a decoder's state (a breaker rebuild's too), its install, its
  discard, a swap, a heartbeat while the server idles, and the end.
- Rank 0 may hold more than one decoder at a time: the breaker's rebuild
  and the governor's tier swap build and probe a new decoder while the
  old one still serves, and a blue-green rollout runs blue and green side
  by side. So every hand-off names the engine it is for (an id the link
  numbers), and a follower holds its engines by that id: ``BUILD`` makes
  one (from the weights the follower holds, or from the weights the build
  carries: a rollout's green engine), ``INSTALL`` makes one the engine in
  service (later weightless builds take its weights), and ``DISCARD``
  drops one and frees its pool (a failed probe, a rollback, the engine a
  rebuild, a tier swap or a promote retired). A discard may name
  rank 0's memscope edge (``rollout_promote``, ``breaker_rebuild``): the
  follower then brackets it in an edge of its own memscope, whose
  engines it registers as rank 0 registers its decoders.

No hang: rank 0 sends the end on every exit path of its server
(``GenerateAPI.stop``; ``ContinuousDecoder.close``). A follower whose
rank 0 died fails at the closed connection or at the world's timeout
(``root.common.mesh.timeout``) and raises, so its process exits
non-zero. A rank 0 whose follower died gets a failed collective: its
breaker trips, and the rebuild's hand-off fails loudly. A call that
fails on rank 0 after it was handed on leaves the world out of step, so
the link refuses every later hand-off at once instead of pairing
mismatched collectives.

What it costs is counted: :class:`WorldLink` the bytes and seconds of
each hand-off by op, :class:`TensorParallel` the calls, operand bytes
and wall seconds of the collectives; ``observe/metrics.publish_decoder``
publishes both (``veles_tp_*``).
"""

import threading
import time

import torch

from veles_tpu_torch.core.config import root
from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.fleet.pod import _Channel
from veles_tpu_torch.parallel import decode, kv_pool
from veles_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT, PartitionSpec
from veles_tpu_torch.parallel.reshard import (apply_plan, plan_reshard,
                                              reshard)

#: lifecycle events rank 0 hands on beside the device calls
BUILD, INSTALL, DISCARD, SWAP, BEAT, END = ("build", "install", "discard",
                                           "swap", "beat", "end")


class TensorParallel:
    """The collectives of one rank of a head-sharded engine over the
    mesh's ``axis``: :meth:`reduce` (all-reduce, sum) and :meth:`gather`
    (all-gather of the last dim). ``stats``: the calls, operand bytes and
    wall seconds of each kind; with gloo on a card a collective stages
    its operand through the host, so its seconds include the wait for
    the product that feeds it."""

    def __init__(self, mesh, axis="model"):
        self.mesh = mesh
        self.axis = axis
        self.size = int(mesh.shape[axis])
        self.group = mesh.axis_group(axis)
        if self.group is None and self.size > 1:
            raise RuntimeError(
                "a %r axis of %d needs the mesh's world: join it first "
                "(parallel/mesh.initialize_distributed)"
                % (axis, self.size))
        self.stats = {"reduce": [0, 0, 0.0], "gather": [0, 0, 0.0]}

    def _book(self, kind, tensor, started):
        row = self.stats[kind]
        row[0] += 1
        row[1] += tensor.numel() * tensor.element_size()
        row[2] += time.perf_counter() - started

    def reduce(self, y):
        """The sum of every rank's partial ``y``, in float32, returned in
        ``y``'s type; the same bits on every rank."""
        started = time.perf_counter()
        buf = y.float().contiguous()
        torch.distributed.all_reduce(buf, group=self.group)
        self._book("reduce", buf, started)
        return buf.to(y.dtype)

    def gather(self, x):
        """Every rank's ``x`` concatenated along the last dim in rank
        order: the whole vocabulary's logits from each rank's slice."""
        started = time.perf_counter()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        torch.distributed.all_gather(parts, x, group=self.group)
        self._book("gather", x, started)
        return torch.cat(parts, dim=-1)



class WorldLink:
    """Rank 0's channel to the other ranks of a serving mesh: one a mesh
    (:func:`world_link`), shared by every decoder built on it. ``stats``
    counts the hand-offs, bytes and seconds by op; ``broken`` holds why
    the world is out of step (then every hand-off raises)."""

    def __init__(self, mesh):
        self.channel = _Channel(mesh.group)
        self.broken = None
        self.ended = False
        self.last_sent = time.monotonic()
        self.stats = {"calls": {}, "bytes": {}, "seconds": 0.0}
        self._lock = threading.Lock()
        self._engines = 0

    def new_engine(self):
        """The id of a new engine on this link (every build takes one)."""
        with self._lock:
            self._engines += 1
            return self._engines

    def hand_on(self, op, payload=None, engine=None):
        """Broadcast ``(op, engine, payload)`` to the followers; returns
        the bytes sent."""
        with self._lock:
            if self.broken is not None:
                raise RuntimeError("the serving mesh is out of step (%s); "
                                   "restart its world" % self.broken)
            if self.ended:
                if op != BUILD:
                    raise RuntimeError(
                        "the serving mesh's stream has ended")
                # a new decoder opens a new stream: the followers run
                # follow() again
                self.ended = False
            started = time.perf_counter()
            try:
                size = self.channel.send((op, engine, payload))
            except Exception as exc:
                self.broken = "hand-off of %r failed: %s" % (op, exc)
                raise
            self.last_sent = time.monotonic()
            stats = self.stats
            stats["calls"][op] = stats["calls"].get(op, 0) + 1
            stats["bytes"][op] = stats["bytes"].get(op, 0) + size
            stats["seconds"] += time.perf_counter() - started
            return size

    def run(self, engine, op, args):
        """Rank 0's device call: hand ``(op, args)`` on for ``engine``'s
        id, then apply it to rank 0's shard ``engine``. A call that fails
        here after the followers took it leaves the world out of step:
        the link is broken from then on."""
        self.hand_on(op, args, engine=engine.engine_id)
        try:
            return engine.apply(op, args)
        except Exception as exc:
            self.broken = "%r failed on rank 0 after it was handed on: " \
                "%s" % (op, exc)
            raise

    def heartbeat(self):
        """Hand a beat on when nothing went for a third of the world's
        timeout, so an idle server's followers never time out."""
        timeout = float(root.common.mesh.get("timeout") or DEFAULT_TIMEOUT)
        if self.broken is None and not self.ended \
                and time.monotonic() - self.last_sent > timeout / 3:
            self.hand_on(BEAT)

    def end(self):
        """The end of the stream, safe on every exit path and where the
        followers are gone already."""
        if self.ended:
            return
        try:
            if self.broken is None:
                self.hand_on(END)
        except Exception:   # noqa: BLE001 - the followers may be gone
            pass
        self.ended = True


def world_link(mesh):
    """The :class:`WorldLink` of ``mesh`` (made on first use, on rank 0)."""
    link = mesh.__dict__.get("_world_link")
    if link is None:
        link = mesh.__dict__.setdefault("_world_link", WorldLink(mesh))
    return link


class ShardEngine:
    """One rank's shard of the sharded slot or paged engine. ``config``
    is the decoder's geometry as rank 0 built it: ``slots``, ``max_len``
    (rounded), ``vocab``, ``paged``, ``page_size``, ``pool_pages``,
    ``quantize``. ``params`` and ``embed_table`` are the whole serving
    weights (the int8 tiers quantize them first, as a single device
    does); the engine keeps this rank's slice (:attr:`params`), the
    whole table and a state of this rank's heads (:attr:`state`)."""

    def __init__(self, mesh, params, embed_table, heads, config,
                 axis="model", device=None, engine_id=None):
        self.mesh = mesh
        #: the id the hand-offs name this engine by
        self.engine_id = engine_id
        self.axis = axis
        self.device = resolve_device(device)
        self.config = dict(config)
        self.n = int(mesh.shape[axis])
        self.heads = int(heads)
        self.local_heads = self.heads // self.n
        self.tp = TensorParallel(mesh, axis)
        self.params = self.embed_table = None
        self.last_reshard = None
        self.set_params(params, embed_table, label=None)
        quantized = config.get("quantize") == "int8-kv"
        embed = int(self.embed_table.shape[1])
        n_blocks = len(self.params["blocks"])
        if config.get("paged"):
            self.state = kv_pool.init_paged_state(
                n_blocks, config["pool_pages"], config["page_size"],
                self.local_heads, embed // self.heads, config["vocab"],
                config["slots"], dtype=self.embed_table.dtype,
                quantized=quantized, device=self.device)
        else:
            self.state = decode.init_slot_state(
                n_blocks, config["slots"], config["max_len"],
                self.local_heads, embed // self.heads, config["vocab"],
                dtype=self.embed_table.dtype, quantized=quantized,
                device=self.device)

    def set_params(self, params, embed_table, label="swap"):
        """Take new whole weights: quantize them in the int8 tiers, then
        slice this rank's part. With a ``label`` the slice goes through
        :func:`~veles_tpu_torch.parallel.reshard.reshard` and its receipt
        (a whole tree to the serving layout: slice-only, 0 bytes) is
        kept in :attr:`last_reshard`."""
        from veles_tpu_torch.device import tree_to

        params = tree_to(params, self.device)
        table = embed_table.to(self.device)
        if self.config.get("quantize") \
                and not isinstance(params["head"], dict):
            params = decode.quantize_params(params)
        if label is None:
            local, table = decode.shard_slot_params(
                params, table, self.heads, self.mesh, axis=self.axis)
        else:
            decode.validate_slot_mesh(self.mesh, self.heads, params, table,
                                      axis=self.axis)
            packed = decode.repack_slot_params(params, self.heads)
            local, stats = reshard(
                packed, self.mesh,
                decode.slot_param_specs(packed, self.axis), label=label)
            local = decode.local_from_packed(local)
            self.last_reshard = stats
        self.params = local
        self.embed_table = table

    def _tensor(self, array, dtype=None):
        tensor = torch.as_tensor(array)
        if dtype is not None:
            tensor = tensor.to(dtype)
        return tensor.to(self.device)

    def _keys(self, args):
        keys = args.get("keys")
        return None if keys is None else self._tensor(keys, torch.long)

    def _x(self, tokens):
        return self.embed_table[self._tensor(tokens, torch.long)]

    def apply(self, op, args):
        """Run device call ``op`` on this rank's shard from its host
        operands ``args``; returns what the call emits (the dispatches'
        tokens, the capture's page payloads) or None."""
        heads, tp, state = self.local_heads, self.tp, self.state
        if op == "admit":
            decode.slot_admit_many(
                self.params, heads, state, self._tensor(args["slots"]),
                self._x(args["tokens"]), self._tensor(args["lengths"]),
                self._keys(args), tp=tp)
        elif op == "paged.admit":
            kv_pool.paged_admit_many(
                self.params, heads, state, self._tensor(args["slots"]),
                self._tensor(args["pages"]), self._x(args["tokens"]),
                self._tensor(args["lengths"]), self._keys(args), tp=tp)
        elif op == "paged.admit_tail":
            kv_pool.paged_admit_tail(
                self.params, heads, state, self._tensor(args["slots"]),
                self._tensor(args["prefix_pages"]),
                self._tensor(args["pages"]), self._x(args["tokens"]),
                self._tensor(args["lengths"]), self._keys(args), tp=tp)
        elif op == "paged.admit_hit":
            kv_pool.paged_admit_hit(
                state, self._tensor(args["slots"]),
                self._tensor(args["lengths"]),
                self._tensor(args["logits"], torch.float32),
                self._keys(args))
        elif op == "dispatch":
            _, emitted = decode.slot_step_many(
                self.params, self.embed_table, heads, state,
                self._tensor(args["active"]), args["n"], *args["sampling"],
                span=args["span"], tp=tp)
            return emitted
        elif op == "paged.dispatch":
            _, emitted = kv_pool.paged_slot_step_many(
                self.params, self.embed_table, heads, state,
                self._tensor(args["table"]), self._tensor(args["active"]),
                args["n"], *args["sampling"], tp=tp)
            return emitted
        elif op == "capture":
            return self._capture(args["pages"])
        elif op == "restore":
            self._restore(args["pages"], args["values"])
        else:
            raise ValueError("unknown sharded engine call %r" % (op,))
        return None

    def _pool_specs(self):
        specs = kv_pool.paged_state_specs(
            self.config.get("quantize") == "int8-kv", axis=self.axis)
        return {name: specs[name] for name in kv_pool.PAGED_KV_LEAVES
                if name in self.state}

    def _capture(self, pages):
        """The whole heads of ``pages``' payloads, on the host of every
        rank: each rank's heads gathered over the axis (rank 0 keeps them
        as the prefix cache's shadows)."""
        if not pages:
            return {}
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        specs = self._pool_specs()
        local = {name: self.state[name].index_select(1, idx)
                 for name in specs}
        plan = plan_reshard(local, self.mesh, PartitionSpec(), specs,
                            local=True)
        whole = {}
        for (name, val), leaf_plan in zip(sorted(local.items()),
                                          plan.leaves):
            whole[name] = apply_plan(val, leaf_plan, self.mesh).cpu()
        return {page: {name: val[:, i].clone()
                       for name, val in whole.items()}
                for i, page in enumerate(pages)}

    def _restore(self, pages, values):
        """Copy the whole-head payloads ``values`` (one (L, NP, ...) host
        tensor a pool leaf) into ``pages``: this rank's heads of each."""
        specs = self._pool_specs()
        plan = plan_reshard(values, self.mesh, specs, PartitionSpec())
        mine = {name: apply_plan(values[name], leaf_plan, self.mesh)
                for name, leaf_plan in zip(sorted(values), plan.leaves)}
        kv_pool._paged_restore(self.state, pages, mine)



def _register_engine(engine):
    """memscope's owners of a follower's engine, as rank 0's decoder
    registers them (weakly: a dropped engine leaves the next sample)."""
    from veles_tpu_torch.observe.memscope import get_memscope

    scope = get_memscope()
    scope.register("params", engine, lambda e: 0 if e.params is None
                   else decode.param_tree_bytes(e.params, e.embed_table))
    scope.register("decode_state", engine, lambda e: 0 if e.state is None
                   else decode.slot_state_bytes(e.state))


def follow(mesh, params, embed_table, heads, axis="model", device=None):
    """The side of a rank above 0: apply rank 0's hand-offs to this
    rank's engines, in order, until its end event. ``params`` and
    ``embed_table`` are the whole serving weights the world started from
    (every rank loads the same checkpoint): a build that carries no
    weights takes the weights of the engine in service (these at first;
    an install or a swap of that engine replaces them).

    Returns the follower's stats: events and bytes by op, seconds
    waiting and applying, the decode steps its dispatches ran,
    ``engine``, the engine in service at the end (its state as the
    stream left it), ``engines``, the ids of the engines still held, and
    ``edges``, the memscope verdicts of the discards that named an edge.
    Raises when the world is lost (rank 0 died: the closed connection,
    or the world's timeout)."""
    from veles_tpu_torch.observe.memscope import get_memscope

    channel = _Channel(mesh.group)
    engines, weights = {}, {}
    held = (params, embed_table)
    current = None
    stats = {"calls": {}, "bytes": {}, "wait_s": 0.0, "apply_s": 0.0,
             "steps": 0, "edges": []}
    while True:
        started = time.perf_counter()
        (op, eid, payload), size = channel.receive()
        received = time.perf_counter()
        stats["wait_s"] += received - started
        stats["calls"][op] = stats["calls"].get(op, 0) + 1
        stats["bytes"][op] = stats["bytes"].get(op, 0) + size
        if op == END:
            stats["engine"] = engines.get(current)
            stats["engines"] = sorted(engines)
            return stats
        if op == BUILD:
            built = payload.get("weights") or held
            engines[eid] = ShardEngine(mesh, built[0], built[1], heads,
                                       payload["config"], axis=axis,
                                       device=device, engine_id=eid)
            weights[eid] = built
            _register_engine(engines[eid])
            if current is None:
                # the stream's first engine serves until an install
                current = eid
        elif op == INSTALL:
            current = eid
            held = weights[eid]
        elif op == DISCARD:
            edge = payload["edge"]
            scope = get_memscope()
            if edge:
                scope.edge_begin(edge)
            engine = engines.pop(eid)
            weights.pop(eid)
            # the pool and the shard go now, whoever holds the engine
            engine.state = engine.params = engine.embed_table = None
            del engine
            if current == eid:
                current = None
            if edge:
                verdict = scope.edge_end(edge, gc_collect=True)
                if verdict is not None:
                    stats["edges"].append(
                        {"edge": edge, "leak": verdict["leak"],
                         "owner": verdict["owner"],
                         "grown": dict(verdict["grown"])})
        elif op == SWAP:
            table = payload["embed_table"]
            new = (payload["params"],
                   weights[eid][1] if table is None else table)
            engines[eid].set_params(new[0], new[1], label="swap")
            weights[eid] = new
            if eid == current:
                held = new
        elif op != BEAT:
            engines[eid].apply(op, payload)
            if op in ("dispatch", "paged.dispatch"):
                stats["steps"] += payload["n"]
        stats["apply_s"] += time.perf_counter() - received
