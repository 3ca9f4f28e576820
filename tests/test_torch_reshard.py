"""The port's collective resharding (veles_tpu_torch/parallel/reshard.py)
against the JAX package's (tests/test_reshard.py).

The plans (``TestSchedule``) come from shapes and specs alone: the port's
are built in this process on a world-less ``data=2, model=4`` mesh and
must equal the JAX package's on 8 virtual devices op for op, bytes and
all. The moves (``TestReshard``) run in gloo worlds of 2 (``model=2``)
and 4 (``data=2, model=2``) ``python -c`` ranks (tests/torch_world.py):
every rank reshards its own shards, and round trips must return the
values bit for bit."""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from veles_tpu.parallel import reshard as jrs
from veles_tpu.parallel.mesh import build_mesh as jbuild_mesh
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.parallel import reshard as trs
from veles_tpu_torch.parallel.mesh import Mesh, PartitionSpec as P

from torch_world import join_world, start_world

torch.set_num_threads(1)

DEADLINE = 90


@pytest.fixture(scope="module")
def meshes():
    return (jbuild_mesh(devices=jax.devices()[:8], data=2, model=4),
            Mesh({"data": 2, "model": 4}))


def _port(spec):
    """A JAX spec as the port's."""
    return P(*tuple(spec))


def _plans(meshes, shape, src, dst):
    jmesh, tmesh = meshes
    theirs = jrs.plan_reshard(jnp.zeros(shape, jnp.float32), jmesh, dst,
                              src).leaves[0]
    ours = trs.plan_reshard(torch.zeros(shape), tmesh, _port(dst),
                            _port(src)).leaves[0]
    return theirs, ours


SCHEDULE = [
    ((16, 32), JP(None, "model"), JP("model", None)),
    ((16, 32), JP(), JP(None, "model")),
    ((16, 32), JP("data", None), JP()),
    ((16, 32), JP(("data", "model"), None), JP()),
    ((16, 32), JP("data", None), JP("data", None)),
    ((16, 32), JP("model"), JP("model", None)),
    ((16, 32), JP(), JP(None)),
    ((16, 32), JP(("model",), None), JP("model")),
    ((16, 32), JP("model", "data"), JP("data", "model")),
]


class TestSchedule:
    @pytest.mark.parametrize("shape,src,dst", SCHEDULE,
                             ids=["transpose", "slice", "gather", "nested",
                                  "keep", "respelled", "none",
                                  "one-tuple", "entangled"])
    def test_plan_equals_jax(self, meshes, shape, src, dst):
        """Every case of tests/test_reshard.py::TestSchedule: the same
        steps (op, axis, dims) and the same wire bytes."""
        theirs, ours = _plans(meshes, shape, src, dst)
        assert ours.steps == theirs.steps
        assert ours.bytes == theirs.bytes

    def test_transpose_resharding_is_one_all_to_all(self, meshes):
        _, ours = _plans(meshes, (16, 32), JP(None, "model"),
                         JP("model", None))
        assert [s[0] for s in ours.steps] == ["all_to_all"]
        assert ours.bytes == 8 * (16 * 32 * 4 // 4) * 3 // 4

    def test_indivisible_spec_raises_named_error(self, meshes):
        with pytest.raises(ValueError, match="cannot shard"):
            trs.plan_reshard(torch.zeros(15, 32), meshes[1],
                             P("data", None), P())

    def test_tree_plan_equals_jax(self, meshes):
        """The whole train-to-serve tree, the float and int8 tiers: the
        step tally and the bytes of the port's serving layout, planned
        on the repacked tree, against JAX's on its own layout (both are
        slice-only)."""
        from veles_tpu.parallel.decode import slot_param_specs as jspecs
        from veles_tpu.parallel.transformer_step import \
            init_transformer_params as jinit
        from veles_tpu_torch.parallel import decode as tdec
        from veles_tpu_torch.parallel.transformer_step import \
            init_transformer_params as tinit

        jparams = jinit(numpy.random.RandomState(1), 2, 32, 8, 16)
        tparams = tdec.repack_slot_params(tinit(
            numpy.random.RandomState(1), 2, 32, 8, 16, device="cpu"), 8)
        theirs = jrs.plan_reshard(jparams, meshes[0], jspecs(jparams),
                                  JP())
        ours = trs.plan_reshard(tparams, meshes[1],
                                tdec.slot_param_specs(tparams), P())
        assert ours.bytes == theirs.bytes == 0
        assert ours.counts() == theirs.counts()


#: the round trips of tests/test_reshard.py::TestReshard, as (src, dst)
CASES = [
    (P(), P(None, "model")),
    (P(None, "model"), P("model", None)),
    (P("data", None), P(None, "model")),
    (P(("data", "model"), None), P()),
    (P("model", "data"), P("data", "model")),
]

RANK = r'''
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.parallel import decode, reshard as rs
from veles_tpu_torch.parallel.mesh import PartitionSpec as P
from veles_tpu_torch.parallel.transformer_step import init_transformer_params
world = cfg["world"]
mesh = build_mesh(data=world // 2, model=2)
w = torch.from_numpy(inputs["w"])
trips = []
for src, dst in inputs["cases"]:
    mine, _ = rs.reshard(w, mesh, src)
    there, stats = rs.reshard(mine, mesh, dst, src)
    back, _ = rs.reshard(there, mesh, src, dst)
    whole, _ = rs.reshard(there, mesh, P(), dst)
    trips.append({"there": there.numpy(), "back": back.numpy(),
                  "mine": mine.numpy(), "whole": whole.numpy(),
                  "bytes": stats["bytes"], "counts": stats["counts"],
                  "seconds": stats["seconds"]})
out["trips"] = trips
params = init_transformer_params(numpy.random.RandomState(1), 2, 32, 8,
                                 16, device="cpu")
packed = decode.repack_slot_params(params, 8)
specs = decode.slot_param_specs(packed)
registry = MetricsRegistry(enabled=True)
served, to_serve = rs.reshard(packed, mesh, specs, label="train_to_serve",
                              registry=registry)
back, to_train = rs.reshard(served, mesh, P(), specs,
                            label="serve_to_train", registry=registry)
leaves = [l for _, l in decode.tree_leaves_with_path(packed)]
back_leaves = [l for _, l in decode.tree_leaves_with_path(back)]
out["tree"] = {
    "to_serve": to_serve, "to_train": to_train,
    "exact": all(torch.equal(a, b) for a, b in zip(leaves, back_leaves)),
    "local_wqkv": tuple(served["blocks"][0]["wqkv"].shape),
    "local_head": tuple(served["head"].shape),
    "metrics": registry.expose()}
naive, _ = rs.naive_reshard(packed, mesh, specs)
out["naive_equal"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
    decode.tree_leaves_with_path(naive),
    decode.tree_leaves_with_path(served)))
finish()
'''


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = numpy.random.RandomState(0).randn(16, 32).astype(numpy.float32)
    inputs = {"w": w, "cases": CASES}
    started = {n: start_world(RANK, n, str(tmp_path_factory.mktemp(
        "reshard%d" % n)), inputs) for n in (2, 4)}
    return w, {n: join_world(s, DEADLINE)[0] for n, s in started.items()}


def _local(w, spec, mesh):
    """The shard of ``w`` a rank of ``mesh`` holds under ``spec``."""
    plan = trs.plan_reshard(torch.from_numpy(w), mesh, spec, P())
    return trs.apply_plan(torch.from_numpy(w), plan.leaves[0],
                          mesh).numpy()


class TestReshard:
    @pytest.mark.parametrize("n", [2, 4])
    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_round_trip_bit_exact(self, worlds, n, case):
        """Each rank's shard after the move is its shard of ``w`` under
        the destination spec, the move back returns its source shard, and
        a gather gives ``w``: bit for bit."""
        w, results = worlds
        src, dst = CASES[case]
        for rank, got in enumerate(results[n]):
            mesh = Mesh({"data": n // 2, "model": 2}, rank=rank)
            trip = got["trips"][case]
            numpy.testing.assert_array_equal(trip["mine"],
                                             _local(w, src, mesh))
            numpy.testing.assert_array_equal(trip["there"],
                                             _local(w, dst, mesh))
            numpy.testing.assert_array_equal(trip["back"], trip["mine"])
            numpy.testing.assert_array_equal(trip["whole"], w)
            assert not numpy.isnan(trip["seconds"])

    @pytest.mark.parametrize("n", [2, 4])
    def test_tree_transition_train_to_serve_and_back(self, worlds, n):
        """A whole checkpoint to the serving layout is slice-only (0
        bytes) and leaves each rank its heads; back to whole pays real
        bytes and returns every leaf exactly; both transitions book their
        metrics under their labels; the naive formulation gives the same
        shards."""
        _, results = worlds
        for got in results[n]:
            tree = got["tree"]
            assert tree["to_serve"]["bytes"] == 0
            assert tree["to_serve"]["counts"].get("slice")
            assert tree["to_train"]["bytes"] > 0
            assert tree["exact"]
            assert tree["local_wqkv"] == (32, 3, 4, 4)
            assert tree["local_head"] == (32, 8)
            text = tree["metrics"]
            for label in ("train_to_serve", "serve_to_train"):
                assert 'veles_reshard_bytes_total{transition="%s"}' \
                    % label in text
            assert "veles_reshard_seconds_bucket" in text
            assert got["naive_equal"]


def test_respelled_dst_spec_is_a_no_op():
    """A destination spelling the leaf's layout differently passes it
    through untouched: one keep, 0 bytes (no world needed)."""
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mesh = Mesh({"model": 2})
    out, stats = trs.reshard(w, mesh, P("model", None), P("model"))
    assert stats["bytes"] == 0 and stats["counts"] == {"keep": 1}
    assert torch.equal(out, w)


def test_metrics_surface_and_indivisible_leaf():
    registry = MetricsRegistry(enabled=True)
    mesh = Mesh({"data": 2})
    trs.reshard(torch.zeros(16, 32), mesh, P("data", None),
                label="t2s-test", registry=registry)
    text = registry.expose()
    assert 'veles_reshard_bytes_total{transition="t2s-test"}' in text
    assert "veles_reshard_seconds_bucket" in text
    with pytest.raises(ValueError, match="cannot shard"):
        trs.reshard(torch.zeros(15, 4), mesh, P("data", None),
                    registry=registry)
