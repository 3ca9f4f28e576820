"""The port's data-parallel reduce (veles_tpu_torch/parallel/mapreduce.py)
against the JAX package's under ``shard_map`` on the CPU.

The JAX side reduces on a data mesh of 2 and 4 of the 8 virtual CPU
devices in this process; the port's side is a gloo world of 2 and 4
processes (:data:`RANK`), each rank given the same per-device numpy
inputs as its device. Both reduce the same tree in the three tiers
(``reduce_sum`` and ``reduce_mean``), and the ranks also take the int8
tier's first-stage codes and scale and run three data-parallel train
steps (``fleet_train_step``) with the reduce plane's stats on.

Held: the int8 tier's codes, scales and results bit-equal to JAX's (the
same f32 operations on the same bytes, the sums exact in int32); the
integer leaves exact; f32 and bf16 within ``ULPS * n * eps`` of the
summed magnitudes (a ring adds the n terms in another order than XLA's
all-reduce, rounding each partial sum to the wire's type);
``reduce_wire_bytes`` equal; the ``ReduceStats`` counters equal JAX's on
the same notes."""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from veles_tpu.observe.metrics import MetricsRegistry as JMetricsRegistry
from veles_tpu.parallel import mapreduce as jmr
from veles_tpu.parallel.mesh import build_mesh as jbuild_mesh, shard_map
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.parallel import mapreduce as mr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a sum of n terms rounded in another order differs by at most about
#: n roundings of the terms' magnitudes: the bound per element is
#: ``ULPS * n * eps * sum(|x_i|)``, eps of the wire's type
F32_EPS, BF16_EPS, ULPS = 2.0 ** -24, 2.0 ** -8, 2
#: seconds the worlds of ranks may take
DEADLINE = 90
WORLDS = (2, 4)
PRECISIONS = ("f32", "bf16", "int8")
STEPS = 3

#: one rank: ``python -c RANK <config.json> <rank>``
RANK = r'''
import json, pickle, sys
import numpy, torch
torch.set_num_threads(1)
cfg = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
from veles_tpu_torch.observe.xla_stats import get_compile_tracker
from veles_tpu_torch.parallel import mapreduce as mr
from veles_tpu_torch.parallel.mesh import (build_mesh,
                                           finalize_distributed,
                                           initialize_distributed)
initialize_distributed(cfg["coordinator"], cfg["world"], rank,
                       device="cpu", timeout=cfg["timeout"])
mesh = build_mesh(data=cfg["world"])
with open(cfg["inputs"], "rb") as fin:
    inputs = pickle.load(fin)
tree = {key: torch.from_numpy(numpy.asarray(value[rank]))
        for key, value in inputs["tree"].items()}
out = {}
for precision in ("f32", "bf16", "int8"):
    for mean in (False, True):
        fn = mr.reduce_mean if mean else mr.reduce_sum
        got = fn(tree, precision=precision)
        out[precision, mean] = {k: v.numpy() for k, v in got.items()}
flat = tree["w"].reshape(-1)
flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % cfg["world"]))
scale = mr._scale_of(flat, None)
out["codes"] = (mr._quantize(flat, scale).numpy(), scale.numpy())
# three data-parallel train steps with the reduce plane on
get_compile_tracker().enabled = True
stats = mr.get_reduce_stats()
stats.reset()
step = inputs["step"]
train_step = mr.fleet_train_step(mesh, step["specs"], "none",
                                 with_confusion=False,
                                 reduce_precision="f32")[0]
params = [{"p": {k: torch.from_numpy(v) for k, v in layer["p"].items()},
           "v": {k: torch.from_numpy(v) for k, v in layer["v"].items()}}
          for layer in step["params"]]
hypers = [torch.from_numpy(h) for h in step["hypers"]]
losses = []
for _ in range(3):
    params, (loss, n_err) = train_step(
        params, hypers, {}, torch.from_numpy(step["data"]),
        torch.from_numpy(step["labels"]),
        torch.arange(len(step["labels"])), float(len(step["labels"])), 0)
    losses.append((float(loss), int(n_err)))
out["step"] = {"losses": losses, "stats": stats.snapshot(),
               "idle": stats.idle_fraction(),
               "name": train_step.program_name,
               "params": [{k: v.numpy() for k, v in layer["p"].items()}
                          for layer in params]}
with open(cfg["out"] % rank, "wb") as fout:
    pickle.dump(out, fout)
finalize_distributed()
'''


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _inputs(world):
    """Per-device trees: float leaves at three magnitudes (one whose size
    does not divide by the world, so the int8 tier pads), an integer
    count and an integer matrix."""
    rng = numpy.random.RandomState(11 + world)
    return {"w": (rng.randn(world, 37, 5) * 3).astype(numpy.float32),
            "b": (rng.randn(world, 7) * 1e-3).astype(numpy.float32),
            "big": (rng.randn(world, 64) * 1e4).astype(numpy.float32),
            "n": rng.randint(0, 100, (world,)).astype(numpy.int32),
            "cm": rng.randint(0, 9, (world, 3, 3)).astype(numpy.int32)}


def _dense_specs():
    leaves = (("w", "weights", "_velocity_w", False, True),
              ("b", "bias", "_velocity_b", True, False))
    return [{"kind": "dense", "activation": "tanh", "leaves": leaves,
             "has_params": True, "solver": "momentum"},
            {"kind": "dense", "activation": "linear", "leaves": leaves,
             "has_params": True, "solver": "momentum"}]


def _step_inputs(batch=64, in_f=24, hidden=16, classes=10):
    rng = numpy.random.RandomState(3)
    params, fan = [], in_f
    for width in (hidden, classes):
        w = (rng.randn(fan, width) * 0.1).astype(numpy.float32)
        params.append({"p": {"w": w, "b": numpy.zeros(width,
                                                      numpy.float32)},
                       "v": {"w": numpy.zeros_like(w),
                             "b": numpy.zeros(width, numpy.float32)}})
        fan = width
    hyper = numpy.asarray([0.05, 0.05, 0.0, 0.0, 0.9, 0.9, 0.999, 1e-8],
                          numpy.float32)
    return {"specs": _dense_specs(), "params": params,
            "hypers": [hyper, hyper],
            "data": rng.rand(batch, in_f).astype(numpy.float32),
            "labels": rng.randint(0, classes, batch).astype(numpy.int64)}


def _jax_reduces(world, tree):
    """JAX's reduce_sum / reduce_mean per tier, each device's result,
    and the int8 tier's first-stage codes and scale of ``w`` (the
    reference's formula, mapreduce.py:114-117)."""
    mesh = jbuild_mesh(devices=jax.devices()[:world], data=world)
    out = {}

    def run(body, args):
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                               out_specs=P("data")))
        return jax.tree.map(numpy.asarray, fn(args))

    for precision in PRECISIONS:
        for mean in (False, True):
            reducer = jmr.reduce_mean if mean else jmr.reduce_sum

            def body(t, reducer=reducer, precision=precision):
                local = jax.tree.map(lambda x: x[0], t)
                got = reducer(local, "data", precision=precision)
                return jax.tree.map(lambda x: x[None], got)
            out[precision, mean] = run(body, tree)

    def codes(w):
        flat = w[0].astype(jnp.float32).reshape(-1)
        flat = jnp.pad(flat, (0, (-flat.size) % world))
        amax = lax.pmax(jnp.max(jnp.abs(flat)), "data")
        scale = jnp.maximum(amax, jnp.float32(1e-30)) / 127.0
        quant = jnp.clip(jnp.round(flat / scale), -127.0, 127.0) \
            .astype(jnp.int8)
        return quant[None], scale[None]
    out["codes"] = run(codes, tree["w"])
    return out


def _jax_steps(world, step):
    """Three of JAX's ``fleet_train_step`` train steps from the same
    inputs, and its ReduceStats snapshot."""
    from veles_tpu.observe.xla_stats import get_compile_tracker
    mesh = jbuild_mesh(devices=jax.devices()[:world], data=world)
    tracker = get_compile_tracker()
    was_enabled, tracker.enabled = tracker.enabled, True
    stats = jmr.get_reduce_stats()
    stats.reset()
    try:
        train_step = jmr.fleet_train_step(
            mesh, step["specs"], "none", with_confusion=False,
            reduce_precision="f32")[0]
        params = jax.tree.map(jnp.asarray, step["params"])
        hypers = [jnp.asarray(h) for h in step["hypers"]]
        data = jnp.asarray(step["data"])
        labels = jnp.asarray(step["labels"].astype(numpy.int32))
        indices = jnp.arange(len(step["labels"]), dtype=jnp.int32)
        losses = []
        for _ in range(STEPS):
            params, (loss, n_err) = train_step(
                params, hypers, {}, data, labels, indices,
                numpy.float32(len(step["labels"])), numpy.int32(0))
            losses.append((float(loss), int(n_err)))
        return {"losses": losses, "stats": stats.snapshot(),
                "name": train_step.program_name,
                "params": [{k: numpy.asarray(v)
                            for k, v in layer["p"].items()}
                           for layer in params]}
    finally:
        tracker.enabled = was_enabled
        stats.reset()


@pytest.fixture(scope="module")
def worlds():
    """For each world size: (per-device inputs, JAX's results, each
    rank's results)."""
    import pickle
    step = _step_inputs()
    with tempfile.TemporaryDirectory() as directory:
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        started, trees = {}, {}
        for world in WORLDS:
            trees[world] = _inputs(world)
            sub = os.path.join(directory, "world%d" % world)
            os.makedirs(sub)
            inputs = os.path.join(sub, "inputs.pickle")
            with open(inputs, "wb") as fout:
                pickle.dump({"tree": trees[world], "step": step}, fout)
            cfg = {"world": world, "timeout": DEADLINE, "inputs": inputs,
                   "coordinator": "127.0.0.1:%d" % free_port(),
                   "out": os.path.join(sub, "rank%d.pickle")}
            path = os.path.join(sub, "config.json")
            with open(path, "w") as fout:
                json.dump(cfg, fout)
            started[world] = ([subprocess.Popen(
                [sys.executable, "-c", RANK, path, str(rank)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for rank in range(world)], cfg["out"])
        end = time.monotonic() + DEADLINE
        try:
            want = {world: (_jax_reduces(world, trees[world]),
                            _jax_steps(world, step)) for world in WORLDS}
            logs = {world: [proc.communicate(
                timeout=max(end - time.monotonic(), 0.1))[0]
                for proc in procs]
                for world, (procs, _) in started.items()}
        except subprocess.TimeoutExpired:
            pytest.fail("a world of ranks passed its %d s deadline"
                        % DEADLINE)
        finally:
            for procs, _ in started.values():
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
        out = {}
        for world, (procs, pattern) in started.items():
            for rank, proc in enumerate(procs):
                assert proc.returncode == 0, "world %d, rank %d:\n%s" % (
                    world, rank, logs[world][rank][-3000:])
            ranks = []
            for rank in range(world):
                with open(pattern % rank, "rb") as fin:
                    ranks.append(pickle.load(fin))
            out[world] = (trees[world], want[world], ranks)
    return out


@pytest.mark.parametrize("mean", [False, True], ids=["sum", "mean"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("world", WORLDS)
def test_reduce_matches_jax(worlds, world, precision, mean):
    tree, (want, _), ranks = worlds[world]
    for rank, got_all in enumerate(ranks):
        got = got_all[precision, mean]
        for key in tree:
            expect = want[precision, mean][key][rank]
            assert got[key].dtype == expect.dtype, key
            if key in ("n", "cm") or precision == "int8":
                # integers exact; the int8 tier bit for bit
                assert numpy.array_equal(got[key], expect), key
            else:
                eps = F32_EPS if precision == "f32" else BF16_EPS
                bound = ULPS * world * eps * numpy.abs(tree[key]).sum(0)
                if mean:
                    bound = bound / world
                assert (numpy.abs(got[key] - expect) <= bound).all(), key
        # every rank holds the same result
        for key in tree:
            assert numpy.array_equal(got[key],
                                     ranks[0][precision, mean][key])


@pytest.mark.parametrize("world", WORLDS)
def test_int8_codes_and_scale_bit_equal(worlds, world):
    """The int8 tier's first stage: the global scale (the MAX all-reduce
    of each rank's amax) and the int8 codes, bit-equal to the
    reference's formula on the same devices."""
    _, (want, _), ranks = worlds[world]
    codes, scale = want["codes"]
    for rank, got in enumerate(ranks):
        got_codes, got_scale = got["codes"]
        assert got_codes.dtype == numpy.int8
        assert numpy.array_equal(got_codes, codes[rank])
        assert got_scale.tobytes() == numpy.float32(scale[rank]).tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_fleet_train_step_matches_jax(worlds, world):
    """Three data-parallel train steps through ``fleet_train_step``: the
    losses and error counts, the weights, and the reduce plane's
    counters (steps and analytic wire bytes) as JAX's."""
    _, (_, want), ranks = worlds[world]
    for got in (rank["step"] for rank in ranks):
        assert got["name"] == want["name"] == "mapreduce.fleet_train_step"
        assert [n for _, n in got["losses"]] \
            == [n for _, n in want["losses"]]
        numpy.testing.assert_allclose([l for l, _ in got["losses"]],
                                      [l for l, _ in want["losses"]],
                                      rtol=1e-5)
        for tl, jl in zip(got["params"], want["params"]):
            for key in jl:
                numpy.testing.assert_allclose(tl[key], jl[key], atol=1e-6,
                                              rtol=0)
        assert got["stats"] == want["stats"]
        assert got["stats"]["f32"]["steps"] == STEPS
        assert got["idle"] is not None


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_wire_bytes_equal_jax(n, precision):
    tree = {"w": numpy.zeros((96, 32), numpy.float32),
            "b": numpy.zeros(33, numpy.float32),
            "h": numpy.zeros(5, numpy.float16),
            "n": numpy.zeros(16, numpy.int32)}
    want = jmr.reduce_wire_bytes(tree, n, precision)
    assert mr.reduce_wire_bytes(tree, n, precision) == want
    # torch leaves count as their numpy twins
    torch_tree = {k: torch.from_numpy(v) for k, v in tree.items()}
    assert mr.reduce_wire_bytes(torch_tree, n, precision) == want


def test_reduce_precision_of_and_bad_tier():
    assert mr.REDUCE_PRECISIONS == jmr.REDUCE_PRECISIONS
    for value in PRECISIONS:
        assert mr.reduce_precision_of(value) == value
    for fn in (mr.reduce_precision_of, jmr.reduce_precision_of):
        with pytest.raises(ValueError, match="--fleet-reduce"):
            fn("fp8")
    with pytest.raises(ValueError, match="fp8"):
        mr.reduce_sum({"x": torch.zeros(2)}, precision="fp8")
    tree = {"x": torch.ones(2)}
    assert mr.broadcast(tree) is tree


def test_reduce_stats_counters_equal_jax():
    """The same notes (explicit clock) give the same per-tier counters,
    idle fraction and published families, the cadence reset included."""
    notes = [("f32", 100, 0.5, 10.0), ("f32", 100, 0.5, 11.0),
             ("int8", 30, 0.25, 12.0), ("f32", 100, 0.5, 200.0),
             ("bf16", 50, 0.1, 200.5)]
    stats, jstats = mr.ReduceStats(), jmr.ReduceStats()
    assert stats.idle_fraction() is None
    for precision, wire, busy, now in notes:
        stats.note(precision, wire_bytes=wire, busy=busy, now=now)
        jstats.note(precision, wire_bytes=wire, busy=busy, now=now)
        assert stats.snapshot() == jstats.snapshot()
        assert stats.idle_fraction() == jstats.idle_fraction()
    registry, jregistry = (MetricsRegistry(enabled=True),
                           JMetricsRegistry(enabled=True))
    saved, jsaved = mr._stats, jmr._stats
    mr._stats, jmr._stats = stats, jstats
    try:
        mr.publish_reduce_stats(registry)
        jmr.publish_reduce_stats(jregistry)
    finally:
        mr._stats, jmr._stats = saved, jsaved
    rows = [line for line in registry.expose().splitlines()
            if line.startswith("veles_fleet")]
    jrows = [line for line in jregistry.expose().splitlines()
             if line.startswith("veles_fleet")]
    assert rows == jrows and len(rows) == 7
    stats.reset()
    assert stats.snapshot() == {} and stats.idle_fraction() is None
