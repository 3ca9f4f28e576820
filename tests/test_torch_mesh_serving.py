"""The port's sharded serving (veles_tpu_torch/parallel/tp_engine.py,
``serving.ContinuousDecoder(mesh=)``, ``GenerateAPI(mesh=)``,
``build_serve_mesh``) against the JAX package's on the CPU.

Mirrors tests/test_mesh_serving.py, tests/test_paged.py::TestPagedMesh,
tests/test_deploy.py::TestSwapReshardSeam and the mesh bundle of
tests/test_aot.py. The port's side is a gloo world of 2 and of 4
``python -c`` ranks (tests/torch_world.py; one world a size runs every
case and pickles its results): rank 0 drives the decoders and the HTTP
front, every other rank follows (``tp_engine.follow``, or its own
``GenerateAPI.start()``). The JAX package's sharded engine runs in this
process over ``build_mesh(devices=jax.devices()[:n], data=1, model=n)``
of the 8 virtual devices, on the same weights (made once with numpy) and
the same drives. Greedy f32 streams must be token-equal to the JAX
package's sharded streams and to the port's single-device decoder; the
logits after a prefill agree within :data:`LOGIT_TOL` of the largest
(f32 sums split over the ranks and reassociated); every rank holds H/n
heads of the KV, and its control state stays bit-equal to rank 0's."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.parallel.mesh import build_mesh as jbuild_mesh
from veles_tpu.parallel.transformer_step import \
    init_transformer_params as jinit
from veles_tpu.serving import ContinuousDecoder as JDecoder
from veles_tpu_torch.parallel.mesh import Mesh
from veles_tpu_torch.parallel.transformer_step import \
    init_transformer_params as tinit
from veles_tpu_torch.serving import (ContinuousDecoder, GenerateAPI,
                                     build_serve_mesh)

from torch_world import (BLOCKS, EMBED, HEADS, REPO, TIERS, VOCAB,
                         _prompts, as_torch, drive, free_port, join_world,
                         start_world)

torch.set_num_threads(1)

#: f32 logits after a prefill, against the largest: the products split
#: over n ranks and their sums reassociate (a few ulp of values ~1)
LOGIT_TOL = 1e-5
DEADLINE = 120
#: the tiers held against the JAX package's sharded engine at n = 4 too
#: (n = 2 holds every tier; each JAX layout compiles its own programs)
JAX_AT_4 = ("dense", "paged-int8kv")


RANK = r'''
import threading, time, urllib.request
from veles_tpu_torch.aot.artifact import build_serving_bundle
from veles_tpu_torch.aot.loader import load_bundle
from veles_tpu_torch.core.config import root
from veles_tpu_torch.parallel import tp_engine
from veles_tpu_torch.serving import (ContinuousDecoder, GenerateAPI,
                                     build_serve_mesh)
from torch_world import (HEADS, TIERS, PAGED, _prompts, drive, as_torch,
                         post)
n = cfg["world"]
mesh = build_mesh(data=1, model=n)
params, table = as_torch(inputs["params"]), torch.from_numpy(inputs["table"])
params2 = as_torch(inputs["params2"])
def control(state):
    return {k: state[k].numpy().copy() for k in ("lengths", "step",
                                                 "logits", "req_key")}
def local(state):
    return {k: tuple(state[k].shape) for k in state}
def follow(p=params):
    got = tp_engine.follow(mesh, p, table, HEADS, device="cpu")
    out.setdefault("follow", []).append(
        {"control": control(got["engine"].state),
         "shapes": local(got["engine"].state), "calls": got["calls"]})
def lead(dec):
    out.setdefault("lead", []).append(
        {"control": control(dec.state), "shapes": local(dec.state)})
    dec.close()
# 1. every tier's composite drive, and the logits after a first prefill
for tier, kw in TIERS.items():
    if rank:
        follow(); follow()
        continue
    paged = bool(kw.get("paged"))
    single = ContinuousDecoder(params, table, HEADS, device="cpu", **kw)
    ref = drive(single, _prompts(tier), paged)
    dec = ContinuousDecoder(params, table, HEADS, mesh=mesh, device="cpu",
                            **kw)
    got = drive(dec, _prompts(tier), paged)
    out[tier] = {"single": ref, "mesh": got,
                 "counts": dict(dec.dispatch_counts),
                 "single_counts": dict(single.dispatch_counts),
                 "tp": dec.tp_stats()}
    lead(dec)
    pre = []
    for m in (None, mesh):
        d = ContinuousDecoder(params, table, HEADS, mesh=m, device="cpu",
                              **kw)
        for p in _prompts(tier)[:2]:
            d.submit(p)
        d._admit_pending()
        pre.append(d.state["logits"].numpy().copy())
        if m is not None:
            lead(d)
    out[tier]["prefill"] = pre
# 2. a swap onto the mesh: slice-only, then the new weights' streams
if rank:
    follow()
else:
    dec = ContinuousDecoder(params, table, HEADS, mesh=mesh, device="cpu",
                            slots=2, max_len=32, n_tokens=5)
    before = dec.last_swap_stats
    old = dec.swap_params(params2)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [2, 2]]
    for p in prompts:
        dec.submit(p)
    dec.run_until_drained(chunk=2)
    single = ContinuousDecoder(params2, table, HEADS, device="cpu",
                               slots=2, max_len=32, n_tokens=5)
    for p in prompts:
        single.submit(p)
    single.run_until_drained(chunk=2)
    out["swap"] = {"before": before, "stats": dec.last_swap_stats,
                   "mesh": dict(dec.results), "single": dict(single.results),
                   "old_is_whole": old[0]["head"].shape[1] == table.shape[0]}
    lead(dec)
# 3. a mesh AOT bundle boots with every dispatch a hit
if rank:
    follow()
else:
    path = cfg["dir"] + "/mesh.aot.tar"
    kw = dict(slots=2, max_len=64, n_tokens=5, tile=16)
    build_serving_bundle(params, table, HEADS, path, chunk=4, mesh=mesh,
                         buckets=[16], device="cpu", **kw)
    aot = load_bundle(path, mesh=mesh, prefetch=False, device="cpu")
    dec = ContinuousDecoder(params, table, HEADS, mesh=mesh, aot=aot,
                            device="cpu", **kw)
    live = ContinuousDecoder(params, table, HEADS, device="cpu", **kw)
    got = []
    for d in (live, dec):
        for p in _prompts("dense")[:3]:
            d.submit(p)
        d.run_until_drained(chunk=4)
        got.append(dict(d.results))
    out["aot"] = {"live": got[0], "mesh": got[1], "active": dec.aot_active,
                  "stats": aot.stats()}
    lead(dec)
# 4. GenerateAPI over HTTP; a breaker trip; the metrics
if rank:
    api = GenerateAPI(params, table, HEADS, device="cpu", mesh=mesh,
                      chunk=4, rebuild_backoff=0.01, **PAGED).start()
    out["api_follow"] = {k: v for k, v in api.follow_stats.items()
                         if k != "engine"}
    out["api_follow"]["in_service"] = api.follow_stats["engine"].engine_id
else:
    api = GenerateAPI(params, table, HEADS, device="cpu", mesh=mesh,
                      chunk=4, rebuild_backoff=0.01, **PAGED).start()
    try:
        prompts = [p.tolist() for p in _prompts("paged")]
        first = [post(api.port, p) for p in prompts]
        # a rollout over the mesh: green (params2, carried by its build)
        # passes its probe on every rank; blue's breaker trip then aborts
        # it, and every rank drops green's engine
        rollout = api.begin_rollout(params2)
        out["rollout"] = {"started": rollout.state,
                          "green": api._green is not None}
        api.request_trip("test trip")
        deadline = time.monotonic() + 60
        while api.health.counter("rebuilds") < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        again = [post(api.port, p) for p in prompts]
        with urllib.request.urlopen("http://127.0.0.1:%d/metrics"
                                    % api.port, timeout=30) as resp:
            metrics = resp.read().decode()
        out["rollout"].update(state=rollout.state,
                              green_after=api._green is not None)
        out["api"] = {"first": first, "again": again,
                      "rebuild": dict(api.last_rebuild or {}),
                      "rebuilds": api.health.counter("rebuilds"),
                      "pool": api.decoder.pool.snapshot(),
                      "metrics": metrics}
    finally:
        api.stop()
# 6. train -> serve: the transformer step over the model=n mesh (which
# replicates it), the reshard into the serving layout and back, and the
# trained weights served over the mesh
from veles_tpu_torch.parallel import decode as tdecode, reshard as trs
from veles_tpu_torch.parallel.mesh import PartitionSpec
from veles_tpu_torch.parallel.transformer_step import (
    build_transformer_train_step)
from veles_tpu_torch.device import tree_leaves_with_path
trans = inputs["transition"]
step = build_transformer_train_step(HEADS, mesh=mesh, learning_rate=0.05)
trained, losses = as_torch(trans["params"]), []
for _ in range(3):
    trained, (loss, _) = step(trained, torch.from_numpy(trans["x"]),
                              torch.from_numpy(trans["labels"]))
    losses.append(float(loss))
packed = tdecode.repack_slot_params(trained, HEADS)
specs = tdecode.slot_param_specs(packed)
served, to_serve = trs.reshard(packed, mesh, specs, label="train_to_serve")
back, to_train = trs.reshard(served, mesh, PartitionSpec(), specs,
                             label="serve_to_train")
gathered = tdecode.local_from_packed(back)
out["transition"] = {
    "losses": losses, "to_serve": to_serve["bytes"],
    "to_train": to_train["bytes"],
    "exact": all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_path(packed), tree_leaves_with_path(back))),
    "params": [t.numpy() for _, t in tree_leaves_with_path(gathered)]}
table2 = torch.from_numpy(trans["table"])
kw = dict(slots=2, max_len=64, n_tokens=5)
if rank:
    got = tp_engine.follow(mesh, trained, table2, HEADS, device="cpu")
    out["transition"]["followed"] = got["calls"]
else:
    dec = ContinuousDecoder(trained, table2, HEADS, mesh=mesh, device="cpu",
                            **kw)
    one = ContinuousDecoder(gathered, table2, HEADS, device="cpu", **kw)
    for d in (dec, one):
        for p in trans["prompts"]:
            d.submit(p)
        d.run_until_drained(chunk=4)
    out["transition"].update(mesh_streams=dict(dec.results),
                             single_streams=dict(one.results))
    dec.close()
# 5. the serve mesh ignores a training mesh config
root.common.mesh.axes.data = 2
serve = build_serve_mesh("model=%d" % n)
root.common.mesh.axes.data = 1
out["serve_mesh"] = dict(serve.shape)
finish()
'''


def _model(seed):
    rng = numpy.random.RandomState(seed)
    params = jinit(rng, BLOCKS, EMBED, HEADS, VOCAB)
    table = (rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.3)
    return jax.tree.map(numpy.asarray, params), table


def _transition_inputs():
    """test_mesh_serving.py:253-304's draws: the model, its table, the
    tokens it trains on and the prompts it then serves."""
    rng = numpy.random.RandomState(7)
    params = jax.tree.map(numpy.asarray, jinit(rng, BLOCKS, EMBED, HEADS,
                                               VOCAB))
    table = rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.3
    x = rng.randn(4, 8, EMBED).astype(numpy.float32)
    labels = rng.randint(0, VOCAB, (4, 8))
    prompts = [rng.randint(0, VOCAB, n) for n in (5, 8, 3)]
    return {"params": params, "table": table, "x": x, "labels": labels,
            "prompts": prompts}


def _jax_transition(trans, n):
    """The JAX package's side: three steps of its transformer step over a
    mesh of model=n (which its shard_map replicates), then its
    single-device decoder's streams of the prompts."""
    from veles_tpu.parallel.transformer_step import \
        build_transformer_train_step as jstep
    mesh = jbuild_mesh(devices=jax.devices()[:n], data=1, model=n)
    step = jstep(HEADS, mesh=mesh, learning_rate=0.05)
    params, losses = jax.tree.map(jnp.asarray, trans["params"]), []
    for _ in range(3):
        params, (loss, _) = step(params, jnp.asarray(trans["x"]),
                                 jnp.asarray(trans["labels"]))
        losses.append(float(loss))
    dec = JDecoder(params, jnp.asarray(trans["table"]), HEADS, slots=2,
                   max_len=64, n_tokens=5)
    for p in trans["prompts"]:
        dec.submit(p)
    dec.run_until_drained(chunk=4)
    return {"losses": losses, "streams": dict(dec.results),
            "params": [numpy.asarray(a) for a in jax.tree.leaves(params)]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, started at once; the JAX package's sharded drives run
    here meanwhile. Returns (jax streams and logits, results by size)."""
    params, table = _model(0)
    params2, _ = _model(99)
    inputs = {"params": params, "table": table, "params2": params2,
              "transition": _transition_inputs()}
    started = {}
    for n in (2, 4):
        directory = str(tmp_path_factory.mktemp("serve%d" % n))
        started[n] = start_world(RANK, n, directory, inputs,
                                 extra={"dir": directory}, timeout=60)
    theirs = {}
    jtable = jnp.asarray(table)
    for n in (2, 4):
        jmesh = jbuild_mesh(devices=jax.devices()[:n], data=1, model=n)
        for tier, kw in TIERS.items():
            if n == 4 and tier not in JAX_AT_4:
                continue
            dec = JDecoder(params, jtable, HEADS, mesh=jmesh, **kw)
            theirs[tier, n] = {"streams": drive(dec, _prompts(tier),
                                                bool(kw.get("paged")))}
            pre = JDecoder(params, jtable, HEADS, mesh=jmesh, **kw)
            for p in _prompts(tier)[:2]:
                pre.submit(p)
            pre._admit_pending()
            theirs[tier, n]["prefill"] = numpy.asarray(
                pre.state["logits"])
        theirs["transition", n] = _jax_transition(inputs["transition"], n)
    results = {n: join_world(s, DEADLINE)[0] for n, s in started.items()}
    return theirs, results


CASES = [(tier, n) for n in (2, 4) for tier in TIERS]


@pytest.mark.parametrize("tier,n", CASES)
def test_streams_equal_jax_sharded_and_single(worlds, tier, n):
    """The acceptance composite in every tier of the slab and the pool:
    the mesh's greedy streams equal the port's single-device decoder's
    and the JAX package's sharded engine's, token for token; the pool's
    page-aligned prompt re-admits as a zero-prefill hit."""
    theirs, results = worlds
    got = results[n][0][tier]
    assert got["mesh"] == got["single"]
    if (tier, n) in theirs:
        assert got["mesh"] == {int(k): v for k, v
                               in theirs[tier, n]["streams"].items()}
    else:
        assert got["mesh"] == {int(k): v for k, v
                               in theirs[tier, 2]["streams"].items()}
    if TIERS[tier].get("paged"):
        assert got["counts"]["admit_hit"] == 1
        assert got["mesh"][3] == got["mesh"][0]


@pytest.mark.parametrize("tier,n", CASES)
def test_prefill_logits_within_tolerance(worlds, tier, n):
    """The logits after a first admission's prefill agree with the
    single device's and the JAX package's within LOGIT_TOL of the
    largest."""
    theirs, results = worlds
    single, mesh = results[n][0][tier]["prefill"]
    jax_logits = theirs.get((tier, n), theirs[tier, 2])["prefill"]
    scale = numpy.abs(single).max()
    for other in (single, jax_logits):
        assert numpy.abs(mesh - other).max() <= LOGIT_TOL * scale


@pytest.mark.parametrize("n", [2, 4])
def test_every_rank_holds_its_heads_and_the_same_control(worlds, n):
    """Each rank's slab or pool holds H/n heads (the int8 scales too),
    its control rows (lengths, step, logits, keys) are bit-equal to rank
    0's after every stream, and the admissions and chunks are the single
    device's (one admit a prompt-bucket group: no per-request
    dispatches)."""
    _, results = worlds
    lead = results[n][0]["lead"]
    for rank in range(1, n):
        follow = results[n][rank]["follow"]
        assert len(follow) == len(lead)
        for mine, theirs in zip(follow, lead):
            assert mine["shapes"] == theirs["shapes"]
            for key, value in theirs["control"].items():
                numpy.testing.assert_array_equal(mine["control"][key],
                                                 value, err_msg=key)
    for entry in lead:
        shapes = entry["shapes"]
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in shapes:
                axis = 2 if ("k_scale" in shapes or name.endswith(
                    "scale")) else 3
                assert shapes[name][axis] == HEADS // n, (name, shapes)
    for tier in TIERS:
        got = results[n][0][tier]
        for key in ("admit", "chunk", "admit_requests"):
            assert got["counts"][key] == got["single_counts"][key]
        handed = got["tp"]["handoff"]["calls"]
        assert handed["build"] >= 1
        assert got["tp"]["collectives"]["reduce"][0] > 0


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_swap_is_slice_only_zero_wire_bytes(worlds, n):
    """A host checkpoint swapped onto the live mesh moves 0 bytes on the
    wire (test_deploy.py:420-460): replicated to sharded is slices; the
    swapped engine streams as a fresh single device on the new weights,
    and the stash it hands back is the whole old weights."""
    _, results = worlds
    swap = results[n][0]["swap"]
    assert swap["before"] is None
    assert swap["stats"]["bytes"] == 0
    assert set(swap["stats"]["counts"]) <= {"slice", "keep"}
    assert swap["mesh"] == swap["single"]
    assert swap["old_is_whole"]


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_aot_bundle_boots_every_dispatch_a_hit(worlds, n):
    """A bundle built for the mesh boots rank 0's decoder with its
    geometry matched: every dispatch a hit, none a miss, and the streams
    the live engine's (test_aot.py:265-290)."""
    _, results = worlds
    aot = results[n][0]["aot"]
    assert aot["active"]
    assert aot["mesh"] == aot["live"]
    assert sum(aot["stats"]["misses"].values()) == 0
    assert aot["stats"]["hits"].get("decode.dispatch", 0) > 0
    assert aot["stats"]["hits"].get("decode.admit", 0) > 0


@pytest.mark.parametrize("n", [2, 4])
def test_generate_api_and_breaker_over_the_mesh(worlds, n):
    """GenerateAPI(mesh=) answers over HTTP with the single device's
    tokens; a breaker trip rebuilds every rank's engine, restores the
    prefix pages by copy, and streams as the fault-free run; /metrics
    carries the hand-off and collective counters; a blue-green rollout
    runs over the mesh (green built from the weights its build carries
    and probed on every rank) until the trip aborts it; the follower's
    GenerateAPI ran until rank 0's end, holding the rebuilt engine
    alone."""
    _, results = worlds
    api = results[n][0]["api"]
    single = results[n][0]["paged"]["single"]
    assert api["first"] == [single[0], single[1], single[2]]
    assert api["again"] == api["first"]
    assert api["rebuilds"] == 1
    assert api["rebuild"]["restored_pages"] > 0
    assert api["pool"]["prefix_hits"] > 0
    for name in ("veles_tp_handoff_bytes_total",
                 "veles_tp_collective_seconds_total",
                 "veles_tp_handoff_calls_total"):
        assert name in api["metrics"]
    assert results[n][0]["rollout"] == {
        "started": "shifting", "green": True, "state": "rolled_back",
        "green_after": False}
    for rank in range(1, n):
        follow = results[n][rank]["api_follow"]
        calls = follow["calls"]
        # the first engine, green and the rebuild; green and the first
        # dropped, the rebuild installed
        assert calls["build"] == 3 and calls["end"] == 1
        assert calls["discard"] == 2 and calls["install"] == 1
        assert calls["capture"] == 1 and calls["restore"] == 1
        assert follow["engines"] == [follow["in_service"]]
        assert [e["edge"] for e in follow["edges"]] == ["breaker_rebuild"]
        assert not any(e["leak"] for e in follow["edges"])


@pytest.mark.parametrize("n", [2, 4])
def test_serve_mesh_ignores_training_mesh_config(worlds, n):
    """A training ``data=2`` never leaks into ``--serve-mesh model=n``
    (test_mesh_serving.py:217-235), inside the world on every rank."""
    _, results = worlds
    for got in results[n]:
        assert got["serve_mesh"]["model"] == n
        assert got["serve_mesh"]["data"] == 1


@pytest.mark.parametrize("n", [2, 4])
def test_train_reshard_serve_transition(worlds, n):
    """TestTrainServeTransition: the transformer step trains over the
    model=n mesh (replicated, the JAX package's three steps within its
    tolerances and every rank's weights the same bits), reshards into
    the serving layout moving 0 bytes, serves over the mesh with the
    streams of one process's decoder fed the gathered weights (and of the
    JAX package's), and reshards back bit-equal."""
    theirs, results = worlds
    want = theirs["transition", n]
    lead = results[n][0]["transition"]
    assert lead["losses"] == pytest.approx(want["losses"], rel=1e-5)
    for rank in range(n):
        got = results[n][rank]["transition"]
        assert got["to_serve"] == 0 and got["to_train"] > 0
        assert got["exact"]
        for a, b in zip(got["params"], lead["params"]):
            numpy.testing.assert_array_equal(a, b)
    for a, b in zip(lead["params"], want["params"]):
        numpy.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert lead["mesh_streams"] == lead["single_streams"]
    assert lead["mesh_streams"] == {int(k): list(map(int, v))
                                    for k, v in want["streams"].items()}
    for rank in range(1, n):
        assert results[n][rank]["transition"]["followed"]["build"] == 1


def test_serve_mesh_config_string():
    """build_serve_mesh: bad specs fail naming the flag, the device-count
    check blames the serve knob, empty means one device."""
    from veles_tpu.serving import build_serve_mesh as jbuild_serve_mesh

    assert build_serve_mesh(None) is None and build_serve_mesh("") is None
    for bad, match in (("bogus=2", "serve-mesh"), ("model=x", "serve-mesh"),
                       ("model=3", "serve.mesh")):
        with pytest.raises(ValueError, match=match):
            build_serve_mesh(bad)
        with pytest.raises(ValueError, match=match):
            jbuild_serve_mesh(bad)
    assert dict(build_serve_mesh("model=1").shape)["model"] == 1


def test_rejects_indivisible_heads_and_later_paths():
    """A 3-way model axis cannot split 8 heads: the JAX package's error;
    a governor over a mesh is refused no more: the constructor goes on to
    the mesh decoder's build, which wants the mesh's world (the governor
    over a world: tests/test_torch_mesh_governor.py)."""
    params = as_torch(_model(0)[0])
    table = torch.from_numpy(_model(0)[1])
    with pytest.raises(ValueError, match="divisible"):
        ContinuousDecoder(params, table, HEADS, mesh=Mesh({"model": 3}),
                          device="cpu")
    with pytest.raises(ValueError, match="process group"):
        GenerateAPI(params, table, HEADS, mesh=Mesh({"model": 2}),
                    governor=object(), device="cpu")


#: the workflow file the CLI world runs on every rank: the same program,
#: rank 0 serving and answering its own requests, the others following
CLI_WORKFLOW = r'''
import json, sys, numpy, torch
sys.path.insert(0, %(tests)r)
from torch_world import post
from veles_tpu_torch.core.config import root
from veles_tpu_torch.parallel.transformer_step import init_transformer_params
from veles_tpu_torch.serving import GenerateAPI

def run(load, main):
    torch.set_num_threads(1)
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, 2, 32, 8, 16, device="cpu")
    table = torch.from_numpy(rng.randn(16, 32).astype(numpy.float32) * .3)
    api = GenerateAPI(params, table, 8, slots=2, max_len=32, n_tokens=4,
                      chunk=2, device="cpu").start()
    if api.follower:
        return
    try:
        got = [post(api.port, p) for p in ([1, 2, 3], [4, 5, 6, 7, 8])]
        with open(%(out)r, "w") as fout:
            json.dump({"tokens": got, "mesh": dict(api.mesh.shape)}, fout)
    finally:
        api.stop()
'''


def test_cli_serve_mesh_two_process_world(tmp_path):
    """``--serve-mesh model=2`` with ``--coordinator/--num-processes/
    --process-id``: each rank joins the world, rank 0 serves (its
    tokens the single device's), rank 1 follows and exits 0 at rank 0's
    end."""
    out = str(tmp_path / "tokens.json")
    wf = tmp_path / "wf.py"
    wf.write_text(CLI_WORKFLOW % {"tests": os.path.dirname(
        os.path.abspath(__file__)), "out": out})
    coordinator = "127.0.0.1:%d" % free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", str(wf), "-",
         "root.common.mesh.timeout=60", "--device", "cpu",
         "--serve-mesh", "model=2", "--coordinator", coordinator,
         "--num-processes", "2", "--process-id", str(rank)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=90)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
    got = json.load(open(out))
    assert got["mesh"]["model"] == 2
    params = tinit(numpy.random.RandomState(0), 2, 32, 8, 16, device="cpu")
    rng = numpy.random.RandomState(0)
    tinit(rng, 2, 32, 8, 16, device="cpu")
    table = torch.from_numpy(rng.randn(16, 32).astype(numpy.float32) * .3)
    ref = ContinuousDecoder(params, table, 8, slots=2, max_len=32,
                            n_tokens=4, device="cpu")
    for p in ([1, 2, 3], [4, 5, 6, 7, 8]):
        ref.submit(p)
    ref.run_until_drained(chunk=2)
    assert got["tokens"] == [ref.results[0], ref.results[1]]


KILL_RANK = r'''
import os, signal, time
from veles_tpu_torch.serving import GenerateAPI
from torch_world import as_torch, post
mesh = build_mesh(data=1, model=2)
params, table = as_torch(inputs["params"]), torch.from_numpy(inputs["table"])
api = GenerateAPI(params, table, 8, slots=2, max_len=32, n_tokens=4,
                  chunk=2, device="cpu", mesh=mesh)
if rank:
    with open(cfg["dir"] + "/follower.pid", "w") as fout:
        fout.write(str(os.getpid()))
    api.start()
else:
    api.start()
    out["first"] = post(api.port, [1, 2, 3])
    with open(cfg["dir"] + "/served", "w") as fout:
        fout.write("1")
    while not os.path.exists(cfg["dir"] + "/killed"):
        time.sleep(0.05)
    started = time.monotonic()
    try:
        post(api.port, [4, 5, 6], timeout=60)
        out["after"] = "answered"
    except urllib.error.HTTPError as exc:
        out["after"] = exc.code
    out["seconds"] = time.monotonic() - started
    save()
    api.stop()
    os._exit(0)
'''


def test_killed_follower_gives_503_not_a_hang(tmp_path):
    """A follower killed with SIGKILL under traffic: rank 0's next
    request fails its collective, the breaker trips and sheds with a
    retryable 503 well inside the world's timeout; nothing hangs."""
    params, table = _model(0)
    directory = str(tmp_path)
    started = start_world("import urllib.error\n" + KILL_RANK, 2,
                          directory, {"params": params, "table": table},
                          extra={"dir": directory}, timeout=30)
    deadline = time.monotonic() + 60
    while not os.path.exists(os.path.join(directory, "served")):
        assert time.monotonic() < deadline, "rank 0 never served"
        assert started[0][0].poll() is None, started[0][0].communicate()
        time.sleep(0.05)
    with open(os.path.join(directory, "follower.pid")) as fin:
        os.kill(int(fin.read()), signal.SIGKILL)
    with open(os.path.join(directory, "killed"), "w") as fout:
        fout.write("1")
    results, logs = join_world(started, 60, check=False)
    leader = results[0]
    if leader is not None:
        assert leader["after"] == 503, logs[0][-3000:]
        assert leader["seconds"] < 30
    else:
        assert started[0][0].returncode != 0
