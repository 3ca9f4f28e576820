"""The serving governor's tier ladder and the blue-green rollout over a
serving mesh (``GenerateAPI(mesh=, governor=)``, ``begin_rollout`` on a
mesh; ``parallel/tp_engine.follow``'s engines named by id), against one
process and the JAX package on the CPU.

A gloo world of 2 ``python -c`` ranks (tests/torch_world.py, under its
deadline): rank 0 serves the paged float tier behind a governor whose
burn the test scripts (a stub SLO engine), rank 1 follows. The governor
walks bf16 -> int8 -> int8-kv -> int8 -> bf16; at every rung the streams
of three prompts posted one at a time must equal one process's decoder
fixed at that tier and the JAX package's. Then a rollout to new weights
(carried by green's build) is promoted, and the streams are the new
weights' in one process; then a second rollout whose green probe is
planted to fail leaves blue serving the same streams. Rank 1 must have
built, installed and discarded an engine for each move and hold one
engine at the end, and neither rank's memscope may read the promote as
a leak."""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.parallel.transformer_step import \
    init_transformer_params as jinit
from veles_tpu.serving import ContinuousDecoder as JDecoder

from torch_world import (BLOCKS, EMBED, HEADS, PAGED, VOCAB, join_world,
                         start_world)

torch.set_num_threads(1)

DEADLINE = 150
#: the governor's moves, and the tier each lands on
MOVES = [("demote", "int8"), ("demote", "int8-kv"), ("promote", "int8"),
         ("promote", "bf16")]

RANK = r'''
import time
from veles_tpu_torch.observe.governor import GovernorConfig, ServingGovernor
from veles_tpu_torch.observe.memscope import get_memscope
from veles_tpu_torch.rollout import RolloutConfig
from veles_tpu_torch.serving import ContinuousDecoder, GenerateAPI
from torch_world import HEADS, PAGED, as_torch, post
n = cfg["world"]
mesh = build_mesh(data=1, model=n)
params, table = as_torch(inputs["params"]), torch.from_numpy(inputs["table"])
params2, params3 = as_torch(inputs["params2"]), as_torch(inputs["params3"])
prompts = [list(map(int, p)) for p in inputs["prompts"]]
if rank:
    api = GenerateAPI(params, table, HEADS, device="cpu", mesh=mesh,
                      chunk=4, **PAGED).start()
    got = api.follow_stats
    out["follow"] = {"calls": got["calls"], "engines": got["engines"],
                     "in_service": got["engine"].engine_id,
                     "edges": got["edges"]}
    finish()


class BurnSLO:
    """The governor's burn sensor, scripted by the test."""
    burn = None

    def summary(self):
        if self.burn is None:
            return None
        return {"burn_rate": self.burn, "objective": "ttft_p95_ms",
                "window": "2s"}

    def record(self, **kwargs):
        pass

    def publish(self, registry):
        pass

    def version_burn(self, version, now=None):
        return None


class ProbeFault:
    """A chaos hook that fails the next probe decode once armed (a probe
    passes no decoder), before its first dispatch is handed on."""
    armed = False

    def before_step(self, decoder=None):
        if decoder is None and self.armed:
            self.armed = False
            raise RuntimeError("planted green probe fault")

    def maybe_poison_swap(self, params):
        return params


def wait(predicate, what, timeout=60):
    end = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > end:
            raise AssertionError("timed out waiting for " + what)
        time.sleep(0.01)


def single(weights, quantize):
    dec = ContinuousDecoder(weights, table, HEADS, device="cpu",
                            quantize=quantize, **PAGED)
    streams = []
    for p in prompts:
        rid = dec.submit(p)
        dec.run_until_drained()
        streams.append(list(map(int, dec.results.pop(rid))))
    return streams


slo, chaos = BurnSLO(), ProbeFault()
governor = ServingGovernor(GovernorConfig(
    demote_burn=2.0, recover_burn=1.0, cooldown_s=0.3, interval_s=0.01,
    ladder=("int8", "int8-kv"), breaker_guard=False, prewarm=False))
api = GenerateAPI(params, table, HEADS, device="cpu", mesh=mesh, chunk=4,
                  governor=governor, slo=slo, chaos=chaos, **PAGED).start()
rungs = []
try:
    rungs.append(("bf16", [post(api.port, p) for p in prompts]))
    for burn, tier in ((3.0, "int8"), (3.0, "int8-kv"), (0.5, "int8"),
                       (0.5, "bf16")):
        level = governor.level
        slo.burn = burn
        wait(lambda: governor.level != level, "the governor's move")
        slo.burn = None
        wait(lambda: (api.decoder.quantize or "bf16") == tier
             and api._tier_request is None, "the swap to " + tier)
        rungs.append((tier, [post(api.port, p) for p in prompts]))
    moves = [(t["action"], t["tier"]) for t in governor.transitions
             if t["action"] in ("demote", "promote")]
    rollout = api.begin_rollout(params2, version="v2", config=RolloutConfig(
        steps=(1.0,), hold_s=0.0, cooldown_s=0.0, min_requests=1,
        interval_s=0.01, ttft_floor_s=60.0))
    # every request is green's at the one rung: one answered makes the
    # verdict that promotes (no blue TTFT to hold green's against: the
    # TTFT predicate's floor sits past a loaded host's mesh request)
    end = time.monotonic() + 60
    while rollout.state != "promoted":
        assert time.monotonic() < end, "no promote: " + rollout.state
        post(api.port, prompts[2])
    promoted = [post(api.port, p) for p in prompts]
    chaos.armed = True
    try:
        api.begin_rollout(params3, version="v3")
        refused = None
    except RuntimeError as exc:
        refused = str(exc)
    after = [post(api.port, p) for p in prompts]
    verdicts = [(v["edge"], v["leak"]) for v in get_memscope().edges]
    out["lead"] = {
        "rungs": rungs, "moves": moves, "promoted": promoted,
        "rollout": rollout.state, "refused": refused, "after": after,
        "version": api.version, "green": api._green is not None,
        "tier_swaps": len(api.tier_swaps), "verdicts": verdicts,
        "single": {tier: single(params, None if tier == "bf16" else tier)
                   for tier in ("bf16", "int8", "int8-kv")},
        "single_v2": single(params2, None)}
finally:
    api.stop()
finish()
'''


def _model(seed):
    rng = numpy.random.RandomState(seed)
    params = jinit(rng, BLOCKS, EMBED, HEADS, VOCAB)
    table = rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.3
    return jax.tree.map(numpy.asarray, params), table


def _jax_streams(params, table, quantize, prompts):
    dec = JDecoder(jax.tree.map(jnp.asarray, params), jnp.asarray(table),
                   HEADS, quantize=quantize, **PAGED)
    streams = []
    for p in prompts:
        rid = dec.submit(p)
        dec.run_until_drained()
        streams.append(list(map(int, dec.results.pop(rid))))
    return streams


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of 2, started first; the JAX package's streams at each
    tier run here meanwhile."""
    params, table = _model(0)
    params2, _ = _model(99)
    params3, _ = _model(5)
    rng = numpy.random.RandomState(8)
    prompts = [rng.randint(0, VOCAB, n) for n in (16, 11, 5)]
    started = start_world(RANK, 2, str(tmp_path_factory.mktemp("gov")),
                          {"params": params, "table": table,
                           "params2": params2, "params3": params3,
                           "prompts": prompts}, timeout=60)
    theirs = {tier: _jax_streams(params, table,
                                 None if tier == "bf16" else tier, prompts)
              for tier in ("bf16", "int8", "int8-kv")}
    theirs["v2"] = _jax_streams(params2, table, None, prompts)
    results, _ = join_world(started, DEADLINE)
    return theirs, results


def test_ladder_moves_and_streams_over_the_mesh(world):
    """The governor walks the ladder down and back over the mesh, one
    tier swap a move; every rung's streams equal one process's decoder
    at that tier and the JAX package's, token for token."""
    theirs, results = world
    lead = results[0]["lead"]
    assert lead["moves"] == MOVES
    assert lead["tier_swaps"] == 4
    assert [tier for tier, _ in lead["rungs"]] == [
        "bf16", "int8", "int8-kv", "int8", "bf16"]
    for tier, streams in lead["rungs"]:
        assert streams == lead["single"][tier] == theirs[tier], tier


def test_rollout_promotes_over_the_mesh(world):
    """A blue-green rollout to new weights (which ride green's build to
    the follower) is promoted: the streams are then one process's on the
    new weights (and the JAX package's), and memscope's promote edge on
    rank 0 reads no leak."""
    theirs, results = world
    lead = results[0]["lead"]
    assert lead["rollout"] == "promoted"
    assert lead["promoted"] == lead["single_v2"] == theirs["v2"]
    assert ("rollout_promote", False) in lead["verdicts"]
    assert all(not leak for edge, leak in lead["verdicts"]
               if edge == "rollout_promote")


def test_failed_green_probe_rolls_back_leaving_one_engine(world):
    """A second rollout whose green probe is planted to fail is refused:
    blue serves on with its streams unchanged, and rank 1, which built
    green's engine, drops it and ends holding the one engine in service.
    Its engine events add up: a build and a discard for each tier swap,
    green's build and install and blue's discard for the promote, and the
    refused green's build and discard."""
    _, results = world
    lead, follow = results[0]["lead"], results[1]["follow"]
    assert "green build/probe refused" in lead["refused"]
    assert "planted green probe fault" in lead["refused"]
    assert lead["after"] == lead["promoted"]
    assert lead["version"] == "v2" and not lead["green"]
    calls = follow["calls"]
    assert calls["build"] == 1 + 4 + 2
    assert calls["install"] == 4 + 1
    assert calls["discard"] == 4 + 1 + 1
    assert calls["end"] == 1
    assert follow["engines"] == [follow["in_service"]]
    assert [e["edge"] for e in follow["edges"]] == ["rollout_promote"]
    assert not any(e["leak"] for e in follow["edges"])
