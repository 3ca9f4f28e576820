"""The port's sequence parallelism (ring and Ulysses attention in
veles_tpu_torch/ops/attention.py, the data x seq transformer train step
in parallel/transformer_step.py) against the JAX package's on the CPU.

Mirrors tests/test_attention.py::TestRing and ::TestUlysses and
tests/test_pipeline_expert.py::TestSequenceParallelTraining. The port's
side is one gloo world of 4 ``python -c`` ranks (tests/torch_world.py)
that rebuilds its mesh for each case (seq=4, data=2 x seq=2) and pickles
its results; the JAX package runs the same cases in this process on 4 of
the 8 virtual devices, on the same numpy inputs. Tolerances are the JAX
tests': attention against the naive reference rtol 2e-2 / atol 2e-3; the
step against one device loss rel 1e-5 and leaves rtol 1e-4 / atol 1e-5,
ring against Ulysses 1e-3 / 1e-4; ``n_err`` equal. The parameters after
a step hold the same bits on every rank."""

import math

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.ops.attention import (make_ring_attention as jring,
                                     make_ulysses_attention as julysses)
from veles_tpu.parallel.mesh import build_mesh as jbuild_mesh
from veles_tpu.parallel.transformer_step import (
    build_transformer_train_step as jstep,
    init_transformer_params as jinit, shard_tokens as jshard)
from veles_tpu_torch.parallel.transformer_step import (
    build_transformer_train_step, init_transformer_params)

from torch_world import as_torch, join_world, start_world

torch.set_num_threads(1)

DEADLINE = 120
WORLD = 4

#: the attention cases: name -> (batch, T, heads, head width, seed,
#: strategy, causal)
ATTENTION = {
    "ring-full": (2, 128, 2, 16, 0, "ring", False),
    "ring-causal": (2, 128, 2, 16, 0, "ring", True),
    "ring-long": (1, 256, 2, 16, 0, "ring", True),
    "ulysses-full": (2, 128, 8, 16, 0, "ulysses", False),
    "ulysses-causal": (2, 128, 8, 16, 0, "ulysses", True),
    "ring-vs-ulysses-ring": (1, 128, 8, 16, 3, "ring", True),
    "ring-vs-ulysses-ulysses": (1, 128, 8, 16, 3, "ulysses", True),
}
#: the train-step cases: name -> (mesh, data seed, blocks, strategy,
#: learning rate, steps)
STEPS = {
    "dp-sp": (dict(data=2, seq=2), 0, 2, "ulysses", 0.1, 1),
    "dp-sp-ring": (dict(data=2, seq=2), 0, 2, "ring", 0.1, 1),
    "sp4": (dict(data=1, seq=4), 0, 2, "ulysses", 0.1, 1),
    "sp4-ring": (dict(data=1, seq=4), 0, 2, "ring", 0.1, 1),
    "ring-vs-ulysses-u": (dict(data=2, seq=2), 5, 1, "ulysses", 0.1, 1),
    "ring-vs-ulysses-r": (dict(data=2, seq=2), 5, 1, "ring", 0.1, 1),
    "learns": (dict(data=2, seq=2), 2, 1, "ulysses", 0.5, 12),
}

RANK = r'''
from veles_tpu_torch.ops.attention import (make_ring_attention,
                                           make_ulysses_attention)
from veles_tpu_torch.parallel.transformer_step import (
    build_transformer_train_step, shard_tokens)
from torch_world import as_torch
n = cfg["world"]
mesh = build_mesh(data=1, seq=n)
out["attention"] = {}
for name, (q, k, v, strategy, causal) in inputs["attention"].items():
    make = make_ring_attention if strategy == "ring" \
        else make_ulysses_attention
    fn = make(mesh, causal=causal)
    t = q.shape[1] // n
    blocks = [torch.from_numpy(a)[:, rank * t:(rank + 1) * t]
              for a in (q, k, v)]
    out["attention"][name] = fn(*blocks).numpy()
try:
    make_ulysses_attention(mesh)(*[torch.zeros(1, 16, 6, 8)] * 3)
    out["six_heads"] = None
except ValueError as exc:
    out["six_heads"] = str(exc)
out["steps"] = {}
for name, (axes, x, labels, params, strategy, lr, steps) \
        in inputs["steps"].items():
    mesh = build_mesh(**axes)
    step = build_transformer_train_step(4, mesh=mesh, learning_rate=lr,
                                        sp_strategy=strategy)
    xs, ls = shard_tokens([torch.from_numpy(x), torch.from_numpy(labels)],
                          mesh)
    params = as_torch(params)
    losses = []
    for _ in range(steps):
        params, (loss, n_err) = step(params, xs, ls)
        losses.append(float(loss))
    out["steps"][name] = {
        "losses": losses, "n_err": int(n_err),
        "params": [t.numpy() for t in _leaves(params)],
        "x_block": tuple(xs.shape)}
finish()
'''

LEAVES = r'''
def _leaves(params):
    return [t for blk in params["blocks"] for _, t in sorted(blk.items())] \
        + [params[k] for k in ("head", "lnf_b", "lnf_w")]
'''


def _leaves(params):
    """Leaves in jax.tree.leaves order (dict keys sorted)."""
    return [t for blk in params["blocks"] for _, t in sorted(blk.items())] \
        + [params[k] for k in ("head", "lnf_b", "lnf_w")]


def naive_attention(q, k, v, causal=False):
    s = numpy.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[1]
        s = numpy.where(numpy.tril(numpy.ones((t, t), bool))[None, None],
                        s, -1e30)
    p = numpy.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return numpy.einsum("bhqk,bkhd->bqhd", p, v)


def _qkv(b, t, h, d, seed):
    rng = numpy.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(numpy.float32) * 0.5
            for _ in range(3)]


def _data(seed, b=4, t=32, e=16, vocab=11):
    rng = numpy.random.RandomState(seed)
    x = rng.randn(b, t, e).astype(numpy.float32) * 0.3
    labels = rng.randint(0, vocab, (b, t))
    return rng, x, labels


def _step_inputs(name):
    axes, seed, blocks, strategy, lr, steps = STEPS[name]
    rng, x, labels = _data(seed)
    params = jax.tree.map(numpy.asarray, jinit(rng, n_blocks=blocks,
                                               embed=16, heads=4, vocab=11))
    return axes, x, labels, params, strategy, lr, steps


def _jax_step(name, params, x, labels):
    """The JAX package's step on its own mesh of the case's axes, and its
    single-device step: ``(sharded, single)``, each ``(leaves, losses,
    n_err)``."""
    axes, _, _, _, strategy, lr, steps = _step_inputs(name)
    out = []
    for mesh in (jbuild_mesh(devices=jax.devices()[:WORLD], **axes), None):
        step = jstep(heads=4, mesh=mesh, learning_rate=lr,
                     sp_strategy=strategy)
        xs, ls = (jshard([x, labels], mesh) if mesh is not None
                  else (jnp.asarray(x), jnp.asarray(labels)))
        p, losses = jax.tree.map(jnp.asarray, params), []
        for _ in range(steps):
            p, (loss, n_err) = step(p, xs, ls)
            losses.append(float(loss))
        out.append(([numpy.asarray(a) for a in jax.tree.leaves(p)],
                    losses, int(n_err)))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's world, started first; the JAX package's cases run here
    meanwhile. Returns (jax results, per-rank results)."""
    attention = {name: tuple(_qkv(*spec[:5])) + spec[5:]
                 for name, spec in ATTENTION.items()}
    steps = {name: _step_inputs(name) for name in STEPS}
    started = start_world(LEAVES + RANK, WORLD,
                          str(tmp_path_factory.mktemp("seq")),
                          {"attention": attention, "steps": steps})
    theirs = {"attention": {}, "steps": {}}
    mesh = jbuild_mesh(devices=jax.devices()[:WORLD], data=1, seq=WORLD)
    for name, (q, k, v, strategy, causal) in attention.items():
        make = jring if strategy == "ring" else julysses
        theirs["attention"][name] = numpy.asarray(
            make(mesh, causal=causal)(q, k, v))
    for name, (_, x, labels, params, *_) in steps.items():
        theirs["steps"][name] = _jax_step(name, params, x, labels)
    return theirs, join_world(started, DEADLINE)[0], attention


def _gathered(results, name):
    return numpy.concatenate([r["attention"][name] for r in results], axis=1)


@pytest.mark.parametrize("name", [n for n in ATTENTION
                                  if not n.startswith("ring-vs")])
def test_attention_matches_single_device_and_jax(world, name):
    """Ring and Ulysses attention over a 4-way seq mesh equal the naive
    attention and the JAX package's over its own 4-way seq mesh (the
    causal mask across ranks, Ulysses' head chunks in axis order: 8
    heads, 2 a rank)."""
    theirs, results, attention = world
    q, k, v, _, causal = attention[name]
    got = _gathered(results, name)
    numpy.testing.assert_allclose(got, naive_attention(q, k, v, causal),
                                  rtol=2e-2, atol=2e-3)
    numpy.testing.assert_allclose(got, theirs["attention"][name],
                                  rtol=2e-2, atol=2e-3)


def test_each_rank_holds_its_block_of_the_sequence(world):
    """Every rank holds T/4 of the sequence, in and out (the JAX test's
    addressable shards): (1, 64, 2, 16) of 256 positions."""
    _, results, _ = world
    for r in results:
        assert r["attention"]["ring-long"].shape == (1, 64, 2, 16)
        assert r["attention"]["ulysses-full"].shape == (2, 32, 8, 16)


def test_ring_matches_ulysses(world):
    _, results, _ = world
    numpy.testing.assert_allclose(
        _gathered(results, "ring-vs-ulysses-ring"),
        _gathered(results, "ring-vs-ulysses-ulysses"), rtol=2e-2,
        atol=2e-3)


def test_ulysses_heads_divisibility_required(world):
    _, results, _ = world
    for r in results:
        assert "divisible" in r["six_heads"]


def _check_step(got, want, rel=1e-5, rtol=1e-4, atol=1e-5):
    leaves, losses, n_err = want
    assert got["losses"][-1] == pytest.approx(losses[-1], rel=rel)
    assert got["n_err"] == n_err
    for a, b in zip(got["params"], leaves):
        numpy.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["dp-sp", "dp-sp-ring", "sp4", "sp4-ring"])
def test_step_matches_single_device_and_jax(world, name):
    """One dp x sp (or sp=4) step equals the single-device step and the
    JAX package's sharded step; the parameters hold the same bits on
    every rank, and each rank took its (data, seq) block."""
    theirs, results, _ = world
    sharded, single = theirs["steps"][name]
    axes = STEPS[name][0]
    for got in (r["steps"][name] for r in results):
        _check_step(got, single)
        _check_step(got, sharded)
        assert got["x_block"] == (4 // axes["data"], 32 // axes["seq"], 16)
    for r in results[1:]:
        for a, b in zip(r["steps"][name]["params"],
                        results[0]["steps"][name]["params"]):
            numpy.testing.assert_array_equal(a, b)


def test_ring_strategy_matches_ulysses_step(world):
    """A ring-SP train step equals the Ulysses one on the same inputs
    (the JAX test's 1e-3 / 1e-4), and the JAX package's ring step."""
    theirs, results, _ = world
    got_u = results[0]["steps"]["ring-vs-ulysses-u"]
    got_r = results[0]["steps"]["ring-vs-ulysses-r"]
    assert got_u["losses"][0] == pytest.approx(got_r["losses"][0], rel=1e-4)
    assert got_u["n_err"] == got_r["n_err"]
    for a, b in zip(got_u["params"], got_r["params"]):
        numpy.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    _check_step(got_r, theirs["steps"]["ring-vs-ulysses-r"][0])


def test_training_reduces_loss(world):
    """Twelve dp x sp steps at learning rate 0.5 take the loss below 0.7
    of its first value, as the JAX package's do."""
    theirs, results, _ = world
    losses = results[0]["steps"]["learns"]["losses"]
    assert losses[-1] < losses[0] * 0.7, losses
    _check_step(results[0]["steps"]["learns"], theirs["steps"]["learns"][0],
                rel=1e-4, rtol=1e-3, atol=1e-4)


def test_single_step_matches_jax_and_rejects_a_bad_strategy():
    """Without a mesh the step is the JAX package's single-device step;
    an unknown strategy raises the JAX package's ValueError."""
    _, x, labels, params, strategy, lr, _ = _step_inputs("dp-sp")
    _, single = _jax_step("dp-sp", params, x, labels)
    step = build_transformer_train_step(4, learning_rate=lr)
    p, (loss, n_err) = step(as_torch(params), torch.from_numpy(x),
                            torch.from_numpy(labels))
    _check_step({"losses": [float(loss)], "n_err": int(n_err),
                 "params": [t.numpy() for t in _leaves(p)]}, single)
    with pytest.raises(ValueError, match="sp_strategy"):
        build_transformer_train_step(4, sp_strategy="tree")
    assert init_transformer_params(numpy.random.RandomState(0), 1, 16, 4,
                                   11, device="cpu")["head"].shape == (16, 11)
