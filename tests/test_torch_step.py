"""The port's model-axis train step (veles_tpu_torch/parallel/step.py) and
the fused tick over a mesh that sizes an axis besides ``data`` against
the JAX package's on the CPU.

The port's side is a gloo world of 2 and one of 4 ``python -c`` ranks
(tests/torch_world.py) that run every case and pickle their results; the
JAX package's ``build_train_step`` runs the same cases in this process on
2 and 4 of the 8 virtual devices, on the same numpy inputs, at precision
level 2 (f32 products). The step cases: a 64 -> 32 tanh -> 12 MLP, three
steps with momentum and weight decay, over ``model=2``, ``data=2 x
model=2`` and ``model=4``: the loss, ``n_err`` and the gathered
parameters equal the JAX package's sharded and single-device steps
(``n_err`` exactly, the rest within :data:`ATOL`: f32 sums in another
order), and the replicas along ``data`` hold the same bits.

The fused tick shards over ``data`` alone and replicates over every
other axis, as the JAX package's ``shard_map`` over ``data``: the digits
MLP trained by a workflow over ``data=2 x model=2`` must equal the same
workflow over ``data=2`` in a world of 2, bit for bit (a reduce over the
whole world instead of the data line would sum every gradient twice)."""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.core.config import root as jroot
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu.parallel import step as jstep
from veles_tpu.parallel.mesh import build_mesh as jbuild_mesh
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.parallel import build_train_step, step as tstep

from torch_world import join_world, start_world

torch.set_num_threads(1)

DEADLINE = 120
#: f32 throughout at precision level 2: only the order of the sums
#: differs (the column shards' partial input errors, gloo's reduces)
ATOL = 1e-5
STEPS = 3
SPEC = [dict(activation="tanh", learning_rate=0.1, learning_rate_bias=0.05,
             weights_decay=1e-3, l1_vs_l2=1e-4, gradient_moment=0.9),
        dict(activation="linear", learning_rate=0.1, learning_rate_bias=0.1,
             weights_decay=0.0, l1_vs_l2=0.0, gradient_moment=0.5)]
#: the step cases: name -> (world, mesh axes)
CASES = {"model2": (2, dict(model=2)),
         "data2-model2": (4, dict(data=2, model=2)),
         "model4": (4, dict(model=4))}
#: the workflow: digits, 64 -> 256 tanh -> 10, minibatch 100, 2 epochs
LENGTHS, MINIBATCH, EPOCHS = [0, 297, 1500], 100, 2

RANK = r'''
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.parallel import build_train_step
from veles_tpu_torch.parallel.step import shard_batch, shard_params
from torch_world import as_torch
n = cfg["world"]
root.common.engine.precision_level = 2
# 1. the digits workflow: data=2, and data=2 x model=2 in the world of 4
mesh = build_mesh(**({"data": 2} if n == 2 else {"data": 2, "model": 2}))
x, y = inputs["digits"]
for sweep in (True, False):
    prng.get("loader").seed(8765)
    wf = MLPWorkflow(DummyLauncher(), device="cpu", mesh=mesh,
                     layers=(256, 10),
                     loader_kwargs=dict(data=x, labels=y,
                                        class_lengths=inputs["lengths"],
                                        minibatch_size=inputs["minibatch"],
                                        normalization_type="linear"),
                     learning_rate=0.1, max_epochs=inputs["epochs"],
                     fused_sweep=sweep, fused_pipeline=sweep)
    unit_params_from_jax(wf, inputs["weights"])
    wf.initialize()
    seen = []
    summary = wf.decision._epoch_summary
    def recorded(stats, epoch, seen=seen, summary=summary):
        seen.append([int(s[0]) for s in stats])
        summary(stats, epoch)
    wf.decision._epoch_summary = recorded
    wf.run()
    out["workflow", sweep] = {
        "epochs": seen, "sharded": wf.fused_tick.mesh is mesh,
        "weights": [(f.weights.data.numpy(), f.bias.data.numpy())
                    for f in wf.forwards]}
# 2. the model-axis step
for name, (world, axes) in inputs["cases"].items():
    if world != n:
        continue
    mesh = build_mesh(**axes)
    step = build_train_step(inputs["spec"], mesh=mesh)
    params = shard_params(as_torch(inputs["params"]), mesh)
    batch = shard_batch([torch.from_numpy(a) for a in inputs["batch"]],
                        mesh)
    metrics = []
    for _ in range(inputs["steps"]):
        params, (loss, n_err) = step(params, *batch)
        metrics.append((float(loss), int(n_err)))
    out[name] = {"metrics": metrics, "rows": batch[0].shape[0],
                 "params": {k: [t.numpy() for t in v]
                            for k, v in params.items()}}
finish()
'''


def _digits():
    from sklearn.datasets import load_digits
    digits = load_digits()
    perm = numpy.random.RandomState(0).permutation(len(digits.data))
    return (digits.data.astype(numpy.float32)[perm],
            digits.target.astype(numpy.int32)[perm])


def _mlp_inputs():
    rng = numpy.random.RandomState(3)

    def mat(a, b):
        return (rng.randn(a, b) / numpy.sqrt(a)).astype(numpy.float32)
    w = [mat(64, 32), mat(32, 12)]
    b = [(rng.randn(32) * 0.1).astype(numpy.float32),
         (rng.randn(12) * 0.1).astype(numpy.float32)]
    params = {"w": w, "b": b, "vw": [numpy.zeros_like(a) for a in w],
              "vb": [numpy.zeros_like(a) for a in b]}
    batch = rng.rand(40, 8, 8).astype(numpy.float32)
    labels = rng.randint(0, 12, 40).astype(numpy.int32)
    mask = numpy.ones(40, numpy.float32)
    mask[-4:] = 0.0
    return params, (batch, labels, mask)


def _jax_steps(params, batch, mesh):
    """The JAX package's step, three times: (metrics, parameters)."""
    step = jstep.build_train_step(SPEC, mesh=mesh, donate=False)
    p = jax.tree.map(jnp.asarray, params)
    arrays = [jnp.asarray(a) for a in batch]
    if mesh is not None:
        p, arrays = jstep.shard_params(p, mesh), jstep.shard_batch(arrays,
                                                                   mesh)
    metrics = []
    for _ in range(STEPS):
        p, (loss, n_err) = step(p, *arrays)
        metrics.append((float(loss), int(n_err)))
    return metrics, jax.tree.map(numpy.asarray, p)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    params, batch = _mlp_inputs()
    x, y = _digits()
    rng = numpy.random.RandomState(5)
    weights = [{"weights": (rng.randn(64, 256) * 0.1).astype(numpy.float32),
                "bias": numpy.zeros(256, numpy.float32)},
               {"weights": (rng.randn(256, 10) * 0.1).astype(numpy.float32),
                "bias": numpy.zeros(10, numpy.float32)}]
    inputs = {"digits": (x, y), "lengths": LENGTHS, "minibatch": MINIBATCH,
              "epochs": EPOCHS, "weights": weights, "spec": SPEC,
              "cases": CASES, "params": params, "batch": batch,
              "steps": STEPS}
    started = {n: start_world(RANK, n, str(tmp_path_factory.mktemp(
        "step%d" % n)), inputs) for n in (2, 4)}
    level = jroot.common.engine.get("precision_level", 0)
    jroot.common.engine.precision_level = 2
    try:
        theirs = {None: _jax_steps(params, batch, None)}
        for name, (world, axes) in CASES.items():
            theirs[name] = _jax_steps(params, batch, jbuild_mesh(
                devices=jax.devices()[:world], **axes))
    finally:
        jroot.common.engine.precision_level = level
    results = {n: join_world(s, DEADLINE)[0] for n, s in started.items()}
    return theirs, results


def _gathered(results, name):
    """The whole parameters from the ranks of data coordinate 0, and each
    rank's shards by its model coordinate."""
    axes = CASES[name][1]
    model = axes.get("model", 1)
    lead = results[:model]   # data coordinate 0: ranks 0 .. model - 1
    out = {}
    for key in ("w", "b", "vw", "vb"):
        dim = 1 if key in ("w", "vw") else 0
        out[key] = [numpy.concatenate([r[name]["params"][key][i]
                                       for r in lead], axis=dim)
                    for i in range(2)]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax_sharded_and_single(worlds, name):
    """Three steps over the case's mesh: loss and n_err of every step and
    the gathered parameters and velocities equal the JAX package's
    sharded step and its single-device step."""
    theirs, results = worlds
    world, axes = CASES[name]
    got = _gathered(results[world], name)
    for want_metrics, want in (theirs[name], theirs[None]):
        for (loss, n_err), (jloss, jn_err) in zip(
                results[world][0][name]["metrics"], want_metrics):
            assert loss == pytest.approx(jloss, rel=1e-5)
            assert n_err == jn_err
        for key in ("w", "b", "vw", "vb"):
            for a, b in zip(got[key], want[key]):
                numpy.testing.assert_allclose(a, b, atol=ATOL)
    assert results[world][0][name]["rows"] == 40 // axes.get("data", 1)


@pytest.mark.parametrize("name", list(CASES))
def test_replicas_hold_the_same_bits(worlds, name):
    """The ranks of one model coordinate (the data axis's replicas) hold
    the same parameter bits, and every rank the same metrics."""
    _, results = worlds
    world, axes = CASES[name]
    model = axes.get("model", 1)
    ranks = results[world]
    for rank, got in enumerate(ranks):
        assert got[name]["metrics"] == ranks[0][name]["metrics"]
        twin = ranks[rank % model][name]["params"]
        for key, leaves in got[name]["params"].items():
            for a, b in zip(leaves, twin[key]):
                numpy.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "minibatch"])
def test_fused_tick_data2_model2_equals_data2(worlds, sweep):
    """The repair of the fused tick's reduce: the workflow over data=2 x
    model=2 (4 ranks) trains bit for bit as over data=2 (2 ranks): every
    epoch's n_err and the final weights, on every rank, its tick sharded
    over the mesh."""
    _, results = worlds
    want = results[2][0]["workflow", sweep]
    for got in results[4] + results[2]:
        got = got["workflow", sweep]
        assert got["sharded"]
        assert got["epochs"] == want["epochs"]
        for (w, b), (jw, jb) in zip(got["weights"], want["weights"]):
            numpy.testing.assert_array_equal(w, jw)
            numpy.testing.assert_array_equal(b, jb)


def test_layer_spec_and_params_round_trip():
    """extract_layer_spec reads the JAX package's spec off the same
    workflow; get_params and set_params round-trip the unit Arrays."""
    x, y = _digits()
    kwargs = dict(layers=(32, 10), learning_rate=0.05, max_epochs=1,
                  loader_kwargs=dict(data=x, labels=y,
                                     class_lengths=LENGTHS,
                                     minibatch_size=MINIBATCH))
    twf = MLPWorkflow(DummyLauncher(), device="cpu", **kwargs)
    jwf = JMLPWorkflow(JDummyLauncher(), **kwargs)
    assert tstep.extract_layer_spec(twf) == jstep.extract_layer_spec(jwf)
    twf.initialize()
    params = tstep.get_params(twf)
    assert [tuple(w.shape) for w in params["w"]] == [(64, 32), (32, 10)]
    assert not params["vw"][0].any()
    doubled = {k: [2 * t for t in v] for k, v in params.items()}
    tstep.set_params(twf, doubled)
    assert torch.equal(twf.forwards[1].weights.data, doubled["w"][1])
    assert torch.equal(twf.gds[0]._velocity_b.data, doubled["vb"][0])
    assert build_train_step is tstep.build_train_step
    assert root.common.engine.get("precision_level", 0) == 0
