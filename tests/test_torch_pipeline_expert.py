"""The port's pipeline (veles_tpu_torch/parallel/pipeline.py) and expert
(parallel/expert.py) parallelism against the JAX package's on the CPU.

Mirrors tests/test_pipeline_expert.py::TestPipeline,
::TestPipelineTraining, ::TestExpertParallel and ::TestExpertTraining.
The port's side is a gloo world of 2 and one of 4 ``python -c`` ranks
(tests/torch_world.py) that rebuild their mesh for each case (``pipe=2``
and ``4``, ``pipe=2 x data=2``, ``expert=2`` and ``4``) and pickle their
results; the JAX package runs the same cases in this process on as many
of the 8 virtual devices, on the same numpy inputs. Tolerances are the
JAX tests': the pipeline forward 2e-5, its step loss rel 1e-5 and leaves
rtol 2e-4 / atol 2e-5, the MoE 2e-4; the routing and the drop fractions
equal."""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.parallel import expert as jexpert, pipeline as jpipeline
from veles_tpu.parallel.mesh import build_mesh as jbuild_mesh
from veles_tpu_torch.parallel import expert, pipeline

from torch_world import join_world, start_world

torch.set_num_threads(1)

DEADLINE = 120
D = 8

#: pipeline forward cases: name -> (world, stages, microbatches)
FORWARD = {"p2-m4": (2, 2, 4), "p4-m8": (4, 4, 8), "p2-m8": (2, 2, 8)}
#: pipeline train cases: name -> (world, stages, microbatches, data axis,
#: steps, learning rate, teacher targets)
TRAIN = {"p2-m4": (2, 2, 4, 1, 1, 0.1, False),
         "p4-m8": (4, 4, 8, 1, 1, 0.1, False),
         "p2-d2": (4, 2, 4, 2, 1, 0.1, False),
         "learns": (4, 4, 8, 1, 30, 0.2, True)}
#: MoE forward cases: name -> (world, experts)
MOE = {"e8-ep2": (2, 8), "e8-ep4": (4, 8), "e16-ep4": (4, 16)}

RANK = r'''
from veles_tpu_torch.parallel import collectives, expert, pipeline
n = cfg["world"]
def stage(w, x):
    return torch.tanh(x @ w["w"] + w["b"])
def mse(outputs, targets):
    return ((outputs - targets) ** 2).mean()
def tensors(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}
for name, (world, stages, micro, weights, batch) in \
        inputs["forward"].items():
    if world != n:
        continue
    mesh = build_mesh(pipe=stages)
    run = pipeline.make_pipeline(mesh, stage, micro)
    got = run(pipeline.shard_stage_weights(tensors(weights), mesh),
              torch.from_numpy(batch))
    out["forward", name] = {"y": got.numpy(),
                            "calls": {k: v[0] for k, v in
                                      collectives.collective_stats(
                                          mesh).items()}}
for name, (world, stages, micro, dp, steps, lr, weights, batch,
           targets) in inputs["train"].items():
    if world != n:
        continue
    mesh = build_mesh(pipe=stages, data=dp)
    step = pipeline.make_pipeline_train_step(mesh, stage, micro, mse,
                                             learning_rate=lr)
    w = pipeline.shard_stage_weights(tensors(weights), mesh)
    losses = []
    for _ in range(steps):
        w, loss = step(w, torch.from_numpy(batch), torch.from_numpy(targets))
        losses.append(float(loss))
    out["train", name] = {"losses": losses,
                          "w": {k: v.numpy() for k, v in w.items()}}
if n == 2:
    mesh = build_mesh(pipe=2)
    for label, bad in (("weights", inputs["bad_weights"]),
                       ("batch", inputs["bad_batch"])):
        try:
            pipeline.make_pipeline(mesh, stage, 4)(*bad)
            out["refusal", label] = None
        except ValueError as exc:
            out["refusal", label] = str(exc)
for name, (world, n_experts, params, tokens) in inputs["moe"].items():
    if world != n:
        continue
    mesh = build_mesh(expert=n)
    moe = expert.make_moe_ffn(mesh, n_experts, capacity_factor=float(
        n_experts))
    t = tokens.shape[0] // n
    y, dropped = moe(expert.shard_moe_params(tensors(params), mesh),
                     torch.from_numpy(tokens[rank * t:(rank + 1) * t]))
    out["moe", name] = {"y": y.numpy(), "dropped": float(dropped)}
mesh = build_mesh(expert=n)
params = expert.shard_moe_params(tensors(inputs["moe_params"]), mesh)
t = 64 // n
moe = expert.make_moe_ffn(mesh, 8, capacity_factor=1.0)
y, dropped = moe(params, torch.ones((t, 16)))
out["drops"] = {"y": y.numpy(), "dropped": float(dropped)}
x, targets = (torch.from_numpy(a[rank * t:(rank + 1) * t])
              for a in inputs["moe_train"])
for label, cf, lr, steps in (("step", 8.0, 0.05, 1),
                             ("learns", 4.0, 0.1, 20)):
    step = expert.make_moe_train_step(mesh, 8, capacity_factor=cf,
                                      learning_rate=lr)
    p, losses = params, []
    for _ in range(steps):
        p, loss = step(p, x, targets)
        losses.append(float(loss))
    out["moe_train", label] = {"losses": losses,
                               "params": {k: v.numpy()
                                          for k, v in p.items()}}
finish()
'''


def _stage(w, x):
    return jnp.tanh(x @ w["w"] + w["b"])


def _mse(outputs, targets):
    return jnp.mean((outputs - targets) ** 2)


def _weights(n_stages, rng):
    return {"w": rng.randn(n_stages, D, D).astype(numpy.float32) * 0.3,
            "b": rng.randn(n_stages, D).astype(numpy.float32) * 0.1}


def _forward_inputs(stages, micro):
    rng = numpy.random.RandomState(0)
    batch = rng.randn(micro * 4, D).astype(numpy.float32)
    return _weights(stages, rng), batch


def _train_inputs(stages, micro, dp, teacher):
    rng = numpy.random.RandomState(0)
    weights = _weights(stages, rng)
    batch = rng.randn(micro * 4 * dp, D).astype(numpy.float32)
    targets = rng.randn(batch.shape[0], D).astype(numpy.float32)
    if teacher:
        teach = numpy.random.RandomState(7).randn(D, D).astype(
            numpy.float32) * 0.3
        targets = numpy.asarray(jnp.tanh(batch @ teach))
    return weights, batch, targets


def _moe_inputs(n_experts):
    rng = numpy.random.RandomState(0)
    params = jexpert.init_moe_params(rng, n_experts, 16, 32)
    tokens = rng.randn(64, 16).astype(numpy.float32)
    return jax.tree.map(numpy.asarray, params), tokens


def _moe_train_inputs():
    rng = numpy.random.RandomState(0)
    params = jexpert.init_moe_params(rng, 8, 16, 32)
    x = rng.randn(64, 16).astype(numpy.float32)
    targets = rng.randn(64, 16).astype(numpy.float32) * 0.1
    return jax.tree.map(numpy.asarray, params), x, targets


def _jax_sequential_step(weights, batch, targets, lr):
    def loss_fn(w):
        return _mse(jpipeline.sequential_reference(_stage, w, batch),
                    targets)
    loss, grads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, weights))
    return jax.tree.map(lambda w, g: numpy.asarray(w - lr * g), weights,
                        grads), float(loss)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    moe_params, _, _ = _moe_train_inputs()
    inputs = {
        "forward": {name: spec[:3] + _forward_inputs(*spec[1:])
                    for name, spec in FORWARD.items()},
        "train": {name: spec[:5] + (spec[5],) + _train_inputs(
            spec[1], spec[2], spec[3], spec[6])
            for name, spec in TRAIN.items()},
        "moe": {name: spec + _moe_inputs(spec[1])
                for name, spec in MOE.items()},
        "moe_params": moe_params, "moe_train": _moe_train_inputs()[1:]}
    weights, batch = _forward_inputs(2, 4)
    inputs["bad_weights"] = (weights, batch)             # not sharded
    inputs["bad_batch"] = ({k: v[:1] for k, v in weights.items()},
                           batch[:10])                     # 10 rows, 4 micro
    started = {n: start_world(RANK, n, str(tmp_path_factory.mktemp(
        "pp%d" % n)), inputs) for n in (2, 4)}
    theirs = {}
    for name, (world, stages, micro) in FORWARD.items():
        weights, batch = _forward_inputs(stages, micro)
        mesh = jbuild_mesh(devices=jax.devices()[:stages], data=1,
                           pipe=stages)
        run = jpipeline.make_pipeline(mesh, _stage, micro)
        theirs["forward", name] = numpy.asarray(run(
            jpipeline.shard_stage_weights(weights, mesh), batch))
    for name, (world, stages, micro, dp, steps, lr, teacher) \
            in TRAIN.items():
        weights, batch, targets = _train_inputs(stages, micro, dp, teacher)
        mesh = jbuild_mesh(devices=jax.devices()[:world], data=dp,
                           pipe=stages)
        step = jpipeline.make_pipeline_train_step(mesh, _stage, micro, _mse,
                                                  learning_rate=lr)
        w, losses = jpipeline.shard_stage_weights(weights, mesh), []
        for _ in range(steps):
            w, loss = step(w, batch, targets)
            losses.append(float(loss))
        theirs["train", name] = (jax.tree.map(numpy.asarray, w), losses,
                                 _jax_sequential_step(weights, batch,
                                                      targets, lr))
    for name, (world, n_experts) in MOE.items():
        params, tokens = _moe_inputs(n_experts)
        mesh = jbuild_mesh(devices=jax.devices()[:world], data=1,
                           expert=world)
        moe = jexpert.make_moe_ffn(mesh, n_experts,
                                   capacity_factor=float(n_experts))
        y, dropped = moe(jexpert.shard_moe_params(params, mesh), tokens)
        theirs["moe", name] = (numpy.asarray(y), float(dropped),
                               numpy.asarray(jexpert.reference_moe(
                                   jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(tokens))))
    results = {n: join_world(s, DEADLINE)[0] for n, s in started.items()}
    return theirs, results


@pytest.mark.parametrize("name", list(FORWARD))
def test_pipeline_matches_sequential_and_jax(worlds, name):
    """The pipelined forward equals the stages applied in order and the
    JAX package's pipeline, on every stage."""
    theirs, results = worlds
    world, stages, micro = FORWARD[name]
    weights, batch = _forward_inputs(stages, micro)
    want = batch
    for s in range(stages):
        want = numpy.tanh(want @ weights["w"][s] + weights["b"][s])
    for r in results[world]:
        got = r["forward", name]["y"]
        numpy.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        numpy.testing.assert_allclose(got, theirs["forward", name],
                                      rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", list(FORWARD))
def test_pipeline_is_one_schedule(worlds, name):
    """The whole fill, steady state and drain is one schedule of
    n_micro + n_stages - 2 hand-offs and one masked psum (the JAX
    package's one compiled computation)."""
    _, results = worlds
    world, stages, micro = FORWARD[name]
    for r in results[world]:
        assert r["forward", name]["calls"] == {
            "ppermute": micro + stages - 2, "psum": 1}


@pytest.mark.parametrize("name", ["p2-m4", "p4-m8", "p2-d2"])
def test_pipeline_train_step_matches_sequential(worlds, name):
    """One pipelined train step (pp, and pp x dp) equals the sequential
    single-device step on the same global batch and the JAX package's
    pipelined step; every stage's block is its rows of the result."""
    theirs, results = worlds
    world, stages, *_ = TRAIN[name]
    jw, jlosses, (want_w, want_loss) = theirs["train", name]
    for rank, r in enumerate(results[world]):
        got = r["train", name]
        stage = rank // (world // stages)   # pipe is the major axis
        assert got["losses"][0] == pytest.approx(want_loss, rel=1e-5)
        assert got["losses"][0] == pytest.approx(jlosses[0], rel=1e-5)
        for key in ("w", "b"):
            numpy.testing.assert_allclose(
                got["w"][key], want_w[key][stage:stage + 1], rtol=2e-4,
                atol=2e-5)
            numpy.testing.assert_allclose(
                got["w"][key], jw[key][stage:stage + 1], rtol=2e-4,
                atol=2e-5)


def test_pipeline_training_reduces_loss(worlds):
    """Thirty steps toward a teacher's outputs descend monotonically to
    below 0.6 of the first loss, as the JAX package's do."""
    theirs, results = worlds
    losses = results[4][0]["train", "learns"]["losses"]
    assert losses[-1] < losses[0] * 0.6, losses
    assert all(b <= a + 1e-4 for a, b in zip(losses, losses[1:])), losses
    numpy.testing.assert_allclose(losses, theirs["train", "learns"][1],
                                  rtol=1e-4)


def test_pipeline_refuses_with_the_constraints_names(worlds):
    """A whole tree where a stage's block belongs, and a batch that does
    not split into microbatches, fail before any collective, naming the
    constraint; shard_stage_weights refuses a leading dimension other
    than the axis's size."""
    _, results = worlds
    assert "leading dim 2 != 1" in results[2][0]["refusal", "weights"]
    assert "does not divide into 4 microbatches" \
        in results[2][0]["refusal", "batch"]
    from veles_tpu_torch.parallel.mesh import Mesh
    weights, _ = _forward_inputs(3, 4)
    with pytest.raises(ValueError, match="leading dim 3 != pipe axis 2"):
        pipeline.shard_stage_weights(
            {k: torch.from_numpy(v) for k, v in weights.items()},
            Mesh({"pipe": 2}))


@pytest.mark.parametrize("name", list(MOE))
def test_moe_matches_dense_reference(worlds, name):
    """With capacity for every token, the sharded MoE equals the dense
    single-device reference and the JAX package's MoE, dropping nothing
    (e_local > 1 exercises the (ep, e_local) flattening both ways)."""
    theirs, results = worlds
    world, _ = MOE[name]
    jy, jdropped, want = theirs["moe", name]
    got = numpy.concatenate([r["moe", name]["y"] for r in results[world]])
    numpy.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    numpy.testing.assert_allclose(got, jy, rtol=2e-4, atol=2e-4)
    for r in results[world]:
        assert r["moe", name]["dropped"] == jdropped == 0.0


@pytest.mark.parametrize("world", [2, 4])
def test_capacity_drops_reported(worlds, world):
    """Identical tokens all route to one expert: a tight capacity drops
    most of them, says so (the JAX package's fraction), and their output
    rows are zero."""
    _, results = worlds
    mesh = jbuild_mesh(devices=jax.devices()[:world], data=1, expert=world)
    params, _, _ = _moe_train_inputs()
    jy, jdropped = jexpert.make_moe_ffn(mesh, 8, capacity_factor=1.0)(
        jexpert.shard_moe_params(params, mesh), jnp.ones((64, 16)))
    got = numpy.concatenate([r["drops"]["y"] for r in results[world]])
    for r in results[world]:
        assert r["drops"]["dropped"] == float(jdropped)
        assert r["drops"]["dropped"] > 0.5
    assert (numpy.abs(got).sum(axis=1) < 1e-7).sum() >= 32
    numpy.testing.assert_allclose(got, numpy.asarray(jy), rtol=2e-4,
                                  atol=2e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_moe_train_step_matches_dense_reference(worlds, world):
    """With nothing dropped, one sharded train step equals the dense
    reference's autograd step (the JAX test's tolerances): loss, gate
    and every expert's weights; the gate is the same on every rank."""
    _, results = worlds
    params, x, targets = _moe_train_inputs()
    tp = {k: torch.from_numpy(numpy.array(v)).requires_grad_(True)
          for k, v in params.items()}
    loss = ((expert.reference_moe(tp, torch.from_numpy(x))
             - torch.from_numpy(targets)) ** 2).mean()
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    want = {k: (tp[k] - 0.05 * grads[k]).detach().numpy() for k in tp}
    ranks = results[world]
    got = {k: (ranks[0]["moe_train", "step"]["params"][k] if k == "gate"
               else numpy.concatenate([r["moe_train", "step"]["params"][k]
                                       for r in ranks]))
           for k in want}
    assert ranks[0]["moe_train", "step"]["losses"][0] == pytest.approx(
        float(loss.detach()), rel=1e-5)
    for k in want:
        numpy.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                      atol=2e-5)
    for r in ranks[1:]:
        numpy.testing.assert_array_equal(
            r["moe_train", "step"]["params"]["gate"], got["gate"])


@pytest.mark.parametrize("world", [2, 4])
def test_moe_train_step_matches_jax(worlds, world):
    """The same step equals the JAX package's sharded MoE step, and
    twenty steps at capacity 4 take the loss below 0.7 of its first."""
    _, results = worlds
    params, x, targets = _moe_train_inputs()
    mesh = jbuild_mesh(devices=jax.devices()[:world], data=1, expert=world)
    step = jexpert.make_moe_train_step(mesh, 8, capacity_factor=8.0,
                                       learning_rate=0.05)
    jp, jloss = step(jexpert.shard_moe_params(params, mesh), x, targets)
    ranks = results[world]
    assert ranks[0]["moe_train", "step"]["losses"][0] == pytest.approx(
        float(jloss), rel=1e-5)
    for k, v in jp.items():
        got = ranks[0]["moe_train", "step"]["params"][k] if k == "gate" \
            else numpy.concatenate([r["moe_train", "step"]["params"][k]
                                    for r in ranks])
        numpy.testing.assert_allclose(got, numpy.asarray(v), rtol=2e-4,
                                      atol=2e-5)
    losses = ranks[0]["moe_train", "learns"]["losses"]
    assert losses[-1] < losses[0] * 0.7, losses


def test_moe_params_drawn_as_jax_draws_them():
    """init_moe_params draws gate, w1 and w2 in the JAX package's order;
    the biases are zeros; the experts refuse an axis they do not
    divide."""
    mine = expert.init_moe_params(numpy.random.RandomState(4), 8, 16, 32,
                                  device="cpu")
    theirs = jexpert.init_moe_params(numpy.random.RandomState(4), 8, 16, 32)
    for k, v in theirs.items():
        numpy.testing.assert_array_equal(mine[k].numpy(), numpy.asarray(v))
    from veles_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match="divide"):
        expert.make_moe_ffn(Mesh({"expert": 3}), 8)
