"""The port's sequence-model training tier (nn/attention.py units,
StandardWorkflow's self_attention / ffn / layer_norm types, the fused
tick's attention, ffn and layer_norm kinds, convert) against the JAX
package's on the CPU.

Weights are carried across (the JAX units draw from threefry, the port's
from torch): the fused train step from the same numpy parameters, the
workflow from ``convert.unit_params_from_jax``. Tolerances: level 2 is
f32 throughout, so only the summation order differs (~1e-7 measured on
one step, ~1e-7 after 24 steps); level 0 rounds operands to bf16 on both
sides at slightly different places (JAX also rounds the attention
probabilities), and a sum landing on the other side of a rounding
boundary moves a weight by one bf16 step of its update (~1e-3 measured
after 24 steps).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.models.standard import StandardWorkflow as JStandardWorkflow
from veles_tpu.parallel import fused as jfused
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.nn.attention import (GDLayerNorm, GDSelfAttention,
                                          GDTokenFFN, LayerNorm,
                                          SelfAttention, TokenFFN)
from veles_tpu_torch.parallel import fused

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = {0: 5e-3, 2: 1e-5}


@pytest.fixture
def engine(monkeypatch):
    def set_level(level):
        for cfg in (jroot, root):
            monkeypatch.setattr(cfg.common.engine, "precision_level", level,
                                raising=False)
    return set_level


# -- one fused train step -----------------------------------------------------

EMBED, HEADS, SEQ, CLASSES = 32, 2, 16, 5


def _specs(package):
    """A pre-LN block (layer_norm, residual causal attention, layer_norm,
    residual gelu ffn) and a dense head, in ``package``'s spec format."""
    attn = dict(leaves=package._ATTN_LEAVES, has_params=True,
                solver="momentum")
    wb = dict(leaves=package._WB_LEAVES, has_params=True, solver="momentum")
    return [dict(kind="layer_norm", eps=1e-5, **wb),
            dict(kind="attention", heads=HEADS, causal=True, residual=True,
                 **attn),
            dict(kind="layer_norm", eps=1e-5, **wb),
            dict(kind="ffn", activation="gelu", residual=True, **attn),
            dict(kind="dense", activation="linear", **wb)]


def _numpy_params(seed):
    """Per-layer {"p": leaves, "v": velocities}, every leaf (biases and
    layer-norm shifts included) non-zero so momentum and decay show."""
    rng = numpy.random.RandomState(seed)

    def leaf(*shape, scale=0.1):
        return (rng.randn(*shape) * scale).astype(numpy.float32)

    hidden = 4 * EMBED
    shapes = [{"w": (EMBED,), "b": (EMBED,)},
              {"w": (EMBED, 3 * EMBED), "b": (3 * EMBED,),
               "ow": (EMBED, EMBED), "ob": (EMBED,)},
              {"w": (EMBED,), "b": (EMBED,)},
              {"w": (EMBED, hidden), "b": (hidden,), "ow": (hidden, EMBED),
               "ob": (EMBED,)},
              {"w": (SEQ * EMBED, CLASSES), "b": (CLASSES,)}]
    params = []
    for layer in shapes:
        p = {k: leaf(*s) for k, s in layer.items()}
        if len(layer) == 2 and len(layer["w"]) == 1:
            p["w"] = p["w"] + 1.0   # a layer norm's scale near one
        params.append({"p": p, "v": {k: leaf(*s, scale=0.01)
                                     for k, s in layer.items()}})
    return params


def _step(package, params, decay):
    """One train step of ``package``'s fused tick (JAX: the veles_tpu
    module; else the port's) on a 4-row minibatch of 6 sequences."""
    rng = numpy.random.RandomState(3)
    data = rng.randn(6, SEQ, EMBED).astype(numpy.float32)
    labels = rng.randint(0, CLASSES, 6).astype(numpy.int32)
    indices = numpy.array([4, 0, 5, 2], numpy.int64)
    hyper = numpy.array([0.1, 0.05, decay, 0.0, 0.9, 0.9, 0.999, 1e-8],
                        numpy.float32)
    if package is jfused:
        step = jfused.build_tick(_specs(jfused), "none",
                                 with_confusion=False)[0]
        tree = [{"p": {k: jnp.asarray(v) for k, v in layer["p"].items()},
                 "v": {k: jnp.asarray(v) for k, v in layer["v"].items()}}
                for layer in params]
        new, (loss, n_err) = step(
            tree, [jnp.asarray(hyper)] * len(tree), {}, jnp.asarray(data),
            jnp.asarray(labels), jnp.asarray(indices), numpy.float32(4),
            numpy.int64(0))
    else:
        step = fused.build_tick(_specs(fused), "none",
                                with_confusion=False)[0]
        tree = [{"p": {k: torch.from_numpy(v) for k, v in layer["p"].items()},
                 "v": {k: torch.from_numpy(v) for k, v in layer["v"].items()}}
                for layer in params]
        new, (loss, n_err) = step(
            tree, [torch.from_numpy(hyper)] * len(tree), {},
            torch.from_numpy(data), torch.from_numpy(labels),
            torch.from_numpy(indices), 4.0)
    return ([{part: {k: numpy.asarray(v) for k, v in layer[part].items()}
              for part in ("p", "v")} for layer in new],
            float(loss), int(n_err))


@pytest.mark.parametrize("decay", [0.0, 0.05], ids=["no-decay", "decay"])
@pytest.mark.parametrize("level", [0, 2])
def test_fused_train_step_matches_jax(engine, level, decay):
    """One step: loss, n_err and every updated leaf and velocity."""
    engine(level)
    params = _numpy_params(1)
    want, want_loss, want_err = _step(jfused, params, decay)
    got, loss, n_err = _step(fused, params, decay)
    assert n_err == want_err
    assert abs(loss - want_loss) <= ATOL[level]
    for got_layer, want_layer in zip(got, want):
        for part in ("p", "v"):
            for leaf, value in want_layer[part].items():
                numpy.testing.assert_allclose(got_layer[part][leaf], value,
                                              rtol=0, atol=ATOL[level])


def test_weight_decay_reaches_attention_biases_not_layer_norm_shifts():
    """``_ATTN_LEAVES`` decays every leaf of an attention or ffn block,
    biases included; ``_WB_LEAVES`` leaves a layer norm's shift (and a
    dense bias) alone: with the decay on, the attention and ffn biases
    move by -lr_b * decay * b through the velocity, the shifts not at
    all."""
    root.common.engine.precision_level = 2
    try:
        params = _numpy_params(2)
        plain, _, _ = _step(fused, params, 0.0)
        decayed, _, _ = _step(fused, params, 0.05)
    finally:
        root.common.engine.precision_level = 0
    for i in (1, 3):
        for leaf in ("b", "ob"):
            numpy.testing.assert_allclose(
                decayed[i]["p"][leaf] - plain[i]["p"][leaf],
                -0.05 * 0.05 * params[i]["p"][leaf], rtol=1e-3, atol=1e-7)
    for i in (0, 2, 4):
        numpy.testing.assert_array_equal(decayed[i]["p"]["b"],
                                         plain[i]["p"]["b"])
        assert not numpy.array_equal(decayed[i]["p"]["w"], plain[i]["p"]["w"])


# -- the workflow --------------------------------------------------------------

def _digits(n=600):
    from sklearn.datasets import load_digits
    digits = load_digits()
    x = (digits.images / 16.0).astype(numpy.float32)   # (N, 8, 8)
    y = digits.target.astype(numpy.int32)
    perm = numpy.random.RandomState(0).permutation(len(x))[:n]
    return x[perm], y[perm]


#: samples/transformer_digits.py's topology (one pre-LN block, a dense
#: stack, the softmax head); causal attention, as the long-context tier's
LAYERS = [{"type": "layer_norm"},
          {"type": "self_attention", "heads": 4, "residual": True,
           "causal": True},
          {"type": "layer_norm"},
          {"type": "ffn"},
          {"type": "all2all_tanh", "output_sample_shape": (32,)},
          {"type": "softmax", "output_sample_shape": (10,)}]


def _kwargs(**overrides):
    x, y = _digits()
    kwargs = dict(layers=LAYERS,
                  loader_kwargs=dict(data=x, labels=y,
                                     class_lengths=[0, 100, 500],
                                     minibatch_size=50),
                  learning_rate=0.1, gradient_moment=0.9,
                  weights_decay=0.001,
                  decision_kwargs=dict(max_epochs=2), name="digits")
    kwargs.update(overrides)
    return kwargs


def _unit_leaves(unit):
    slots = ("weights", "bias", "out_weights", "out_bias")
    return {name: numpy.asarray(getattr(unit, name).data) for name in slots
            if hasattr(unit, name)}


def _record_epochs(wf):
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append([int(s[0]) for s in stats])
        summary(stats, epoch)

    wf.decision._epoch_summary = recorded
    return seen


@pytest.mark.parametrize("level", [0, 2])
def test_transformer_workflow_matches_jax(engine, level):
    """Two epochs of the transformer_digits topology (pipelined sweeps)
    from the JAX workflow's initial weights: per-epoch error counts,
    the stop bookkeeping and every weight."""
    engine(level)
    jprng.get("default").seed(21)
    jprng.get("loader").seed(22)
    jwf = JStandardWorkflow(JDummyLauncher(), **_kwargs())
    jwf.initialize()
    prng.get("loader").seed(22)
    twf = StandardWorkflow(DummyLauncher(), device="cpu", **_kwargs())
    unit_params_from_jax(twf, [_unit_leaves(f) for f in jwf.forwards])
    twf.initialize()
    jepochs, tepochs = _record_epochs(jwf), _record_epochs(twf)
    jwf.run()
    twf.run()
    assert len(tepochs) == 2 and tepochs == jepochs
    for key in ("_epochs_done", "best_n_err", "best_epoch"):
        assert getattr(twf.decision, key) == getattr(jwf.decision, key)
    for jf, tf in zip(jwf.forwards, twf.forwards):
        for name, value in _unit_leaves(jf).items():
            numpy.testing.assert_allclose(
                getattr(tf, name).data.numpy(), value, rtol=0,
                atol=ATOL[level], err_msg="%s.%s" % (tf.name, name))


def _long_context_kwargs(lr):
    """chip_smoke.py's long-context training configuration (4 x [layer
    norm, residual causal attention, layer norm, residual gelu ffn of
    ratio 4], a 16-class softmax head, 16 samples of randn, 4 valid / 12
    train, minibatch 1, moment 0.9) cut from 8192 x 1024 with 8 heads to
    64 x 128 with one head of 128."""
    rng = numpy.random.RandomState(0)
    data = rng.randn(16, 64, 128).astype(numpy.float32)
    train_labels = rng.randint(0, 16, 12)
    labels = numpy.concatenate([train_labels[rng.randint(0, 12, 4)],
                                train_labels])
    block = [{"type": "layer_norm"},
             {"type": "self_attention", "heads": 1, "causal": True,
              "residual": True},
             {"type": "layer_norm"},
             {"type": "ffn", "ratio": 4, "activation": "gelu",
              "residual": True}]
    return dict(layers=block * 4 + [{"type": "softmax",
                                     "output_sample_shape": 16}],
                loader_kwargs=dict(data=data, labels=labels,
                                   class_lengths=[0, 4, 12],
                                   minibatch_size=1,
                                   normalization_type="none"),
                learning_rate=lr, gradient_moment=0.9,
                decision_kwargs=dict(max_epochs=2), name="long")


def _record_losses(wf):
    """Per epoch: (mean train loss, validation n_err)."""
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append((stats[2][2] / max(stats[2][1], 1), int(stats[1][0])))
        summary(stats, epoch)

    wf.decision._epoch_summary = recorded
    return seen


@pytest.mark.parametrize("lr", [0.01, 1e-5])
def test_learning_rate_diverges_alike(engine, lr):
    """Why chip_smoke.py trains the long-context stack at lr 1e-5, not
    bench.py:260's 0.01: at minibatch 1 a step moves a logit of the head
    over the flattened T x E features by about lr * T * E. Cut to T x E
    = 64 x 128 (lr * T * E = 82 at 0.01; 84000 at full width), both
    packages, from the JAX workflow's weights at level 0, agree on the
    first epoch (loss within 1e-2, n_err equal); at 0.01 both losses are
    NaN in the second epoch, at 1e-5 both are finite and agree (1e-3)."""
    engine(0)
    jprng.get("default").seed(1234)
    jprng.get("loader").seed(1234)
    jwf = JStandardWorkflow(JDummyLauncher(), **_long_context_kwargs(lr))
    jwf.initialize()
    prng.get("loader").seed(1234)
    twf = StandardWorkflow(DummyLauncher(), device="cpu",
                           **_long_context_kwargs(lr))
    unit_params_from_jax(twf, [_unit_leaves(f) for f in jwf.forwards])
    twf.initialize()
    jepochs, tepochs = _record_losses(jwf), _record_losses(twf)
    jwf.run()
    twf.run()
    print("lr %g: JAX %s, port %s" % (lr, jepochs, tepochs))
    assert len(jepochs) == len(tepochs) == 2
    assert tepochs[0][1] == jepochs[0][1]
    assert tepochs[0][0] == pytest.approx(jepochs[0][0], rel=1e-2)
    if lr == 0.01:
        assert numpy.isnan(jepochs[1][0]) and numpy.isnan(tepochs[1][0])
    else:
        assert tepochs[1][0] == pytest.approx(jepochs[1][0], rel=1e-3)


def test_workflow_wires_the_sequence_units():
    """The layer types build the three units and their GD twins, linked
    leaf by leaf, and the fused tick takes the chain (attention and ffn
    with _ATTN_LEAVES, layer norms with _WB_LEAVES)."""
    prng.get("loader").seed(3)
    twf = StandardWorkflow(DummyLauncher(), device="cpu", **_kwargs())
    twf.initialize()
    kinds = [(type(f), type(g)) for f, g in zip(twf.forwards, twf.gds)]
    assert kinds[:4] == [(LayerNorm, GDLayerNorm),
                         (SelfAttention, GDSelfAttention),
                         (LayerNorm, GDLayerNorm), (TokenFFN, GDTokenFFN)]
    attn, gd = twf.forwards[1], twf.gds[1]
    assert gd.out_weights is attn.out_weights and gd.bias is attn.bias
    assert gd._velocity_ow.data.shape == attn.out_weights.data.shape
    specs = fused.extract_model_spec(twf)
    assert [s["kind"] for s in specs] == ["layer_norm", "attention",
                                          "layer_norm", "ffn", "dense",
                                          "dense"]
    assert specs[1]["leaves"] is fused._ATTN_LEAVES
    assert specs[3]["leaves"] is fused._ATTN_LEAVES
    assert specs[0]["leaves"] is fused._WB_LEAVES
    assert specs[1]["causal"] and specs[1]["heads"] == 4
    twf.run()
    assert twf.decision.epochs_done == 2


def test_units_draw_in_the_jax_packages_order():
    """initialize() draws each unit's projections from its PRNG stream
    in the JAX package's order and shapes, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)); the biases are zeros, the layer norm's scale ones.
    The two packages take the same number of draws under one seed (the
    numbers are torch's, not threefry's), and the port's are exactly its
    stream's draws replayed in that order."""
    layers = [{"type": "layer_norm"},
              {"type": "self_attention", "heads": 2},
              {"type": "ffn", "ratio": 2},
              {"type": "softmax", "output_sample_shape": 10}]
    jprng.get("default").seed(31)
    jwf = JStandardWorkflow(JDummyLauncher(), **_kwargs(layers=layers))
    jwf.initialize()
    prng.get("default").seed(31)
    twf = StandardWorkflow(DummyLauncher(), device="cpu",
                           **_kwargs(layers=layers))
    twf.initialize()
    assert prng.get("default")._counter == jprng.get("default")._counter
    for jf, tf in zip(jwf.forwards, twf.forwards):
        want, got = _unit_leaves(jf), _unit_leaves(tf)
        assert {k: v.shape for k, v in got.items()} \
            == {k: v.shape for k, v in want.items()}
        assert all(v.dtype == numpy.float32 for v in got.values())
    ln, sa, ffn = twf.forwards[:3]
    assert torch.equal(ln.weights.data, torch.ones(8))
    for unit in (ln, sa, ffn):
        assert not unit.bias.data.any()
    assert not sa.out_bias.data.any() and not ffn.out_bias.data.any()
    replay = prng.RandomGenerator("replay").seed(31)
    for weights, fan_in in ((sa.weights, 8), (sa.out_weights, 8),
                            (ffn.weights, 8), (ffn.out_weights, 16)):
        draw = replay.fill_uniform(tuple(weights.data.shape),
                                   fan_in ** -0.5, "cpu")
        assert torch.equal(weights.data, draw)
        assert weights.data.abs().max() <= fan_in ** -0.5


def test_unit_params_from_jax_fills_the_out_projection():
    """convert fills a block's four leaves and four velocities before
    initialize(), which then draws nothing; a key the unit has no slot
    for raises."""
    twf = StandardWorkflow(DummyLauncher(), device="cpu", **_kwargs())
    rng = numpy.random.RandomState(4)
    leaves = [{"weights": numpy.ones(8), "bias": numpy.zeros(8)},
              {"weights": rng.rand(8, 24), "bias": rng.rand(24),
               "out_weights": rng.rand(8, 8), "out_bias": rng.rand(8),
               "velocity_ow": numpy.ones((8, 8))}]
    with pytest.raises(ValueError, match="no slot"):
        unit_params_from_jax(twf, [{"out_weights": numpy.ones((8, 8))}]
                             + [{}] * 5)
    unit_params_from_jax(twf, leaves + [{}] * 4)
    twf.initialize()
    attn = twf.forwards[1]
    numpy.testing.assert_array_equal(attn.out_weights.data.numpy(),
                                     leaves[1]["out_weights"]
                                     .astype(numpy.float32))
    assert attn.out_bias.data.dtype == torch.float32
    assert torch.equal(twf.gds[1]._velocity_ow.data, torch.ones(8, 8))
    assert not twf.gds[1]._velocity_ob.data.any()


def test_sequence_tier_imports_neither_jax_nor_veles_tpu():
    """The tier's modules import, and a tiny causal transformer trains on
    the CPU, with JAX and the JAX package blocked."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "veles_tpu"):
            sys.modules[name] = None
        import numpy
        from veles_tpu_torch.dummy import DummyLauncher
        from veles_tpu_torch.models.standard import StandardWorkflow
        import veles_tpu_torch.nn.attention, veles_tpu_torch.ops.attention
        rng = numpy.random.RandomState(0)
        wf = StandardWorkflow(
            DummyLauncher(), device="cpu",
            layers=[{"type": "layer_norm"},
                    {"type": "self_attention", "heads": 2, "causal": True,
                     "residual": True},
                    {"type": "ffn"}, {"type": "softmax",
                                      "output_sample_shape": 3}],
            loader_kwargs=dict(data=rng.rand(30, 6, 8).astype("float32"),
                               labels=rng.randint(0, 3, 30),
                               class_lengths=[0, 10, 20],
                               minibatch_size=10),
            decision_kwargs=dict(max_epochs=2))
        wf.initialize()
        wf.run()
        assert wf.decision.epochs_done == 2
        leaked = [m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "veles_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("trained")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            env=env, capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.split()[-1] == "trained"
