"""The port's tensor-parallel decode (veles_tpu_torch/parallel/decode.py:
``make_tp_generate``, the head-major repack, the slot layout's specs and
``shard_slot_params``) against the JAX package on the CPU.

``make_tp_generate`` runs in gloo worlds of 2 and 4 ``python -c`` ranks
(tests/torch_world.py; one world a size runs every case), the JAX
package's over ``build_mesh(devices=jax.devices()[:n], data=1,
model=n)`` of the 8 virtual devices (tests/conftest.py) in this process.
Mirrors tests/test_decode.py:214-275 (the three TP generate tests) and
tests/test_quant.py:281 (the int8 refusal): greedy f32 tokens equal
``generate``'s and the JAX package's on every rank. The layout tests run
in this process on world-less meshes: a whole tree to the serving layout
is slice-only and needs no world."""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.parallel import decode as jdec
from veles_tpu.parallel import transformer_step as jts
from veles_tpu.parallel.mesh import build_mesh as jbuild_mesh
from veles_tpu_torch.parallel import decode as tdec
from veles_tpu_torch.parallel import transformer_step as tts
from veles_tpu_torch.parallel.mesh import Mesh

from torch_world import join_world, start_world

torch.set_num_threads(1)

#: seconds a world of ranks may take for all its cases
DEADLINE = 90

#: name -> (seed, blocks, embed, heads, vocab, prompt shape, n_tokens,
#: world sizes): the JAX tests' models (test_decode.py:214-262)
MODELS = {
    "smoke": (9, 1, 8, 2, 4, (1, 3), 2, (2,)),
    "eight": (6, 2, 32, 8, 16, (2, 6), 7, (2, 4)),
}

RANK = r'''
from veles_tpu_torch.parallel.decode import make_tp_generate
mesh = build_mesh(data=1, model=cfg["world"])
for name, (params, table, prompt, heads, n_tokens) in inputs.items():
    if cfg["world"] not in cfg["sizes"][name]:
        continue
    run = make_tp_generate(mesh, heads, n_tokens, device="cpu")
    params = {"blocks": [{k: torch.from_numpy(v) for k, v in b.items()}
                         for b in params["blocks"]],
              **{k: torch.from_numpy(params[k])
                 for k in ("lnf_w", "lnf_b", "head")}}
    out[name] = run(params, torch.from_numpy(table), prompt).numpy()
finish()
'''


def _model(name):
    seed, blocks, embed, heads, vocab, shape, n_tokens, _ = MODELS[name]
    rng = numpy.random.RandomState(seed)
    params = jts.init_transformer_params(rng, blocks, embed, heads, vocab)
    table = rng.randn(vocab, embed).astype(numpy.float32) * 0.3
    prompt = rng.randint(0, vocab, shape)
    host = jax.tree.map(numpy.asarray, params)
    return host, table, prompt, heads, n_tokens


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started at once; each rank's tokens by model."""
    inputs = {name: _model(name) for name in MODELS}
    sizes = {name: list(MODELS[name][-1]) for name in MODELS}
    started = {n: start_world(RANK, n, str(tmp_path_factory.mktemp(
        "tp%d" % n)), inputs, extra={"sizes": sizes}) for n in (2, 4)}
    results = {n: join_world(s, DEADLINE)[0] for n, s in started.items()}
    return inputs, results


@pytest.mark.parametrize("name,n", [("smoke", 2), ("eight", 2),
                                    ("eight", 4)])
def test_tp_generate_matches_generate_and_jax(worlds, name, n):
    """Every rank's greedy tokens equal the port's single-device
    ``generate``, the JAX package's ``generate`` and its
    ``make_tp_generate`` over an n-device model axis."""
    inputs, results = worlds
    params, table, prompt, heads, n_tokens = inputs[name]
    tparams = tdec.tree_to(_torch_tree(params), "cpu")
    single, _ = tdec.generate(tparams, torch.from_numpy(table), prompt,
                              heads, n_tokens, device="cpu")
    jsingle, _ = jdec.generate(params, jnp.asarray(table),
                               jnp.asarray(prompt), heads,
                               n_tokens=n_tokens)
    run = jdec.make_tp_generate(
        jbuild_mesh(devices=jax.devices()[:n], data=1, model=n), heads,
        n_tokens=n_tokens)
    jtp = numpy.asarray(run(params, jnp.asarray(table),
                            jnp.asarray(prompt)))
    numpy.testing.assert_array_equal(single.numpy(),
                                     numpy.asarray(jsingle))
    numpy.testing.assert_array_equal(jtp, numpy.asarray(jsingle))
    for rank, got in enumerate(results[n]):
        numpy.testing.assert_array_equal(got[name], single.numpy(),
                                         err_msg="rank %d" % rank)


def _torch_tree(params):
    return {"blocks": [{k: torch.from_numpy(numpy.array(v))
                        for k, v in blk.items()}
                       for blk in params["blocks"]],
            **{k: torch.from_numpy(numpy.array(params[k]))
               for k in ("lnf_w", "lnf_b", "head")}}


def _jax_error(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


@pytest.mark.parametrize("n", [2, 8])
def test_tp_generate_refuses_indivisible_with_jax_message(n):
    """Heads 4 and a vocabulary of 11 cannot split 8 (nor the vocabulary
    2) ways: both packages refuse with the same message
    (test_decode.py:265-275)."""
    rng = numpy.random.RandomState(0)
    params = jts.init_transformer_params(rng, 2, 16, 4, 11)
    table = rng.randn(11, 16).astype(numpy.float32)
    run = jdec.make_tp_generate(
        jbuild_mesh(devices=jax.devices()[:n], data=1, model=n), 4,
        n_tokens=3)
    theirs = _jax_error(lambda: run(params, jnp.asarray(table),
                                    jnp.zeros((1, 4), jnp.int32)))
    ours = tdec.make_tp_generate(Mesh({"model": n}), 4, 3, device="cpu")
    with pytest.raises(ValueError) as exc:
        ours(_torch_tree(jax.tree.map(numpy.asarray, params)),
             torch.from_numpy(table), numpy.zeros((1, 4), numpy.int64))
    assert str(exc.value) == theirs
    assert "divisible" in theirs


def test_tp_generate_refuses_int8_params_with_jax_message():
    """The int8 tier is single-device decoding: quantized params are
    refused (test_quant.py:281)."""
    rng = numpy.random.RandomState(7)
    jparams = jdec.quantize_params(jts.init_transformer_params(
        rng, 1, 16, 2, 8))
    table = rng.randn(8, 16).astype(numpy.float32)
    run = jdec.make_tp_generate(
        jbuild_mesh(devices=jax.devices()[:2], data=1, model=2), 2,
        n_tokens=2)
    theirs = _jax_error(lambda: run(jparams, jnp.asarray(table),
                                    jnp.zeros((1, 3), jnp.int32)))
    tparams = tdec.quantize_params(tts.init_transformer_params(
        numpy.random.RandomState(7), 1, 16, 2, 8, device="cpu"))
    ours = tdec.make_tp_generate(Mesh({"model": 2}), 2, 2, device="cpu")
    with pytest.raises(ValueError) as exc:
        ours(tparams, torch.from_numpy(table), numpy.zeros((1, 3),
                                                           numpy.int64))
    assert str(exc.value) == theirs


def _spec(p):
    """A JAX PartitionSpec as the port's tuple of entries."""
    return tuple(p)


def test_layout_specs_match_jax():
    """``slot_state_specs`` and every leaf of ``slot_param_specs`` that
    keeps its shape are the JAX package's; the repacked qkv and
    out-projection shard over heads, as JAX's ``_tp_specs``
    (decode.py:784-805)."""
    rng = numpy.random.RandomState(0)
    jparams = jts.init_transformer_params(rng, 2, 32, 8, 16)
    tparams = tts.init_transformer_params(numpy.random.RandomState(0), 2,
                                          32, 8, 16, device="cpu")
    for quantized in (False, True):
        theirs = jdec.slot_state_specs(quantized)
        ours = tdec.slot_state_specs(quantized)
        assert set(ours) == set(theirs)
        for name in theirs:
            assert tuple(ours[name]) == _spec(theirs[name]), name
    for jp, tp in ((jparams, tparams), (jdec.quantize_params(jparams),
                                        tdec.quantize_params(tparams))):
        theirs = jdec.slot_param_specs(jp)
        ours = tdec.slot_param_specs(tp)
        tp_specs = jdec._tp_specs(2, "model")
        for jblk, tblk in zip(theirs["blocks"], ours["blocks"]):
            for name in ("ln1_w", "ln1_b", "bout", "ln2_w", "ln2_b", "w1",
                         "b1", "w2", "b2"):
                assert _tuple_tree(tblk[name]) == _tuple_tree(jblk[name])
            for name in ("wqkv", "bqkv", "wout"):
                got = tblk[name]["q8"] if isinstance(tblk[name], dict) \
                    else tblk[name]
                assert tuple(got) == _spec(tp_specs["blocks"][0][name])
        assert _tuple_tree(ours["head"]) == _tuple_tree(theirs["head"])


def _tuple_tree(spec):
    if isinstance(spec, dict):
        return {k: _tuple_tree(v) for k, v in spec.items()}
    return tuple(spec)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("n", [2, 4])
def test_shards_are_whole_heads_contiguous(n, quantize):
    """Each rank's shard is contiguous (K2 reads whole rows) and holds
    its heads: its qkv projection's output is [q | k | v] of exactly
    those heads of the whole projection's, so ``_block_qkv`` splits by
    the local width into the rank's heads; the FFN, out-projection and
    head slices are the rank's columns and rows (int8 scales following
    their columns, whole under a row shard)."""
    heads, embed = 8, 32
    params = tts.init_transformer_params(numpy.random.RandomState(2), 2,
                                         embed, heads, 16, device="cpu")
    if quantize:
        params = tdec.quantize_params(params)
    table = torch.from_numpy(numpy.random.RandomState(3).randn(
        16, embed).astype(numpy.float32))
    x = torch.from_numpy(numpy.random.RandomState(4).randn(
        2, 5, embed).astype(numpy.float32))
    h = heads // n
    whole = tts._block_qkv(params["blocks"][0], x, heads)
    for rank in range(n):
        local, got_table = tdec.shard_slot_params(
            params, table, heads, Mesh({"model": n}, rank=rank))
        assert got_table is table
        for path, leaf in tdec.tree_leaves_with_path(local):
            assert leaf.is_contiguous(), path
        blk = local["blocks"][0]
        part = tts._block_qkv(blk, x, h)
        for got, want in zip(part, whole):
            assert got.shape == (2, 5, h, embed // heads)
            torch.testing.assert_close(
                got, want[:, :, rank * h:(rank + 1) * h], rtol=0,
                atol=1e-5)
        cols = embed * 4 // n
        w1 = blk["w1"]["q8"] if quantize else blk["w1"]
        full_w1 = params["blocks"][0]["w1"]
        full_w1 = full_w1["q8"] if quantize else full_w1
        assert torch.equal(w1, full_w1[:, rank * cols:(rank + 1) * cols])
        if quantize:
            assert torch.equal(
                blk["w2"]["scale"], params["blocks"][0]["w2"]["scale"])
            assert torch.equal(
                blk["w1"]["scale"],
                params["blocks"][0]["w1"]["scale"][
                    rank * cols:(rank + 1) * cols])


def test_validate_slot_mesh_matches_jax():
    """A serving mesh the heads, FFN or vocabulary cannot split fails at
    build time with the JAX package's message naming the sizes."""
    params = jts.init_transformer_params(numpy.random.RandomState(0), 1,
                                         24, 6, 16)
    table = numpy.zeros((16, 24), numpy.float32)
    with pytest.raises(ValueError) as theirs:
        jdec.validate_slot_mesh(
            jbuild_mesh(devices=jax.devices()[:4], data=1, model=4), 6,
            params, table)
    with pytest.raises(ValueError) as ours:
        tdec.validate_slot_mesh(Mesh({"model": 4}), 6,
                                jax.tree.map(numpy.asarray, params), table)
    assert str(ours.value) == str(theirs.value)
    assert tdec.validate_slot_mesh(Mesh({"model": 1}), 6, params,
                                   table) == 1
