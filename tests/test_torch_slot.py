"""The port's dense slot slab against the JAX package on the same
weights and inputs, on the CPU: ``init_slot_state``,
``slot_admit_many``, ``slot_step(_many)`` (veles_tpu_torch/parallel/
decode.py), the dense int8-KV attend with K4's plain version
(ops/quant.py, held against the JAX Pallas kernel in interpret mode),
and the dense branches of ``ContinuousDecoder`` and ``GenerateAPI``,
which serve the slab by default as the JAX package's do.

On the CPU ``int8_cache_attend`` runs K4's plain version where the
kernel's shape gate holds; chip_smoke.py and tests/test_torch_cuda.py
hold the kernel against it on the card."""

import inspect
import json
import math
import threading
import urllib.request

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import serving as jserving
from veles_tpu.core.config import root as jroot
from veles_tpu.ops import quant as jquant
from veles_tpu.parallel import decode as jdec
from veles_tpu.parallel import transformer_step as jts
from veles_tpu_torch import serving as tserving
from veles_tpu_torch.core.config import root as troot
from veles_tpu_torch.ops import quant as tquant
from veles_tpu_torch.parallel import decode as tdec
from veles_tpu_torch.parallel import kv_pool as tpool
from veles_tpu_torch.parallel import transformer_step as tts

torch.set_num_threads(1)

BLOCKS, EMBED, HEADS, VOCAB, SLOTS = 2, 64, 4, 256, 4
HEAD_DIM = EMBED // HEADS
MAX_LEN = 32
#: f32 through two blocks and a 256-way head: XLA and PyTorch reorder
#: the sums, which moves activations ~1 by a few ulp per sublayer
ATOL = 2e-5
#: the attend's f32 math on both sides from the same int8 codes and f32
#: scales; only the order of the sums differs
ATTEND_ATOL = 1e-5
TIERS = pytest.mark.parametrize("quantize", [None, "int8", "int8-kv"])


def _model(embed=EMBED, heads=HEADS):
    jparams = jts.init_transformer_params(numpy.random.RandomState(0),
                                          BLOCKS, embed, heads, VOCAB)
    tparams = tts.init_transformer_params(numpy.random.RandomState(0),
                                          BLOCKS, embed, heads, VOCAB,
                                          device="cpu")
    table = numpy.random.RandomState(1).randn(VOCAB, embed).astype(
        numpy.float32)
    return jparams, tparams, table


@pytest.fixture(scope="module")
def model():
    return _model()


def _dtype_name(array):
    return str(array.dtype).split(".")[-1]


# -- slab state -----------------------------------------------------------

@pytest.mark.parametrize("layout,dtype", [
    ("float", "float32"), ("float", "bfloat16"), ("int8-kv", "float32"),
    ("paged", "float32")])
def test_init_slot_state_matches_jax(layout, dtype):
    """Every leaf the JAX package creates, with its shape and type; the
    per-slot sampling key is one int64 a slot where the JAX package
    keeps a typed threefry key of the same shape. The JAX package's
    ``paged=True`` delegates to its pool; the port's decoder builds the
    pool with ``kv_pool.init_paged_state`` itself."""
    jstate = jdec.init_slot_state(BLOCKS, SLOTS, MAX_LEN, HEADS, HEAD_DIM,
                                  VOCAB, dtype=jnp.dtype(dtype),
                                  quantized=layout == "int8-kv",
                                  paged=layout == "paged",
                                  page_size=8 if layout == "paged" else None)
    if layout == "paged":
        tstate = tpool.init_paged_state(
            BLOCKS, tpool.default_pool_pages(SLOTS, MAX_LEN, 8), 8, HEADS,
            HEAD_DIM, VOCAB, SLOTS, dtype=getattr(torch, dtype),
            device="cpu")
    else:
        tstate = tdec.init_slot_state(BLOCKS, SLOTS, MAX_LEN, HEADS,
                                      HEAD_DIM, VOCAB,
                                      dtype=getattr(torch, dtype),
                                      quantized=layout == "int8-kv",
                                      device="cpu")
    assert tuple(tstate["req_key"].shape) == tuple(jstate["req_key"].shape)
    assert tstate["req_key"].dtype == torch.int64
    want = {name: (tuple(a.shape), _dtype_name(a))
            for name, a in jstate.items() if name != "req_key"}
    assert {name: (tuple(t.shape), _dtype_name(t))
            for name, t in tstate.items() if name != "req_key"} == want
    assert all(not t.any() for t in tstate.values())
    assert tdec.slot_state_bytes(tstate) == 8 * SLOTS + sum(
        numpy.asarray(a).nbytes for name, a in jstate.items()
        if name != "req_key")


def test_slot_state_bytes_of_the_smoke_slab():
    """The serving model's slab at the dense smoke phase's sizes: 92.3 MB
    of bf16 K/V at max_len 704, 53.5 MB of int8 codes and scales at the
    int8-KV tier's 768."""
    kv = ("k", "v", "k_scale", "v_scale")
    sizes = {}
    for quantized, max_len in ((False, 704), (True, 768)):
        state = tdec.init_slot_state(4, 8, max_len, 16, 64, 32768,
                                     dtype=torch.bfloat16,
                                     quantized=quantized, device="cpu")
        sizes[quantized] = sum(state[name].numel()
                               * state[name].element_size()
                               for name in kv if name in state)
    assert sizes == {False: 92274688, True: 53477376}


# -- admission ------------------------------------------------------------

def _admit_inputs(table):
    """Three prompts of 5, 7 and 3 tokens right-padded to one bucket of
    8, into lanes 2, 0 and 3 (lane 1 stays empty)."""
    rng = numpy.random.RandomState(8)
    lens = (5, 7, 3)
    padded = numpy.zeros((3, 8), numpy.int64)
    for j, n in enumerate(lens):
        padded[j, :n] = rng.randint(0, VOCAB, n)
    return [2, 0, 3], table[padded], list(lens)


def _jax_admit(jparams, table, quantized):
    slots, x, lens = _admit_inputs(table)
    state = jdec.init_slot_state(BLOCKS, SLOTS, MAX_LEN, HEADS, HEAD_DIM,
                                 VOCAB, quantized=quantized)
    return jdec.slot_admit_many(
        jparams, jnp.asarray(table), HEADS, state,
        jnp.asarray(slots, jnp.int32), jnp.asarray(x),
        jax.random.split(jax.random.key(0), 3),
        jnp.asarray(lens, jnp.int32))


def _torch_admit(tparams, table, quantized):
    slots, x, lens = _admit_inputs(table)
    state = tdec.init_slot_state(BLOCKS, SLOTS, MAX_LEN, HEADS, HEAD_DIM,
                                 VOCAB, quantized=quantized, device="cpu")
    return tdec.slot_admit_many(tparams, HEADS, state, torch.tensor(slots),
                                torch.from_numpy(x), torch.tensor(lens))


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "int8-kv"])
def test_slot_admit_many_matches_jax(model, quantized):
    """One batched admission: control rows bit for bit, logits and the
    float slab (every lane, the empty one included) to f32 round-off,
    the int8 slab's scales to f32 round-off of K/V that went through the
    same sublayers in another summation order."""
    jparams, tparams, table = model
    jstate = _jax_admit(jparams, table, quantized)
    tstate = _torch_admit(tparams, table, quantized)
    for name in ("lengths", "step"):
        numpy.testing.assert_array_equal(tstate[name].numpy(),
                                         numpy.asarray(jstate[name]))
    assert tstate["lengths"].tolist() == [7, 0, 5, 3]
    numpy.testing.assert_allclose(tstate["logits"].numpy(),
                                  numpy.asarray(jstate["logits"]),
                                  atol=ATOL, rtol=0)
    assert not tstate["logits"][1].any()
    if quantized:
        for name in ("k_scale", "v_scale"):
            numpy.testing.assert_allclose(tstate[name].numpy(),
                                          numpy.asarray(jstate[name]),
                                          rtol=1e-5, atol=0)
    else:
        for name in ("k", "v"):
            numpy.testing.assert_allclose(tstate[name].numpy(),
                                          numpy.asarray(jstate[name]),
                                          atol=ATOL, rtol=0)


def test_slot_admit_int8_codes_from_the_same_kv_are_jax_bit_for_bit(
        model, monkeypatch):
    """The int8-KV admission's quantization and head-major scatter: fed
    the JAX prefill's own K/V, the port writes the JAX slab's codes bit
    for bit, every untouched position included. The scales agree to two
    ulps: XLA compiles the jitted admission's ``amax / 127`` as a
    product with the rounded reciprocal (the eager division, which the
    port's quantization matches bit for bit, is in
    tests/test_torch_int8kv.py)."""
    jparams, tparams, table = model
    jstate = _jax_admit(jparams, table, True)
    slots, x, lens = _admit_inputs(table)
    ref = jdec._prefill_forward(jparams, jnp.asarray(x), HEADS,
                                jnp.asarray(lens, jnp.int32))
    monkeypatch.setattr(
        tdec, "_prefill_forward",
        lambda *args: tuple(torch.from_numpy(numpy.array(a)) for a in ref))
    tstate = _torch_admit(tparams, table, True)
    for name in ("k", "v", "lengths"):
        numpy.testing.assert_array_equal(tstate[name].numpy(),
                                         numpy.asarray(jstate[name]))
    for name in ("k_scale", "v_scale"):
        numpy.testing.assert_allclose(tstate[name].numpy(),
                                      numpy.asarray(jstate[name]),
                                      rtol=2.4e-7, atol=0)


# -- the decode step ------------------------------------------------------

#: live lengths of the step tests: a lane at 0, two mid-lane, and an
#: inactive lane at max_len, whose append clamps to the last position
STEP_LENGTHS = [5, 0, MAX_LEN, 11]
STEP_ACTIVE = [True, True, False, True]


def _step_states(quantized):
    """The same slab in both packages, drawn with numpy: random K/V (or
    int8 codes and positive scales), lengths, logits."""
    rng = numpy.random.RandomState(9)
    arrays = {"lengths": numpy.asarray(STEP_LENGTHS, numpy.int32),
              "logits": rng.randn(SLOTS, VOCAB).astype(numpy.float32),
              "step": numpy.asarray([3, 0, 9, 1], numpy.int32)}
    if quantized:
        shape = (BLOCKS, SLOTS, HEADS, HEAD_DIM, MAX_LEN)
        for name in ("k", "v"):
            arrays[name] = rng.randint(-127, 128, shape).astype(numpy.int8)
            arrays[name + "_scale"] = rng.uniform(
                0.005, 0.03, shape[:3] + shape[4:]).astype(numpy.float32)
    else:
        shape = (BLOCKS, SLOTS, MAX_LEN, HEADS, HEAD_DIM)
        for name in ("k", "v"):
            arrays[name] = rng.randn(*shape).astype(numpy.float32)
    jstate = {name: jnp.asarray(a) for name, a in arrays.items()}
    jstate["req_key"] = jax.random.split(jax.random.key(0), SLOTS)
    tstate = {name: torch.from_numpy(a.copy()) for name, a in arrays.items()}
    return jstate, tstate


def _assert_states_match(tstate, jstate, quantized):
    for name in ("lengths", "step"):
        numpy.testing.assert_array_equal(tstate[name].numpy(),
                                         numpy.asarray(jstate[name]))
    numpy.testing.assert_allclose(tstate["logits"].numpy(),
                                  numpy.asarray(jstate["logits"]),
                                  atol=ATOL, rtol=0)
    if quantized:
        for name in ("k", "v"):
            numpy.testing.assert_array_equal(tstate[name].numpy(),
                                             numpy.asarray(jstate[name]))
            numpy.testing.assert_allclose(
                tstate[name + "_scale"].numpy(),
                numpy.asarray(jstate[name + "_scale"]), rtol=1e-5, atol=0)
    else:
        for name in ("k", "v"):
            numpy.testing.assert_allclose(tstate[name].numpy(),
                                          numpy.asarray(jstate[name]),
                                          atol=ATOL, rtol=0)


@pytest.mark.parametrize("span", [16, MAX_LEN])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "int8-kv"])
def test_slot_step_matches_jax(model, quantized, span):
    """One step: each lane appends at its own length (the lane at
    max_len at the last position), attends its visible positions of the
    span, and only active lanes advance; tokens come from the pre-step
    logits."""
    jparams, tparams, table = model
    jstate, tstate = _step_states(quantized)
    active = numpy.asarray(STEP_ACTIVE)
    jstate, jtok = jdec.slot_step(jparams, jnp.asarray(table), HEADS,
                                  jstate, jnp.asarray(active), span=span)
    tstate, ttok = tdec.slot_step(tparams, torch.from_numpy(table), HEADS,
                                  tstate, torch.from_numpy(active),
                                  span=span)
    assert ttok.tolist() == numpy.asarray(jtok).tolist()
    assert tstate["lengths"].tolist() == [6, 1, MAX_LEN, 12]
    _assert_states_match(tstate, jstate, quantized)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "int8-kv"])
def test_slot_step_many_matches_jax(model, quantized):
    jparams, tparams, table = model
    jstate, tstate = _step_states(quantized)
    active = numpy.asarray(STEP_ACTIVE)
    jstate, jtoks = jdec.slot_step_many(jparams, jnp.asarray(table), HEADS,
                                        jstate, jnp.asarray(active), 3,
                                        span=16)
    tstate, ttoks = tdec.slot_step_many(tparams, torch.from_numpy(table),
                                        HEADS, tstate,
                                        torch.from_numpy(active), 3,
                                        span=16)
    assert ttoks.shape == (3, SLOTS)
    assert ttoks.tolist() == numpy.asarray(jtoks).tolist()
    assert tstate["step"].tolist() == [6, 3, 9, 4]
    _assert_states_match(tstate, jstate, quantized)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "int8-kv"])
def test_slot_step_span_tiling_is_inert(model, quantized):
    """The port of tests/test_decode.py::test_slot_step_span_tiling_is_
    inert: any span past the longest ACTIVE length gives the tokens and
    the state of attending the whole lane, masked positions adding
    exact zeros (held to the tolerances of the JAX comparison: torch's
    sums over a longer lane may group differently). The inactive lane
    at max_len sees only the span, so what it appends past the first
    block is the span's, and its tokens are discarded."""
    _, tparams, table = model
    active = torch.tensor(STEP_ACTIVE)
    runs = []
    for span in (16, 24, None):
        _, tstate = _step_states(quantized)
        state, tokens = tdec.slot_step(tparams, torch.from_numpy(table),
                                       HEADS, tstate, active, span=span)
        runs.append(({name: t[:, active] if t.dim() > 3 else t
                      for name, t in state.items()}, tokens))
    full, tok_full = runs[-1]
    for tiled, tok_tiled in runs[:-1]:
        assert tok_tiled.tolist() == tok_full.tolist()
        _assert_states_match(tiled, full, quantized)


# -- the dense int8-KV attend and K4's plain version ----------------------

def _attend_problem(batch=3, heads=2, head_dim=32, t=128, seed=11):
    rng = numpy.random.RandomState(seed)
    q = rng.randn(batch, 1, heads, head_dim).astype(numpy.float32) \
        / math.sqrt(head_dim)
    kv = []
    for _ in range(2):
        codes, scale = jdec._quantize_kv(jnp.asarray(
            rng.randn(batch, t, heads, head_dim).astype(numpy.float32)))
        kv += [numpy.array(jnp.transpose(codes, (0, 2, 3, 1))),
               numpy.array(jnp.transpose(scale, (0, 2, 1)))]
    return q, kv


def _mask(kind, batch, t):
    """A per-row mask of ragged lengths (0, 50, t - 1), or one shared
    mask as (T,) or (1, T)."""
    if kind == "per-row":
        lengths = numpy.asarray([0, 50, t - 1][:batch])[:, None]
        return numpy.where(numpy.arange(t)[None, :] <= lengths, 0.0,
                           -1e30).astype(numpy.float32)
    mask = numpy.where(numpy.arange(t) <= 77, 0.0, -1e30).astype(
        numpy.float32)
    return mask if kind == "shared" else mask[None]


def _t(array):
    return torch.from_numpy(numpy.array(array))


MASKS = pytest.mark.parametrize("mask_kind", ["per-row", "shared",
                                              "shared-1xT"])
Q_DTYPES = pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])


@MASKS
@Q_DTYPES
def test_k4_plain_matches_jax_kernel(mask_kind, q_dtype):
    """K4's plain version (``use_pallas=True`` on a CPU tensor) against
    ``_pallas_cache_attend`` in interpret mode: both widen q to f32 and
    keep ``p * v_scale`` in f32."""
    q, kv = _attend_problem()
    mask = _mask(mask_kind, 3, 128)
    jq = jnp.asarray(q, jnp.dtype(q_dtype))
    ref = jquant._pallas_cache_attend(jq, *map(jnp.asarray, kv),
                                      jnp.asarray(mask), interpret=True)
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    out = tquant.int8_cache_attend(tq, *map(_t, kv), _t(mask),
                                   use_pallas=True)
    assert out.dtype == torch.float32 and out.shape == q.shape
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATTEND_ATOL, rtol=0)
    # the default runs the kernel (its plain version here) where the
    # gate holds
    torch.testing.assert_close(
        tquant.int8_cache_attend(tq, *map(_t, kv), _t(mask)), out,
        rtol=0, atol=0)


@MASKS
@Q_DTYPES
def test_use_pallas_false_matches_jax_xla_formulation(mask_kind, q_dtype):
    """``use_pallas=False`` is the JAX package's XLA formulation, bf16
    rounding of the value weights included, at a shape the gate
    admits."""
    q, kv = _attend_problem(seed=12)
    mask = _mask(mask_kind, 3, 128)
    ref = jquant.int8_cache_attend(jnp.asarray(q, jnp.dtype(q_dtype)),
                                   *map(jnp.asarray, kv), jnp.asarray(mask),
                                   use_pallas=False)
    out = tquant.int8_cache_attend(
        torch.from_numpy(q).to(getattr(torch, q_dtype)), *map(_t, kv),
        _t(mask), use_pallas=False)
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATTEND_ATOL, rtol=0)


def test_masked_positions_add_exact_zeros():
    """Whatever a masked position holds stays out of the result."""
    q, kv = _attend_problem(seed=13)
    mask = _mask("per-row", 3, 128)
    first = tquant.int8_cache_attend(_t(q), *map(_t, kv), _t(mask))
    hidden = mask < 0
    for codes, scale in ((kv[0], kv[1]), (kv[2], kv[3])):
        codes[numpy.broadcast_to(hidden[:, None, None, :],
                                 codes.shape)] = 127
        scale[numpy.broadcast_to(hidden[:, None, :], scale.shape)] = 1e3
    second = tquant.int8_cache_attend(_t(q), *map(_t, kv), _t(mask))
    torch.testing.assert_close(first, second, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["t_off_tile", "d_off_tile"])
def test_the_kernel_is_refused_where_its_gate_fails(case):
    """``use_pallas=True`` on a shape the JAX kernel's gate refuses
    raises; it never runs the torch formulation instead. The default
    runs the torch formulation there, as the JAX package."""
    q, kv = _attend_problem(head_dim=16 if case == "d_off_tile" else 32,
                            t=24 if case != "d_off_tile" else 128)
    mask = torch.zeros(kv[0].shape[-1])
    args = (_t(q), *map(_t, kv), mask)
    with pytest.raises(ValueError, match="T % 128"):
        tquant.int8_cache_attend(*args, use_pallas=True)
    torch.testing.assert_close(tquant.int8_cache_attend(*args),
                               tquant._cache_attend_xla(*args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 2])
def test_generate_int8_kv_bf16_keeps_the_jax_formulation(seed, monkeypatch):
    """The reference ``generate`` attends its int8 cache through JAX's
    XLA formulation on any device, never K4 or its plain version: at a
    width K4's gate admits (D = 32, T = 128) a bf16 model streams the
    JAX package's tokens, whose value weights ``p * v_scale`` round to
    bf16 (K4's f32 weights change these streams)."""
    embed, heads = 64, 2
    jparams = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16),
        jts.init_transformer_params(numpy.random.RandomState(0), BLOCKS,
                                    embed, heads, VOCAB))
    tparams = tts.init_transformer_params(numpy.random.RandomState(0),
                                          BLOCKS, embed, heads, VOCAB,
                                          dtype=torch.bfloat16,
                                          device="cpu")
    table = numpy.random.RandomState(1).randn(VOCAB, embed).astype(
        numpy.float32)

    def refused(*args):
        raise AssertionError("generate ran K4's plain version")

    monkeypatch.setattr(tquant, "_cache_attend_plain", refused)
    prompt = numpy.random.RandomState(seed).randint(0, VOCAB, (2, 11))
    jtoks, _ = jdec.generate(jparams, jnp.asarray(table, jnp.bfloat16),
                             jnp.asarray(prompt), heads, n_tokens=24,
                             quantize="int8-kv")
    ttoks, tcache = tdec.generate(tparams, torch.from_numpy(table)
                                  .bfloat16(), prompt, heads, n_tokens=24,
                                  quantize="int8-kv", device="cpu")
    assert tcache["k"].shape[-2:] == (32, 128)
    assert ttoks.tolist() == numpy.asarray(jtoks).tolist()


@pytest.mark.parametrize("case", ["codes_dtype", "scale_shape", "mask_rows",
                                  "q_rank", "mask_dtype"])
def test_attend_rejects_malformed_operands(case):
    q, kv = _attend_problem()
    args = [_t(q), *map(_t, kv), torch.zeros(128)]
    if case == "codes_dtype":
        args[1] = args[1].float()
    elif case == "scale_shape":
        args[4] = args[4][..., :64]
    elif case == "mask_rows":
        args[5] = torch.zeros(2, 128)
    elif case == "q_rank":
        args[0] = args[0][:, 0]
    else:
        args[5] = args[5].double()
    with pytest.raises((ValueError, TypeError)):
        tquant.int8_cache_attend(*args)


def test_cpu_tensors_never_count_a_launch():
    q, kv = _attend_problem()
    before = tquant.int8_cache_attend.launches
    tquant.int8_cache_attend(_t(q), *map(_t, kv), torch.zeros(128),
                             use_pallas=True)
    assert tquant.int8_cache_attend.launches == before


# -- the dense ContinuousDecoder ------------------------------------------

def _prompts(seed=2, lengths=(5, 17, 8, 3, 20, 11, 30)):
    rng = numpy.random.RandomState(seed)
    return [rng.randint(0, VOCAB, n).astype(numpy.int32) for n in lengths]


def _drive(decoder, prompts, chunk):
    """Three requests up front, then one more joining mid-flight on
    every driver pass; returns each prompt's stream."""
    rids = [decoder.submit(p) for p in prompts[:3]]
    later = list(prompts[3:])

    def admit():
        if later:
            rids.append(decoder.submit(later.pop(0)))

    decoder.drain_pipelined(chunk, admit=admit)
    return [list(decoder.results[rid]) for rid in rids]


@TIERS
def test_dense_decoder_matches_jax_dense_decoder(model, quantize):
    """Staggered mid-flight joins through the lag-1 chunked drain, in
    every tier: streams, dispatch counts (one admission per prompt
    bucket group) and tokens out equal the JAX package's dense decoder
    (the default of both), and the streams its generate()."""
    jparams, tparams, table = model
    prompts = _prompts()
    kwargs = dict(slots=SLOTS, max_len=64, n_tokens=10, quantize=quantize)
    ours = tserving.ContinuousDecoder(tparams, torch.from_numpy(table),
                                      HEADS, device="cpu", **kwargs)
    theirs = jserving.ContinuousDecoder(jparams, jnp.asarray(table), HEADS,
                                        **kwargs)
    assert not ours.paged and not theirs.paged and ours.pool is None
    streams = _drive(ours, prompts, 4)
    assert streams == _drive(theirs, prompts, 4)
    assert ours.dispatch_counts == theirs.dispatch_counts
    assert ours.dispatch_counts["admit"] > 1
    assert ours.tokens_out == theirs.tokens_out == 10 * len(prompts)
    assert ours.max_len == theirs.max_len == (128 if quantize == "int8-kv"
                                              else 64)
    assert len({t for s in streams for t in s}) > 8
    for prompt, stream in zip(prompts[:2], streams):
        toks, _ = jdec.generate(jparams, jnp.asarray(table),
                                jnp.asarray(prompt[None]), HEADS,
                                n_tokens=10, quantize=quantize)
        assert stream == numpy.asarray(toks)[0].tolist()


def test_dense_single_steps_eos_and_cancel(model):
    """step() by step() with an eos: streams (cut at the eos, inclusive)
    and dispatch counts equal the JAX dense decoder's; a cancel frees
    the slot at once."""
    jparams, tparams, table = model
    prompts = _prompts(seed=3, lengths=(6, 9, 4))
    toks, _ = jdec.generate(jparams, jnp.asarray(table),
                            jnp.asarray(prompts[1][None]), HEADS, n_tokens=8)
    eos = int(numpy.asarray(toks)[0, 3])
    kwargs = dict(slots=2, max_len=MAX_LEN, n_tokens=8, eos=eos)
    decs = [tserving.ContinuousDecoder(tparams, torch.from_numpy(table),
                                       HEADS, device="cpu", **kwargs),
            jserving.ContinuousDecoder(jparams, jnp.asarray(table), HEADS,
                                       **kwargs)]
    for dec in decs:
        for prompt in prompts:
            dec.submit(prompt)
        dec.run_until_drained()
    ours, theirs = decs
    assert ours.results == theirs.results
    assert ours.results[1][-1] == eos and len(ours.results[1]) <= 4
    assert ours.dispatch_counts == theirs.dispatch_counts
    assert ours.dispatch_counts["step"] > 0
    assert ours.tokens_out == theirs.tokens_out
    rid = ours.submit(prompts[0])
    ours.step()
    assert ours.busy and ours.cancel(rid) and not ours.cancel(rid)
    assert not ours.busy and sorted(ours._free) == [0, 1]


def test_dense_int8_kv_attends_through_k4(monkeypatch):
    """At a head width the kernel's gate admits (D = 32) the int8-KV
    slab attends through K4 — its plain version on the CPU — once per
    block and step, and still streams the JAX dense decoder's tokens
    (the JAX package runs its XLA formulation there: f32, so the two
    agree to round-off)."""
    jparams, tparams, table = _model(embed=64, heads=2)
    calls = []
    plain = tquant._cache_attend_plain

    def counted(*args):
        calls.append(args[1].shape)
        return plain(*args)

    monkeypatch.setattr(tquant, "_cache_attend_plain", counted)
    prompts = _prompts(seed=4, lengths=(7, 12, 5))
    kwargs = dict(slots=2, max_len=40, n_tokens=6, quantize="int8-kv")
    ours = tserving.ContinuousDecoder(tparams, torch.from_numpy(table), 2,
                                      device="cpu", **kwargs)
    theirs = jserving.ContinuousDecoder(jparams, jnp.asarray(table), 2,
                                        **kwargs)
    streams = _drive(ours, prompts, 3)
    assert streams == _drive(theirs, prompts, 3)
    assert ours.dispatch_counts == theirs.dispatch_counts
    steps = 3 * ours.dispatch_counts["chunk"]
    assert len(calls) == BLOCKS * steps
    # the attended span is one 128-position tile of the slab
    assert all(shape == (2, 2, 32, 128) for shape in calls)


# -- the defaults and the HTTP front --------------------------------------

def test_defaults_serve_the_dense_slab_as_in_jax():
    def default(cls):
        return inspect.signature(cls).parameters["paged"].default

    assert default(tserving.ContinuousDecoder) \
        == default(jserving.ContinuousDecoder) is False
    # both fronts resolve their None from the config, whose default is
    # the slab
    assert default(tserving.GenerateAPI) is None
    assert default(jserving.GenerateAPI) is None
    assert troot.common.serve.get("paged") is False
    assert jroot.common.serve.get("paged", False) is False


def test_generate_api_defaults_serve_the_slab(model):
    jparams, tparams, table = model
    api = tserving.GenerateAPI(tparams, torch.from_numpy(table), HEADS,
                               slots=SLOTS, max_len=48, n_tokens=6, chunk=2,
                               device="cpu").start()
    try:
        assert not api.decoder.paged
        assert api.decoder.state["k"].shape == (BLOCKS, SLOTS, 48, HEADS,
                                                HEAD_DIM)
        prompts = _prompts(seed=5, lengths=(4, 13, 9))
        answers = [None] * len(prompts)

        def client(i):
            req = urllib.request.Request(
                "http://127.0.0.1:%d/generate" % api.port,
                data=json.dumps({"tokens": prompts[i].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers[i] = json.loads(resp.read().decode())["tokens"]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        for prompt, answer in zip(prompts, answers):
            toks, _ = jdec.generate(jparams, jnp.asarray(table),
                                    jnp.asarray(prompt[None]), HEADS,
                                    n_tokens=6)
            assert answer == numpy.asarray(toks)[0].tolist()
        health = api.health.snapshot()
        assert health["counters"]["completed"] == 3
        assert health["inflight"] == 0 and "pool" not in health
        assert health["dispatch_counts"]["admit"] >= 1
    finally:
        api.stop()
