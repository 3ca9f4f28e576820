"""The port's causal-LM tier (veles_tpu_torch/parallel/transformer_step,
decode, kv_pool and convert) against the JAX package on the same
weights and inputs, on the CPU.

Weights come from the same numpy RandomState draws in both packages (or
through convert.params_from_jax), so every comparison starts from
bit-identical parameters."""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.ops import attention as jattention
from veles_tpu.parallel import decode as jdec
from veles_tpu.parallel import kv_pool as jpool
from veles_tpu.parallel import transformer_step as jts
from veles_tpu_torch import convert
from veles_tpu_torch.ops import attention as tattention
from veles_tpu_torch.parallel import decode as tdec
from veles_tpu_torch.parallel import kv_pool as tpool
from veles_tpu_torch.parallel import transformer_step as tts

torch.set_num_threads(1)

BLOCKS, EMBED, HEADS, VOCAB = 2, 32, 4, 64
#: f32 through two blocks and a 64-way head: XLA and PyTorch reorder
#: the sums, which moves activations ~1 by a few ulp per sublayer
ATOL = 2e-5


@pytest.fixture(scope="module")
def model():
    jparams = jts.init_transformer_params(numpy.random.RandomState(0),
                                          BLOCKS, EMBED, HEADS, VOCAB)
    tparams = tts.init_transformer_params(numpy.random.RandomState(0),
                                          BLOCKS, EMBED, HEADS, VOCAB,
                                          device="cpu")
    table = numpy.random.RandomState(1).randn(VOCAB, EMBED).astype(
        numpy.float32)
    return jparams, tparams, table


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(numpy.asarray, tree))


def test_same_seed_gives_the_same_weights(model):
    jparams, tparams, _ = model
    jl = _leaves(jparams)
    tl = _leaves(convert.params_to_numpy(tparams))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        numpy.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tier", ["float", "int8", "bf16"])
def test_params_from_jax_round_trip(model, tier):
    jparams = model[0]
    if tier == "int8":
        jparams = jdec.quantize_params(jparams)
    elif tier == "bf16":
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    numpy_tree = jax.tree.map(numpy.asarray, jparams)
    tparams = convert.params_from_jax(numpy_tree, device="cpu")
    if tier == "bf16":
        assert tparams["head"].dtype == torch.bfloat16
    for a, b in zip(_leaves(numpy_tree),
                    _leaves(convert.params_to_numpy(tparams))):
        # bfloat16 comes back widened exactly to float32
        assert a.dtype == b.dtype or tier == "bf16"
        numpy.testing.assert_array_equal(a.astype(b.dtype), b)
    bf16 = convert.params_from_jax(numpy_tree, device="cpu",
                                   dtype=torch.bfloat16)
    assert bf16["lnf_w"].dtype == torch.bfloat16
    if tier == "int8":
        assert bf16["head"]["q8"].dtype == torch.int8
        assert bf16["head"]["scale"].dtype == torch.float32


def test_layer_norm_and_mlp_match_jax(model):
    jparams, tparams, _ = model
    x = numpy.random.RandomState(2).randn(2, 5, EMBED).astype(
        numpy.float32) * 3 + 1
    jblk, tblk = jparams["blocks"][0], tparams["blocks"][0]
    numpy.testing.assert_allclose(
        tts._ln(torch.from_numpy(x), tblk["ln1_w"], tblk["ln1_b"]).numpy(),
        numpy.asarray(jts._ln(jnp.asarray(x), jblk["ln1_w"],
                              jblk["ln1_b"])), atol=ATOL, rtol=0)
    # jax.nn.gelu's tanh approximation, not torch's erf default
    numpy.testing.assert_allclose(
        tts._mlp(tblk, torch.from_numpy(x)).numpy(),
        numpy.asarray(jts._mlp(jblk, jnp.asarray(x))), atol=ATOL, rtol=0)


def test_causal_attention_matches_jax():
    rng = numpy.random.RandomState(3)
    q, k, v = (rng.randn(2, 7, HEADS, 8).astype(numpy.float32)
               for _ in range(3))
    ref = jattention.attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True)
    out = tattention.attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True)
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATOL, rtol=0)


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("t_q,t_k", [(4096, 4096), (4095, 4096),
                                     (4096, 8192), (512, 512)])
def test_flash_gate_follows_the_jax_rule(monkeypatch, head_dim, t_q, t_k):
    """The port raises on CUDA exactly where the JAX package would run
    its flash kernel on a TPU (its backend check left aside: the rule
    is asked as if on a TPU)."""
    monkeypatch.setattr(jattention.jax, "default_backend", lambda: "tpu")

    class Shape:
        def __init__(self, t):
            self.shape = (1, t, 2, head_dim)

    assert tattention.uses_flash(t_q, t_k, head_dim) \
        == jattention._use_pallas_flash(Shape(t_q), Shape(t_k))
    assert tattention.uses_flash(t_q, t_k, head_dim) \
        == (min(t_q, t_k) >= 4096 and head_dim == 128)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_prefill_forward_logits_and_kv_match_jax(model, ragged):
    jparams, tparams, table = model
    tokens = numpy.random.RandomState(4).randint(0, VOCAB, (3, 9))
    x = table[tokens]
    lengths = numpy.asarray([9, 4, 1], numpy.int32) if ragged else None
    jl, jk, jv, jlen = jdec._prefill_forward(
        jparams, jnp.asarray(x), HEADS,
        None if lengths is None else jnp.asarray(lengths))
    tl, tk, tv, tlen = tdec._prefill_forward(
        tparams, torch.from_numpy(x), HEADS,
        None if lengths is None else torch.from_numpy(lengths))
    for ours, ref in ((tl, jl), (tk, jk), (tv, jv)):
        numpy.testing.assert_allclose(ours.numpy(), numpy.asarray(ref),
                                      atol=ATOL, rtol=0)
    numpy.testing.assert_array_equal(numpy.asarray(tlen),
                                     numpy.asarray(jlen))


def _jax_stream_logits(jparams, table, prompt, tokens, quantize):
    """The JAX package's logits before each emitted token, fed the
    port's tokens: prefill, then decode_step per token."""
    if quantize:
        jparams = jdec.quantize_params(jparams)
    n = tokens.shape[1]
    cache = jdec.init_kv_cache(BLOCKS, 1, prompt.shape[1] + n, HEADS,
                               EMBED // HEADS)
    table = jnp.asarray(table)
    logits, cache = jdec.prefill(jparams, table[jnp.asarray(prompt)],
                                 HEADS, cache)
    seen = []
    for i in range(n):
        seen.append(numpy.asarray(logits))
        tok = jnp.asarray(tokens[:, i])
        logits, cache = jdec.decode_step(jparams, table[tok][:, None, :],
                                         HEADS, cache)
    return numpy.stack(seen, axis=1)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_generate_tokens_and_logits_match_jax(model, quantize):
    jparams, tparams, table = model
    prompt = numpy.random.RandomState(5).randint(0, VOCAB, (1, 11))
    jtoks, _ = jdec.generate(jparams, jnp.asarray(table),
                             jnp.asarray(prompt), HEADS, n_tokens=12,
                             quantize=quantize)
    ttoks, cache, logits = tdec.generate(
        tparams, torch.from_numpy(table), prompt, HEADS, n_tokens=12,
        quantize=quantize, return_logits=True, device="cpu")
    assert ttoks.tolist() == numpy.asarray(jtoks).tolist()
    assert len(set(ttoks[0].tolist())) > 3   # a stream worth comparing
    assert cache["length"] == 11 + 12
    ref = _jax_stream_logits(jparams, table, prompt, ttoks.numpy(),
                             quantize)
    numpy.testing.assert_allclose(logits.numpy(), ref, atol=ATOL, rtol=0)


def test_generate_samples_reproducibly_in_vocab(model):
    _, tparams, table = model
    prompt = numpy.arange(6)[None] % VOCAB
    runs = []
    for _ in range(2):
        toks, _ = tdec.generate(tparams, torch.from_numpy(table), prompt,
                                HEADS, n_tokens=8, temperature=0.8,
                                top_k=5, key=tdec.request_key(3, 0),
                                device="cpu")
        runs.append(toks.tolist())
    assert runs[0] == runs[1]
    assert all(0 <= t < VOCAB for t in runs[0][0])


def test_generate_rejects_bad_arguments(model):
    _, tparams, table = model
    prompt = numpy.zeros((1, 4), numpy.int64)
    with pytest.raises(ValueError, match="max_len"):
        tdec.generate(tparams, torch.from_numpy(table), prompt, HEADS, 8,
                      max_len=6, device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        tdec.generate(tparams, torch.from_numpy(table), prompt, HEADS, 2,
                      quantize="int4", device="cpu")


class TestPagePool:
    """The host page table: the invariants the serving gate relies on,
    and the sizing formulas shared with the JAX package."""

    def test_alloc_release_refcounts(self):
        pool = tpool.PagePool(8, 4)
        assert pool.capacity == 7
        pages = pool.alloc(3)
        assert len(pages) == 3 and tpool.SCRATCH_PAGE not in pages
        assert (pool.used_pages, pool.free_pages) == (3, 4)
        pool.retain(pages)
        pool.release(pages)
        assert pool.used_pages == 3
        pool.release(pages)
        assert (pool.used_pages, pool.free_pages) == (0, 7)
        assert pool.alloc(8) is None

    def test_reservations_bound_by_capacity(self):
        pool = tpool.PagePool(6, 4)
        assert pool.try_reserve(3) and pool.try_reserve(2)
        assert not pool.try_reserve(1)
        pool.unreserve(2)
        assert pool.try_reserve(1)
        assert pool.snapshot()["reserved_pages"] == 4

    def test_rejects_degenerate_shapes(self):
        with pytest.raises(ValueError, match="scratch"):
            tpool.PagePool(1, 4)
        with pytest.raises(ValueError, match="page_size"):
            tpool.PagePool(4, 0)

    @pytest.mark.parametrize("positions,page_size", [(1, 8), (8, 8),
                                                     (9, 8), (700, 128)])
    def test_sizing_matches_jax(self, positions, page_size):
        assert tpool.pages_for(positions, page_size) \
            == jpool.pages_for(positions, page_size)
        assert tpool.default_pool_pages(3, positions, page_size, 4) \
            == jpool.default_pool_pages(3, positions, page_size, 4)


def test_paged_step_appends_through_the_table(model):
    """One paged step writes each active slot's K/V at page
    table[s, len // ps], offset len % ps, and advances only active
    slots; the emitted token comes from the pre-step logits."""
    _, tparams, table = model
    ps = 4
    state = tpool.init_paged_state(BLOCKS, 6, ps, HEADS, EMBED // HEADS,
                                   VOCAB, 2, device="cpu")
    state["lengths"][:] = torch.tensor([5, 2], dtype=torch.int32)
    state["logits"][0, 7] = 1.0
    state["logits"][1, 9] = 1.0
    page_table = torch.tensor([[3, 4], [0, 0]], dtype=torch.int32)
    active = torch.tensor([True, False])
    state, emitted = tpool.paged_slot_step(tparams,
                                           torch.from_numpy(table), HEADS,
                                           state, page_table, active)
    assert emitted.tolist() == [7, 9]
    assert state["lengths"].tolist() == [6, 2]
    assert state["k"][:, 4, 1].abs().sum() > 0       # slot 0: page 4, off 1
    assert state["k"][:, 0, 2].abs().sum() > 0       # slot 1: scratch
    assert state["k"][:, 3].abs().sum() == 0


def test_entry_points_refuse_a_missing_card(model, monkeypatch):
    """device=None means the card; without one nothing falls back to the
    CPU quietly."""
    _, tparams, table = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.init_transformer_params(numpy.random.RandomState(0), 1, 8, 2,
                                    16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdec.generate(tparams, torch.from_numpy(table),
                      numpy.zeros((1, 3), numpy.int64), HEADS, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpool.init_paged_state(1, 4, 4, 2, 4, 16, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax({"w": numpy.zeros(3, numpy.float32)})
