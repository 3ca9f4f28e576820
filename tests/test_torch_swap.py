"""The prefix cache's survival across decoders and the live weight
hot-swap (veles_tpu_torch/parallel/kv_pool.py, serving.py) on the CPU
against the JAX package: page shadows captured from a dying decoder and
restored into a fresh pool by copy (float and int8-KV pools), the
decoder's swap_params and its refusals, and GenerateAPI's drain-then-swap
seam, rollback and poisoned-checkpoint gate over HTTP.

Tolerances: a restored page is bit-equal to its shadow (a copy), and
within 1e-5 of the JAX package's restored page (the same prefill in f32
on both sides, summed in another order); the int8 codes of the two
sides are compared after dequantization, within 1e-5 plus one code step
where a rounding boundary falls between them. Greedy streams are
compared exactly."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu import serving as jserving
from veles_tpu.parallel import decode as jdec
from veles_tpu.parallel import transformer_step as jts
from veles_tpu_torch import serving as tserving
from veles_tpu_torch import serving_chaos as tchaos
from veles_tpu_torch.parallel import kv_pool as tpool
from veles_tpu_torch.parallel import transformer_step as tts

torch.set_num_threads(1)

BLOCKS, EMBED, HEADS, VOCAB = 2, 32, 4, 64
PS, N_TOKENS = 8, 4


def _weights(seed):
    jparams = jts.init_transformer_params(numpy.random.RandomState(seed),
                                          BLOCKS, EMBED, HEADS, VOCAB)
    tparams = tts.init_transformer_params(numpy.random.RandomState(seed),
                                          BLOCKS, EMBED, HEADS, VOCAB,
                                          device="cpu")
    return jparams, tparams


@pytest.fixture(scope="module")
def model():
    jparams, tparams = _weights(0)
    jparams2, tparams2 = _weights(5)
    table = numpy.random.RandomState(1).randn(VOCAB, EMBED).astype(
        numpy.float32)
    return {"j": jparams, "t": tparams, "j2": jparams2, "t2": tparams2,
            "table": table}


def _args(quantize, kwargs):
    args = dict(slots=2, max_len=64, n_tokens=N_TOKENS, paged=True,
                page_size=PS, quantize=quantize)
    args.update(kwargs)
    return args


def _ours(model, quantize=None, which="", **kwargs):
    return tserving.ContinuousDecoder(
        model["t" + which], torch.from_numpy(model["table"]), HEADS,
        device="cpu", **_args(quantize, kwargs))


def _theirs(model, quantize=None, which="", **kwargs):
    return jserving.ContinuousDecoder(
        model["j" + which], jnp.asarray(model["table"]), HEADS,
        **_args(quantize, kwargs))


def _pair(model, quantize=None, which=""):
    return (_ours(model, quantize, which),
            _theirs(model, quantize, which))


def _generate(model, prompt, quantize=None, which="", max_len=64):
    toks, _ = jdec.generate(model["j" + which], jnp.asarray(model["table"]),
                            jnp.asarray(numpy.asarray(prompt)[None]), HEADS,
                            n_tokens=N_TOKENS, max_len=max_len,
                            quantize=quantize)
    return numpy.asarray(toks)[0].tolist()


def _prompts():
    rng = numpy.random.RandomState(3)
    system = rng.randint(0, VOCAB, 2 * PS)
    return [system, rng.randint(0, VOCAB, 3 * PS),
            numpy.concatenate([system, rng.randint(0, VOCAB, 3)])]


def _serve(dec, prompts):
    rids = [dec.submit(p) for p in prompts]
    dec.run_until_drained(chunk=2)
    return [list(dec.results[rid]) for rid in rids]


def _leaf(state, name, page):
    val = state[name][:, page]
    return (val.float().numpy() if isinstance(val, torch.Tensor)
            else numpy.asarray(val, numpy.float32))


# -- the prefix cache across a rebuild -----------------------------------------

@pytest.mark.parametrize("quantize", [None, "int8-kv"],
                         ids=["float", "int8-kv"])
def test_restore_matches_jax_page_for_page(model, quantize):
    """Shadows captured from the dying decoders, a fresh decoder on each
    side built with prefix_cache=: the entries' tokens and the prefix_*
    counters equal the JAX package's; each restored page is bit-equal to
    its shadow and within 1e-5 of the JAX package's restored page; the
    cached prompt is then a hit streaming its pre-trip tokens, without a
    new miss."""
    prompts = _prompts()
    ours, theirs = _pair(model, quantize)
    streams = _serve(ours, prompts)
    assert streams == _serve(theirs, prompts)
    ours.pool.capture_shadows(ours.state)
    theirs.pool.capture_shadows(theirs.state)
    assert sorted(ours.pool.cache.page_shadow) \
        == sorted(theirs.pool.cache.page_shadow)
    rebuilt = _ours(model, quantize, prefix_cache=ours.pool.cache)
    jrebuilt = _theirs(model, quantize, prefix_cache=theirs.pool.cache)
    tcache, jcache = rebuilt.pool.cache, jrebuilt.pool.cache
    assert [e["tokens"].tolist() for e in tcache.entries.values()] \
        == [e["tokens"].tolist() for e in jcache.entries.values()]
    assert tcache.counters == jcache.counters
    assert rebuilt.restore_stats["pages"] == len(tcache.page_shadow) > 0
    leaves = ("k", "v", "k_scale", "v_scale") if quantize else ("k", "v")
    for tentry, jentry in zip(tcache.entries.values(),
                              jcache.entries.values()):
        for tpage, jpage in zip(tentry["pages"], jentry["pages"]):
            for name in leaves:
                assert torch.equal(rebuilt.state[name][:, tpage],
                                   tcache.page_shadow[tpage][name])
            if quantize:
                for kind in ("k", "v"):
                    ours_val = _leaf(rebuilt.state, kind, tpage) \
                        * _leaf(rebuilt.state, kind + "_scale",
                                tpage)[:, :, None, :]
                    theirs_val = _leaf(jrebuilt.state, kind, jpage) \
                        * _leaf(jrebuilt.state, kind + "_scale",
                                jpage)[:, :, None, :]
                    step = _leaf(rebuilt.state, kind + "_scale",
                                 tpage).max()
                    numpy.testing.assert_allclose(
                        ours_val, theirs_val, rtol=0, atol=1e-5 + step)
                    numpy.testing.assert_allclose(
                        _leaf(rebuilt.state, kind + "_scale", tpage),
                        _leaf(jrebuilt.state, kind + "_scale", jpage),
                        rtol=1e-5, atol=1e-6)
            else:
                for name in leaves:
                    numpy.testing.assert_allclose(
                        _leaf(rebuilt.state, name, tpage),
                        _leaf(jrebuilt.state, name, jpage),
                        rtol=1e-5, atol=1e-5)
    misses = rebuilt.pool.snapshot()["prefix_misses"]
    hit = rebuilt.submit(prompts[0])
    rebuilt.run_until_drained(chunk=2)
    assert rebuilt.results[hit] == streams[0]
    assert rebuilt.dispatch_counts["admit_hit"] == 1
    assert rebuilt.pool.snapshot()["prefix_misses"] == misses


def test_an_unshadowed_entry_is_dropped_as_an_eviction(model):
    """A page without a shadow (its capture failed) drops every entry
    that names it, counted as evictions, as the JAX package counts them;
    the rest restore."""
    prompts = _prompts()
    ours, theirs = _pair(model)
    _serve(ours, prompts)
    _serve(theirs, prompts)
    for dec in (ours, theirs):
        dec.pool.capture_shadows(dec.state)
        third = list(dec.pool.cache.entries.values())[-1]["pages"][-1]
        del dec.pool.cache.page_shadow[third]
    rebuilt = _ours(model, prefix_cache=ours.pool.cache)
    jrebuilt = _theirs(model, prefix_cache=theirs.pool.cache)
    tsnap, jsnap = rebuilt.pool.snapshot(), jrebuilt.pool.snapshot()
    for key in ("prefix_entries", "prefix_evictions", "pages_used"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["prefix_evictions"] >= 1
    assert 0 < tsnap["prefix_entries"] < len(ours.pool.cache.entries) \
        + tsnap["prefix_evictions"]


def test_restore_copies_every_pool_leaf():
    """_paged_restore writes each leaf's pages in place and nothing
    else."""
    state = tpool.init_paged_state(2, 6, 4, 2, 3, 10, 2, quantized=True,
                                   device="cpu")
    before = {k: v.clone() for k, v in state.items()}
    values = {name: torch.full((2, 2) + tuple(state[name].shape[2:]), 7,
                               dtype=state[name].dtype)
              for name in ("k", "v", "k_scale", "v_scale")}
    out = tpool._paged_restore(state, [4, 2], values)
    assert out is state
    for name in values:
        assert (state[name][:, [2, 4]] == 7).all()
        assert torch.equal(state[name][:, [0, 1, 3, 5]],
                           before[name][:, [0, 1, 3, 5]])


# -- the decoder's swap ----------------------------------------------------------

@pytest.mark.parametrize("quantize", [None, "int8"])
def test_decoder_swap_matches_jax(model, quantize):
    """swap_params on an idle decoder: the returned pair is the old one,
    the prefix cache is flushed, and the streams after the swap equal
    the JAX decoder's after its swap and generate() on the new
    weights."""
    prompts = _prompts()
    ours, theirs = _pair(model, quantize)
    _serve(ours, prompts)
    _serve(theirs, prompts)
    assert len(ours.pool.cache) > 0
    old = ours.swap_params(model["t2"])
    assert old[0] is not ours.params and old[1] is ours.embed_table
    theirs.swap_params(model["j2"])
    assert len(ours.pool.cache) == len(theirs.pool.cache) == 0
    assert not ours.pool.cache.page_shadow
    after = _serve(ours, prompts)
    assert after == _serve(theirs, prompts)
    assert after == [_generate(model, p, quantize, "2") for p in prompts]


def _refusals(params, table, module, heads):
    dec = module.ContinuousDecoder(params, table, heads, slots=2,
                                   max_len=32, n_tokens=2,
                                   **({"device": "cpu"}
                                      if module is tserving else {}))
    cases = []
    no_lnf = {k: v for k, v in params.items() if k != "lnf_b"}
    wide_head = dict(params, head=params["head"][:, :-1])
    if module is tserving:
        bf16_head = dict(params, head=params["head"].to(torch.bfloat16))
    else:
        bf16_head = dict(params, head=params["head"].astype(jnp.bfloat16))
    for bad in (no_lnf, wide_head, bf16_head):
        with pytest.raises(ValueError) as info:
            dec.swap_params(bad)
        cases.append(str(info.value))
    return cases


def test_swap_refusals_match_jax(model):
    """A tree, shape or dtype mismatch is refused with the JAX package's
    messages (the tree's own printout aside), and the old weights stay."""
    ours = _refusals(model["t"], torch.from_numpy(model["table"]),
                     tserving, HEADS)
    theirs = _refusals(model["j"], jnp.asarray(model["table"]), jserving,
                       HEADS)
    prefix = ("swap refused: checkpoint tree structure does not match "
              "the serving params (")
    assert ours[0].startswith(prefix) and theirs[0].startswith(prefix)
    assert ours[1:] == theirs[1:]
    assert "[0]['head'] is float32(32, 63) in the checkpoint" in ours[1]
    assert "[0]['head'] is bfloat16(32, 64)" in ours[2]


def test_non_finite_leaf_matches_jax(model):
    bad_t = dict(model["t"], lnf_w=model["t"]["lnf_w"].clone())
    bad_t["lnf_w"][3] = float("inf")
    bad_j = dict(model["j"], lnf_w=model["j"]["lnf_w"].at[3].set(
        float("inf")))
    assert tserving._non_finite_leaf(bad_t) \
        == jserving._non_finite_leaf(bad_j) == "['lnf_w']"
    table = torch.from_numpy(model["table"]).clone()
    table[0, 0] = float("nan")
    assert tserving._non_finite_leaf((model["t"], table)) == "[1]"
    assert tserving._non_finite_leaf(model["t"]) is None


# -- the hot swap over HTTP ---------------------------------------------------------

def _post(port, tokens, timeout=60):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps({"tokens": tokens}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


@pytest.fixture
def api(model):
    api = tserving.GenerateAPI(
        model["t"], torch.from_numpy(model["table"]), HEADS, slots=3,
        max_len=64, n_tokens=N_TOKENS, chunk=2, paged=True, page_size=PS,
        quantize="int8", rebuild_backoff=0.01, device="cpu",
        chaos=tchaos.ServingChaosMonkey(tchaos.ServingChaosConfig(
            slow_step=1.0, slow_step_ms=5.0))).start()
    yield api
    api.stop()


def test_swap_drains_in_flight_on_the_old_weights(model, api):
    """A burst in flight when the swap is asked for finishes on weights
    A (the staged queue holds, nothing is shed); later requests equal a
    fresh API on weights B; rollback_swap brings A's streams back; a
    NaN checkpoint is refused, naming the leaf, and A keeps serving."""
    prompts = [p.tolist() for p in _prompts()]
    want_a = [_generate(model, p, "int8") for p in prompts]
    want_b = [_generate(model, p, "int8", "2") for p in prompts]
    answers = [None] * len(prompts)

    def client(i):
        answers[i] = _post(api.port, prompts[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    first = api.decoder._next_id
    for thread in threads:
        thread.start()
    for _ in range(3000):   # every request submitted to the decoder
        if api.decoder._next_id == first + len(prompts):
            break
        time.sleep(0.005)
    assert api.swap_params(model["t2"], version="B") is True
    for thread in threads:
        thread.join(timeout=60)
    assert [a[0] for a in answers] == [200] * 3
    assert [a[1]["tokens"] for a in answers] == want_a
    assert [_post(api.port, p)[1]["tokens"] for p in prompts] == want_b
    snap = api.health.snapshot()
    assert snap["version"] == "B" and api.decoder.version == "B"
    assert snap["counters"]["param_swaps"] == 1
    assert snap["counters"]["shed"] == 0 == snap["counters"]["errors"]
    assert api.last_swap["drain_s"] > 0
    assert api.rollback_swap() is True
    assert [_post(api.port, p)[1]["tokens"] for p in prompts] == want_a
    poisoned = dict(model["t2"], lnf_w=torch.full_like(model["t2"]["lnf_w"],
                                                      float("nan")))
    with pytest.raises(RuntimeError, match=r"non-finite.*\['lnf_w'\]"):
        api.swap_params(poisoned, version="poison")
    assert api.health.counter("swap_failures") == 1
    assert [_post(api.port, p)[1]["tokens"] for p in prompts] == want_a


def test_zero_5xx_across_the_swap_window(model, api):
    """A client posting through the drain-then-swap window sees only
    200s: the seam holds requests, it never sheds them."""
    codes, stop = [], threading.Event()

    def pound():
        while not stop.is_set():
            codes.append(_post(api.port, [2, 3])[0])

    thread = threading.Thread(target=pound)
    thread.start()
    try:
        time.sleep(0.1)
        assert api.swap_params(model["t2"], version="v2") is True
        time.sleep(0.1)
    finally:
        stop.set()
        thread.join(60)
    assert codes and set(codes) == {200}


def test_poison_profile_refuses_the_first_swap(model):
    """deploy_poison_nan poisons the first swap's checkpoint: refused,
    the old weights serve, and the next swap lands."""
    monkey = tchaos.ServingChaosMonkey(tchaos.ServingChaosConfig(
        deploy_poison_nan=True))
    api = tserving.GenerateAPI(
        model["t"], torch.from_numpy(model["table"]), HEADS, slots=2,
        max_len=64, n_tokens=N_TOKENS, chunk=2, device="cpu",
        chaos=monkey).start()
    try:
        with pytest.raises(RuntimeError, match=r"\['blocks'\]\[0\]\['b1'\]"):
            api.swap_params(model["t2"])
        assert _post(api.port, [4, 5, 6])[1]["tokens"] \
            == _generate(model, [4, 5, 6], max_len=64)
        assert api.swap_params(model["t2"]) is True
        assert _post(api.port, [4, 5, 6])[1]["tokens"] \
            == _generate(model, [4, 5, 6], which="2", max_len=64)
    finally:
        api.stop()
