"""The port's prefix cache and its three admission families (cold, tail,
hit) against the JAX package, on the CPU: the page-boundary digests and
the pool's cache bookkeeping, then the paged ContinuousDecoder's streams,
dispatch counts and ``prefix_*`` pool counters against the JAX paged
decoder and generate() on the same weights and prompts (the analogues
of tests/test_paged.py), and the HTTP front's pool-priced Retry-After
and /healthz prefix fields.

The JAX decoder runs its gather path here, whose admission groups are
keyed by pow2 prompt buckets; the port's are ragged. The workloads keep
every group within one bucket, so the dispatch counts are comparable."""

import inspect
import json
import urllib.error
import urllib.request

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu import serving as jserving
from veles_tpu.parallel import decode as jdec
from veles_tpu.parallel import kv_pool as jpool
from veles_tpu.parallel import transformer_step as jts
from veles_tpu_torch import serving as tserving
from veles_tpu_torch.parallel import kv_pool as tpool
from veles_tpu_torch.parallel import transformer_step as tts

torch.set_num_threads(1)

PS = 8
BLOCKS, EMBED, HEADS, VOCAB = 2, 32, 4, 64
DISPATCH_KEYS = ("admit", "admit_tail", "admit_hit", "admit_requests")
PREFIX_KEYS = ("prefix_entries", "prefix_hits", "prefix_misses",
               "prefix_evictions", "pages_used")


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


# -- host side --------------------------------------------------------------

@pytest.mark.parametrize("n", [0, PS - 1, PS, 5 * PS + 3])
def test_boundary_keys_match_jax(n):
    tokens = numpy.random.RandomState(n).randint(0, 50000, n)
    whole = n // PS
    keys = tpool._boundary_keys(tokens, PS, whole)
    assert keys == jpool._boundary_keys(tokens, PS, whole)
    assert keys == [jpool._prefix_key(tokens[:k * PS])
                    for k in range(1, whole + 1)]


def _pool_pair(pages=8):
    return tpool.PagePool(pages, PS), jpool.PagePool(pages, PS)


def _snap(pool):
    snap = pool.snapshot()
    return {key: snap[key] for key in snap if key != "reserved_pages"}


def test_hit_counter_monotone_under_rollback():
    """A lookup rolled back by unlookup (no pages for the tail) moves no
    counter; the retried admission books one hit, in both packages."""
    for pool in _pool_pair():
        tokens = numpy.arange(PS, dtype=numpy.int32)
        pages = pool.alloc(1)
        if isinstance(pool, jpool.PagePool):
            pool.insert(tokens, pages, None)
        else:
            pool.insert(tokens, pages)
        longer = numpy.arange(2 * PS, dtype=numpy.int32)
        entry, shared = pool.lookup(longer)
        assert entry is not None and shared == PS
        pool.unlookup(entry)
        assert pool.cache.counters["hits"] == 0
        entry, shared = pool.lookup(longer)
        pool.book_hit()
        assert pool.cache.counters["hits"] == 1


def _replay(pool, jax_side):
    """One sequence of cache operations: two admissions publish their
    whole pages (one with logits), the slots retire, a partial and an
    exact lookup hit, the int8 rule refuses a partial one, a short pool
    evicts LRU entries, then a flush."""
    logits = numpy.arange(4, dtype=numpy.float32)
    a = numpy.arange(2 * PS, dtype=numpy.int32)
    b = numpy.arange(100, 100 + 3 * PS + 2, dtype=numpy.int32)
    for tokens, with_logits in ((a, True), (b, False)):
        pages = pool.alloc(len(tokens) // PS + 1)
        args = (tokens, pages) + ((None,) if jax_side else ())
        pool.insert(*args, logits=logits if with_logits else None)
        pool.release(pages)
    seen = []
    entry, shared = pool.lookup(numpy.concatenate([a, [7, 7]]))
    seen.append(shared)
    pool.book_hit()
    pool.release(entry["pages"])
    entry, shared = pool.lookup(a)
    seen.append((shared, list(entry["logits"])))
    pool.book_hit()
    pool.release(entry["pages"])
    seen.append(pool.lookup(b[:2 * PS + 1], allow_partial=False)[1])
    pool.book_miss()
    seen.append(_snap(pool))
    got = pool.alloc(pool.free_pages + 2)      # evicts the two LRU entries
    seen.append((len(got), _snap(pool)))
    pool.release(got)
    seen.append((pool.flush_prefix_cache(), _snap(pool)))
    return seen


def test_cache_bookkeeping_matches_jax():
    tpool_, jpool_ = _pool_pair(pages=10)
    assert _replay(tpool_, False) == _replay(jpool_, True)


def test_retry_after_priced_from_release_rate(monkeypatch):
    """A cold window answers the fallback; once pages were released the
    observed rate prices the wait, clamped at 1 s, in both packages."""
    monkeypatch.setattr(tpool, "RETRY_AFTER_FALLBACK_S", 2.5)
    for pool in _pool_pair():
        fallback = ({} if isinstance(pool, tpool.PagePool)
                    else {"fallback": 2.5})
        assert pool.retry_after(4, **fallback) == 2.5
        assert pool.release_rate() == 0.0
        pool.release(pool.alloc(4))
        assert pool.release_rate() > 0
        assert pool.retry_after(4) == 1.0


@pytest.mark.parametrize("constant, method, argument", [
    ("PREFIX_CACHE_ENTRIES", jpool.PrefixCache.__init__, "max_entries"),
    ("RELEASE_WINDOW_S", jpool.PagePool.release_rate, "window"),
    ("RETRY_AFTER_FALLBACK_S", jpool.PagePool.retry_after, "fallback"),
])
def test_pool_constants_are_the_jax_defaults(constant, method, argument):
    """The port fixes at module level what the JAX package takes as an
    argument that its serving path leaves at the default."""
    default = inspect.signature(method).parameters[argument].default
    assert getattr(tpool, constant) == default


# -- the decoder against the JAX paged decoder ------------------------------

def _decoders(model, **kwargs):
    jparams, tparams, table = model
    args = dict(slots=2, page_size=PS, paged=True)
    args.update(kwargs)
    ours = tserving.ContinuousDecoder(tparams, torch.from_numpy(table),
                                      HEADS, device="cpu", **args)
    theirs = jserving.ContinuousDecoder(jparams, jnp.asarray(table),
                                        HEADS, **args)
    return ours, theirs


def _generate(model, prompt, n_tokens, max_len, quantize=None):
    jparams, _, table = model
    toks, _ = jdec.generate(jparams, jnp.asarray(table),
                            jnp.asarray(prompt)[None], HEADS,
                            n_tokens=n_tokens, max_len=max_len,
                            quantize=quantize)
    return numpy.asarray(toks)[0].tolist()


def _assert_same(ours, theirs):
    assert ours.results == theirs.results
    assert {k: ours.dispatch_counts[k] for k in DISPATCH_KEYS} \
        == {k: theirs.dispatch_counts[k] for k in DISPATCH_KEYS}
    ts, js = ours.pool.snapshot(), theirs.pool.snapshot()
    assert {k: ts[k] for k in PREFIX_KEYS} == {k: js[k] for k in PREFIX_KEYS}


@pytest.mark.parametrize("quantize", [None, "int8-kv"])
def test_composite_matches_jax_decoder_and_generate(model, quantize):
    """Staggered submissions joining mid-flight through the pipelined
    chunked drain, both KV tiers: streams, dispatch counts and pool
    counters equal the JAX paged decoder's, streams equal generate(),
    and every retired slot returned its pages but what the cache
    keeps."""
    prompts = [numpy.random.RandomState(1).randint(0, VOCAB, n)
               for n in (5, 3, 16, 4, 9)]
    decs = _decoders(model, max_len=32, n_tokens=6, quantize=quantize)
    for dec in decs:
        pending = list(prompts)
        for _ in range(2):
            dec.submit(pending.pop(0))
        dec.drain_pipelined(
            4, admit=lambda dec=dec, pending=pending:
                pending and dec.submit(pending.pop(0)))
    ours, theirs = decs
    _assert_same(ours, theirs)
    assert ours.max_len == theirs.max_len == (128 if quantize else 32)
    for rid, prompt in enumerate(prompts):
        assert ours.results[rid] == _generate(model, prompt, 6, 32,
                                              quantize)
    held = {page for entry in ours.pool.cache.entries.values()
            for page in entry["pages"]}
    assert ours.pool.used_pages == len(held) and not ours._slot_pages


def test_shared_prefix_tail_hit_and_divergence(model):
    """A page-aligned system prompt is prefilled once; prompts sharing
    it admit as tails, the exact prompt as a control-row hit; the cache
    entry keeps its page ids."""
    rng = numpy.random.RandomState(2)
    system = rng.randint(0, VOCAB, 2 * PS)
    prompts = [system] + [numpy.concatenate([system, rng.randint(
        0, VOCAB, n)]) for n in (5, 3, 7)] + [system]
    decs = _decoders(model, max_len=64, n_tokens=6)
    for dec in decs:
        dec.submit(prompts[0], 6)
        dec.run_until_drained()
        first = next(iter(dec.pool.cache.entries.values()))["pages"]
        for prompt in prompts[1:]:
            dec.submit(prompt, 6)
        dec.run_until_drained(chunk=4)
        assert next(iter(dec.pool.cache.entries.values()))["pages"] \
            == first
    ours, theirs = decs
    _assert_same(ours, theirs)
    assert ours.dispatch_counts["admit_tail"] >= 1
    assert ours.dispatch_counts["admit_hit"] >= 1
    assert ours.pool.snapshot()["prefix_hits"] == 4
    for rid, prompt in enumerate(prompts):
        assert ours.results[rid] == _generate(model, prompt, 6, 64)


def test_int8_kv_reuses_exact_prompts_only(model):
    rng = numpy.random.RandomState(3)
    system = rng.randint(0, VOCAB, 2 * PS)
    longer = numpy.concatenate([system, rng.randint(0, VOCAB, 4)])
    decs = _decoders(model, max_len=64, n_tokens=5, quantize="int8-kv")
    for dec in decs:
        dec.submit(system, 5)
        dec.run_until_drained()
        dec.submit(longer, 5)     # shares the prefix: must go cold
        dec.submit(system, 5)     # the exact prompt: a hit
        dec.run_until_drained(chunk=4)
    ours, theirs = decs
    _assert_same(ours, theirs)
    assert ours.dispatch_counts["admit_tail"] == 0
    assert ours.dispatch_counts["admit_hit"] == 1
    for rid, prompt in enumerate((system, longer, system)):
        assert ours.results[rid] == _generate(model, prompt, 5, 64,
                                              "int8-kv")


def test_eviction_under_pool_pressure(model):
    """Seven allocatable pages hold at most two cached two-page
    prefixes beside a live slot: later admissions evict LRU entries, in
    the same order and count as the JAX pool, with exact streams."""
    rng = numpy.random.RandomState(5)
    prompts = [rng.randint(0, VOCAB, 2 * PS) for _ in range(4)]
    decs = _decoders(model, slots=1, max_len=24, n_tokens=4, pool_pages=8)
    for dec in decs:
        for prompt in prompts:
            dec.submit(prompt, 4)
        dec.run_until_drained()
    ours, theirs = decs
    _assert_same(ours, theirs)
    assert ours.pool.snapshot()["prefix_evictions"] >= 1
    for rid, prompt in enumerate(prompts):
        assert ours.results[rid] == _generate(model, prompt, 4, 24)


def test_repeated_extended_prompt_converges_to_hit(model):
    """A tail admission publishes the extended prompt, so its second
    admission is a hit, not another tail prefill."""
    rng = numpy.random.RandomState(12)
    system = rng.randint(0, VOCAB, 2 * PS)
    extended = numpy.concatenate([system, rng.randint(0, VOCAB, PS)])
    decs = _decoders(model, max_len=64, n_tokens=6)
    for dec in decs:
        for prompt in (system, extended, extended):
            dec.submit(prompt, 6)
            dec.run_until_drained()
    ours, theirs = decs
    _assert_same(ours, theirs)
    assert ours.dispatch_counts["admit_tail"] == 1
    assert ours.dispatch_counts["admit_hit"] == 1
    want = _generate(model, extended, 6, 64)
    assert ours.results[1] == ours.results[2] == want


def test_cached_logits_survive_a_later_admission_into_the_slot(model):
    """The cache keeps a copy of a page-aligned prompt's logits: a later
    admission into the same slot, before any decode step replaced the
    logits tensor, writes that slot's row in place and must leave the
    entry's logits as they were; the hit then streams exactly."""
    _, tparams, table = model
    rng = numpy.random.RandomState(8)
    system = rng.randint(0, VOCAB, 2 * PS)
    dec = tserving.ContinuousDecoder(tparams, torch.from_numpy(table),
                                     HEADS, slots=1, max_len=32,
                                     n_tokens=5, paged=True, page_size=PS,
                                     device="cpu")
    first = dec.submit(system, 5)
    dec._admit_pending()
    entry, _ = dec.pool.lookup(system)
    dec.pool.unlookup(entry)
    kept = entry["logits"].clone()
    dec.cancel(first)
    dec.submit(rng.randint(0, VOCAB, 11), 5)
    dec._admit_pending()          # same slot, row written in place
    assert not torch.equal(dec.state["logits"][0], kept)
    assert torch.equal(entry["logits"], kept)
    rid = dec.submit(system, 5)
    dec.run_until_drained()
    assert dec.dispatch_counts["admit_hit"] == 1
    assert dec.results[rid] == _generate(model, system, 5, 32)


# -- the HTTP front ---------------------------------------------------------

def _post(port, payload):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode()), {}
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode()), dict(err.headers)


def _health(port):
    with urllib.request.urlopen("http://127.0.0.1:%d/healthz" % port,
                                timeout=30) as resp:
        return json.loads(resp.read().decode())


@pytest.fixture
def api_factory(model):
    _, tparams, table = model
    started = []

    def make(**kwargs):
        args = dict(slots=2, max_len=48, n_tokens=6, chunk=2,
                    paged=True, page_size=PS, device="cpu")
        args.update(kwargs)
        api = tserving.GenerateAPI(tparams, torch.from_numpy(table),
                                   HEADS, **args).start()
        started.append(api)
        return api

    yield make
    for api in started:
        api.stop()


def test_http_hit_and_healthz_prefix_fields(model, api_factory):
    api = api_factory()
    prompt = numpy.random.RandomState(4).randint(0, VOCAB, 2 * PS).tolist()
    answers = [_post(api.port, {"tokens": prompt}) for _ in range(2)]
    assert [code for code, _, _ in answers] == [200, 200]
    assert answers[0][1]["tokens"] == answers[1][1]["tokens"] \
        == _generate(model, numpy.asarray(prompt), 6, 48)
    health = _health(api.port)
    assert health["dispatch_counts"]["admit_hit"] == 1
    pool = health["pool"]
    assert (pool["prefix_hits"], pool["prefix_misses"],
            pool["prefix_entries"]) == (1, 1, 2)
    assert pool["prefix_hit_rate"] == 0.5


def test_http_int8_kv_round_trip(model, api_factory):
    api = api_factory(quantize="int8-kv")
    assert api.decoder.max_len == 128
    prompt = numpy.random.RandomState(6).randint(0, VOCAB, 13)
    code, body, _ = _post(api.port, {"tokens": prompt.tolist()})
    assert code == 200
    assert body["tokens"] == _generate(model, prompt, 6, 48, "int8-kv")


def test_http_pool_429_is_priced_by_the_release_rate(api_factory):
    api = api_factory(pool_pages=4)
    api.decoder.pool.retry_after = lambda need: 7.4 + need
    code, body, headers = _post(api.port, {"tokens": list(range(20))})
    assert code == 429 and "pool" in body["error"]
    assert headers.get("Retry-After") == "11"     # 7.4 + 4 pages
