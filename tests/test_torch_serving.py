"""The port's serving tier (veles_tpu_torch/serving.py) on the CPU:
ContinuousDecoder streams against the JAX package's paged
ContinuousDecoder and generate() on the same weights, the GenerateAPI
HTTP contract (round trip, 400, 429, 503, 504), the refusal to run
without a card unless asked for the CPU, and the package's isolation
from JAX."""

import json
import os
import subprocess
import sys
import textwrap
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
from veles_tpu_torch.parallel import decode as tdec
from veles_tpu_torch.parallel import transformer_step as tts

torch.set_num_threads(1)

BLOCKS, EMBED, HEADS, VOCAB = 2, 32, 4, 64
PS, SLOTS, MAX_LEN = 8, 3, 48
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _prompts():
    rng = numpy.random.RandomState(2)
    return [rng.randint(0, VOCAB, n).astype(numpy.int32)
            for n in (5, 17, 8, 3, 20, 11)]


def _drive(decoder, prompts, chunk):
    """Three requests up front, then one more joining mid-flight on
    every driver pass (the staggered-submission hook); returns each
    prompt's stream."""
    rids = [decoder.submit(p) for p in prompts[:3]]
    later = list(prompts[3:])

    def admit():
        if later:
            rids.append(decoder.submit(later.pop(0)))

    decoder.drain_pipelined(chunk, admit=admit)
    return [list(decoder.results[rid]) for rid in rids]


def _jax_generate(jparams, table, prompt, n_tokens, quantize):
    toks, _ = jdec.generate(jparams, jnp.asarray(table),
                            jnp.asarray(prompt[None]), HEADS,
                            n_tokens=n_tokens, quantize=quantize)
    return numpy.asarray(toks)[0].tolist()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_decoder_streams_match_jax_decoder_and_generate(model, quantize):
    """Greedy streams of staggered mid-flight joins, ragged admission
    and lag-1 chunks: token for token the JAX paged decoder's and each
    prompt's JAX generate() (f32, the same weights)."""
    jparams, tparams, table = model
    prompts = _prompts()
    ours = _drive(tserving.ContinuousDecoder(
        tparams, torch.from_numpy(table), HEADS, slots=SLOTS,
        max_len=MAX_LEN, n_tokens=10, paged=True, page_size=PS,
        quantize=quantize, device="cpu"), prompts, chunk=4)
    theirs = _drive(jserving.ContinuousDecoder(
        jparams, jnp.asarray(table), HEADS, slots=SLOTS, max_len=MAX_LEN,
        n_tokens=10, paged=True, page_size=PS, quantize=quantize),
        prompts, chunk=4)
    assert ours == theirs
    for prompt, stream in zip(prompts, ours):
        assert stream == _jax_generate(jparams, table, prompt, 10,
                                       quantize)
    assert len({t for s in ours for t in s}) > 8   # streams worth comparing


def test_single_steps_eos_and_cancel(model):
    """step() by step(): streams equal generate() cut at eos (inclusive);
    cancelling frees the slot and returns every page."""
    jparams, tparams, table = model
    prompts = _prompts()[:3]
    refs = [_jax_generate(jparams, table, p, 8, None) for p in prompts]
    eos = refs[1][3]
    dec = tserving.ContinuousDecoder(
        tparams, torch.from_numpy(table), HEADS, slots=2, max_len=MAX_LEN,
        n_tokens=8, eos=eos, paged=True, page_size=PS, device="cpu")
    rids = [dec.submit(p) for p in prompts]
    dec.run_until_drained()
    for rid, ref in zip(rids, refs):
        cut = ref[:ref.index(eos) + 1] if eos in ref else ref
        assert dec.results[rid] == cut
    # every page not held by a prefix-cache entry is back in the pool
    cached = len({page for entry in dec.pool.cache.entries.values()
                  for page in entry["pages"]})
    assert cached and dec.pool.used_pages == cached
    rid = dec.submit(prompts[0])
    dec.step()
    assert dec.pool.used_pages > cached
    assert dec.cancel(rid) and not dec.cancel(rid)
    assert dec.pool.used_pages == cached and not dec.busy


def test_decoder_samples_reproducibly_from_its_seed(model):
    """temperature > 0 draws each request from its own key stream, derived
    from the decoder's seed: the same seed and submissions give the same
    in-vocab streams."""
    _, tparams, table = model
    runs = []
    for _ in range(2):
        dec = tserving.ContinuousDecoder(
            tparams, torch.from_numpy(table), HEADS, slots=2,
            max_len=MAX_LEN, n_tokens=6, temperature=0.9, top_k=8, seed=5,
            paged=True, page_size=PS, device="cpu")
        rids = [dec.submit(p) for p in _prompts()[:3]]
        dec.drain_pipelined(2)
        runs.append([dec.results[rid] for rid in rids])
    assert runs[0] == runs[1]
    assert all(len(s) == 6 and all(0 <= t < VOCAB for t in s)
               for s in runs[0])


def test_decoder_refuses_what_this_slice_does_not_serve(model,
                                                        monkeypatch):
    _, tparams, table = model
    table = torch.from_numpy(table)
    with pytest.raises(ValueError, match="quantize"):
        tserving.ContinuousDecoder(tparams, table, HEADS,
                                   quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        tserving.ContinuousDecoder(tparams, table, HEADS, paged=True,
                                   page_size=0, device="cpu")
    dec = tserving.ContinuousDecoder(tparams, table, HEADS, max_len=16,
                                     n_tokens=4, paged=True, page_size=PS,
                                     device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        dec.submit(numpy.zeros(13, numpy.int32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.ContinuousDecoder(tparams, table, HEADS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.GenerateAPI(tparams, table, HEADS)


# -- the HTTP front -------------------------------------------------------

def _post(port, payload, timeout=60):
    data = (payload if isinstance(payload, bytes)
            else json.dumps(payload).encode())
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port, data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
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
        args = dict(slots=SLOTS, max_len=MAX_LEN, n_tokens=6, chunk=2,
                    paged=True, page_size=PS, device="cpu")
        args.update(kwargs)
        api = tserving.GenerateAPI(tparams, torch.from_numpy(table), HEADS,
                                   **args).start()
        started.append(api)
        return api

    yield make
    for api in started:
        api.stop()


def _hold_dispatch(api):
    """Make the driver's next dispatch wait for the returned event."""
    release = threading.Event()
    dispatch = api.decoder.dispatch_chunk

    def held(chunk):
        release.wait(30)
        return dispatch(chunk)

    api.decoder.dispatch_chunk = held
    return release


def _wait_inflight(api, n):
    for _ in range(3000):
        if _health(api.port)["inflight"] == n:
            return
        time.sleep(0.01)
    raise AssertionError("never saw %d requests in flight" % n)


def test_http_round_trip_three_concurrent(model, api_factory):
    _, tparams, table = model
    api = api_factory()
    prompts = _prompts()[:3]
    answers = [None] * 3

    def client(i):
        answers[i] = _post(api.port, {"tokens": prompts[i].tolist()})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(3)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
    assert not any(thread.is_alive() for thread in threads)
    for prompt, (code, body, _) in zip(prompts, answers):
        ref, _ = tdec.generate(tparams, torch.from_numpy(table),
                               prompt[None], HEADS, n_tokens=6,
                               device="cpu")
        assert code == 200 and body["tokens"] == ref[0].tolist()
    health = _health(api.port)
    assert health["ready"] and health["counters"]["completed"] == 3
    assert health["inflight"] == 0
    assert health["pool"]["reserved_pages"] == 0
    # the prompts' whole pages stay published in the prefix cache; every
    # other page is back in the pool
    cached = {page for entry in api.decoder.pool.cache.entries.values()
              for page in entry["pages"]}
    assert health["pool"]["pages_used"] == len(cached)
    assert health["pool"]["prefix_misses"] == 3


@pytest.mark.parametrize("payload,match", [
    ({"tokens": []}, "non-empty"),
    ({"tokens": [VOCAB]}, "non-empty"),
    ({"tokens": "12"}, "non-empty"),
    ({"tokens": [1], "n_tokens": 0}, "positive"),
    ({"tokens": [1], "deadline_s": -1}, "deadline_s"),
    ({"tokens": [1] * (MAX_LEN - 5)}, "max_len"),
    ({"n_tokens": 3}, "tokens"),
    (b"{not json", ""),
], ids=["empty", "out-of-vocab", "not-a-list", "n_tokens", "deadline",
        "too-long", "no-tokens", "bad-json"])
def test_http_400(api_factory, payload, match):
    api = api_factory()
    code, body, _ = _post(api.port, payload)
    assert code == 400 and match in body["error"]


def test_http_429_when_the_queue_is_full(api_factory):
    api = api_factory(max_queue=1)
    release = _hold_dispatch(api)
    first = []
    thread = threading.Thread(
        target=lambda: first.append(_post(api.port, {"tokens": [1, 2]})))
    thread.start()
    _wait_inflight(api, 1)
    code, body, headers = _post(api.port, {"tokens": [3]})
    assert code == 429 and "saturated" in body["error"]
    assert headers.get("Retry-After") == "1"
    release.set()
    thread.join(timeout=60)
    assert first and first[0][0] == 200 and len(first[0][1]["tokens"]) == 6


def test_http_429_when_the_pool_cannot_hold_the_request(api_factory):
    # 3 allocatable pages of 8 positions; 20 + 6 tokens + two chunks of
    # lag-1 slack need 4
    api = api_factory(pool_pages=4)
    code, body, _ = _post(api.port, {"tokens": list(range(20))})
    assert code == 429 and "pool" in body["error"]
    code, body, _ = _post(api.port, {"tokens": list(range(5))})
    assert code == 200


def test_http_504_at_the_deadline(api_factory):
    api = api_factory(n_tokens=40, chunk=1)
    dispatch = api.decoder.dispatch_chunk

    def slow(chunk):
        time.sleep(0.05)
        return dispatch(chunk)

    api.decoder.dispatch_chunk = slow
    code, body, _ = _post(api.port, {"tokens": [1, 2, 3],
                                     "deadline_s": 0.3})
    assert code == 504 and "deadline" in body["error"]
    health = _health(api.port)
    assert health["counters"]["expired"] == 1
    assert health["pool"]["reserved_pages"] == 0


def test_http_503_after_a_decoder_failure(model, api_factory):
    """The JAX package's breaker contract: the request in flight when
    the decoder faults is shed with a retryable 503 naming the fault
    (Retry-After: 1), and the server heals (rebuild, probe) and answers
    200 again without a restart."""
    _, tparams, table = model
    api = api_factory(rebuild_backoff=0.01)

    def broken(chunk):
        raise RuntimeError("injected device fault")

    api.decoder.dispatch_chunk = broken
    code, body, headers = _post(api.port, {"tokens": [1, 2]})
    assert code == 503 and "injected device fault" in body["error"]
    assert headers.get("Retry-After") == "1"
    for _ in range(3000):
        if api.health.ready:
            break
        time.sleep(0.01)
    health = _health(api.port)
    assert health["ready"] and health["breaker"] == "closed"
    assert health["counters"]["shed"] == 1
    assert health["counters"]["trips"] == health["counters"]["rebuilds"] == 1
    code, body, _ = _post(api.port, {"tokens": [1, 2]})
    ref, _ = tdec.generate(tparams, torch.from_numpy(table),
                           numpy.asarray([[1, 2]]), HEADS, n_tokens=6,
                           device="cpu")
    assert code == 200 and body["tokens"] == ref[0].tolist()


def test_port_imports_neither_jax_nor_veles_tpu():
    """Every module of the port, and chip_smoke.py, imports with JAX and
    the JAX package blocked."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "veles_tpu"):
            sys.modules[name] = None
        import veles_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            veles_tpu_torch.__path__, "veles_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        leaked = [m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "veles_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            env=env, capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr
    assert int(result.stdout.split()[-1]) >= 12
