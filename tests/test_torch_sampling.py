"""Per-request sampling streams of the port (veles_tpu_torch/parallel/
decode.py, kv_pool.py, serving.py) on the CPU.

The JAX package gives each request its own key stream, fold_in(req_key,
step) with req_key = fold_in(base_key, request_id), so a sampled
request's tokens equal generate(batch=1, key=req_key) whichever slot it
lands in and whoever shares its steps. Threefry's bits cannot be
reproduced in torch, so these tests hold the port to the same property
on its own streams (the counter hash of decode.gumbel_noise), in the
dense slab, the paged pool (cold, tail and hit admissions) and
generate(); and hold its draws to the softmax's distribution."""

import numpy
import pytest
import torch

from veles_tpu_torch import serving as tserving
from veles_tpu_torch.parallel import decode as tdec
from veles_tpu_torch.parallel import transformer_step as tts

torch.set_num_threads(1)

BLOCKS, EMBED, HEADS, VOCAB = 2, 32, 4, 64
PS, SLOTS, MAX_LEN, N_TOKENS = 8, 4, 48, 10
TEMPERATURE, TOP_K, SEED = 0.9, 8, 7
#: the 0.999 quantile of the chi-square distribution with 4 degrees of
#: freedom (top-k 5 leaves 5 cells): a correct sampler exceeds it once
#: in a thousand seeds, a sampler off by a few percent in one cell at
#: 20000 draws far more often
CHI2_999_DOF4 = 18.467


@pytest.fixture(scope="module")
def model():
    params = tts.init_transformer_params(numpy.random.RandomState(0),
                                         BLOCKS, EMBED, HEADS, VOCAB,
                                         device="cpu")
    table = torch.from_numpy(numpy.random.RandomState(1).randn(
        VOCAB, EMBED).astype(numpy.float32))
    return params, table


def _prompts():
    """Three prompts; on the pool the first is page-aligned (two pages)
    and the second extends it (a tail admission once the first is
    cached)."""
    rng = numpy.random.RandomState(2)
    first = rng.randint(0, VOCAB, 2 * PS)
    return [first, numpy.concatenate([first, rng.randint(0, VOCAB, 5)]),
            rng.randint(0, VOCAB, 11)]


def _decoder(model, paged, temperature=TEMPERATURE, seed=SEED):
    params, table = model
    return tserving.ContinuousDecoder(
        params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
        n_tokens=N_TOKENS, temperature=temperature, top_k=TOP_K, seed=seed,
        paged=paged, page_size=PS if paged else None, device="cpu")


def _generate(model, prompt, key, temperature=TEMPERATURE):
    params, table = model
    toks, _ = tdec.generate(params, table, numpy.asarray(prompt)[None],
                            HEADS, n_tokens=N_TOKENS, max_len=MAX_LEN,
                            temperature=temperature, top_k=TOP_K, key=key,
                            device="cpu")
    return toks[0].tolist()


def _alone(model, paged, prompts, rid):
    """Request ``rid``'s stream served alone: the requests before it are
    submitted and cancelled before any step, so it keeps its id (and its
    key) and takes the first free slot."""
    dec = _decoder(model, paged)
    for prompt in prompts[:rid]:
        dec.cancel(dec.submit(prompt))
    got = dec.submit(prompts[rid])
    dec.drain_pipelined(3)
    return dec.results[got], dec


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sampled_stream_is_the_requests_own(model, paged):
    """Each request's sampled stream is the same served beside the
    others (all at once), alone, in another slot and from
    generate(batch=1, key=request_key(seed, request_id))."""
    prompts = _prompts()
    dec = _decoder(model, paged)
    rids = [dec.submit(p) for p in prompts]
    dec.drain_pipelined(3)
    burst = [dec.results[rid] for rid in rids]
    assert all(len(s) == N_TOKENS for s in burst)
    assert len({tuple(s) for s in burst}) == 3
    for rid, prompt in enumerate(prompts):
        alone, single = _alone(model, paged, prompts, rid)
        assert alone == burst[rid]
        assert burst[rid] == _generate(model, prompt,
                                       tdec.request_key(SEED, rid))
    # alone, every request took slot SLOTS - 1; in the burst request 1
    # and 2 sat in slots SLOTS - 2 and SLOTS - 3
    assert SLOTS >= 3


def test_paged_admission_families_sample_their_own_streams(model):
    """The pool's cold, tail and hit admissions seat the request's key:
    the page-aligned prompt (cold), the same prompt again (a hit), its
    extension (a tail) and the prompt a third time (a hit beside a
    running request) each sample generate(key=their key)'s stream."""
    prompts = _prompts()
    dec = _decoder(model, True)
    order = [prompts[0], prompts[0], prompts[1], prompts[0]]
    rids = [dec.submit(order[0])]
    dec.drain_pipelined(3)
    rids += [dec.submit(p) for p in order[1:]]
    dec.drain_pipelined(3)
    assert dec.dispatch_counts["admit_hit"] >= 1
    assert dec.dispatch_counts["admit_tail"] >= 1
    streams = [dec.results[rid] for rid in rids]
    for rid, prompt, stream in zip(rids, order, streams):
        assert stream == _generate(model, prompt,
                                   tdec.request_key(SEED, rid))
    # one prompt, three requests: three keys, three streams
    assert len({tuple(streams[i]) for i in (0, 1, 3)}) == 3


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_streams_ignore_the_seed(model, paged):
    """temperature 0 stays greedy: the seed changes nothing, and the
    streams are generate()'s greedy ones."""
    prompts = _prompts()
    runs = []
    for seed in (0, 123):
        dec = _decoder(model, paged, temperature=0.0, seed=seed)
        rids = [dec.submit(p) for p in prompts]
        dec.drain_pipelined(3)
        runs.append([dec.results[rid] for rid in rids])
    assert runs[0] == runs[1]
    assert runs[0] == [_generate(model, p, None, temperature=0.0)
                       for p in prompts]


def test_generate_rows_draw_from_their_keys(model):
    """generate with one key per row: each row's stream is its own
    batch-1 stream with that key; an int key gives every row the same
    noise, so equal prompts give equal streams."""
    params, table = model
    prompt = _prompts()[2]
    batch = numpy.stack([prompt, prompt])
    keys = [tdec.request_key(SEED, 4).item(), tdec.request_key(SEED, 9).item()]
    toks, _ = tdec.generate(params, table, batch, HEADS, N_TOKENS,
                            max_len=MAX_LEN, temperature=TEMPERATURE,
                            top_k=TOP_K, key=keys, device="cpu")
    assert toks[0].tolist() == _generate(model, prompt, keys[0])
    assert toks[1].tolist() == _generate(model, prompt, keys[1])
    assert toks[0].tolist() != toks[1].tolist()
    same, _ = tdec.generate(params, table, batch, HEADS, N_TOKENS,
                            max_len=MAX_LEN, temperature=TEMPERATURE,
                            top_k=TOP_K, key=keys[0], device="cpu")
    assert same[0].tolist() == same[1].tolist() == toks[0].tolist()


def _chi_square(tokens, probs):
    counts = numpy.bincount(tokens, minlength=len(probs))
    support = probs > 0
    assert not counts[~support].any()    # never outside the top-k
    expected = probs[support] * len(tokens)
    return float(((counts[support] - expected) ** 2 / expected).sum())


@pytest.mark.parametrize("across", ["requests", "steps"])
def test_draws_follow_the_truncated_softmax(across):
    """20000 draws from one fixed logit row at temperature 0.7 and top-k
    5, one per request key (step 0) or one per step of one key: the
    empirical frequencies are within the chi-square bound of the
    softmax of the five largest logits / 0.7."""
    n, temperature, top_k = 20000, 0.7, 5
    row = torch.from_numpy(numpy.random.RandomState(3).randn(VOCAB).astype(
        numpy.float32))
    logits = row.expand(n, VOCAB)
    if across == "requests":
        keys = tdec.request_key(SEED, torch.arange(n))
        steps = torch.zeros(n, dtype=torch.long)
    else:
        keys = tdec.request_key(SEED, torch.zeros(n, dtype=torch.long))
        steps = torch.arange(n)
    tokens = tdec._pick_token(logits, keys, steps, temperature, True, top_k)
    scaled = row.double().numpy() / temperature
    top = numpy.argsort(-scaled)[:top_k]
    probs = numpy.zeros(VOCAB)
    probs[top] = numpy.exp(scaled[top] - scaled[top].max())
    probs /= probs.sum()
    assert _chi_square(tokens.numpy(), probs) < CHI2_999_DOF4


def test_counter_hash_is_exact_integer_arithmetic():
    """The keys are 32-bit integers in int64 tensors: fold_in is
    MurmurHash3's finalizer mixing, the same on any device, and a
    bijection in the key for a fixed step."""
    assert tdec._mix32(torch.tensor(0)).item() == 0
    # MurmurHash3 fmix32(1), computed with Python's unbounded integers
    x = 1
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    assert tdec._mix32(torch.tensor(1)).item() == x
    big = torch.tensor(0xFFFFFFFF)
    assert 0 <= tdec._mix32(big).item() <= 0xFFFFFFFF
    keys = torch.arange(4096)
    folded = tdec.fold_in(keys, torch.tensor(5))
    assert len(set(folded.tolist())) == 4096
    assert tdec.request_key(SEED, 3).item() \
        == tdec.fold_in(tdec._mix32(torch.tensor(SEED)),
                        torch.tensor(3)).item()
