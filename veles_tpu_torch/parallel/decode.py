"""KV-cache autoregressive decoding: the single-request dense reference
and the dense slot slab of continuous batching.

The port of ``veles_tpu/parallel/decode.py`` (``:39-73``, ``:76-148``,
``:151-225``, ``:233-354``, ``:371-664``): prefill the prompt once, then
one token per step against a static-shape cache — float, or in the
int8-KV tier int8 codes with per-(position, head) scales in the
head-major (L, B, H, D, T) layout. PyTorch runs eagerly, so the JAX
package's scans become Python loops and caches are updated in place.

:func:`generate` is the reference the serving engines are held against:
torch ops with the JAX package's numerics, except the int8 weight tiers'
matvec (K2); its int8-KV attend is the JAX package's XLA formulation
(``int8_cache_attend(use_pallas=False)``), never the dense attend
kernel (K4) that the slot engine runs. The slot engine
(:func:`init_slot_state`, :func:`slot_admit_many`, :func:`slot_step`,
:func:`slot_step_many`) is the dense tier of
``serving.ContinuousDecoder``; the paged engine
(``kv_pool.py``) shares ``_prefill_forward``, ``_quantize_kv`` and the
sublayers.
"""

import numpy
import torch

from veles_tpu_torch.device import resolve_device, tree_to
from veles_tpu_torch.ops.attention import attention
from veles_tpu_torch.ops.quant import (int8_cache_attend, matmul_any,
                                       quantize_int8)
from veles_tpu_torch.parallel.transformer_step import (_block_qkv, _head,
                                                       _mlp)

#: the attended-span tile of the slot engine (positions): each dispatch
#: attends ceil((longest live sequence + appends) / tile) * tile
#: positions of the slab instead of max_len. The int8-KV tier also
#: rounds its cache length up to whole tiles, the granule of the dense
#: attend kernel's T gate.
SLOT_SPAN_TILE = 128


def init_kv_cache(n_blocks, batch, max_len, heads, head_dim,
                  dtype=torch.float32, quantized=False, device=None):
    """Static-shape cache plus the filled length (a host integer: the
    whole batch shares it). Float: K/V (L, B, T, H, D). ``quantized``:
    int8 K/V head-major (L, B, H, D, T) with f32 ``k_scale``/``v_scale``
    (L, B, H, T), one absmax scale per (block, row, position, head)."""
    device = resolve_device(device)
    if quantized:
        qshape = (n_blocks, batch, heads, head_dim, max_len)
        sshape = (n_blocks, batch, heads, max_len)
        return {"k": torch.zeros(qshape, dtype=torch.int8, device=device),
                "v": torch.zeros(qshape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, device=device),
                "v_scale": torch.zeros(sshape, device=device),
                "length": 0}
    shape = (n_blocks, batch, max_len, heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0}


def _quantize_kv(x):
    """Per-(row, position, head) symmetric int8 over the last axis:
    (..., D) -> (int8 (..., D), f32 scale (...,)); the absmax over 127,
    rounded half to even and clipped to +-127, scale 1 where the absmax
    is 0. One copy for prefills and decode appends."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0]


def _prefill_forward(params, x, heads, length=None):
    """The prompt forward pass shared by every prefill surface: run
    ``x`` (B, T, E) through all blocks once and return ``(last_logits,
    k_all, v_all, cache_len)`` with ``k_all``/``v_all`` stacked
    (L, B, T, H, D).

    ``length`` may be None (use T) or a (B,) integer tensor of per-row
    true lengths (ragged admission); the logits read from each row's
    position ``length - 1``. Causality keeps pad positions out of every
    real position's activations."""
    batch, t, embed = x.shape
    ks, vs = [], []
    for blk in params["blocks"]:
        q, k, v = _block_qkv(blk, x, heads)
        ks.append(k)
        vs.append(v)
        att = attention(q, k, v, causal=True)
        x = x + matmul_any(att.reshape(batch, t, embed),
                           blk["wout"]) + blk["bout"]
        x = _mlp(blk, x)
    if length is None:
        last = x[:, -1]
        cache_len = t
    else:
        rows = torch.arange(batch, device=x.device)
        last = x[rows, length.long() - 1]
        cache_len = length
    logits = _head(params, last)
    return logits, torch.stack(ks), torch.stack(vs), cache_len


def prefill(params, x, heads, cache):
    """Run the prompt (B, T, E) once, writing ``cache`` positions
    [0, T) in place; returns ``(last_logits, cache)``."""
    logits, k_all, v_all, t = _prefill_forward(params, x, heads)
    if "k_scale" in cache:
        # the prompt attended exact K/V; only the cached copies round
        for name, val in (("k", k_all), ("v", v_all)):
            q8, scale = _quantize_kv(val)     # (L,B,T,H,D), (L,B,T,H)
            cache[name][..., :t] = q8.permute(0, 1, 3, 4, 2)
            cache[name + "_scale"][..., :t] = scale.permute(0, 1, 3, 2)
    else:
        cache["k"][:, :, :t] = k_all.to(cache["k"].dtype)
        cache["v"][:, :, :t] = v_all.to(cache["v"].dtype)
    cache["length"] = t
    return logits, cache


def _cache_attend(q, k_all, v_all, mask=None):
    """Attention of query tokens against the given cache prefix, f32
    softmax: q (B, 1, H, D) against K/V (B, L, H, D); ``mask`` (bool,
    broadcast to (B, H, 1, L)) hides positions with a -1e30 score, None
    shows them all. As in the JAX package the scores accumulate in f32
    from q's type, and the probabilities are cast to q's type before the
    value product (which accumulates in f32 again). Returns (B, 1, H, D)
    float32."""
    d = numpy.float32(q.shape[-1])
    scale = float(numpy.float32(1.0) / numpy.sqrt(d))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k_all.to(q.dtype).float()) * scale
    if mask is not None:
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(),
                        v_all.to(q.dtype).float())


def decode_step(params, x_tok, heads, cache):
    """One token (B, 1, E) through every block against the cache; the
    token's K/V are appended in place at ``cache["length"]``, and the
    attend reads positions [0, length] (the JAX package masks the rest
    of the cache, which contributes exact zeros). The int8-KV cache
    quantizes the append and attends the whole cache under that mask
    through the torch formulation of :func:`ops.quant.int8_cache_attend`
    (``use_pallas=False``: JAX's XLA numerics, no kernel, on any
    device), q pre-scaled by 1/sqrt(D) in q's type. Returns ``(logits,
    cache)``."""
    batch, _, embed = x_tok.shape
    length = cache["length"]
    quantized = "k_scale" in cache
    if quantized:
        max_len = cache["k"].shape[-1]
        mask_addend = torch.where(
            torch.arange(max_len, device=x_tok.device) <= length,
            0.0, -1e30).float()
        inv_sqrt = (embed // heads) ** -0.5
    x = x_tok
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _block_qkv(blk, x, heads)
        if quantized:
            for name, val in (("k", k), ("v", v)):
                q8, scale = _quantize_kv(val[:, 0])   # (B,H,D), (B,H)
                cache[name][i, ..., length] = q8
                cache[name + "_scale"][i, ..., length] = scale
            att = int8_cache_attend(q * inv_sqrt, cache["k"][i],
                                    cache["k_scale"][i], cache["v"][i],
                                    cache["v_scale"][i], mask_addend,
                                    use_pallas=False)
        else:
            cache["k"][i, :, length] = k[:, 0].to(cache["k"].dtype)
            cache["v"][i, :, length] = v[:, 0].to(cache["v"].dtype)
            att = _cache_attend(q, cache["k"][i, :, :length + 1],
                                cache["v"][i, :, :length + 1])
        att = att.to(x.dtype)
        x = x + matmul_any(att.reshape(batch, 1, embed),
                           blk["wout"]) + blk["bout"]
        x = _mlp(blk, x)
    logits = _head(params, x[:, 0])
    cache["length"] = length + 1
    return logits, cache


#: the decode-path weight matrices the int8 tier quantizes (norms and
#: biases stay in the serving float type)
_QUANT_BLOCK_MATS = ("wqkv", "wout", "w1", "w2")


def quantize_params(params):
    """Weight-only int8 quantization of the decode-path matmuls: every
    block projection and the vocab head become ``{"q8": int8, "scale":
    f32}`` leaves that ``matmul_any`` dequantizes inside the product."""
    qblocks = []
    for blk in params["blocks"]:
        qblk = dict(blk)
        for name in _QUANT_BLOCK_MATS:
            q, s = quantize_int8(blk[name])
            qblk[name] = {"q8": q, "scale": s}
        qblocks.append(qblk)
    q, s = quantize_int8(params["head"])
    return dict(params, blocks=qblocks, head={"q8": q, "scale": s})


#: MurmurHash3's 32-bit finalizer constants and the golden-ratio offset
#: of the counter hash below
_MIX1, _MIX2, _GOLDEN = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9
_MASK32 = 0xFFFFFFFF


def _mul32(x, c):
    """``x * c`` mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit
    constant, in halves so no int64 product overflows."""
    return ((x & 0xFFFF) * c + (((x >> 16) * c) & 0xFFFF) * 65536) & _MASK32


def _mix32(x):
    """MurmurHash3's finalizer, a bijection of [0, 2^32), on int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 16)


def fold_in(key, data):
    """A new 32-bit key from ``key`` and the integer ``data`` (int64
    tensors, broadcast; values in [0, 2^32)): the port's counterpart of
    ``jax.random.fold_in``, an integer hash that gives the same bits on
    the CPU and the card."""
    return _mix32(key ^ _mix32((data + _GOLDEN) & _MASK32))


def request_key(seed, request_id):
    """The sampling key (an int64 tensor) of request ``request_id`` of a
    decoder seeded ``seed`` (ints or int64 tensors), as the JAX decoder
    folds the request id into its base key (``serving.py:912-918``,
    ``:1345``). A request's stream equals :func:`generate`
    ``(batch=1, key=...)``'s with this key, whichever slot it lands in
    and whoever shares it."""
    seed = torch.as_tensor(seed, dtype=torch.long) & _MASK32
    return fold_in(_mix32(seed), torch.as_tensor(request_id,
                                                 dtype=torch.long))


def gumbel_noise(keys, steps, vocab):
    """(B, vocab) float64 standard Gumbel noise for the rows' (key,
    step) pairs: a uniform from the counter hash of (key, step, vocab
    index) for each entry, ``-log(-log(u))``. Row b's noise depends on
    ``keys[b]`` and ``steps[b]`` alone."""
    step_keys = fold_in(keys.long(), steps.long())
    index = torch.arange(vocab, dtype=torch.long, device=step_keys.device)
    bits = fold_in(step_keys[:, None], index[None, :])
    u = (bits.double() + 0.5) * 2.0 ** -32
    return -torch.log(-torch.log(u))


def _pick_token(logits, keys, steps, temperature, sample, top_k):
    """Greedy (``sample=False``; the first maximal index, as
    ``jnp.argmax``) or temperature sampling, optionally truncated to the
    top-k logits. Row b samples from its own stream: the Gumbel-max
    ``argmax(logits / T + g)`` with ``g`` from (``keys[b]``,
    ``steps[b]``) (:func:`gumbel_noise`), exact in distribution. The JAX
    package draws from threefry keys of the same (key, step) structure;
    its bits cannot be reproduced, so sampled tokens agree with it in
    distribution only."""
    if not sample:
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / temperature
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, float("-inf")))
    noise = gumbel_noise(keys, steps, scaled.shape[-1])
    return torch.argmax(scaled.double() + noise, dim=-1)


def generate(params, embed_table, prompt_tokens, heads, n_tokens,
             max_len=None, temperature=0.0, top_k=0, key=None,
             quantize=None, return_logits=False, device=None):
    """Decode ``n_tokens`` after ``prompt_tokens`` (B, T) ints — greedy
    by default; ``temperature > 0`` samples (optionally top-k truncated)
    the token of step i from (``key``, i), as the JAX package's
    ``generate(key=)`` folds the step into its key. ``key`` is an int
    (every row draws from it) or one per row; None is
    ``request_key(0, 0)``, the first request of a decoder seeded 0.
    ``quantize="int8"`` runs the W8A16 tier (weights quantized once up
    front unless already quantized); ``"int8-kv"`` also stores the cache
    as int8, its length rounded up to whole 128-position tiles as in the
    JAX package (masking keeps the extra positions inert).

    ``embed_table`` (vocab, E) maps tokens to input embeddings; its
    dtype is the cache's. Returns ``(tokens (B, n_tokens), cache)``, and
    with ``return_logits=True`` also the (B, n_tokens, vocab) float32
    logits each emitted token was picked from."""
    if quantize not in (None, "none", "int8", "int8-kv"):
        raise ValueError("quantize must be None, 'int8' or 'int8-kv', "
                         "got %r" % (quantize,))
    device = resolve_device(device)
    params = tree_to(params, device)
    embed_table = embed_table.to(device)
    if quantize in ("int8", "int8-kv") \
            and not isinstance(params["head"], dict):
        params = quantize_params(params)
    prompt = torch.as_tensor(prompt_tokens, dtype=torch.long).to(device)
    batch, t = prompt.shape
    embed = embed_table.shape[1]
    if max_len is None:
        max_len = t + n_tokens
    if max_len < t + n_tokens:
        raise ValueError("max_len %d < prompt %d + n_tokens %d"
                         % (max_len, t, n_tokens))
    if top_k < 0:
        raise ValueError("top_k must be >= 0, got %d" % top_k)
    top_k = min(int(top_k), embed_table.shape[0])
    if quantize == "int8-kv":
        max_len = -(-max_len // SLOT_SPAN_TILE) * SLOT_SPAN_TILE
    cache = init_kv_cache(len(params["blocks"]), batch, max_len, heads,
                          embed // heads, dtype=embed_table.dtype,
                          quantized=quantize == "int8-kv", device=device)
    logits, cache = prefill(params, embed_table[prompt], heads, cache)
    keys = torch.as_tensor(request_key(0, 0) if key is None else key,
                           dtype=torch.long).to(device).expand(batch)
    toks, seen = [], []
    for i in range(n_tokens):
        tok = _pick_token(logits, keys, torch.full_like(keys, i),
                          temperature, bool(temperature), top_k)
        toks.append(tok)
        if return_logits:
            seen.append(logits.float())
        logits, cache = decode_step(params, embed_table[tok][:, None, :],
                                    heads, cache)
    tokens = torch.stack(toks, dim=1)
    if return_logits:
        return tokens, cache, torch.stack(seen, dim=1)
    return tokens, cache


# -- continuous batching: the dense slot slab ---------------------------------
#
# The port of decode.py:371-664: a fixed pool of cache SLOTS, each lane
# holding one in-flight sequence at its own length, decode_step's math with
# the scalar length generalized to a per-slot vector. PyTorch runs eagerly,
# so the slab is updated in place (no donated copy) and the chunk scan is
# a Python loop. Each slot carries its request's sampling key and the
# step it has reached, so its sampled tokens are generate(batch=1,
# key=...)'s.


def init_slot_state(n_blocks, slots, max_len, heads, head_dim, vocab,
                    dtype=torch.float32, quantized=False, device=None):
    """Cache + control state for ``slots`` concurrent sequences
    (``decode.py:380-441``). Float: the slab K/V (L, S, T, H, D) in
    ``dtype``. ``quantized``: int8 K/V head-major (L, S, H, D, T) with
    f32 ``k_scale``/``v_scale`` (L, S, H, T). Control: per-slot
    ``lengths`` and ``step`` (int32), ``req_key`` (int64, the sampling
    key of the slot's request) and ``logits`` (float32, the next
    token's). The page pool's state is ``kv_pool.init_paged_state``."""
    device = resolve_device(device)
    state = control_state(slots, vocab, device)
    if quantized:
        qshape = (n_blocks, slots, heads, head_dim, max_len)
        sshape = (n_blocks, slots, heads, max_len)
        for name in ("k", "v"):
            state[name] = torch.zeros(qshape, dtype=torch.int8,
                                      device=device)
            state[name + "_scale"] = torch.zeros(sshape, device=device)
    else:
        shape = (n_blocks, slots, max_len, heads, head_dim)
        for name in ("k", "v"):
            state[name] = torch.zeros(shape, dtype=dtype, device=device)
    return state


def control_state(slots, vocab, device):
    """The per-slot control rows of a slot or paged state: ``lengths``
    and ``step`` (int32), ``req_key`` (int64) and ``logits`` (float32)."""
    return {
        "lengths": torch.zeros((slots,), dtype=torch.int32, device=device),
        "logits": torch.zeros((slots, vocab), dtype=torch.float32,
                              device=device),
        "step": torch.zeros((slots,), dtype=torch.int32, device=device),
        "req_key": torch.zeros((slots,), dtype=torch.long, device=device),
    }


def write_control(state, slots, lengths, logits, req_keys=None):
    """Seat admitted rows: the control rows of ``slots`` (B,) get their
    lengths, next-token logits and request keys (``req_keys`` (B,), 0
    when None), and their step restarts at 0."""
    idx = slots.long()
    state["lengths"][idx] = lengths.to(torch.int32)
    state["logits"][idx] = logits.float()
    state["step"][idx] = 0
    state["req_key"][idx] = (0 if req_keys is None
                             else req_keys.to(torch.long))


def advance_control(state, active, logits):
    """After a step: the active rows' lengths and steps move on by one
    and take the new logits."""
    state["lengths"] = torch.where(active, state["lengths"] + 1,
                                   state["lengths"])
    state["logits"] = torch.where(active[:, None], logits, state["logits"])
    state["step"] = torch.where(active, state["step"] + 1, state["step"])


def slot_state_bytes(state):
    """Device bytes of a slot (or paged) decode state: the sum of its
    tensors' bytes."""
    return sum(t.numel() * t.element_size() for t in state.values())


def slot_admit_many(params, heads, state, slots, prompt_x, lengths,
                    req_keys=None):
    """Admit one group in one prefill (``decode.py:461-507``): run
    ``prompt_x`` (B, T, E) — rows right-padded to the group's bucket T —
    and write positions [0, T) of the lanes ``slots`` (B,), quantized
    into the head-major layout in the int8-KV tier, plus their control
    rows; ``lengths`` (B,) are the true prompt lengths, ``req_keys``
    (B,) the rows' sampling keys (:func:`request_key`). Positions past T
    keep a retired occupant's values, which this sequence's own appends
    rewrite before its mask shows them. Updates ``state`` in place and
    returns it."""
    t = prompt_x.shape[1]
    logits, k_all, v_all, lengths = _prefill_forward(params, prompt_x,
                                                     heads, lengths)
    write_control(state, slots, lengths, logits, req_keys)
    idx = slots.long()
    for name, val in (("k", k_all), ("v", v_all)):
        if "k_scale" in state:
            q8, scale = _quantize_kv(val)      # (L,B,T,H,D), (L,B,T,H)
            state[name][:, idx, :, :, :t] = q8.permute(0, 1, 3, 4, 2)
            state[name + "_scale"][:, idx, :, :t] = scale.permute(0, 1, 3, 2)
        else:
            state[name][:, idx, :t] = val.to(state[name].dtype)
    return state


def slot_step(params, embed_table, heads, state, active, temperature=1.0,
              sample=False, top_k=0, span=None):
    """One decode step across all slots (``decode.py:529-642``);
    ``active`` (S,) bool gates which lanes advance (inactive lanes are
    computed, their lengths, logits and step stay, and the host discards
    their tokens). The token emitted at this step is picked from the
    PRE-step logits, as ``generate`` emits; a sampled one from the
    slot's (``req_key``, ``step``), so a slot's stream is
    ``generate(batch=1, key=req_key)``'s.

    Each lane's K/V append lands at its own length, clamped to the last
    position as the JAX package's ``dynamic_update_slice`` clamps it (an
    inactive lane that reached ``max_len`` rewrites that position
    harmlessly). The attend reads positions [0, span) only (``span``
    defaults to ``max_len``; the host passes one past every live length),
    position p of slot s visible iff p <= lengths[s]: the float tier
    through :func:`_cache_attend`, the int8-KV tier through
    :func:`ops.quant.int8_cache_attend` on the slab view (K4 on the
    card) with q pre-scaled by 1/sqrt(D) in q's type. Updates ``state``
    in place; returns ``(state, emitted (S,))`` without a host sync."""
    slots = state["lengths"].shape[0]
    quantized = "k_scale" in state
    max_len = state["k"].shape[-1] if quantized else state["k"].shape[2]
    if span is None or span > max_len:
        span = max_len
    lengths = state["lengths"]
    # a greedy step reads no key
    keys, steps = ((state["req_key"], state["step"]) if sample
                   else (None, None))
    tok_in = _pick_token(state["logits"], keys, steps, temperature, sample,
                         top_k)
    x = embed_table[tok_in][:, None, :]
    embed = x.shape[-1]
    visible = (torch.arange(span, device=x.device)[None, :]
               <= lengths[:, None])
    if quantized:
        mask_addend = torch.where(visible, 0.0, -1e30).float()
        inv_sqrt = (embed // heads) ** -0.5
    rows = torch.arange(slots, device=x.device)
    pos = torch.clamp(lengths, max=max_len - 1).long()
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _block_qkv(blk, x, heads)
        if quantized:
            # the int, the two index tensors and the slices between them
            # put the slot axis first: the target is (S, H, D)
            for name, val in (("k", k), ("v", v)):
                q8, scale = _quantize_kv(val[:, 0])     # (S,H,D), (S,H)
                state[name][i, rows, :, :, pos] = q8
                state[name + "_scale"][i, rows, :, pos] = scale
            att = int8_cache_attend(
                q * inv_sqrt, state["k"][i, ..., :span],
                state["k_scale"][i, ..., :span], state["v"][i, ..., :span],
                state["v_scale"][i, ..., :span], mask_addend)
        else:
            state["k"][i, rows, pos] = k[:, 0].to(state["k"].dtype)
            state["v"][i, rows, pos] = v[:, 0].to(state["v"].dtype)
            att = _cache_attend(q, state["k"][i, :, :span],
                                state["v"][i, :, :span],
                                visible[:, None, None, :])
        att = att.to(x.dtype)
        x = x + matmul_any(att.reshape(slots, 1, embed),
                           blk["wout"]) + blk["bout"]
        x = _mlp(blk, x)
    advance_control(state, active, _head(params, x[:, 0]).float())
    return state, tok_in


def slot_step_many(params, embed_table, heads, state, active, n,
                   temperature=1.0, sample=False, top_k=0, span=None):
    """``n`` lockstep :func:`slot_step`s (``decode.py:645-664``); ``span``
    must cover the longest live sequence plus the whole chunk. Returns
    ``(state, emitted (n, S))``, still on the device."""
    emitted = []
    for _ in range(n):
        state, tok = slot_step(params, embed_table, heads, state, active,
                               temperature, sample, top_k, span=span)
        emitted.append(tok)
    return state, torch.stack(emitted)
