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

The programs carry the JAX package's names (``observe/xla_stats.
instrument``: ``decode.generate``, ``decode.admit``, ``decode.step``,
``decode.dispatch``), and :func:`dispatch_flops` / :func:`prefill_flops`
count their FLOPs from shapes for the online MFU gauge (torch has no
``cost_analysis``).
"""

import numpy
import torch

from veles_tpu_torch.device import (resolve_device, tree_leaves_with_path,
                                    tree_rebuild, tree_to)
from veles_tpu_torch.observe.xla_stats import instrument
from veles_tpu_torch.ops.attention import attention
from veles_tpu_torch.ops.quant import int8_cache_attend, quantize_int8
from veles_tpu_torch.parallel.mesh import PartitionSpec
from veles_tpu_torch.parallel.transformer_step import (_attn_out,
                                                       _block_qkv, _head,
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


def _reduce_of(tp):
    """The all-reduce that completes a head-sharded product on a rank of
    the tensor-parallel engine (``tp``: ``parallel/tp_engine.
    TensorParallel``), or None on one rank."""
    return None if tp is None else tp.reduce


def _logits(params, x, tp=None):
    """The vocabulary head: ``_head``'s logits, all-gathered to the whole
    vocabulary on a rank of the tensor-parallel engine (each rank holds a
    vocab slice of ``head``), so every rank picks from the same logits."""
    logits = _head(params, x)
    return logits if tp is None else tp.gather(logits)


def _prefill_forward(params, x, heads, length=None, tp=None):
    """The prompt forward pass shared by every prefill surface: run
    ``x`` (B, T, E) through all blocks once and return ``(last_logits,
    k_all, v_all, cache_len)`` with ``k_all``/``v_all`` stacked
    (L, B, T, H, D).

    ``length`` may be None (use T) or a (B,) integer tensor of per-row
    true lengths (ragged admission); the logits read from each row's
    position ``length - 1``. Causality keeps pad positions out of every
    real position's activations. ``tp`` runs the pass on one rank's
    shard of the tensor-parallel engine: ``heads`` are the rank's own,
    K/V hold those heads, and the logits are the whole vocabulary's."""
    batch, t, _ = x.shape
    reduce = _reduce_of(tp)
    ks, vs = [], []
    for blk in params["blocks"]:
        q, k, v = _block_qkv(blk, x, heads)
        ks.append(k)
        vs.append(v)
        att = attention(q, k, v, causal=True)
        x = _attn_out(blk, x, att, reduce)
        x = _mlp(blk, x, reduce)
    if length is None:
        last = x[:, -1]
        cache_len = t
    else:
        rows = torch.arange(batch, device=x.device)
        last = x[rows, length.long() - 1]
        cache_len = length
    logits = _logits(params, last, tp)
    return logits, torch.stack(ks), torch.stack(vs), cache_len


def prefill(params, x, heads, cache, tp=None):
    """Run the prompt (B, T, E) once, writing ``cache`` positions
    [0, T) in place; returns ``(last_logits, cache)``."""
    logits, k_all, v_all, t = _prefill_forward(params, x, heads, tp=tp)
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


def decode_step(params, x_tok, heads, cache, tp=None):
    """One token (B, 1, E) through every block against the cache; the
    token's K/V are appended in place at ``cache["length"]``, and the
    attend reads positions [0, length] (the JAX package masks the rest
    of the cache, which contributes exact zeros). The int8-KV cache
    quantizes the append and attends the whole cache under that mask
    through the torch formulation of :func:`ops.quant.int8_cache_attend`
    (``use_pallas=False``: JAX's XLA numerics, no kernel, on any
    device), q pre-scaled by 1/sqrt(D) in q's type. ``tp``: one rank's
    shard of the tensor-parallel engine (:func:`make_tp_generate`).
    Returns ``(logits, cache)``."""
    length = cache["length"]
    quantized = "k_scale" in cache
    reduce = _reduce_of(tp)
    if quantized:
        max_len = cache["k"].shape[-1]
        mask_addend = torch.where(
            torch.arange(max_len, device=x_tok.device) <= length,
            0.0, -1e30).float()
    x = x_tok
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _block_qkv(blk, x, heads)
        inv_sqrt = q.shape[-1] ** -0.5
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
        x = _attn_out(blk, x, att.to(x.dtype), reduce)
        x = _mlp(blk, x, reduce)
    logits = _logits(params, x[:, 0], tp)
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
                    req_keys=None, tp=None):
    """Admit one group in one prefill (``decode.py:461-507``): run
    ``prompt_x`` (B, T, E) — rows right-padded to the group's bucket T —
    and write positions [0, T) of the lanes ``slots`` (B,), quantized
    into the head-major layout in the int8-KV tier, plus their control
    rows; ``lengths`` (B,) are the true prompt lengths, ``req_keys``
    (B,) the rows' sampling keys (:func:`request_key`). Positions past T
    keep a retired occupant's values, which this sequence's own appends
    rewrite before its mask shows them. ``tp``: one rank's shard of the
    tensor-parallel engine (``parallel/tp_engine.py``). Updates ``state``
    in place and returns it."""
    t = prompt_x.shape[1]
    logits, k_all, v_all, lengths = _prefill_forward(params, prompt_x,
                                                     heads, lengths, tp)
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


def slot_admit(params, heads, state, slot, prompt_x, req_key=None,
               length=None):
    """Prefill ``prompt_x`` (1, T, E) into lane ``slot``: the B = 1 case
    of :func:`slot_admit_many` (``decode.py:510-527``), with the port's
    argument order (no embedding table). ``req_key`` is the lane's
    sampling key (:func:`request_key`; 0 when None), ``length`` the true
    prompt length of a right-padded ``prompt_x`` (T when None). Updates
    ``state`` in place and returns it."""
    device = state["lengths"].device
    if length is None:
        length = prompt_x.shape[1]
    keys = None if req_key is None else torch.as_tensor(
        req_key, dtype=torch.long, device=device).reshape(1)
    return slot_admit_many(
        params, heads, state,
        torch.tensor([int(slot)], dtype=torch.int32, device=device),
        prompt_x, torch.tensor([int(length)], dtype=torch.int32,
                               device=device), keys)


def slot_step(params, embed_table, heads, state, active, temperature=1.0,
              sample=False, top_k=0, span=None, tp=None):
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
    card) with q pre-scaled by 1/sqrt(D) in q's type. ``tp``: one rank's
    shard of the tensor-parallel engine; every rank picks from the same
    all-gathered logits. Updates ``state`` in place; returns ``(state,
    emitted (S,))`` without a host sync."""
    slots = state["lengths"].shape[0]
    quantized = "k_scale" in state
    reduce = _reduce_of(tp)
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
    visible = (torch.arange(span, device=x.device)[None, :]
               <= lengths[:, None])
    if quantized:
        mask_addend = torch.where(visible, 0.0, -1e30).float()
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
                q * q.shape[-1] ** -0.5, state["k"][i, ..., :span],
                state["k_scale"][i, ..., :span], state["v"][i, ..., :span],
                state["v_scale"][i, ..., :span], mask_addend)
        else:
            state["k"][i, rows, pos] = k[:, 0].to(state["k"].dtype)
            state["v"][i, rows, pos] = v[:, 0].to(state["v"].dtype)
            att = _cache_attend(q, state["k"][i, :, :span],
                                state["v"][i, :, :span],
                                visible[:, None, None, :])
        x = _attn_out(blk, x, att.to(x.dtype), reduce)
        x = _mlp(blk, x, reduce)
    advance_control(state, active, _logits(params, x[:, 0], tp).float())
    return state, tok_in


def slot_step_many(params, embed_table, heads, state, active, n,
                   temperature=1.0, sample=False, top_k=0, span=None,
                   tp=None):
    """``n`` lockstep :func:`slot_step`s (``decode.py:645-664``); ``span``
    must cover the longest live sequence plus the whole chunk. Returns
    ``(state, emitted (n, S))``, still on the device."""
    emitted = []
    for _ in range(n):
        state, tok = slot_step(params, embed_table, heads, state, active,
                               temperature, sample, top_k, span=span,
                               tp=tp)
        emitted.append(tok)
    return state, torch.stack(emitted)


# -- tensor-parallel decode and the sharded slot layout ---------------------
#
# The port of decode.py:766-1161. The JAX package goes multi-chip by
# layout: one SPMD program, the params tensor-parallel over the mesh's
# ``model`` axis, the slot slab sharded over its heads, and XLA's
# partitioner inserting the collectives. The port's mesh is a
# torch.distributed world, one process per device, so the partition is
# written out: every rank holds whole heads of every attention block, a
# column/row slice of every FFN and a vocab slice of the head, and runs the
# same slot math on them (``tp=`` of the functions above), two all-reduces
# a block (after ``wout`` and after ``w2``) and one all-gather of the logits
# completing the products (``parallel/tp_engine.TensorParallel``). The
# JAX slab shards the fused qkv by flat columns and lets the partitioner
# reshard around the per-head split (decode.py:970-982); the port repacks
# head-major first (:func:`_repack_block`), as JAX's own
# ``make_tp_generate`` does, so each rank's columns are [q | k | v] of its
# heads. The math of a head is the same either way.


def _repack_block(blk, heads):
    """Host-side repack of one block into head-major layouts a head shard
    can slice: qkv (E, 3E) to (E, 3, H, D), its bias (3E,) to (3, H, D),
    out-proj (E, E) to (H, D, E) (``decode.py:768-781``). The int8 tier's
    ``{"q8", "scale"}`` leaves repack the codes like the float matrix, and
    the qkv's per-column scales like its bias; the out-proj's scales (per
    output column) stay whole."""
    def mat(leaf, shape, scale_shape=None):
        if isinstance(leaf, dict):
            scale = leaf["scale"]
            return {"q8": leaf["q8"].reshape(shape),
                    "scale": (scale.reshape(scale_shape)
                              if scale_shape is not None else scale)}
        return leaf.reshape(shape)

    wqkv = blk["wqkv"]["q8"] if isinstance(blk["wqkv"], dict) \
        else blk["wqkv"]
    embed = wqkv.shape[0]
    head_dim = embed // heads
    return dict(
        blk,
        wqkv=mat(blk["wqkv"], (embed, 3, heads, head_dim),
                 (3, heads, head_dim)),
        bqkv=blk["bqkv"].reshape(3, heads, head_dim),
        wout=mat(blk["wout"], (heads, head_dim, embed)),
    )


def repack_slot_params(params, heads):
    """The serving parameters with every block repacked head-major
    (:func:`_repack_block`): the tree :func:`slot_param_specs`
    describes."""
    return dict(params, blocks=[_repack_block(blk, heads)
                                for blk in params["blocks"]])


def _flatten_block(blk):
    """A rank's slice of a repacked block back in the engine's layout:
    qkv (E, 3, h, D) to (E, 3 h D), its bias to (3 h D,), out-proj
    (h, D, E) to (h D, E), every leaf contiguous (K2 reads whole
    rows)."""
    def flat(leaf, cols):
        if isinstance(leaf, dict):
            return {"q8": flat(leaf["q8"], cols),
                    "scale": leaf["scale"].reshape(-1).contiguous()}
        if cols:
            return leaf.reshape(leaf.shape[0], -1).contiguous()
        return leaf.reshape(-1, leaf.shape[-1]).contiguous()

    return dict(blk, wqkv=flat(blk["wqkv"], True),
                bqkv=blk["bqkv"].reshape(-1).contiguous(),
                wout=flat(blk["wout"], False))


def local_from_packed(local):
    """A rank's slice of the repacked tree (:func:`repack_slot_params`
    under :func:`slot_param_specs`) in the engine's layout."""
    return dict(local, blocks=[_flatten_block(blk)
                               for blk in local["blocks"]])


def validate_slot_mesh(mesh, heads, params, embed_table, axis="model"):
    """Fail a bad serving mesh at build time with an error naming the
    offending dimension (``decode.py:985-1003``); returns the axis
    size."""
    n = dict(mesh.shape).get(axis, 1)
    if n <= 1:
        return n
    blk = params["blocks"][0]
    w1 = blk["w1"]["q8"] if isinstance(blk["w1"], dict) else blk["w1"]
    ffn_hidden = w1.shape[1]
    vocab = embed_table.shape[0]
    if heads % n or ffn_hidden % n or vocab % n:
        raise ValueError(
            "sharded slot serving needs heads (%d), ffn hidden (%d) "
            "and vocab (%d) divisible by the %r axis size %d"
            % (heads, ffn_hidden, vocab, axis, n))
    return n


def slot_param_specs(params, axis="model"):
    """The :class:`~veles_tpu_torch.parallel.mesh.PartitionSpec` tree of
    the tensor-parallel serving layout, for the HEAD-MAJOR tree
    :func:`repack_slot_params` gives (``decode.py:1006-1043``, whose flat
    qkv columns the port replaces by whole heads): qkv (E, 3, H, D), its
    bias and out-proj (H, D, E) shard over heads, FFN-up columns and the
    vocab head over ``axis``, FFN-down rows over ``axis``; norms and the
    biases added after a reduce stay whole. int8 leaves (``{"q8",
    "scale"}``) shard the codes like the float matrix; per-output-column
    scales follow their columns and stay whole under a row shard, which
    is exact: a column's scale commutes with the sum over rows."""
    P = PartitionSpec

    def mat(leaf, spec, scale_spec):
        if isinstance(leaf, dict):
            return {"q8": spec, "scale": scale_spec}
        return spec

    blocks = []
    for blk in params["blocks"]:
        blocks.append({
            "ln1_w": P(), "ln1_b": P(),
            "wqkv": mat(blk["wqkv"], P(None, None, axis, None),
                        P(None, axis, None)),
            "bqkv": P(None, axis, None),
            "wout": mat(blk["wout"], P(axis, None, None), P()),
            "bout": P(),
            "ln2_w": P(), "ln2_b": P(),
            "w1": mat(blk["w1"], P(None, axis), P(axis)),
            "b1": P(axis),
            "w2": mat(blk["w2"], P(axis, None), P()),
            "b2": P(),
        })
    return {"blocks": blocks, "lnf_w": P(), "lnf_b": P(),
            "head": mat(params["head"], P(None, axis), P(axis))}


def slot_state_specs(quantized=False, axis="model"):
    """The slot state's layout (``decode.py:1046-1061``): the KV slab
    (and the int8 tier's scales) shard over their HEADS dim, the control
    rows (lengths, logits, req_key, step) are whole on every rank."""
    P = PartitionSpec
    if quantized:
        kv = P(None, None, axis, None, None)   # (L, S, H, D, T)
        scale = P(None, None, axis, None)      # (L, S, H, T)
        extra = {"k_scale": scale, "v_scale": scale}
    else:
        kv = P(None, None, None, axis, None)   # (L, S, T, H, D)
        extra = {}
    return dict({"k": kv, "v": kv, "lengths": P(), "logits": P(),
                 "req_key": P(), "step": P()}, **extra)


def shard_slot_params(params, embed_table, heads, mesh, axis="model"):
    """This rank's shard of the serving parameters and the (whole)
    embedding table: ``(params, embed_table)`` (``decode.py:1078-1087``).
    Validates divisibility first, repacks head-major, slices this rank's
    part by :func:`slot_param_specs` (a whole tree to the serving layout
    is slice-only: nothing crosses the wire) and flattens it back to the
    engine's layout, every leaf contiguous: the qkv columns [q | k | v] of
    this rank's heads, the ``wout`` rows of those heads, its ``w1``
    columns with ``b1``, its ``w2`` rows and its vocab columns of
    ``head``. Quantize first (:func:`quantize_params`): a shard's codes
    are then the single device's."""
    from veles_tpu_torch.parallel.reshard import apply_plan, plan_reshard

    validate_slot_mesh(mesh, heads, params, embed_table, axis=axis)
    packed = repack_slot_params(params, heads)
    plan = plan_reshard(packed, mesh, slot_param_specs(packed, axis),
                        PartitionSpec())
    leaves = iter([apply_plan(leaf, leaf_plan, mesh)
                   for (_, leaf), leaf_plan in zip(
                       tree_leaves_with_path(packed), plan.leaves)])
    return local_from_packed(tree_rebuild(packed, leaves)), embed_table


def make_tp_generate(mesh, heads, n_tokens, axis="model", device=None):
    """Tensor-parallel greedy decoding over ``mesh``'s ``axis``
    (``decode.py:784-982``): every rank holds a head slice of each
    attention block, a column/row slice of each FFN and a vocab slice of
    the head; activations are whole on every rank, and the two per-block
    products complete by an all-reduce over the axis's group (the
    Megatron inference recipe). The KV cache holds the rank's heads, so a
    rank's cache is 1/n of the whole.

    Returns ``run(params, embed_table, prompt_tokens) -> tokens (B,
    n_tokens)``, which EVERY rank of the world calls with the same
    inputs; ``params`` is the standard ``init_transformer_params`` tree
    (repacked and sliced inside). Requires ``heads``, the FFN hidden
    width and the vocabulary divisible by the axis size, and unquantized
    params, with the JAX package's errors. Every rank picks from the
    all-gathered logits, so every rank returns the same tokens."""
    from veles_tpu_torch.parallel.tp_engine import TensorParallel

    n = mesh.shape[axis]
    held = {}

    def run(params, embed_table, prompt_tokens):
        if isinstance(params["head"], dict):
            raise ValueError(
                "tensor-parallel decode takes unquantized params (the "
                "int8 tier is single-device serving; TP shards bf16)")
        embed = embed_table.shape[1]
        ffn = params["blocks"][0]["w1"].shape[1]
        if heads % n or ffn % n or embed_table.shape[0] % n:
            raise ValueError(
                "tensor-parallel decode needs heads (%d), ffn hidden "
                "(%d) and vocab (%d) divisible by the %r axis size %d"
                % (heads, ffn, embed_table.shape[0], axis, n))
        dev = resolve_device(device)
        if "tp" not in held:
            held["tp"] = TensorParallel(mesh, axis)
        tp = held["tp"]
        local, table = shard_slot_params(tree_to(params, dev),
                                         embed_table.to(dev), heads, mesh,
                                         axis=axis)
        prompt = torch.as_tensor(prompt_tokens, dtype=torch.long).to(dev)
        batch, t = prompt.shape
        cache = init_kv_cache(len(local["blocks"]), batch, t + n_tokens,
                              heads // n, embed // heads,
                              dtype=table.dtype, device=dev)
        logits, cache = prefill(local, table[prompt], heads // n, cache,
                                tp=tp)
        toks = []
        for _ in range(n_tokens):
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            logits, cache = decode_step(local, table[tok][:, None, :],
                                        heads // n, cache, tp=tp)
        return torch.stack(toks, dim=1)

    return run


# -- program names and FLOPs (observe/xla_stats.py) ---------------------------

def _product_elements(params):
    """``(blocks, head)``: K * N summed over the weight products one token
    passes through, each block's qkv, output and two MLP products, and
    the vocabulary head."""
    def kn(w):
        w = w["q8"] if isinstance(w, dict) else w
        return int(w.shape[0]) * int(w.shape[1])

    blocks = sum(kn(blk[name]) for blk in params["blocks"]
                 for name in _QUANT_BLOCK_MATS)
    return blocks, kn(params["head"])


def dispatch_flops(params, slots, lengths, n):
    """Analytic FLOPs of one dispatch of ``n`` lockstep steps over
    ``slots`` lanes: every lane runs each weight product every step (2 K
    N; the lanes of free slots are computed too), and each live lane
    attends its visible positions in every block (q.k and p.v, 4 E a
    position). ``lengths`` are the live lanes' lengths before the
    dispatch; step j appends and then attends ``length + j + 1``
    positions."""
    blocks, head = _product_elements(params)
    embed = params["blocks"][0]["ln1_w"].shape[0]
    positions = sum(n * (int(length) + 1) + n * (n - 1) // 2
                    for length in lengths)
    return (2.0 * slots * n * (blocks + head)
            + 4.0 * embed * len(params["blocks"]) * positions)


def param_tree_bytes(params, embed_table=None):
    """Bytes of a parameter tree (plus the embedding table when it is a
    separate leaf): the ``params`` and ``param_stash`` memscope owners'
    sizing primitive (``decode.py:453``)."""
    from veles_tpu_torch.observe.memscope import pytree_nbytes
    return pytree_nbytes(params) + pytree_nbytes(embed_table)


# -- dispatched-work accounting (observe/servescope.py, decode.py:705-763) ----

def admit_waste(bucket, lens, rows):
    """Token decomposition of ONE admission dispatch: ``lens`` live
    prompt/tail lengths prefilled into ``bucket``-position rows, the
    group padded to ``rows`` rows with duplicates. Returns ``(live,
    bucket_pad, group_dup)`` token counts. The port's admissions add no
    duplicate rows (``rows == len(lens)``), so its ``group_dup`` is 0."""
    lens = [int(n) for n in lens]
    live = sum(lens)
    pad = sum(int(bucket) - n for n in lens)
    dup = (int(rows) - len(lens)) * int(bucket)
    return live, pad, dup


def span_overshoot_tokens(lens, span, chunk):
    """Masked attended positions PAST each live slot's sequence across
    one chunked slab dispatch: every lane-step attends ``span``
    positions, a slot at length ``n`` is live to ``n + i`` at step ``i``.
    The sum of ``max(0, span - (n + i))`` over ``i in 1..chunk`` per
    slot, in closed form."""
    span = int(span)
    chunk = int(chunk)
    total = 0
    for n in lens:
        d = span - int(n)
        k = min(chunk, max(0, d - 1))
        total += k * d - k * (k + 1) // 2
    return total


def page_overshoot_tokens(lens, pages, page_size, chunk):
    """The gathered-page twin of :func:`span_overshoot_tokens`: each live
    slot gathers ``pages`` pages a step. The port's pool attends through
    K1 or K3 and never books it; kept for the JAX package's accounting."""
    return span_overshoot_tokens(lens, int(pages) * int(page_size),
                                 chunk)


def tile_pad_tokens(lens, page_size, chunk):
    """The paged kernels' residual: K1 and K3 walk only each slot's live
    pages, so what remains is the dead tail of the last partial page,
    ``ceil((n + 1) / page_size) * page_size - (n + 1)`` lanes a
    slot-step for a slot live to ``n``, summed over ``i in 1..chunk``
    with the slot live to ``n + i - 1`` at step ``i``."""
    ps = int(page_size)
    chunk = int(chunk)
    total = 0
    for n in lens:
        for i in range(1, chunk + 1):
            live = int(n) + i
            total += -(-live // ps) * ps - live
    return total


def prefill_flops(params, rows, width):
    """Analytic FLOPs of an admission's prefill products: ``rows``
    prompts padded to ``width`` positions through every block's
    products, the head once a row (attention not counted)."""
    blocks, head = _product_elements(params)
    return 2.0 * rows * (width * blocks + head)


# the serving programs' names, the JAX package's (decode.py:687-690): each
# matches its host span, so the call counters, the profile and the trace
# share one vocabulary; a disabled tracker's wrapper delegates after one
# attribute check
generate = instrument("decode.generate", generate)
slot_admit_many = instrument("decode.admit", slot_admit_many)
slot_step = instrument("decode.step", slot_step)
slot_step_many = instrument("decode.dispatch", slot_step_many)
