"""KV-cache autoregressive decoding: the single-request dense reference.

The port of ``veles_tpu/parallel/decode.py`` (``:39-62``, ``:76-148``,
``:151-225``, ``:233-354``): prefill the prompt once, then one token per
step against a static-shape cache. PyTorch runs eagerly, so the JAX
package's scan becomes a Python loop and the cache is updated in place.
The serving engine (``kv_pool.py``) shares ``_prefill_forward`` and the
sublayers; :func:`generate` stays plain PyTorch with no kernel except
the int8 tier's matvec, and is what the paged engine is held against.
"""

import numpy
import torch

from veles_tpu_torch.device import resolve_device, tree_to
from veles_tpu_torch.ops.attention import attention
from veles_tpu_torch.ops.quant import matmul_any, quantize_int8
from veles_tpu_torch.parallel.transformer_step import (_block_qkv, _head,
                                                       _mlp)


def init_kv_cache(n_blocks, batch, max_len, heads, head_dim,
                  dtype=torch.float32, device=None):
    """Static-shape float cache: K/V (L, B, T, H, D) per block, plus the
    filled length (a host integer: the whole batch shares it)."""
    device = resolve_device(device)
    shape = (n_blocks, batch, max_len, heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0}


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
    cache["k"][:, :, :t] = k_all.to(cache["k"].dtype)
    cache["v"][:, :, :t] = v_all.to(cache["v"].dtype)
    cache["length"] = t
    return logits, cache


def _cache_attend(q, k_all, v_all):
    """Attention of query tokens against every position of the given
    cache prefix, f32 softmax: q (B, 1, H, D) against K/V (B, L, H, D).
    As in the JAX package the scores accumulate in f32 from q's type,
    and the probabilities are cast to q's type before the value product
    (which accumulates in f32 again). Returns (B, 1, H, D) float32."""
    d = numpy.float32(q.shape[-1])
    scale = float(numpy.float32(1.0) / numpy.sqrt(d))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k_all.to(q.dtype).float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(),
                        v_all.to(q.dtype).float())


def decode_step(params, x_tok, heads, cache):
    """One token (B, 1, E) through every block against the cache; the
    token's K/V are appended in place at ``cache["length"]``, and the
    attend reads positions [0, length] (the JAX package masks the rest
    of the cache, which contributes exact zeros). Returns ``(logits,
    cache)``."""
    batch, _, embed = x_tok.shape
    length = cache["length"]
    x = x_tok
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _block_qkv(blk, x, heads)
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


def _pick_token(logits, generator, temperature, sample, top_k):
    """Greedy (``sample=False``; the first maximal index, as
    ``jnp.argmax``) or temperature sampling from ``generator``,
    optionally truncated to the top-k logits. JAX's key streams cannot
    be reproduced here: sampled tokens agree with the JAX package in
    distribution only."""
    if not sample:
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / temperature
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, float("-inf")))
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(params, embed_table, prompt_tokens, heads, n_tokens,
             max_len=None, temperature=0.0, top_k=0, generator=None,
             quantize=None, return_logits=False, device=None):
    """Decode ``n_tokens`` after ``prompt_tokens`` (B, T) ints — greedy
    by default; ``temperature > 0`` samples (optionally top-k truncated)
    from ``generator`` (a ``torch.Generator`` on ``device``).
    ``quantize="int8"`` runs the W8A16 tier (weights quantized once up
    front unless already quantized).

    ``embed_table`` (vocab, E) maps tokens to input embeddings; its
    dtype is the cache's. Returns ``(tokens (B, n_tokens), cache)``, and
    with ``return_logits=True`` also the (B, n_tokens, vocab) float32
    logits each emitted token was picked from."""
    if quantize not in (None, "none", "int8"):
        raise ValueError("quantize must be None or 'int8' (the int8-KV "
                         "tier is a later slice), got %r" % (quantize,))
    device = resolve_device(device)
    params = tree_to(params, device)
    embed_table = embed_table.to(device)
    if quantize == "int8" and not isinstance(params["head"], dict):
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
    cache = init_kv_cache(len(params["blocks"]), batch, max_len, heads,
                          embed // heads, dtype=embed_table.dtype,
                          device=device)
    logits, cache = prefill(params, embed_table[prompt], heads, cache)
    toks, seen = [], []
    for _ in range(n_tokens):
        tok = _pick_token(logits, generator, temperature,
                          bool(temperature), top_k)
        toks.append(tok)
        if return_logits:
            seen.append(logits.float())
        logits, cache = decode_step(params, embed_table[tok][:, None, :],
                                    heads, cache)
    tokens = torch.stack(toks, dim=1)
    if return_logits:
        return tokens, cache, torch.stack(seen, dim=1)
    return tokens, cache
