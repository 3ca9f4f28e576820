"""Is a serving replica's greedy stream for a prompt the same alone and
inside a burst of concurrent clients?

Bit-equal failover behind the elastic router (``router.py``) needs it: a
request a dead replica dropped is served again by another replica, in
whatever batch that replica holds then. For each tier this script serves
the same prompts through a fresh :class:`~veles_tpu_torch.serving.
GenerateAPI` over loopback HTTP, one request at a time, twice (cold, then
as prefix hits), and through another fresh api from six client threads
of six rounds each, twice (in two orders), and counts the burst streams
that differ from the alone ones. For the first few differences it
recomputes the alone stream's logits at the differing step with one
full-prefix forward and prints the top two and their gap.

The prompts are the smoke's shared-prompt traffic (a two-page system
prompt from seed 2, eight tails of 24 + 8 i tokens behind it, the system
prompt twice more) and six distinct prompts of 40-700 tokens from seed
6; 16 tokens a request. The tiers: the paged int8 tier on bf16 weights
and the paged float tier on f32 weights (the bf16 draws widened).

Run on the card at the repo's serving model's full width (``bench.py``
lines 861-862: embed 1024, 16 heads of 64, 4 blocks, vocab 32768, pages
of 128, 8 slots)::

    python -m veles_tpu_torch.scripts.batch_composition

``--small --device cpu`` runs a narrow model on the CPU (a self-check).
The last line is one JSON object with every count.
"""

import argparse
import json
import threading
import urllib.request

import numpy
import torch

from veles_tpu_torch.device import tree_to
from veles_tpu_torch.parallel.decode import _prefill_forward, quantize_params
from veles_tpu_torch.parallel.transformer_step import init_transformer_params
from veles_tpu_torch.serving import GenerateAPI

#: (embed, heads, blocks, vocab, page) at full width and in --small
WIDTHS = {"full": (1024, 16, 4, 32768, 128), "small": (32, 4, 2, 64, 16)}
SLOTS, MAX_LEN, CHUNK, N_TOKENS = 8, 1024, 8, 16
CLIENTS, ROUNDS = 6, 6


def prompts(vocab, page):
    """The shared-prompt traffic and the six distinct prompts."""
    rng = numpy.random.RandomState(2)
    system = rng.randint(0, vocab, 2 * page).tolist()
    tails = [system + rng.randint(0, vocab, 24 + 8 * i).tolist()
             for i in range(8)]
    rng = numpy.random.RandomState(6)
    return [system] + tails + [system, system] + [
        rng.randint(0, vocab, n).tolist()
        for n in (40, 100, 180, 300, 450, 700)]


def post(port, tokens):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps({"tokens": tokens, "n_tokens": N_TOKENS}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read().decode())["tokens"]


def burst(port, traffic, order):
    """CLIENTS threads of ROUNDS requests each, prompt ``order[(k *
    ROUNDS + r) % len(order)]``; returns {prompt index: [streams]}."""
    out, lock = {}, threading.Lock()

    def client(k):
        for r in range(ROUNDS):
            i = order[(k * ROUNDS + r) % len(order)]
            tokens = post(port, traffic[i])
            with lock:
                out.setdefault(i, []).append(tokens)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(CLIENTS)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(600)
    return out


def top2(params, table, heads, tokens):
    """The top two logits (f32) of one full-prefix forward of
    ``tokens``: (indices, values, gap)."""
    with torch.no_grad():
        x = table[torch.tensor(tokens, device=table.device)][None]
        logits = _prefill_forward(params, x, heads)[0].float()[0]
    top = torch.topk(logits, 2)
    return (top.indices.tolist(), top.values.tolist(),
            float(top.values[0] - top.values[1]))


def run_tier(label, params, table, heads, page, quantize, traffic, device):
    kwargs = dict(slots=SLOTS, max_len=MAX_LEN, n_tokens=N_TOKENS,
                  chunk=CHUNK, paged=True, page_size=page,
                  quantize=quantize)
    api = GenerateAPI(params, table, heads, device=device, **kwargs).start()
    try:
        alone = [post(api.port, p) for p in traffic]
        again = [post(api.port, p) for p in traffic]
    finally:
        api.stop()
    api = GenerateAPI(params, table, heads, device=device, **kwargs).start()
    try:
        order = list(range(len(traffic)))
        bursts = [burst(api.port, traffic, order),
                  burst(api.port, traffic, order[::-1])]
    finally:
        api.stop()
    diffs = []
    for got in bursts:
        for i, streams in sorted(got.items()):
            for stream in streams:
                if stream != alone[i]:
                    step = next(k for k, (a, b) in enumerate(
                        zip(stream, alone[i])) if a != b)
                    diffs.append({"prompt": i, "length": len(traffic[i]),
                                  "step": step})
    served = quantize_params(params) if quantize == "int8" else params
    for diff in diffs[:4]:
        i, step = diff["prompt"], diff["step"]
        indices, values, gap = top2(served, table, heads,
                                    traffic[i] + alone[i][:step])
        diff.update(top2=indices, logits=values, gap=gap,
                    alone_token=alone[i][step])
    result = {"alone_twice_equal": alone == again,
              "burst_streams": sum(len(s) for b in bursts
                                   for s in b.values()),
              "differing": len(diffs), "first": diffs[:4]}
    print("%s: %s" % (label, json.dumps(result)), flush=True)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.scripts.batch_composition")
    parser.add_argument("--small", action="store_true",
                        help="a narrow model (a self-check)")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    embed, heads, blocks, vocab, page = WIDTHS["small" if args.small
                                               else "full"]
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, blocks, embed, heads, vocab,
                                     dtype=torch.bfloat16, device=device)
    table = torch.from_numpy(
        rng.randn(vocab, embed).astype(numpy.float32) * 0.02).to(
            device=device, dtype=torch.bfloat16)
    traffic = prompts(vocab, page)
    if device.type == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    out = {"paged int8, bf16 weights": run_tier(
        "paged int8, bf16 weights", params, table, heads, page, "int8",
        traffic, device),
        "paged float, f32 weights": run_tier(
        "paged float, f32 weights", tree_to(params, device, torch.float32),
        table.float(), heads, page, None, traffic, device)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
