"""Drive the PyTorch/CUDA port (veles_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of the serving path from veles_tpu_torch/ops/csrc
   with nvcc (sm_90a), then hold each kernel against its plain PyTorch
   version at the serving path's shapes, and time kernel, plain version
   and the nearest PyTorch library call with CUDA events (L2 flushed
   before every timed launch, median of 25);
3. GenerateAPI at the full width of the repo's serving model (embed
   1024, 16 heads, 4 blocks, vocab 32768, bf16, paged pool of 128-token
   pages, 8 slots) answers 8 concurrent HTTP requests, with float and
   with int8 weights; the kernels' launch counters show the path went
   through them;
4. the same configuration in float32 streams the same greedy tokens as
   the port's dense reference decode, up to the first step where the
   reference's top-2 logit gap is below 1e-3.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero before printing either.
"""

import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy
import torch

from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops.paged_attention import (_paged_attend_plain,
                                                 paged_attend)
from veles_tpu_torch.ops.quant import (_int8_matmul_plain, int8_matmul,
                                       quantize_int8)
from veles_tpu_torch.parallel.decode import generate, quantize_params
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)
from veles_tpu_torch.serving import GenerateAPI

#: the repo's serving model at full width (bench.py:861-862)
EMBED, HEADS, BLOCKS, VOCAB = 1024, 16, 4, 32768
SLOTS, MAX_LEN, N_TOKENS, CHUNK, PAGE = 8, 1024, 32, 8, 128
#: H100 SXM device memory rate (NVIDIA data sheet), bytes/s, and the
#: dense bf16 tensor-core peak, operations/s
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
#: K1 writes f32 from bf16 inputs that both versions widen exactly;
#: they differ only in summation order and exp over up to 1101
#: positions, far inside this bound
K1_ATOL = 2e-3
#: K2 writes bf16: a one-ulp difference in the final rounding is 2^-8
#: relative, so the bound is 1e-2 of the output's largest magnitude
K2_RTOL = 1e-2
#: decode-step weight shapes (K, N) and launches of each per step: the
#: four block projections per block, then the vocab head
K2_SHAPES = ((EMBED, 3 * EMBED), (EMBED, EMBED), (EMBED, 4 * EMBED),
             (4 * EMBED, EMBED), (EMBED, VOCAB))
K2_PER_STEP = (BLOCKS, BLOCKS, BLOCKS, BLOCKS, 1)
TOP2_GAP = 1e-3


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median device time of one call, from CUDA events, with the L2
    cache flushed (a 256 MB write) before every timed launch."""

    def __init__(self, device, reps=25, warmup=3):
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device=device)
        self.reps = reps
        self.warmup = warmup
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __call__(self, fn):
        times = []
        for i in range(self.warmup + self.reps):
            self.flush.zero_()
            self.start.record()
            fn()
            self.end.record()
            self.end.synchronize()
            if i >= self.warmup:
                times.append(self.start.elapsed_time(self.end))
        return statistics.median(times)


def k1_problem(device, gen):
    """The serving path's K1 shapes: 8 slots, 16 heads of 64, 128-token
    bf16 pages, ragged lengths from 0 to 1100 (0, a page boundary, a
    full table row), and a page table with one column more than the
    longest row needs, rows padded with the scratch page."""
    lengths = [0, 127, 128, 300, 511, 700, 1023, 1100]
    pb = 1100 // PAGE + 2
    table = numpy.zeros((SLOTS, pb), numpy.int32)
    nxt = 1
    for s, n in enumerate(lengths):
        for p in range(n // PAGE + 1):
            table[s, p] = nxt
            nxt += 1
    shape = (nxt, PAGE, HEADS, EMBED // HEADS)
    k = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    q = torch.randn((SLOTS, HEADS, EMBED // HEADS), generator=gen,
                    device=device).to(torch.bfloat16)
    return (q, k, v, torch.from_numpy(table).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


def k1_phase(timer, device, gen):
    q, k, v, table, lengths = k1_problem(device, gen)
    out = paged_attend(q, k, v, table, lengths, page_size=PAGE)
    ref = _paged_attend_plain(q, k, v, table, lengths, PAGE)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    print("K1 paged_attend: max_abs_err %.3g (tolerance %.1g)"
          % (err, K1_ATOL))
    if not err <= K1_ATOL:
        raise AssertionError("K1 disagrees with its plain version")
    # the library yardstick: SDPA over K/V already gathered contiguous
    # (the gather itself is not timed), with the same visibility mask
    span = table.shape[1] * PAGE
    idx = table.long()
    kg = k[idx].reshape(SLOTS, span, HEADS, -1).transpose(1, 2)
    vg = v[idx].reshape(SLOTS, span, HEADS, -1).transpose(1, 2)
    mask = (torch.arange(span, device=device)[None, :]
            <= lengths[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: paged_attend(q, k, v, table, lengths,
                                    page_size=PAGE))
    plain_ms = timer(lambda: _paged_attend_plain(q, k, v, table, lengths,
                                                 PAGE))
    library_ms = timer(lambda: sdpa(qs, kg, vg, attn_mask=mask))
    live = sum(min(int(n) + 1, table.shape[1] * PAGE)
               for n in lengths.tolist())
    head_dim = EMBED // HEADS
    nbytes = (q.numel() * q.element_size()
              + 2 * live * HEADS * head_dim * k.element_size()
              + table.numel() * 4 + lengths.numel() * 4
              + SLOTS * HEADS * head_dim * 4)
    ops = 4 * live * HEADS * head_dim
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_OPS_PER_S else "operations")
    print("K1 ms %.4f plain_ms %.4f sdpa_ms %.4f bound_ms %.4f (%s, %d "
          "live positions, %d bytes)" % (ms, plain_ms, library_ms,
                                         bound_ms, bound_by, live,
                                         nbytes))
    return {"name": "paged_attend", "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "veles_tpu/ops/paged_attention.py:151",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def library_available(x, q_t, scale_t):
    """Whether this PyTorch build runs its W8A16 operator
    (``torch._weight_int8pack_mm``) on the card: the yardstick, never
    called by the port."""
    try:
        torch._weight_int8pack_mm(x, q_t, scale_t)
        torch.cuda.synchronize()
        return True
    except (AttributeError, RuntimeError, NotImplementedError) as exc:
        print("K2 library yardstick unavailable: %s"
              % str(exc).splitlines()[0])
        return False


def k2_phase(timer, device, gen):
    """Every M in {8, 100, 256} at every weight shape of the decode
    step, bf16 x; the JSON numbers are one decode step's worth at M = 8
    (each shape's time times its launches per step)."""
    worst_rel, worst_abs = 0.0, 0.0
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bytes_s": 0.0, "ops_s": 0.0}
    library = None
    for (k, n), per_step in zip(K2_SHAPES, K2_PER_STEP):
        w = torch.randn((k, n), generator=gen, device=device) / math.sqrt(k)
        q, scale = quantize_int8(w)
        # the library yardstick's layout: (N, K) weights, scales in x's
        # type
        q_t = q.t().contiguous()
        scale_t = scale.to(torch.bfloat16)
        for m in (8, 100, 256):
            x = torch.randn((m, k), generator=gen,
                            device=device).to(torch.bfloat16)
            out = int8_matmul(x, q, scale)
            ref = _int8_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs().max().item()
            rel = diff / ref.float().abs().max().item()
            worst_abs = max(worst_abs, diff)
            worst_rel = max(worst_rel, rel)
            if library is None:
                library = library_available(x, q_t, scale_t)
            ms = timer(lambda: int8_matmul(x, q, scale))
            plain_ms = timer(lambda: _int8_matmul_plain(x, q, scale))
            library_ms = (timer(lambda: torch._weight_int8pack_mm(
                x, q_t, scale_t)) if library else None)
            nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
            ops = 2 * m * k * n
            bytes_s = nbytes / HBM_BYTES_PER_S
            ops_s = ops / BF16_OPS_PER_S
            print("K2 int8_matmul M=%d K=%d N=%d: rel_err %.3g abs_err "
                  "%.3g ms %.4f plain_ms %.4f library_ms %s bound_ms "
                  "%.4f (%s)"
                  % (m, k, n, rel, diff, ms, plain_ms,
                     "%.4f" % library_ms if library_ms is not None
                     else "null", 1e3 * max(bytes_s, ops_s),
                     "bytes" if bytes_s >= ops_s else "operations"))
            if m == 8:
                step["ms"] += per_step * ms
                step["plain_ms"] += per_step * plain_ms
                if library:
                    step["library_ms"] += per_step * library_ms
                step["bytes_s"] += per_step * bytes_s
                step["ops_s"] += per_step * ops_s
    print("K2 worst rel_err %.3g (tolerance %.0e relative to the largest "
          "output)" % (worst_rel, K2_RTOL))
    if not worst_rel <= K2_RTOL:
        raise AssertionError("K2 disagrees with its plain version")
    bound_s = max(step["bytes_s"], step["ops_s"])
    return {"name": "int8_matmul", "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/int8_matmul.cu",
            "replaces": "veles_tpu/ops/quant.py:63",
            "max_abs_err": worst_abs, "ms": step["ms"],
            "plain_ms": step["plain_ms"], "bound_ms": 1e3 * bound_s,
            "bound_by": ("bytes" if step["bytes_s"] >= step["ops_s"]
                         else "operations"),
            "library_ms": step["library_ms"] if library else None}


def post(port, tokens, n_tokens, timeout=600):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps({"tokens": tokens, "n_tokens": n_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())["tokens"]


def serve(params, table, prompts, quantize, device):
    """Answer every prompt through GenerateAPI over HTTP, all at once.
    Returns (streams, wall seconds, K1 launches, K2 launches, chunks,
    host-blocking seconds) for the concurrent burst (a short warm-up
    request runs first, and the launch counters are zeroed after
    it)."""
    api = GenerateAPI(params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK, paged=True,
                      page_size=PAGE, quantize=quantize,
                      device=device).start()
    try:
        post(api.port, prompts[0][:16], CHUNK)
        torch.cuda.synchronize()
        paged_attend.launches = 0
        int8_matmul.launches = 0
        chunks0 = api.decoder.dispatch_counts["chunk"]
        timings0 = dict(api.decoder.timings)
        streams = [None] * len(prompts)
        errors = []

        def client(i):
            try:
                streams[i] = post(api.port, prompts[i], N_TOKENS)
            except Exception as exc:  # reported below, fails the phase
                errors.append("request %d: %r" % (i, exc))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=900)
        wall = time.perf_counter() - t0
        k1, k2 = paged_attend.launches, int8_matmul.launches
        if errors or any(thread.is_alive() for thread in threads):
            raise AssertionError("serving failed: %s" % errors)
        dec = api.decoder
        chunks = dec.dispatch_counts["chunk"] - chunks0
        host_s = sum(dec.timings[key] - timings0[key]
                     for key in ("dispatch_s", "collect_s"))
        return streams, wall, k1, k2, chunks, host_s
    finally:
        api.stop()


def serving_phase(device, prompts):
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                     dtype=torch.bfloat16, device=device)
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02).to(
            device=device, dtype=torch.bfloat16)
    launches = {"paged_attend": 0, "int8_matmul": 0}
    for quantize in (None, "int8"):
        streams, wall, k1, k2, chunks, host_s = serve(
            params, table, prompts, quantize, device)
        for stream in streams:
            if len(stream) != N_TOKENS \
                    or not all(0 <= t < VOCAB for t in stream):
                raise AssertionError("bad stream: %r" % (stream,))
        steps = chunks * CHUNK
        print("serve %s bf16: %d requests x %d tokens in %.3f s = %.1f "
              "tokens/s; %d chunks of %d, %.3f host-blocking ms per chunk "
              "(dispatch + collect); K1 launches %d (>= %d blocks x %d "
              "steps), K2 launches %d"
              % (quantize or "float", len(prompts), N_TOKENS, wall,
                 len(prompts) * N_TOKENS / wall, chunks, CHUNK,
                 1e3 * host_s / max(chunks, 1), k1, BLOCKS, steps, k2))
        if k1 < BLOCKS * steps or steps == 0:
            raise AssertionError("K1 launches %d < %d blocks x %d steps"
                                 % (k1, BLOCKS, steps))
        if quantize == "int8" and k2 == 0:
            raise AssertionError("the int8 run never launched K2")
        launches["paged_attend"] += k1
        launches["int8_matmul"] += k2
    return launches


def agreement_phase(device, prompts):
    """float32 serving against the dense reference decode: float
    weights against generate() on the card (plain ops: no kernel may
    launch), int8 weights against generate() on the CPU (plain ops
    everywhere)."""
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                     device="cpu")
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02)
    for quantize in (None, "int8"):
        tier = params if quantize is None else quantize_params(params)
        streams = serve(tier, table, prompts, quantize, device)[0]
        ref_device = device if quantize is None else "cpu"
        compared = cut = 0
        for prompt, stream in zip(prompts, streams):
            before = (paged_attend.launches, int8_matmul.launches)
            ref, _, logits = generate(
                tier, table, numpy.asarray(prompt)[None], HEADS,
                N_TOKENS, return_logits=True, device=ref_device)
            if (paged_attend.launches, int8_matmul.launches) != before:
                raise AssertionError("the reference decode launched a "
                                     "kernel")
            top2 = torch.topk(logits[0], 2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            n = next((i for i, g in enumerate(gaps) if g < TOP2_GAP),
                     len(gaps))
            if stream[:n] != ref[0, :n].tolist():
                raise AssertionError(
                    "%s stream disagrees with the reference: %r vs %r"
                    % (quantize or "float", stream[:n],
                       ref[0, :n].tolist()))
            compared += n
            cut += len(gaps) - n
        print("agreement %s f32: %d steps compared, %d steps cut off at a "
              "reference top-2 gap below %.0e"
              % (quantize or "float", compared, cut, TOP2_GAP))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print("torch %s, CUDA %s, %s x%d" % (
        torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), torch.cuda.device_count()))
    t0 = time.perf_counter()
    logs = _build.build()
    print("kernels built in %.1f s" % (time.perf_counter() - t0))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  %s: %s" % (name, line.strip()))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    timer = Timer(device)
    kernels = [k1_phase(timer, device, gen), k2_phase(timer, device, gen)]
    prng = numpy.random.RandomState(1)
    prompts = [prng.randint(0, VOCAB, n).tolist()
               for n in numpy.linspace(60, 700, SLOTS).astype(int)]
    launches = serving_phase(device, prompts)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    agreement_phase(device, prompts)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
