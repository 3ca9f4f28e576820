"""K8 and K9's f32 route (``dkv_tf32`` and ``dq_tf32`` in
``veles_tpu_torch/ops/csrc/flash_attention_bwd.cu``) against variants of
its own source, on the card: why the route rounds, sums and splits as it
does.

Each variant is a few text edits of the checked-in source, built with
``nvcc`` and the package's flags into ``veles_tpu_torch/_build/ab/``:

- ``kernels``: the source as checked in;
- ``nearest``: every product's split rounded to nearest;
- ``trunc``: every split truncated, dP's too;
- ``carried``: every sum carried in the mma's own accumulator, which
  rounds toward zero, with no f32 add;
- ``one_chain``: a value product's column blocks one at a time, one
  chain of 12 dependent mmas;
- ``cvt``: the TF32 rounding by ``cvt.rna.tf32.f32`` (masked) in place of
  the integer form;
- ``no_first_dot``: the causal first query's dP from the 3xTF32 product,
  not the f32 FMA dot.

For each it prints the worst rows under chip_smoke.py's row rule (each
row's error over its own norm, floored at 1e-2 of the median row's)
against the f32 plain versions and against a float64 reference at (1,
8192, 4, 128), (2, 333, 2, 128) and (1, 4096, 2, 256) causal, then K8's
and K9's times at (1, 8192, 4, 128) causal: medians of CUDA-event
timings with the L2 flushed, the variants run in order and then in
reverse. Run on the card, from the root of the repo::

    python -m tools.flash_f32_ab [--reps 11]

The last line is one JSON object with every reading. The tool is a
measurement of the design, kept beside the package and outside the tests:
an edit of the kernel source that moves a variant's text makes it stop
with the edit it could not apply, and ``VARIANTS`` is then brought up to
date with the source before the next reading.
"""

import argparse
import ctypes
import json
import math
import statistics
import subprocess

import torch

from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops import attention

SOURCE = _build.CSRC / "flash_attention_bwd.cu"
OUT = _build.BUILD_DIR / "ab"
SHAPES = ((1, 8192, 4, 128), (2, 333, 2, 128), (1, 4096, 2, 256))
TIMED = SHAPES[0]

_FLAGS = ("constexpr bool kNearestS = false, kNearestDP = true, "
          "kNearestV = false;")
_SCORE = '''\
      float t[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
      mma3<kNearestS>(t, ah, al, pb[0], pb[4]);
      mma3<kNearestDP>(u, ch, cl, pd[0], pd[4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[n][e] += t[e];
        y[n][e] += u[e];
      }'''
_LOOP = "for (int i = 0; i < 4; ++i)"
#: name -> [(old text, new text, how many times old occurs)]
VARIANTS = {
    "kernels": [],
    "nearest": [(_FLAGS, _FLAGS.replace("false", "true"), 1)],
    "trunc": [(_FLAGS, _FLAGS.replace("true", "false"), 1)],
    "carried": [
        (_SCORE, '''      mma3<kNearestS>(x[n], ah, al, pb[0], pb[4]);
      mma3<kNearestDP>(y[n], ch, cl, pd[0], pd[4]);''', 1),
        ("t[i][e] = 0.f;", "t[i][e] = acc[n0 + i][e];", 1),
        ("acc[n0 + i][e] += t[i][e];", "acc[n0 + i][e] = t[i][e];", 1)],
    "one_chain": [("n0 += 4", "n0 += 1", 1),
                  ("float t[4][4];", "float t[1][4];", 1),
                  (_LOOP, _LOOP.replace("4", "1"), 3)],
    "cvt": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
             '''  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;''', 1)],
    "no_first_dot": [
        ("if (causal && q0 == 0 && k0 == 0 && threadIdx.x == 0)",
         "if (false)", 1)],
}


def variant_sources(source):
    """{name: source text} of every variant; raises naming an edit whose
    text the source no longer holds as often as it expects."""
    out = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new, count in edits:
            if text.count(old) != count:
                raise ValueError("variant %s: %r occurs %d times, not %d"
                                 % (name, old[:60], text.count(old), count))
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources):
    """Compile every variant at once; {name: (veles_flash_dkv,
    veles_flash_dq)} loaded with ctypes."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / (name + ".cu")
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(OUT / ("lib%s.so" % name)), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    argtypes = [ctypes.c_void_p] * 8 + attention._BACKWARD_ARGTYPES
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError("nvcc failed for variant %s:\n%s"
                               % (name, log))
        lib = ctypes.CDLL(str(OUT / ("lib%s.so" % name)))
        dkv, dq = lib.veles_flash_dkv, lib.veles_flash_dq
        dkv.argtypes, dq.argtypes = argtypes, argtypes[1:]
        fns[name] = (dkv, dq)
    return fns


def worst_row(out, ref):
    """(the worst row's error over its floored norm, its position)."""
    diff, ref = out.double() - ref.double(), ref.double()
    norms = ref.norm(dim=-1)
    rows = diff.norm(dim=-1) / norms.clamp_min(1e-2 * norms.median())
    where = rows.flatten().argmax().item()
    return [rows.flatten()[where].item(), where // out.shape[2] % out.shape[1]]


def f64_backward(q, k, v, do, lse, di):
    """(dK, dV, dQ) of the causal flash backward in float64 from the same
    f32 inputs, lse and di."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool,
                                  device=s.device).tril(), -math.inf)
    p = torch.exp(s - lse.double()[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v)
              - di.double()[..., None]) * scale
    return (torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, do),
            torch.einsum("bhqk,bkhd->bqhd", ds, k))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=11)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_f32_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    fns = build(variant_sources(SOURCE.read_text()))
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(fn):
        times = []
        for i in range(2 + args.reps):
            flush.zero_()
            start.record()
            fn()
            end.record()
            end.synchronize()
            if i >= 2:
                times.append(start.elapsed_time(end))
        return statistics.median(times)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    report = {"device": torch.cuda.get_device_name(0), "rows": {},
              "times": {}}
    for shape in SHAPES:
        b, t, h, d = shape
        qkv = torch.randn((b, t, 3 * h * d), generator=gen, device=device)
        q, k, v = (x.reshape(shape) for x in qkv.split(h * d, -1))
        do = torch.randn(shape, generator=gen, device=device)
        out, lse = attention.flash_attention_fwd(q, k, v, True)
        di = attention._row_dot(out, do)
        plain = (*attention._flash_attention_dkv_plain(q, k, v, do, lse, di,
                                                       True),
                 attention._flash_attention_dq_plain(q, k, v, do, lse, di,
                                                     True))
        exact = f64_backward(q, k, v, do, lse, di)
        label = "x".join(map(str, shape))
        rows = report["rows"][label] = {"plain": {
            "vs_f64": [worst_row(x, r) for x, r in zip(plain, exact)]}}
        ptrs, rest = attention._backward_args(q, k, v, do, lse, di, True)
        dk, dv, dq = (torch.empty_like(x) for x in (k, v, q))
        calls = {}
        for name, (dkv, dq_fn) in fns.items():
            calls[name] = (
                lambda f=dkv: f(*ptrs, dk.data_ptr(), dv.data_ptr(), *rest),
                lambda f=dq_fn: f(*ptrs, dq.data_ptr(), *rest))
            if calls[name][0]() or calls[name][1]():
                raise RuntimeError("variant %s: launch failed" % name)
            torch.cuda.synchronize()
            got = (dk, dv, dq)
            rows[name] = {
                "vs_plain": [worst_row(x, r) for x, r in zip(got, plain)],
                "vs_f64": [worst_row(x, r) for x, r in zip(got, exact)]}
            print("%s %-12s dK dV dQ rows vs plain %s, vs f64 %s" % (
                label, name, rows[name]["vs_plain"], rows[name]["vs_f64"]))
        del plain, exact
        if shape != TIMED:
            continue
        times = {name: ([], []) for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            times[name][0].append(timed(calls[name][0]))
            times[name][1].append(timed(calls[name][1]))
        for name, (k8, k9) in times.items():
            report["times"][name] = {"k8_ms": k8, "k9_ms": k9}
            print("%s %-12s K8 %s ms, K9 %s ms" % (label, name, k8, k9))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
