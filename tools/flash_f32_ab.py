"""The flash kernels' f32 route (``fwd_tf32`` in
``veles_tpu_torch/ops/csrc/flash_attention.cu``, ``dkv_tf32`` and
``dq_tf32`` in ``flash_attention_bwd.cu``, their shared arithmetic in
``tf32x3.cuh``) against variants of its own sources, on the card: why the
route rounds, sums and splits as it does.

Each variant is a few text edits of the checked-in sources, copied with
every other file of ``csrc/`` into ``veles_tpu_torch/_build/ab/<name>/``
and built there with ``nvcc`` and the package's flags; a variant builds
K7's library, K8 and K9's, or both, as its edits touch them:

- ``kernels``: the sources as checked in (both);
- ``nearest``: every backward product's split rounded to nearest;
- ``trunc``: every backward split truncated, dP's too;
- ``fwd_nearest``: both forward products' splits rounded to nearest;
- ``fwd_nearest_s``: the forward's S split rounded to nearest, P V's
  truncated;
- ``carried``: every sum carried in the mma's own accumulator, which
  rounds toward zero, with no f32 add (both);
- ``one_chain``: a value product's column blocks one at a time, one
  chain of 12 dependent mmas (both);
- ``cvt``: the TF32 rounding by ``cvt.rna.tf32.f32`` (masked) in place of
  the integer form (both);
- ``no_first_dot``: the causal first query's dP from the 3xTF32 product,
  not the f32 FMA dot;
- ``fwd_walk32``: the forward walking keys in tiles of 32, not 64.

For each it prints the worst rows under chip_smoke.py's row rule (each
row's error over its own norm, floored at 1e-2 of the median row's)
against the f32 plain versions and against a float64 reference at (1,
8192, 4, 128), (2, 333, 2, 128) and (1, 4096, 2, 256) causal, then the
times at (1, 8192, 4, 128) causal: K7's beside SDPA's f32 forward, and
K8's and K9's; medians of CUDA-event timings with the L2 flushed, the
variants run in order and then in reverse. Run on the card, from the
root of the repo::

    python -m tools.flash_f32_ab [--reps 11] [--only NAME ...]

The last line is one JSON object with every reading. The tool is a
measurement of the design, kept beside the package and outside the tests:
an edit of the kernel sources that moves a variant's text makes it stop
with the edit it could not apply, and ``VARIANTS`` is then brought up to
date with the sources before the next reading.
"""

import argparse
import ctypes
import json
import math
import shutil
import statistics
import subprocess

import torch

from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops import attention

FWD, BWD, TILES = ("flash_attention.cu", "flash_attention_bwd.cu",
                   "tf32x3.cuh")
OUT = _build.BUILD_DIR / "ab"
SHAPES = ((1, 8192, 4, 128), (2, 333, 2, 128), (1, 4096, 2, 256))
TIMED = SHAPES[0]

_FLAGS = ("constexpr bool kNearestS = false, kNearestDP = true, "
          "kNearestV = false;")
_FWD_FLAGS = "constexpr bool kNearestS = false, kNearestV = false;"
_SCORE = '''\
      float t[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
      mma3<kNearestS>(t, ah, al, pb[0], pb[4]);
      mma3<kNearestDP>(u, ch, cl, pd[0], pd[4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[n][e] += t[e];
        y[n][e] += u[e];
      }'''
_FWD_SCORE = '''\
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma3<kNearestS>(t, ah, al, pb[0], pb[4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] += t[e];'''
_LOOP = "for (int i = 0; i < 4; ++i)"
#: name -> [(file, old text, new text, how many times old occurs)]
VARIANTS = {
    "kernels": [],
    "nearest": [(BWD, _FLAGS, _FLAGS.replace("false", "true"), 1)],
    "trunc": [(BWD, _FLAGS, _FLAGS.replace("true", "false"), 1)],
    "fwd_nearest": [(FWD, _FWD_FLAGS, _FWD_FLAGS.replace("false", "true"),
                     1)],
    "fwd_nearest_s": [(FWD, _FWD_FLAGS, _FWD_FLAGS.replace(
        "kNearestS = false", "kNearestS = true"), 1)],
    "carried": [
        (BWD, _SCORE, '''      mma3<kNearestS>(x[n], ah, al, pb[0], pb[4]);
      mma3<kNearestDP>(y[n], ch, cl, pd[0], pd[4]);''', 1),
        (FWD, _FWD_SCORE,
         "      mma3<kNearestS>(x[n], ah, al, pb[0], pb[4]);", 1),
        (TILES, "t[i][e] = 0.f;", "t[i][e] = acc[n0 + i][e];", 1),
        (TILES, "acc[n0 + i][e] += t[i][e];", "acc[n0 + i][e] = t[i][e];",
         1)],
    "one_chain": [(TILES, "n0 += 4", "n0 += 1", 1),
                  (TILES, "float t[4][4];", "float t[1][4];", 1),
                  (TILES, _LOOP, _LOOP.replace("4", "1"), 3)],
    "cvt": [(TILES,
             "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
             '''  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;''', 1)],
    "no_first_dot": [
        (BWD, "if (causal && q0 == 0 && k0 == 0 && threadIdx.x == 0)",
         "if (false)", 1)],
    "fwd_walk32": [(FWD, "constexpr int kT32BK = 64;",
                    "constexpr int kT32BK = 32;", 1)],
}


def variant_sources(variants=VARIANTS):
    """{name: {file: text}} of every variant's edited files; raises
    naming an edit whose text the source no longer holds as often as it
    expects."""
    out = {}
    for name, edits in variants.items():
        texts = {}
        for path, old, new, count in edits:
            text = texts.get(path, (_build.CSRC / path).read_text())
            if text.count(old) != count:
                raise ValueError("variant %s: %r occurs %d times in %s, not "
                                 "%d" % (name, old[:60], text.count(old),
                                         path, count))
            texts[path] = text.replace(old, new)
        out[name] = texts
    return out


def targets(texts):
    """The libraries a variant builds: K7's where its edits touch the
    forward or the shared header (or nothing), K8 and K9's likewise."""
    if not texts or TILES in texts:
        return (FWD, BWD)
    return tuple(path for path in (FWD, BWD) if path in texts)


def build(sources):
    """Compile every variant's libraries at once; {name: {"fwd":
    veles_flash_fwd, "bwd": (veles_flash_dkv, veles_flash_dq)}} as each
    builds them, loaded with ctypes."""
    procs = {}
    for name, texts in sources.items():
        where = OUT / name
        shutil.rmtree(where, ignore_errors=True)
        shutil.copytree(_build.CSRC, where)
        for path, text in texts.items():
            (where / path).write_text(text)
        for path in targets(texts):
            lib = where / ("lib" + path.replace(".cu", ".so"))
            procs[name, path] = (lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(where / path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    argtypes = [ctypes.c_void_p] * 8 + attention._BACKWARD_ARGTYPES
    fns = {}
    for (name, path), (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError("nvcc failed for variant %s (%s):\n%s"
                               % (name, path, log))
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 ")]
        print("%s %s: %s" % (name, path, "; ".join(spills)))
        loaded = ctypes.CDLL(str(lib))
        if path == FWD:
            fwd = loaded.veles_flash_fwd
            fwd.argtypes = attention._FORWARD_ARGTYPES
            fns.setdefault(name, {})["fwd"] = fwd
        else:
            dkv, dq = loaded.veles_flash_dkv, loaded.veles_flash_dq
            dkv.argtypes, dq.argtypes = argtypes, argtypes[1:]
            fns.setdefault(name, {})["bwd"] = (dkv, dq)
    return fns


def worst_row(out, ref):
    """(the worst row's error over its floored norm, its position)."""
    diff, ref = out.double() - ref.double(), ref.double()
    norms = ref.norm(dim=-1)
    rows = diff.norm(dim=-1) / norms.clamp_min(1e-2 * norms.median())
    where = rows.flatten().argmax().item()
    return [rows.flatten()[where].item(), where // out.shape[2] % out.shape[1]]


def _causal_scores(q, k):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    return s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool,
                                     device=s.device).tril(), -math.inf)


def f64_forward(q, k, v):
    """The causal attention's output in float64 from the same f32
    inputs."""
    q, k, v = (t.double() for t in (q, k, v))
    p = torch.softmax(_causal_scores(q, k), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def f64_backward(q, k, v, do, lse, di):
    """(dK, dV, dQ) of the causal flash backward in float64 from the same
    f32 inputs, lse and di."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_causal_scores(q, k) - lse.double()[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v)
              - di.double()[..., None]) * scale
    return (torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, do),
            torch.einsum("bhqk,bkhd->bqhd", ds, k))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=11)
    parser.add_argument("--only", nargs="+", choices=sorted(VARIANTS),
                        help="these variants (and the checked-in kernels)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_f32_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    chosen = {name: edits for name, edits in VARIANTS.items()
              if not args.only or name == "kernels" or name in args.only}
    fns = build(variant_sources(chosen))
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    sdpa = torch.nn.functional.scaled_dot_product_attention

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
        label = "x".join(map(str, shape))
        rows = report["rows"][label] = {}
        # K7: out against the plain version and float64
        plain_out, plain_lse = attention._flash_attention_fwd_plain(q, k, v,
                                                                    True)
        exact = f64_forward(q, k, v)
        rows["plain"] = {"fwd_vs_f64": worst_row(plain_out, exact)}
        out, lse = torch.empty_like(q), torch.empty_like(plain_lse)
        fwd_rest = [b, h, t, t, d, 1, 0, 1.0 / math.sqrt(d),
                    *attention._strides(q), *attention._strides(k),
                    *attention._strides(v), attention._stream(q)]
        calls = {}
        for name, lib in fns.items():
            if "fwd" not in lib:
                continue
            calls[name] = lambda f=lib["fwd"]: f(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *fwd_rest)
            if calls[name]():
                raise RuntimeError("variant %s: K7 launch failed" % name)
            torch.cuda.synchronize()
            rows.setdefault(name, {}).update(
                fwd_vs_plain=worst_row(out, plain_out),
                fwd_vs_f64=worst_row(out, exact),
                lse_vs_plain=(lse - plain_lse).abs().max().item())
            print("%s %-13s K7 rows vs plain %s, vs f64 %s, lse %.3g" % (
                label, name, rows[name]["fwd_vs_plain"],
                rows[name]["fwd_vs_f64"], rows[name]["lse_vs_plain"]))
        del plain_out, exact
        if shape == TIMED:
            heads_first = [x.transpose(1, 2) for x in (q, k, v)]
            calls["sdpa"] = lambda: sdpa(*heads_first, is_causal=True)
            times = {name: [] for name in calls}
            for name in list(calls) + list(calls)[::-1]:
                times[name].append(timed(calls[name]))
            for name, k7 in times.items():
                report["times"].setdefault(name, {})["k7_ms"] = k7
                print("%s %-13s K7 %s ms" % (label, name, k7))
        # K8 and K9 on the checked-in forward's out and lse
        out, lse = attention.flash_attention_fwd(q, k, v, True)
        di = attention._row_dot(out, do)
        plain = (*attention._flash_attention_dkv_plain(q, k, v, do, lse, di,
                                                       True),
                 attention._flash_attention_dq_plain(q, k, v, do, lse, di,
                                                     True))
        exact = f64_backward(q, k, v, do, lse, di)
        rows["plain"]["vs_f64"] = [worst_row(x, r)
                                   for x, r in zip(plain, exact)]
        ptrs, rest = attention._backward_args(q, k, v, do, lse, di, True)
        dk, dv, dq = (torch.empty_like(x) for x in (k, v, q))
        calls = {}
        for name, lib in fns.items():
            if "bwd" not in lib:
                continue
            dkv, dq_fn = lib["bwd"]
            calls[name] = (
                lambda f=dkv: f(*ptrs, dk.data_ptr(), dv.data_ptr(), *rest),
                lambda f=dq_fn: f(*ptrs, dq.data_ptr(), *rest))
            if calls[name][0]() or calls[name][1]():
                raise RuntimeError("variant %s: launch failed" % name)
            torch.cuda.synchronize()
            got = (dk, dv, dq)
            rows.setdefault(name, {}).update(
                vs_plain=[worst_row(x, r) for x, r in zip(got, plain)],
                vs_f64=[worst_row(x, r) for x, r in zip(got, exact)])
            print("%s %-13s dK dV dQ rows vs plain %s, vs f64 %s" % (
                label, name, rows[name]["vs_plain"], rows[name]["vs_f64"]))
        del plain, exact
        if shape != TIMED:
            continue
        times = {name: ([], []) for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            times[name][0].append(timed(calls[name][0]))
            times[name][1].append(timed(calls[name][1]))
        for name, (k8, k9) in times.items():
            report["times"].setdefault(name, {}).update(k8_ms=k8, k9_ms=k9)
            print("%s %-13s K8 %s ms, K9 %s ms" % (label, name, k8, k9))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
