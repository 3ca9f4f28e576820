"""Where the observe planes' cost goes on the serving path.

Serves bursts of prompts through :class:`~veles_tpu_torch.serving.GenerateAPI`
over loopback HTTP, in the paged ``int8`` tier, under plane settings
taken in turn (ABBA order within each repetition):

- ``default``: ``start()`` as a user runs it, nothing patched: the flight
  ring, the request ledger and the serve scope on, the registry and the
  device truth enabled by ``start()``, the tracer off, and the metric
  history's sampler off (``history`` adds it);
- ``off``: every plane off after ``start()``;
- ``flight``: the flight ring alone;
- ``metrics``: the registry and the device truth alone;
- ``traced``: ``default`` plus the tracer writing spans to a JSONL file;
- ``ledger_off``: ``default`` with the request ledger and the serve scope
  off;
- ``history``: ``default`` with the metric history's sampler running at
  its 1 s default.

Each run prints its tokens/s and a timeline from stamps taken around the
driver's calls (identical in every setting): when the burst's requests
were staged, the driver's time inside ``dispatch_chunk`` (admission
included), ``collect_chunk`` and the progress bookkeeping, the driver's
idle gaps, the process's and the driver thread's CPU seconds, and the
interpreter's garbage collections. ``--profile-driver`` adds one
``cProfile`` of the driver thread for ``default`` and for ``off``.

Run on the card at the repo's serving model's full width (``bench.py``
lines 861-862: embed 1024, 16 heads of 64, 4 blocks, vocab 32768, bf16,
8 slots)::

    python -m veles_tpu_torch.scripts.observe_cost --reps 6

``--small --device cpu`` runs a narrow model on the CPU (a self-check).
"""

import argparse
import cProfile
import contextlib
import gc
import io
import json
import os
import pstats
import statistics
import tempfile
import threading
import time
import urllib.request

import numpy
import torch

from veles_tpu_torch.core.logger import (enable_event_recording,
                                         get_event_recorder)
from veles_tpu_torch.observe.flight import get_flight_recorder
from veles_tpu_torch.observe.history import (MetricHistory,
                                             set_metric_history)
from veles_tpu_torch.observe.metrics import get_metrics_registry
from veles_tpu_torch.observe.reqledger import get_request_ledger
from veles_tpu_torch.observe.servescope import get_serve_scope
from veles_tpu_torch.observe.tracing import get_tracer
from veles_tpu_torch.observe.xla_stats import get_compile_tracker
from veles_tpu_torch.parallel.transformer_step import init_transformer_params
from veles_tpu_torch.serving import GenerateAPI

#: the serving model at full width (bench.py:861-862) and its burst
FULL = dict(embed=1024, heads=16, blocks=4, vocab=32768, slots=8,
            max_len=1024, n_tokens=32, chunk=8, page=128,
            prompts=(60, 700))
#: a narrow model for the CPU
SMALL = dict(embed=64, heads=4, blocks=2, vocab=512, slots=8, max_len=256,
             n_tokens=32, chunk=8, page=16, prompts=(20, 120))

SETTINGS = ("default", "off", "flight", "metrics", "traced", "ledger_off",
            "history")

#: the planes as ``start()`` leaves them
DEFAULT = ("flight", "registry", "tracker", "ledger", "scope")


def set_history(setting):
    """Before ``start()``: the process metric history at its 1 s default
    for ``history`` (the front starts its sampler), else none."""
    set_metric_history(MetricHistory.from_config(
        registry=get_metrics_registry()) if setting == "history" else None)


def set_planes(setting):
    """Turn the planes of ``setting`` on and the others off (called
    after ``start()``, which enabled the registry and device truth)."""
    on = {"default": DEFAULT,
          "off": (),
          "flight": ("flight",),
          "metrics": ("registry", "tracker"),
          "traced": DEFAULT + ("tracer",),
          "ledger_off": ("flight", "registry", "tracker"),
          "history": DEFAULT}[setting]
    get_flight_recorder().enabled = "flight" in on
    get_metrics_registry().enabled = "registry" in on
    get_compile_tracker().enabled = "tracker" in on
    get_tracer().enabled = "tracer" in on
    get_request_ledger().enabled = "ledger" in on
    get_serve_scope().enabled = "scope" in on


class GcClock:
    """The interpreter's garbage collections and their wall ms (a
    ``gc.callbacks`` entry while installed)."""

    def __init__(self):
        self.n, self.ms, self._t = 0, 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.n += 1
            self.ms += 1e3 * (time.perf_counter() - self._t)

    @contextlib.contextmanager
    def install(self):
        gc.callbacks.append(self)
        try:
            yield self
        finally:
            gc.callbacks.remove(self)


class Stamps:
    """(name, start, end) perf_counter stamps of wrapped calls."""

    def __init__(self):
        self.rows = []
        self.lock = threading.Lock()

    def wrap(self, obj, name):
        real = getattr(obj, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                with self.lock:
                    self.rows.append((name, t0, t1))
        setattr(obj, name, wrapper)


def thread_cpu(thread):
    return time.clock_gettime(time.pthread_getcpuclockid(thread.ident))


def post(port, tokens, n_tokens):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps({"tokens": tokens, "n_tokens": n_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read().decode())["tokens"]


def one_run(params, table, prompts, cfg, setting, device, profile=False):
    """One burst under ``setting``; returns its timeline by name."""
    api = GenerateAPI(params, table, cfg["heads"], slots=cfg["slots"],
                      max_len=cfg["max_len"], n_tokens=cfg["n_tokens"],
                      chunk=cfg["chunk"], paged=True,
                      page_size=cfg["page"], quantize="int8",
                      device=device)
    stamps = Stamps()
    for name in ("dispatch_chunk", "collect_chunk"):
        stamps.wrap(api.decoder, name)
    for name in ("_stage", "_note_progress", "_drain_staged"):
        stamps.wrap(api, name)
    prof = cProfile.Profile() if profile else None
    if prof is not None:
        drive = api._drive

        def profiled():
            prof.enable()
            try:
                drive()
            finally:
                prof.disable()
        api._drive = profiled
    set_history(setting)
    api.start()
    try:
        # a warm-up request shorter than a page, then the setting
        post(api.port, prompts[0][:min(16, cfg["page"] - 1)], cfg["chunk"])
        if device.type == "cuda":
            torch.cuda.synchronize()
        set_planes(setting)
        del stamps.rows[:]
        timings0 = dict(api.decoder.timings)
        chunks0 = api.decoder.dispatch_counts["chunk"]
        replies = [None] * len(prompts)
        clock = GcClock()

        def client(i):
            post(api.port, prompts[i], cfg["n_tokens"])
            replies[i] = time.perf_counter()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        cpu0, driver0 = time.process_time(), thread_cpu(api._driver)
        with clock.install():
            t0 = time.perf_counter()
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
            wall = time.perf_counter() - t0
        cpu, driver = (time.process_time() - cpu0,
                       thread_cpu(api._driver) - driver0)
        timings = {key: api.decoder.timings[key] - timings0[key]
                   for key in timings0}
        chunks = api.decoder.dispatch_counts["chunk"] - chunks0
    finally:
        set_planes("default")
        api.stop()
        set_history(None)
    rows = sorted(stamps.rows, key=lambda row: row[1])
    staged = [t0_ - t0 for name, t0_, _ in rows if name == "_stage"]
    driver_rows = [row for row in rows if row[0] != "_stage"]
    busy = {}
    for name, start, end in driver_rows:
        busy[name] = busy.get(name, 0.0) + end - start
    first = next((start for name, start, _ in driver_rows
                  if name == "dispatch_chunk"), t0)
    gaps = [b[1] - a[2] for a, b in zip(driver_rows, driver_rows[1:])
            if b[1] > a[2]]
    out = {
        "setting": setting,
        "tokens_s": len(prompts) * cfg["n_tokens"] / wall,
        "wall_ms": 1e3 * wall,
        "staged_first_ms": 1e3 * min(staged) if staged else None,
        "staged_last_ms": 1e3 * max(staged) if staged else None,
        "first_dispatch_ms": 1e3 * (first - t0),
        "dispatch_ms": 1e3 * busy.get("dispatch_chunk", 0.0),
        "collect_ms": 1e3 * busy.get("collect_chunk", 0.0),
        "progress_ms": 1e3 * busy.get("_note_progress", 0.0),
        "drain_ms": 1e3 * busy.get("_drain_staged", 0.0),
        "gaps_ms": 1e3 * sum(gaps),
        "gaps_over_1ms": sum(g > 1e-3 for g in gaps),
        "last_reply_ms": 1e3 * (max(replies) - t0),
        "admit_ms": 1e3 * timings["admit_s"],
        "enqueue_ms": 1e3 * timings["dispatch_s"],
        "readback_ms": 1e3 * timings["collect_s"],
        "chunks": chunks,
        "cpu_ms": 1e3 * cpu,
        "driver_cpu_ms": 1e3 * driver,
        "gc": clock.n,
        "gc_ms": clock.ms,
    }
    if prof is not None:
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(15)
        out["profile"] = text.getvalue()
    return out


def model(cfg, device):
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, cfg["blocks"], cfg["embed"],
                                     cfg["heads"], cfg["vocab"],
                                     dtype=torch.bfloat16, device=device)
    table = torch.from_numpy(
        rng.randn(cfg["vocab"], cfg["embed"]).astype(numpy.float32)
        * 0.02).to(device=device, dtype=torch.bfloat16)
    prng = numpy.random.RandomState(1)
    prompts = [prng.randint(0, cfg["vocab"], n).tolist()
               for n in numpy.linspace(*cfg["prompts"],
                                       cfg["slots"]).astype(int)]
    return params, table, prompts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=6)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--settings", default=",".join(SETTINGS))
    parser.add_argument("--profile-driver", action="store_true")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("observe_cost: no CUDA device available")
        return 1
    cfg = SMALL if args.small else FULL
    settings = args.settings.split(",")
    params, table, prompts = model(cfg, device)
    directory = tempfile.mkdtemp(prefix="observe-cost-")
    enable_event_recording(os.path.join(directory, "events.jsonl"))
    # one throwaway run: kernel loads, allocator growth, first calls
    one_run(params, table, prompts, cfg, "default", device)
    runs = []
    for rep in range(args.reps):
        order = settings if rep % 2 == 0 else settings[::-1]
        for setting in order:
            run = one_run(params, table, prompts, cfg, setting, device)
            runs.append(run)
            print(" ".join("%s=%s" % (k, ("%.3f" % v if isinstance(
                v, float) else v)) for k, v in run.items()), flush=True)
    keys = [k for k, v in runs[0].items() if isinstance(v, (int, float))]
    print("medians:")
    for setting in settings:
        mine = [run for run in runs if run["setting"] == setting]
        print("  %-8s %s" % (setting, " ".join(
            "%s=%.3f" % (k, statistics.median(run[k] for run in mine
                                              if run[k] is not None))
            for k in keys)))
    if args.profile_driver:
        for setting in ("default", "off"):
            run = one_run(params, table, prompts, cfg, setting, device,
                          profile=True)
            print("driver profile, %s (%.1f tokens/s):\n%s"
                  % (setting, run["tokens_s"], run["profile"]))
    get_event_recorder().close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
