"""Gloo worlds of ``python -c`` ranks for the port's CPU tests of the
serving mesh (tests/test_torch_tp_decode.py, test_torch_reshard.py,
test_torch_mesh_serving.py): each rank is a fresh interpreter on the
port alone that joins the world on an ephemeral port, runs every case of
its file and pickles its results for the parent, which holds them
against the JAX package in its own process. A world gets a deadline; its
ranks are killed when it passes, and the test then fails."""

import json
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))

#: the preamble every rank script runs: join the world, read the config
PREAMBLE = r'''
import json, pickle, sys
import numpy, torch
torch.set_num_threads(1)
cfg = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
with open(cfg["inputs"], "rb") as fin:
    inputs = pickle.load(fin)
from veles_tpu_torch.parallel.mesh import build_mesh, initialize_distributed
initialize_distributed(cfg["coordinator"], cfg["world"], rank,
                       device="cpu", timeout=cfg["timeout"])
out = {}
def save():
    with open(cfg["out"] % rank, "wb") as fout:
        pickle.dump(out, fout)
def finish():
    # the results are saved; gloo's teardown at interpreter exit is not
    # under test, and under a loaded host it aborts now and then
    # (std::terminate in the process group's destructor), so leave at once
    save()
    import os
    sys.stdout.flush()
    os._exit(0)
'''


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_world(body, world, directory, inputs, timeout=60, extra=None):
    """Start ``world`` ranks running :data:`PREAMBLE` then ``body`` (which
    fills ``out`` and calls ``finish()``, or ``save()`` and leaves on its
    own); ``inputs`` (pickled) reach them as ``inputs``. Returns
    ``(procs, out_pattern)``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "inputs.pickle")
    with open(path, "wb") as fout:
        pickle.dump(inputs, fout)
    cfg = dict(extra or {}, world=world, timeout=timeout, inputs=path,
               coordinator="127.0.0.1:%d" % free_port(),
               out=os.path.join(directory, "rank%d.pickle"))
    cfg_path = os.path.join(directory, "config.json")
    with open(cfg_path, "w") as fout:
        json.dump(cfg, fout)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + TESTS + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", PREAMBLE + body, cfg_path, str(rank)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    return procs, cfg["out"]


def join_world(started, deadline, check=True):
    """Wait at most ``deadline`` seconds for the ranks of ``started``
    (:func:`start_world`'s return); kill them all on expiry (the test
    fails) and, with ``check``, fail on a rank's non-zero exit. Returns
    ``(results, logs)``: each rank's pickled ``out`` (None where it wrote
    none) and its output."""
    procs, pattern = started
    end = time.monotonic() + deadline
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(
                timeout=max(end - time.monotonic(), 0.1))[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a world of ranks passed its %d s deadline" % deadline)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if check:
        for rank, (proc, log) in enumerate(zip(procs, logs)):
            assert proc.returncode == 0, "rank %d:\n%s" % (rank, log[-4000:])
    results = []
    for rank in range(len(procs)):
        try:
            with open(pattern % rank, "rb") as fin:
                results.append(pickle.load(fin))
        except OSError:
            results.append(None)
    return results, logs


# -- the serving mesh's drives, shared by the test and its ranks ------------

HEADS, EMBED, BLOCKS, VOCAB = 8, 32, 2, 16
PS = 8

#: the slab's drive (test_mesh_serving.py:41-63) and the pool's
#: (test_paged.py:472-505): decoder kwargs and prompt lengths
DENSE = dict(slots=3, max_len=256, n_tokens=6, tile=8)
PAGED = dict(slots=2, max_len=64, n_tokens=5, paged=True, page_size=PS)
TIERS = {
    "dense": dict(DENSE),
    "dense-int8kv": dict(DENSE, quantize="int8-kv"),
    "paged": dict(PAGED),
    "paged-int8": dict(PAGED, quantize="int8"),
    "paged-int8kv": dict(PAGED, quantize="int8-kv"),
}


def _prompts(tier):
    """The drive's prompts: the pool's start page-aligned."""
    if TIERS[tier].get("paged"):
        rng = numpy.random.RandomState(7)
        return [rng.randint(0, VOCAB, n) for n in (2 * PS, 19, 5)]
    rng = numpy.random.RandomState(3)
    return [rng.randint(0, VOCAB, n) for n in (5, 9, 3, 7, 6, 11, 4)]


def drive(dec, prompts, paged):
    """The composite drive: staggered submissions joining mid-flight, the
    pipelined chunked drain; the pool then re-admits its page-aligned
    first prompt (a zero-prefill hit). The same on both packages."""
    pending = list(prompts)
    for _ in range(2 if paged else 3):
        dec.submit(pending.pop(0))
    dec.drain_pipelined(4, admit=lambda: pending
                        and dec.submit(pending.pop(0)))
    if paged:
        dec.submit(prompts[0])
        dec.run_until_drained()
    return {rid: list(map(int, toks)) for rid, toks in dec.results.items()}


def as_torch(tree):
    """A numpy parameter tree as CPU tensors."""
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_torch(v) for v in tree]
    return torch.from_numpy(numpy.array(tree))


def post(port, prompt, timeout=60):
    """POST ``prompt`` to a GenerateAPI on ``port``; its tokens."""
    import urllib.request
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps({"tokens": list(map(int, prompt))}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())["tokens"]
