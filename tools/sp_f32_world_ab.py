"""chip_smoke.py's phase 28 (e) alone, an earlier tree against this one in
one call: the f32 Ulysses step at a rank's (1, 8192, 4, 128) over seq=2 on
two ranks sharing the card (gloo), ``--steps`` steps a world, each step's
wall and its collectives by op (calls, operand bytes, seconds), and rank
0's one-process step before the world, in the order earlier, this, this,
earlier. The earlier tree is a directory holding another commit of the
repo (``git archive <commit> | tar -x -C DIR``). Run on the card from the
root of the repo::

    python -m tools.sp_f32_world_ab DIR [--steps 4] [--json PATH]
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one rank: argv tree, coordinator, rank, steps; prints "REPORT <json>"
RANK = r'''
import json, os, sys
tree, coordinator = sys.argv[1], sys.argv[2]
rank, steps = int(sys.argv[3]), int(sys.argv[4])
sys.path.insert(0, tree)
import torch
import chip_smoke as cs
from veles_tpu_torch.parallel.mesh import initialize_distributed, build_mesh
from veles_tpu_torch.parallel.collectives import collective_stats
from veles_tpu_torch.parallel.transformer_step import (
    build_transformer_train_step, shard_tokens)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
problems = cs.sp_problems(dev)
params32, x32, labels = problems["sp32"]
del problems
out = {"rank": rank, "tree": tree, "steps": []}
if rank == 0:
    step = build_transformer_train_step(cs.LONG_HEADS,
                                        learning_rate=cs.SP_LR)
    for _ in range(steps):
        (p, _), row = cs.sp_timed(dev, None,
                                  lambda: step(params32, x32, labels))
        out.setdefault("one", []).append(row["wall"])
        del p
initialize_distributed(coordinator, 2, rank, device="cuda", backend="gloo",
                       timeout=600)
mesh = build_mesh(data=1, seq=2)
xs, ls = shard_tokens([x32, labels], mesh)
step = build_transformer_train_step(cs.LONG_HEADS, mesh=mesh,
                                    learning_rate=cs.SP_LR)
zero = [0, 0, 0.0]
for _ in range(steps):
    before = {k: list(v) for k, v in collective_stats(mesh).items()}
    (p, (loss, n_err)), row = cs.sp_timed(dev, mesh,
                                          lambda: step(params32, xs, ls))
    row["by_op"] = {k: [v[0] - before.get(k, zero)[0],
                        v[1] - before.get(k, zero)[1],
                        round(v[2] - before.get(k, zero)[2], 4)]
                    for k, v in collective_stats(mesh).items()}
    row["loss"] = float(loss)
    out["steps"].append(row)
    del p
print("REPORT " + json.dumps(out), flush=True)
os._exit(0)
'''


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world(tree, steps):
    """Both ranks' reports of one world run from ``tree``."""
    coordinator = "127.0.0.1:%d" % free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, tree, coordinator, str(r), str(steps)],
        cwd=tree, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    reports = []
    try:
        for proc in procs:
            text = proc.communicate(timeout=600)[0]
            line = [ln for ln in text.splitlines()
                    if ln.startswith("REPORT ")]
            if not line:
                print(text[-3000:])
                raise SystemExit("a rank failed in %s" % tree)
            reports.append(json.loads(line[-1][len("REPORT "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return reports


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent", help="the earlier tree's directory")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--json", help="write every reading here")
    args = parser.parse_args(argv)
    parent = os.path.abspath(args.parent)
    t0 = time.time()
    builds = [subprocess.Popen(
        [sys.executable, "-c",
         "from veles_tpu_torch.ops import _build; _build.build()"],
        cwd=tree) for tree in (parent, HERE)]
    if any(b.wait() for b in builds):
        raise SystemExit("a build failed")
    print("built both trees in %.1f s" % (time.time() - t0), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    results = []
    for label, tree in (("earlier", parent), ("this", HERE),
                        ("this", HERE), ("earlier", parent)):
        t = time.time()
        reports = world(tree, args.steps)
        results.append({"label": label, "reports": reports})
        print("%s: one process %s s; world %s" % (
            label, ["%.4f" % w for w in reports[0].get("one", [])],
            "; ".join("rank %d %s" % (r["rank"], ", ".join(
                "%.3f of %.3f" % (s["collective_s"], s["wall"])
                for s in r["steps"])) for r in reports)), flush=True)
        for r in reports:
            for i, s in enumerate(r["steps"]):
                print("  %s rank %d step %d by op %s launches f32 %s/%s" % (
                    label, r["rank"], i, s["by_op"],
                    s["launches"].get("flash_attention_dkv_f32"),
                    s["launches"].get("flash_attention_dq_f32")),
                    flush=True)
        print("  %s world %.1f s" % (label, time.time() - t), flush=True)
    if args.json:
        with open(args.json, "w") as fout:
            json.dump(results, fout)


if __name__ == "__main__":
    main()
