"""The port's fleet x pod composition (veles_tpu_torch/fleet/pod.py, the
launcher's pod slave, ``models/standard.py``'s meshed slave tick) against
tests/test_fleet_pod.py and tests/test_fleet_chaos.py's
``TestInProgramReduceChaos``, on the CPU.

The JAX pod slave is one process over ``jax.devices()[:2]`` of the 8
virtual CPU devices (tests/conftest.py), run in this process. The port's
pod slave is a gloo world of 2 processes: each rank is a fresh
interpreter (:data:`RANK`) that joins the world on an ephemeral port
with a bounded timeout; rank 0 connects to the master and every other
rank follows its jobs. The masters run on threads in this process. Every
rank of a test is killed past :data:`DEADLINE` and the test then fails;
every master is stopped in a ``finally``.

The digits cases are tests/test_fleet_pod.py's ``_kw`` (layers (16, 10),
297 valid / 1500 train, minibatch 300, lr 0.5), the master's initial
weights the JAX master's (``convert.unit_params_from_jax``). The chaos
family is ``_control_kw`` (320 random rows of 8 features, layers (8, 2),
minibatch 64, lr 0.3, 3 epochs) at world 2 (JAX's is 8 devices), under
JAX's chaos profile and ``CHAOS_SEED``; its anchor is the standalone
two-rank world at the fleet's cadence (per minibatch: no sweep, no
pipeline), the port's counterpart of ``_run_standalone_pod``."""

import asyncio
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import numpy
import pytest
import torch

import jax
from veles_tpu.core import prng as jprng
from veles_tpu.launcher import Launcher as JLauncher
from veles_tpu.loader.base import VALID as JVALID
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu.parallel.mesh import build_mesh as jbuild_mesh
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.parity import read_digits

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds every rank and master thread of a test may take
DEADLINE = 90
#: the pod worlds' timeout (seconds): a follower whose rank 0 is gone
#: fails within it
WORLD_TIMEOUT = 30
#: tests/test_fleet_chaos.py's seed and profile
CHAOS_SEED = int(os.environ.get("VELES_TPU_CHAOS_SEED", "1"))
CHAOS = dict(enabled=True, seed=CHAOS_SEED, death=0.18,
             death_mode="disconnect", frame_drop=0.04, frame_delay=0.10,
             frame_delay_ms=5.0, duplicate_update=0.25, slow_job=0.25,
             slow_job_ms=20.0)
#: the port's standalone world against the JAX family, at level 0 (bf16
#: products) in both: the same roundings, f32 sums in another order (the
#: shards' gradients summed by gloo against JAX's psum); measured 9.2e-6
#: on the weights and 2.7e-7 on the biases after three epochs
CHAOS_ATOL = 1e-4

#: one rank of a pod: ``python -c RANK <config.json> <rank>``. A slave
#: rank joins the fleet at ``cfg["master"]``; a standalone rank runs the
#: same workflow at the fleet's cadence. Rank 0 alone takes the chaos
#: profile; with ``stop_after`` it stops its client once it has done that
#: many jobs (an abrupt close, as tests/test_fleet_pod.py's drop).
RANK = r'''
import json, pickle, sys, threading, time
import numpy, torch
torch.set_num_threads(1)
cfg = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.parallel.mesh import (build_mesh,
                                           finalize_distributed,
                                           initialize_distributed,
                                           mesh_coordinate_labels)
initialize_distributed(cfg["coordinator"], cfg["world"], rank,
                       device="cpu", timeout=cfg["timeout"])
for key, value in cfg["fleet"].items():
    setattr(root.common.fleet, key, value)
prng.get("default").seed(42)
prng.get("loader").seed(43)
data = numpy.load(cfg["data"], allow_pickle=True)
kw = dict(layers=tuple(cfg["layers"]),
          loader_kwargs=dict(data=data["x"], labels=data["y"],
                             class_lengths=cfg["lengths"],
                             minibatch_size=cfg["minibatch"],
                             normalization_type="linear"),
          learning_rate=cfg["lr"], max_epochs=cfg["epochs"])
mesh = build_mesh(data=cfg["world"])
if cfg["master"]:
    launcher = Launcher(master_address=cfg["master"],
                        chaos=cfg["chaos"] if rank == 0 else None)
else:
    launcher = Launcher()
    kw.update(fused_sweep=False, fused_pipeline=False)
wf = MLPWorkflow(launcher, name=cfg["name"], device="cpu", mesh=mesh, **kw)
if "weights" in data.files:
    unit_params_from_jax(wf, data["weights"].tolist())
launcher.initialize()
agent = launcher.agent
if rank == 0 and cfg["master"]:
    # one line a job rank 0 starts: it holds the job's lease until its
    # update, so a test that kills it on these lines kills it holding one
    do_job = wf.do_job
    def marked(data, callback=None):
        with open(cfg["out"] % rank + ".started", "a") as fout:
            fout.write("job\n")
        return do_job(data, callback)
    wf.do_job = marked
if cfg["stop_after"] and rank == 0:
    def stopper():
        while agent.jobs_done < cfg["stop_after"]:
            time.sleep(0.005)
        agent.stop()
    threading.Thread(target=stopper, daemon=True).start()
out = {"rank": rank, "fused": wf.fused_tick is not None
       and wf.fused_tick.mesh is mesh}
try:
    launcher.run()
finally:
    out["jobs"] = getattr(agent, "jobs_done", None)
    out["ticks"] = wf.fused_tick.ticks if wf.fused_tick else 0
    out["weights"] = [(f.weights.data.numpy().copy(),
                       f.bias.data.numpy().copy()) for f in wf.forwards]
    out["best"] = list(wf.decision.best_n_err)
    out["kind"] = type(agent).__name__
    out["chaos"] = dict(getattr(getattr(agent, "chaos", None), "counters",
                                None) or {})
    out["rollbacks"] = getattr(agent, "rollbacks", None)
    out["failure"] = repr(getattr(agent, "failure", None))
    out["coords"] = mesh_coordinate_labels()
    stats = getattr(agent, "stats", None)
    if stats is None and getattr(agent, "pod", None) is not None:
        stats = agent.pod.stats
    out["stats"] = stats
    with open(cfg["out"] % rank, "wb") as fout:
        pickle.dump(out, fout)
    launcher.stop()
finalize_distributed()
'''


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _digits():
    x, y = read_digits()
    return x.astype(numpy.float32), y.astype(numpy.int32)


def _kw(max_epochs=4, minibatch=300, device="cpu"):
    x, y = _digits()
    kw = dict(layers=(16, 10),
              loader_kwargs=dict(data=x, labels=y,
                                 class_lengths=[0, 297, 1500],
                                 minibatch_size=minibatch,
                                 normalization_type="linear"),
              learning_rate=0.5, max_epochs=max_epochs)
    if device is not None:
        kw["device"] = device
    return kw


def _control_kw(max_epochs=3, device="cpu"):
    rng = numpy.random.RandomState(0)
    data = rng.rand(320, 8).astype(numpy.float32)
    labels = (data[:, 0] > 0.5).astype(numpy.int32)
    kw = dict(layers=(8, 2),
              loader_kwargs=dict(data=data, labels=labels,
                                 class_lengths=[0, 64, 256],
                                 minibatch_size=64,
                                 normalization_type="linear"),
              learning_rate=0.3, max_epochs=max_epochs)
    if device is not None:
        kw["device"] = device
    return kw


def _seed(package=prng):
    package.get("default").seed(42)
    package.get("loader").seed(43)


def _initial_weights(wf):
    return [{"weights": numpy.asarray(f.weights.mem).copy(),
             "bias": numpy.asarray(f.bias.mem).copy()}
            for f in wf.forwards]


class Pod:
    """A world of :data:`RANK` processes on ``kw``'s data and layers: a
    pod slave of the master at ``master`` (``"HOST:PORT"``), or with
    ``master=None`` the standalone world at the fleet's cadence."""

    def __init__(self, tmp_path, tag, kw, master=None, weights=None,
                 fleet=None, chaos=None, stop_after=0, world=2):
        directory = tmp_path / tag
        directory.mkdir()
        arrays = {"x": kw["loader_kwargs"]["data"],
                  "y": kw["loader_kwargs"]["labels"]}
        if weights is not None:
            arrays["weights"] = numpy.array(weights, dtype=object)
        data = str(directory / "data.npz")
        numpy.savez(data, **arrays)
        loader = kw["loader_kwargs"]
        cfg = {"coordinator": "127.0.0.1:%d" % free_port(), "world": world,
               "timeout": WORLD_TIMEOUT, "master": master, "name": tag,
               "data": data, "layers": list(kw["layers"]),
               "lengths": list(loader["class_lengths"]),
               "minibatch": loader["minibatch_size"],
               "lr": kw["learning_rate"], "epochs": kw["max_epochs"],
               "fleet": dict(fleet or {}), "chaos": chaos,
               "stop_after": stop_after,
               "out": str(directory / "rank%d.pickle")}
        path = str(directory / "config.json")
        with open(path, "w") as fout:
            json.dump(cfg, fout)
        self.out = cfg["out"]
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", RANK, path, str(rank)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]
        self.logs = [None] * world

    def wait(self, deadline):
        """Wait for every rank until ``deadline`` (a monotonic time); kill
        them all past it and fail."""
        try:
            for rank, proc in enumerate(self.procs):
                self.logs[rank] = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))[0]
        except subprocess.TimeoutExpired:
            pytest.fail("a pod's ranks passed the %d s deadline" % DEADLINE)
        finally:
            self.kill()
        return [proc.returncode for proc in self.procs]

    def started(self):
        """The jobs rank 0 has started."""
        try:
            with open(self.out % 0 + ".started") as fin:
                return len(fin.readlines())
        except OSError:
            return 0

    def kill(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def records(self):
        """Each rank's record; every rank must have exited 0."""
        for rank, (proc, log) in enumerate(zip(self.procs, self.logs)):
            assert proc.returncode == 0, "rank %d:\n%s" % (rank,
                                                          log[-3000:])
        out = []
        for rank in range(len(self.procs)):
            with open(self.out % rank, "rb") as fin:
                out.append(pickle.load(fin))
        return out


class Master:
    """A port master on 127.0.0.1 on a thread, its initial weights given,
    serving no job before ``hold_for`` slaves are connected (a pod's ranks
    start in seconds, a digits run ends in less: without the hold the
    first slave would drain the stream alone). With ``stagger``, the
    first slave served runs alone until the master has taken ``stagger``
    updates, then waits until every other slave has answered two jobs
    (tests/test_fleet_pod.py holds its second slave back until the first
    has done a job). ``join`` waits for it within the deadline."""

    def __init__(self, kw, weights=None, name="fleet-t", hold_for=1,
                 stagger=0):
        _seed()
        self.launcher = Launcher(listen_address="127.0.0.1:0")
        self.wf = MLPWorkflow(self.launcher, name=name, **kw)
        if weights is not None:
            unit_params_from_jax(self.wf, weights)
        self.launcher.initialize()
        agent = self.launcher.agent
        serve, released, seen = agent._serve_job, [], []

        def waiting(slave):
            if not stagger or agent._stopped.is_set():
                return False
            done = agent.ledger.snapshot()["done"]
            if slave.id != seen[0]:
                return seen[0] in agent.slaves and done < stagger
            return done >= stagger and any(
                getattr(agent.slaves.get(sid), "jobs_done", 2) < 2
                for sid in seen[1:])

        async def held(slave, writer):
            while not released and len(agent.slaves) < hold_for \
                    and not agent._stopped.is_set():
                await asyncio.sleep(0.01)
            released.append(True)
            if slave.id not in seen:
                seen.append(slave.id)
            while waiting(slave):
                await asyncio.sleep(0.005)
            await serve(slave, writer)
        agent._serve_job = held
        self.address = "127.0.0.1:%d" % agent.port
        self.thread = threading.Thread(target=self.launcher.run,
                                       daemon=True)
        self.thread.start()

    def join(self, deadline):
        self.thread.join(max(deadline - time.monotonic(), 0.1))
        assert not self.thread.is_alive(), "the master did not finish"

    @property
    def best(self):
        return self.wf.decision.best_n_err[VALID]

    def weights(self):
        return [(f.weights.data.numpy(), f.bias.data.numpy())
                for f in self.wf.forwards]


@pytest.fixture
def masters():
    made = []

    def make(*args, **kwargs):
        made.append(Master(*args, **kwargs))
        return made[-1]
    yield make
    for master in made:
        master.launcher.stop()


@pytest.fixture
def pods():
    made = []

    def make(*args, **kwargs):
        made.append(Pod(*args, **kwargs))
        return made[-1]
    yield make
    for pod in made:
        pod.kill()


def _jax_master(kw, name="fleet-t"):
    _seed(jprng)
    master = JLauncher(listen_address="127.0.0.1:0")
    wf = JMLPWorkflow(master, name=name, **kw)
    master.initialize()
    thread = threading.Thread(target=master.run, daemon=True)
    thread.start()
    return master, wf, thread


@pytest.fixture(scope="module")
def jax_pod():
    """tests/test_fleet_pod.py's first case on the JAX side: a master and
    one pod slave over ``jax.devices()[:2]``, 2 epochs; the master's
    initial weights and best validation n_err."""
    kw = _kw(max_epochs=2, device=None)
    master, wf, thread = _jax_master(kw)
    weights = _initial_weights(wf)
    _seed(jprng)
    slave = JLauncher(master_address="127.0.0.1:%d" % master.agent.port)
    swf = JMLPWorkflow(slave, name="fleet-t",
                       mesh=jbuild_mesh(devices=jax.devices()[:2], data=2),
                       **kw)
    slave.initialize()
    try:
        assert swf.fused_tick is not None \
            and swf.fused_tick.mesh.shape["data"] == 2
        slave.run()
        thread.join(DEADLINE)
        assert not thread.is_alive(), "the JAX master did not finish"
        return {"weights": weights, "best": wf.decision.best_n_err[JVALID]}
    finally:
        master.stop()
        slave.stop()


def test_pod_slave_matches_graph_slave_and_the_jax_pod(tmp_path, masters,
                                                        pods, jax_pod):
    """From the JAX master's weights: the port's pod slave (two ranks)
    reaches the best validation n_err of the port's per-unit graph slave
    and of the JAX pod slave; its follower did every job rank 0 did and
    rank 0 handed each on."""
    weights = jax_pod["weights"]
    deadline = time.monotonic() + DEADLINE
    graph = masters(_kw(max_epochs=2), weights)
    _seed()
    slave = Launcher(master_address=graph.address)
    try:
        swf = MLPWorkflow(slave, name="fleet-t", fused=False,
                          **_kw(max_epochs=2))
        slave.initialize()
        assert swf.fused_tick is None
        slave.run()
    finally:
        slave.stop()
    graph.join(deadline)
    master = masters(_kw(max_epochs=2), weights)
    pod = pods(tmp_path, "fleet-t", _kw(max_epochs=2), master.address)
    pod.wait(deadline)
    master.join(deadline)
    leader, follower = pod.records()
    assert leader["fused"] and follower["fused"]
    assert leader["kind"] == "Client" and follower["kind"] == "Follower"
    assert leader["jobs"] == follower["jobs"] == 12
    assert leader["ticks"] == follower["ticks"] == 12
    assert leader["stats"]["events"] == {"job": 12, "end": 1}
    # the labels rank 0 merges into the metric rows it piggybacks
    assert leader["coords"] == {"process": "0", "mesh": "data2"}
    assert master.best == graph.best == jax_pod["best"]


def test_two_pod_slaves_converge(tmp_path, masters, pods, jax_pod):
    """Two pod slaves of two ranks each (the full fleet x pod
    composition) from the JAX master's weights, the start pinned as
    tests/test_fleet_pod.py pins it: the master's first job held until
    both are connected, the first slave alone for one epoch (6 jobs),
    then held until the second has answered two (an even interleaving
    from the first job loses every other update to the overwrite merge
    and read 42 once in 6 runs under load): both take jobs, every rank
    ticks, the best n_err is within the JAX test's bound of 40."""
    deadline = time.monotonic() + DEADLINE
    master = masters(_kw(max_epochs=8), jax_pod["weights"], hold_for=2,
                     stagger=6)
    first = pods(tmp_path, "s1", _kw(max_epochs=8), master.address)
    second = pods(tmp_path, "s2", _kw(max_epochs=8), master.address)
    first.wait(deadline)
    second.wait(deadline)
    master.join(deadline)
    records = first.records() + second.records()
    assert all(r["jobs"] and r["ticks"] == r["jobs"] for r in records)
    assert master.best is not None and master.best <= 40, master.best


def test_pod_slave_drop_requeues(tmp_path, masters, pods):
    """A pod slave whose rank 0 stops its client mid-run (an abrupt close,
    tests/test_fleet_pod.py's drop): the master drops it and finishes on
    the other pod slave; the dropped pod's follower ends with rank 0's
    end event and exits 0, having done the jobs rank 0 did."""
    deadline = time.monotonic() + DEADLINE
    master = masters(_kw(max_epochs=3), hold_for=2)
    survivor = pods(tmp_path, "s1", _kw(max_epochs=3), master.address)
    dropped = pods(tmp_path, "s2", _kw(max_epochs=3), master.address,
                   stop_after=2)
    dropped.wait(deadline)
    survivor.wait(deadline)
    master.join(deadline)
    leader, follower = dropped.records()
    assert leader["jobs"] == follower["jobs"] >= 2
    assert leader["stats"]["events"]["end"] == 1
    assert follower["kind"] == "Follower" and follower["failure"] == "None"
    assert all(r["jobs"] for r in survivor.records())
    assert master.best is not None
    snap = master.launcher.agent.ledger.snapshot()
    assert snap["outstanding"] == 0
    assert snap["issued"] == snap["done"] + snap["requeued"]


def test_a_killed_pod_rank0_fails_its_follower(tmp_path, masters, pods):
    """SIGKILL a pod slave's rank 0 once it has started its third job, so
    that it holds the job's lease (each job stretched by the chaos
    slow-job fault): the master requeues the lease and finishes on a
    single-rank slave; the follower's world is lost, so it exits
    non-zero, well inside the world's timeout."""
    deadline = time.monotonic() + DEADLINE
    master = masters(_kw(max_epochs=3))
    pod = pods(tmp_path, "s1", _kw(max_epochs=3), master.address,
               chaos={"enabled": True, "seed": 23, "slow_job": 1.0,
                      "slow_job_ms": 200.0})
    ledger = master.launcher.agent.ledger
    while pod.started() < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert pod.started() >= 3, "the pod never started a third job"
    killed_at = time.monotonic()
    pod.procs[0].send_signal(signal.SIGKILL)
    pod.procs[1].wait(timeout=WORLD_TIMEOUT + 5)
    follower_s = time.monotonic() - killed_at
    _seed()
    slave = Launcher(master_address=master.address)
    try:
        MLPWorkflow(slave, name="fleet-t", **_kw(max_epochs=3))
        slave.initialize()
        runner = threading.Thread(target=slave.run, daemon=True)
        runner.start()
        master.join(deadline)
        runner.join(max(deadline - time.monotonic(), 0.1))
    finally:
        slave.stop()
    codes = pod.wait(deadline)
    assert codes[0] == -signal.SIGKILL
    assert codes[1] not in (0, None), pod.logs[1][-3000:]
    assert "the pod follower stopped" in pod.logs[1]
    assert follower_s < WORLD_TIMEOUT
    snap = ledger.snapshot()
    assert snap["requeued_dropped"] >= 1 and snap["outstanding"] == 0
    assert slave.agent.jobs_done > 0 and master.best is not None


def test_a_pod_slave_the_meshed_tick_declines(tmp_path, masters, pods):
    """A minibatch the data axis does not divide (299 over 2 ranks): as
    the JAX package does, the slave warns and runs the per-unit graph on
    one device, rank 0's; rank 1 is released at once and exits 0; the
    run still trains."""
    deadline = time.monotonic() + DEADLINE
    master = masters(_kw(max_epochs=2, minibatch=299))
    pod = pods(tmp_path, "graph", _kw(max_epochs=2, minibatch=299),
               master.address)
    pod.wait(deadline)
    master.join(deadline)
    leader, released = pod.records()
    assert leader["kind"] == "Client" and not leader["fused"]
    assert leader["jobs"] == 14 and leader["ticks"] == 0  # 2 x (1 + 6)
    assert released["kind"] == "NoneType" and released["jobs"] is None
    # an untrained model sits near 267 of 297
    assert master.best is not None and master.best < 250


def test_pod_slave_on_safe_codec(tmp_path, masters, pods, monkeypatch):
    """The pod slave behind the pickle-free wire (``codec = "safe"`` on
    every host): its jobs and updates survive the safe codec and the
    run converges."""
    monkeypatch.setattr(root.common.fleet, "codec", "safe", raising=False)
    deadline = time.monotonic() + DEADLINE
    master = masters(_kw(max_epochs=2))
    pod = pods(tmp_path, "safe", _kw(max_epochs=2), master.address,
               fleet={"codec": "safe"})
    pod.wait(deadline)
    master.join(deadline)
    leader, follower = pod.records()
    assert leader["ticks"] > 0 and follower["ticks"] == leader["ticks"]
    assert master.best is not None and master.best < 150


# -- the in-program reduce under chaos (TestInProgramReduceChaos) -------------


@pytest.fixture(scope="module")
def chaos_anchor(tmp_path_factory):
    """The JAX family's standalone pod on ``jax.devices()[:2]`` (its
    ``_run_standalone_pod`` at data=2) and the port's standalone
    two-rank world at the fleet's cadence, from the JAX run's initial
    weights."""
    kw = _control_kw(device=None)
    _seed(jprng)
    launcher = JLauncher()
    wf = JMLPWorkflow(launcher, name="mr-chaos",
                      mesh=jbuild_mesh(devices=jax.devices()[:2], data=2),
                      fused_sweep=False, fused_pipeline=False, **kw)
    launcher.initialize()
    weights = _initial_weights(wf)
    launcher.run()
    jax_weights = [(numpy.asarray(f.weights.mem), numpy.asarray(f.bias.mem))
                   for f in wf.forwards]
    jax_best = wf.decision.best_n_err[JVALID]
    launcher.stop()
    pod = Pod(tmp_path_factory.mktemp("anchor"), "mr-chaos", _control_kw(),
              weights=weights)
    try:
        pod.wait(time.monotonic() + DEADLINE)
        ranks = pod.records()
    finally:
        pod.kill()
    return {"weights": weights, "jax_weights": jax_weights,
            "jax_best": jax_best, "ranks": ranks}


def test_standalone_pod_world_matches_the_jax_family(chaos_anchor):
    """The anchor itself: both ranks bit-equal, on the JAX family's best
    validation n_err, the weights within :data:`CHAOS_ATOL` of its."""
    first, second = chaos_anchor["ranks"]
    assert first["fused"] and second["fused"]
    for (w0, b0), (w1, b1) in zip(first["weights"], second["weights"]):
        numpy.testing.assert_array_equal(w0, w1)
        numpy.testing.assert_array_equal(b0, b1)
    assert first["best"][VALID] == chaos_anchor["jax_best"]
    for (w, b), (jw, jb) in zip(first["weights"],
                                chaos_anchor["jax_weights"]):
        numpy.testing.assert_allclose(w, jw, atol=CHAOS_ATOL, rtol=0)
        numpy.testing.assert_allclose(b, jb, atol=CHAOS_ATOL, rtol=0)


@pytest.mark.parametrize("chaos", [None, CHAOS], ids=["clean", "chaos"])
def test_control_plane_pod_is_bit_equal_to_the_standalone_world(
        tmp_path, masters, pods, monkeypatch, chaos_anchor, chaos):
    """A control-plane master and one pod slave of two ranks, fault-free
    and under the JAX family's chaos profile on rank 0 (deaths mid-step,
    dropped and delayed frames, duplicate replays, stragglers): the
    master's weights and both ranks' are bit-equal to the standalone
    world's, on its best n_err; every epoch fence synced the master; under
    chaos the deaths, duplicates, requeues and rollbacks each fired at
    least once, and every rollback reached the follower."""
    monkeypatch.setattr(root.common.fleet, "plane", "control",
                        raising=False)
    deadline = time.monotonic() + DEADLINE
    master = masters(_control_kw(), chaos_anchor["weights"],
                     name="mr-chaos")
    pod = pods(tmp_path, "mr-chaos", _control_kw(), master.address,
               fleet={"plane": "control"}, chaos=chaos)
    pod.wait(deadline)
    master.join(deadline)
    status = master.launcher.agent.fleet_status()
    leader, follower = pod.records()
    reference = chaos_anchor["ranks"][0]
    assert status["plane"] == "control"
    assert master.best == reference["best"][VALID]
    for got in (master.weights(), leader["weights"], follower["weights"]):
        for (w, b), (rw, rb) in zip(got, reference["weights"]):
            numpy.testing.assert_array_equal(w, rw)
            numpy.testing.assert_array_equal(b, rb)
    assert status.get("payload_rejects", 0) == 0
    events = leader["stats"]["events"]
    assert events["fence"] == status["sync"]["applied"] >= 3
    assert events.get("rollback", 0) == leader["rollbacks"]
    if chaos is None:
        assert status["sync"]["applied"] == 3
        assert status["ledger"]["fenced_total"] == 0
        return
    counters = leader["chaos"]
    assert counters["deaths"] >= 1, counters
    assert counters["updates_duplicated"] >= 1, counters
    assert status["ledger"]["requeued"] >= 1, status["ledger"]
    assert status["ledger"]["fenced"]["duplicate"] >= 1, status["ledger"]
    assert leader["rollbacks"] >= 1


def test_a_follower_that_drifted_fails_at_the_fence():
    """A fence event carries the digest of the weights rank 0 ships; a
    follower whose own fence payload digests otherwise has drifted and
    fails rather than train on."""
    from veles_tpu_torch.fleet import pod

    weights = [{"weights": numpy.arange(6, dtype=numpy.float32)}, None]
    workflow = types.SimpleNamespace(take_fence_sync=lambda: weights)
    follower = pod.Follower(workflow)
    follower._apply(pod.FENCE, pod.digest(weights))
    drifted = [{"weights": numpy.arange(6, dtype=numpy.float32) + 1e-7},
               None]
    with pytest.raises(RuntimeError, match="drifted apart"):
        follower._apply(pod.FENCE, pod.digest(drifted))
