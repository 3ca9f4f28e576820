"""The port's fleet through its command line (``python -m veles_tpu_torch
-l/-m/-n``) against the contracts of tests/test_cli_fleet.py, on the CPU
(``--device cpu``).

The master and its slaves are real processes: a CLI slave serves jobs
until the MASTER is done, and ``-n localhost`` makes the master spawn its
own slave. Every process has a deadline that kills it; a slave starts
only once its master's log says it listens, and gives up reconnecting
after one attempt, so none outlives its master for long. The
master-to-slave argv transform of ``--nodes`` gives the JAX package's
command for every edge form."""

import json
import os
import socket
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from veles_tpu.launcher import Launcher as JLauncher
from veles_tpu_torch.launcher import Launcher, slave_argv

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: every process of a test runs within this many seconds, or is killed
DEADLINE = 90

WF = """
import numpy
from veles_tpu_torch.models.mlp import MLPWorkflow

def run(load, main):
    rng = numpy.random.RandomState(0)
    X = rng.rand(300, 8).astype(numpy.float32)
    y = (X[:, 0] > 0.5).astype(numpy.int32)
    load(MLPWorkflow, layers=(8, 2),
         loader_kwargs=dict(data=X, labels=y, class_lengths=[0, 60, 240],
                            minibatch_size=60),
         learning_rate=0.3, max_epochs=2)
    main()
"""


def _env():
    env = dict(os.environ)
    env["VELES_TPU_FLEET_SECRET"] = "cli-test"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _free_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _argv(wf_file, *flags):
    return [sys.executable, "-m", "veles_tpu_torch", str(wf_file), "-",
            "root.common.fleet.max_reconnect_attempts=1",
            "--device", "cpu"] + list(flags)


def _start(argv, log):
    """A process of ``argv`` with its output in the file ``log``."""
    with open(log, "w") as out:
        return subprocess.Popen(argv, env=_env(), stdout=out,
                                stderr=subprocess.STDOUT)


def _wait_listening(master, log, deadline):
    """Wait until the master's log says it listens ("master listening
    on HOST:PORT", written once its socket is bound), it has exited, or
    ``deadline`` has passed: its slaves connect only then, within their
    reconnect budget of one attempt."""
    while time.monotonic() < deadline and master.poll() is None \
            and "master listening on" not in log.read_text():
        time.sleep(0.05)


def _wait_all(procs, deadline):
    try:
        return [proc.wait(timeout=max(deadline - time.monotonic(), 1))
                for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture
def wf_file(tmp_path):
    path = tmp_path / "wf.py"
    path.write_text(WF)
    return path


def test_cli_master_slave_roundtrip(tmp_path, wf_file):
    """A CLI slave serves jobs until the master is done; both exit 0 and
    the master writes the results."""
    result_file = tmp_path / "res.json"
    port = _free_port()
    deadline = time.monotonic() + DEADLINE
    log = tmp_path / "master.log"
    master = _start(_argv(wf_file, "-l", "127.0.0.1:%d" % port,
                          "--result-file", str(result_file)), log)
    _wait_listening(master, log, deadline)
    slave = _start(_argv(wf_file, "-m", "127.0.0.1:%d" % port),
                   tmp_path / "slave.log")
    assert _wait_all([master, slave], deadline) == [0, 0]
    results = json.loads(result_file.read_text())
    assert results["epochs"] == 2
    assert results["best_validation_errors"] is not None


def test_cli_nodes_spawns_local_slave(tmp_path, wf_file):
    """``-n localhost``: the master spawns its own slave (a detached local
    process running ``python -m veles_tpu_torch``) and training ends
    without any manual slave."""
    result_file = tmp_path / "res.json"
    deadline = time.monotonic() + DEADLINE
    master = subprocess.Popen(
        _argv(wf_file, "-l", "127.0.0.1:%d" % _free_port(), "-n",
              "localhost", "--result-file", str(result_file)),
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        cwd=str(tmp_path))
    assert _wait_all([master], deadline) == [0]
    assert json.loads(result_file.read_text())["epochs"] == 2


#: master argvs in every edge form -l/-n/--result-file/-b can take
EDGE_FORMS = {
    "equals": ["--listen=0.0.0.0:5050", "--nodes=host1",
               "--result-file=r.json"],
    "space": ["-l", "0.0.0.0:5050", "-n", "host1", "--result-file",
              "r.json"],
    "fused": ["-l127.0.0.1:1", "-nhost1"],
    "long-space": ["--listen", "127.0.0.1:1", "--nodes", "h1,h2"],
    "background": ["-l", "127.0.0.1:1", "-b", "--background"],
    "kept": ["-l", "127.0.0.1:1", "--respawn", "--chaos-death", "0.1",
             "--fleet-plane", "control", "root.a.b=1"],
}


def _spawned_command(launcher_cls, module, argv):
    """The command ``_launch_nodes`` spawns for ``argv``."""
    lau = launcher_cls(listen_address="127.0.0.1:0", nodes=["localhost"])
    lau.agent = mock.Mock(host="127.0.0.1", port=5050)
    lau.agent.secret_spawn_env.return_value = {}
    with mock.patch(module + ".fleet.respawn.respawn_recipe") as recipe, \
            mock.patch(module + ".fleet.respawn.default_spawner") as spawn:
        recipe.return_value = {"executable": "/usr/bin/python3",
                               "argv": ["-m", "pkg", "wf.py"] + argv,
                               "cwd": "/tmp", "pythonpath": ""}
        lau._launch_nodes()
    ((host, command), kwargs), = spawn.call_args_list
    assert host == "localhost" and kwargs["cwd"] == "/tmp"
    return command


@pytest.mark.parametrize("form", sorted(EDGE_FORMS))
def test_nodes_argv_transform_matches_jax(form):
    """The master's argv becomes the slave's as the JAX launcher makes it:
    no surviving --listen (the slave would be a second master), no
    --nodes, no --result-file, no -b; --respawn and the rest kept."""
    argv = EDGE_FORMS[form]
    mine = _spawned_command(Launcher, "veles_tpu_torch", argv)
    assert mine == _spawned_command(JLauncher, "veles_tpu", argv)
    assert mine.endswith("-m 127.0.0.1:5050")
    for gone in ("--listen", "--nodes", "--result-file", "-l127",
                 "-nhost", " -b", "--background", "host1"):
        assert gone not in mine
    assert slave_argv(["wf.py"] + argv, "m:1")[-2:] == ["-m", "m:1"]
    if form == "kept":
        assert "--respawn" in mine and "--chaos-death 0.1" in mine


@pytest.mark.parametrize("plane", ["data", "control"])
def test_cli_pod_slave(tmp_path, wf_file, plane):
    """A pod slave from the command line: ``-m HOST:PORT --mesh data=2
    --coordinator H:P --num-processes 2 --process-id i``, one process a
    rank. Rank 0 connects, rank 1 follows its jobs; every process exits
    0 and the master writes the results. The master's ``--mesh`` is
    ignored with the JAX package's warning."""
    result_file = tmp_path / "res.json"
    port, coordinator = _free_port(), "127.0.0.1:%d" % _free_port()
    flags = ["--fleet-plane", plane, "--mesh", "data=2"]
    logs = [tmp_path / ("%s.log" % name)
            for name in ("master", "rank0", "rank1")]
    argvs = [_argv(wf_file, "-l", "127.0.0.1:%d" % port, "--result-file",
                   str(result_file), *flags)]
    argvs += [_argv(wf_file, "-m", "127.0.0.1:%d" % port, *flags,
                    "--coordinator", coordinator, "--num-processes", "2",
                    "--process-id", str(rank)) for rank in range(2)]
    deadline = time.monotonic() + DEADLINE
    procs = [_start(argvs[0], logs[0])]
    _wait_listening(procs[0], logs[0], deadline)
    procs += [_start(argv, log) for argv, log in zip(argvs[1:], logs[1:])]
    assert _wait_all(procs, deadline) == [0, 0, 0], [log.read_text()[-2000:]
                                                     for log in logs]
    results = json.loads(result_file.read_text())
    assert results["epochs"] == 2
    master, rank0, rank1 = (log.read_text() for log in logs)
    assert "the mesh is ignored here; configure it on the slaves" in master
    assert "connected as slave-1" in rank0 and "pod follower" not in rank0
    assert "pod follower, rank 1 of 2" in rank1
    assert "rank 0 ended the job stream after" in rank1
    assert "over local mesh Mesh(pipe=1, data=2" in rank0 + rank1
