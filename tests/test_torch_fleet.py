"""The port's training fleet (veles_tpu_torch/fleet/server.py, client.py,
launcher.py's master and slave modes, the units' fleet payloads and the
slave's fused tick) against the contracts of tests/test_fleet.py's
TestLoopback, TestRespawn and TestChecksum, on the CPU.

A master and its slaves run in this process over loopback, each started
on its own thread and joined with a deadline; every launcher is stopped
in a ``finally``. The data is the digits set (the committed copy,
``veles_tpu_torch/data/digits.csv.gz``, in scikit-learn's order), the
JAX fleet tests' configuration (``_kw``): layers (16, 10), 297 valid /
1500 train, minibatch 300, lr 0.5. The JAX package's fleet runs once
(module fixture) and hands its master's initial weights to the port
(``convert.unit_params_from_jax``): one sync slave must then land on the
JAX fleet's per-epoch n_err exactly, as the port's standalone run does
from the same weights."""

import threading
import time
import types

import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.launcher import Launcher as JLauncher
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.nn.gd import GradientDescent
from veles_tpu_torch.parity import read_digits

torch.set_num_threads(1)

#: every thread joined within this many seconds, or the test fails
DEADLINE = 60


def _kw(max_epochs=2, minibatch=300, device="cpu"):
    x, y = read_digits()
    kw = dict(layers=(16, 10),
              loader_kwargs=dict(data=x.astype(numpy.float32),
                                 labels=y.astype(numpy.int32),
                                 class_lengths=[0, 297, 1500],
                                 minibatch_size=minibatch,
                                 normalization_type="linear"),
              learning_rate=0.5, max_epochs=max_epochs)
    if device is not None:
        kw["device"] = device
    return kw


def _seed(package=prng):
    package.get("default").seed(42)
    package.get("loader").seed(43)


def _record_epochs(wf):
    """The workflow's per-epoch validation n_err, in order."""
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append(int(stats[VALID][0]))
        summary(stats, epoch)

    wf.decision._epoch_summary = recorded
    return seen


class Fleet:
    """A port master on 127.0.0.1 and its slaves, run on threads; stop()
    stops them all."""

    def __init__(self, kw, weights=None, master_kw=None):
        _seed()
        self.master = Launcher(listen_address="127.0.0.1:0",
                               **(master_kw or {}))
        self.wf = MLPWorkflow(self.master, name="fleet-t", **kw)
        if weights is not None:
            unit_params_from_jax(self.wf, weights)
        self.epochs = _record_epochs(self.wf)
        self.slaves = []
        self.threads = []
        self.master.initialize()
        self._start(self.master.run)

    def _start(self, target):
        thread = threading.Thread(target=target, daemon=True)
        thread.start()
        self.threads.append(thread)

    def slave(self, kw, weights=None, start=True, **slave_kw):
        _seed()
        slave = Launcher(master_address="127.0.0.1:%d"
                         % self.master.agent.port, **slave_kw)
        wf = MLPWorkflow(slave, name="fleet-t", **kw)
        if weights is not None:
            unit_params_from_jax(wf, weights)
        slave.initialize()
        self.slaves.append(slave)
        if start:
            self._start(slave.run)
        return slave

    def join(self):
        deadline = time.monotonic() + DEADLINE
        for thread in self.threads:
            thread.join(max(deadline - time.monotonic(), 0.1))
        assert not any(t.is_alive() for t in self.threads), \
            "the fleet did not finish within %d s" % DEADLINE

    def stop(self):
        for launcher in [self.master] + self.slaves:
            launcher.stop()


@pytest.fixture
def fleet():
    fleets = []

    def make(*args, **kwargs):
        fleets.append(Fleet(*args, **kwargs))
        return fleets[-1]
    yield make
    for made in fleets:
        made.stop()


@pytest.fixture(scope="module")
def jax_fleet():
    """The JAX package's master with one sync slave (tests/test_fleet.py
    ``test_sync_training_and_parity``): its master's initial weights, its
    per-epoch validation n_err and best n_err, the slave's job count."""
    kw = _kw(device=None)
    _seed(jprng)
    master = JLauncher(listen_address="127.0.0.1:0")
    wf = JMLPWorkflow(master, name="fleet-t", **kw)
    epochs = _record_epochs(wf)
    master.initialize()
    weights = [{"weights": numpy.asarray(f.weights.mem),
                "bias": numpy.asarray(f.bias.mem)} for f in wf.forwards]
    thread = threading.Thread(target=master.run, daemon=True)
    thread.start()
    _seed(jprng)
    slave = JLauncher(master_address="127.0.0.1:%d" % master.agent.port)
    JMLPWorkflow(slave, name="fleet-t", **kw)
    slave.initialize()
    try:
        runner = threading.Thread(target=slave.run, daemon=True)
        runner.start()
        runner.join(DEADLINE)
        thread.join(DEADLINE)
        assert not thread.is_alive() and not runner.is_alive()
        return {"weights": weights, "epochs": epochs,
                "best": wf.decision.best_n_err[VALID],
                "jobs": slave.agent.jobs_done}
    finally:
        master.stop()
        slave.stop()


def test_sync_slave_matches_standalone_and_the_jax_fleet(fleet, jax_fleet):
    """One port master and one sync slave from the JAX fleet's initial
    weights: the JAX fleet's per-epoch and best validation n_err, the
    port's standalone run's from the same weights, 12 jobs (2 epochs x
    (1 valid + 5 train)), and the slave's tick is the fused tick."""
    weights = jax_fleet["weights"]
    _seed()
    standalone = MLPWorkflow(DummyLauncher(), name="fleet-t", **_kw())
    unit_params_from_jax(standalone, weights)
    alone = _record_epochs(standalone)
    standalone.initialize()
    standalone.run()
    run = fleet(_kw(), weights)
    slave = run.slave(_kw())
    run.join()
    assert run.epochs == jax_fleet["epochs"] == alone
    assert run.wf.decision.best_n_err[VALID] == jax_fleet["best"] \
        == standalone.decision.best_n_err[VALID]
    assert slave.agent.jobs_done == jax_fleet["jobs"] == 12
    assert slave.workflow.fused_tick is not None
    for fwd, ref in zip(run.wf.forwards, standalone.forwards):
        numpy.testing.assert_allclose(fwd.weights.data.numpy(),
                                      ref.weights.data.numpy(),
                                      atol=1e-6, rtol=0)
    snap = run.master.agent.ledger.snapshot()
    assert snap["issued"] == snap["done"] == 12
    assert snap["outstanding"] == 0 and snap["fenced_total"] == 0


def test_two_slaves_share_the_epoch(fleet):
    run = fleet(_kw())
    first = run.slave(_kw())
    second = run.slave(_kw())
    run.join()
    jobs = first.agent.jobs_done, second.agent.jobs_done
    # the stream is asynchronous: a next-epoch job may go out before the
    # stop decision lands, so the total may pass 12
    assert sum(jobs) >= 12 and all(jobs), jobs
    assert run.wf.decision.best_n_err[VALID] is not None


def test_async_slave_mode(fleet):
    run = fleet(_kw())
    run.slave(_kw(), async_slave=True)
    run.join()
    assert run.wf.decision.best_n_err[VALID] is not None


def test_average_merge_mode_on_the_device(monkeypatch):
    """``merge = "average"`` keeps the mean of the master's and the
    slave's parameters as tensors on the unit's device; an unknown mode
    raises."""
    monkeypatch.setattr(root.common.fleet, "merge", "average",
                        raising=False)
    gd = GradientDescent(DummyWorkflow())
    gd.weights = Array(torch.full((2, 2), 4.0))
    gd.bias = Array(torch.full((2,), 4.0))
    gd.apply_data_from_slave({"weights": numpy.zeros((2, 2), numpy.float32),
                              "bias": numpy.zeros(2, numpy.float32)})
    assert isinstance(gd.weights.data, torch.Tensor)
    assert torch.equal(gd.weights.data, torch.full((2, 2), 2.0))
    assert torch.equal(gd.bias.data, torch.full((2,), 2.0))
    monkeypatch.setattr(root.common.fleet, "merge", "bogus",
                        raising=False)
    with pytest.raises(ValueError):
        gd.apply_data_from_slave({"weights": numpy.zeros((2, 2)),
                                  "bias": numpy.zeros(2)})


def test_average_merge_fleet_learns(fleet, monkeypatch):
    monkeypatch.setattr(root.common.fleet, "merge", "average",
                        raising=False)
    run = fleet(_kw(max_epochs=3))
    run.slave(_kw(max_epochs=3))
    run.join()
    # averaging against the master's state damps each step; it learns
    # all the same (an untrained model sits near 267 of 297)
    assert run.wf.decision.best_n_err[VALID] <= 150


def test_drop_slave_requeues_minibatches(fleet):
    """A dropped slave's pending minibatch is requeued with its flags
    and served again; the epoch still completes."""
    run = fleet(_kw(max_epochs=1))
    loader = run.wf.loader
    fake = types.SimpleNamespace(id="fake-1")
    with run.master.agent._update_lock:
        job = loader.generate_data_for_slave(fake)
        assert loader.pending_minibatches_["fake-1"]
        loader.drop_slave(fake)
    assert loader.failed_minibatches == [job]
    run.slave(_kw(max_epochs=1))
    run.join()
    assert not loader.failed_minibatches
    assert run.wf.decision.best_n_err[VALID] is not None


def _assert_payloads_equal(got, want):
    """Per unit: None, a scalar, the loader's tuple or a dict of arrays
    and scalars, equal in keys, shapes, dtypes and values."""
    assert len(got) == len(want)
    for mine, theirs in zip(got, want):
        if theirs is None or mine is None:
            assert mine is None and theirs is None
        elif isinstance(theirs, dict):
            assert sorted(mine) == sorted(theirs)
            for key, value in theirs.items():
                if isinstance(value, numpy.ndarray):
                    assert isinstance(mine[key], numpy.ndarray), key
                    assert mine[key].shape == value.shape, key
                    assert mine[key].dtype == value.dtype, key
                    numpy.testing.assert_allclose(mine[key], value,
                                                  atol=1e-6, rtol=0)
                else:
                    assert mine[key] == pytest.approx(value), key
        elif not isinstance(theirs, (tuple, list)):
            assert mine == theirs
        else:
            assert len(mine) == len(theirs)
            for a, b in zip(mine, theirs):
                if isinstance(b, numpy.ndarray):
                    numpy.testing.assert_array_equal(a, b)
                else:
                    assert a == b


def test_payloads_match_the_jax_package():
    """The job a master serves, the update its slave answers after one
    tick and the handshake: the JAX package's keys, shapes, dtypes and
    values, from the same weights and seeds; numpy arrays only."""
    kw = _kw(device=None)
    launchers = []
    try:
        _seed(jprng)
        jmaster = JLauncher(listen_address="127.0.0.1:0")
        launchers.append(jmaster)
        jwf = JMLPWorkflow(jmaster, name="fleet-t", **kw)
        jmaster.initialize()
        weights = [{"weights": numpy.asarray(f.weights.mem),
                    "bias": numpy.asarray(f.bias.mem)}
                   for f in jwf.forwards]
        _seed()
        master = Launcher(listen_address="127.0.0.1:0")
        launchers.append(master)
        twf = MLPWorkflow(master, name="fleet-t", **_kw())
        unit_params_from_jax(twf, weights)
        master.initialize()
        who = types.SimpleNamespace(id="s-1")
        for _ in range(3):  # the valid minibatch, then two train ones
            jjob = jwf.generate_data_for_slave(who)
            tjob = twf.generate_data_for_slave(who)
            _assert_payloads_equal(tjob, jjob)
        _assert_payloads_equal(twf.generate_initial_data_for_slave(who),
                               jwf.generate_initial_data_for_slave(who))
        updates = []
        for package, launcher_cls, wf_cls, job in (
                (jprng, JLauncher, JMLPWorkflow, jjob),
                (prng, Launcher, MLPWorkflow, tjob)):
            _seed(package)
            slave = launcher_cls(master_address="127.0.0.1:1")
            launchers.append(slave)
            swf = wf_cls(slave, name="fleet-t",
                         **(kw if package is jprng else _kw()))
            slave.initialize()
            done = []
            swf.do_job(job, done.append)
            updates.append(done[0])
        _assert_payloads_equal(updates[1], updates[0])
        for entry in updates[1]:
            for value in (entry or {}).values() \
                    if isinstance(entry, dict) else ():
                assert not isinstance(value, torch.Tensor)
    finally:
        for launcher in launchers:
            launcher.stop()


def test_lr_decay_reaches_slaves(fleet):
    """The master's plateau annealing rides the jobs: the slave that
    runs the ticks anneals too."""
    kw = _kw(max_epochs=6)
    kw["learning_rate"] = 1e-7  # a plateau after the first epoch
    run = fleet(kw)
    run.wf.decision.lr_decay = 0.5
    run.wf.decision.lr_decay_patience = 2
    slave = run.slave(kw)
    run.join()
    assert run.wf.gds[0].learning_rate < 1e-7
    assert slave.workflow.gds[0].learning_rate < 1e-7


def test_control_plane_matches_the_fused_standalone_run(fleet, monkeypatch):
    """``plane = "control"``: weights travel in the handshake and at the
    epoch fences only, the slave's parameters stay resident in its fused
    tick, and one slave gives the standalone fused run's per-epoch n_err
    and weights."""
    monkeypatch.setattr(root.common.fleet, "plane", "control",
                        raising=False)
    _seed()
    standalone = MLPWorkflow(DummyLauncher(), name="fleet-t", **_kw())
    alone = _record_epochs(standalone)
    standalone.initialize()
    weights = [{"weights": f.weights.data.numpy().copy(),
                "bias": f.bias.data.numpy().copy()}
               for f in standalone.forwards]
    standalone.run()
    run = fleet(_kw(), weights)
    slave = run.slave(_kw())
    run.join()
    assert run.master.agent.control_plane
    assert run.epochs == alone
    assert run.master.agent.fleet_status()["sync"]["applied"] == 2
    for fwd, ref in zip(run.wf.forwards, standalone.forwards):
        numpy.testing.assert_allclose(fwd.weights.data.numpy(),
                                      ref.weights.data.numpy(),
                                      atol=1e-6, rtol=0)
    tick = slave.workflow.fused_tick
    assert tick is not None and tick.ticks == slave.agent.jobs_done == 12


def test_control_plane_rollback_restores_the_pre_job_params(monkeypatch):
    """A re-issued control-plane job rolls the resident parameters back
    to exactly the pre-job ones; an eval tick leaves nothing to undo;
    ``reset_residency`` makes the next tick read the unit Arrays."""
    monkeypatch.setattr(root.common.fleet, "plane", "control",
                        raising=False)
    _seed()
    slave = Launcher(master_address="127.0.0.1:1")
    try:
        wf = MLPWorkflow(slave, name="fleet-t", **_kw())
        slave.initialize()
        master = MLPWorkflow(DummyLauncher(), name="fleet-t", **_kw())
        master.initialize()
        who = types.SimpleNamespace(id="s")
        tick = wf.fused_tick
        done = []
        wf.do_job(master.generate_data_for_slave(who), done.append)
        assert not tick.rollback_job()  # the valid minibatch: nothing
        before = [dict(p["p"]) for p in tick._params_]
        wf.do_job(master.generate_data_for_slave(who), done.append)
        assert any(not torch.equal(p["p"]["w"], b["w"])
                   for p, b in zip(tick._params_, before))
        assert tick.rollback_job()
        for p, b in zip(tick._params_, before):
            assert all(torch.equal(p["p"][k], b[k]) for k in b)
        tick.reset_residency()
        assert tick._params_ is None
    finally:
        slave.stop()


def test_server_respawns_dropped_slave(fleet):
    """A slave with a relaunch recipe that dies makes the master schedule
    a respawn of ``python -m veles_tpu_torch ... -b``."""
    spawned = []
    run = fleet(_kw(), master_kw={"respawn": True})
    manager = run.master.agent.respawn_manager
    manager.spawner = lambda host, cmd, cwd=None, env=None: spawned.append(
        (host, cmd))
    manager.base_delay = 0.01
    slave = run.slave(_kw(), respawn=True)
    deadline = time.monotonic() + DEADLINE
    while not run.master.agent.slaves and time.monotonic() < deadline:
        time.sleep(0.02)
    assert run.master.agent.slaves, "the slave never connected"
    slave.agent.stop()  # an abrupt close, no "bye"
    while not spawned and time.monotonic() < deadline:
        time.sleep(0.02)
    assert spawned, "the master never scheduled a respawn"
    host, cmd = spawned[0]
    assert host in ("127.0.0.1", "::1") and "-b" in cmd


def test_checksum_mismatch_rejected(fleet):
    run = fleet(_kw(max_epochs=1))
    slave = run.slave(_kw(max_epochs=1), start=False)
    # the class is shared with the master in this process: swap the
    # CLIENT's workflow for a stand-in with another checksum
    slave.agent.workflow = types.SimpleNamespace(checksum="bogus")
    slave.run()
    assert slave.agent.jobs_done == 0
    assert slave.agent.refusal == "workflow checksum mismatch"


def test_slave_splice_and_its_reversal():
    """A slave runs ONE tick per job: the fused tick between the loader
    and the EndPoint; ``_disable_fused_slave`` restores the per-unit
    chain, and a graph-mode slave trains the same job to the same
    parameters."""
    results = []
    for fused in (True, False):
        _seed()
        slave = Launcher(master_address="127.0.0.1:1")
        try:
            wf = MLPWorkflow(slave, name="fleet-t", **_kw())
            slave.initialize()
            if not fused:
                wf._disable_fused_slave()
                assert wf.fused_tick is None and wf.loader.fill_data
            master = MLPWorkflow(DummyLauncher(), name="fleet-t", **_kw())
            unit_params_from_jax(master, [
                {"weights": f.weights.data.numpy(),
                 "bias": f.bias.data.numpy()} for f in wf.forwards])
            master.initialize()
            who = types.SimpleNamespace(id="s")
            master.generate_data_for_slave(who)  # the valid minibatch
            done = []
            wf.do_job(master.generate_data_for_slave(who), done.append)
            results.append(done[0][wf.distribution_order().index(
                wf.gds[0])]["weights"])
        finally:
            slave.stop()
    # level 0: the graph's GD units and the fused tick round their
    # operands to bf16 at different points (tests/test_torch_training.py
    # LEVEL0_ATOL)
    numpy.testing.assert_allclose(results[0], results[1], atol=1e-3,
                                  rtol=0)
