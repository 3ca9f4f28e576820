"""The port's stream loader (veles_tpu_torch/loader/stream.py) and task
farm (fleet/farm.py) against the JAX package's on the CPU: the
contracts of tests/test_aux_tools.py's TestStreamLoader and
tests/test_meta_workflows.py's TestTaskFarm, and the fleet's frames
crossing between the packages — a JAX feeder pushing into the port's
loader, a port farm slave serving a JAX farm master. Every server,
loader and worker is stopped in a ``finally``, every worker thread
joined with a deadline."""

import sys
import threading

import numpy
import pytest
import torch

from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.fleet.farm import TaskFarmMaster as JTaskFarmMaster
from veles_tpu.fleet.server import Server as JServer
from veles_tpu.loader.stream import StreamFeeder as JStreamFeeder
from veles_tpu.loader.stream import StreamLoader as JStreamLoader
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.fleet.farm import TaskFarmMaster, farm_worker
from veles_tpu_torch.fleet.protocol import ProtocolError
from veles_tpu_torch.fleet.server import Server
from veles_tpu_torch.loader.stream import StreamFeeder, StreamLoader

torch.set_num_threads(1)

#: every worker thread joined within this many seconds
DEADLINE = 60


def _loader(**kwargs):
    workflow = DummyWorkflow()
    workflow.device = torch.device("cpu")
    loader = StreamLoader(workflow, **kwargs)
    loader.initialize()
    return loader


@pytest.mark.parametrize("feeder_cls", [StreamFeeder, JStreamFeeder],
                         ids=["port-feeder", "jax-feeder"])
def test_push_and_serve_as_jax(feeder_cls):
    """Pushed samples come out as one minibatch of tensors on the
    loader's device with the JAX loader's values and mask, whichever
    package's feeder pushed them; ``end`` completes the loader."""
    loader = _loader(sample_shape=(4,), minibatch_size=8, secret="s3")
    jloader = JStreamLoader(JDummyWorkflow(), sample_shape=(4,),
                            minibatch_size=8, secret="s3")
    jloader.initialize()
    try:
        for target in (loader, jloader):
            feeder = feeder_cls("127.0.0.1:%d" % target.port, secret="s3")
            assert feeder.push(numpy.arange(4.0), numpy.arange(4.0) * 2) \
                == {"type": "ack", "accepted": 2}
            target.run()
            assert target.minibatch_valid_size == 2
            feeder.end()
        assert isinstance(loader.minibatch_data.data, torch.Tensor)
        assert loader.minibatch_data.data.device.type == "cpu"
        numpy.testing.assert_array_equal(loader.minibatch_data.mem,
                                         numpy.asarray(
                                             jloader.minibatch_data.mem))
        numpy.testing.assert_array_equal(loader.sample_mask.mem,
                                         numpy.asarray(
                                             jloader.sample_mask.mem))
        loader.run()
        assert bool(loader.complete)
    finally:
        loader.stop()
        jloader.stop()


def test_wrong_secret_rejected():
    loader = _loader(sample_shape=(2,), minibatch_size=4, secret="right")
    try:
        feeder = StreamFeeder("127.0.0.1:%d" % loader.port, secret="wrong")
        with pytest.raises((ProtocolError, ConnectionError, EOFError,
                            OSError)):
            feeder.push(numpy.zeros(2))
        assert loader._queue_.qsize() == 0
    finally:
        loader.stop()


#: a task: python writes {"value": N} into its --result-file
TASK = ("import json,sys;argv=sys.argv;"
        "path=argv[argv.index('--result-file')+1];"
        "json.dump({'value': int(argv[1])}, open(path,'w'))")


@pytest.mark.parametrize("package", ["port", "jax"])
def test_farm_loopback_over_the_fleet_protocol(package):
    """A port farm slave serves a farm master (the port's, and the JAX
    package's: the frames and the checksum secret agree): two batches,
    the second after a quiet period; ``close`` lets the worker exit."""
    master_cls, server_cls = ((TaskFarmMaster, Server) if package == "port"
                              else (JTaskFarmMaster, JServer))
    farm = master_cls("test")
    server = server_cls("127.0.0.1:0", farm).start()
    farm.on_new_tasks = server.kick
    worker = threading.Thread(
        target=farm_worker, args=("127.0.0.1:%d" % server.port, "test"),
        daemon=True)
    worker.start()
    try:
        for i in range(3):
            farm.submit("t%d" % i, [sys.executable, "-c", TASK, str(i)])
        results = farm.wait_batch(timeout=DEADLINE)
        assert {k: v["results"]["value"] for k, v in results.items()} \
            == {"t0": 0, "t1": 1, "t2": 2}
        farm.take_results()
        farm.submit("t3", [sys.executable, "-c", TASK, "7"])
        assert farm.wait_batch(timeout=DEADLINE)["t3"]["results"] \
            == {"value": 7}
        farm.close()
        server.kick()
        worker.join(timeout=DEADLINE)
        assert not worker.is_alive()
    finally:
        server.stop()


def test_farm_drop_slave_requeues():
    class Slave:
        id = "s1"

    farm = TaskFarmMaster("x")
    farm.submit("a", ["cmd"])
    assert farm.generate_data_for_slave(Slave())["task_id"] == "a"
    assert farm.generate_data_for_slave(Slave()) is False  # parked
    farm.drop_slave(Slave())
    assert farm.generate_data_for_slave(Slave())["task_id"] == "a"
