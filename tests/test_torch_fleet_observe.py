"""The fleet's own observability in the port (ROADMAP A7's rest) against
the JAX package on the CPU: the metric history's fleet rows
(``observe/history.fleet_summary`` on a slave's update frames,
``fleet/client.py``, and ``ingest_summary`` on the master,
``fleet/server.py``) and the dashboard's fleet column (a master's
``fleet_status()`` through the launcher's ``StatusNotifier`` into a
``WebStatusServer``, ``web_status.format_fleet_health``).

A port master and one slave run on threads in this process over
loopback, on the digits (layers (16, 10), 297 valid / 1500 train,
minibatch 300, 2 epochs), joined within :data:`DEADLINE` and stopped in a
``finally``. The process-wide registries, history and web settings a
test touches are restored after it."""

import threading
import time

import numpy
import pytest
import torch

from veles_tpu import web_status as jweb
from veles_tpu.observe.history import MetricHistory as JaxHistory
from veles_tpu.observe.history import stop_history_sampler as jstop_history
from veles_tpu.observe.metrics import MetricsRegistry as JaxRegistry
from veles_tpu_torch import web_status as web
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.observe import history as history_mod
from veles_tpu_torch.observe.history import MetricHistory
from veles_tpu_torch.observe.metrics import (MetricsRegistry,
                                             get_metrics_registry)
from veles_tpu_torch.parity import read_digits

torch.set_num_threads(1)

#: every thread joined within this many seconds, or the test fails
DEADLINE = 60
#: the summary's stamp: fleet_summary and ingest_summary take ``now``
NOW = 500.0


def _kw():
    x, y = read_digits()
    return dict(layers=(16, 10), device="cpu",
                loader_kwargs=dict(data=x.astype(numpy.float32),
                                   labels=y.astype(numpy.int32),
                                   class_lengths=[0, 297, 1500],
                                   minibatch_size=300,
                                   normalization_type="linear"),
                learning_rate=0.5, max_epochs=2)


def _seed():
    prng.get("default").seed(42)
    prng.get("loader").seed(43)


def _run_fleet(master_kw=None):
    """A master and one slave to the end of the run; returns the master
    launcher (not stopped: the caller stops it) and the slave's."""
    _seed()
    master = Launcher(listen_address="127.0.0.1:0", **(master_kw or {}))
    MLPWorkflow(master, name="fleet-t", **_kw())
    master.initialize()
    _seed()
    slave = Launcher(master_address="127.0.0.1:%d" % master.agent.port)
    MLPWorkflow(slave, name="fleet-t", **_kw())
    slave.initialize()
    threads = [threading.Thread(target=launcher.run, daemon=True)
               for launcher in (master, slave)]
    for thread in threads:
        thread.start()
    end = time.monotonic() + DEADLINE
    for thread in threads:
        thread.join(max(end - time.monotonic(), 0.1))
    assert not any(t.is_alive() for t in threads), "the fleet hung"
    return master, slave


def _rows(step):
    """One sample of a few summary-prefix gauges and a counter, and a
    series outside the prefixes (never summarized)."""
    return [("veles_slo_burn_rate", "gauge",
             (("objective", "ttft_p95_ms"),), 0.5 * step),
            ("veles_kv_pages_free", "gauge", (), 64.0 - step),
            ("veles_serving_requests_total", "counter", (), 10.0 * step),
            ("veles_other_total", "counter", (), float(step))]


@pytest.fixture
def registries():
    """The port's process registry on (the piggyback's gate), emptied
    before and after."""
    registry = get_metrics_registry()
    was = registry.enabled
    registry.reset()
    registry.enabled = True
    yield
    registry.reset()
    registry.enabled = was


def test_history_rows_ride_the_frames_and_land_as_jax(monkeypatch,
                                                      registries):
    """Equal samples in the slave's history and a JAX history give equal
    summary rows, and the rows the slave's update frames carry are those;
    the master ingests them into the slave-labelled series the JAX
    package's ``ingest_summary`` makes of the same rows."""
    slave_history = MetricHistory(registry=MetricsRegistry(), capacity=8)
    master_history = MetricHistory(registry=MetricsRegistry(), capacity=8)
    jax_slave = JaxHistory(registry=JaxRegistry(), capacity=8)
    for step in range(6):
        slave_history.sample(now=490.0 + step, rows=_rows(step))
        jax_slave.sample(now=490.0 + step, rows=_rows(step))
    want = jax_slave.fleet_summary(now=NOW)
    assert slave_history.fleet_summary(now=NOW) == want
    assert [row[0] for row in want] == ["veles_kv_pages_free",
                                        "veles_serving_requests_total",
                                        "veles_slo_burn_rate"]
    summary, ingest = (slave_history.fleet_summary,
                       master_history.ingest_summary)
    monkeypatch.setattr(slave_history, "fleet_summary",
                        lambda: summary(now=NOW))
    landed = []

    def ingest_at(sid, rows):
        landed.append((sid, rows))
        return ingest(sid, rows, now=NOW)
    monkeypatch.setattr(master_history, "ingest_summary", ingest_at)
    # the client reads the history on its thread, the master elsewhere
    monkeypatch.setattr(history_mod, "get_metric_history", lambda: (
        slave_history if threading.current_thread().name == "fleet-client"
        else master_history))
    master, slave = _run_fleet()
    try:
        assert len(landed) == slave.agent.jobs_done == 12
        assert all(sid == "slave-1" and rows == want
                   for sid, rows in landed)
        jax_master = JaxHistory(registry=JaxRegistry(), capacity=8)
        jax_master.ingest_summary("slave-1", want, now=NOW)

        def slave_series(history):
            # the master's own series (its fleetscope's goodput and
            # straggler trends) are not the slave's
            return [row for row in history.debug_snapshot(now=NOW)["series"]
                    if row["labels"].get("slave") == "slave-1"]
        got = slave_series(master_history)
        assert got == slave_series(jax_master)
        assert sorted(row["name"] for row in got) \
            == [row[0] for row in want]
    finally:
        master.stop()
        slave.stop()


def test_fleet_column_through_the_notifier_equals_jax(monkeypatch):
    """A master's status, fleet keys and all, pushed by the launcher's
    StatusNotifier into a port WebStatusServer, then the same status into
    the JAX package's server: equal fleet columns, which name the run's
    ledger (12 jobs done)."""
    server = web.WebStatusServer(port=0, host="127.0.0.1").start()
    jserver = jweb.WebStatusServer(port=0, host="127.0.0.1")
    master = slave = None
    try:
        for key, value in (("enabled", True), ("host", "127.0.0.1"),
                           ("port", server.port),
                           ("notification_interval", 0.05)):
            monkeypatch.setattr(root.common.web, key, value, raising=False)
        master, slave = _run_fleet()
        notifier = master.status_notifier
        assert notifier is not None and slave.status_notifier is None
        final = notifier.snapshot()
        assert final["mode"] == "master"
        assert final["fleet"]["ledger"]["done"] == 12
        end = time.monotonic() + DEADLINE
        while time.monotonic() < end and (server.statuses().get(
                final["id"]) or {}).get("fleet") != final["fleet"]:
            time.sleep(0.02)
        pushed = server.statuses()[final["id"]]
        assert pushed["fleet"] == final["fleet"]
        jserver.start()
        jserver.update(dict(pushed))
        cells = [[row["fleet"] for row in s.live_state()["workflows"]]
                 for s in (server, jserver)]
        assert cells[0] == cells[1] \
            == [jweb.format_fleet_health(final["fleet"])]
        assert "12" in cells[0][0]
        assert web.format_fleet_health(final["fleet"]) == cells[1][0]
    finally:
        for launcher in (master, slave):
            if launcher is not None:
                launcher.stop()
        server.stop()
        jserver.stop()
        jstop_history()
