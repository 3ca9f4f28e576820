"""The port's web status dashboard (veles_tpu_torch/web_status.py) and
the device column's formatter (observe/xla_stats.format_device_stats)
against the JAX package's on the CPU.

The pure formatters give JAX's strings on the same inputs. Both
packages' ``WebStatusServer`` take the same pushed status and answer the
page, ``/service``, ``/plots.json``, the graph's SVG, ``/events`` and
``/metrics`` alike (the page's clock cells aside), ``/metrics`` with the
active mesh's gauges and the reduce plane's families from the same
mesh and the same reduce notes. ``StatusNotifier.snapshot`` has JAX's
keys, and the notifier's pushes reach the server. Every server and
notifier a test starts is stopped in its ``finally``, and the JAX
dashboard's metric-history sampler (which it starts unheld) with it."""

import json
import re
import types
import urllib.error
import urllib.request

import pytest
import torch

import jax
from veles_tpu import web_status as jweb
from veles_tpu.observe.history import stop_history_sampler as jstop_history
from veles_tpu.observe.metrics import get_metrics_registry as jregistry
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.observe import xla_stats as jxla
from veles_tpu.parallel import mapreduce as jmr
from veles_tpu.parallel import mesh as jmesh
from veles_tpu_torch import web_status as web
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.observe import xla_stats
from veles_tpu_torch.observe.metrics import get_metrics_registry
from veles_tpu_torch.parallel import mapreduce as mr
from veles_tpu_torch.parallel import mesh

torch.set_num_threads(1)

FLEETS = [
    None, "x", {},
    {"plane": "control", "ledger": {"done": 7, "issued": 9, "requeued": 2,
                                    "fenced_total": 1},
     "sync": {"applied": 3, "fenced": 1},
     "reduce": {"f32": {"steps": 12, "bytes": 3.2e6, "idle": 0.25},
                "int8": {"steps": 2, "bytes": 0, "idle": None}},
     "goodput": {"jobs": 5, "fraction": 0.8, "wasted_s": 1.5},
     "straggler": {"slave": "s2", "score": 2.5},
     "chaos": {"frame_drop": 2, "slow_job": 0, "death": 1}},
    {"ledger": {}, "sync": {"applied": 0}, "reduce": {},
     "goodput": {"jobs": 0}},
]
SERVINGS = [
    None, [], {},
    {"ready": True, "breaker": "open", "inflight": "3",
     "counters": {"completed": 10, "trips": 1, "shed": 0, "errors": 2},
     "latency_ms": {"ttft": {"count": 4, "p95": 12.5},
                    "tpot": {"count": 0, "p95": 1.0},
                    "queue_wait": {"count": 2, "p95": 0.7}},
     "governor": {"demoted": True, "tier": "int8",
                  "counters": {"demotions": 2, "promotions": 1,
                               "guard_trips": 1}},
     "slo": {"burn_rate": 2.345, "objective": "ttft_p95_ms",
             "window": "5m"},
     "servescope": {"occupancy": 0.625, "goodput": 0.9,
                    "dominant_cause": "tile_pad", "waste_share": 0.3},
     "pool": {"pages_used": 5, "pages_total": 64,
              "prefix_hit_rate": 0.5},
     "memscope": {"top_owner": "kv_pool", "tagged_bytes": 3.5e8,
                  "headroom_s": 41.6, "leaks": 1,
                  "last_leak_owner": "params"}},
    {"ready": False, "breaker": "closed", "inflight": "x",
     "pool": {"pages_used": None}, "governor": {"demoted": False},
     "servescope": {"dominant_cause": "discard", "waste_share": 0.1}},
]
TRENDS = [
    None, {}, [],
    [{"label": "slo_burn", "spark": [0, 1, 2, 5, 3], "last": 3},
     {"label": "latency", "spark": "▁▂", "last": 0.5}, "junk", {}],
]
DEVICES = [
    None, {},
    {"memory": {"0": {"bytes_in_use": 3 << 30, "bytes_limit": 80 << 30}},
     "mesh": "data2", "compiles": 4, "compile_seconds": 12.25,
     "storms": 1, "mfu": 0.4321},
    {"memory": {"cpu": {"bytes_in_use": 1 << 29, "bytes_limit": None}},
     "mesh": None, "compiles": 0, "mfu": None},
]
GRAPHS = [
    {},
    {"nodes": [{"id": "u0", "label": "start", "cls": "StartPoint",
                "group": "PLUMBING", "runs": 1},
               {"id": "u1", "label": "loader", "cls": "FullBatchLoader",
                "group": "LOADER", "runs": 4},
               {"id": "u2", "label": "tick <fused>", "cls": "FusedTick",
                "group": "WORKER", "runs": 0},
               {"id": "u3", "label": "orphan", "cls": "X"}],
     "edges": [["u0", "u1"], ["u1", "u2"], ["u2", "u1"], ["u9", "u1"],
               "bad"]},
]


@pytest.mark.parametrize("fleet", FLEETS)
def test_format_fleet_health_equals_jax(fleet):
    assert web.format_fleet_health(fleet) == jweb.format_fleet_health(fleet)


@pytest.mark.parametrize("serving", SERVINGS)
def test_format_serving_health_equals_jax(serving):
    assert web.format_serving_health(serving) \
        == jweb.format_serving_health(serving)


@pytest.mark.parametrize("trends", TRENDS)
def test_format_trends_cell_equals_jax(trends):
    assert web.format_trends_cell(trends) == jweb.format_trends_cell(trends)


@pytest.mark.parametrize("device", DEVICES)
def test_format_device_stats_equals_jax(device):
    assert xla_stats.format_device_stats(device) \
        == jxla.format_device_stats(device)


@pytest.mark.parametrize("graph", GRAPHS, ids=["empty", "dag"])
def test_render_graph_svg_equals_jax(graph):
    assert web.render_graph_svg(graph) == jweb.render_graph_svg(graph)


@pytest.mark.parametrize("limit", [1, 3, 50])
def test_tail_lines_equals_jax(tmp_path, limit):
    path = tmp_path / "events.jsonl"
    path.write_bytes(b"".join(b'{"n": %d, "pad": "%s"}\n' % (i, b"x" * i)
                              for i in range(40)) + b"\xff\xfe tail")
    assert web.tail_lines(str(path), limit, block=64) \
        == jweb.tail_lines(str(path), limit, block=64)


def _get(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, b""


def _post(port, body):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/update" % port, data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _status():
    return {"id": "mnist-1", "name": "mnist <b>", "mode": "standalone",
            "runtime": 12.7, "slaves": [{"id": 1}], "fleet": FLEETS[3],
            "serving": SERVINGS[3], "device": DEVICES[2],
            "trends": TRENDS[3], "graph": GRAPHS[1]}


_CLOCK = re.compile(rb"\d\d:\d\d:\d\d")


def test_server_answers_as_jax(tmp_path):
    """The same pushed status through both servers: equal page (the clock
    cells aside), state, plot list, graph SVG and events, and the same
    refusals of malformed pushes and unknown paths, and the same debug
    surfaces listed."""
    plots = tmp_path / "plots"
    plots.mkdir()
    (plots / "err.png").write_bytes(b"\x89PNG fake")
    events = tmp_path / "events.jsonl"
    events.write_text("".join(json.dumps({"i": i}) + "\n"
                              for i in range(5)) + "not json\n")
    servers = [jweb.WebStatusServer(port=0, plots_directory=str(plots),
                                    events_path=str(events)),
               web.WebStatusServer(port=0, plots_directory=str(plots),
                                   events_path=str(events))]
    try:
        for server in servers:
            server.start()
        answers = []
        for server in servers:
            port = server.port
            got = {"post": _post(port, json.dumps(_status()).encode()),
                   "bad": _post(port, b"{nope"),
                   "list": _post(port, b"[1, 2]")}
            for path in ("/", "/service", "/plots.json",
                         "/graph/mnist-1.svg?t=3", "/graph/none.svg",
                         "/events", "/plots/err.png", "/plots/..%2Fx",
                         "/nowhere", "/debug"):
                code, body = _get(port, path)
                if path == "/service":
                    body = json.loads(body)
                    body["mnist-1"].pop("updated")
                elif path == "/debug":
                    # the surfaces' help texts name each package's files
                    body = sorted(json.loads(body)["surfaces"])
                got[path] = (code, _CLOCK.sub(b"T", body)
                             if isinstance(body, bytes) else body)
            answers.append(got)
        assert answers[1] == answers[0]
        assert answers[0]["/"][0] == 200 and b"mnist &lt;b&gt;" \
            in answers[0]["/"][1]
        assert answers[0]["/graph/mnist-1.svg?t=3"][1].startswith(b"<svg")
    finally:
        for server in servers:
            server.stop()
        # the JAX dashboard starts its history sampler unheld
        jstop_history()
    assert servers[1]._httpd is None


@pytest.fixture
def fresh_registries():
    """Both packages' process-wide metric registries, emptied before the
    test and after it, their enabled flags restored: the tests that ran
    earlier in this process (a JAX fleet master's ``publish_fleet``, a
    reduce plane's ``counter_set`` rows) must not reach ``/metrics``."""
    registries = (jregistry(), get_metrics_registry())
    was = [registry.enabled for registry in registries]
    for registry in registries:
        registry.reset()
    yield
    for registry, enabled in zip(registries, was):
        registry.reset()
        registry.enabled = enabled


def _family_rows(text, prefixes=("veles_mesh", "veles_fleet")):
    return sorted(line for line in text.decode().splitlines()
                  if line.startswith(prefixes))


def test_metrics_carry_the_mesh_and_the_reduce_plane_as_jax(
        fresh_registries):
    """``/metrics`` on both dashboards after the same data mesh and the
    same reduce notes: equal ``veles_mesh_*`` and ``veles_fleet_*`` rows."""
    jmesh.build_mesh(devices=jax.devices()[:4], data=4)
    mesh.build_mesh(devices=4, data=4)
    notes = [("f32", 4096, 0.5, 10.0), ("f32", 4096, 0.5, 11.0),
             ("bf16", 2048, 0.25, 12.0)]
    saved = (jmr._stats, mr._stats)
    jmr._stats, mr._stats = jmr.ReduceStats(), mr.ReduceStats()
    for precision, wire, busy, now in notes:
        jmr._stats.note(precision, wire_bytes=wire, busy=busy, now=now)
        mr._stats.note(precision, wire_bytes=wire, busy=busy, now=now)
    servers = [jweb.WebStatusServer(port=0), web.WebStatusServer(port=0)]
    try:
        rows = []
        for server in servers:
            server.start()
            code, body = _get(server.port, "/metrics")
            assert code == 200
            rows.append(_family_rows(body))
    finally:
        for server in servers:
            server.stop()
        jstop_history()
        jmr._stats, mr._stats = saved
    assert rows[1] == rows[0]
    assert 'veles_mesh_axis_size{axis="data"} 4' in rows[1]
    assert "veles_mesh_devices 4" in rows[1]
    assert any(row.startswith("veles_fleet_reduce_bytes_total")
               for row in rows[1])
    assert xla_stats.device_summary()["mesh"] == "data4"


def _launcher(workflow):
    return types.SimpleNamespace(workflow=workflow, mode="standalone")


def test_notifier_snapshot_has_jax_keys_and_pushes():
    """The snapshot's keys (with the device column on) and values equal
    JAX's for the same workflow; the thread's pushes reach a port
    server; stop() joins it."""
    tracker, jtracker = (xla_stats.get_compile_tracker(),
                         jxla.get_compile_tracker())
    was = (tracker.enabled, jtracker.enabled)
    tracker.enabled = jtracker.enabled = True
    server = web.WebStatusServer(port=0)
    notifier = None
    try:
        server.start()
        jsnap = jweb.StatusNotifier(
            _launcher(JDummyWorkflow(name="wf"))).snapshot()
        workflow = DummyWorkflow(name="wf")
        notifier = web.StatusNotifier(
            _launcher(workflow), url="http://127.0.0.1:%d/update"
            % server.port, interval=0.05)
        snap = notifier.snapshot()
        # "trends" is there once a package's metric history has samples,
        # which depends on what ran before in this process
        assert sorted(set(snap) - {"trends"}) \
            == sorted(set(jsnap) - {"trends"})
        for key in ("id", "name", "mode", "slaves"):
            assert snap[key] == jsnap[key]
        assert sorted(snap["device"]) == sorted(jsnap["device"])
        assert [n["cls"] for n in snap["graph"]["nodes"]] \
            == [n["cls"] for n in jsnap["graph"]["nodes"]]
        notifier.start()
        for _ in range(200):
            if snap["id"] in server.statuses():
                break
            notifier._stop.wait(0.05)
        assert server.statuses()[snap["id"]]["name"] == "wf"
        assert "wf" in server.render_page()
    finally:
        if notifier is not None:
            notifier.stop()
        server.stop()
        tracker.enabled, jtracker.enabled = was
    assert notifier._thread is None
