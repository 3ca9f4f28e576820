"""The port's elastic router (veles_tpu_torch/router.py) on the CPU, held
against the JAX package's (veles_tpu/router.py, tests/test_router.py).

The ring and the prefix keys equal JAX's; ``RouterConfig.from_spec``
gives the same values and the same errors; both routers over
tests/test_router.py's ``ScriptedTransport`` shape give the same
outcomes, failures and counters (transport death, busy pricing, the
exhausted set, a 400 passed through, the hedge's late discard, the
pick); the HTTP front answers as JAX's does (relay with the replica and
trace headers, 400 without a replica call, the honest all-down 503,
unready 503, ``/debug/router`` and ``/metrics``); the real transport
raises on a half-written reply. Then the in-process fleet: three CPU
``GenerateAPI`` replicas (greedy, f32) behind the port's router, one
stopped mid-traffic by six client threads: every reply is 200 and equal
to the JAX package's ``GenerateAPI`` on the same weights, and the plane
names the stopped replica in its transitions and the incident. The
subprocess kill -9 on the card is tests/test_torch_cuda.py's."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.fleet import serve_plane as jplane
from veles_tpu import router as jrouter
from veles_tpu_torch import router as trouter
from veles_tpu_torch.fleet import serve_plane as tplane

torch.set_num_threads(1)

PACKAGES = {"port": (trouter, tplane), "jax": (jrouter, jplane)}


def healthy_snap(goodput=1.0, inflight=0, limit=8, pages_used=0,
                 pages_total=64):
    return {"servescope": {"goodput_fraction": goodput},
            "inflight": inflight, "governor": {"effective_limit": limit},
            "pool": {"pages_used": pages_used, "pages_total": pages_total},
            "counters": {"completed": 0}}


class ScriptedTransport:
    """tests/test_router.py's attempt transport: behaviors by replica
    URL prefix, ``fn(body, headers, timeout) -> (status, headers,
    payload)`` or raising like a dead socket."""

    def __init__(self):
        self.behavior = {}
        self._lock = threading.Lock()
        self.calls = []

    def set(self, url, fn):
        self.behavior[url.rstrip("/")] = fn

    def __call__(self, url, body, headers, timeout):
        with self._lock:
            self.calls.append(url)
        for prefix, fn in self.behavior.items():
            if url.startswith(prefix):
                return fn(body, headers, timeout)
        raise ConnectionRefusedError("no behavior for %s" % url)


def ok_behavior(name):
    def fn(body, headers, timeout):
        tokens = json.loads(body.decode())["tokens"]
        out = [(sum(tokens) + i) % 97 for i in range(3)]
        return 200, {}, json.dumps({"tokens": out,
                                    "served_by": name}).encode()
    return fn


def busy_behavior(price):
    def fn(body, headers, timeout):
        return 429, {"Retry-After": str(price)}, b'{"error":"full"}'
    return fn


def dead_behavior(body, headers, timeout):
    raise ConnectionResetError("kill -9")


def reject_behavior(body, headers, timeout):
    return 400, {}, b'{"error":"bad tokens"}'


def make_fleet(which, n=2, transport=None, plane_over=None, **over):
    router_mod, plane_mod = PACKAGES[which]
    cfg = plane_mod.ServePlaneConfig(**dict(
        {"poll_interval_s": 0.01, "cooldown_s": 0.0}, **(plane_over or {})))
    plane = plane_mod.ServePlane(
        ["http://127.0.0.1:%d" % (9000 + i) for i in range(n)],
        config=cfg, fetch=lambda url: healthy_snap())
    router = router_mod.ElasticRouter(
        plane, config=router_mod.RouterConfig(**dict(
            {"port": 0, "hedge_after_s": 5.0, "backoff_s": 0.0,
             "page_size": 4}, **over)),
        transport=transport if transport is not None
        else ScriptedTransport())
    return plane, router


@pytest.fixture
def no_history():
    """Neither package's process history records the plane's series."""
    from veles_tpu.observe import history as jhist
    from veles_tpu_torch.observe import history as thist
    saved = jhist.get_metric_history(), thist.get_metric_history()
    jhist.set_metric_history(None)
    thist.set_metric_history(None)
    try:
        yield
    finally:
        jhist.set_metric_history(saved[0])
        thist.set_metric_history(saved[1])


# -- the ring and the keys ---------------------------------------------------

@pytest.mark.parametrize("names", [[], ["r-a"], ["r-a", "r-b", "r-c"],
                                   ["127.0.0.1:%d" % (9000 + i)
                                    for i in range(5)]])
@pytest.mark.parametrize("vnodes", [1, 16, 64])
def test_ring_owners_match_jax(names, vnodes):
    ours = trouter.HashRing(names, vnodes=vnodes)
    theirs = jrouter.HashRing(names, vnodes=vnodes)
    for i in range(128):
        key = ("key-%d" % i).encode()
        assert ours.owners(key) == theirs.owners(key)


def test_prefix_keys_match_jax():
    rng = numpy.random.RandomState(0)
    for page in (1, 4, 16, 128):
        for n in (0, 1, 3, 4, 15, 16, 17, 128, 300):
            tokens = rng.randint(0, 32768, n).tolist()
            assert trouter.prefix_key(tokens, page) == \
                jrouter.prefix_key(tokens, page)
    assert trouter.prefix_key([1, 2, 3], 4) is None
    assert trouter.prefix_key([1, 2, 3, 4, 9], 4) == \
        trouter.prefix_key([1, 2, 3, 4], 4)


# -- configuration -----------------------------------------------------------

def _config_outcome(cls, spec):
    try:
        cfg = cls.from_spec(spec)
    except Exception as exc:   # noqa: BLE001 - compared
        return (type(exc).__name__, str(exc))
    return {key: getattr(cfg, key) for key in cls.KEYS
            if hasattr(cfg, key)}


SPECS = [None, "", "hedge_after_s=1.5,retire_polls=5,max_attempts=2,"
         "adopt_pressure=0.7", "no_such_knob=1", "vnodes", "max_inflight=0",
         "max_inflight=-1", "hedge_after_s=0", "page_size=0",
         "spill_pressure=1.5", "retire_ratio=1.0", "poll_interval_s=0",
         "fail_threshold=0", "cooldown_s=-1", "min_active=0",
         {"port": 8801, "host": "0.0.0.0", "replicas": "a,b",
          "backoff_s": 0.01, "goodput_floor": 0.1}, ["not", "a", "dict"],
         "poll_interval_s=0.2,fail_threshold=2,cooldown_s=0.0,"
         "hedge_after_s=2.0,backoff_s=0.01,page_size=128"]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_from_spec_matches_jax(spec):
    for ours, theirs in ((trouter.RouterConfig, jrouter.RouterConfig),
                         (tplane.ServePlaneConfig,
                          jplane.ServePlaneConfig)):
        assert _config_outcome(ours, spec) == _config_outcome(theirs, spec)


def test_build_router_wires_both_halves(no_history):
    plane, router = trouter.build_router(
        ["http://127.0.0.1:9000", "127.0.0.1:9001"],
        standby=["127.0.0.1:9100"], spec="vnodes=16,retire_polls=4")
    assert router.plane is plane
    assert router.config.vnodes == 16 and plane.config.retire_polls == 4
    assert [r.url for r in plane.replicas] == [
        "http://127.0.0.1:9000", "http://127.0.0.1:9001",
        "http://127.0.0.1:9100"]
    assert len(plane.active()) == 2 and len(plane.standby()) == 1


# -- the lease machinery against a scripted transport ------------------------

def _dispatch(which, behaviors, tokens, **over):
    """One routed request over a fresh fleet: the lease's outcome,
    failures and the router's counters, sleeps recorded."""
    transport = ScriptedTransport()
    plane, router = make_fleet(which, n=len(behaviors),
                               transport=transport, **over)
    for rep, fn in zip(plane.replicas, behaviors):
        transport.set(rep.url, fn)
    sleeps = []
    router._sleep = sleeps.append
    lease = router.dispatch(tokens, json.dumps({"tokens": tokens}).encode(),
                            {}, time.monotonic() + 30)
    return {"outcome": lease.outcome, "failures": lease.failures,
            "counters": {key: router.counter(key) for key in (
                "retries", "failovers", "affinity_hits",
                "affinity_misses", "late_discards")},
            "calls": len(transport.calls), "sleeps": sleeps,
            "replica_failures": [r.failures for r in plane.replicas]}


SCENARIOS = {
    "death": ([dead_behavior, ok_behavior("r1")], [1, 2, 3], {}),
    "death-keyed": ([dead_behavior, ok_behavior("r1")], [1, 2, 3, 4], {}),
    "busy": ([busy_behavior(3.5), busy_behavior(1.5)], [5, 6, 7, 8],
             {"max_attempts": 2}),
    "exhausted": ([dead_behavior, dead_behavior], [1, 2, 3, 4], {}),
    "passthrough": ([reject_behavior, reject_behavior], [1, 2, 3, 4], {}),
    "healthy": ([ok_behavior("a"), ok_behavior("b"), ok_behavior("c")],
                [7, 7, 7, 7, 7], {}),
    "backoff": ([dead_behavior, dead_behavior, ok_behavior("c")],
                [1, 2, 3], {"backoff_s": 0.5}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_dispatch_matches_jax(scenario, no_history):
    behaviors, tokens, over = SCENARIOS[scenario]
    ours = _dispatch("port", behaviors, tokens, **over)
    theirs = _dispatch("jax", behaviors, tokens, **over)
    assert ours == theirs


def test_hedged_late_answer_is_discarded_as_jax(no_history):
    """The fence: a primary hung past hedge_after_s loses to the hedge;
    its late answer is counted and dropped, in both routers."""
    results = {}
    for which in PACKAGES:
        release = threading.Event()

        def slow(body, headers, timeout):
            release.wait(10)
            return 200, {}, b'{"served_by": "slow", "tokens": [9]}'

        transport = ScriptedTransport()
        plane, router = make_fleet(which, transport=transport,
                                   hedge_after_s=0.05)
        key = PACKAGES[which][0].prefix_key([1, 2, 3, 4], 4)
        primary = router._ring_for(r.name for r in plane.replicas) \
            .owners(key)[0]
        for rep in plane.replicas:
            transport.set(rep.url, slow if rep.name == primary
                          else ok_behavior("fast"))
        lease = router.dispatch([1, 2, 3, 4], b'{"tokens": [1, 2, 3, 4]}',
                                {}, time.monotonic() + 30)
        won = lease.outcome
        release.set()
        deadline = time.monotonic() + 10
        while router.counter("late_discards") < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        results[which] = (won, lease.late, router.counter("late_discards"),
                          lease.outcome)
    assert results["port"] == results["jax"]
    assert json.loads(results["port"][0][1].decode())["served_by"] == \
        "fast"
    assert results["port"][1:3] == (1, 1)


def test_pick_matches_jax(no_history):
    picks = {}
    for which in PACKAGES:
        plane, router = make_fleet(which, n=4, spill_pressure=0.9)
        out = []
        for pressures in ((0.0, 0.0, 0.0, 0.0), (0.95, 0.1, 0.5, 0.2),
                          (0.95, 0.95, 0.95, 0.95), (0.8, 0.2, 0.5, 0.2)):
            for rep, p in zip(plane.replicas, pressures):
                rep.pressure = p
            for tokens in ([7, 7, 7, 7], [1, 2, 3], [4, 4, 4, 4, 4, 4, 4, 4]):
                key = PACKAGES[which][0].prefix_key(tokens, 4)
                rep, primary = router._pick(key, set())
                out.append((rep.name, primary))
                rep, primary = router._pick(key, {rep.name})
                out.append((rep.name, primary))
        plane.replicas[0].state = "draining"
        plane.replicas[1].note_done(False)
        plane.replicas[1].note_done(False)
        plane.replicas[1].note_done(False)
        out.append(router._pick(None, {plane.replicas[2].name})[0].name)
        picks[which] = out
    assert picks["port"] == picks["jax"]


# -- the HTTP front ----------------------------------------------------------

def post(url, payload, headers=None):
    data = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    req = urllib.request.Request(
        url + "/generate", data=data,
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode()), \
                dict(resp.headers)
    except urllib.error.HTTPError as err:
        with err:
            return err.code, json.loads(err.read().decode() or "{}"), \
                dict(err.headers or {})


def _front_session(which):
    """One scripted session against a started front: its replies'
    statuses, bodies and routing headers, and the router's tallies."""
    transport = ScriptedTransport()
    plane, router = make_fleet(which, transport=transport,
                               plane_over={"poll_interval_s": 30.0,
                                           "fail_threshold": 3})
    router.start()
    url = "http://127.0.0.1:%d" % router.port
    rows = []
    try:
        for rep in plane.replicas:
            transport.set(rep.url, ok_behavior(rep.name))
            rep.goodput, rep.pressure = 1.0, 0.25
        status, body, headers = post(url, {"tokens": [1, 2, 3, 4]},
                                     {"X-Veles-Trace": "t-42",
                                      "X-Veles-Tenant": "tenant-a"})
        rows.append((status, body, headers.get("X-Veles-Replica"),
                     headers.get("X-Veles-Trace")))
        for payload in (b"not json", b"{}",
                        json.dumps({"tokens": []}).encode(),
                        json.dumps({"tokens": [1, True]}).encode(),
                        json.dumps({"tokens": "abc"}).encode()):
            rows.append(post(url, payload)[:2])
        for rep in plane.replicas:
            transport.set(rep.url, dead_behavior)
        status, body, headers = post(url, {"tokens": [1, 2, 3, 4]})
        rows.append((status, body, headers.get("Retry-After")))
        for rep in plane.replicas:
            rep.state = "dead"
        rows.append(router.health.ready)
        status, body, headers = post(url, {"tokens": [1, 2, 3, 4]})
        rows.append((status, body, headers.get("Retry-After")))
        with urllib.request.urlopen(url + "/debug/router",
                                    timeout=10) as resp:
            snap = json.loads(resp.read().decode())
        rows.append((snap["counters"], snap["config"],
                     snap["plane"]["active"]))
        with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
            scrape = resp.read().decode()
        rows.append(sorted({line.split("{")[0].split(" ")[0]
                            for line in scrape.splitlines()
                            if line.startswith("veles_router_")}))
        rows.append((router.health.counter("completed"),
                     router.health.counter("shed"),
                     router.health.snapshot()["inflight"]))
        forwarded = transport.calls[:1]
    finally:
        router.stop()
    return rows, forwarded


@pytest.fixture
def fresh_registries():
    """Both packages' process-wide metric registries emptied before the
    test and after it, their enabled flags restored: rows that tests run
    earlier in this process left (a JAX router's failover histogram)
    must not reach this test's ``/metrics`` (ROADMAP C9)."""
    from veles_tpu.observe.metrics import get_metrics_registry as jreg
    from veles_tpu_torch.observe.metrics import get_metrics_registry
    registries = (jreg(), get_metrics_registry())
    was = [registry.enabled for registry in registries]
    for registry in registries:
        registry.reset()
    yield
    for registry, enabled in zip(registries, was):
        registry.reset()
        registry.enabled = enabled


def test_front_session_matches_jax(no_history, fresh_registries):
    ours, forwarded = _front_session("port")
    theirs, _ = _front_session("jax")
    assert ours == theirs
    assert ours[0][0] == 200 and ours[0][3] == "t-42"
    assert all(row[0] == 400 for row in ours[1:6])
    assert ours[6][0] == 503 and int(ours[6][2]) >= 1
    assert ours[7] is False and ours[8][0] == 503
    assert "veles_router_failovers_total" in ours[10]
    assert "veles_router_replica_goodput" in ours[10]
    assert forwarded


def _serve_once(script):
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    port = server.getsockname()[1]

    def run():
        conn, _ = server.accept()
        try:
            conn.recv(65536)
            script(conn)
        finally:
            conn.close()
            server.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return "http://127.0.0.1:%d" % port, thread


def test_half_stream_eof_raises():
    """A replica that dies mid-body (1000 bytes promised, 10 sent, the
    socket closed: a SIGKILL's shape) fails the attempt; an error
    status returns as a verdict with its headers."""
    url, thread = _serve_once(lambda conn: conn.sendall(
        b"HTTP/1.1 200 OK\r\nContent-Length: 1000\r\n\r\n0123456789"))
    with pytest.raises(Exception):
        trouter._http_post(url, b"{}", {}, timeout=10)
    thread.join(10)
    url, thread = _serve_once(lambda conn: conn.sendall(
        b"HTTP/1.1 429 Too Many Requests\r\nRetry-After: 7\r\n"
        b"Content-Length: 2\r\n\r\n{}"))
    status, headers, payload = trouter._http_post(url, b"{}", {},
                                                  timeout=10)
    thread.join(10)
    assert (status, headers.get("Retry-After"), payload) == (429, "7",
                                                             b"{}")


# -- the in-process fleet: three CPU replicas, one stopped -------------------

HEADS, EMBED, BLOCKS, VOCAB = 4, 16, 2, 11
SERVE_KW = dict(slots=2, max_len=48, n_tokens=5, chunk=2, paged=True,
                page_size=4)
PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8], [2, 4, 6, 8], [9, 1, 9, 1],
           [3, 3, 3, 3], [1, 2, 3, 4, 5], [1, 2, 3, 4, 6, 7, 8, 9, 10]]


@pytest.fixture
def isolated_history(tmp_path, monkeypatch):
    """A private port MetricHistory and incident recorder, so the
    detector's rule and artifact are observable without ambient serve
    rules claiming the leading indicator."""
    from veles_tpu_torch.observe import servescope
    from veles_tpu_torch.observe.history import (IncidentRecorder,
                                                 MetricHistory,
                                                 get_metric_history,
                                                 set_metric_history)
    from veles_tpu_torch.observe.metrics import MetricsRegistry
    monkeypatch.setattr(servescope, "MIN_EVAL_TOKENS", 10 ** 9)
    history = MetricHistory(
        registry=MetricsRegistry(enabled=True), interval_s=0.01,
        capacity=256, series_cap=64, rules=[],
        incidents=IncidentRecorder(cooldown_s=0.0,
                                   directory=str(tmp_path)))
    previous = get_metric_history()
    set_metric_history(history)
    try:
        yield history
    finally:
        set_metric_history(previous)


def _jax_streams():
    """The JAX package's GenerateAPI on the seed-0 toy model: each
    prompt's greedy tokens, one request at a time."""
    from veles_tpu.parallel.transformer_step import init_transformer_params
    from veles_tpu.serving import GenerateAPI as JAPI

    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB)
    table = rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.3
    api = JAPI(params, jnp.asarray(table), HEADS, **SERVE_KW).start()
    try:
        return {tuple(p): post("http://127.0.0.1:%d" % api.port,
                               {"tokens": p})[1]["tokens"]
                for p in PROMPTS}, params, table
    finally:
        api.stop()


def test_inprocess_failover_equals_jax(isolated_history):
    from veles_tpu_torch import convert
    from veles_tpu_torch.serving import GenerateAPI

    want, jparams, jtable = _jax_streams()
    params = convert.params_from_jax(jparams, device="cpu")
    table = torch.from_numpy(jtable)
    apis = [GenerateAPI(params, table, HEADS, device="cpu",
                        **SERVE_KW).start() for _ in range(3)]
    router = None
    try:
        plane, router = trouter.build_router(
            ["http://127.0.0.1:%d" % api.port for api in apis],
            spec="poll_interval_s=0.1,fail_threshold=2,cooldown_s=0.0,"
                 "hedge_after_s=2.0,backoff_s=0.01,page_size=4")
        router.start()
        front = "http://127.0.0.1:%d" % router.port
        baseline = {}
        for prompt in PROMPTS:
            status, body, headers = post(front, {"tokens": prompt})
            assert status == 200, body
            baseline[tuple(prompt)] = body["tokens"]
        assert baseline == want
        results, errors, lock = [], [], threading.Lock()
        started = threading.Barrier(7)

        def pound(k):
            started.wait(30)
            for r in range(6):
                prompt = PROMPTS[(k + r) % len(PROMPTS)]
                try:
                    status, body, _ = post(front, {"tokens": prompt})
                except Exception as exc:   # noqa: BLE001 - counted
                    with lock:
                        errors.append(repr(exc))
                    continue
                with lock:
                    results.append((tuple(prompt), status, body))

        threads = [threading.Thread(target=pound, args=(k,))
                   for k in range(6)]
        for thread in threads:
            thread.start()
        started.wait(30)
        time.sleep(0.05)
        apis[0].stop()
        for thread in threads:
            thread.join(60)
        assert not any(thread.is_alive() for thread in threads)
        assert errors == []
        assert len(results) == 36
        for prompt, status, body in results:
            assert status == 200, body
            assert body["tokens"] == want[prompt]
        dead = plane.replicas[0].name
        deadline = time.monotonic() + 30
        while plane.find(dead).state != "dead" \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        entry = next(t for t in plane.transitions
                     if t["action"] == "replica_dead")
        assert entry["replica"] == dead
        doc = isolated_history.incidents.last_doc
        assert doc is not None
        leading = doc["leading_indicator"]
        assert leading["series"] == tplane.REPLICA_GOODPUT_SERIES
        assert ["replica", dead] in leading["labels"]
        status, body, _ = post(front, {"tokens": PROMPTS[0]})
        assert status == 200 and body["tokens"] == want[tuple(PROMPTS[0])]
    finally:
        if router is not None:
            router.stop()
        for api in apis:
            api.stop()
