"""The port's traffic record and replay, and the capacity search
(veles_tpu_torch/observe/replay.py, observe/capacity.py), on the CPU
against the JAX package.

A trace built from the same ledger rows holds the same rows, tenant
hashes and salt fingerprint in both packages (the header's ``created``
stamp aside), and ``record_trace`` stamps the same loss; ``warp_plan``
and ``plan_fingerprint`` are equal for the same trace, seed and knobs,
and so are ``RecordedTrafficProfile`` plans. Replays through a scripted
poster give equal summaries in their deterministic fields (counts,
availability, tokens; the wall-clock ones are left out), and
``CapacityFinder`` gives equal reports over a scripted endpoint and over
a scripted server burn (a stand-in front's ``/metrics``,
``/debug/history`` and ``/debug/serve``).

End to end on a toy GenerateAPI (embed 16, vocab 29, 2 slots, paged,
two tenants): ``observe record --live`` writes a trace without the raw
tenant names and with a sidecar that verifies, ``observe replay`` at
warp 1 delivers every recorded token, and ``observe capacity`` writes a
``veles-capacity-report`` that ``observe regress`` passes against
itself."""

import importlib
import json
import threading
import time
import urllib.request

import numpy
import pytest
import torch

from veles_tpu.observe import capacity as jcap
from veles_tpu import serving_chaos as jchaos
from veles_tpu_torch import serving_chaos as tchaos
from veles_tpu_torch.core.config import root as troot
from veles_tpu_torch.observe import capacity as tcap
from veles_tpu_torch.observe import history as history_mod
from veles_tpu_torch.observe.history import (MetricHistory,
                                             stop_history_sampler)
from veles_tpu_torch.observe.regress import sha256_of
from veles_tpu_torch.observe.reqledger import RequestLedger
from veles_tpu_torch.observe.slo import SLOEngine, parse_objectives
from veles_tpu_torch.observe.trace_export import main as observe_main
from veles_tpu_torch.parallel import transformer_step as tts
from veles_tpu_torch.serving import GenerateAPI

torch.set_num_threads(1)

# the packages export a ``replay`` function that shadows the module name
jrep = importlib.import_module("veles_tpu.observe.replay")
trep = importlib.import_module("veles_tpu_torch.observe.replay")

HEADS, EMBED, VOCAB, BLOCKS = 4, 16, 29, 2
DETERMINISTIC = ("requests", "completed", "shed", "errors", "availability",
                 "tokens_delivered", "tokens_recorded", "delivered_ratio")


@pytest.fixture(autouse=True)
def quiet_planes(monkeypatch, tmp_path):
    monkeypatch.setattr(history_mod, "_history",
                        MetricHistory(interval_s=30))
    monkeypatch.setattr(history_mod, "_history_built", True)
    monkeypatch.setattr(troot.common.dirs, "run", str(tmp_path / "run"))
    yield
    stop_history_sampler()


def make_ledger(n=12, chunk_cap=512, capacity=512,
                tenants=("acme", "globex")):
    """The port's ledger driven through its hooks, as the JAX package's
    tests/test_replay.py:37-52 drives its own."""
    ledger = RequestLedger(chunk_cap=chunk_cap, capacity=capacity)
    for i in range(n):
        row = ledger.stage(api="generate-api", trace="trace-%d" % i,
                           tenant=tenants[i % len(tenants)],
                           prompt_len=4 + i % 3, budget=4, bucket=8,
                           deadline=9.0)
        ledger.note_admit(row, "dense" if i % 2 else "cold")
        for _ in range(4):
            ledger.note_tokens(row, 1)
        ledger.resolve(row, "completed" if i % 5 else "expired")
        time.sleep(0.002)
    return ledger


def _header(header):
    return {k: v for k, v in header.items() if k != "created"}


@pytest.fixture(scope="module")
def rows():
    return make_ledger(12).resolved()


# -- the trace ---------------------------------------------------------------

@pytest.mark.parametrize("salt", ["veles", "s1", "super-secret"])
def test_build_trace_matches_jax(rows, salt):
    ours = trep.build_trace(rows, salt=salt, source="x")
    theirs = jrep.build_trace(rows, salt=salt, source="x")
    assert _header(ours[0]) == _header(theirs[0])
    assert ours[1] == theirs[1]
    assert len({row["tenant"] for row in ours[1]}) == 2
    assert len(ours[0]["salt_fingerprint"]) == 8


@pytest.mark.parametrize("tenant", ["", "acme", "globex", "tenant-17",
                                    "ünïcode"])
def test_hash_tenant_matches_jax(tenant):
    for salt in ("veles", "s2"):
        assert trep.hash_tenant(tenant, salt) == jrep.hash_tenant(tenant,
                                                                  salt)


@pytest.mark.parametrize("kwargs", [{}, {"chunk_cap": 2},
                                    {"capacity": 4}])
def test_record_trace_stamps_the_same_loss(tmp_path, kwargs):
    """A bounded ledger under-records; both packages stamp the header
    with the same tallies, and the port's file round-trips through both
    loaders with a sidecar that verifies."""
    ledger = make_ledger(6, **kwargs)
    ours = trep.record_trace(ledger, str(tmp_path / "t.jsonl"))
    theirs = jrep.record_trace(ledger, str(tmp_path / "j.jsonl"))
    assert _header(ours) == dict(_header(theirs),
                                 source=_header(ours)["source"])
    for module in (trep, jrep):
        header, loaded = module.load_trace(str(tmp_path / "t.jsonl"))
        assert header == ours
    sidecar = open(str(tmp_path / "t.jsonl.sha256")).read().split()[0]
    assert sidecar == sha256_of(str(tmp_path / "t.jsonl"))
    raw = open(str(tmp_path / "t.jsonl")).read()
    assert "acme" not in raw and "globex" not in raw and "trace-" not in raw


def test_tampered_and_future_traces_are_refused(tmp_path):
    ledger = make_ledger(4)
    path = str(tmp_path / "t.jsonl")
    trep.record_trace(ledger, path)
    with open(path, "a") as fout:
        fout.write(json.dumps({"t": 99.0}) + "\n")
    for module in (trep, jrep):
        with pytest.raises(ValueError, match="sha256 sidecar"):
            module.load_trace(path)
    future = str(tmp_path / "future.jsonl")
    trep.write_trace({"kind": "veles-trace", "schema": 99}, [], future)
    for module in (trep, jrep):
        with pytest.raises(ValueError, match="schema"):
            module.load_trace(future)


def test_record_from_snapshot_matches_jax(tmp_path, rows):
    payload = {"slowest": rows, "inflight": [],
               "loss": {"inflight_dropped": 1}}
    ours = trep.record_from_snapshot(payload, str(tmp_path / "a.jsonl"))
    theirs = jrep.record_from_snapshot(payload, str(tmp_path / "b.jsonl"))
    assert _header(ours) == _header(theirs)
    assert trep.load_trace(str(tmp_path / "a.jsonl"))[1] \
        == jrep.load_trace(str(tmp_path / "b.jsonl"))[1]


# -- the warp plan -----------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    {}, {"warp": 4.0}, {"warp": 3.0, "seed": 11, "burst_compress": 0.4,
                        "long_context_skew": 0.5},
    {"seed": 2, "long_context_skew": 1.0},
    {"tenant_weights": "acme:0,globex:2"},
    {"tenant_weights": "acme:1.7", "seed": 5, "warp": 0.5}])
def test_warp_plan_matches_jax(rows, knobs):
    trace = trep.build_trace(rows)[1]
    knobs = dict(knobs)
    weights = knobs.pop("tenant_weights", None)
    if weights:
        knobs["tenant_weights"] = {
            trep.hash_tenant(name, "veles"): float(w) for name, w in (
                part.split(":") for part in weights.split(","))}
    ours = trep.warp_plan(trace, **knobs)
    theirs = jrep.warp_plan(trace, **knobs)
    assert ours == theirs
    assert trep.plan_fingerprint(ours) == jrep.plan_fingerprint(theirs)
    assert trep.tenant_mix(ours) == jrep.tenant_mix(theirs)


def test_recorded_traffic_profile_matches_jax(tmp_path):
    path = str(tmp_path / "t.jsonl")
    trep.record_trace(make_ledger(10), path)
    profiles = [module.RecordedTrafficProfile(
        path, warp=4.0, seed=5, burst_compress=0.3, long_context_skew=0.2)
        for module in (tchaos, jchaos)]
    assert profiles[0].plan() == profiles[1].plan()
    assert profiles[0].fingerprint() == profiles[1].fingerprint()
    assert profiles[0].expected_mix() == profiles[1].expected_mix()
    summaries = [profile.drive(poster=lambda e, p: (200, p["n_tokens"]),
                               workers=4) for profile in profiles]
    assert [{k: s[k] for k in DETERMINISTIC} for s in summaries][0] \
        == {k: summaries[1][k] for k in DETERMINISTIC}
    assert summaries[0]["completed"] == 10


# -- the open-loop replayer --------------------------------------------------

def _statuses():
    return [200, 429, 503, 200, 400, -1, 200, 200, 200]


@pytest.mark.parametrize("workers", [1, 4])
def test_scripted_replays_match_jax(workers):
    rows = [{"t": i * 0.002, "tenant": "aa", "prompt_len": 2 + i % 3,
             "budget": 2, "tokens": 2} for i in range(9)]
    summaries, seen = [], []
    for module in (trep, jrep):
        statuses = iter(_statuses())
        lock = threading.Lock()
        got = []

        def poster(entry, payload):
            with lock:
                status = next(statuses)
                got.append((entry["index"], len(payload["tokens"]),
                            payload["n_tokens"]))
            if status == -1:
                raise OSError("connection refused")
            return status, payload["n_tokens"] if status == 200 else 0
        summary = module.replay(module.warp_plan(rows), poster=poster,
                                workers=workers, vocab=VOCAB, seed=3)
        summaries.append({k: summary[k] for k in DETERMINISTIC})
        seen.append(sorted(got))
    assert summaries[0] == summaries[1] and seen[0] == seen[1]
    if workers == 1:
        assert summaries[0]["completed"] == 5
        assert summaries[0]["shed"] == 2 and summaries[0]["errors"] == 2


def test_summarize_replay_matches_jax():
    plan = [{"tokens_recorded": 4}] * 4
    results = [{"status": 200, "tokens": 4, "skew_ms": 1.0,
                "wall_ms": 3.0},
               {"status": 429, "tokens": 0, "skew_ms": 2.0,
                "wall_ms": 1.0},
               {"status": 500, "tokens": 0, "skew_ms": 0.5,
                "wall_ms": 9.0}, None]
    assert trep.summarize_replay(plan, results, 0.5) \
        == jrep.summarize_replay(plan, results, 0.5)


# -- the capacity search -----------------------------------------------------

CAP_ROWS = [{"t": i * 0.01, "tenant": "aa", "prompt_len": 3, "budget": 4,
             "tokens": 4} for i in range(8)] + [
    {"t": 0.09, "tenant": "bb", "prompt_len": 3, "budget": 4, "tokens": 4}]


def _scripted(cliff):
    def runner(warp):
        return {"requests": 9,
                "availability": 1.0 if warp < cliff else 0.5,
                "tokens_per_sec": min(warp, cliff) * 100.0,
                "schedule_skew_ms_p95": 1.5,
                "request_wall_ms_p95": 4.0 * warp}
    return runner


@pytest.mark.parametrize("cliff,kwargs", [
    (4.0, {"warp_step": 2.0, "max_warp": 32.0, "refine_steps": 2}),
    (1000.0, {"warp_step": 2.0, "max_warp": 4.0}),
    (8.0, {"warp_step": 2.0, "max_warp": 16.0, "refine_steps": 1}),
    (1.0, {"warp_step": 3.0, "max_warp": 9.0}),
    (1000.0, {"warp_step": 2.0, "max_warp": 16.0, "p95_ms": 20.0,
              "refine_steps": 3})])
def test_capacity_reports_match_jax(cliff, kwargs, tmp_path):
    docs, texts = [], []
    for module in (tcap, jcap):
        finder = module.CapacityFinder(CAP_ROWS, start_warp=1.0,
                                       runner=_scripted(cliff), **kwargs)
        doc = finder.run()
        texts.append(module.render_capacity_report(doc))
        doc.pop("created")
        docs.append(doc)
    assert docs[0] == docs[1] and texts[0] == texts[1]
    assert docs[0]["mix"]["requests"] == 9
    path = str(tmp_path / "cap.json")
    tcap.write_capacity_report(dict(docs[0], created=0.0), path)
    saved = json.loads(open(path).read())
    assert saved["kind"] == "veles-capacity-report"
    assert open(path + ".sha256").read().split()[0] == sha256_of(path)


class _ScriptedFront:
    """A stand-in front whose ``/metrics`` burn rises with each scrape
    past ``breach_after``, whose ``/debug/history`` names a breaching
    rule and whose ``/debug/serve`` names a waste cause: the capacity
    search's server-side breach path without a model."""

    def __init__(self, burns):
        import http.server

        self.burns = list(burns)
        self.scrapes = 0
        front = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/metrics"):
                    burn = front.burns[min(front.scrapes,
                                           len(front.burns) - 1)]
                    front.scrapes += 1
                    body = ('veles_slo_burn_rate{objective="ttft_p95_ms",'
                            'window="60s"} %s\n' % burn)
                elif self.path.startswith("/debug/history"):
                    body = json.dumps({"now_mono": 10.0, "rules": [
                        {"name": "ttft_p95_high", "breach_since": 4.0,
                         "series": "veles_serving_latency_ms",
                         "breach_labels": [["kind", "ttft"]]},
                        {"name": "slo_burn", "breach_since": 5.0,
                         "series": "veles_slo_burn_rate",
                         "breach_labels": []}], "series": []})
                elif self.path.startswith("/debug/serve"):
                    body = json.dumps({"dominant_cause": "tile_pad"})
                else:
                    self.send_error(404)
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = "http://127.0.0.1:%d" % self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("burns", [(0.2, 0.4, 3.5), (0.1, 0.9, 0.95, 1.2),
                                   (0.0,)])
def test_capacity_over_a_scripted_burn_matches_jax(burns):
    """The server-side breach: the burn scraped off ``/metrics`` after
    each probe, the incident handoff off ``/debug/history`` naming the
    first-breaching series, the dominant waste off ``/debug/serve``;
    both packages' reports equal."""
    docs, texts = [], []
    for module in (tcap, jcap):
        front = _ScriptedFront(burns)
        try:
            finder = module.CapacityFinder(
                CAP_ROWS, url=front.url, start_warp=1.0, warp_step=2.0,
                max_warp=8.0, refine_steps=1, runner=_scripted(1000.0))
            doc = finder.run()
        finally:
            front.close()
        texts.append(module.render_capacity_report(doc).replace(
            front.url, "URL"))
        doc.pop("created")
        assert doc.pop("endpoint") == front.url
        if doc["incident"] is not None:
            doc["incident"].pop("time")   # the wall clock of the read
        docs.append(doc)
    assert docs[0] == docs[1] and texts[0] == texts[1]
    if max(burns) > 1.0:
        assert docs[0]["breached"]
        assert docs[0]["breach"]["detail"]["objective"] == "slo_burn"
        assert docs[0]["breach"]["first_breaching_series"] \
            == "veles_serving_latency_ms"
    else:
        assert not docs[0]["breached"]


def test_server_burn_reads_the_worst_gauge():
    import http.server

    class Metrics(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = ('veles_slo_burn_rate{objective="a",window="60s"} 0.5\n'
                    'veles_slo_burn_rate{objective="b",window="5s"} 3.25\n'
                    'veles_other 9\n').encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Metrics)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://127.0.0.1:%d" % server.server_address[1]
        assert tcap.server_burn(url) == jcap.server_burn(url) \
            == (3.25, '{objective="b",window="5s"}')
    finally:
        server.shutdown()
        server.server_close()
    assert tcap.server_burn("http://127.0.0.1:1") is None


# -- end to end on the port's front ------------------------------------------

@pytest.fixture(scope="module")
def model():
    rng = numpy.random.RandomState(0)
    params = tts.init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                         device="cpu")
    table = torch.from_numpy(rng.randn(VOCAB, EMBED).astype(
        numpy.float32) * 0.3)
    return params, table


def _post(url, tokens, tenant):
    req = urllib.request.Request(url, data=json.dumps(
        {"tokens": tokens, "n_tokens": 3}).encode(),
        headers={"X-Veles-Tenant": tenant})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_record_replay_capacity_regress_on_a_live_front(model, tmp_path,
                                                        capsys):
    params, table = model
    api = GenerateAPI(params, table, HEADS, slots=2, max_len=32,
                      n_tokens=4, chunk=2, paged=True, page_size=8,
                      quantize="int8", ledger=RequestLedger(),
                      slo=SLOEngine(parse_objectives("ttft_p95_ms=2000")),
                      device="cpu").start()
    base = "http://127.0.0.1:%d" % api.port
    trace = str(tmp_path / "live.trace.jsonl")
    report = str(tmp_path / "live.capacity.json")
    try:
        for i in range(10):
            _post(base + "/generate", [1 + i % 5] * (3 + i % 3),
                  "acme" if i % 2 else "globex")
            time.sleep(0.02)
        assert observe_main(["record", "--live", base, "-o", trace]) == 0
        raw = open(trace).read()
        assert "acme" not in raw and "globex" not in raw
        assert open(trace + ".sha256").read().split()[0] \
            == sha256_of(trace)
        header, rows = trep.load_trace(trace)
        assert header["count"] == 10 and not header["lossy"]
        assert len({row["tenant"] for row in rows}) == 2
        assert all(len(row["tenant"]) == 16 for row in rows)
        capsys.readouterr()
        assert observe_main(["replay", trace, "--live", base, "--warp",
                             "1", "--vocab", str(VOCAB), "--workers",
                             "4"]) == 0
        out = capsys.readouterr().out
        summary = json.loads(out[out.index("{"):])
        assert summary["delivered_ratio"] == 1.0
        assert summary["completed"] == 10
        assert observe_main(["capacity", trace, "--live", base, "-o",
                             report, "--start-warp", "1", "--warp-step",
                             "4", "--max-warp", "16", "--refine-steps",
                             "0", "--vocab", str(VOCAB), "--workers",
                             "4"]) == 0
        out = capsys.readouterr().out
        assert "sustains" in out or "no breach" in out
        doc = json.loads(open(report).read())
        assert doc["kind"] == "veles-capacity-report"
        assert doc["escalation"]
        assert set(doc["mix"]["tenants"]) == {r["tenant"] for r in rows}
        metrics = urllib.request.urlopen(base + "/metrics").read().decode()
        for name in ("staged", "resolved", "inflight_dropped",
                     "chunk_stamps_dropped", "ring_overflow"):
            assert "veles_reqledger_%s_total" % name in metrics
    finally:
        api.stop()
    assert observe_main(["regress", report, report]) == 0
