"""The port's request ledger (veles_tpu_torch/observe/reqledger.py) and its
hooks in the serving path, against the JAX package on the CPU.

Held equal to the JAX package, with the same numpy-seeded weights and
prompts: the rows of the same toy traffic through both packages'
``ContinuousDecoder`` (paged, the JAX side on its fused-kernel route in
interpret mode, and the dense slab): their stage waterfalls, admission
kinds, groups, buckets, pages, token counts, chunk cadences and dispatch
attributions; and the autopsy text (``format_waterfall``, ``autopsy``,
``widest_gap``) of the same rows. Port-only: the rows the HTTP fronts
write (``GenerateAPI`` with its tenant and trace headers, ``RESTfulAPI``),
the kernel-build windows a row names as its stall, and the record path's
lock-free contract."""

import json
import threading
import urllib.request

import numpy
import pytest
import torch

from veles_tpu_torch.observe import history as history_mod
from veles_tpu_torch.observe.history import (MetricHistory,
                                             stop_history_sampler)
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.observe.reqledger import (RequestLedger, autopsy,
                                               format_waterfall,
                                               publish_request_ledger,
                                               widest_gap)
from veles_tpu_torch.observe.xla_stats import CompileTracker
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)

torch.set_num_threads(1)

#: prompts of the toy traffic: two cold, a page-aligned prompt twice (cold
#: then a hit on the paged pool), a prompt extending it (a tail) and a
#: one-token prompt
PROMPTS = ([1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 1, 2], [1, 2, 3, 4, 5, 6, 7, 8],
           [1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9, 1, 2], [5])
KW = dict(slots=2, max_len=48, n_tokens=6, page_size=8)


@pytest.fixture(autouse=True)
def quiet_history(monkeypatch):
    """The port's metric history pinned to a 30 s cadence for the file
    (the sampler runs every collector), and every sampler stopped after
    each test."""
    monkeypatch.setattr(history_mod, "_history",
                        MetricHistory(registry=MetricsRegistry(),
                                      interval_s=30.0))
    monkeypatch.setattr(history_mod, "_history_built", True)
    yield
    stop_history_sampler()


@pytest.fixture
def process_ledger(monkeypatch):
    """A fresh process-wide request ledger for one test, the one before it
    put back afterwards (tier-1 hygiene, C12): ``--dist loadfile`` runs
    other files first in the same worker, and their resolved rows and
    requests in flight would share ``get_request_ledger()`` with the
    test, pushing its one row out of ``/debug/requests``'s slowest."""
    from veles_tpu_torch.observe import reqledger

    fresh = RequestLedger()
    monkeypatch.setattr(reqledger, "_ledger", fresh)
    return fresh


def _weights():
    from veles_tpu.parallel.transformer_step import (
        init_transformer_params as jax_init)

    rng = numpy.random.RandomState(0)
    jparams = jax_init(rng, 2, 16, 4, 11)
    table = rng.randn(11, 16).astype(numpy.float32) * 0.3
    params = init_transformer_params(numpy.random.RandomState(0), 2, 16,
                                     4, 11, device="cpu")
    return jparams, params, table


def _drive(decoder, ledger, prompts=PROMPTS, together=False):
    """Stage a row, submit and link each prompt (one a drain pass, or all
    before the first), drain lag-1 with chunks of 2; resolve the rows."""
    rows, queue = [], list(prompts)

    def admit():
        while queue:
            prompt = queue.pop(0)
            row = ledger.stage(api="toy", prompt_len=len(prompt))
            decoder.ledger_link(decoder.submit(prompt), row)
            rows.append(row)
            if not together:
                return
    admit()
    decoder.drain_pipelined(2, admit=admit)
    for row in rows:
        ledger.resolve(row, "completed")
    return rows


def _facts(row):
    return {"stages": [stage for stage, _ in row["stages"]],
            "admit": row["admit"], "pages_used": row["pages_used"],
            "tokens": row["tokens"], "rid": row["rid"],
            "chunks": [chunk[1:] for chunk in row["chunks"]],
            "dispatches": row["dispatches"], "outcome": row["outcome"]}


def _both(paged, together=False):
    import jax.numpy as jnp
    from veles_tpu.observe.reqledger import RequestLedger as JaxLedger
    from veles_tpu.serving import ContinuousDecoder as JaxDecoder
    from veles_tpu_torch.serving import ContinuousDecoder

    jparams, params, table = _weights()
    jledger, ledger = JaxLedger(), RequestLedger()
    jdec = JaxDecoder(jparams, jnp.asarray(table), 4, ledger=jledger,
                      paged=paged, paged_kernel=True if paged else None,
                      **KW)
    dec = ContinuousDecoder(params, torch.from_numpy(table), 4,
                            ledger=ledger, paged=paged, device="cpu", **KW)
    return (_drive(jdec, jledger, together=together),
            _drive(dec, ledger, together=together), dec)


@pytest.mark.parametrize("together", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_rows_of_the_same_traffic_equal_jax(paged, together):
    """Stages, admission kinds, groups, buckets, pages, tokens, chunk
    cadence and dispatch attribution equal the JAX package's row for row
    (the JAX slab pads a group to a power of two; the row's group is the
    live count in both)."""
    jrows, rows, dec = _both(paged, together)
    assert [_facts(r) for r in rows] == [_facts(r) for r in jrows]
    kinds = {r["admit"]["kind"] for r in rows}
    assert kinds >= {"cold", "tail"} if paged else kinds == {"dense"}
    for row in rows:
        assert row["dispatches"]["aot"] == 0
        assert sum(c[1] for c in row["chunks"]) == row["tokens"] == 6
        assert row["admit"]["program"] == (
            {"cold": "paged.admit", "tail": "paged.admit_tail",
             "hit": "paged.admit_hit"}[row["admit"]["kind"]]
            if paged else "decode.admit")
    # the decoder's rid -> row map empties as requests retire
    assert dec._ledger_rows == {}


def test_waterfall_and_autopsy_text_equal_jax():
    from veles_tpu.observe import reqledger as jax_ledger

    _, rows, _ = _both(True)
    rows[0]["compile_stalls"] = [["paged_attention.cu", 1234.5]]
    rows[1]["error"] = "x" * 10
    for row in rows:
        assert format_waterfall(row) == jax_ledger.format_waterfall(row)
        assert widest_gap(row) == jax_ledger.widest_gap(row)
    assert autopsy(rows, slowest=4) == jax_ledger.autopsy(rows, slowest=4)
    assert "compile stalls: paged_attention.cu 1234ms" in autopsy(rows)


def test_ledger_bounds_and_tallies_equal_jax():
    """The ring, the in-flight cap and the chunk cap drop and count as the
    JAX ledger does; the scrape bridge publishes the five tallies."""
    from veles_tpu.observe.reqledger import RequestLedger as JaxLedger

    def fill(ledger):
        rows = [ledger.stage(api="a", prompt_len=i) for i in range(7)]
        for row in rows[:5]:
            for n in (2, 3, 1):
                ledger.note_tokens(row, n)
            ledger.resolve(row, "completed")
        ledger.resolve(rows[0], "errors")   # resolved exactly once
        return (ledger.staged_total, ledger.resolved_total,
                ledger.loss_tallies(), len(ledger.inflight()),
                [r["tokens"] for r in ledger.resolved()])

    kw = dict(capacity=3, inflight_cap=4, chunk_cap=2)
    assert fill(RequestLedger(**kw)) == fill(JaxLedger(**kw))
    ledger = RequestLedger(**kw)
    fill(ledger)
    registry = MetricsRegistry(enabled=True)
    publish_request_ledger(registry, ledger)
    text = registry.expose()
    for name in ("staged", "resolved", "inflight_dropped",
                 "chunk_stamps_dropped", "ring_overflow"):
        assert "veles_reqledger_%s_total " % name in text
    assert RequestLedger(enabled=False).stage() is None


def test_a_kernel_build_overlapping_a_request_is_its_stall(monkeypatch):
    """The tracker keeps each build's and load's wall window; a resolved
    row names the ones that overlapped it."""
    import time

    from veles_tpu_torch.observe import xla_stats

    tracker = CompileTracker(enabled=True)
    monkeypatch.setattr(xla_stats, "_tracker", tracker)
    ledger = RequestLedger()
    row = ledger.stage(api="a")
    time.sleep(0.01)
    tracker.record_compile("paged_attention.cu", 0.005)
    tracker.record_hit("int8_matmul.cu", 0.002)
    tracker.record_hit("int8_matmul.cu")   # an instant load: no window
    ledger.resolve(row, "completed")
    names = [name for name, _ in row["compile_stalls"]]
    assert names == ["paged_attention.cu", "int8_matmul.cu"]
    assert row["compile_stall_ms"] >= 6.0
    assert tracker.compiles_overlapping(0.0, 1.0) == []


def test_record_paths_hold_no_lock():
    """The overhead guard: the ledger, the serve scope, memscope and the
    metric history carry no lock attribute (their record paths are
    GIL-atomic container operations)."""
    from veles_tpu_torch.observe.memscope import MemScope
    from veles_tpu_torch.observe.servescope import ServeScope

    lock_types = (type(threading.Lock()), type(threading.RLock()))
    for obj in (RequestLedger(), ServeScope(), MemScope(),
                MetricHistory(registry=MetricsRegistry())):
        held = [k for k, v in vars(obj).items()
                if isinstance(v, lock_types)]
        assert held == [], (type(obj).__name__, held)


def _post(url, body, headers):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"}, **headers))
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read().decode())


@pytest.mark.parametrize("paged", [False, True])
def test_generate_api_rows_carry_tenant_trace_and_waterfall(paged):
    """Every POST leaves a row on ``/debug/requests``: the whole
    waterfall (``pool_gated`` on the pool), its tenant and trace id, its
    quant tier, the live dispatches of its admission and chunks, and
    chunk tokens adding up to the budget."""
    from veles_tpu_torch.serving import GenerateAPI

    _, params, table = _weights()
    ledger = RequestLedger()
    api = GenerateAPI(params, torch.from_numpy(table), 4, chunk=2,
                      paged=paged, ledger=ledger, device="cpu",
                      **KW).start()
    try:
        url = "http://127.0.0.1:%d" % api.port
        for i, prompt in enumerate(PROMPTS[:4]):
            body = _post(url + "/generate", {"tokens": prompt},
                         {"X-Veles-Trace": "beef%02d/01" % i,
                          "X-Veles-Tenant": "tenant-%d" % (i % 2)})
            assert len(body["tokens"]) == 6
        payload = _get(url + "/debug/requests?n=8")
    finally:
        api.stop()
    assert payload["inflight"] == [] and payload["resolved_total"] == 4
    want = (["staged", "pool_gated", "admitted", "first_token", "resolved"]
            if paged else ["staged", "admitted", "first_token", "resolved"])
    by_trace = {row["trace"]: row for row in payload["slowest"]}
    assert sorted(by_trace) == ["beef%02d" % i for i in range(4)]
    for trace, row in by_trace.items():
        assert [s for s, _ in row["stages"]] == want
        assert row["tenant"] == "tenant-%d" % (int(trace[4:]) % 2)
        assert row["outcome"] == "completed" and row["quant"] == "bf16"
        assert sum(c[1] for c in row["chunks"]) == 6
        assert row["dispatches"] == {"aot": 0,
                                     "live": 1 + len(row["chunks"])}
        assert row["api"] == "generate-api" and row["breaker_gen"] == 0
        assert (row["pages_reserved"] > 0) == paged


def test_rejected_requests_leave_rows():
    """A request the gate refuses resolves its row ``rejected``."""
    from veles_tpu_torch.serving import GenerateAPI

    _, params, table = _weights()
    ledger = RequestLedger()
    api = GenerateAPI(params, torch.from_numpy(table), 4, chunk=2,
                      ledger=ledger, device="cpu", **KW).start()
    api.health.set_ready(False)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post("http://127.0.0.1:%d/generate" % api.port,
                  {"tokens": [1, 2]}, {})
        assert err.value.code == 503
    finally:
        api.stop()
    (row,) = ledger.resolved()
    assert row["outcome"] == "rejected" and row["error"] == "unready"


def test_restful_api_writes_ledger_rows(monkeypatch, process_ledger):
    """``RESTfulAPI`` opens a row per POST (staged -> resolved, the
    outcome, the trace of its ``restful.request`` span) and serves
    ``/debug/requests``, from the process ledger (set up fresh here)."""
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.observe.reqledger import get_request_ledger
    from veles_tpu_torch.observe.tracing import get_tracer
    from veles_tpu_torch.serving import RESTfulAPI

    monkeypatch.setattr(get_tracer(), "enabled", True)

    api = RESTfulAPI(DummyWorkflow(), port=0, path="/api")

    def feed(data, responder):
        responder["result"] = float(numpy.sum(data))
        responder["event"].set()
    api.feed = feed
    api.requests = []
    ledger = get_request_ledger()
    assert ledger is process_ledger
    before = ledger.resolved_total
    api.initialize()
    try:
        url = "http://127.0.0.1:%d" % api.port
        out = _post(url + "/api", {"input": [1.0, 2.0, 3.5],
                                   "codec": "list"},
                    {"X-Veles-Trace": "cafe01/02"})
        assert out == {"result": 6.5}
        payload = _get(url + "/debug/requests?n=64")
    finally:
        api.stop()
    assert ledger.resolved_total == before + 1
    rows = [r for r in payload["slowest"] if r["api"] == "restful-api"
            and r["trace"] == "cafe01"]
    assert rows and rows[0]["outcome"] == "completed"
    assert rows[0]["prompt_len"] == 3
    assert [s for s, _ in rows[0]["stages"]] == ["staged", "resolved"]
