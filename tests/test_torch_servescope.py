"""The port's serving goodput observatory (veles_tpu_torch/observe/
servescope.py) and the dispatched-work accounting of parallel/decode.py,
against the JAX package on the CPU.

Held equal to the JAX package: the four waste functions bit for bit
(hypothesis over lengths, spans, pages and chunks); the scope's tallies
for the same numpy-seeded traffic through both ``ContinuousDecoder``s
(paged: the JAX side on its fused-kernel route in interpret mode; the
dense slab: equal but ``group_dup``, which the JAX slab books for its
power-of-two padding and the port, adding no duplicate rows, never
does); the autopsy's rule states and incident for the same booked
traffic; and the Perfetto trace and summary ``observe serve-trace``
assembles from the same payload. Port-only: the counts against an
independent count from the request lengths, the families on
``/metrics``, ``/debug/serve`` and ``/healthz``'s cell."""

import json
import urllib.request

import numpy
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from veles_tpu_torch.observe import history as history_mod
from veles_tpu_torch.observe import servescope as scope_mod
from veles_tpu_torch.observe.history import (IncidentRecorder,
                                             MetricHistory,
                                             stop_history_sampler)
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.observe.servescope import (ServeScope,
                                                assemble_serve_trace,
                                                publish_serve_scope,
                                                render_serve_summary,
                                                serve_trace_main)
from veles_tpu_torch.parallel.decode import (admit_waste,
                                             page_overshoot_tokens,
                                             span_overshoot_tokens,
                                             tile_pad_tokens)
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)

torch.set_num_threads(1)

KW = dict(slots=3, max_len=64, n_tokens=7, page_size=8)
PROMPTS = ([1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 1, 2], [3, 1], [2] * 17,
           [1, 2, 3, 4, 5, 6, 7, 8], [5, 6])


@pytest.fixture(autouse=True)
def quiet_history(monkeypatch):
    """The port's metric history pinned to a 30 s cadence for the file,
    and every sampler stopped after each test."""
    monkeypatch.setattr(history_mod, "_history",
                        MetricHistory(registry=MetricsRegistry(),
                                      interval_s=30.0))
    monkeypatch.setattr(history_mod, "_history_built", True)
    yield
    stop_history_sampler()


@pytest.fixture
def fresh_scope(monkeypatch):
    """A fresh process scope for the port (the decoders read it at
    construction)."""
    scope = ServeScope()
    monkeypatch.setattr(scope_mod, "_serve_scope", scope)
    return scope


lens = st.lists(st.integers(0, 300), max_size=8)


@settings(max_examples=60, deadline=None)
@given(bucket=st.integers(0, 512), lens=lens, extra=st.integers(0, 4))
def test_admit_waste_equals_jax(bucket, lens, extra):
    from veles_tpu.parallel.decode import admit_waste as jax_waste

    rows = len(lens) + extra
    assert admit_waste(bucket, lens, rows) == jax_waste(bucket, lens, rows)


@settings(max_examples=60, deadline=None)
@given(lens=lens, span=st.integers(0, 700), chunk=st.integers(0, 16))
def test_span_overshoot_equals_jax_and_the_brute_sum(lens, span, chunk):
    from veles_tpu.parallel.decode import span_overshoot_tokens as jax_fn

    got = span_overshoot_tokens(lens, span, chunk)
    assert got == jax_fn(lens, span, chunk)
    assert got == sum(max(0, span - (n + i)) for n in lens
                      for i in range(1, chunk + 1))


@settings(max_examples=60, deadline=None)
@given(lens=lens, pages=st.integers(0, 40), page_size=st.integers(1, 64),
       chunk=st.integers(0, 16))
def test_page_overshoot_equals_jax(lens, pages, page_size, chunk):
    from veles_tpu.parallel.decode import page_overshoot_tokens as jax_fn

    assert page_overshoot_tokens(lens, pages, page_size, chunk) \
        == jax_fn(lens, pages, page_size, chunk)


@settings(max_examples=60, deadline=None)
@given(lens=lens, page_size=st.integers(1, 64), chunk=st.integers(0, 16))
def test_tile_pad_equals_jax(lens, page_size, chunk):
    from veles_tpu.parallel.decode import tile_pad_tokens as jax_fn

    assert tile_pad_tokens(lens, page_size, chunk) \
        == jax_fn(lens, page_size, chunk)


def _weights():
    from veles_tpu.parallel.transformer_step import (
        init_transformer_params as jax_init)

    rng = numpy.random.RandomState(1)
    jparams = jax_init(rng, 1, 16, 4, 13)
    table = rng.randn(13, 16).astype(numpy.float32) * 0.3
    params = init_transformer_params(numpy.random.RandomState(1), 1, 16,
                                     4, 13, device="cpu")
    return jparams, params, table


def _drive(decoder, chunk=2):
    """All prompts submitted at once, drained lag-1."""
    for prompt in PROMPTS:
        decoder.submit(prompt)
    decoder.drain_pipelined(chunk)


def _tallies(scope):
    return {"waste": dict(scope.waste), "useful": dict(scope.useful),
            "occupancy": scope.occupancy(), "admits": scope.admits,
            "dispatches": scope.dispatches, "collects": scope.collects,
            "dominant": scope.dominant_cause()}


@pytest.mark.parametrize("paged", [False, True])
def test_tallies_of_the_same_traffic_equal_jax(paged, fresh_scope):
    import jax.numpy as jnp
    from veles_tpu.observe.servescope import get_serve_scope as jax_scope
    from veles_tpu.serving import ContinuousDecoder as JaxDecoder
    from veles_tpu_torch.serving import ContinuousDecoder

    jparams, params, table = _weights()
    jscope = jax_scope()
    jscope.reset()
    _drive(JaxDecoder(jparams, jnp.asarray(table), 4, paged=paged,
                      paged_kernel=True if paged else None, **KW))
    jax = _tallies(jscope)
    jscope.reset()
    dec = ContinuousDecoder(params, torch.from_numpy(table), 4,
                            paged=paged, device="cpu", **KW)
    _drive(dec)
    port = _tallies(fresh_scope)
    assert port["waste"]["group_dup"] == 0
    if not paged:
        # the JAX slab pads its groups of 3 and 2 to 4 and 2 rows
        assert jax["waste"]["group_dup"] > 0
        jax["waste"]["group_dup"] = 0
        jax["dominant"] = port["dominant"]
    assert port == jax
    assert port["waste"]["page_overshoot"] == 0
    assert (port["waste"]["tile_pad"] > 0) == paged
    assert (port["waste"]["span_overshoot"] > 0) == (not paged)
    assert port["useful"]["decode"] == dec.tokens_out


def _booked_dispatch_lens(decoder):
    """Wrap ``_note_dispatch`` to keep each dispatch's (n, live lengths)."""
    seen = []
    real = decoder._note_dispatch

    def wrapper(n, lens, elapsed):
        seen.append((n, list(lens)))
        return real(n, lens, elapsed)
    decoder._note_dispatch = wrapper
    return seen


@pytest.mark.parametrize("paged", [False, True])
def test_counts_equal_an_independent_count(paged, fresh_scope):
    """``tile_pad`` (pool) and ``span_overshoot`` (slab) equal a count from
    the request lengths, ``dead_slot`` the empty lane-steps, useful decode
    tokens the tokens delivered, prefill the prompt positions."""
    from veles_tpu_torch.serving import ContinuousDecoder

    _, params, table = _weights()
    dec = ContinuousDecoder(params, torch.from_numpy(table), 4,
                            paged=paged, device="cpu", **KW)
    seen = _booked_dispatch_lens(dec)
    _drive(dec)
    waste = fresh_scope.waste
    ps, tile = KW["page_size"], dec.tile
    pad = span = dead = 0
    for n, live in seen:
        dead += (KW["slots"] - len(live)) * n
        for length in live:
            for i in range(1, n + 1):
                pad += -(-(length + i) // ps) * ps - (length + i)
        top = min(-(-(max(live) + n) // tile) * tile, KW["max_len"])
        span += sum(max(0, top - (length + i)) for length in live
                    for i in range(1, n + 1))
    assert waste["dead_slot"] == dead
    assert waste["tile_pad"] == (pad if paged else 0)
    assert waste["span_overshoot"] == (0 if paged else span)
    assert fresh_scope.useful["decode"] == dec.tokens_out \
        == KW["n_tokens"] * len(PROMPTS)
    assert fresh_scope.useful["prefill"] == sum(map(len, PROMPTS))
    assert waste["group_dup"] == 0
    rows = fresh_scope.slot_rows()
    assert len(rows) == len(PROMPTS)
    assert all(r["retire"] is not None and r["first"] is not None
               for r in rows)


def _book(scope, rng):
    """A seeded stream of bookings (what a decoder feeds)."""
    now = 100.0
    for _ in range(40):
        now += float(rng.rand())
        scope.note_admit("cold", 16, 2, 2, 20, 12, 0, 0.01, now=now)
        scope.note_dispatch(4, 8, int(rng.randint(1, 9)),
                            int(rng.randint(0, 400)), 0.02, now=now + 0.1,
                            paged=True, pages=3, kernel=True)
        scope.note_collect(16, int(rng.randint(0, 17)), 0.001,
                           now=now + 0.2)
        scope.note_idle(0.05, now=now + 0.3)
    scope.inject_waste("group_dup", 5000, now=now)
    return now


def test_autopsy_rules_and_incident_equal_jax(tmp_path):
    from veles_tpu.observe.history import (
        IncidentRecorder as JaxRecorder, MetricHistory as JaxHistory)
    from veles_tpu.observe.metrics import MetricsRegistry as JaxRegistry
    from veles_tpu.observe.servescope import ServeScope as JaxScope

    out = {}
    for label, scope, history in (
            ("jax", JaxScope(), JaxHistory(
                registry=JaxRegistry(), incidents=JaxRecorder(
                    cooldown_s=0, directory=str(tmp_path / "jax")))),
            ("port", ServeScope(), MetricHistory(
                registry=MetricsRegistry(), incidents=IncidentRecorder(
                    cooldown_s=0, directory=str(tmp_path / "port"))))):
        rng = numpy.random.RandomState(5)
        paths = []
        for i in range(6):
            now = _book(scope, rng) + 1000 * i
            paths.append(scope.autopsy_tick(history, now=now))
        doc = history.incidents.last_doc
        out[label] = ([bool(p) for p in paths], scope.goodput_summary(),
                      dict(scope.waste),
                      [r.state() for r in history.rules],
                      {k: doc["trigger"][k] for k in
                       ("rule", "value", "labels", "dominant_cause",
                        "waste", "waste_window", "occupancy")},
                      doc["leading_indicator"])
    assert out["port"] == out["jax"]
    assert out["port"][4]["rule"] == "serve_waste"
    assert out["port"][4]["dominant_cause"] in out["port"][2]


def test_publish_families_after_traffic_only():
    registry = MetricsRegistry(enabled=True)
    scope = ServeScope()
    publish_serve_scope(registry, scope)
    assert not registry.expose().strip()
    _book(scope, numpy.random.RandomState(0))
    publish_serve_scope(registry, scope)
    text = registry.expose()
    for needle in ('veles_serve_goodput_seconds_total{component="idle"}',
                   'veles_serve_token_waste_total{cause="tile_pad"}',
                   'veles_serve_tokens_useful_total{phase="decode"}',
                   "veles_serve_goodput_fraction ",
                   "veles_serve_slot_occupancy ",
                   "veles_serve_waste_share "):
        assert needle in text, needle


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read().decode())


def _post(url, body, headers):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"}, **headers))
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())


def test_debug_serve_and_the_trace_equal_jax(fresh_scope, tmp_path,
                                            capsys):
    """``/debug/serve`` after a paged burst: slot rows and ledger rows;
    ``observe serve-trace`` on the saved payload writes the trace the JAX
    package assembles from it (one row per slot) and prints its
    summary."""
    from veles_tpu.observe.servescope import (
        assemble_serve_trace as jax_assemble,
        render_serve_summary as jax_summary)
    from veles_tpu_torch.__main__ import main
    from veles_tpu_torch.observe.reqledger import RequestLedger
    from veles_tpu_torch.observe.trace_export import span_tree
    from veles_tpu_torch.serving import GenerateAPI

    _, params, table = _weights()
    api = GenerateAPI(params, torch.from_numpy(table), 4, chunk=2,
                      paged=True, ledger=RequestLedger(), device="cpu",
                      **KW).start()
    try:
        url = "http://127.0.0.1:%d" % api.port
        for i, prompt in enumerate(PROMPTS[:4]):
            _post(url + "/generate", {"tokens": prompt},
                  {"X-Veles-Trace": "aa%02d/01" % i})
        payload = _get(url + "/debug/serve")
        health = _get(url + "/healthz")
    finally:
        api.stop()
    assert payload["kind"] == "servescope"
    assert len(payload["slots"]) == 4
    assert {r["trace"] for r in payload["slots"]} \
        == {"aa%02d" % i for i in range(4)}
    assert payload["waste"]["tile_pad"] > 0
    assert set(health["servescope"]) >= {"goodput", "occupancy",
                                         "waste_share"}
    trace = assemble_serve_trace(payload)
    assert trace == jax_assemble(payload)
    assert render_serve_summary(payload, trace) \
        == jax_summary(payload, jax_assemble(payload))
    meta = [e for e in trace["traceEvents"] if e.get("ph") == "M"]
    (slots_pid,) = [e["pid"] for e in meta
                    if e["name"] == "process_name"
                    and e["args"]["name"].startswith("slots")]
    slots = {e["tid"] for e in meta if e["name"] == "thread_name"
             and e["pid"] == slots_pid}
    assert slots == {r["slot"] for r in payload["slots"]}
    trees = span_tree(trace)
    for i in range(4):
        tree = trees["aa%02d" % i]
        assert any(s.startswith("occ-") and p.startswith("req-")
                   for s, p in tree.items() if p)
    saved = tmp_path / "serve.json"
    saved.write_text(json.dumps(payload))
    out = tmp_path / "serve.trace.json"
    assert main(["observe", "serve-trace", str(saved), "-o",
                 str(out)]) == 0
    printed = capsys.readouterr().out
    assert "across %d slot row(s)" % len(slots) in printed
    assert json.loads(out.read_text()) == trace
    assert serve_trace_main(str(tmp_path / "missing.json")) == 1
