"""The port's tuning cache and autotuners (veles_tpu_torch/ops/gemm.py,
quant.py, paged_attention.py) and the device benchmark (ops/benchmark.py)
on the CPU.

The races time kernels on the card, so here the timer (``gemm._race``)
and the device check are stubbed, and a made-up card name stands in for
``device_tag``: the cache's hygiene (the JAX package's
``tests/test_ops.py::TestAutotuneCacheHygiene``), its round trip and the
CLI (``tests/test_som_alexnet.py::TestAutotuneCLI``), the device keying,
the ``"tuned"`` gate and the routes it and the ``int8:``/``pgatt:``
verdicts choose. The helpers the JAX package and the port share by name
(``_sane_entry``, ``_size_bucket``) are held against the JAX package's.
Without a card, every autotuner raises."""

import json
import logging
import math
import os

import numpy
import pytest
import torch

from veles_tpu.ops import gemm as jgemm
from veles_tpu_torch.__main__ import main as cli_main
from veles_tpu_torch.core.config import root
from veles_tpu_torch.ops import gemm, paged_attention, quant
from veles_tpu_torch.ops.benchmark import device_benchmark

torch.set_num_threads(1)

CARD = "Fake Card 80GB sm_90"
OTHER = "Other Card 40GB sm_80"
CPU = torch.device("cpu")


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    """A fresh cache file, a made-up card for the keys, no warning
    given yet."""
    path = str(tmp_path / "pallas_tuning.json")
    monkeypatch.setattr(root.common.engine, "pallas_autotune_cache", path,
                        raising=False)
    monkeypatch.setattr(gemm, "_tuning_cache", None)
    monkeypatch.setattr(gemm, "_insane_warned", False)
    monkeypatch.setattr(gemm, "device_tag", lambda device=None: CARD)
    return path


@pytest.fixture
def stub_race(monkeypatch):
    """``_race`` calls every candidate once (so the kernels' plain
    versions run) and returns the times ``stub_race.times`` names (by
    candidate, else 2e-4) and ``stub_race.plain``; the device check
    returns the CPU."""
    class Stub:
        times = {}
        plain = 3e-4
        calls = []

    def race(kernels, plain, repeats=gemm.MIN_REPEATS):
        Stub.calls.append((list(kernels), repeats))
        for fn in list(kernels.values()) + [plain]:
            fn()
        return ({name: Stub.times.get(name, 2e-4) for name in kernels},
                Stub.plain)

    monkeypatch.setattr(gemm, "_race", race)
    monkeypatch.setattr(gemm, "_autotune_device", lambda device=None: CPU)
    Stub.calls = []
    return Stub


def _write(path, cache):
    with open(path, "w") as fout:
        json.dump(cache, fout)


def _bf16(m, k):
    return torch.zeros((m, k), dtype=torch.bfloat16)


# -- hygiene (tests/test_ops.py::TestAutotuneCacheHygiene) --------------------

def test_poisoned_rows_dropped_at_load_and_file_cleaned(cache_file, caplog):
    poisoned = {
        CARD + "|bfloat16:10": {"blocks": [256], "seconds": 9.4e-05,
                                "xla_seconds": -0.000107,
                                "beats_xla": True},
        CARD + "|bfloat16:11": {"blocks": [128], "seconds": 2e-4,
                                "xla_seconds": 3e-4, "beats_xla": True},
        CARD + "|int8:1024x4096": {"use_pallas": True, "splits": 4,
                                   "seconds": 0.0},
    }
    _write(cache_file, poisoned)
    with caplog.at_level(logging.WARNING, logger="gemm.autotune"):
        cache = gemm._load_cache()
    assert set(cache) == {CARD + "|bfloat16:11"}
    assert set(json.load(open(cache_file))) == {CARD + "|bfloat16:11"}
    warnings = [r for r in caplog.records
                if "physically impossible" in r.getMessage()]
    assert len(warnings) == 1


def test_dropped_bucket_runs_the_defaults(cache_file):
    _write(cache_file, {CARD + "|bfloat16:10": {
        "blocks": [128], "seconds": -1.0, "beats_xla": True}})
    a = _bf16(1024, 1024)
    assert gemm._tuned_beats_xla(a, a) is False
    assert gemm._tuned_blocks(1024, 1024, 1024, torch.bfloat16, CPU) \
        == gemm._DEFAULT_BLOCKS == (0,)


def test_persist_rejects_insane_rows(cache_file):
    gemm._persist_cache({
        "good": {"blocks": [128], "seconds": 1e-4, "xla_seconds": 2e-4,
                 "beats_xla": True},
        "negative": {"blocks": [128], "seconds": -1e-4},
        "zero": {"blocks": [128], "seconds": 0.0},
        "nan": {"blocks": [128], "seconds": float("nan")},
        "inf": {"blocks": [128], "xla_seconds": float("inf")},
        "not-a-dict": 7,
    })
    assert set(json.load(open(cache_file))) == {"good"}


@pytest.mark.parametrize("entry", [
    {"seconds": 1e-5, "xla_seconds": 2e-5}, {"blocks": [1, 2, 3]},
    {"seconds": -1e-5}, {"xla_seconds": 0}, {"seconds": True}, [1, 2],
    {"seconds": float("nan")}, {"xla_seconds": "1"}, 7],
    ids=lambda e: repr(e)[:24])
def test_sane_entry_matches_jax(entry):
    assert gemm._sane_entry(entry) == jgemm._sane_entry(entry)


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (512, 512, 1024),
                                   (784, 4096, 4096), (4096, 4096, 784),
                                   (512, 1000, 4096), (8, 3072, 1024)])
def test_size_bucket_matches_jax(shape):
    assert gemm._size_bucket(*shape) == jgemm._size_bucket(*shape)


def test_a_torn_or_foreign_file_reads_as_empty(cache_file):
    for text in ("{not json", "[1, 2]"):
        with open(cache_file, "w") as fout:
            fout.write(text)
        gemm._tuning_cache = None
        assert gemm._load_cache() == {}


def test_a_new_path_is_read_anew(cache_file, tmp_path, monkeypatch):
    """The smoke points the cache at a fresh file for its earlier
    phases: a changed path must not keep serving the old verdicts."""
    _write(cache_file, {CARD + "|bfloat16:11": {
        "blocks": [256], "seconds": 1e-4, "xla_seconds": 2e-4,
        "beats_xla": True}})
    assert gemm._tuned_blocks(784, 4096, 4096, torch.bfloat16, CPU) \
        == (256,)
    other = str(tmp_path / "empty.json")
    monkeypatch.setattr(root.common.engine, "pallas_autotune_cache", other)
    assert gemm._tuned_blocks(784, 4096, 4096, torch.bfloat16, CPU) \
        == (0,)


# -- device keying and the "tuned" gate ----------------------------------------

def _verdict(beats, blocks=(256,)):
    return {"blocks": list(blocks), "seconds": 1e-4, "xla_seconds": 2e-4,
            "beats_xla": beats}


def test_an_entry_of_another_card_is_ignored(cache_file):
    kind = gemm._gemm_kind(784, 4096, 4096, torch.bfloat16)
    _write(cache_file, {OTHER + "|" + kind: _verdict(True, (128,))})
    a, b = _bf16(784, 4096), _bf16(4096, 4096)
    assert gemm._tuned_beats_xla(a, b) is False
    assert gemm._tuned_blocks(784, 4096, 4096, torch.bfloat16, CPU) == (0,)
    assert quant._tuned_decision(8, 1024, 3072, CPU) == (True, None)
    _write(cache_file, {OTHER + "|" + kind: _verdict(True, (128,)),
                        CARD + "|" + kind: _verdict(False, (256,))})
    gemm._tuning_cache = None
    assert gemm._tuned_beats_xla(a, b) is False
    assert gemm._tuned_blocks(784, 4096, 4096, torch.bfloat16, CPU) \
        == (256,)


@pytest.mark.parametrize("beats", [True, False])
def test_tuned_gate_reads_beats_xla(cache_file, monkeypatch, beats):
    """``matmul(use_pallas="tuned")`` takes K5 where the gate holds and
    this card's verdict says ``beats_xla``; True always, False never."""
    kind = gemm._gemm_kind(784, 4096, 4096, torch.bfloat16)
    _write(cache_file, {CARD + "|" + kind: _verdict(beats)})
    routed = []
    monkeypatch.setattr(gemm, "_kernel_eligible", lambda a, b: True)
    monkeypatch.setattr(gemm, "blocked_matmul",
                        lambda a, b, out_dtype=torch.float32:
                        routed.append(tuple(a.shape)) or
                        gemm._plain_product(a, b).to(out_dtype))
    a = torch.randn(784, 4096)
    b = torch.randn(4096, 4096)
    for use in ("tuned", True, False):
        routed.clear()
        out = gemm.matmul(a, b, out_dtype=torch.float32, use_pallas=use)
        assert out.shape == (784, 4096)
        want = beats if use == "tuned" else use
        assert routed == ([(784, 4096)] if want else [])


def test_tuned_on_a_cpu_tensor_runs_the_plain_version(cache_file,
                                                      monkeypatch):
    kind = gemm._gemm_kind(512, 512, 512, torch.bfloat16)
    _write(cache_file, {CARD + "|" + kind: _verdict(True)})
    monkeypatch.setattr(gemm, "blocked_matmul",
                        lambda *a, **k: pytest.fail("kernel route taken"))
    a = torch.randn(512, 512)
    out = gemm.matmul(a, a, precision_level=2, use_pallas="tuned")
    torch.testing.assert_close(out, a @ a, rtol=1e-5, atol=1e-4)


def test_kernels_take_the_tuned_width_and_check_bn(cache_file):
    """K5 and K6 read ``bn`` from the bucket (their CPU plain versions
    ignore it); a width outside 0/128/256 raises before anything
    runs."""
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    bias = torch.randn(16)
    for bn in (None, 0, 128, 256):
        torch.testing.assert_close(gemm.blocked_matmul(a, b, bn=bn),
                                   a @ b, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(
            gemm.dense_epilogue(a, b, bias, "tanh", bn=bn),
            gemm._dense_epilogue_plain(a, b, bias, "tanh"))
    for bad in (64, 512, -1):
        with pytest.raises(ValueError, match="bn must be one of"):
            gemm.blocked_matmul(a, b, bn=bad)
        with pytest.raises(ValueError, match="bn must be one of"):
            gemm.dense_epilogue(a, b, bias, bn=bad)
    _write(cache_file, {CARD + "|" + gemm._gemm_kind(
        64, 16, 32, torch.bfloat16): _verdict(True, (64,))})
    gemm._tuning_cache = None
    # a width the kernels cannot take is no verdict
    assert gemm._tuned_blocks(64, 16, 32, torch.bfloat16, CPU) == (0,)


# -- round trips ----------------------------------------------------------------

def test_autotune_matmul_round_trip(cache_file, stub_race):
    """tests/test_som_alexnet.py::TestAutotuneCLI::test_cache_roundtrip:
    both widths race on bf16, the faster persists with both times and
    the verdict, and a fresh load reads it back."""
    stub_race.times = {128: 2e-4, 256: 1e-4}
    blocks = gemm.autotune_matmul(512, 512, 1024, iters=3)
    assert blocks == (256,)
    assert stub_race.calls == [([128, 256], 3)]
    gemm._tuning_cache = None
    assert gemm._tuned_blocks(512, 512, 1024, torch.bfloat16, CPU) \
        == (256,)
    entry = json.load(open(cache_file))[
        CARD + "|" + gemm._gemm_kind(512, 512, 1024, torch.bfloat16)]
    assert entry["seconds"] == 1e-4 and entry["xla_seconds"] == 3e-4
    assert entry["beats_xla"] is True and entry["shape"] == [512, 512, 1024]
    # the f32 tile has one shape: only its verdict is tuned
    stub_race.calls.clear()
    assert gemm.autotune_matmul(512, 512, 1024, dtype=torch.float32) \
        == (0,)
    assert stub_race.calls == [([0], gemm.MIN_REPEATS)]


@pytest.mark.parametrize("kernel,plain,beats", [
    (1e-4, 3e-4, True), (2.95e-4, 3e-4, False), (4e-4, 3e-4, False)],
    ids=["clear-win", "inside-the-margin", "loss"])
def test_the_margin(cache_file, stub_race, kernel, plain, beats):
    stub_race.times = {128: kernel, 256: kernel}
    stub_race.plain = plain
    gemm.autotune_matmul(784, 4096, 4096)
    a, b = _bf16(784, 4096), _bf16(4096, 4096)
    assert gemm._tuned_beats_xla(a, b) is beats


def test_an_impossible_timing_is_not_persisted(cache_file, stub_race):
    stub_race.times = {128: -1e-4, 256: -2e-4}
    gemm.autotune_matmul(512, 512, 1024)
    assert not os.path.exists(cache_file) \
        or json.load(open(cache_file)) == {}
    assert gemm._tuned_blocks(512, 512, 1024, torch.bfloat16, CPU) == (0,)


@pytest.fixture
def int8_on_cpu(monkeypatch):
    """K2's launch replaced by its plain version, a 132-SM card."""
    monkeypatch.setattr(quant, "sm_count", lambda device: 132)
    monkeypatch.setattr(quant, "_int8_kernel",
                        lambda x, q, scale, splits=None:
                        quant._int8_matmul_plain(x, q, scale))


def test_int8_round_trip_and_route(cache_file, stub_race, int8_on_cpu):
    """``int8:KxN``: the split candidates race, the faster side wins (the
    JAX package's rule), and ``_tuned_decision`` reads the verdict back
    inside the decode row bound."""
    candidates = quant.int8_split_candidates(8, 1024, 3072, 132)
    assert candidates[0] == 1 and len(set(candidates)) == len(candidates)
    assert quant._tuned_decision(8, 1024, 3072, CPU) == (True, None)
    assert quant._tuned_decision(257, 1024, 3072, CPU) == (False, None)
    stub_race.times = {want: 5e-5 + 1e-6 * i
                       for i, want in enumerate(candidates)}
    stub_race.plain = 1e-4
    decision = quant.autotune_int8(8, 1024, 3072)
    assert decision["use_pallas"] is True
    assert decision["splits"] == candidates[0]
    assert len(decision["measured"]) == len(candidates) + 1
    gemm._tuning_cache = None
    assert quant._tuned_decision(8, 1024, 3072, CPU) \
        == (True, candidates[0])
    assert quant._tuned_decision(300, 1024, 3072, CPU) == (False, None)
    stub_race.plain = 1e-5
    decision = quant.autotune_int8(8, 1024, 3072)
    assert decision["use_pallas"] is False and decision["splits"] is None
    assert quant._tuned_decision(8, 1024, 3072, CPU) == (False, None)
    assert set(json.load(open(cache_file))) == {CARD + "|int8:1024x3072"}


def test_int8_split_override_keeps_the_bounds():
    """The verdict's split count replaces the plan's request, inside the
    plan's bounds (whole 16-row steps, splits x rows <= 512)."""
    sms = 132
    for m, k, n in ((8, 1024, 3072), (8, 4096, 1024), (256, 1024, 3072),
                    (8, 37, 100)):
        steps = -(-k // quant.INT8_STEP_K)
        for want in (1, 2, 3, 7, 64, 1000):
            tiles, splits, slice_rows = quant._int8_plan(m, k, n, sms, want)
            assert slice_rows % quant.INT8_STEP_K == 0
            assert slice_rows * (splits - 1) < k <= slice_rows * splits
            assert splits * m <= max(quant.INT8_MAX_SPLIT_ROWS, m)
            assert splits <= steps
        assert quant._int8_plan(m, k, n, sms, None) \
            == quant._int8_plan(m, k, n, sms)
    for want in quant.int8_split_candidates(8, 1024, 3072, sms):
        assert quant._int8_plan(8, 1024, 3072, sms, want)[1] in (
            1, 2, 4, 7, 8, 16, 32, 64)


def test_pgatt_round_trip(cache_file, stub_race, monkeypatch):
    """``pgatt:PSxD``: the pages-per-split candidates race against the
    gather attend; the verdict picks K1's and K3's plan, never the
    route."""
    monkeypatch.setattr(paged_attention, "_paged_launch",
                        lambda q, k, v, t, lens, ps, pages:
                        paged_attention._paged_attend_plain(
                            q, k, v, t, lens, ps))
    stub_race.times = {1: 3e-5, 2: 2e-5, 4: 4e-5}
    stub_race.plain = 1e-4
    assert paged_attention._tuned_pages(16, 8, CPU) is None
    best = paged_attention.autotune_paged_attention(16, 8, heads=2,
                                                    slots=3)
    assert best == 2
    assert stub_race.calls[-1][0] == [1, 2, 4]
    gemm._tuning_cache = None
    assert paged_attention._tuned_pages(16, 8, CPU) == 2
    assert paged_attention._tuned_pages(16, 16, CPU) is None
    entry = json.load(open(cache_file))[CARD + "|pgatt:16x8"]
    assert entry["beats_xla"] is True and entry["blocks"] == [2]


def test_paged_plan_override():
    sms = 132
    assert paged_attention.paged_page_candidates(4) == [1, 2, 4]
    assert paged_attention.paged_page_candidates(6) == [1, 2, 4, 6]
    assert paged_attention.paged_page_candidates(1) == [1]
    for pages in (1, 2, 4, 6, 9):
        got, splits, _ = paged_attention._paged_plan(8, 16, 64, 6, 128, sms,
                                                     pages)
        assert got == min(pages, 6) and splits == -(-6 // got)
    # the split bound holds whatever the verdict says
    got, splits, _ = paged_attention._paged_plan(1, 1, 64, 1000, 16, sms, 1)
    assert splits <= paged_attention.PAGED_MAX_SPLITS
    assert paged_attention._paged_plan(8, 16, 64, 6, 128, sms, None) \
        == paged_attention._paged_plan(8, 16, 64, 6, 128, sms)


# -- the CLI --------------------------------------------------------------------

def test_cli_entry(cache_file, stub_race, capsys, tmp_path):
    """``python -m veles_tpu_torch autotune``: one JSON line a shape, the
    two times beside the verdict, exit 0 when every verdict persisted;
    ``--cache`` names the file."""
    path = str(tmp_path / "named.json")
    stub_race.times = {128: 1e-4, 256: 1.5e-4}
    assert cli_main(["autotune", "512x512x1024,784x4096x4096",
                     "--cache", path]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    assert [line["shape"] for line in lines] == [[512, 512, 1024],
                                                 [784, 4096, 4096]]
    for line in lines:
        assert line["blocks"] == [128] and line["persisted"]
        assert math.isclose(line["kernel_ms"], 0.1)
        assert math.isclose(line["plain_ms"], 0.3)
        assert line["verdict"] is True and line["device"] == CARD
        assert line["cache"] == path
    assert len(json.load(open(path))) == 2


def test_cli_int8_and_paged_attention(cache_file, stub_race, capsys,
                                      monkeypatch, int8_on_cpu):
    monkeypatch.setattr(paged_attention, "_paged_launch",
                        lambda q, k, v, t, lens, ps, pages:
                        paged_attention._paged_attend_plain(
                            q, k, v, t, lens, ps))
    assert cli_main(["autotune", "8x256x384,16x64x128", "--int8"]) == 0
    assert cli_main(["autotune", "16x8", "--paged-attention"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    assert [line["key"] for line in lines] == [
        "int8:256x384", "int8:64x128", "pgatt:16x8"]
    assert all(line["persisted"] for line in lines)
    assert lines[0]["verdict"] is True and lines[0]["splits"] is not None
    assert lines[2]["pages"] == 1
    assert set(json.load(open(cache_file))) == {
        CARD + "|int8:256x384", CARD + "|int8:64x128",
        CARD + "|pgatt:16x8"}


def test_cli_exits_1_when_nothing_persisted(cache_file, stub_race,
                                            monkeypatch, capsys):
    monkeypatch.setattr(gemm, "_persist_cache", lambda cache: None)
    assert cli_main(["autotune", "512x512x1024"]) == 1
    assert json.loads(capsys.readouterr().out)["persisted"] is False


# -- without a card -------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: gemm.autotune_matmul(512, 512, 1024),
    lambda: quant.autotune_int8(8, 1024, 3072),
    lambda: paged_attention.autotune_paged_attention(128, 64),
    lambda: cli_main(["autotune", "512x512x1024"]),
    lambda: gemm.autotune_matmul(512, 512, 1024, device="cpu")],
    ids=["matmul", "int8", "paged", "cli", "cpu-asked"])
def test_autotune_without_a_card_raises(cache_file, call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the race would run")
    with pytest.raises(RuntimeError, match="autotune measures the CUDA "
                                           "card"):
        call()
    assert not os.path.exists(cache_file)


# -- the device benchmark -------------------------------------------------------

def test_device_benchmark_gives_a_positive_finite_power():
    """The port's contract: a positive, finite power (not the ratio of
    two runs, which depends on the host's load)."""
    power = device_benchmark(size=64, depth=2, iters=2, device="cpu")
    assert power > 0 and math.isfinite(power)


def test_device_benchmark_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_benchmark(size=64)


def test_the_chain_is_the_jax_packages():
    """One link of the chain, ``x @ x / size`` in bf16, against the JAX
    package's arithmetic on the same bf16 input (within bf16's
    rounding)."""
    import jax.numpy as jnp
    x = numpy.random.RandomState(0).rand(32, 32).astype(numpy.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = (torch.matmul(xb, xb) / 32).float().numpy()
    jx = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    want = numpy.asarray(
        (jnp.matmul(jx, jx, preferred_element_type=jnp.float32)
         .astype(jnp.bfloat16) / jnp.float32(32)), numpy.float32)
    numpy.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
