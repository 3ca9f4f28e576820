"""The port's bench artifacts and regression gate
(veles_tpu_torch/observe/regress.py) on the CPU against the JAX package.

``load_bench`` gives equal keys and notes on every committed
``BENCH_*.json`` (the truncated r05 among them, recovered by the
scanning parser); ``compare`` gives equal findings across every pair of
them and across seeded edits; the ``observe regress`` CLI's exit codes
0, 1 and 2 are equal. The writer's artifacts verify in both packages,
and their device fingerprint is torch's."""

import glob
import itertools
import json
import os

import pytest

from veles_tpu.observe import regress as jreg
from veles_tpu.observe.trace_export import main as jax_observe
from veles_tpu_torch.observe import regress as treg
from veles_tpu_torch.observe.trace_export import main as observe_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHES = sorted(os.path.basename(path) for path in glob.glob(
    os.path.join(REPO, "BENCH_*.json")))


@pytest.mark.parametrize("name", BENCHES)
def test_load_bench_matches_jax(name):
    path = os.path.join(REPO, name)
    ours, our_info = treg.load_bench(path)
    theirs, their_info = jreg.load_bench(path)
    assert ours == theirs
    assert our_info == their_info
    assert ours, name
    if name == "BENCH_r05.json":
        assert our_info["recovered"] is True


@pytest.mark.parametrize("old,new", list(itertools.combinations(
    BENCHES, 2)))
def test_compare_matches_jax_across_artifacts(old, new):
    a = treg.load_bench(os.path.join(REPO, old))[0]
    b = treg.load_bench(os.path.join(REPO, new))[0]
    for first, second in ((a, b), (b, a)):
        ours = treg.compare(first, second)
        assert ours == jreg.compare(first, second)
        assert treg.regressions(ours) == jreg.regressions(ours)


@pytest.mark.parametrize("edit", [
    {"capacity_sustained_tokens_per_sec": 0.85},
    {"decode_continuous_ttft_p95_ms": 1.3},
    {"governor_transitions": 3.0},
    {"serve_waste_share": 1.5},
    {"hbm_owner_kv_pool_bytes": 1.2},
    {"serve_goodput_fraction": 0.7},
    {"elastic_failover_ms": 0.5},
    {"x_tokens_per_sec": 0.8, "x_spread": 0.25}])
def test_compare_directions_match_jax(edit):
    old = {"capacity_sustained_tokens_per_sec": 1000.0,
           "decode_continuous_ttft_p95_ms": 10.0,
           "governor_transitions": 2.0, "serve_waste_share": 0.1,
           "hbm_owner_kv_pool_bytes": 1e9,
           "serve_goodput_fraction": 0.9, "elastic_failover_ms": 40.0,
           "x_tokens_per_sec": 50.0, "config": "a", "flag": True,
           "zero_ms": 0.0}
    new = dict(old)
    for key, factor in edit.items():
        new[key] = old.get(key, 1.0) * factor if key in old else factor
    new.pop("zero_ms")
    new["brand_new_ms"] = 1.0
    ours = treg.compare(old, new, allow_missing=("zero_ms",))
    assert ours == jreg.compare(old, new, allow_missing=("zero_ms",))


@pytest.mark.parametrize("text", [
    '{"a_ms": 1.5, "b": true, "c": null, "d": "x", "e": -2e3, "f": .5',
    '"trunc": 1, "tail_tokens_per_sec": 321.5}', '', 'not json at all'])
def test_recover_keys_matches_jax(text):
    assert treg.recover_keys(text) == jreg.recover_keys(text)


def test_writer_artifacts_verify_in_both_packages(tmp_path):
    path = str(tmp_path / "bench.json")
    artifact = treg.BenchArtifact(path, meta={"note": "cpu"})
    artifact.update({"a_tokens_per_sec": 100.0})
    artifact.update({"b_step_ms": 2.5})
    for module in (treg, jreg):
        keys, info = module.load_bench(path)
        assert keys == {"a_tokens_per_sec": 100.0, "b_step_ms": 2.5}
        assert info["sidecar"] is True and info["keys_intact"] is True
    doc = json.loads(open(path).read())
    assert doc["device"]["backend"] in ("cuda", "cpu")
    assert set(doc["device"]) == {"backend", "device_kind",
                                  "device_count", "torch"}
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
    with open(path, "a") as fout:
        fout.write(" ")
    assert treg.verify_sidecar(path) is jreg.verify_sidecar(path) is False


def test_device_fingerprint_reads_torch():
    import torch

    fingerprint = treg.device_fingerprint()
    assert fingerprint["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert fingerprint["backend"] == "cpu"
        assert fingerprint["device_count"] == 1


def _seeded(tmp_path, name, keys, tamper=False, stale_sidecar=False):
    path = str(tmp_path / name)
    treg.BenchArtifact(path).update(keys)
    if tamper:
        doc = json.loads(open(path).read())
        doc["keys"]["a_tokens_per_sec"] = 1.0
        with open(path, "w") as fout:
            json.dump(doc, fout)
    if stale_sidecar:
        with open(path + ".sha256", "w") as fout:
            fout.write("0" * 64 + "  " + name + "\n")
    return path


@pytest.mark.parametrize("case", ["clean", "capacity_loss", "time_up",
                                  "missing", "unreadable", "tampered",
                                  "stale_sidecar", "empty", "r05_self",
                                  "json"])
def test_cli_exit_codes_match_jax(case, tmp_path, capsys):
    base = {"a_tokens_per_sec": 100.0, "b_step_ms": 2.0,
            "capacity_sustained_tokens_per_sec": 1000.0}
    old = _seeded(tmp_path, "old.json", base)
    extra = []
    if case == "clean":
        new = _seeded(tmp_path, "new.json", base)
    elif case == "capacity_loss":
        new = _seeded(tmp_path, "new.json", dict(
            base, capacity_sustained_tokens_per_sec=850.0))
    elif case == "time_up":
        new = _seeded(tmp_path, "new.json", dict(base, b_step_ms=3.0))
    elif case == "missing":
        new = _seeded(tmp_path, "new.json", {"a_tokens_per_sec": 100.0})
    elif case == "unreadable":
        new = str(tmp_path / "nope.json")
    elif case == "tampered":
        new = _seeded(tmp_path, "new.json", base, tamper=True)
    elif case == "stale_sidecar":
        new = _seeded(tmp_path, "new.json", base, stale_sidecar=True)
    elif case == "empty":
        old = str(tmp_path / "empty.json")
        with open(old, "w") as fout:
            fout.write("{}")
        new = _seeded(tmp_path, "new.json", base)
    elif case == "r05_self":
        old = new = os.path.join(REPO, "BENCH_r05.json")
    else:
        new = _seeded(tmp_path, "new.json", dict(base, b_step_ms=9.0))
        extra = ["--json"]
    argv = ["regress", old, new] + extra
    ours = observe_main(argv)
    our_out = capsys.readouterr().out
    theirs = jax_observe(argv)
    their_out = capsys.readouterr().out
    assert ours == theirs
    assert our_out == their_out
    expected = {"clean": 0, "capacity_loss": 1, "time_up": 1,
                "missing": 1, "unreadable": 2, "tampered": 2,
                "stale_sidecar": 0, "empty": 2, "r05_self": 0, "json": 1}
    assert ours == expected[case]
    if case == "capacity_loss":
        assert "capacity_sustained_tokens_per_sec" in our_out
