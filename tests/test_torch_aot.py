"""The port's AOT bundles (veles_tpu_torch/aot/) on the CPU, held against
the JAX package's (veles_tpu/aot/) at tests/test_aot.py's model (HEADS 4,
EMBED 16, BLOCKS 2, VOCAB 32, seed 0, its dense shape, CHUNK 4), the
port's weights converted from JAX's.

The format (sha-addressed members, the sidecar, two builds with one sha,
a flipped byte refused naming its member); the gate, each stale field
refused by name (``kernels`` among them); ``decoder_geometry`` equal to
JAX's in dense and paged, in every tier; a geometry mismatch serving live,
loudly; AOT-served greedy streams bit-equal to the port's live ones and
equal to JAX's (its AOT-served ones in the dense tier); an AOT-booted
front whose warm-up books no kernel build and every dispatch a hit, with
``/metrics`` carrying the AOT families; a breaker rebuild binding the
same bundle; ``root.common.serve.aot`` at a missing path booting a
working live server; the fused tick installed from a bundle; the CLI's
exit codes equal to JAX's; the cold-start keys lower-better; and the
library seam of ``ops/_build.py``.

On the CPU the port launches no kernel, so a CPU bundle holds no library
(its rows name the libraries a card's bundle packs): the staging tests
pack stand-in bytes under a real source's digest and never load them.
The card's test (tests/test_torch_cuda.py) boots a process from a
bundle of built libraries with an empty build directory."""

import hashlib
import io
import json
import logging
import os
import tarfile
import urllib.error
import urllib.request

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.aot import artifact as jart
from veles_tpu.aot import cli as jcli
from veles_tpu.aot import loader as jload
from veles_tpu.core import prng as jprng
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu.observe import regress as jreg
from veles_tpu.parallel.transformer_step import init_transformer_params
from veles_tpu.serving import ContinuousDecoder as JDecoder
from veles_tpu_torch import convert
from veles_tpu_torch.aot import cli as tcli
from veles_tpu_torch.aot.artifact import (BundleBuilder,
                                          build_serving_bundle,
                                          capture_tick_programs,
                                          decoder_geometry, inspect_bundle,
                                          read_bundle, workflow_tick)
from veles_tpu_torch.aot.loader import (AotCompatError, check_compat,
                                        install_fused_tick,
                                        install_workflow_tick, load_bundle)
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.observe import regress as treg
from veles_tpu_torch.observe.xla_stats import get_compile_tracker
from veles_tpu_torch.ops import _build
from veles_tpu_torch.parallel import fused
from veles_tpu_torch.serving import ContinuousDecoder, GenerateAPI
from veles_tpu_torch.serving_chaos import tear_file

torch.set_num_threads(1)

HEADS, EMBED, BLOCKS, VOCAB = 4, 16, 2, 32
#: the dense serving shape every dense bundle here mirrors
DENSE_KW = dict(slots=3, max_len=64, n_tokens=6, tile=16)
CHUNK = 4
#: the paged shape (tests/test_aot.py's prefix-reuse test)
PAGED_KW = dict(slots=3, max_len=64, n_tokens=6, tile=16, paged=True,
                page_size=16)
#: stand-in bytes for a built library: the CPU cannot build or load one
FAKE_LIBRARY = b"\x7fELF stand-in library " * 512
#: the fused tick's weights after a run: the bundle changes where the
#: libraries come from, not what computes, so an installed tick's weights
#: equal the live tick's exactly; against JAX, the level-0 bf16 operands'
#: rounding (tests/test_torch_training.py's LEVEL0_ATOL)
TICK_JAX_ATOL = 1e-3


@pytest.fixture(scope="module")
def model():
    rng = numpy.random.RandomState(0)
    jparams = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB)
    table = rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.3
    return (jparams, jnp.asarray(table),
            convert.params_from_jax(jparams, device="cpu"),
            torch.from_numpy(table))


@pytest.fixture(scope="module")
def dense_bundle(model, tmp_path_factory):
    _, _, params, table = model
    path = str(tmp_path_factory.mktemp("aot") / "dense.aot.tar")
    build_serving_bundle(params, table, HEADS, path, chunk=CHUNK,
                         device="cpu", **DENSE_KW)
    return path


@pytest.fixture(autouse=True)
def _unstaged():
    """No library stays staged from one test into the next."""
    yield
    _build.unstage()


def _prompts(n=7, seed=3):
    rng = numpy.random.RandomState(seed)
    return [rng.randint(0, VOCAB, k) for k in (5, 9, 3, 7, 6, 11, 4)[:n]]


def _drain(dec, prompts):
    pending = list(prompts)
    for _ in range(min(3, len(pending))):
        dec.submit(pending.pop(0))
    dec.drain_pipelined(
        CHUNK, admit=lambda: pending and dec.submit(pending.pop(0)))
    return dec


def _results(dec):
    return {rid: [int(t) for t in tokens]
            for rid, tokens in dec.results.items()}


def _library_bundle(path, stem="int8_matmul", blob=FAKE_LIBRARY):
    """A bundle whose one row launches ``stem``, packing ``blob`` as its
    library under the tree's source digest."""
    bundle = BundleBuilder(device="cpu")
    bundle.add_library(stem, blob=blob)
    bundle.add("decode.dispatch", ("dispatch", 1, 16), [stem])
    return bundle.write(str(path))


def _rewrite(path, out, manifest=None, flip=None):
    """Re-pack a bundle's members, with another manifest or one member's
    last byte flipped (no sidecar: the member check must catch it)."""
    old, members = read_bundle(path, verify=False)
    members["manifest.json"] = json.dumps(manifest or old).encode()
    with tarfile.open(out, "w") as tar:
        for name, blob in members.items():
            if name == flip:
                blob = blob[:-1] + bytes([blob[-1] ^ 1])
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return str(out)


# -- the format --------------------------------------------------------------

class TestBundleFormat:
    def test_sha_addressed_members_and_sidecar(self, tmp_path):
        path = _library_bundle(tmp_path / "lib.aot.tar")
        manifest, members = read_bundle(path)
        assert manifest["kind"] == "veles-aot-bundle"
        (row,) = manifest["libraries"]
        assert row["member"] == "programs/%s" % hashlib.sha256(
            members[row["member"]]).hexdigest()
        assert members[row["member"]] == FAKE_LIBRARY
        assert row["digest"] == _build.source_digest("int8_matmul")
        assert manifest["kernels"] == {"int8_matmul": row["digest"]}
        with open(path + ".sha256") as fin:
            digest = fin.read().split()[0]
        assert digest == treg.sha256_of(path)
        info = inspect_bundle(path)
        assert info["programs"] == 1
        assert info["libraries"] == {"int8_matmul": len(FAKE_LIBRARY)}

    def test_cpu_bundle_holds_no_library(self, model, tmp_path):
        _, _, params, table = model
        path = build_serving_bundle(params, table, HEADS,
                                    str(tmp_path / "int8.tar"),
                                    chunk=CHUNK, quantize="int8",
                                    device="cpu", **DENSE_KW)
        manifest, members = read_bundle(path)
        assert set(members) == {"manifest.json"}
        assert [row["member"] for row in manifest["libraries"]] == [None]
        assert set(manifest["kernels"]) == {"int8_matmul"}
        for row in manifest["programs"]:
            assert row["libraries"] == ["int8_matmul"]
        assert manifest["fingerprint"]["backend"] == "cpu"
        assert manifest["mesh"] is None

    @pytest.mark.parametrize("kw", [DENSE_KW, PAGED_KW],
                             ids=["dense", "paged"])
    def test_build_twice_same_sha(self, model, tmp_path, kw):
        _, _, params, table = model
        digests = []
        for name in ("a.tar", "b.tar"):
            path = build_serving_bundle(params, table, HEADS,
                                        str(tmp_path / name), chunk=CHUNK,
                                        device="cpu", **kw)
            digests.append(treg.sha256_of(path))
        assert digests[0] == digests[1]

    def test_tampered_member_refused_naming_it(self, tmp_path):
        path = _library_bundle(tmp_path / "lib.aot.tar")
        manifest, _ = read_bundle(path)
        victim = manifest["libraries"][0]["member"]
        bad = _rewrite(path, tmp_path / "bad.tar", flip=victim)
        with pytest.raises(ValueError, match="content hash") as err:
            load_bundle(bad, prefetch=False, device="cpu")
        assert victim in str(err.value)
        assert _build.staged_path("int8_matmul") is None


# -- the gate ----------------------------------------------------------------

class TestCompatGate:
    @pytest.fixture()
    def manifest(self, dense_bundle):
        return read_bundle(dense_bundle)[0]

    @pytest.mark.parametrize("field,value", [
        ("schema", 999), ("torch", "0.0.1"), ("cuda", "0.0"),
        ("kernels", {"int8_matmul": "00" * 32}),
        ("kernels", {"no_such_kernel": "00" * 32})])
    def test_stale_field_refused_by_name(self, manifest, field, value):
        stale = dict(manifest)
        stale[field] = value
        with pytest.raises(AotCompatError) as err:
            check_compat(stale)
        assert err.value.field == field

    def test_fingerprint_refused(self, manifest):
        stale = dict(manifest, fingerprint=dict(manifest["fingerprint"],
                                                device_kind="H9000"))
        with pytest.raises(AotCompatError) as err:
            check_compat(stale)
        assert err.value.field == "fingerprint"
        # a CPU bundle is not loadable for the card either
        with pytest.raises(AotCompatError) as err:
            check_compat(manifest, device="cuda")
        assert err.value.field == "fingerprint"

    def test_mesh_refused_both_ways(self, manifest):
        class Mesh:
            shape = {"model": 8}

        with pytest.raises(AotCompatError) as err:
            check_compat(manifest, mesh=Mesh())
        assert err.value.field == "mesh"
        stale = dict(manifest, mesh={"axes": {"model": 2}, "devices": 2})
        with pytest.raises(AotCompatError) as err:
            check_compat(stale)
        assert err.value.field == "mesh"

    def test_order_matches_jax(self, manifest, dense_bundle):
        """Schema first, then the versions, the fingerprint, the mesh: a
        manifest stale in all of them is refused for the first, as
        JAX's gate refuses it."""
        stale = dict(manifest, schema=999, torch="0", fingerprint={})
        with pytest.raises(AotCompatError) as ours:
            check_compat(stale)
        jstale = dict(read_bundle(dense_bundle)[0], schema=999, jax="0",
                      fingerprint={})
        with pytest.raises(jload.AotCompatError) as theirs:
            jload.check_compat(jstale)
        assert ours.value.field == theirs.value.field == "schema"

    def test_edited_source_refuses_the_bundle(self, tmp_path, monkeypatch):
        path = _library_bundle(tmp_path / "lib.aot.tar")
        real = _build.source_digest
        monkeypatch.setattr(_build, "source_digest", lambda name: (
            "ff" * 32 if name == "int8_matmul" else real(name)))
        with pytest.raises(AotCompatError) as err:
            load_bundle(path, prefetch=False, device="cpu")
        assert err.value.field == "kernels"
        assert _build.staged_path("int8_matmul") is None

    def test_stale_bundle_file_refused_by_name(self, dense_bundle,
                                               tmp_path):
        manifest = dict(read_bundle(dense_bundle)[0], torch="0.0.1")
        stale = _rewrite(dense_bundle, tmp_path / "stale.tar", manifest)
        with pytest.raises(AotCompatError) as err:
            load_bundle(stale, device="cpu")
        assert err.value.field == "torch"


# -- the geometry ------------------------------------------------------------

@pytest.mark.parametrize("quantize", [None, "int8", "int8-kv"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decoder_geometry_matches_jax(model, paged, quantize):
    jparams, jtable, params, table = model
    kw = dict(PAGED_KW if paged else DENSE_KW, quantize=quantize)
    ours = decoder_geometry(ContinuousDecoder(params, table, HEADS,
                                              device="cpu", **kw))
    theirs = jart.decoder_geometry(JDecoder(jparams, jtable, HEADS, **kw))
    assert ours == theirs


def test_geometry_mismatch_degrades_to_live(model, dense_bundle, caplog):
    _, _, params, table = model
    aot = load_bundle(dense_bundle, prefetch=False, device="cpu")
    kw = dict(DENSE_KW, slots=2)
    with caplog.at_level(logging.WARNING):
        dec = ContinuousDecoder(params, table, HEADS, aot=aot,
                                device="cpu", **kw)
    assert not dec.aot_active and dec.aot is None
    assert any("refused" in r.getMessage() and "'slots'" in r.getMessage()
               for r in caplog.records)
    ref = ContinuousDecoder(params, table, HEADS, device="cpu", **kw)
    for d in (dec, ref):
        _drain(d, _prompts(3))
    assert dec.results == ref.results


# -- the streams -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dense_streams(model, tmp_path_factory):
    """JAX's AOT-served dense streams from its own bundle."""
    jparams, jtable, _, _ = model
    path = str(tmp_path_factory.mktemp("jaot") / "dense.aot.tar")
    jart.build_serving_bundle(jparams, jtable, HEADS, path, chunk=CHUNK,
                              buckets=[16], **DENSE_KW)
    aot = jload.load_bundle(path, prefetch=False)
    dec = _drain(JDecoder(jparams, jtable, HEADS, aot=aot, **DENSE_KW),
                 _prompts())
    assert dec.aot_active and not aot.stats()["misses"]
    return _results(dec)


class TestStreams:
    def test_dense_streams(self, model, dense_bundle, jax_dense_streams):
        _, _, params, table = model
        aot = load_bundle(dense_bundle, prefetch=False, device="cpu")
        ref = _drain(ContinuousDecoder(params, table, HEADS, device="cpu",
                                       **DENSE_KW), _prompts())
        got = _drain(ContinuousDecoder(params, table, HEADS, aot=aot,
                                       device="cpu", **DENSE_KW),
                     _prompts())
        assert got.aot_active
        assert _results(got) == _results(ref) == jax_dense_streams
        stats = aot.stats()
        assert stats["hits"]["decode.admit"] > 0
        assert stats["hits"]["decode.dispatch"] > 0
        assert not stats["misses"]
        assert ref.dispatch_counts == got.dispatch_counts

    def test_int8kv_streams(self, model, tmp_path):
        jparams, jtable, params, table = model
        kw = dict(slots=3, max_len=128, n_tokens=6, tile=128,
                  quantize="int8-kv")
        path = build_serving_bundle(params, table, HEADS,
                                    str(tmp_path / "int8kv.tar"),
                                    chunk=CHUNK, device="cpu", **kw)
        aot = load_bundle(path, prefetch=False, device="cpu")
        ref = _drain(ContinuousDecoder(params, table, HEADS, device="cpu",
                                       **kw), _prompts(4))
        got = _drain(ContinuousDecoder(params, table, HEADS, aot=aot,
                                       device="cpu", **kw), _prompts(4))
        jax_live = _drain(JDecoder(jparams, jtable, HEADS, **kw),
                          _prompts(4))
        assert got.aot_active
        assert _results(got) == _results(ref) == _results(jax_live)
        assert not aot.stats()["misses"]

    def test_paged_streams_with_prefix_reuse(self, model, tmp_path):
        """Cold, tail and hit admissions all serve from the bundle: the
        port's ragged tails are enumerable (width x prefix pages)."""
        jparams, jtable, params, table = model
        path = build_serving_bundle(params, table, HEADS,
                                    str(tmp_path / "paged.tar"),
                                    chunk=CHUNK, device="cpu", **PAGED_KW)
        aot = load_bundle(path, prefetch=False, device="cpu")
        rng = numpy.random.RandomState(5)
        system = rng.randint(0, VOCAB, 16)  # one whole page
        prompts = [system.tolist() + rng.randint(0, VOCAB, k).tolist()
                   for k in (3, 5, 0, 3)]
        prompts.append(prompts[2])  # the page-aligned prompt again: a hit
        results = []
        for a in (None, aot):
            dec = ContinuousDecoder(params, table, HEADS, aot=a,
                                    device="cpu", **PAGED_KW)
            for prompt in prompts:
                dec.submit(prompt)
                dec.run_until_drained(chunk=CHUNK)
            results.append((_results(dec), dict(dec.dispatch_counts)))
        jdec = JDecoder(jparams, jtable, HEADS, **PAGED_KW)
        for prompt in prompts:
            jdec.submit(prompt)
            jdec.run_until_drained(chunk=CHUNK)
        (ref, ref_counts), (got, got_counts) = results
        assert got == ref == _results(jdec)
        assert got_counts == ref_counts
        assert got_counts["admit_hit"] > 0 and got_counts["admit_tail"] > 0
        stats = aot.stats()
        for name in ("paged.admit", "paged.admit_tail", "paged.admit_hit",
                     "paged.dispatch"):
            assert stats["hits"].get(name, 0) > 0, name
        assert not stats["misses"]


# -- the front ---------------------------------------------------------------

def _post(port, tokens, n_tokens=None):
    body = {"tokens": [int(t) for t in tokens]}
    if n_tokens is not None:
        body["n_tokens"] = n_tokens
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())["tokens"]


class TestServing:
    def test_warmup_books_no_build_and_every_dispatch_a_hit(
            self, model, dense_bundle):
        _, _, params, table = model
        aot = load_bundle(dense_bundle, prefetch=False, device="cpu")
        api = GenerateAPI(params, table, HEADS, chunk=CHUNK, port=0,
                          aot=aot, device="cpu", **DENSE_KW).start()
        try:
            tracker = get_compile_tracker()
            before = tracker.snapshot()["compiles"]
            hits_before = sum(aot.stats()["hits"].values())
            rng = numpy.random.RandomState(7)
            for k in (5, 9, 17, 33, 3):  # every prompt bucket
                assert _post(api.port, rng.randint(0, VOCAB, k))
            after = tracker.snapshot()["compiles"]
            assert {k: v for k, v in after.items() if k.endswith(".cu")} \
                == {k: v for k, v in before.items() if k.endswith(".cu")}
            stats = aot.stats()
            assert sum(stats["hits"].values()) > hits_before
            assert not stats["misses"]
            rows = api.ledger.resolved(5)
            assert rows and all(row["dispatches"]["aot"] > 0
                                and row["dispatches"]["live"] == 0
                                for row in rows)
            with urllib.request.urlopen(
                    "http://127.0.0.1:%d/metrics" % api.port,
                    timeout=10) as resp:
                text = resp.read().decode()
            assert 'veles_aot_hits_total{program="decode.admit"}' in text
            assert "veles_aot_programs_loaded" in text
        finally:
            api.stop()

    def test_breaker_rebuild_reuses_loaded_programs(self, model,
                                                    dense_bundle):
        _, _, params, table = model
        aot = load_bundle(dense_bundle, prefetch=False, device="cpu")
        api = GenerateAPI(params, table, HEADS, chunk=CHUNK, port=0,
                          aot=aot, device="cpu", **DENSE_KW)
        first = api.decoder
        assert first.aot_active and first.aot is aot
        assert api._rebuild()
        assert api.decoder is not first
        assert api.decoder.aot_active and api.decoder.aot is aot

    def test_serve_aot_config_fallback(self, model, tmp_path, caplog,
                                       monkeypatch):
        """``root.common.serve.aot`` at a missing bundle boots a WORKING
        live server, loudly."""
        _, _, params, table = model
        monkeypatch.setattr(root.common.serve, "aot",
                            str(tmp_path / "missing.aot.tar"),
                            raising=False)
        with caplog.at_level(logging.WARNING):
            api = GenerateAPI(params, table, HEADS, chunk=CHUNK, port=0,
                              device="cpu", **DENSE_KW).start()
        try:
            assert not api.decoder.aot_active and api.aot is None
            assert any("refused" in r.getMessage()
                       for r in caplog.records)
            assert len(_post(api.port, [1, 2, 3])) == DENSE_KW["n_tokens"]
        finally:
            api.stop()

    def test_serve_aot_config_boots_from_the_bundle(self, model,
                                                    dense_bundle,
                                                    monkeypatch, caplog):
        _, _, params, table = model
        monkeypatch.setattr(root.common.serve, "aot", dense_bundle,
                            raising=False)
        with caplog.at_level(logging.WARNING):
            api = GenerateAPI(params, table, HEADS, chunk=2, port=0,
                              device="cpu", **DENSE_KW)
        assert api.decoder.aot_active
        assert any("chunk 4" in r.getMessage() and "chunk 2"
                   in r.getMessage() for r in caplog.records)


# -- the fused tick ----------------------------------------------------------

def _digits_kwargs():
    from sklearn.datasets import load_digits
    digits = load_digits()
    x = digits.data.astype(numpy.float32)
    y = digits.target.astype(numpy.int32)
    perm = numpy.random.RandomState(0).permutation(len(x))
    return dict(layers=(32, 10),
                loader_kwargs=dict(data=x[perm], labels=y[perm],
                                   class_lengths=[0, 297, 1500],
                                   minibatch_size=100,
                                   normalization_type="linear"),
                learning_rate=0.1, max_epochs=2, fused_sweep=False)


def _recorded(wf):
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append([int(s[0]) for s in stats])
        summary(stats, epoch)

    wf.decision._epoch_summary = recorded
    return seen


class TestFusedTick:
    @pytest.fixture(autouse=True)
    def _clean_tick_cache(self):
        yield
        fused._TICK_CACHE.clear()

    def test_installed_tick_trains_as_live_and_as_jax(self, tmp_path):
        jprng.get("default").seed(4321)
        jprng.get("loader").seed(8765)
        jwf = JMLPWorkflow(JDummyLauncher(), **_digits_kwargs())
        jwf.initialize()
        layers = [{"weights": numpy.asarray(f.weights.data),
                   "bias": numpy.asarray(f.bias.data)}
                  for f in jwf.forwards]

        def port_workflow(programs=None):
            prng.get("loader").seed(8765)
            wf = MLPWorkflow(DummyLauncher(), device="cpu",
                             **_digits_kwargs())
            convert.unit_params_from_jax(wf, layers)
            if programs is not None:
                install_workflow_tick(programs, wf)
            wf.initialize()
            return wf

        # each port run right after its seeding: the loader stream is
        # process-wide
        live = port_workflow()
        specs, train, evals, install = workflow_tick(live)
        bundle = BundleBuilder(device="cpu")
        capture_tick_programs(bundle, live.fused_tick._steps_, train,
                              evals, specs=specs)
        epochs = [_recorded(jwf), _recorded(live)]
        jwf.run()
        live.run()
        aot = load_bundle(bundle.write(str(tmp_path / "tick.tar")),
                          prefetch=False, device="cpu")
        served = port_workflow(aot)
        assert served.fused_tick._steps_[0].__wrapped__ is not None
        epochs.append(_recorded(served))
        served.run()
        assert epochs[2] == epochs[1] == epochs[0]
        stats = aot.stats()
        assert stats["hits"]["fused.train_step"] \
            == served.fused_tick.minibatch_counts[2]
        assert stats["hits"]["fused.eval_step"] \
            == served.fused_tick.minibatch_counts[1]
        assert not stats["misses"]
        for jf, lf, sf in zip(jwf.forwards, live.forwards,
                              served.forwards):
            assert torch.equal(sf.weights.data, lf.weights.data)
            assert torch.equal(sf.bias.data, lf.bias.data)
            numpy.testing.assert_allclose(
                sf.weights.data.numpy(), numpy.asarray(jf.weights.data),
                atol=TICK_JAX_ATOL, rtol=0)

    def test_uncovered_minibatch_is_a_miss(self, tmp_path):
        prng.get("loader").seed(1)
        wf = MLPWorkflow(DummyLauncher(), device="cpu", **_digits_kwargs())
        wf.initialize()
        specs, train, evals, install = workflow_tick(wf)
        bundle = BundleBuilder(device="cpu")
        capture_tick_programs(bundle, None, train, specs=specs)
        aot = load_bundle(bundle.write(str(tmp_path / "tick.tar")),
                          prefetch=False, device="cpu")
        steps = install_fused_tick(aot, specs, **install)
        installed = fused.build_tick(
            specs, install["norm_type"],
            with_confusion=install["with_confusion"],
            augment=install["augment"], loss_kind=install["loss_kind"])
        assert installed[0] is steps[0]
        out = installed[0](*train)
        ref = fused.build_tick(specs, install["norm_type"],
                               with_confusion=install["with_confusion"],
                               augment=install["augment"],
                               loss_kind=install["loss_kind"],
                               cached=False)[0](*train)
        assert torch.equal(out[1][1], ref[1][1])
        tail = list(train)
        tail[5] = train[5][:37]
        installed[0](*tail)
        stats = aot.stats()
        assert stats["hits"] == {"fused.train_step": 1}
        assert stats["misses"] == {"fused.train_step": 1}


# -- the CLI -----------------------------------------------------------------

def _cli_codes(main, out, capsys, extra=()):
    codes = [main(["build", "--out", out, "--blocks", "1", "--embed",
                   "16", "--heads", "4", "--vocab", "32", "--slots", "2",
                   "--max-len", "32", "--n-tokens", "4", "--chunk", "2",
                   "--tile", "16", *extra])]
    summary = json.loads(capsys.readouterr().out)
    assert summary["programs"] > 0
    codes.append(main(["inspect", out]))
    codes.append(main(["verify", out]))
    assert "loadable" in capsys.readouterr().out
    codes.append(main(["verify", out, "--mesh", "model=8"]))
    assert "mesh" in capsys.readouterr().out
    with open(out, "r+b") as fout:
        fout.seek(-1, os.SEEK_END)
        last = fout.read(1)
        fout.seek(-1, os.SEEK_END)
        fout.write(bytes([last[0] ^ 1]))
    codes.append(main(["verify", out]))
    capsys.readouterr()
    return codes


def test_cli_exit_codes_match_jax(tmp_path, capsys):
    ours = _cli_codes(tcli.main, str(tmp_path / "port.aot.tar"), capsys,
                      extra=("--device", "cpu"))
    theirs = _cli_codes(jcli.main, str(tmp_path / "jax.aot.tar"), capsys)
    assert ours == theirs == [0, 0, 0, 1, 2]


def test_cli_refusals_name_their_roadmap_items(tmp_path, capsys):
    """``aot build --mesh`` records a bundle for that serving mesh (its
    ``mesh`` field JAX's shape); ``verify`` gives the JAX package's
    verdicts: loadable for that mesh, refused for another or for none;
    a mesh the weights cannot split is refused with JAX's error."""
    out = str(tmp_path / "b.aot.tar")
    base = ["build", "--out", out, "--device", "cpu", "--blocks", "1",
            "--embed", "16", "--heads", "8", "--vocab", "32"]
    assert tcli.main(base + ["--mesh", "model=8"]) == 0
    manifest, _ = read_bundle(out)
    assert manifest["mesh"]["devices"] == 8
    assert manifest["mesh"]["axes"]["model"] == 8
    assert manifest["geometry"]["mesh_axis"] == "model"
    capsys.readouterr()
    assert tcli.main(["verify", out]) == 0
    assert tcli.main(["verify", out, "--mesh", "model=4"]) == 1
    assert "REFUSED: mesh" in capsys.readouterr().out
    with pytest.raises(ValueError, match="divisible"):
        tcli.main(base + ["--out", str(tmp_path / "c.aot.tar"),
                          "--mesh", "model=3"])
    assert not os.path.exists(str(tmp_path / "c.aot.tar"))


def _package_dir(directory):
    """tests/test_forge.py's package directory: a manifest naming a
    workflow and a config file."""
    os.makedirs(directory)
    with open(os.path.join(directory, "manifest.json"), "w") as fout:
        json.dump({"name": "toy-model", "version": "1.0",
                   "short_description": "toy model", "workflow": "wf.py",
                   "config": "cfg.py", "requires": ["numpy"]}, fout)
    for name, text in (("wf.py", "# the workflow\n"),
                       ("cfg.py", "root.toy.x = 1\n")):
        with open(os.path.join(directory, name), "w") as fout:
            fout.write(text)
    return directory


def test_stage_into_package_gives_jax_manifest(tmp_path, capsys,
                                               dense_bundle):
    """``stage_into_package`` (and ``aot build --forge-dir``) copies the
    bundle and its sidecar and rewrites the manifest as the JAX
    package's does, byte for byte; staging twice lists the bundle
    once."""
    ours = _package_dir(str(tmp_path / "port"))
    theirs = _package_dir(str(tmp_path / "jax"))
    name = os.path.basename(dense_bundle)
    assert tcli.stage_into_package(dense_bundle, ours) == name
    assert jcli.stage_into_package(dense_bundle, theirs) == name
    tcli.stage_into_package(dense_bundle, ours)
    jcli.stage_into_package(dense_bundle, theirs)
    for member in ("manifest.json", name, name + ".sha256"):
        with open(os.path.join(ours, member), "rb") as fin, \
                open(os.path.join(theirs, member), "rb") as fjax:
            assert fin.read() == fjax.read(), member
    with open(os.path.join(ours, "manifest.json")) as fin:
        assert json.load(fin)["artifacts"] == [name]
    out = str(tmp_path / "cli.aot.tar")
    assert tcli.main(["build", "--out", out, "--device", "cpu",
                      "--blocks", "1", "--embed", "16", "--heads", "4",
                      "--vocab", "32", "--max-len", "32",
                      "--forge-dir", ours]) == 0
    capsys.readouterr()
    with open(os.path.join(ours, "manifest.json")) as fin:
        assert json.load(fin)["artifacts"] == [name, "cli.aot.tar"]
    assert os.path.isfile(os.path.join(ours, "cli.aot.tar.sha256"))


class TestForgeArtifactDistribution:
    """tests/test_aot.py::TestForgeArtifactDistribution on the port:
    bundles ride forge packages; the server verifies the sidecar on
    receipt, 422s a tampered upload, and a fetched bundle boots a
    decoder from its programs."""

    def _package(self, tmp_path, bundle, tamper=False):
        from veles_tpu_torch.forge import package as pkg

        directory = _package_dir(str(tmp_path / "pkg"))
        tcli.stage_into_package(bundle, directory)
        if tamper:
            victim = os.path.join(directory, os.path.basename(bundle))
            with open(victim, "r+b") as fout:
                fout.seek(-1, os.SEEK_END)
                last = fout.read(1)
                fout.seek(-1, os.SEEK_END)
                fout.write(bytes([last[0] ^ 1]))
        path, manifest = pkg.pack(directory,
                                  out_path=str(tmp_path / "pkg.tar.gz"))
        assert manifest["artifacts"] == [os.path.basename(bundle)]
        with open(path, "rb") as fin:
            return fin.read()

    def test_upload_verifies_and_rejects_tamper(self, tmp_path,
                                                dense_bundle):
        from veles_tpu_torch.forge import ForgeServer, package as pkg

        server = ForgeServer(str(tmp_path / "store"))
        blob = self._package(tmp_path, dense_bundle)
        assert server.upload(blob, version="1.0")["name"] == "toy-model"
        bad = self._package(tmp_path / "t2", dense_bundle, tamper=True)
        with pytest.raises(pkg.TamperedPackageError):
            server.upload(bad, version="1.1")
        server.start()
        try:
            req = urllib.request.Request(
                "http://127.0.0.1:%d/upload?version=2.0" % server.port,
                data=bad,
                headers={"Content-Type": "application/octet-stream"})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
            assert err.value.code == 422
            assert "2.0" not in server.details("toy-model")["versions"]
        finally:
            server.stop()

    def test_fetched_bundle_loads(self, tmp_path, dense_bundle, model):
        """pack -> upload -> fetch -> unpack -> load_bundle -> a decoder
        serving from the bundle's programs."""
        from veles_tpu_torch.forge import ForgeServer, package as pkg

        server = ForgeServer(str(tmp_path / "store"))
        server.upload(self._package(tmp_path, dense_bundle),
                      version="1.0")
        dest = str(tmp_path / "fetched")
        manifest = pkg.unpack(server.fetch("toy-model"), dest)
        aot = load_bundle(os.path.join(dest, manifest["artifacts"][0]),
                          prefetch=False, device="cpu")
        _, _, params, table = model
        dec = ContinuousDecoder(params, table, HEADS, aot=aot,
                                device="cpu", **DENSE_KW)
        assert dec.aot_active


def test_cli_warm_cache(model, tmp_path, capsys):
    _, _, params, table = model
    path = build_serving_bundle(params, table, HEADS,
                                str(tmp_path / "w.aot.tar"), chunk=CHUNK,
                                device="cpu", **DENSE_KW)
    assert tcli.main(["warm-cache", path]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["programs"] == stats["compiled"] > 0
    assert stats["exec_cache"]["directory"] == path + ".xcache"
    assert tcli.main(["warm-cache", path, "--mesh", "model=8"]) == 1


def test_aot_command_through_main(tmp_path, capsys):
    from veles_tpu_torch.__main__ import main

    out = str(tmp_path / "m.aot.tar")
    assert main(["aot", "build", "--out", out, "--device", "cpu",
                 "--blocks", "1", "--embed", "16", "--heads", "4",
                 "--vocab", "32", "--max-len", "32"]) == 0
    capsys.readouterr()
    assert main(["aot", "verify", out]) == 0


# -- the regression gate -----------------------------------------------------

def test_coldstart_keys_are_lower_better():
    old = {"coldstart_to_first_token_ms": 100.0, "warmup_compiles": 2,
           "coldstart_compiles": 0.5}
    new = {"coldstart_to_first_token_ms": 150.0, "warmup_compiles": 6,
           "coldstart_compiles": 3.0}
    bad = {f["key"] for f in treg.regressions(treg.compare(old, new))}
    assert bad == set(old)
    assert treg.compare(old, new) == jreg.compare(old, new)
    assert not treg.regressions(treg.compare(old, dict(old)))


# -- the library seam --------------------------------------------------------

class TestLibrarySeam:
    @pytest.fixture()
    def no_nvcc(self, tmp_path, monkeypatch):
        """nvcc raises, the build directory is empty, nothing is loaded,
        and ctypes "loads" a library by recording its path."""
        def refuse():
            raise AssertionError("nvcc ran")

        monkeypatch.setattr(_build, "_nvcc", refuse)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "_functions", {})
        loaded = []

        class Lib:
            def __init__(self, path):
                loaded.append(path)

            def __getattr__(self, symbol):
                return lambda *args: 0

        monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
        return loaded

    def test_matching_digest_is_taken(self, no_nvcc, tmp_path):
        path = tmp_path / "lib.so"
        path.write_bytes(FAKE_LIBRARY)
        builds = get_compile_tracker().snapshot()["compiles"]
        _build.stage("int8_matmul", path,
                     _build.source_digest("int8_matmul"))
        fn = _build.function("int8_matmul", "veles_int8_matmul", [])
        assert fn() == 0
        assert no_nvcc == [str(path)]
        assert get_compile_tracker().snapshot()["compiles"] == builds

    def test_mismatching_digest_is_refused(self, no_nvcc, tmp_path):
        path = tmp_path / "lib.so"
        path.write_bytes(FAKE_LIBRARY)
        with pytest.raises(ValueError, match="refused"):
            _build.stage("int8_matmul", path, "00" * 32)
        assert _build.staged_path("int8_matmul") is None
        with pytest.raises(AssertionError, match="nvcc ran"):
            _build.function("int8_matmul", "veles_int8_matmul", [])
        assert no_nvcc == []

    def test_load_bundle_stages_through_the_cache(self, no_nvcc, tmp_path,
                                                  caplog):
        path = _library_bundle(tmp_path / "lib.aot.tar")
        aot = load_bundle(path, prefetch=False, exec_cache=True,
                          device="cpu")
        staged = _build.staged_path("int8_matmul")
        assert staged.startswith(path + ".xcache")
        with open(staged, "rb") as fin:
            assert fin.read() == FAKE_LIBRARY
        assert aot.libraries() == {"int8_matmul": "bundle"}
        assert aot.footprint_bytes() == len(FAKE_LIBRARY)
        aot.compile_all()
        assert no_nvcc == [staged]
        assert aot.stats()["compiled"] == 1
        # the next boot takes the verified entry
        again = load_bundle(path, prefetch=False, exec_cache=True,
                            device="cpu")
        assert again.libraries() == {"int8_matmul": "cache"}
        assert again.exec_cache.stats()["hits"] == 1
        # a torn entry is refused loudly and nvcc builds that library
        tear_file(staged)
        with caplog.at_level(logging.WARNING):
            torn = load_bundle(path, prefetch=False, exec_cache=True,
                               device="cpu")
        assert torn.libraries() == {"int8_matmul": "live"}
        assert _build.staged_path("int8_matmul") is None
        assert not os.path.exists(staged)
        assert torn.exec_cache.stats()["rejects"] == 1
        assert any("nvcc builds it live" in r.getMessage()
                   for r in caplog.records)
        _build._libs.clear()  # a fresh process has loaded nothing
        with pytest.raises(AssertionError, match="nvcc ran"):
            torn.compile_all()
        assert torn.stats()["compiled"] == 0
