"""The port's package export (veles_tpu_torch/export.py) and the native
runtime's binding (veles_tpu_torch/inference.py) against the JAX
package's, on the CPU.

For the same weights (the JAX workflow's, carried across with
``convert.unit_params_from_jax``) the port's package must equal the JAX
package's member for member: the same tar member names in the same
order, the same ``.npy`` bytes and the same ``contents.json`` apart from
``checksum``, which hashes each package's own workflow source. That is
held at 32 and 16 bits for an MLP, a convnet with every pooling kind and
the pre-LN transformer stack. The C++ runtime under ``native/`` (built
with g++ by the port) must load the port's package and agree with the
port's forward (rtol 2e-3, atol 1e-5, equal argmax:
tests/test_native.py:72-78's bounds) and with JAX's ``NativeWorkflow``
on JAX's package."""

import io
import json
import os
import tarfile

import numpy
import pytest
import torch

from veles_tpu import inference as jinference
from veles_tpu.core import prng as jprng
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.export import package_export as jpackage_export
from veles_tpu.models.standard import StandardWorkflow as JStandardWorkflow
from veles_tpu_torch import inference
from veles_tpu_torch.convert import unit_params_from_jax, unit_state_of
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.export import package_export
from veles_tpu_torch.inference import (LIB_PATH, NativeWorkflow,
                                       build_native)
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.nn.kohonen import KohonenForward
from veles_tpu_torch.parallel.fused import forward_chain

torch.set_num_threads(1)


def _data(kind):
    rng = numpy.random.RandomState(0)
    if kind in ("mlp", "wide"):
        x = rng.rand(300, 64).astype(numpy.float32)
    elif kind == "conv":
        x = rng.rand(300, 8, 8, 2).astype(numpy.float32)
    else:
        x = (rng.randn(300, 6, 16) * 0.3).astype(numpy.float32)
    return x, rng.randint(0, 4, 300).astype(numpy.int32)


LAYERS = {
    "mlp": [{"type": "all2all_tanh", "output_sample_shape": (24,)},
            {"type": "all2all_relu", "output_sample_shape": (12,)},
            {"type": "softmax", "output_sample_shape": (4,)}],
    "conv": [{"type": "conv_tanh", "n_kernels": 4, "kx": 3, "ky": 3},
             {"type": "max_pooling", "kx": 2, "ky": 2},
             {"type": "conv_strict_relu", "n_kernels": 4, "kx": 2,
              "ky": 2, "padding": "VALID"},
             {"type": "avg_pooling", "kx": 1, "ky": 1},
             {"type": "maxabs_pooling", "kx": 1, "ky": 1},
             {"type": "softmax", "output_sample_shape": (4,)}],
    "transformer": [{"type": "layer_norm"},
                    {"type": "self_attention", "heads": 4,
                     "causal": True, "residual": True},
                    {"type": "layer_norm"},
                    {"type": "ffn", "ratio": 2},
                    {"type": "all2all_tanh", "output_sample_shape": (8,)},
                    {"type": "softmax", "output_sample_shape": (4,)}],
    # wide enough for the .npy members to outweigh the tar's blocks
    "wide": [{"type": "all2all_tanh", "output_sample_shape": (256,)},
             {"type": "softmax", "output_sample_shape": (4,)}],
}


def _pair(kind):
    """The JAX workflow and the port's with its weights, initialized."""
    x, y = _data(kind)
    kwargs = dict(layers=LAYERS[kind],
                  loader_kwargs=dict(data=x, labels=y,
                                     class_lengths=[0, 60, 240],
                                     minibatch_size=60),
                  learning_rate=0.1, decision_kwargs=dict(max_epochs=1),
                  name="export-%s" % kind)
    jprng.get("default").seed(5)
    jwf = JStandardWorkflow(JDummyLauncher(), **kwargs)
    jwf.initialize()
    twf = StandardWorkflow(DummyLauncher(), device="cpu", **kwargs)
    unit_params_from_jax(twf, unit_state_of(jwf))
    twf.initialize()
    return jwf, twf, x


def _members(path):
    with tarfile.open(path) as tar:
        return [(m.name, tar.extractfile(m).read()) for m in tar]


@pytest.fixture(scope="module")
def native_lib():
    return build_native()


@pytest.fixture
def jax_native(monkeypatch, native_lib):
    """JAX's NativeWorkflow over the same native sources, loaded from the
    port's g++ build (the JAX binding's own build runs cmake in
    native/build, which tests/test_native.py owns)."""
    monkeypatch.setattr(jinference, "_lib", None)
    monkeypatch.setattr(jinference, "build_native", lambda: native_lib)
    return jinference.NativeWorkflow


@pytest.mark.parametrize("precision", [32, 16])
@pytest.mark.parametrize("kind", ["mlp", "conv", "transformer"])
def test_package_equals_jax(tmp_path, kind, precision):
    jwf, twf, _ = _pair(kind)
    ours = package_export(twf, str(tmp_path / "t.tar"), precision)
    theirs = jpackage_export(jwf, str(tmp_path / "j.tar"), precision)
    ours, theirs = _members(ours), _members(theirs)
    assert [name for name, _ in ours] == [name for name, _ in theirs]
    assert ours[0][0] == "contents.json"
    contents = [json.loads(blob) for _, blob in (ours[0], theirs[0])]
    assert contents[0].pop("checksum") != contents[1].pop("checksum")
    assert contents[0] == contents[1]
    assert contents[0]["precision"] == precision
    assert contents[0]["units"][-1]["config"]["activation"] == "softmax"
    for (name, blob), (_, jblob) in zip(ours[1:], theirs[1:]):
        assert blob == jblob, name
        assert numpy.load(io.BytesIO(blob)).dtype == (
            numpy.float16 if precision == 16 else numpy.float32)


@pytest.mark.parametrize("kind", ["mlp", "conv", "transformer"])
def test_native_runs_the_port_package(tmp_path, monkeypatch, jax_native,
                                      kind):
    """The runtime agrees with the port's forward (f32, level 2) and with
    JAX's NativeWorkflow on JAX's package."""
    monkeypatch.setattr(root.common.engine, "precision_level", 2)
    jwf, twf, x = _pair(kind)
    path = package_export(twf, str(tmp_path / "t.tar"))
    rt = NativeWorkflow(path, max_batch=64)
    assert rt.unit_count == len(LAYERS[kind])
    assert rt.probe()
    batch = x[:32]
    native = rt.run(batch)
    logits = forward_chain(twf)(torch.from_numpy(batch))
    ours = torch.softmax(logits, dim=-1).numpy()
    numpy.testing.assert_allclose(native, ours, rtol=2e-3, atol=1e-5)
    numpy.testing.assert_array_equal(native.argmax(-1), ours.argmax(-1))
    theirs = jax_native(jpackage_export(jwf, str(tmp_path / "j.tar"))
                        ).run(batch)
    numpy.testing.assert_array_equal(native, theirs)
    with pytest.raises(ValueError):
        rt.run(numpy.zeros((65,) + batch.shape[1:], numpy.float32))
    with pytest.raises(ValueError):
        rt.run(numpy.zeros((1, 3), numpy.float32))


def test_f16_package_is_smaller_and_close(tmp_path):
    _, twf, x = _pair("wide")
    p32 = package_export(twf, str(tmp_path / "w32.tar"), precision=32)
    p16 = package_export(twf, str(tmp_path / "w16.tar"), precision=16)
    assert os.path.getsize(p16) < 0.65 * os.path.getsize(p32)
    out32 = NativeWorkflow(p32).run(x[:64])
    out16 = NativeWorkflow(p16).run(x[:64])
    numpy.testing.assert_allclose(out16, out32, atol=5e-3)


def test_export_refuses_what_it_cannot_export(tmp_path):
    _, twf, _ = _pair("mlp")
    with pytest.raises(ValueError, match="16- and 32-bit"):
        package_export(twf, str(tmp_path / "bad.tar"), precision=8)
    wf = DummyWorkflow()
    wf.forwards = [KohonenForward(wf, name="som")]
    wf.loader = twf.loader
    with pytest.raises(ValueError, match="cannot export unit 'som'"):
        package_export(wf, str(tmp_path / "som.tar"))


def test_export_is_deterministic_and_honours_source_date_epoch(
        tmp_path, monkeypatch):
    _, twf, _ = _pair("mlp")
    first = _members(package_export(twf, str(tmp_path / "a.tar")))
    again = _members(package_export(twf, str(tmp_path / "b.tar")))
    assert first == again
    assert json.loads(first[0][1])["exported"] == "1970-01-01 00:00:00"
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "86400")
    stamped = _members(package_export(twf, str(tmp_path / "c.tar")))
    assert json.loads(stamped[0][1])["exported"] == "1970-01-02 00:00:00"


def test_build_native_rebuilds_on_a_newer_source(native_lib, monkeypatch):
    """The cached library is reused while it is newer than every source,
    and rebuilt with g++ (no cmake) from every native/src/*.cc when it
    is older; the compiler is stubbed here by a copy of the library."""
    import shutil
    import subprocess

    calls = []

    def fake_run(argv, **kwargs):
        calls.append(argv)
        shutil.copy(native_lib, argv[argv.index("-o") + 1])

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert native_lib == LIB_PATH
    assert build_native() == LIB_PATH
    assert not calls
    newest = max(os.path.getmtime(p) for p in inference._sources())
    os.utime(LIB_PATH, (newest - 60,) * 2)
    assert build_native() == LIB_PATH
    (argv,) = calls
    assert argv[:6] == ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                        "-pthread"]
    assert sorted(a for a in argv if a.endswith(".cc")) \
        == inference._sources() and len(inference._sources()) == 6
    assert os.path.getmtime(LIB_PATH) >= newest
