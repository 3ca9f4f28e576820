"""The port's ``deploy rollout`` (veles_tpu_torch/deploy_cli.py) on the
CPU, held against the JAX package's (veles_tpu/deploy_cli.py,
tests/test_deploy.py::TestDeployRolloutCLI at its toy model: HEADS 4,
EMBED 16, VOCAB 11).

The serving checkpoint: each ``weights.npz`` member the port writes is
the JAX package's, byte for byte, for f32, bfloat16 and int8 trees, and
each package reads the other's leaves back exactly. The exit-code matrix
(0 began, 2 unavailable or malformed, 3 tampered, 4 no api or refused)
equals JAX's over the same packages. A JAX-written package rolls into a
live port ``GenerateAPI`` through ``python -m veles_tpu_torch deploy
rollout NAME@VERSION --forge-url URL`` (``__main__.main``, the api from
``serving.get_current_api``): it promotes, and afterwards every stream
equals a fresh api's on the new weights; a second rollout while one is
in flight exits 4 and a tampered package 3, neither touching the live
streams. The forge path is where the two packages differ on purpose:
the JAX package's ``_resolve_package`` reads the directory it unpacked
into as a file and exits 2 (ROADMAP C)."""

import hashlib
import io
import json
import time
import urllib.request
import zipfile

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import deploy_cli as jdeploy
from veles_tpu.forge import package as jpkg
from veles_tpu.parallel.transformer_step import init_transformer_params
from veles_tpu_torch import convert
from veles_tpu_torch import deploy_cli as tdeploy
from veles_tpu_torch import serving as tserving
from veles_tpu_torch.forge import ForgeServer
from veles_tpu_torch.parallel.decode import quantize_params

torch.set_num_threads(1)

HEADS, EMBED, VOCAB = 4, 16, 11


def _model():
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, 2, EMBED, HEADS, VOCAB)
    table = rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.3
    params2 = init_transformer_params(numpy.random.RandomState(99),
                                      2, EMBED, HEADS, VOCAB)
    return params, table, params2


def _port(tree):
    return convert.params_from_jax(tree, device="cpu")


def _members(blob):
    with zipfile.ZipFile(io.BytesIO(blob)) as archive:
        return {name: archive.read(name) for name in archive.namelist()}


def _trees(tier):
    """(JAX tree, port tree) of the toy model in ``tier``."""
    params, table, _ = _model()
    jtree = (params, jnp.asarray(table))
    if tier == "bf16":
        jtree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jtree)
    ttree = (_port(jtree[0]), convert.params_from_jax(
        {"t": jtree[1]}, device="cpu")["t"])
    if tier == "int8":
        from veles_tpu.parallel.decode import \
            quantize_params as jquantize
        jtree = (jquantize(jtree[0]), jtree[1])
        ttree = (quantize_params(ttree[0]), ttree[1])
    return jtree, ttree


@pytest.mark.parametrize("tier", ["f32", "bf16", "int8"])
def test_checkpoint_members_are_jax_bytes(tier):
    jtree, ttree = _trees(tier)
    ours, theirs = io.BytesIO(), io.BytesIO()
    tdeploy.save_serving_checkpoint(ours, *ttree)
    jdeploy.save_serving_checkpoint(theirs, *jtree)
    assert _members(ours.getvalue()) == _members(theirs.getvalue())
    # each side reads the other's leaves back exactly
    got = tdeploy.load_serving_checkpoint(theirs.getvalue(), *ttree)
    from veles_tpu_torch.device import tree_leaves_with_path
    for (path, a), (_, b) in zip(tree_leaves_with_path(got),
                                 tree_leaves_with_path(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    back = jdeploy.load_serving_checkpoint(ours.getvalue(), *jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        numpy.testing.assert_array_equal(
            numpy.asarray(a).view(numpy.uint8),
            numpy.asarray(b).view(numpy.uint8))
    with pytest.raises(ValueError, match="leaves"):
        tdeploy.load_serving_checkpoint(ours.getvalue(), {"one": ttree[1]},
                                        ttree[1])


class _Recorder:
    """tests/test_deploy.py's injectable ``api``: a decoder carrying the
    live tree, ``begin_rollout`` recorded or refused."""

    class _Decoder:
        def __init__(self, params, table):
            self.params = params
            self.embed_table = table

    def __init__(self, params, table, refuse=None):
        self.decoder = self._Decoder(params, table)
        self.calls = []
        self._refuse = refuse

    def begin_rollout(self, new_params, new_embed_table=None,
                      version="green", timeout=120.0):
        if self._refuse is not None:
            raise self._refuse
        self.calls.append({"version": version, "timeout": timeout,
                           "params": new_params, "table": new_embed_table})


def _package(tmp_path, params, table, name="toy-serve", version="2.0",
             tamper=False, weights=True, tag="pkg"):
    """A packed package holding the JAX package's serving checkpoint of
    ``(params, table)`` and its sidecar (test_deploy.py's shape)."""
    d = tmp_path / tag
    d.mkdir()
    (d / "wf.py").write_text("# serving checkpoint carrier\n")
    artifacts = []
    if weights:
        with open(d / "weights.npz", "wb") as fout:
            jdeploy.save_serving_checkpoint(fout, params, table)
        digest = hashlib.sha256((d / "weights.npz").read_bytes()) \
            .hexdigest()
        (d / "weights.npz.sha256").write_text(
            "%s  weights.npz\n" % ("0" * 64 if tamper else digest))
        artifacts = ["weights.npz"]
    (d / "manifest.json").write_text(json.dumps({
        "name": name, "version": version, "workflow": "wf.py",
        "artifacts": artifacts}))
    path, _ = jpkg.pack(str(d))
    return path


def _matrix(deploy, recorder, tmp_path, paths, current):
    """The exit codes of test_deploy.py's matrix through ``deploy``."""
    sink = io.StringIO()
    codes = []
    api = recorder(None)
    codes.append(deploy.rollout_package(paths["good"], api=api, out=sink))
    codes.append(len(api.calls))
    codes.append(api.calls[0]["version"])
    codes.append(deploy.rollout_package(str(tmp_path / "absent.tar.gz"),
                                        api=api, out=sink))
    codes.append(deploy.rollout_package(paths["garbage"], api=api,
                                        out=sink))
    codes.append(deploy.rollout_package(paths["no-weights"], api=api,
                                        out=sink))
    mismatched = recorder("mismatched")
    codes.append(deploy.rollout_package(paths["good"], api=mismatched,
                                        out=sink))
    codes.append(len(mismatched.calls))
    codes.append(deploy.rollout_package(paths["tampered"], api=api,
                                        out=sink))
    current(None)
    codes.append(deploy.rollout_package(paths["good"], api=None, out=sink))
    busy = recorder(RuntimeError("already in flight"))
    codes.append(deploy.rollout_package(paths["good"], api=busy, out=sink))
    codes.append(deploy.main(["rollout", paths["good"], "--timeout", "5"],
                             api=recorder(None)))
    return codes, api.calls[0]


def test_exit_code_matrix_matches_jax(tmp_path, monkeypatch):
    import veles_tpu.serving as jserving

    params, table, params2 = _model()
    jtable = jnp.asarray(table)
    paths = {"good": _package(tmp_path, params2, jtable),
             "no-weights": _package(tmp_path, params2, jtable,
                                    weights=False, tag="nw"),
             "tampered": _package(tmp_path, params2, jtable, tamper=True,
                                  tag="bad")}
    paths["garbage"] = str(tmp_path / "garbage.tar.gz")
    with open(paths["garbage"], "wb") as fout:
        fout.write(b"not a tarball")
    tparams, ttable = _port(params), torch.from_numpy(table)

    def jrec(arg):
        if arg == "mismatched":
            return _Recorder({"only": jtable}, jtable)
        return _Recorder(params, jtable, refuse=arg)

    def trec(arg):
        if arg == "mismatched":
            return _Recorder({"only": ttable}, ttable)
        return _Recorder(tparams, ttable, refuse=arg)

    theirs, _ = _matrix(jdeploy, jrec, tmp_path, paths,
                        lambda v: monkeypatch.setattr(
                            jserving, "_CURRENT_API", v))
    ours, call = _matrix(tdeploy, trec, tmp_path, paths,
                         lambda v: monkeypatch.setattr(
                             tserving, "_CURRENT_API", v))
    assert ours == theirs == [0, 1, "toy-serve@2.0", 2, 2, 2, 2, 0, 3, 4,
                              4, 0]
    want = _port(params2)
    from veles_tpu_torch.device import tree_leaves_with_path
    for (path, a), (_, b) in zip(tree_leaves_with_path(call["params"]),
                                 tree_leaves_with_path(want)):
        assert torch.equal(a, b), path
    assert torch.equal(call["table"], ttable)


def test_forge_path_resolves_where_jax_exits_2(tmp_path, monkeypatch):
    """``name@version`` from a forge store: the port fetches the
    package's bytes and begins the rollout (0); the JAX package unpacks
    the fetch into a directory named pkg.tar.gz and reads it as a file,
    so it exits 2 (ROADMAP C's reference-side failures)."""
    params, table, params2 = _model()
    jtable = jnp.asarray(table)
    server = ForgeServer(str(tmp_path / "store")).start()
    try:
        url = "http://127.0.0.1:%d" % server.port
        with open(_package(tmp_path, params2, jtable), "rb") as fin:
            server.upload(fin.read())
        api = _Recorder(_port(params), torch.from_numpy(table))
        assert tdeploy.rollout_package("toy-serve@2.0", api=api,
                                       forge_url=url,
                                       out=io.StringIO()) == 0
        assert api.calls[0]["version"] == "toy-serve@2.0"
        sink = io.StringIO()
        assert jdeploy.rollout_package(
            "toy-serve@2.0", api=_Recorder(params, jtable),
            forge_url=url, out=sink) == 2
        assert "Is a directory" in sink.getvalue()
        assert tdeploy.rollout_package("toy-serve@9.9", api=api,
                                       forge_url=url,
                                       out=io.StringIO()) == 2
    finally:
        server.stop()


# -- a JAX-written package rolled into a live port api -----------------------

SERVE_KW = dict(slots=2, max_len=32, n_tokens=5, chunk=2)
ROLLOUT = {"steps": (0.3, 1.0), "hold_s": 0.3, "cooldown_s": 0.3,
           "window_s": 5.0, "min_requests": 2, "interval_s": 0.05}
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [2, 2], [9, 8, 7, 6, 5]]


def _hash_point(tenant):
    import zlib
    return (zlib.crc32(tenant.encode()) % 10000) / 10000.0


def _post(port, tokens, tenant=None):
    headers = {"Content-Type": "application/json"}
    if tenant:
        headers["X-Veles-Tenant"] = tenant
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps({"tokens": tokens}).encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())["tokens"]


def _streams(params, table):
    api = tserving.GenerateAPI(params, table, HEADS, device="cpu",
                               **SERVE_KW).start()
    try:
        return [_post(api.port, p) for p in PROMPTS]
    finally:
        api.stop()


@pytest.fixture
def rollout_config():
    from veles_tpu_torch.core.config import root
    saved = {key: root.common.serve.rollout.get(key, None)
             for key in ROLLOUT}
    for key, value in ROLLOUT.items():
        setattr(root.common.serve.rollout, key, value)
    try:
        yield
    finally:
        for key, value in saved.items():
            setattr(root.common.serve.rollout, key, value)


def test_jax_package_rolls_into_port_api(tmp_path, rollout_config):
    from veles_tpu_torch.__main__ import main

    params, table, params2 = _model()
    jtable = jnp.asarray(table)
    tparams, ttable = _port(params), torch.from_numpy(table)
    before = _streams(tparams, ttable)
    after = _streams(_port(params2), ttable)
    assert before != after
    server = ForgeServer(str(tmp_path / "store")).start()
    api = tserving.GenerateAPI(tparams, ttable, HEADS, device="cpu",
                               **SERVE_KW).start()
    try:
        url = "http://127.0.0.1:%d" % server.port
        for tag, tamper in (("good", False), ("bad", True)):
            with open(_package(tmp_path, params2, jtable, tag=tag,
                               version="2.0" if tag == "good" else "2.1",
                               tamper=tamper), "rb") as fin:
                blob = fin.read()
            if tamper:
                path = str(tmp_path / "bad.tar.gz")
                with open(path, "wb") as fout:
                    fout.write(blob)
            else:
                server.upload(blob)
        assert tserving.get_current_api() is api
        assert [_post(api.port, p) for p in PROMPTS] == before
        assert main(["deploy", "rollout", "toy-serve@2.0", "--forge-url",
                     url, "--timeout", "60"]) == 0
        rollout = api._rollout
        assert rollout is not None and rollout.version == "toy-serve@2.0"
        # a second rollout while one is in flight, then a tampered
        # package: refused, the live streams untouched
        assert main(["deploy", "rollout", "toy-serve@2.0", "--forge-url",
                     url]) == 4
        assert main(["deploy", "rollout", path]) == 3
        tenants = ["t%d" % i for i in range(1000)]
        green = next(t for t in tenants if _hash_point(t) < 0.3)
        blue = next(t for t in tenants if _hash_point(t) >= 0.3)
        # no green traffic yet, so the ramp has not moved: blue serves the
        # old weights, green the new
        assert rollout.state == "shifting"
        assert [_post(api.port, p, blue) for p in PROMPTS] == before
        assert [_post(api.port, p, green) for p in PROMPTS] == after
        deadline = time.monotonic() + 60
        while rollout.state not in ("promoted", "rolled_back") \
                and time.monotonic() < deadline:
            assert _post(api.port, PROMPTS[0], green) == after[0]
            assert _post(api.port, PROMPTS[1], blue) in (before[1],
                                                        after[1])
        assert rollout.state == "promoted", rollout.snapshot()
        assert api.version == "toy-serve@2.0"
        assert [_post(api.port, p) for p in PROMPTS] == after
    finally:
        api.stop()
        server.stop()
