"""The port's forge (veles_tpu_torch/forge/) on the CPU, held against the
JAX package's (veles_tpu/forge/, tests/test_forge.py's model directory).

The package format: one directory packed by both packages gives the same
bytes, with and without AOT artifact members; ``validate_manifest``,
``read_manifest``, ``verify_artifact_members`` and ``unpack`` refuse the
same inputs with the same errors; ``deploy_version`` agrees. The server:
one scripted HTTP sequence (register, uploads good and bad, the
listings, history, diff, fetch, delete, the owner rule, a single 413)
against both servers gives equal status codes and bodies apart from
times and tokens; a store that one package's server wrote is served by
the other's. Port-only: a fetched workflow package runs through the
port's launcher (tests/test_forge.py::test_fetched_model_runs)."""

import io
import json
import os
import socket
import tarfile
import urllib.error
import urllib.request

import pytest
import torch

from veles_tpu.forge import ForgeServer as JForgeServer
from veles_tpu.forge import package as jpkg
from veles_tpu_torch.forge import ForgeClient, ForgeServer
from veles_tpu_torch.forge import package as tpkg

torch.set_num_threads(1)

TOKEN = "sekrit"


def make_model_dir(path, name="toy-model", version="1.0", cfg="1"):
    """tests/test_forge.py's package: a manifest, a port workflow that
    trains a six-feature toy MLP for two epochs, and a config file."""
    os.makedirs(path)
    with open(os.path.join(path, "manifest.json"), "w") as fout:
        json.dump({"name": name, "version": version,
                   "short_description": "toy model", "workflow": "wf.py",
                   "config": "cfg.py", "requires": ["numpy"]}, fout)
    with open(os.path.join(path, "wf.py"), "w") as fout:
        fout.write('''
import numpy
from veles_tpu_torch.models.mlp import MLPWorkflow

def run(load, main):
    rng = numpy.random.RandomState(0)
    X = rng.rand(60, 6).astype(numpy.float32)
    y = (X[:, 0] > 0.5).astype(numpy.int32)
    load(MLPWorkflow, layers=(6, 2),
         loader_kwargs=dict(data=X, labels=y, class_lengths=[0, 20, 40],
                            minibatch_size=20),
         learning_rate=0.5, max_epochs=2)
    main()
''')
    with open(os.path.join(path, "cfg.py"), "w") as fout:
        fout.write("root.toy.x = %s\n" % cfg)
    return str(path)


def with_artifact(directory, blob=b"bundle bytes " * 64, tamper=False,
                  sidecar=True):
    """Stage a stand-in artifact member and its sidecar as
    ``aot build --forge-dir`` does, optionally flipping one byte after
    the sidecar was written."""
    import hashlib

    with open(os.path.join(directory, "b.aot.tar"), "wb") as fout:
        fout.write(blob)
    if sidecar:
        with open(os.path.join(directory, "b.aot.tar.sha256"), "w") as fout:
            fout.write("%s  b.aot.tar\n" % hashlib.sha256(blob).hexdigest())
    if tamper:
        with open(os.path.join(directory, "b.aot.tar"), "wb") as fout:
            fout.write(blob[:-1] + bytes([blob[-1] ^ 1]))
    path = os.path.join(directory, "manifest.json")
    with open(path) as fin:
        manifest = json.load(fin)
    manifest["artifacts"] = ["b.aot.tar"]
    with open(path, "w") as fout:
        json.dump(manifest, fout)
    return directory


def packed(pkg, directory, out):
    path, _ = pkg.pack(directory, out_path=out)
    with open(path, "rb") as fin:
        return fin.read()


def outcome(fn, *args):
    """A call's result, or its exception's type name and text."""
    try:
        return ("ok", fn(*args))
    except Exception as exc:   # noqa: BLE001 - compared, not handled
        return (type(exc).__name__, str(exc))


# -- the package format ------------------------------------------------------

@pytest.mark.parametrize("artifact", [False, True])
def test_pack_gives_the_jax_bytes(tmp_path, artifact):
    d = make_model_dir(str(tmp_path / "m"))
    if artifact:
        with_artifact(d)
    ours = packed(tpkg, d, str(tmp_path / "port.tar.gz"))
    theirs = packed(jpkg, d, str(tmp_path / "jax.tar.gz"))
    assert ours == theirs
    assert packed(tpkg, d, str(tmp_path / "again.tar.gz")) == ours
    assert tpkg.read_manifest(theirs) == jpkg.read_manifest(ours)
    assert tpkg.file_inventory(ours) == jpkg.file_inventory(ours)
    assert tpkg.verify_artifact_members(theirs) == \
        jpkg.verify_artifact_members(ours)
    dest = str(tmp_path / "out")
    assert tpkg.unpack(theirs, dest) == jpkg.read_manifest(theirs)
    assert sorted(os.listdir(dest)) == sorted(
        name for name in os.listdir(d) if not name.endswith(".tar.gz"))


MANIFESTS = [
    {"workflow": "wf.py"},
    {"name": "../evil", "workflow": "w"},
    {"name": "x"},
    {"name": "x", "workflow": "w", "requires": ["numpy", "numpy>=1"]},
    {"name": "x", "workflow": "w", "requires": "numpy"},
    {"name": "x", "workflow": "w", "version": "../2.0"},
    {"name": "x", "workflow": "w", "version": "v 2"},
    {"name": "x", "workflow": "w", "artifacts": ["", "b"]},
    ["not", "a", "dict"],
    {"name": "x", "workflow": "w", "version": "2.0",
     "requires": ["numpy>=1", "torch"], "artifacts": ["b.aot.tar"]},
]


@pytest.mark.parametrize("manifest", MANIFESTS)
def test_validate_manifest_and_deploy_version_agree(manifest):
    assert outcome(tpkg.validate_manifest, manifest) == \
        outcome(jpkg.validate_manifest, manifest)
    assert outcome(tpkg.deploy_version, manifest) == \
        outcome(jpkg.deploy_version, manifest)


def _tar(members):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name, payload in members:
            info = tarfile.TarInfo(name)
            if payload is None:
                info.type = tarfile.SYMTYPE
                info.linkname = "/etc/passwd"
            else:
                info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload or b""))
    return buf.getvalue()


MANIFEST = json.dumps({"name": "evil", "workflow": "w.py"}).encode()
BLOBS = {
    "traversal": _tar([("manifest.json", MANIFEST),
                       ("../escape.txt", b"boom")]),
    "absolute": _tar([("manifest.json", MANIFEST),
                      ("/tmp/abs.txt", b"boom")]),
    "link": _tar([("manifest.json", MANIFEST), ("link", None),
                  ("w.py", b"")]),
    "no-manifest": _tar([("w.py", b"")]),
    "bad-manifest": _tar([("manifest.json",
                           json.dumps({"name": "../x"}).encode())]),
    "junk": b"this is not a tarball",
}


@pytest.mark.parametrize("case", sorted(BLOBS))
def test_unpack_refuses_as_jax(tmp_path, case):
    blob = BLOBS[case]
    ours = outcome(tpkg.unpack, blob, str(tmp_path / "port"))
    theirs = outcome(jpkg.unpack, blob, str(tmp_path / "jax"))
    assert ours == theirs
    assert not (tmp_path / "escape.txt").exists()
    if ours[0] == "ok":
        assert sorted(os.listdir(tmp_path / "port")) == \
            sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("case", ["tampered", "no-sidecar", "no-member"])
def test_artifact_refusals_agree(tmp_path, case):
    d = make_model_dir(str(tmp_path / "m"))
    with_artifact(d, tamper=case == "tampered",
                  sidecar=case != "no-sidecar")
    if case == "no-member":
        os.unlink(os.path.join(d, "b.aot.tar"))
        # pack refuses a listed artifact that is absent: build the
        # archive by hand, as a corrupt upload would arrive
        blob = _tar([(name, open(os.path.join(d, name), "rb").read())
                     for name in sorted(os.listdir(d))])
    elif case == "no-sidecar":
        blob = _tar([(name, open(os.path.join(d, name), "rb").read())
                     for name in sorted(os.listdir(d))])
    else:
        blob = packed(tpkg, d, str(tmp_path / "p.tar.gz"))
    ours = outcome(tpkg.verify_artifact_members, blob)
    assert ours[0] == "TamperedPackageError"
    assert ours == outcome(jpkg.verify_artifact_members, blob)
    if case != "tampered":
        assert outcome(tpkg.pack, d) == outcome(jpkg.pack, d)


# -- the server --------------------------------------------------------------

def _request(port, method, path, body=None, headers=None):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path), data=body,
        headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers.get("Content-Type"), \
                resp.read()
    except urllib.error.HTTPError as err:
        with err:
            return err.code, err.headers.get("Content-Type"), err.read()


def _oversized_register(port):
    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        sock.sendall(b"POST /register HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: 9999999999\r\n\r\n")
        sock.settimeout(10)
        chunks = []
        while True:
            data = sock.recv(4096)
            if not data:
                break
            chunks.append(data)
    text = b"".join(chunks).decode(errors="replace")
    return text.split("\r\n")[0], text.count("HTTP/1.0")


def _normalized(body):
    """A reply body with its times, sizes of time-stamped files, emails'
    tokens and error texts' object addresses taken out."""
    try:
        doc = json.loads(body.decode())
    except (UnicodeDecodeError, ValueError):
        return body

    def walk(node):
        if isinstance(node, dict):
            return {key: ("<t>" if key in ("uploaded", "issued", "token")
                          else walk(val)) for key, val in node.items()}
        if isinstance(node, list):
            return [walk(val) for val in node]
        return node
    return walk(doc)


def _script(tmp_path, server_cls, tag):
    """One scripted session against a fresh server of ``server_cls``:
    every step's (status, content type, normalized body)."""
    root_dir = tmp_path / ("store-" + tag)
    server = server_cls(str(root_dir), token=TOKEN).start()
    port = server.port
    blobs = {}
    for name, kwargs in (("v1", {}), ("v2", {"version": "2.0", "cfg": "2"}),
                         ("v3", {"version": "3.0"}),
                         ("other", {"name": "other-model"})):
        d = make_model_dir(str(tmp_path / tag / name), **kwargs)
        if name == "v2":
            with open(os.path.join(d, "README.md"), "w") as fout:
                fout.write("new in 2.0\n")
        blobs[name] = packed(jpkg, d, str(tmp_path / tag / (name + ".tgz")))
    tampered = make_model_dir(str(tmp_path / tag / "bad"), version="9.0")
    blobs["bad"] = packed(jpkg, with_artifact(tampered, tamper=True),
                          str(tmp_path / tag / "bad.tgz"))
    master = {"X-Forge-Token": TOKEN,
              "Content-Type": "application/octet-stream"}
    steps = []
    try:
        def step(method, path, body=None, headers=None):
            status, kind, payload = _request(port, method, path, body,
                                             headers)
            steps.append((method, path, status, kind,
                          _normalized(payload)))
            return payload

        step("GET", "/service?query=list")
        step("POST", "/upload", blobs["v1"], {"Content-Type": "x"})
        step("POST", "/upload", blobs["v1"], master)
        step("POST", "/upload", blobs["v1"], master)
        step("POST", "/upload?version=../../tmp/evil", blobs["v1"], master)
        step("POST", "/upload", b"this is not a tarball", master)
        step("POST", "/upload", blobs["bad"], master)
        step("POST", "/register", b'{"email": "not-an-email"}')
        step("POST", "/register", b"{not json")
        dev = json.loads(step("POST", "/register",
                              b'{"email": "dev@example.com"}'))["token"]
        eve = json.loads(step("POST", "/register",
                              b'{"email": "eve@example.com"}'))["token"]
        step("POST", "/upload", blobs["v2"],
             dict(master, **{"X-Forge-Token": eve}))
        step("POST", "/upload", blobs["other"],
             dict(master, **{"X-Forge-Token": dev}))
        step("POST", "/upload", blobs["v2"], master)
        for query in ("list", "details&name=toy-model",
                      "details&name=nobody", "history&name=toy-model",
                      "history&name=other-model",
                      "diff&name=toy-model&from=1.0&to=2.0",
                      "diff&name=toy-model&from=1.0&to=9.9", "nonsense"):
            step("GET", "/service?query=" + query)
        for query in ("name=toy-model", "name=toy-model&version=1.0",
                      "name=toy-model&version=../../etc/passwd",
                      "name=nobody"):
            step("GET", "/fetch?" + query)
        step("POST", "/delete?name=other-model", b"",
             dict(master, **{"X-Forge-Token": dev}))
        step("POST", "/upload", blobs["v3"],
             dict(master, **{"X-Forge-Token": dev}))
        step("POST", "/delete?name=toy-model&version=2.0", b"", master)
        step("GET", "/service?query=details&name=toy-model")
        step("POST", "/delete?name=nobody", b"", master)
        step("POST", "/nowhere", b"", master)
        step("GET", "/nowhere")
        steps.append(("POST", "/register (oversized)",
                      _oversized_register(port)))
        step("GET", "/service?query=list")
    finally:
        server.stop()
    return steps


def test_scripted_session_matches_jax(tmp_path):
    ours = _script(tmp_path, ForgeServer, "port")
    theirs = _script(tmp_path, JForgeServer, "jax")
    assert len(ours) == len(theirs)
    for mine, want in zip(ours, theirs):
        assert mine == want, (mine[:3], want[:3])
    codes = [row[2] for row in ours if len(row) == 5]
    assert {200, 400, 403, 404, 422} <= set(codes)
    assert ours[-2][2] == (ours[-2][2][0], 1) and "413" in ours[-2][2][0]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_served_by_the_other_package(tmp_path, writer):
    """A store one package's server wrote (versions, owner, tokens) is
    served by the other's: the same listing, details, history and bytes,
    and the owner rule still holds across the two."""
    first, second = ((ForgeServer, JForgeServer) if writer == "port"
                     else (JForgeServer, ForgeServer))
    store = str(tmp_path / "store")
    blob = packed(jpkg, make_model_dir(str(tmp_path / "v1")),
                  str(tmp_path / "v1.tgz"))
    server = first(store, token=TOKEN)
    server.upload(blob, uploaded_by="master")
    issued = server.register("dev@example.com")["token"]
    details = server.details("toy-model")
    server = second(store, token=TOKEN).start()
    try:
        assert server.details("toy-model") == details
        assert server.fetch("toy-model") == blob
        assert [m["name"] for m in server.list_models()] == ["toy-model"]
        assert server.history("toy-model")["latest"] == "1.0"
        registered = ForgeClient("http://127.0.0.1:%d" % server.port,
                                 token=issued)
        with pytest.raises(urllib.error.HTTPError) as err:
            registered.upload(make_model_dir(str(tmp_path / "v2"),
                                             version="2.0"))
        assert err.value.code == 403
        dest, manifest = registered.fetch("toy-model",
                                          dest=str(tmp_path / "got"))
        assert manifest == jpkg.read_manifest(blob)
        assert sorted(os.listdir(dest)) == ["cfg.py", "manifest.json",
                                            "wf.py"]
    finally:
        server.stop()


def test_fetched_model_runs(tmp_path):
    """The full hub story on the port: upload, fetch, run the fetched
    workflow through the port's launcher."""
    import veles_tpu_torch
    from veles_tpu_torch.core.config import root

    server = ForgeServer(str(tmp_path / "store"), token=TOKEN).start()
    try:
        client = ForgeClient("http://127.0.0.1:%d" % server.port,
                             token=TOKEN)
        assert client.upload(make_model_dir(str(tmp_path / "m"))) == {
            "name": "toy-model", "version": "1.0"}
        dest, manifest = client.fetch("toy-model",
                                      dest=str(tmp_path / "run"))
    finally:
        server.stop()
    launcher = veles_tpu_torch(os.path.join(dest, manifest["workflow"]),
                               os.path.join(dest, manifest["config"]),
                               device="cpu")
    assert launcher.workflow.decision.epochs_done >= 2
    assert root.toy.x == 1
