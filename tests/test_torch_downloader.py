"""The port's downloader (veles_tpu_torch/downloader.py), ``MNISTLoader``'s
``url_base`` and ``loader/hdfs.py`` against the JAX package's on the CPU.

Mirrors tests/test_downloader.py (local files and ``file://`` URLs only)
and tests/test_dataset_formats.py::TestHDFSTextLoader (an in-process
WebHDFS stub). Each case runs both packages on the same files and holds
the extracted members, the markers, the loaded arrays and the streamed
lines equal."""

import gzip
import hashlib
import http.server
import json
import os
import pickle
import struct
import tarfile
import threading
import zipfile

import numpy
import pytest
import torch

from veles_tpu import downloader as jdownloader
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.loader.hdfs import HDFSTextLoader as JHDFSTextLoader
from veles_tpu.loader.mnist import MNISTLoader as JMNISTLoader
from veles_tpu_torch import downloader
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.loader.hdfs import HDFSTextLoader
from veles_tpu_torch.loader.mnist import FILES, MNISTLoader, read_idx

torch.set_num_threads(1)

PACKAGES = (("port", downloader), ("jax", jdownloader))


def _cpu_workflow():
    wf = DummyWorkflow()
    wf.device = torch.device("cpu")
    return wf


def _write_idx(path, array):
    codes = {numpy.uint8: 0x08, numpy.int32: 0x0C, numpy.float32: 0x0D}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as out:
        out.write(struct.pack(">HBB", 0, codes[array.dtype.type],
                              array.ndim))
        out.write(struct.pack(">" + "I" * array.ndim, *array.shape))
        out.write(array.astype(array.dtype.newbyteorder(">")).tobytes())


def _fake_mnist(directory, n_train=120, n_test=40, suffix=""):
    rng = numpy.random.RandomState(0)
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    for prefix, n in (("train", n_train), ("t10k", n_test)):
        arrays[prefix] = rng.randint(0, 256, (n, 28, 28)).astype(
            numpy.uint8)
        _write_idx(os.path.join(directory, "%s-images-idx3-ubyte%s"
                                % (prefix, suffix)), arrays[prefix])
        _write_idx(os.path.join(directory, "%s-labels-idx1-ubyte%s"
                                % (prefix, suffix)),
                   rng.randint(0, 10, n).astype(numpy.uint8))
    return arrays


def _tree(directory):
    """Every file under ``directory``: relative path -> bytes."""
    out = {}
    for base, _, files in os.walk(directory):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as fin:
                out[os.path.relpath(path, directory)] = fin.read()
    return out


def _archives(tmp_path):
    """One payload in every container fetch unpacks: a plain file, .gz,
    .tar, .tar.gz, .tar.bz2, .tar.xz and .zip."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_text("hello")
    (src / "b.bin").write_bytes(bytes(range(256)) * 3)
    made = {"plain.bin": str(src / "b.bin")}
    with open(str(src / "b.bin"), "rb") as fin, \
            gzip.open(str(tmp_path / "single.bin.gz"), "wb") as out:
        out.write(fin.read())
    made["gz"] = str(tmp_path / "single.bin.gz")
    for mode, ext in (("w", "tar"), ("w:gz", "tar.gz"),
                      ("w:bz2", "tar.bz2"), ("w:xz", "tar.xz")):
        path = str(tmp_path / ("data." + ext))
        with tarfile.open(path, mode) as tar:
            tar.add(str(src / "a.txt"), arcname="a.txt")
            tar.add(str(src / "b.bin"), arcname="sub/b.bin")
        made[ext] = path
    path = str(tmp_path / "data.zip")
    with zipfile.ZipFile(path, "w") as zf:
        zf.write(str(src / "a.txt"), "a.txt")
        zf.write(str(src / "b.bin"), "sub/b.bin")
    made["zip"] = path
    return made


@pytest.mark.parametrize("kind", ["plain.bin", "gz", "tar", "tar.gz",
                                  "tar.bz2", "tar.xz", "zip"])
@pytest.mark.parametrize("scheme", ["path", "file"])
def test_fetch_unpacks_as_jax(tmp_path, kind, scheme):
    """Each container, from a local path and a file:// URL: the same
    members returned and the same files (with the .ok marker) on disk."""
    source = _archives(tmp_path)[kind]
    url = source if scheme == "path" else "file://" + source
    got = {}
    for name, pkg in PACKAGES:
        out = str(tmp_path / name)
        members = pkg.fetch(url, out)
        got[name] = ([os.path.relpath(m, out) for m in members],
                     _tree(out))
    assert got["port"] == got["jax"]
    members, files = got["port"]
    marker = os.path.basename(source) + ".ok"
    assert files[marker] == b"ok\n"
    if kind.startswith("tar") or kind == "zip":
        assert files["a.txt"] == b"hello"
        assert files[os.path.join("sub", "b.bin")] == \
            bytes(range(256)) * 3


def test_fetch_returns_at_its_marker(tmp_path):
    """A second fetch of a complete download returns at the .ok marker:
    it neither copies nor unpacks again (a removed source is not read)."""
    source = _archives(tmp_path)["tar.gz"]
    for name, pkg in PACKAGES:
        out = str(tmp_path / name)
        pkg.fetch(source, out)
        os.remove(os.path.join(out, "a.txt"))
    os.remove(source)
    for name, pkg in PACKAGES:
        out = str(tmp_path / name)
        assert pkg.fetch(source, out) == [os.path.join(out, "data.tar.gz")]
        assert not os.path.exists(os.path.join(out, "a.txt"))


def test_fetch_checksum(tmp_path):
    payload = tmp_path / "x.bin"
    payload.write_bytes(b"data")
    good = hashlib.sha256(b"data").hexdigest()
    for name, pkg in PACKAGES:
        with pytest.raises(ValueError, match="sha256 mismatch"):
            pkg.fetch(str(payload), str(tmp_path / name / "bad"),
                      checksum="0" * 64)
        # the mismatched copy is removed and no marker is written
        assert os.listdir(str(tmp_path / name / "bad")) == []
        assert pkg.fetch(str(payload), str(tmp_path / name / "good"),
                         checksum=good) == [
            str(tmp_path / name / "good" / "x.bin")]


def test_downloader_unit_file_url(tmp_path):
    src = tmp_path / "dataset.tar.gz"
    inner = tmp_path / "weights.npy"
    numpy.save(str(inner), numpy.arange(3.0))
    with tarfile.open(str(src), "w:gz") as tar:
        tar.add(str(inner), arcname="weights.npy")
    units = []
    for name, wf, pkg in (("port", _cpu_workflow(), downloader),
                          ("jax", JDummyWorkflow(), jdownloader)):
        unit = pkg.Downloader(wf, url="file://" + str(src),
                              directory=str(tmp_path / name),
                              files=["weights.npy"])
        assert unit.initialize() is None
        units.append(unit)
    for name in ("port", "jax"):
        numpy.testing.assert_array_equal(
            numpy.load(str(tmp_path / name / "weights.npy")),
            numpy.arange(3.0))
    # a second initialize returns on the files (the source is gone)
    src.unlink()
    for unit in units:
        assert unit.initialize() is None
    # a file the archive does not hold is missing afterwards
    missing = downloader.Downloader(
        _cpu_workflow(), url="file://" + str(tmp_path / "none.tar.gz"),
        directory=str(tmp_path / "other"), files=["weights.npy"])
    with pytest.raises((FileNotFoundError, OSError)):
        missing.initialize()


def test_downloader_needs_a_directory(tmp_path):
    from veles_tpu_torch.core.config import root
    assert root.common.dirs.get("datasets", None) is None
    with pytest.raises(ValueError, match="needs a directory"):
        downloader.Downloader(_cpu_workflow(), url="file:///x.tar")


def test_mnist_url_base_fetches_then_reads_in_place(tmp_path):
    """MNISTLoader(url_base="file://...") on gzipped idx files: both
    packages fetch the four, load the same arrays, and a second loader
    over the same directory fetches nothing (the members and markers are
    there: a removed source is not read)."""
    src = str(tmp_path / "src")
    arrays = _fake_mnist(src, suffix=".gz")
    loaded = {}
    for name, cls, wf in (("port", MNISTLoader, _cpu_workflow()),
                          ("jax", JMNISTLoader, JDummyWorkflow())):
        loader = cls(wf, directory=str(tmp_path / name),
                     url_base="file://" + src, minibatch_size=20)
        loader.initialize()
        loaded[name] = loader
    port, jax_loader = loaded["port"], loaded["jax"]
    numpy.testing.assert_array_equal(
        port.original_data.data.numpy(),
        numpy.asarray(jax_loader.original_data.data))
    numpy.testing.assert_array_equal(
        port.original_labels.data.numpy(),
        numpy.asarray(jax_loader.original_labels.data))
    assert port.class_lengths == jax_loader.class_lengths == [0, 40, 120]
    numpy.testing.assert_array_equal(
        read_idx(str(tmp_path / "port" / FILES["train_images"])),
        arrays["train"])
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    before = _tree(str(tmp_path / "port"))
    for name in os.listdir(src):
        os.remove(os.path.join(src, name))
    again = MNISTLoader(_cpu_workflow(), directory=str(tmp_path / "port"),
                        url_base="file://" + src, minibatch_size=20)
    again.initialize()
    assert _tree(str(tmp_path / "port")) == before
    numpy.testing.assert_array_equal(again.original_data.data.numpy(),
                                     port.original_data.data.numpy())


@pytest.fixture
def webhdfs():
    """An in-process WebHDFS namenode (tests/test_dataset_formats.py:
    163-192): GETFILESTATUS and OPEN of one 25-line file; it records the
    requests' queries."""
    lines = ["line %d" % i for i in range(25)]
    payload = ("\n".join(lines) + "\n").encode()
    seen = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append(self.path)
            if "op=GETFILESTATUS" in self.path:
                body = json.dumps({"FileStatus": {
                    "length": len(payload), "type": "FILE"}}).encode()
            elif "op=OPEN" in self.path:
                body = payload
            else:
                self.send_error(400)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield "127.0.0.1:%d" % server.server_port, lines, seen
    server.shutdown()
    server.server_close()


def _stream(loader):
    chunks = []
    while not loader.finished:
        loader.run()
        chunks.append(list(loader.output))
    return chunks


def test_hdfs_chunked_streaming_as_jax(webhdfs):
    """Both loaders stream the stub's file in chunks of 10 (the last cut
    to its 5 lines, finished set), with the same requests; a pickled
    loader resumes past the lines it served."""
    address, lines, seen = webhdfs
    got = {}
    for name, cls, wf in (("port", HDFSTextLoader, _cpu_workflow()),
                          ("jax", JHDFSTextLoader, JDummyWorkflow())):
        del seen[:]
        loader = cls(wf, file="/data/corpus.txt", address=address,
                     chunk=10, user="veles")
        assert loader.stat() == {
            "length": len(("\n".join(lines) + "\n").encode()),
            "type": "FILE"}
        loader.initialize()
        got[name] = (_stream(loader), list(seen))
    assert got["port"] == got["jax"]
    chunks, requests = got["port"]
    assert chunks == [lines[:10], lines[10:20], lines[20:25]]
    assert all("user.name=veles" in r for r in requests)
    assert requests[0].startswith("/webhdfs/v1/data/corpus.txt?op=")
    # resume: a loader pickled after its first chunk re-opens past it
    loader = HDFSTextLoader(_cpu_workflow(), file="/data/corpus.txt",
                            address="http://" + address, chunk=10)
    loader.initialize()
    loader.run()
    resumed = pickle.loads(pickle.dumps(loader))
    assert resumed.lines_consumed == 10
    resumed.initialize()
    assert _stream(resumed) == [lines[10:20], lines[20:25]]
