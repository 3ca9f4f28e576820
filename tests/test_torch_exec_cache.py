"""The port's persistent library cache (veles_tpu_torch/aot/exec_cache.py)
on the CPU: an entry round-trips; a torn entry (``serving_chaos.
tear_file``), a bit-flipped one and one without its sidecar are refused
with ONE warning each, unlinked and counted in ``rejects`` and
``misses``; the sidecar is renamed before the entry; two threads storing
one key never cross an entry with the other's sidecar; the key moves
with every field it digests; and ``resolve_cache`` resolves as the JAX
package's does. The cache holds built libraries, so an entry here is
any bytes: the loader's use of it is in tests/test_torch_aot.py."""

import logging
import os
import threading

import pytest
import torch

from veles_tpu.aot import exec_cache as jcache
from veles_tpu.core.config import root as jroot
from veles_tpu_torch.aot import exec_cache as tcache
from veles_tpu_torch.core.config import root as troot
from veles_tpu_torch.serving_chaos import tear_file

torch.set_num_threads(1)

LIBRARY = b"\x7fELF" + bytes(range(256)) * 64
ROW = {"name": "int8_matmul", "digest": "ab" * 32}


@pytest.fixture
def cache(tmp_path):
    return tcache.ExecutableCache(str(tmp_path / "xcache"))


def _key(**env):
    fingerprint = dict(tcache.cache_fingerprint(), **env)
    return tcache.entry_key(ROW, fingerprint)


def test_round_trip(cache):
    key = _key()
    assert cache.load(key) is None
    path = cache.store(key, LIBRARY)
    assert path == cache.path(key) and path.endswith(".so")
    assert cache.load(key) == path
    with open(path, "rb") as fin:
        assert fin.read() == LIBRARY
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1
    assert cache.stats()["writes"] == 1 and cache.stats()["rejects"] == 0


@pytest.mark.parametrize("damage", ["torn", "flipped", "no_sidecar"])
def test_damaged_entry_refused_once_unlinked_and_counted(cache, damage,
                                                         caplog):
    key = _key(device_kind="damage-%s" % damage)
    path = cache.store(key, LIBRARY)
    before = tcache.totals()
    if damage == "torn":
        assert tear_file(path) < len(LIBRARY)
    elif damage == "flipped":
        with open(path, "r+b") as fout:
            fout.seek(10)
            byte = fout.read(1)
            fout.seek(10)
            fout.write(bytes([byte[0] ^ 1]))
    else:
        os.remove(path + ".sha256")
    with caplog.at_level(logging.WARNING, logger="aot.ExecCache"):
        assert cache.load(key) is None
        # refused entries are unlinked, so a second look is a plain miss
        assert cache.load(key) is None
        # the same damage again warns no more
        cache.store(key, LIBRARY)
        if damage == "torn":
            tear_file(path)
        elif damage == "flipped":
            with open(path, "r+b") as fout:
                fout.write(b"\0")
        else:
            os.remove(path + ".sha256")
        assert cache.load(key) is None
    warned = [r for r in caplog.records if "refused" in r.getMessage()]
    assert len(warned) == 1 and path in warned[0].getMessage()
    assert not os.path.exists(path)
    stats = cache.stats()
    assert stats["rejects"] == 2 and stats["misses"] == 3
    after = tcache.totals()
    assert after["rejects"] - before["rejects"] == 2
    assert after["misses"] - before["misses"] == 3
    # the next store repairs the entry
    cache.store(key, LIBRARY)
    assert cache.load(key) == path


def test_sidecar_renamed_first(cache, monkeypatch):
    renamed = []
    real = os.replace

    def recording(src, dst):
        renamed.append(os.path.basename(dst))
        return real(src, dst)

    monkeypatch.setattr(tcache.os, "replace", recording)
    key = _key()
    cache.store(key, LIBRARY)
    assert renamed == [key + ".so.sha256", key + ".so"]


def test_two_threads_storing_one_key_do_not_interleave(cache):
    key = _key()
    blobs = [bytes([i]) * 4096 for i in range(8)]
    for _ in range(5):
        barrier = threading.Barrier(len(blobs))

        def store(blob):
            barrier.wait()
            cache.store(key, blob)

        threads = [threading.Thread(target=store, args=(blob,))
                   for blob in blobs]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=30)
        # whichever thread renamed last, its entry and its sidecar agree
        assert cache.load(key) == cache.path(key)
        with open(cache.path(key), "rb") as fin:
            assert fin.read() in blobs
    assert cache.stats()["rejects"] == 0
    assert not [name for name in os.listdir(cache.directory)
                if ".tmp" in name]


@pytest.mark.parametrize("field,value", [
    ("schema", 99), ("torch", "0.0.1"), ("cuda", "0.0"),
    ("device_kind", "another card"), ("device_count", 8)])
def test_key_moves_with_the_environment(field, value):
    assert _key(**{field: value}) != _key()
    assert tcache.entry_key(dict(ROW, digest="cd" * 32),
                            tcache.cache_fingerprint()) != _key()
    assert tcache.cache_fingerprint()["schema"] == tcache.CACHE_SCHEMA


def test_unwritable_directory_returns_none(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    cache = tcache.ExecutableCache(str(blocker / "sub"))
    assert cache.store(_key(), LIBRARY) is None
    assert cache.stats()["writes"] == 0


@pytest.mark.parametrize("arg", [None, False, True, "dir", "config",
                                 "config_true"])
def test_resolve_cache_matches_jax(arg, tmp_path, monkeypatch):
    bundle = str(tmp_path / "b.aot.tar")
    directory = str(tmp_path / "elsewhere")
    setting = None
    if arg == "dir":
        arg = directory
    elif arg in ("config", "config_true"):
        setting = directory if arg == "config" else True
        arg = None
    for cfg in (troot, jroot):
        monkeypatch.setattr(cfg.common.serve, "aot_cache", setting,
                            raising=False)
    ours = tcache.resolve_cache(arg, bundle)
    theirs = jcache.resolve_cache(arg, bundle)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours.directory == theirs.directory
    given = tcache.ExecutableCache(directory)
    assert tcache.resolve_cache(given, bundle) is given
    assert tcache.resolve_cache(True, None) is None
