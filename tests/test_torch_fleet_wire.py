"""The port's fleet wire (veles_tpu_torch/fleet/protocol.py, safecodec.py,
sharedio.py), its job ledger, chaos monkey and respawn manager against
the JAX package's on the CPU.

Frames cross between the packages: the same message encodes to the same
safe-codec bytes, and each package decodes the other's pickle, safe and
shared-memory frames. Every refusal of tests/test_fleet.py's
TestProtocol, TestSharedIO and TestSafeCodec still refuses on the port.
One scripted sequence of lease, settle, expire, drop and stale-epoch
operations gives both ledgers the same outcomes; equal seeds give both
chaos monkeys the same decisions in the same order; the respawn
managers back off and spend their budgets alike, and a spawned slave
runs ``python -m veles_tpu_torch``. The one loopback here (the
shared-memory negotiation) joins its fleet with a deadline."""

import asyncio
import gzip
import io
import json
import os
import pickle
import struct
import sys
import threading

import numpy
import pytest
import torch

from veles_tpu.core.config import root as jroot
from veles_tpu.fleet import chaos as jchaos
from veles_tpu.fleet import ledger as jledger
from veles_tpu.fleet import protocol as jprotocol
from veles_tpu.fleet import respawn as jrespawn
from veles_tpu.fleet import safecodec as jsafecodec
from veles_tpu_torch.core.config import root
from veles_tpu_torch.fleet import chaos, ledger, protocol, respawn, safecodec
from veles_tpu_torch.fleet import sharedio
from veles_tpu_torch.fleet.protocol import ProtocolError, _mac, encode_frame

torch.set_num_threads(1)

KEY = b"test-secret"


class FakeReader:
    def __init__(self, data):
        self.buf = io.BytesIO(data)

    async def readexactly(self, n):
        data = self.buf.read(n)
        if len(data) < n:
            raise asyncio.IncompleteReadError(data, n)
        return data


def _read(frame, module=protocol, **kwargs):
    return asyncio.run(module.read_frame(FakeReader(frame), KEY, **kwargs))


def _raw_frame(codec, payload):
    """A frame with any codec byte and a VALID MAC: the refusal comes
    after authentication."""
    return (struct.pack(">IB", len(payload), codec)
            + _mac(KEY, codec, payload) + payload)


def _message():
    import ml_dtypes
    return {
        "type": "job", "n": 7, "f": 1.5, "flag": True, "none": None,
        "name": "unit", "raw": b"\x00\xffbytes",
        "list": [1, [2.5, "x"], {"k": (1, 2)}], "tuple": (3, "y"),
        5: "int-key", (1, "t"): "tuple-key",
        "arr": numpy.arange(12, dtype=numpy.float32).reshape(3, 4),
        "i64": numpy.arange(3, dtype=numpy.int64),
        "bf16": numpy.ones((2, 2), ml_dtypes.bfloat16),
        "scalar": numpy.float32(2.25)}


@pytest.fixture
def safe_wire():
    """Both packages on the safe codec, restored after the test."""
    saved = (root.common.fleet.get("codec", "pickle"),
             jroot.common.fleet.get("codec", "pickle"))
    root.common.fleet.codec = jroot.common.fleet.codec = "safe"
    yield
    root.common.fleet.codec, jroot.common.fleet.codec = saved


def _assert_same(got, want):
    assert sorted(map(repr, got)) == sorted(map(repr, want))
    for key, value in want.items():
        if isinstance(value, numpy.ndarray):
            assert got[key].dtype == value.dtype
            numpy.testing.assert_array_equal(got[key], value)
        else:
            assert got[key] == value and type(got[key]) is type(value)


def test_safe_codec_bytes_equal_the_jax_package():
    msg = _message()
    data = safecodec.dumps(msg)
    assert data == jsafecodec.dumps(msg)
    _assert_same(safecodec.loads(data), msg)
    _assert_same(jsafecodec.loads(data), msg)


@pytest.mark.parametrize("codec", ["pickle", "safe"])
@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_frames_cross_between_the_packages(codec, direction, request):
    if codec == "safe":
        request.getfixturevalue("safe_wire")
    msg = _message()
    msg["big"] = numpy.random.RandomState(0).rand(40000).astype(
        numpy.float32)  # past the gzip threshold
    send, recv = ((protocol, jprotocol) if direction == "port-to-jax"
                  else (jprotocol, protocol))
    frame = send.encode_frame(msg, KEY)
    assert frame[4] in ((1,) if codec == "pickle" else (3,))
    _assert_same(recv.decode_frame_bytes(frame, KEY), msg)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_shared_memory_frames_cross_between_the_packages(direction):
    send, recv = ((protocol, jprotocol) if direction == "port-to-jax"
                  else (jprotocol, protocol))
    msg = {"type": "job", "job": numpy.arange(50000)}
    frame = send.encode_frame(msg, KEY, shm_threshold=0)
    assert len(frame) < 1024  # only the descriptor rode the wire
    out = _read(frame, recv)
    numpy.testing.assert_array_equal(out["job"], msg["job"])


def test_frame_roundtrip_and_compression():
    msg = {"type": "job", "job": [numpy.arange(5), {"a": 1}]}
    out = _read(encode_frame(msg, KEY))
    numpy.testing.assert_array_equal(out["job"][0], numpy.arange(5))
    big = encode_frame({"data": numpy.zeros(1 << 20, numpy.float32)}, KEY)
    assert len(big) < 1 << 20  # gzip kicked in


def _bomb():
    bomb = gzip.compress(b"\0" * (4 << 20), compresslevel=9)
    return _raw_frame(1, bomb), {"max_frame": 1 << 20}, "exceeds limit"


def _truncated():
    member = gzip.compress(pickle.dumps({"type": "job"}))
    return _raw_frame(1, member[:-6]), {}, "gzip"


def _oversized_hello():
    big = encode_frame({"type": "hello", "pad": os.urandom(1 << 17)}, KEY)
    return big, {"max_frame": 1 << 16}, "exceeds limit"


def _tampered():
    frame = bytearray(encode_frame({"type": "hello"}, KEY))
    frame[-1] ^= 0xFF
    return bytes(frame), {}, "HMAC"


#: tests/test_fleet.py TestProtocol's refusals: (frame, read kwargs,
#: the message they must name)
PROTOCOL_REFUSALS = {
    "unauthenticated": lambda: (encode_frame({"type": "hello"},
                                             b"attacker-key"), {}, "HMAC"),
    "tampered": _tampered,
    "gzip-bomb": _bomb,
    "truncated-gzip": _truncated,
    "unknown-codec": lambda: (_raw_frame(7, b"payload"), {},
                              "unknown frame codec"),
    "oversized-preauth-hello": _oversized_hello,
}


@pytest.mark.parametrize("case", sorted(PROTOCOL_REFUSALS))
def test_protocol_refusals_still_refuse(case):
    frame, kwargs, match = PROTOCOL_REFUSALS[case]()
    with pytest.raises(ProtocolError, match=match):
        _read(frame, **kwargs)
    with pytest.raises(jprotocol.ProtocolError, match=match):
        _read(frame, jprotocol, **kwargs)


def test_secret_defaults_to_the_workflow_checksum(monkeypatch):
    monkeypatch.delenv("VELES_TPU_FLEET_SECRET", raising=False)
    monkeypatch.setattr(root.common.fleet, "secret", None, raising=False)

    class WF:
        checksum = "abc123"

    assert protocol.resolve_secret(WF(), with_source=True) \
        == (b"abc123", "checksum")
    assert protocol.machine_id() == jprotocol.machine_id()


def _segments():
    return {n for n in os.listdir(sharedio.shm_dir())
            if n.startswith(sharedio._PREFIX)}


def test_shm_frame_roundtrip_unlinks_its_segment():
    before = _segments()
    frame = encode_frame({"type": "job", "job": numpy.arange(50000)}, KEY,
                         shm_threshold=0)
    created = _segments() - before
    assert len(created) == 1
    numpy.testing.assert_array_equal(_read(frame)["job"],
                                     numpy.arange(50000))
    assert not created & _segments()


def test_shm_tamper_refused_and_left_in_place():
    before = _segments()
    frame = encode_frame({"x": numpy.zeros(9000)}, KEY, shm_threshold=0)
    name = (_segments() - before).pop()
    path = os.path.join(sharedio.shm_dir(), name)
    with open(path, "r+b") as fout:
        fout.write(b"\xff")
    try:
        with pytest.raises(ProtocolError):
            _read(frame)
        assert name in _segments()
    finally:
        os.unlink(path)


@pytest.mark.parametrize("name", ["../../etc/passwd", "/etc/passwd",
                                  "evil"])
def test_shm_path_containment(name):
    frame = encode_frame({"__shm__": {"name": name, "size": 1,
                                      "mac": "0"}}, KEY)
    with pytest.raises(ProtocolError):
        _read(frame)


def test_shm_negotiated_on_a_loopback_fleet():
    """Same machine id: the welcome negotiates shared memory, and a big
    job and its update move through segments end to end."""
    from veles_tpu_torch.fleet.client import Client
    from veles_tpu_torch.fleet.server import Server

    class BigJobWorkflow:
        checksum = "shm-test"

        def __init__(self):
            self.applied = []

        def generate_initial_data_for_slave(self, slave):
            return None

        def generate_data_for_slave(self, slave):
            return None if self.applied else numpy.ones(200000,
                                                        numpy.float32)

        def apply_data_from_slave(self, update, slave):
            self.applied.append(float(numpy.asarray(update).sum()))

        def apply_initial_data_from_master(self, initial):
            pass

        def do_job(self, job, callback):
            callback(numpy.asarray(job) * 2)

        def drop_slave(self, slave):
            pass

        def has_more_jobs(self):
            return not self.applied

    wf = BigJobWorkflow()
    server = Server("127.0.0.1:0", wf, secret="shm-test").start()
    done = threading.Event()
    server.on_finished = done.set
    client = Client(server.address, BigJobWorkflow(),
                    secret="shm-test").start()
    try:
        assert done.wait(timeout=20), "the fleet job did not complete"
        assert wf.applied == [400000.0]
        assert client._shm_thr_ is not None
    finally:
        client.stop()
        server.stop()


#: tests/test_fleet.py TestSafeCodec's malformed-but-authenticated safe
#: frames, each a ProtocolError naming the bad safe frame
SAFE_HEADERS = {
    "missing-node-type": {"x": 1},
    "bad-reshape": {"t": "a", "d": "<f4", "s": [5, 5], "o": 0, "n": 4},
    "unknown-node": {"t": "zz"},
    "recursion-bait": b"[" * 50000 + b"1" + b"]" * 50000,
}


@pytest.mark.parametrize("case", sorted(SAFE_HEADERS))
def test_malformed_safe_frame_is_a_protocol_error(case, safe_wire):
    header = SAFE_HEADERS[case]
    head = header if isinstance(header, bytes) \
        else json.dumps(header).encode()
    payload = struct.pack(">I", len(head)) + head + b"\0" * 4
    if len(payload) >= 64 * 1024:
        payload = gzip.compress(payload)
    with pytest.raises(ProtocolError, match="bad safe frame"):
        _read(_raw_frame(2, payload))


def test_safe_receiver_refuses_pickle_frames(safe_wire):
    root.common.fleet.codec = "pickle"
    pickle_frame = encode_frame({"type": "hello"}, KEY)
    root.common.fleet.codec = "safe"
    with pytest.raises(ProtocolError, match="safe fleet codec"):
        _read(pickle_frame)


def test_safe_frame_roundtrip_and_compression(safe_wire):
    msg = {"type": "job", "job": [numpy.zeros(1 << 20, numpy.float32),
                                  {"lr": 0.5}]}
    frame = encode_frame(msg, KEY)
    assert len(frame) < 1 << 20
    out = _read(frame)
    numpy.testing.assert_array_equal(out["job"][0], msg["job"][0])
    assert out["job"][1] == {"lr": 0.5}


class Payload:
    pass


@pytest.mark.parametrize("value,match", [
    ({"job": Payload()}, "Payload"),
    (numpy.array([object()], dtype=object), "object-dtype"),
    ({frozenset((1,)): "x"}, "dict key"),
    # payloads hold numpy arrays: a tensor leaves its device first
    ({"w": torch.zeros(2)}, "Tensor")])
def test_safe_codec_refuses_at_encode(value, match):
    with pytest.raises(safecodec.UnsupportedType, match=match):
        safecodec.dumps(value)


def test_numpy_keys_coerced_at_encode():
    out = safecodec.loads(safecodec.dumps(
        {numpy.int64(3): "a", (numpy.int32(1), "t"): "b"}))
    assert out[3] == "a" and out[(1, "t")] == "b"


def _ledger_script(module):
    """One scripted sequence of lease, settle, expire, drop and stale-
    epoch operations: every outcome, then the snapshot (its wall-clock
    ``wasted_s`` aside)."""
    book = module.JobLedger()
    out = []
    a1 = book.issue("s1", 30.0)
    a2 = book.issue("s1", 30.0)
    b1 = book.issue("s2", 30.0)
    out.append([a1, a2, b1])
    out.append(book.settle(a1, "s1"))       # applied
    out.append(book.settle(a1, "s1"))       # duplicate replay
    out.append(book.settle(b1, "s1"))       # foreign slave
    out.append(book.settle(999, "s1"))      # unknown job
    out.append(book.expire_if_outstanding(a2))
    out.append(book.expire_if_outstanding(a2))
    out.append(book.settle(a2, "s1"))       # requeued lease
    b2 = book.issue("s2", 30.0)
    out.append(sorted(book.requeue_for_slave("s2")))
    out.append(book.settle(b2, "s2"))
    out.append(book.count_stale_epoch())
    out.append(book.settle(book.issue("s3", 30.0), "s3"))
    snap = book.snapshot()
    snap.pop("wasted_s", None)
    out.append(snap)
    out.append(module.FENCE_STALE_EPOCH)
    return out


def test_ledgers_give_equal_outcomes():
    assert _ledger_script(ledger) == _ledger_script(jledger)


def _chaos_script(module, seed):
    """Every hook of a monkey with every fault on (zero delays), in a
    fixed order: which ones fired, then the counters."""
    config = module.ChaosConfig(
        seed=seed, frame_delay=0.3, frame_delay_ms=0.0, frame_drop=0.2,
        slow_job=0.4, slow_job_ms=0.0, duplicate_update=0.5, death=0.25)
    monkey = module.ChaosMonkey(config)
    fired = []
    for _ in range(40):
        before = dict(monkey.counters)
        asyncio.run(monkey._maybe_delay())
        try:
            monkey._maybe_drop(None)
        except ConnectionResetError:
            pass
        asyncio.run(monkey.stretch_job())
        try:
            monkey.maybe_die()
        except ConnectionResetError:
            pass
        fired.append(sorted(k for k in monkey.counters
                            if monkey.counters[k] != before[k]))
        fired.append(monkey._roll(config.duplicate_update))
    return fired, monkey.counters


@pytest.mark.parametrize("seed", [1, 7, 1234])
def test_chaos_monkeys_decide_alike_for_equal_seeds(seed):
    assert _chaos_script(chaos, seed) == _chaos_script(jchaos, seed)
    assert chaos.PROBABILITY_KEYS == jchaos.PROBABILITY_KEYS


def test_chaos_config_from_root_and_its_validation(monkeypatch):
    monkeypatch.setattr(root.common.fleet.chaos, "death", 0.5,
                        raising=False)
    monkeypatch.setattr(root.common.fleet.chaos, "seed", 9, raising=False)
    monkey = chaos.ChaosMonkey.from_config()
    assert monkey.config.death == 0.5 and monkey.config.seed == 9
    with pytest.raises(ValueError, match="outside"):
        chaos.ChaosConfig(frame_drop=1.5)
    with pytest.raises(ValueError, match="death_mode"):
        chaos.ChaosConfig(death_mode="explode")


class _Timers:
    """threading.Timer stand-in: records each delay, starts nothing."""

    def __init__(self):
        self.delays = []
        self.real = threading.Timer

    def __call__(self, delay, fn, args=()):
        self.delays.append(delay)
        timer = self.real(3600.0, fn, args)
        timer.start = lambda: None
        return timer


def _respawn_script(module, monkeypatch):
    timers = _Timers()
    monkeypatch.setattr(module.threading, "Timer", timers)
    mgr = module.RespawnManager(spawner=lambda *a, **k: None,
                                max_attempts=3, base_delay=0.5)
    recipe = {"executable": "/usr/bin/python3",
              "argv": ["-m", "pkg", "wf.py", "-m", "h:1"],
              "cwd": "/work", "pythonpath": "/lib"}
    outcomes = [mgr.schedule("10.0.0.5", recipe, key="mid-1")
                for _ in range(4)]
    mgr.notify_reconnected("mid-1")
    outcomes.append(mgr.schedule("10.0.0.5", recipe, key="mid-1"))
    outcomes.append(mgr.schedule("h", {}))
    outcomes.append(mgr.schedule("h", {"executable": "python"}))
    mgr.stop()
    outcomes.append(mgr.schedule("10.0.0.5", recipe, key="mid-2"))
    monkeypatch.undo()
    return (outcomes, timers.delays, module.RespawnManager.command_of(recipe),
            module.build_command("/x y/python", ["a b", "-m", "h:1"]))


def test_respawn_backoff_and_budget_match(monkeypatch):
    mine = _respawn_script(respawn, monkeypatch)
    theirs = _respawn_script(jrespawn, monkeypatch)
    assert mine == theirs
    outcomes, delays, command, _ = mine
    assert outcomes == [True, True, True, False, True, False, False,
                        False]
    assert delays == [0.5, 1.0, 2.0, 0.5]
    assert command == "/usr/bin/python3 -m pkg -b wf.py -m h:1"


def test_a_spawned_slave_runs_the_port(monkeypatch):
    """``respawn_recipe`` re-encodes ``python -m veles_tpu_torch`` and
    the relaunch command names the port's package, never the JAX one."""
    main = os.path.join(os.path.dirname(respawn.__file__), os.pardir,
                        "__main__.py")
    monkeypatch.setattr(sys, "argv", [os.path.normpath(main), "wf.py", "-",
                                      "-m", "127.0.0.1:5"])
    recipe = respawn.respawn_recipe()
    assert recipe["argv"][:2] == ["-m", "veles_tpu_torch"]
    command = respawn.RespawnManager.command_of(recipe)
    assert " -m veles_tpu_torch -b wf.py" in command
    assert respawn.spawn_env("/lib") == {"PYTHONPATH": "/lib"}
    assert respawn.spawn_env("") is None


@pytest.mark.parametrize("plane", ["data", "control", "bogus"])
def test_the_plane_knob_validates_as_jax(plane, monkeypatch):
    """``fleet_plane``/``fleet_control_plane`` read and validate
    ``root.common.fleet.plane`` as the JAX package's do."""
    from veles_tpu.fleet import fleet_plane as jfleet_plane
    from veles_tpu_torch.fleet import fleet_control_plane, fleet_plane

    monkeypatch.setattr(root.common.fleet, "plane", plane, raising=False)
    monkeypatch.setattr(jroot.common.fleet, "plane", plane, raising=False)
    if plane == "bogus":
        for fn in (fleet_plane, fleet_control_plane, jfleet_plane):
            with pytest.raises(ValueError, match="data' or 'control'"):
                fn()
        return
    assert fleet_plane() == jfleet_plane() == plane
    assert fleet_control_plane() is (plane == "control")
