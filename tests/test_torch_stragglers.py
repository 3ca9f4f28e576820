"""The public names the port had left out, against the JAX package on
the CPU: ``ops/augment``'s ``mirror_batch``, ``shift_batch`` and
``shift1_batch``, ``ops/activations.softmax``,
``ops/losses.softmax_cross_entropy``, ``models/mlp.create_mnist784``,
``parallel/decode.slot_admit``, the HDF5 loaders (``loader/hdf5.py``),
``avatar.Avatar``, ``interaction.Shell``, ``memory.Watcher`` and
``assert_addr``, the Mongo log duplication of ``core/logger``, and three
trainer knobs no port test named before: ``l1_vs_l2``,
``learning_rate_bias`` and the decision's ``lr_decay``.

The augmentation draws come from different generators in the two
packages, so the applies are held against JAX's given JAX's draws. The
trainer knobs run at level 2 from carried weights (per-epoch n_err equal,
weights within 1e-5): ``l1_vs_l2`` at 1e-4 for two epochs, small enough
that no weight crosses zero, where ``sign(w)`` would turn f32 round-off
into different runs; ``lr_decay`` for ten epochs, long enough for epochs
without improvement to halve the rate."""

import gc
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.models import mlp as jmlp
from veles_tpu.ops import activations as jact
from veles_tpu.ops import augment as jaugment
from veles_tpu.ops import losses as jlosses
from veles_tpu.parallel import decode as jdec
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.mutable import Bool
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.memory import Array, Watcher, assert_addr
from veles_tpu_torch.models import mlp
from veles_tpu_torch.ops import activations, augment, losses
from veles_tpu_torch.parallel import decode as tdec

from test_torch_slot import (BLOCKS, HEAD_DIM, HEADS, MAX_LEN, SLOTS, VOCAB,
                             _model)
from test_torch_training import (LEVEL2_ATOL, _digits, _pair,
                                 _run_and_compare, engine)  # noqa: F401

torch.set_num_threads(1)


# -- ops/augment ----------------------------------------------------------------

def _batch(seed=0, shape=(16, 7, 9, 3)):
    return numpy.random.RandomState(seed).randn(*shape).astype(
        numpy.float32)


def _jax_shift_draw(seed, n, max_shift):
    """``shift_batch``'s (dh, dw) (``augment.py:25-40``), as numpy."""
    kh, kw = jax.random.split(jax.random.key(seed))
    return tuple(numpy.array(jax.random.randint(k, (n,), -max_shift,
                                                max_shift + 1))
                 for k in (kh, kw))


@pytest.mark.parametrize("max_shift", [1, 2, 3])
def test_shift_batch_matches_jax(monkeypatch, max_shift):
    monkeypatch.setattr(augment, "shift_draw",
                        lambda seed, n, device, m=1: tuple(
                            torch.from_numpy(d).long()
                            for d in _jax_shift_draw(seed, n, m)))
    batch = _batch(max_shift)
    want = numpy.asarray(jaugment.shift_batch(batch, 11, max_shift))
    got = augment.shift_batch(torch.from_numpy(batch), 11, max_shift)
    numpy.testing.assert_array_equal(got.numpy(), want)
    if max_shift == 1:
        numpy.testing.assert_array_equal(
            augment.shift1_batch(torch.from_numpy(batch), 11).numpy(),
            numpy.asarray(jaugment.shift1_batch(batch, 11)))


def test_mirror_batch_matches_jax(monkeypatch):
    monkeypatch.setattr(augment, "mirror_draw", lambda seed, n, device:
                        torch.from_numpy(numpy.array(jax.random.bernoulli(
                            jax.random.key(seed), 0.5, (n,)))))
    batch = _batch(4)
    numpy.testing.assert_array_equal(
        augment.mirror_batch(torch.from_numpy(batch), 5).numpy(),
        numpy.asarray(jaugment.mirror_batch(batch, 5)))


def test_augment_names():
    """The JAX names beside the port's earlier ones, one function each;
    ``shift_batch`` at one pixel draws what ``shift1`` draws; wider
    shifts reach every offset."""
    assert augment.mirror is augment.mirror_batch
    assert augment.shift1 is augment.shift1_batch
    assert augment.TRANSFORMS == {"mirror": augment.mirror_batch,
                                  "shift1": augment.shift1_batch}
    assert set(augment.TRANSFORMS) == set(jaugment.TRANSFORMS)
    batch = torch.from_numpy(_batch())
    assert torch.equal(augment.shift_batch(batch, 3),
                       augment.shift1_batch(batch, 3))
    dh, dw = augment.shift_draw(3, 512, "cpu", 2)
    assert set(dh.tolist()) == set(dw.tolist()) == set(range(-2, 3))


# -- activations and losses -----------------------------------------------------

def test_softmax_matches_jax():
    x = numpy.random.RandomState(1).randn(6, 10).astype(numpy.float32) * 4
    numpy.testing.assert_allclose(
        activations.softmax(torch.from_numpy(x)).numpy(),
        numpy.asarray(jact.softmax(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_jax(masked):
    rng = numpy.random.RandomState(3)
    logits = rng.randn(8, 5).astype(numpy.float32)
    labels = rng.randint(0, 5, 8).astype(numpy.int32)
    mask = (numpy.arange(8) < 6).astype(numpy.float32) if masked else None
    want = jlosses.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        mask=None if mask is None else jnp.asarray(mask))
    got = losses.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        mask=None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(w),
                                      rtol=1e-6, atol=1e-7)
    assert int(got[2]) == int(want[2])


# -- models/mlp.create_mnist784 --------------------------------------------------

def test_create_mnist784_matches_jax(engine):  # noqa: F811
    """The reference MNIST784 topology (100 tanh, 10 softmax) over a given
    dataset, two epochs at level 2 from the JAX package's weights."""
    engine(precision_level=2)
    x, y = _digits()
    args = (x, y, [0, 297, 1500])
    jprng.get("default").seed(4321)
    jprng.get("loader").seed(8765)
    jwf = jmlp.create_mnist784(JDummyLauncher(), *args, max_epochs=2)
    jwf.initialize()
    prng.get("loader").seed(8765)
    twf = mlp.create_mnist784(DummyLauncher(), *args, max_epochs=2,
                              device="cpu")
    assert twf.name == jwf.name == "MNIST784"
    unit_params_from_jax(twf, [{"weights": numpy.asarray(f.weights.data),
                                "bias": numpy.asarray(f.bias.data)}
                               for f in jwf.forwards])
    twf.initialize()
    assert [tuple(f.weights.shape) for f in twf.forwards] \
        == [tuple(f.weights.shape) for f in jwf.forwards] \
        == [(64, 100), (100, 10)]
    assert twf.loader.normalization_type == "linear"
    assert twf.loader.minibatch_size == 100
    epochs = _run_and_compare(jwf, twf, LEVEL2_ATOL)
    assert len(epochs) == 2


# -- the trainer knobs ------------------------------------------------------------

@pytest.mark.parametrize("overrides", [
    dict(weights_decay=1e-3, l1_vs_l2=1e-4),
    dict(learning_rate=0.1, learning_rate_bias=0.02),
    dict(learning_rate=0.3, gradient_moment=0.5, max_epochs=10,
         decision_kwargs=dict(lr_decay=0.5, lr_decay_patience=1))],
    ids=["l1_vs_l2", "learning_rate_bias", "lr_decay"])
def test_trainer_knob_matches_jax(engine, overrides):  # noqa: F811
    engine(precision_level=2)
    overrides = dict(dict(max_epochs=2), **overrides)
    jwf, twf = _pair(**overrides)
    _run_and_compare(jwf, twf, LEVEL2_ATOL)
    jlrs = [gd.learning_rate for gd in jwf.gds]
    tlrs = [gd.learning_rate for gd in twf.gds]
    assert tlrs == pytest.approx(jlrs, rel=1e-12)
    if "decision_kwargs" in overrides:
        # the decay fired: the run is no test of lr_decay otherwise
        assert max(tlrs) < overrides["learning_rate"]


# -- parallel/decode.slot_admit ---------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "int8-kv"])
@pytest.mark.parametrize("length", [None, 5], ids=["full", "padded"])
def test_slot_admit_matches_jax(quantized, length):
    """One prompt of 7 tokens (right-padded past ``length``) into lane 2:
    the control rows bit for bit, the logits and the K/V slab (or the
    int8 slab's scales) within f32 round-off of the JAX package's."""
    jparams, tparams, table = _model()
    tokens = numpy.random.RandomState(8).randint(0, VOCAB, 7)
    x = table[tokens][None]
    jstate = jdec.init_slot_state(BLOCKS, SLOTS, MAX_LEN, HEADS, HEAD_DIM,
                                  VOCAB, quantized=quantized)
    jstate = jdec.slot_admit(jparams, jnp.asarray(table), HEADS, jstate, 2,
                             jnp.asarray(x), length=length)
    tstate = tdec.init_slot_state(BLOCKS, SLOTS, MAX_LEN, HEADS, HEAD_DIM,
                                  VOCAB, quantized=quantized, device="cpu")
    tstate = tdec.slot_admit(tparams, HEADS, tstate, 2, torch.from_numpy(x),
                             length=length)
    for name in ("lengths", "step"):
        numpy.testing.assert_array_equal(tstate[name].numpy(),
                                         numpy.asarray(jstate[name]))
    assert tstate["lengths"].tolist() == [0, 0, length or 7, 0]
    numpy.testing.assert_allclose(tstate["logits"].numpy(),
                                  numpy.asarray(jstate["logits"]),
                                  atol=2e-5, rtol=0)
    names = ("k_scale", "v_scale") if quantized else ("k", "v")
    for name in names:
        numpy.testing.assert_allclose(
            tstate[name].numpy(), numpy.asarray(jstate[name]),
            rtol=1e-5 if quantized else 0, atol=0 if quantized else 2e-5)
    # the B = 1 case of slot_admit_many, with a request key
    many = tdec.init_slot_state(BLOCKS, SLOTS, MAX_LEN, HEADS, HEAD_DIM,
                                VOCAB, quantized=quantized, device="cpu")
    many = tdec.slot_admit_many(
        tparams, HEADS, many, torch.tensor([2]), torch.from_numpy(x),
        torch.tensor([length or 7]), torch.tensor([99]))
    again = tdec.slot_admit(tparams, HEADS, tdec.init_slot_state(
        BLOCKS, SLOTS, MAX_LEN, HEADS, HEAD_DIM, VOCAB, quantized=quantized,
        device="cpu"), 2, torch.from_numpy(x), req_key=99, length=length)
    for name, value in many.items():
        assert torch.equal(again[name], value), name


# -- loader/hdf5 (tests/test_dataset_formats.py:56-109) ----------------------------

def _dataset(n=48, dim=5, seed=0):
    rng = numpy.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, dim)).astype(numpy.float32),
            rng.randint(0, 3, n).astype(numpy.int32))


@pytest.fixture
def h5_files(tmp_path):
    h5py = pytest.importorskip("h5py")
    x, y = _dataset()
    paths = {}
    for name, rows in (("validation", slice(0, 16)),
                       ("train", slice(16, 48))):
        path = str(tmp_path / (name + ".h5"))
        with h5py.File(path, "w") as fout:
            fout["data"] = x[rows]
            fout["label"] = y[rows]
        paths[name] = path
    return paths, x, y


def _port_workflow():
    wf = DummyWorkflow()
    wf.device = torch.device("cpu")
    return wf


def _loaders(cls_name, **kwargs):
    """The JAX package's loader and the port's, their loader streams
    seeded alike."""
    from veles_tpu.loader import hdf5 as jhdf5
    from veles_tpu_torch.loader import hdf5 as thdf5
    jprng.get("loader").seed(3)
    jl = getattr(jhdf5, cls_name)(JDummyWorkflow(), **kwargs)
    jl.initialize()
    prng.get("loader").seed(3)
    tl = getattr(thdf5, cls_name)(_port_workflow(), **kwargs)
    tl.initialize()
    return jl, tl


def test_fullbatch_hdf5_matches_jax(h5_files):
    paths, x, _ = h5_files
    jl, tl = _loaders("FullBatchHDF5Loader",
                      validation_path=paths["validation"],
                      train_path=paths["train"], minibatch_size=8)
    assert tl.class_lengths == jl.class_lengths == [0, 16, 32]
    for _ in range(2 + 4):
        jl.run()
        tl.run()
        idx = numpy.asarray(tl.minibatch_indices.mem)
        numpy.testing.assert_array_equal(
            idx, numpy.asarray(jl.minibatch_indices.mem))
        numpy.testing.assert_allclose(tl.minibatch_data.mem, x[idx],
                                      rtol=1e-6)
        numpy.testing.assert_array_equal(
            tl.minibatch_labels.mem, numpy.asarray(jl.minibatch_labels.mem))


def test_streaming_hdf5_matches_jax(h5_files):
    """One epoch of minibatches read from disk: the same indices, labels
    and mean_disp-normalized rows as the JAX package's streaming
    loader."""
    paths, x, y = h5_files
    jl, tl = _loaders("HDF5Loader", validation_path=paths["validation"],
                      train_path=paths["train"], minibatch_size=8,
                      normalization_type="mean_disp")
    served = 0
    while True:
        jl.run()
        tl.run()
        valid = tl.minibatch_valid_size
        assert valid == jl.minibatch_valid_size
        idx = numpy.asarray(tl.minibatch_indices.mem)
        numpy.testing.assert_array_equal(
            idx, numpy.asarray(jl.minibatch_indices.mem))
        numpy.testing.assert_allclose(
            tl.minibatch_data.mem[:valid],
            numpy.asarray(jl.minibatch_data.mem)[:valid], rtol=1e-5,
            atol=1e-6)
        numpy.testing.assert_array_equal(tl.minibatch_labels.mem[:valid],
                                         y[idx[:valid]])
        numpy.testing.assert_array_equal(tl.sample_mask.mem,
                                         numpy.asarray(jl.sample_mask.mem))
        served += valid
        if tl.epoch_ended:
            break
    assert served == 48 and bool(jl.epoch_ended)
    tl.stop()


def test_hdf5_without_h5py_names_it(h5_files, monkeypatch):
    from veles_tpu_torch.loader import hdf5 as thdf5
    paths, _, _ = h5_files
    monkeypatch.setitem(sys.modules, "h5py", None)
    loader = thdf5.FullBatchHDF5Loader(
        _port_workflow(), train_path=paths["train"], minibatch_size=8)
    with pytest.raises(ImportError, match="h5py"):
        loader.initialize()


def test_hdf5_mixed_labels_refused(h5_files, tmp_path):
    import h5py
    from veles_tpu_torch.loader import hdf5 as thdf5
    paths, x, _ = h5_files
    bare = str(tmp_path / "bare.h5")
    with h5py.File(bare, "w") as fout:
        fout["data"] = x[:4]
    loader = thdf5.FullBatchHDF5Loader(
        _port_workflow(), validation_path=bare, train_path=paths["train"],
        minibatch_size=8)
    with pytest.raises(ValueError, match="some class files have labels"):
        loader.initialize()


# -- avatar and interaction (tests/test_composition_units.py:61-122) -------------

def test_avatar_clones_arrays_bools_and_plain():
    from veles_tpu_torch.avatar import Avatar

    class Producer:
        weights = Array()
        flag = Bool(False)
        epoch = 3
        stats = {"a": 1}

    producer = Producer()
    producer.weights.reset(numpy.ones((2, 2), numpy.float32))
    producer.weights.to_device("cpu")
    avatar = Avatar(_port_workflow())
    avatar.link_clones(producer, "weights", "flag", "epoch", "stats")
    avatar.initialize()
    numpy.testing.assert_array_equal(avatar.weights.mem, numpy.ones((2, 2)))
    assert not bool(avatar.flag) and avatar.epoch == 3
    # the port updates tensors in place: the snapshot must not follow
    producer.weights.data.zero_()
    producer.flag.set(True)
    producer.stats["a"] = 2
    assert float(avatar.weights.mem.max()) == 1.0
    assert avatar.stats == {"a": 1}
    avatar.run()
    assert float(avatar.weights.mem.max()) == 0.0
    assert bool(avatar.flag) and avatar.stats == {"a": 2}
    # a host value is copied too
    producer.weights.reset(numpy.full((2, 2), 5.0, numpy.float32))
    avatar.run()
    producer.weights.mem[0, 0] = -1.0
    assert float(avatar.weights.mem.min()) == 5.0


def test_shell_triggers():
    from veles_tpu_torch.interaction import Shell
    shell = Shell(_port_workflow())
    opened = []
    shell.embed = lambda: opened.append(True)
    shell.run()
    assert not opened
    shell.interrupt()
    shell.run()
    assert opened == [True]
    shell.run()
    assert opened == [True]


def test_shell_file_trigger(tmp_path):
    from veles_tpu_torch.interaction import Shell
    trigger = tmp_path / "shell"
    shell = Shell(_port_workflow(), trigger_path=str(trigger))
    opened = []
    shell.embed = lambda: opened.append(True)
    shell.run()
    assert not opened
    trigger.write_text("")
    shell.run()
    assert opened == [True] and not trigger.exists()


# -- memory.Watcher and assert_addr (tests/test_memory.py) -------------------------

def test_watcher_accounting():
    gc.collect()
    Watcher.reset()
    base = Watcher.mem_in_use()
    a = Array(torch.zeros((8, 8), dtype=torch.float32))
    assert Watcher.mem_in_use() - base == 8 * 8 * 4
    b = Array(numpy.zeros((8, 8), numpy.float32))  # host values count not
    assert Watcher.mem_in_use() - base == 8 * 8 * 4
    b.to_device("cpu")
    assert Watcher.mem_in_use() - base == 2 * 8 * 8 * 4
    b.data = torch.zeros(4, dtype=torch.bfloat16)
    assert Watcher.mem_in_use() - base == 8 * 8 * 4 + 8
    restored = pickle.loads(pickle.dumps(a))
    assert Watcher.mem_in_use() - base == 2 * 8 * 8 * 4 + 8
    del restored, b
    gc.collect()
    a.reset(None)
    assert Watcher.mem_in_use() - base == 0
    assert Watcher.max_mem_in_use() - base == 2 * 8 * 8 * 4 + 8


#: an Array in a reference cycle, collected while the Watcher's lock is
#: held, as a collection that starts inside ``Watcher.add`` runs it
_FINALIZER_UNDER_THE_LOCK = r"""
import gc, torch
from veles_tpu_torch.memory import Array, Watcher
gc.disable()
base = Watcher.mem_in_use()
held = Array(torch.zeros(16))
cyclic = Array(torch.zeros(64))
cyclic.self_ = cyclic
del cyclic
with Watcher._lock:
    gc.collect()
assert Watcher.mem_in_use() - base == 16 * 4, Watcher.mem_in_use() - base
print("released")
"""


def test_watcher_finalizer_under_its_lock_does_not_deadlock():
    """C10: an Array's finalizer that a garbage collection runs on a
    thread holding the Watcher's lock (a collection inside
    ``Watcher.add``) deadlocked that thread; it now defers its bytes,
    taken off the count by the next call."""
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    try:
        done = subprocess.run([sys.executable, "-c",
                               _FINALIZER_UNDER_THE_LOCK], env=env,
                              capture_output=True, text=True, timeout=60)
    except subprocess.TimeoutExpired:
        pytest.fail("the finalizer deadlocked under the Watcher's lock")
    assert done.returncode == 0 and "released" in done.stdout, done.stderr


def test_assert_addr():
    x = torch.ones(3)
    a, b = Array(x), Array(x)
    assert_addr(a, b)
    with pytest.raises(ValueError):
        assert_addr(a, Array(torch.ones(3)))


# -- core/logger's Mongo duplication (tests/test_foundation.py:208-336) ------------

def _fake_client():
    class Coll:
        def __init__(self, database):
            self.database = database
            self.docs = []

        def insert_one(self, doc):
            self.docs.append(doc)

    class DB:
        def __init__(self):
            self._colls = {}

        def __getitem__(self, name):
            return self._colls.setdefault(name, Coll(self))

    class Client:
        def __init__(self):
            self._dbs = {}

        def __getitem__(self, name):
            return self._dbs.setdefault(name, DB())

    return Client()


def test_mongo_logs_and_events_duplicate():
    from veles_tpu_torch.core.logger import (
        Logger, duplicate_all_logging_to_mongo, get_event_recorder)
    client = _fake_client()
    handler = duplicate_all_logging_to_mongo(
        "ignored:1", docid="sess", client_factory=lambda a: client,
        background=False)
    try:
        log = Logger(logger_name="mongo-test")
        log.warning("hello %d", 42)
        logs = client["veles"]["logs"].docs
        assert any(d["message"] == "hello 42" and d["session"] == "sess"
                   for d in logs)
        log.event("epoch", "begin", number=3)
        events = client["veles"]["events"].docs
        assert any(e["name"] == "epoch" and e["etype"] == "begin"
                   and e["number"] == 3 and e["session"] == "sess"
                   for e in events)
    finally:
        handler.close()
    n_logs, n_events = len(logs), len(events)
    Logger(logger_name="mongo-test").warning("after close")
    Logger(logger_name="mongo-test").event("late", "single")
    assert (len(logs), len(events)) == (n_logs, n_events)
    assert not get_event_recorder()._sinks


def test_mongo_background_emission_flushes_on_close():
    from veles_tpu_torch.core.logger import (
        Logger, duplicate_all_logging_to_mongo)
    client = _fake_client()
    handler = duplicate_all_logging_to_mongo(
        "ignored:1", docid="bg", client_factory=lambda a: client)
    log = Logger(logger_name="mongo-bg")
    log.warning("queued %d", 7)
    for i in range(5):
        log.event("tick", "single", number=i)
    handler.close()
    assert any(d["message"] == "queued 7"
               for d in client["veles"]["logs"].docs)
    events = client["veles"]["events"].docs
    assert [e["number"] for e in events] == list(range(5))
    assert all(e["session"] == "bg" for e in events)


def test_failing_sink_is_kept_and_reported_once(caplog):
    from veles_tpu_torch.core.logger import Logger, get_event_recorder
    rec = get_event_recorder()
    calls = []

    def flaky(attrs):
        calls.append(attrs)
        if len(calls) < 3:
            raise RuntimeError("sink boom")

    rec.add_sink(flaky)
    try:
        log = Logger(logger_name="sink-test")
        for name in "xyz":
            log.event(name, "single")
        assert len(calls) == 3 and rec._sinks == [flaky]
        assert sum("event sink failed" in r.getMessage()
                   for r in caplog.records) == 1
    finally:
        rec.remove_sink(flaky)
    assert not rec._sinks


def test_missing_pymongo_reports_clearly(monkeypatch):
    from veles_tpu_torch.core.logger import MongoLogHandler
    monkeypatch.setitem(sys.modules, "pymongo", None)
    with pytest.raises(RuntimeError, match="pymongo"):
        MongoLogHandler("127.0.0.1:1")
