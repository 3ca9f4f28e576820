"""The port's snapshotter (veles_tpu_torch/snapshotter.py), the named
PRNG streams' pickling (C7) and the resumed loader's order (C8), held to
the contracts of tests/test_snapshotter.py and against the JAX package.

The data is sklearn's digits set (64 features, 297 valid / 1500 train),
layers (32, 10), minibatch 100, learning rate 0.1, momentum 0.9. The
parity cases carry the JAX package's initial weights into the port
(``convert.unit_params_from_jax``) and seed both "loader" streams
alike, at precision level 2 (f32 operands): the served index streams
and the per-epoch error counts must be equal, and the weights agree
within LEVEL2_ATOL of their largest element (tests/test_torch_training.py
measured ~1e-7 after 45 steps)."""

import glob
import json
import os
import pickle
import shutil

import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.loader.fullbatch import FullBatchLoader as JFullBatchLoader
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu.nn.decision import DecisionGD as JDecisionGD
from veles_tpu.snapshotter import SnapshotterToFile as JSnapshotterToFile
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.distributable import TriviallyDistributable
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.nn.decision import DecisionGD
from veles_tpu_torch.parallel.sweep import FusedSweep
from veles_tpu_torch.snapshotter import (SnapshotCorruptError, Snapshotter,
                                         SnapshotterToDB,
                                         SnapshotterToFile, place)

torch.set_num_threads(1)

LEVEL2_ATOL = 1e-5


def _digits():
    from sklearn.datasets import load_digits
    digits = load_digits()
    x = digits.data.astype(numpy.float32)
    y = digits.target.astype(numpy.int32)
    perm = numpy.random.RandomState(0).permutation(len(x))
    return x[perm], y[perm]


def _kwargs(max_epochs, normalization="linear"):
    x, y = _digits()
    return dict(layers=(32, 10),
                loader_kwargs=dict(data=x, labels=y,
                                   class_lengths=[0, 297, 1500],
                                   minibatch_size=100,
                                   normalization_type=normalization),
                learning_rate=0.1, gradient_moment=0.9,
                max_epochs=max_epochs, name="snap-test")


def make_wf(max_epochs=1, **kwargs):
    prng.get("default").seed(7)
    prng.get("loader").seed(8)
    return MLPWorkflow(DummyLauncher(), device="cpu",
                       **_kwargs(max_epochs, **kwargs))


def _snapshot_on_improved(wf, snap):
    """The samples' wiring (docs/services.md): the snapshotter between
    the decision and the end point, skipped unless the epoch
    improved."""
    snap.link_from(wf.decision)
    snap.gate_skip = ~wf.decision.improved
    wf.end_point.unlink_from(wf.decision)
    wf.end_point.link_from(snap)
    return snap


def _resume(restored, launcher, max_epochs):
    restored.workflow = launcher
    restored.decision.max_epochs = max_epochs
    restored.decision.complete.unset()
    restored.decision.train_ended.unset()
    restored.initialize()
    restored.run()
    return restored


# -- the contracts of tests/test_snapshotter.py -------------------------------

def test_snapshot_resume_roundtrip(tmp_path):
    wf = make_wf(max_epochs=2)
    snap = _snapshot_on_improved(wf, Snapshotter(
        wf, directory=str(tmp_path), prefix="digits", interval=1,
        time_interval=0))
    wf.initialize()
    wf.run()
    files = [f for f in glob.glob(str(tmp_path / "digits_*.pickle*"))
             if not f.endswith(".lnk")]
    assert files, "no snapshot written"
    assert snap.export_seconds > 0
    err_before = wf.decision.best_n_err[VALID]
    restored = SnapshotterToFile.import_(snap.destination, device="cpu")
    assert restored.restored_from_snapshot
    restored.workflow = DummyLauncher()
    # links survived: the evaluator still reads the last forward's output
    assert restored.evaluator.input is restored.forwards[-1].output
    assert restored.forwards[0].weights.shape \
        == wf.forwards[0].weights.shape
    _resume(restored, DummyLauncher(), 4)
    err_after = restored.decision.best_n_err[VALID]
    assert restored.decision.epochs_done == 4
    assert err_after <= err_before * 2 + 10


def test_weights_export_matches_jax(tmp_path):
    """The same keys as the JAX package's .npz, and for the same weights
    the same values."""
    jprng.get("default").seed(3)
    jwf = JMLPWorkflow(JDummyLauncher(), **_kwargs(1))
    jwf.initialize()
    twf = make_wf()
    unit_params_from_jax(twf, [
        {"weights": numpy.asarray(f.weights.data),
         "bias": numpy.asarray(f.bias.data)} for f in jwf.forwards])
    twf.initialize()
    jpath = JSnapshotterToFile(jwf, directory=str(tmp_path / "j"),
                               prefix="w").export_weights()
    tpath = SnapshotterToFile(twf, directory=str(tmp_path / "t"),
                              prefix="w").export_weights()
    jarrays, tarrays = numpy.load(jpath), numpy.load(tpath)
    assert sorted(tarrays.files) == sorted(jarrays.files) == [
        "fwd0_bias", "fwd0_weights", "fwd1_bias", "fwd1_weights"]
    assert tarrays["fwd0_weights"].shape == (64, 32)
    for key in jarrays.files:
        numpy.testing.assert_array_equal(tarrays[key], jarrays[key])


def test_interval_and_time_gating(tmp_path):
    wf = make_wf()
    wf.initialize()
    snap = SnapshotterToFile(wf, directory=str(tmp_path), prefix="gate",
                             interval=3, time_interval=0)
    snap.initialize()
    snap.run()
    snap.run()
    assert snap.destination is None  # interval not reached
    snap.run()
    assert snap.destination is not None
    # the wall-time window holds the next one back
    snap.time_interval = 3600
    first = snap.destination
    os.remove(first)
    for _ in range(3):
        snap.run()
    assert not os.path.exists(first)


def test_skip_bool(tmp_path):
    wf = make_wf()
    wf.initialize()
    snap = SnapshotterToFile(wf, directory=str(tmp_path), prefix="skip",
                             interval=1, time_interval=0)
    snap.initialize()
    snap.skip.set()
    snap.run()
    assert snap.destination is None


def test_current_link_updated_atomically(tmp_path):
    wf = make_wf()
    wf.initialize()
    snap = SnapshotterToFile(wf, directory=str(tmp_path), prefix="atom",
                             interval=1, time_interval=0)
    snap.suffix = "first"
    snap.export()
    link = str(tmp_path / "atom_current.lnk")
    assert os.path.islink(link) and "first" in os.readlink(link)
    snap.suffix = "second"
    snap.export()
    assert os.path.islink(link) and "second" in os.readlink(link)
    assert not glob.glob(str(tmp_path / "*.lnk.tmp*"))
    assert SnapshotterToFile.import_(
        link, device="cpu").restored_from_snapshot


def test_checksum_sidecar_and_corruption_fallback(tmp_path):
    wf = make_wf()
    wf.initialize()
    snap = SnapshotterToFile(wf, directory=str(tmp_path), prefix="sha",
                             interval=1, time_interval=0)
    snap.suffix = "old"
    snap.export()
    intact = snap.destination
    lines = open(intact + ".sha256").read().splitlines()
    digest, name = lines[0].split()
    assert len(digest) == 64 and name == os.path.basename(intact)
    assert "# prefix: sha" in lines[1]
    snap.suffix = "new"
    snap.export()
    newest = snap.destination
    os.utime(intact, (os.path.getmtime(newest) - 60,) * 2)
    with open(newest, "r+b") as fout:
        fout.write(b"\x00\x01\x02\x03")
    with pytest.raises(SnapshotCorruptError):
        SnapshotterToFile._load_verified(newest, torch.device("cpu"))
    assert SnapshotterToFile.import_(
        newest, device="cpu").restored_from_snapshot
    with open(newest, "wb") as fout:
        fout.write(b"\x1f\x8b")  # gzip magic, then nothing
    assert SnapshotterToFile.import_(
        newest, device="cpu").restored_from_snapshot
    # the fallback never crosses into another prefix that shares the
    # leading "_" segment
    other = SnapshotterToFile(wf, directory=str(tmp_path),
                              prefix="sha_twin", interval=1,
                              time_interval=0)
    other.export()
    with open(intact, "r+b") as fout:
        fout.write(b"\x00\x01\x02\x03")
    with pytest.raises(Exception):
        SnapshotterToFile.import_(newest, device="cpu")
    assert SnapshotterToFile.import_(
        other.destination, device="cpu").restored_from_snapshot
    lonely = tmp_path / "lonely"
    lonely.mkdir()
    bad = lonely / "x_current.0.pickle"
    bad.write_bytes(b"garbage")
    with pytest.raises(Exception):
        SnapshotterToFile.import_(str(bad), device="cpu")


def test_crash_between_sidecar_and_data_rename_tolerated(tmp_path):
    wf = make_wf()
    wf.initialize()
    snap = SnapshotterToFile(wf, directory=str(tmp_path), prefix="win",
                             interval=1, time_interval=0)
    snap.export()
    path = snap.destination
    gen1 = str(tmp_path / "gen1.bak")
    shutil.copy(path, gen1)
    snap.export()
    sidecar_lines = open(path + ".sha256").read().splitlines()
    assert len([line for line in sidecar_lines
                if line and not line.startswith("#")]) == 2
    shutil.copy(gen1, path)
    assert SnapshotterToFile.import_(
        path, device="cpu").restored_from_snapshot
    with open(path, "r+b") as fout:
        fout.write(b"\x00\x01\x02\x03")
    with pytest.raises(SnapshotCorruptError):
        SnapshotterToFile._load_verified(path, torch.device("cpu"))


def test_restful_api_unit_snapshots_cleanly():
    from veles_tpu_torch.serving import RESTfulAPI
    api = RESTfulAPI(DummyWorkflow(), port=0)
    api.health.set_ready(True)
    restored = pickle.loads(pickle.dumps(api))
    assert restored.health is not None
    assert not restored.health.ready


@pytest.mark.parametrize("codec", ["", "gz", "bz2", "xz"])
def test_compression_codecs_roundtrip(tmp_path, codec):
    wf = make_wf()
    wf.initialize()
    snap = SnapshotterToFile(wf, directory=str(tmp_path), prefix="c",
                             compression=codec, interval=1,
                             time_interval=0)
    snap.export()
    assert snap.destination.endswith(".pickle" + ("." + codec if codec
                                                  else ""))
    restored = SnapshotterToFile.import_(snap.destination, device="cpu")
    assert restored.restored_from_snapshot
    numpy.testing.assert_array_equal(restored.forwards[0].weights.mem,
                                     wf.forwards[0].weights.mem)


def test_snapshotter_to_db_roundtrip(tmp_path):
    db = str(tmp_path / "snaps.sqlite3")
    wf = make_wf()
    snap = _snapshot_on_improved(wf, Snapshotter(
        wf, database=db, prefix="dbtest", interval=1, time_interval=0))
    assert isinstance(snap, SnapshotterToDB)
    wf.initialize()
    wf.run()
    assert snap.destination.startswith("sqlite://")
    restored = SnapshotterToDB.import_(snap.destination, device="cpu")
    assert restored.forwards[0].weights.shape \
        == wf.forwards[0].weights.shape
    assert restored.decision._epochs_done == wf.decision._epochs_done
    assert restored._restored_from_snapshot_
    again = SnapshotterToDB.import_(
        "sqlite://%s#dbtest/%s" % (db, snap.suffix or "current"),
        device="cpu")
    assert again.decision._epochs_done == restored.decision._epochs_done
    with pytest.raises(FileNotFoundError):
        SnapshotterToDB.import_("sqlite://%s#nope" % db, device="cpu")
    with pytest.raises(FileNotFoundError):
        SnapshotterToDB.import_("sqlite://%s#x" % (tmp_path / "no.db"),
                                device="cpu")


class Observer(Unit, TriviallyDistributable):
    """A sweep-transparent host unit spliced between the forwards."""

    sweep_transparent = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.ticks = 0

    def run(self):
        self.ticks += 1


def test_sweep_snapshot_resume(tmp_path):
    """The sweep tier's case (tests/test_sweep.py:293): the FusedSweep
    rides the snapshot, its volatile plan rebuilds and training goes
    on, with no second engine spliced."""
    wf = make_wf(max_epochs=2)
    obs = Observer(wf, name="observer")
    wf.forwards[1].unlink_from(wf.forwards[0])
    obs.link_from(wf.forwards[0])
    wf.forwards[1].link_from(obs)
    snap = _snapshot_on_improved(wf, SnapshotterToFile(
        wf, directory=str(tmp_path), prefix="swp", interval=1,
        time_interval=0))
    wf.initialize()
    assert isinstance(wf.sweep_unit, FusedSweep)
    wf.run()
    restored = SnapshotterToFile.import_(snap.destination, device="cpu")
    assert isinstance(restored.sweep_unit, FusedSweep)
    assert restored.sweep_unit in restored.loader.links_to
    ticks = restored.sweep_unit.ticks
    _resume(restored, DummyLauncher(), 4)
    assert sum(isinstance(u, FusedSweep) for u in restored.units) == 1
    assert restored.decision.epochs_done >= 2
    assert restored.sweep_unit.ticks > ticks


def test_import_places_every_tensor(tmp_path):
    """The trouble list of a resume: the unit Arrays, the loader's
    originals, the normalizer's statistics, the GD units' solver state
    and every torch.device attribute go to the device import_ is given
    ("meta" stands in for the card here). The mean_disp normalizer holds
    its statistics as tensors."""
    wf = make_wf(normalization="mean_disp")
    wf.initialize()
    snap = SnapshotterToFile(wf, directory=str(tmp_path), prefix="dev",
                             compression="", interval=1, time_interval=0)
    snap.export()
    with open(snap.destination, "rb") as fin:
        payload = pickle.load(fin)
    meta = torch.device("meta")
    restored = place(payload["workflow"], meta)
    assert restored.device == meta
    tensors = []

    def collect(value, seen):
        if isinstance(value, torch.Tensor):
            tensors.append(value)
        elif isinstance(value, torch.device):
            assert value == meta
        elif id(value) in seen or isinstance(value, (str, bytes,
                                                     numpy.ndarray)):
            return
        elif isinstance(value, dict):
            seen.add(id(value))
            for item in value.values():
                collect(item, seen)
        elif isinstance(value, (list, tuple)):
            seen.add(id(value))
            for item in value:
                collect(item, seen)
        elif hasattr(value, "__dict__") and type(
                value).__module__.startswith("veles_tpu_torch"):
            seen.add(id(value))
            collect(vars(value), seen)

    collect(restored, set())
    assert all(t.device == meta for t in tensors)
    for value in (restored.loader.original_data.data,
                  restored.loader.original_labels.data,
                  restored.gds[0]._velocity_w.data,
                  restored.gds[0]._hyper.data,
                  restored.forwards[0].weights.data):
        assert any(value is t for t in tensors)
    assert any(isinstance(v, torch.Tensor) and v.device == meta
               for v in vars(restored.loader.normalizer).values())


def test_import_onto_a_missing_card_raises(tmp_path, monkeypatch):
    """A snapshot resumes on the card unless the caller asks for the
    CPU: without one, import_ raises instead of falling back."""
    wf = make_wf()
    wf.initialize()
    snap = SnapshotterToFile(wf, directory=str(tmp_path), prefix="cuda",
                             interval=1, time_interval=0)
    snap.export()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SnapshotterToFile.import_(snap.destination)
    assert SnapshotterToFile.import_(
        snap.destination, device="cpu").device == torch.device("cpu")


# -- C7: the named streams pickle ---------------------------------------------

def test_streams_pickle_and_round_trip():
    gen = prng.get("default")
    gen.seed(11)
    gen.randint(0, 100, 7)
    gen.next_generator("cpu")
    clone = pickle.loads(pickle.dumps(gen))
    assert (clone.key, clone.initial_seed, clone._counter) \
        == (gen.key, gen.initial_seed, gen._counter)
    numpy.testing.assert_array_equal(clone.randint(0, 1000, 9),
                                     gen.randint(0, 1000, 9))
    torch.testing.assert_close(clone.fill_uniform((4,), 1.0, "cpu"),
                               gen.fill_uniform((4,), 1.0, "cpu"))
    for key, seed in (("default", 1), ("loader", 2), ("kohonen", 3)):
        prng.get(key).seed(seed)
    state = pickle.loads(pickle.dumps(prng.streams_state()))
    drawn = {key: prng.get(key).randint(0, 10 ** 6, 5)
             for key in state}
    prng.restore_streams(state)
    for key in state:
        numpy.testing.assert_array_equal(
            prng.get(key).randint(0, 10 ** 6, 5), drawn[key])


def test_restored_streams_shuffle_as_jax():
    """After a streams round trip each package's "loader" stream shuffles
    as the other's."""
    for rng in (prng, jprng):
        rng.get("loader").seed(99)
        rng.get("loader").shuffle(numpy.arange(50))
    tstate = pickle.loads(pickle.dumps(prng.streams_state()))
    jstate = pickle.loads(pickle.dumps(jprng.streams_state()))
    for rng in (prng, jprng):
        rng.get("loader").shuffle(numpy.arange(50))
    prng.restore_streams(tstate)
    jprng.restore_streams(jstate)
    ours, theirs = numpy.arange(300), numpy.arange(300)
    prng.get("loader").shuffle(ours)
    jprng.get("loader").shuffle(theirs)
    numpy.testing.assert_array_equal(ours, theirs)


# -- C8: a resumed loader keeps its order -------------------------------------

def _loader_stream(pkg, tmp_path):
    """Serve 7 minibatches, snapshot mid-epoch, resume and serve 40 more:
    the indices served, in order, from either package."""
    x, y = _digits()
    kwargs = dict(data=x[:600], labels=y[:600], class_lengths=[0, 100, 500],
                  minibatch_size=64, normalization_type="linear")
    if pkg == "jax":
        jprng.get("loader").seed(5)
        wf = JDummyWorkflow()
        wf.loader = JFullBatchLoader(wf, **kwargs)
        store = JSnapshotterToFile
        load = store.import_
    else:
        prng.get("loader").seed(5)
        wf = DummyWorkflow()
        wf.device = torch.device("cpu")
        wf.loader = FullBatchLoader(wf, **kwargs)
        store = SnapshotterToFile
        load = lambda path: store.import_(path, device="cpu")  # noqa: E731
    wf.loader.initialize()
    served = [wf.loader.serve_next_minibatch()[1].tolist()
              for _ in range(7)]
    snap = store(wf, directory=str(tmp_path / pkg), prefix="ld",
                 interval=1, time_interval=0)
    snap.export()
    restored = load(snap.destination)
    restored.loader.initialize()
    served += [restored.loader.serve_next_minibatch()[1].tolist()
               for _ in range(40)]
    return served, wf.loader


def test_resumed_loader_keeps_its_order_as_jax(tmp_path):
    ours, loader = _loader_stream("torch", tmp_path)
    theirs, _ = _loader_stream("jax", tmp_path)
    assert ours == theirs
    # the resumed stream continues the epoch: the 8th minibatch is the
    # one the live loader serves next, not a reshuffled epoch's first
    assert ours[7] == loader.serve_next_minibatch()[1].tolist()


# -- parity: snapshot + resume in both packages -------------------------------

@pytest.fixture
def recorder(monkeypatch):
    """Per-epoch error counts and served class sweeps of both packages'
    runs, recorded at class level (instances stay picklable)."""
    from veles_tpu.loader.base import Loader as JLoader
    from veles_tpu_torch.loader.base import Loader

    log = {"epochs": [], "sweeps": []}
    for decision_cls in (DecisionGD, JDecisionGD):
        summary = decision_cls._epoch_summary

        def recorded(self, stats, epoch, _summary=summary):
            log["epochs"].append([int(s[0]) for s in stats])
            _summary(self, stats, epoch)
        monkeypatch.setattr(decision_cls, "_epoch_summary", recorded)
    for loader_cls in (Loader, JLoader):
        serve = loader_cls.serve_next_class_sweep

        def served(self, _serve=serve):
            out = _serve(self)
            log["sweeps"].append((out[0], numpy.asarray(out[1]).tolist()))
            return out
        monkeypatch.setattr(loader_cls, "serve_next_class_sweep", served)
    return log


def _schedule(pkg, mode, tmp_path, layers=None):
    """2 epochs, a snapshot (after the run, or on improved epochs during
    it), then a resume to 4. Returns the initial weights and the resumed
    workflow."""
    if pkg == "jax":
        jprng.get("default").seed(4321)
        jprng.get("loader").seed(8765)
        wf = JMLPWorkflow(JDummyLauncher(), **_kwargs(2))
        store, launcher = JSnapshotterToFile, JDummyLauncher
        load = store.import_
    else:
        prng.get("loader").seed(8765)
        wf = MLPWorkflow(DummyLauncher(), device="cpu", **_kwargs(2))
        unit_params_from_jax(wf, layers)
        store, launcher = SnapshotterToFile, DummyLauncher
        load = lambda path: store.import_(path, device="cpu")  # noqa: E731
    snap = store(wf, directory=str(tmp_path / pkg), prefix=mode,
                 interval=1, time_interval=0)
    if mode == "improved":
        _snapshot_on_improved(wf, snap)
    wf.initialize()
    initial = [{"weights": numpy.array(f.weights.mem),
                "bias": numpy.array(f.bias.mem)} for f in wf.forwards]
    wf.run()
    if mode == "end":
        snap.export()
    return initial, _resume(load(snap.destination), launcher(), 4)


@pytest.mark.parametrize("mode", ["end", "improved"])
def test_snapshot_resume_matches_jax(tmp_path, monkeypatch, recorder,
                                     mode):
    """``end``: the snapshot taken after the 2-epoch run; the resumed
    run equals an uninterrupted 4-epoch one in both packages.
    ``improved``: the samples' snapshot on the final improved tick holds
    the EVALUATED weights of the pipelined tick (one epoch behind the
    post-train state), so both packages' resumed runs leave the
    uninterrupted path the same way (ROADMAP C, reference-side)."""
    for cfg in (jroot, root):
        monkeypatch.setattr(cfg.common.engine, "precision_level", 2,
                            raising=False)
    layers, jwf = _schedule("jax", mode, tmp_path)
    jlog = {k: list(v) for k, v in recorder.items()}
    for value in recorder.values():
        value.clear()
    _, twf = _schedule("torch", mode, tmp_path, layers)
    assert recorder["sweeps"] == jlog["sweeps"]
    assert recorder["epochs"] == jlog["epochs"]
    assert len(recorder["epochs"]) == 4
    for key in ("_epochs_done", "best_n_err", "best_epoch"):
        assert getattr(twf.decision, key) == getattr(jwf.decision, key)
    for jf, tf in zip(jwf.forwards, twf.forwards):
        for attr in ("weights", "bias"):
            want = numpy.asarray(getattr(jf, attr).mem)
            numpy.testing.assert_allclose(
                getattr(tf, attr).mem, want, rtol=0,
                atol=LEVEL2_ATOL * numpy.abs(want).max())


def test_compare_snapshots(tmp_path, capsys):
    """scripts/compare_snapshots.py: identical snapshots exit 0, a
    changed weight and a changed scalar exit 1 with the differences."""
    from veles_tpu_torch.scripts.compare_snapshots import main
    wf = make_wf()
    wf.initialize()
    snap = SnapshotterToFile(wf, directory=str(tmp_path), prefix="cmp",
                             interval=1, time_interval=0)
    snap.export()
    first = str(tmp_path / "first.pickle.gz")
    shutil.copy(snap.destination, first)
    snap.export()
    assert main([first, snap.destination, "--device", "cpu"]) == 0
    wf.forwards[0].weights.data = wf.forwards[0].weights.data + 0.5
    wf.decision.max_epochs = 9
    snap.export()
    capsys.readouterr()
    assert main([first, snap.destination, "--device", "cpu"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["array_diffs"]["fwd0.weights"]["max_abs_delta"] \
        == pytest.approx(0.5)
    assert report["scalar_diffs"]["%s.max_epochs" % wf.decision.name] \
        == {"a": 1, "b": 9}
    assert not report["identical"]


@pytest.mark.parametrize("solver", ["momentum", "adam", "adagrad"])
def test_resume_keeps_the_solver_state(tmp_path, solver):
    """The fused tick's params (``_params_``) are volatile and dropped by
    the pickle; on resume it reads them back from the unit Arrays, the
    velocities, second moments and step count included: 2 epochs, a
    snapshot after the run and a resume to 4 equal 4 uninterrupted
    epochs bit for bit (moments restarted from zero would not)."""
    kwargs = _kwargs(4)
    kwargs["solver"] = solver
    results = []
    for split in (False, True):
        prng.get("default").seed(7)
        prng.get("loader").seed(8)
        kwargs["max_epochs"] = 2 if split else 4
        wf = MLPWorkflow(DummyLauncher(), device="cpu", **kwargs)
        wf.initialize()
        wf.run()
        if split:
            snap = SnapshotterToFile(wf, directory=str(tmp_path),
                                     prefix=solver, interval=1,
                                     time_interval=0)
            snap.export()
            wf = _resume(SnapshotterToFile.import_(snap.destination,
                                                   device="cpu"),
                         DummyLauncher(), 4)
        assert wf.gds[0].solver == solver
        results.append([t.data.clone() for gd in wf.gds
                        for t in (gd.weights, gd.bias, gd._velocity_w)]
                       + ([wf.gds[0]._second_w.data, wf.gds[0]._step.data]
                          if solver != "momentum" else []))
    assert len(results[0]) == len(results[1])
    for whole, split in zip(*results):
        assert torch.equal(whole, split)
