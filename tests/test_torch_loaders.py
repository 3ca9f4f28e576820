"""The port's file loaders against the JAX package's on the CPU, on files
the tests write: ``MNISTLoader`` (idx, plain and gzipped, flat and NHWC,
and ``MLPWorkflow(loader_cls=MNISTLoader)``), ``PicklesLoader``,
``file_loader``'s filters and scanners, ``SoundFileLoader`` with the
auto-label mixin (stdlib ``wave`` files), and ``MinibatchesSaver`` /
``MinibatchesLoader``, whose streams each package replays from the
other. Arrays, labels and mappings are equal bit for bit (the sound
windows to 1e-6: both decode in float64 and round to float32)."""

import gzip
import os
import pickle
import struct
import wave

import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.loader import file_loader as jfile_loader
from veles_tpu.loader.fullbatch import FullBatchLoader as JFullBatchLoader
from veles_tpu.loader.mnist import MNISTLoader as JMNISTLoader
from veles_tpu.loader.mnist import read_idx as jread_idx
from veles_tpu.loader.pickles import PicklesLoader as JPicklesLoader
from veles_tpu.loader.saver import MinibatchesLoader as JMinibatchesLoader
from veles_tpu.loader.saver import MinibatchesSaver as JMinibatchesSaver
from veles_tpu.loader.sound import (
    AutoLabelSoundFileLoader as JAutoLabelSoundFileLoader)
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.loader import file_loader
from veles_tpu_torch.loader.base import loader_registry
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.loader.mnist import MNISTLoader, read_idx
from veles_tpu_torch.loader.pickles import PicklesLoader
from veles_tpu_torch.loader.saver import (MinibatchesLoader,
                                          MinibatchesSaver)
from veles_tpu_torch.loader.sound import (AutoLabelSoundFileLoader,
                                          SoundDecoderMixin)
from veles_tpu_torch.models.mlp import MLPWorkflow

torch.set_num_threads(1)


def _cpu_workflow():
    wf = DummyWorkflow()
    wf.device = torch.device("cpu")
    return wf


def _np(value):
    return value.numpy() if isinstance(value, torch.Tensor) \
        else numpy.asarray(value)


# -- MNIST idx ----------------------------------------------------------------

def write_idx(path, array):
    """An idx file (gzipped where the name ends in .gz): the big-endian
    header, then the uint8 payload."""
    header = struct.pack(">HBB", 0, 0x08, array.ndim) + struct.pack(
        ">" + "I" * array.ndim, *array.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as fout:
        fout.write(header + array.astype(numpy.uint8).tobytes())


def mnist_dir(root, n_train=120, n_test=40, gz=("train-labels-idx1-ubyte",
                                                "t10k-images-idx3-ubyte")):
    """Four idx files of MNIST's layout at a small size, two gzipped."""
    rs = numpy.random.RandomState(21)
    arrays = {
        "train-images-idx3-ubyte": rs.randint(0, 256, (n_train, 28, 28)),
        "train-labels-idx1-ubyte": numpy.arange(n_train) % 10,
        "t10k-images-idx3-ubyte": rs.randint(0, 256, (n_test, 28, 28)),
        "t10k-labels-idx1-ubyte": (numpy.arange(n_test) * 7) % 10}
    os.makedirs(root, exist_ok=True)
    for stem, array in arrays.items():
        write_idx(os.path.join(root, stem + (".gz" if stem in gz else "")),
                  array)
    return arrays


def test_read_idx_matches_jax(tmp_path):
    arrays = mnist_dir(str(tmp_path))
    for name in os.listdir(str(tmp_path)):
        path = str(tmp_path / name)
        got, want = read_idx(path), jread_idx(path)
        assert got.dtype == want.dtype
        numpy.testing.assert_array_equal(got, want)
        stem = name[:-3] if name.endswith(".gz") else name
        numpy.testing.assert_array_equal(got, arrays[stem])
    bad = str(tmp_path / "bad")
    with open(bad, "wb") as fout:
        fout.write(b"\x01\x02\x03\x04")
    with pytest.raises(ValueError, match="not an idx file"):
        read_idx(bad)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "nhwc"])
def test_mnist_loader_matches_jax(tmp_path, flat):
    """original_data, labels and class lengths bit for bit ([0, n_test,
    n_train]: the test set validates), and the linear normalizer's
    output on integer pixels: bit for bit the JAX normalizer's numpy
    formula, within one float32 rounding (1.2e-7 of the interval) of the
    JAX loader's jitted fill, where XLA contracts the rescale's multiply
    and add into one fused multiply-add."""
    arrays = mnist_dir(str(tmp_path))
    jl = JMNISTLoader(JDummyWorkflow(), directory=str(tmp_path), flat=flat,
                      minibatch_size=40)
    tl = MNISTLoader(_cpu_workflow(), directory=str(tmp_path), flat=flat,
                     minibatch_size=40)
    jprng.get("loader").seed(3)
    jl.initialize()
    prng.get("loader").seed(3)
    tl.initialize()
    assert tl.class_lengths == jl.class_lengths == [0, 40, 120]
    shape = (784,) if flat else (28, 28, 1)
    assert tl.original_data.shape == (160,) + shape
    numpy.testing.assert_array_equal(_np(tl.original_data.data),
                                     numpy.asarray(jl.original_data.data))
    numpy.testing.assert_array_equal(
        _np(tl.original_data.data)[40:].reshape(120, 28, 28),
        arrays["train-images-idx3-ubyte"])
    numpy.testing.assert_array_equal(_np(tl.original_labels.data),
                                     numpy.asarray(jl.original_labels.data))
    assert tl.labels_mapping == jl.labels_mapping
    for _ in range(3):
        jl.run()
        tl.run()
        got = _np(tl.minibatch_data.data)
        index = numpy.asarray(jl.minibatch_indices.data)
        numpy.testing.assert_array_equal(tl.minibatch_indices.data, index)
        numpy.testing.assert_array_equal(got, jl.normalizer.normalize(
            numpy.asarray(jl.original_data.data)[index]))
        numpy.testing.assert_allclose(
            got, numpy.asarray(jl.minibatch_data.data), rtol=0,
            atol=1.2e-7)
        numpy.testing.assert_array_equal(
            _np(tl.minibatch_labels.data),
            numpy.asarray(jl.minibatch_labels.data))


def test_mnist_loader_raises_without_files(tmp_path):
    loader = MNISTLoader(_cpu_workflow(), directory=str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="no url_base"):
        loader.initialize()
    loader = MNISTLoader(_cpu_workflow(), directory=str(tmp_path / "none"),
                         url_base="https://example.invalid/mnist")
    with pytest.raises(FileNotFoundError, match="later slice"):
        loader.initialize()
    assert loader_registry["mnist"] is MNISTLoader


def test_mnist_workflow_matches_jax(tmp_path):
    """``MLPWorkflow(loader_cls=MNISTLoader)`` in both packages from the
    same weights: equal index streams and per-epoch n_err (level 0, the
    default, as the repo's MNIST784 sample runs)."""
    mnist_dir(str(tmp_path), n_train=300, n_test=100)
    kwargs = dict(layers=(16, 10), loader_cls=None,
                  loader_kwargs=dict(directory=str(tmp_path),
                                     minibatch_size=50),
                  learning_rate=0.03, gradient_moment=0.9, max_epochs=2,
                  name="MNIST784")
    jprng.get("default").seed(7)
    jprng.get("loader").seed(8)
    jwf = JMLPWorkflow(JDummyLauncher(), **dict(kwargs,
                                                loader_cls=JMNISTLoader))
    prng.get("loader").seed(8)
    twf = MLPWorkflow(DummyLauncher(), device="cpu",
                      **dict(kwargs, loader_cls=MNISTLoader))
    streams = []
    for wf in (jwf, twf):
        served = []
        serve = wf.loader.serve_next_class_sweep

        def recorded(serve=serve, served=served):
            block = serve()
            served.append(numpy.asarray(block[1]).copy())
            return block

        wf.loader.serve_next_class_sweep = recorded
        errors = []
        summary = wf.decision._epoch_summary

        def stamped(stats, epoch, summary=summary, errors=errors):
            errors.append([int(s[0]) for s in stats])
            summary(stats, epoch)

        wf.decision._epoch_summary = stamped
        streams.append((served, errors))
    jwf.initialize()
    unit_params_from_jax(twf, [{"weights": numpy.asarray(f.weights.data),
                                "bias": numpy.asarray(f.bias.data)}
                               for f in jwf.forwards])
    twf.initialize()
    assert isinstance(twf.loader, MNISTLoader)
    assert twf.fused_tick is not None
    jwf.run()
    twf.run()
    (jserved, jerrors), (tserved, terrors) = streams
    assert len(tserved) == len(jserved) == 4
    for a, b in zip(tserved, jserved):
        numpy.testing.assert_array_equal(a, b)
    assert terrors == jerrors and len(terrors) == 2


# -- pickles ------------------------------------------------------------------

def dataset(n=48, dim=5, seed=0):
    rs = numpy.random.RandomState(seed)
    return (rs.uniform(-1, 1, (n, dim)).astype(numpy.float32),
            rs.randint(0, 3, n).astype(numpy.int32))


@pytest.mark.parametrize("form", ["tuple", "dict", "bare"])
def test_pickles_loader_matches_jax(tmp_path, form):
    x, y = dataset()
    paths = []
    for i, sl in enumerate((slice(0, 16), slice(16, 48))):
        path = str(tmp_path / ("part%d.pickle" % i))
        payload = {"tuple": (x[sl], y[sl]),
                   "dict": {"data": x[sl], "labels": y[sl]},
                   "bare": x[sl]}[form]
        with open(path, "wb") as fout:
            pickle.dump(payload, fout)
        paths.append(path)
    kwargs = dict(validation_pickles=[paths[0]], train_pickles=[paths[1]],
                  minibatch_size=8)
    jprng.get("loader").seed(4)
    jl = JPicklesLoader(JDummyWorkflow(), **kwargs)
    jl.initialize()
    prng.get("loader").seed(4)
    tl = PicklesLoader(_cpu_workflow(), **kwargs)
    tl.initialize()
    assert tl.class_lengths == jl.class_lengths == [0, 16, 32]
    numpy.testing.assert_array_equal(_np(tl.original_data.data), x)
    assert bool(tl.original_labels) == (form != "bare")
    if form != "bare":
        numpy.testing.assert_array_equal(
            _np(tl.original_labels.data),
            numpy.asarray(jl.original_labels.data))
    for _ in range(3):
        jl.run()
        tl.run()
        numpy.testing.assert_array_equal(
            _np(tl.minibatch_data.data), numpy.asarray(jl.minibatch_data.data))


def test_pickles_loader_refuses_mixed_shapes_and_labels(tmp_path):
    x, y = dataset()
    good, bad, bare = (str(tmp_path / n) for n in ("g.pickle", "b.pickle",
                                                   "n.pickle"))
    with open(good, "wb") as fout:
        pickle.dump({"data": x, "labels": y}, fout)
    with open(bad, "wb") as fout:
        pickle.dump({"data": numpy.zeros((4, 9), numpy.float32),
                     "labels": numpy.zeros(4, numpy.int32)}, fout)
    with open(bare, "wb") as fout:
        pickle.dump(x, fout)
    with pytest.raises(ValueError, match="sample shapes differ"):
        PicklesLoader(_cpu_workflow(), train_pickles=[good],
                      validation_pickles=[bad]).initialize()
    with pytest.raises(ValueError, match="some pickles have labels"):
        PicklesLoader(_cpu_workflow(), train_pickles=[good, bare]
                      ).initialize()
    with pytest.raises(ValueError, match="no pickles"):
        PicklesLoader(_cpu_workflow()).initialize()


# -- file filters and scanners ------------------------------------------------

@pytest.mark.parametrize("name,kwargs", [
    ("/data/x.png", {}), ("/data/x.jpg", {}), ("/data/bad.png", {}),
    ("/data/x.txt", {}), ("junk.pngXXX.png", {}), ("junk.png", {}),
    ("/a/b.wav", {"file_type": "audio", "file_subtypes": ["x-wav", "wav"]}),
    ("/a/b.png", {"included_files": [".*/keep/.*"]}),
    ("/a/keep/b.png", {"included_files": [".*/keep/.*"]})])
def test_file_filter_matches_jax(name, kwargs):
    kwargs = dict({"file_type": "image", "file_subtypes": ["png"],
                   "ignored_files": [".*bad.*", "junk.png"]}, **kwargs)
    assert file_loader.FileFilter(**kwargs).is_valid_filename(name) \
        == jfile_loader.FileFilter(**kwargs).is_valid_filename(name)


def test_auto_label_and_list_scanner_match_jax(tmp_path):
    for path in ("data/cats/1.png", "d/dogs/2.png", "data/x/y/z.png"):
        assert file_loader.AutoLabelMixin().get_label_from_filename(
            os.path.join(*path.split("/"))) \
            == jfile_loader.AutoLabelMixin().get_label_from_filename(
                os.path.join(*path.split("/")))
    with pytest.raises(ValueError):
        file_loader.AutoLabelMixin().get_label_from_filename("orphan.png")
    custom = {"label_regexp": r"(\d)\.png$"}
    assert file_loader.AutoLabelMixin(**custom).get_label_from_filename(
        "a/7.png") == "7"
    index = tmp_path / "index.txt"
    index.write_text("a.png cat\n\nb.png dog\nc.png\n")
    listing = tmp_path / "index.json"
    listing.write_text('{"1": {"path": "d.png", "label": ["bird"]}, '
                       '"2": {"path": "e.png", "label": []}}')

    class Logged:
        def info(self, *args):
            pass

        warning = info

    class TList(file_loader.FileListScannerMixin, Logged):
        pass

    class JList(jfile_loader.FileListScannerMixin, Logged):
        pass

    for pathname in (str(index), str(listing)):
        t = TList(base_directory=str(tmp_path))
        j = JList(base_directory=str(tmp_path))
        files = t.scan_files(pathname)
        assert files == j.scan_files(pathname)
        assert [t.get_label_from_filename(f) for f in files] \
            == [j.get_label_from_filename(f) for f in files]


def test_directory_scanner_matches_jax(tmp_path):
    for rel in ("b/2.png", "a/1.png", "a/sub/3.png", "a/notes.txt",
                "c/4.jpg"):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"")

    def scanner(module):
        class Scanner(module.FileFilter, module.FileScannerMixin):
            def info(self, *args):
                pass

            warning = info

            def __init__(self):
                module.FileFilter.__init__(self, file_type="image",
                                           file_subtypes=["png"])
                module.FileScannerMixin.__init__(
                    self, train_paths=[str(tmp_path)])
        return Scanner()

    got = scanner(file_loader).collect_keys([str(tmp_path)])
    assert got == scanner(jfile_loader).collect_keys([str(tmp_path)])
    assert [os.path.relpath(p, str(tmp_path)) for p in got] == [
        os.path.join("a", "1.png"), os.path.join("a", "sub", "3.png"),
        os.path.join("b", "2.png")]
    with pytest.raises(TypeError):
        file_loader.FileScannerMixin(train_paths="not-a-list")


# -- sound --------------------------------------------------------------------

def write_wav(path, freq, seconds=0.2, rate=8000, channels=1, width=2):
    t = numpy.arange(int(rate * seconds)) / rate
    signal = numpy.sin(2 * numpy.pi * freq * t)
    if width == 2:
        payload = (signal * 32000).astype(numpy.int16)
    elif width == 4:
        payload = (signal * 2e9).astype(numpy.int32)
    else:
        payload = ((signal * 120) + 128).astype(numpy.uint8)
    if channels == 2:
        payload = numpy.repeat(payload[:, None], 2, axis=1).reshape(-1)
    with wave.open(path, "wb") as out:
        out.setnchannels(channels)
        out.setsampwidth(width)
        out.setframerate(rate)
        out.writeframes(payload.tobytes())
    return payload


@pytest.mark.parametrize("width,channels", [(2, 1), (1, 1), (4, 1), (2, 2)])
def test_decode_matches_jax_and_the_written_samples(tmp_path, width,
                                                    channels):
    from veles_tpu.loader.sound import SoundDecoderMixin as JDecoder
    path = str(tmp_path / "a.wav")
    payload = write_wav(path, 440, channels=channels, width=width)
    got, want = SoundDecoderMixin.decode_file(path), JDecoder.decode_file(
        path)
    for key in ("sampling_rate", "samples", "channels"):
        assert got[key] == want[key]
    numpy.testing.assert_array_equal(got["data"], want["data"])
    scale = {1: 128.0, 2: 32768.0, 4: 2147483648.0}[width]
    offset = 128.0 if width == 1 else 0.0
    numpy.testing.assert_array_equal(
        got["data"], ((payload.astype(numpy.float64) - offset) / scale
                      ).astype(numpy.float32).reshape(-1, channels))


@pytest.mark.parametrize("mono", [True, False])
def test_sound_loader_matches_jax(tmp_path, mono):
    for split, count in (("train", 3), ("validation", 1)):
        for label, freq in (("low", 200), ("high", 1800)):
            d = tmp_path / split / label
            d.mkdir(parents=True)
            for i in range(count):
                write_wav(str(d / ("%d.wav" % i)), freq + i * 7,
                          channels=2 if mono else 1)
    kwargs = dict(train_paths=[str(tmp_path / "train")],
                  validation_paths=[str(tmp_path / "validation")],
                  window_size=400, window_stride=300, minibatch_size=8,
                  mono=mono)
    jprng.get("loader").seed(6)
    jl = JAutoLabelSoundFileLoader(JDummyWorkflow(), **kwargs)
    jl.initialize()
    prng.get("loader").seed(6)
    tl = AutoLabelSoundFileLoader(_cpu_workflow(), **kwargs)
    tl.initialize()
    # 1600 frames a clip, windows of 400 every 300 -> 5 a clip
    assert tl.class_lengths == jl.class_lengths == [0, 2 * 5, 6 * 5]
    assert tl.labels_mapping == jl.labels_mapping == {"high": 0, "low": 1}
    numpy.testing.assert_allclose(_np(tl.original_data.data),
                                  numpy.asarray(jl.original_data.data),
                                  rtol=1e-6, atol=1e-6)
    numpy.testing.assert_array_equal(_np(tl.original_labels.data),
                                     numpy.asarray(jl.original_labels.data))


def test_sound_classifier_trains_through_the_loader(tmp_path):
    """The tones workflow of tests/test_sound_loader.py in the port:
    StandardWorkflow with loader_cls=AutoLabelSoundFileLoader."""
    from veles_tpu_torch.models.standard import StandardWorkflow
    for split, count in (("train", 6), ("validation", 2)):
        for label, freq in (("low", 200), ("high", 1800)):
            d = tmp_path / split / label
            d.mkdir(parents=True)
            for i in range(count):
                write_wav(str(d / ("%d.wav" % i)), freq + i * 7)
    prng.get("default").seed(2)
    prng.get("loader").seed(2)
    wf = StandardWorkflow(
        DummyLauncher(), device="cpu", loader_cls=AutoLabelSoundFileLoader,
        loader_kwargs=dict(train_paths=[str(tmp_path / "train")],
                           validation_paths=[str(tmp_path / "validation")],
                           window_size=400, window_stride=200,
                           minibatch_size=16),
        layers=[{"type": "all2all_tanh", "output_sample_shape": 16},
                {"type": "softmax", "output_sample_shape": 2}],
        learning_rate=0.2, decision_kwargs=dict(max_epochs=10),
        name="tones")
    wf.initialize()
    wf.run()
    best, total = wf.decision.best_n_err[1], wf.loader.class_lengths[1]
    assert best is not None and best <= total * 0.25


# -- the minibatch stream -----------------------------------------------------

def _record(package, path, codec, n_minibatches=6):
    """One epoch of a label-carrying full-batch loader recorded by
    ``package``'s saver ("jax" or "torch"); returns the served
    minibatches (data, labels, class, valid)."""
    x, y = dataset()
    kwargs = dict(data=x, labels=y, class_lengths=[0, 16, 32],
                  minibatch_size=8, shuffle_limit=0)
    if package == "jax":
        wf = JDummyWorkflow()
        loader = JFullBatchLoader(wf, **kwargs)
        saver_cls = JMinibatchesSaver
    else:
        wf = _cpu_workflow()
        loader = FullBatchLoader(wf, **kwargs)
        saver_cls = MinibatchesSaver
    wf.loader = loader
    saver = saver_cls(wf, file_name=path, compression=codec)
    saver.link_attrs(loader, "minibatch_data", "minibatch_labels",
                     "minibatch_class", "minibatch_valid_size",
                     "class_lengths", "max_minibatch_size")
    loader.initialize()
    saver.initialize()
    served = []
    for _ in range(n_minibatches):
        loader.run()
        saver.run()
        served.append((_np(loader.minibatch_data.data).copy(),
                       _np(loader.minibatch_labels.data).copy(),
                       loader.minibatch_class, loader.minibatch_valid_size))
    saver.stop()
    return served


def _replay(package, path, n_minibatches=6):
    if package == "jax":
        loader = JMinibatchesLoader(JDummyWorkflow(), file_name=path,
                                    minibatch_size=8)
    else:
        loader = MinibatchesLoader(_cpu_workflow(), file_name=path,
                                   minibatch_size=8)
    loader.initialize()
    assert loader.class_lengths == [0, 16, 32]
    assert loader.labels_mapping == {0: 0, 1: 1, 2: 2}
    replayed = []
    for _ in range(n_minibatches):
        loader.run()
        replayed.append((_np(loader.minibatch_data.data).copy(),
                         _np(loader.minibatch_labels.data).copy(),
                         loader.minibatch_class,
                         loader.minibatch_valid_size))
    loader.stop()
    return replayed


@pytest.mark.parametrize("codec", ["gz", "bz2", "xz"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_minibatch_stream_crosses_packages(tmp_path, codec, writer, reader):
    path = str(tmp_path / "stream.dat")
    served = _record(writer, path, codec)
    replayed = _replay(reader, path)
    for (sd, sl, sk, sv), (rd, rl, rk, rv) in zip(served, replayed):
        assert (rk, rv) == (sk, sv)
        assert rd.tobytes() == sd.tobytes()
        assert rl.tobytes() == sl.tobytes()


def test_saver_requires_no_shuffle_and_a_known_codec(tmp_path):
    x, y = dataset()
    wf = _cpu_workflow()
    loader = FullBatchLoader(wf, data=x, labels=y, class_lengths=[0, 16, 32])
    wf.loader = loader
    saver = MinibatchesSaver(wf, file_name=str(tmp_path / "s.dat"))
    saver.link_attrs(loader, "minibatch_data", "minibatch_labels",
                     "minibatch_class", "minibatch_valid_size",
                     "class_lengths", "max_minibatch_size")
    loader.initialize()
    with pytest.raises(ValueError, match="shuffle"):
        saver.initialize()
    with pytest.raises(ValueError, match="unknown compression"):
        MinibatchesSaver(wf, file_name=str(tmp_path / "t.dat"),
                         compression="snappy")
