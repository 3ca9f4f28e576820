"""The port's image loaders (veles_tpu_torch/loader/image.py) against the
JAX package's on the CPU, on PNGs the tests write with PIL, in the shapes
of tests/test_image_loader.py: decode, scale (the port's numpy
reimplementation of Pillow's bicubic resampling, which the JAX package
calls), crop, the directory-scanned and index-listed loaders, the random
mirror (the port's draw patched to JAX's flips), and the MSE image loader
with unlabeled and labeled targets. Arrays match within 1e-6 (they are
equal: both sides compute the same uint8 pixels); labels and mappings are
equal. Skipped only where PIL is absent."""

import json
import os

import numpy
import pytest
import torch

import jax

from veles_tpu.core import prng as jprng
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.loader import image as jimage
from veles_tpu_torch.core import prng
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.loader import image as timage
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.ops import augment

torch.set_num_threads(1)

TOL = 1e-6


@pytest.fixture(autouse=True)
def pil():
    return pytest.importorskip("PIL.Image")


def write_png(path, color, size=(12, 12), channels=3, alpha=None):
    from PIL import Image
    arr = numpy.zeros(size + (channels,), numpy.uint8)
    arr[:, :] = color
    arr[:3, :3] = 255   # a bright corner square
    if alpha is not None:
        arr[:, :, 3] = alpha
    Image.fromarray(arr[:, :, 0] if channels == 1 else arr).save(path)


@pytest.fixture
def image_tree(tmp_path):
    """<split>/<label>/<n>.png: red vs blue squares, jittered."""
    rs = numpy.random.RandomState(3)
    for split, count in (("train", 10), ("validation", 4)):
        for label, base in (("red", (200, 30, 30)), ("blue", (30, 30, 200))):
            d = tmp_path / split / label
            d.mkdir(parents=True)
            for i in range(count):
                color = numpy.clip(numpy.array(base)
                                   + rs.randint(-20, 20, 3), 0, 255)
                write_png(str(d / ("%02d.png" % i)), color,
                          size=(14, 10) if i % 2 else (12, 12))
    return tmp_path


def _cpu_workflow():
    wf = DummyWorkflow()
    wf.device = torch.device("cpu")
    return wf


def _np(value):
    return value.numpy() if isinstance(value, torch.Tensor) \
        else numpy.asarray(value)


def _close(got, want):
    numpy.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


def _pair(jcls, tcls, seed=3, **kwargs):
    jprng.get("loader").seed(seed)
    jl = jcls(JDummyWorkflow(), **kwargs)
    jl.initialize()
    prng.get("loader").seed(seed)
    tl = tcls(_cpu_workflow(), **kwargs)
    tl.initialize()
    assert tl.class_lengths == jl.class_lengths
    assert tl.labels_mapping == jl.labels_mapping
    _close(tl.original_data.data, jl.original_data.data)
    if jl.original_labels:
        numpy.testing.assert_array_equal(_np(tl.original_labels.data),
                                         _np(jl.original_labels.data))
    return jl, tl


@pytest.mark.parametrize("color_space,channels", [
    ("RGB", 3), ("GRAY", 1), ("RGBA", 4), ("RGB", 4)],
    ids=["rgb", "gray", "rgba", "rgba-on-background"])
def test_decode_matches_jax(tmp_path, color_space, channels):
    path = str(tmp_path / "img.png")
    write_png(path, (10, 120, 230, 0)[:channels], size=(20, 10),
              channels=channels, alpha=128 if channels == 4 else None)
    got = timage.decode_image(path, color_space, (5, 6, 7))
    want = jimage.decode_image(path, color_space, (5, 6, 7))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("aspect", [False, True])
def test_scale_matches_pil(channels, aspect):
    """Pillow's bicubic resampling, down and up, in 1, 3 and 4 channels
    (RGBA premultiplied), plain and fitted on a background canvas."""
    rs = numpy.random.RandomState(channels)
    for h, w, th, tw in ((20, 10, 8, 8), (9, 31, 16, 16), (7, 7, 23, 23),
                         (40, 36, 12, 12), (5, 12, 5, 30)):
        if aspect and th != tw:
            continue
        arr = rs.randint(0, 256, (h, w, channels)).astype(numpy.float32)
        got = timage.scale_image(arr, (th, tw), aspect, 3)
        want = jimage.scale_image(arr, (th, tw), aspect, 3)
        assert got.shape == want.shape == (th, tw, channels)
        _close(got, want)


@pytest.mark.parametrize("offset", ["center", "random", (1, 2)])
@pytest.mark.parametrize("crop", [(4, 5), (0.5, 0.75)])
def test_crop_matches_jax(offset, crop):
    arr = numpy.arange(10 * 12 * 3, dtype=numpy.float32).reshape(10, 12, 3)
    got = timage.crop_image(arr, crop, offset,
                            numpy.random.RandomState(4))
    want = jimage.crop_image(arr, crop, offset,
                             numpy.random.RandomState(4))
    numpy.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="larger than image"):
        timage.crop_image(arr, (11, 3))


@pytest.mark.parametrize("kwargs", [
    {}, {"crop": (8, 8)}, {"crop": (0.5, 0.5), "crop_offset": "random"},
    {"color_space": "GRAY"}, {"scale_maintain_aspect_ratio": True}],
    ids=["scale", "crop", "random-fraction-crop", "gray", "aspect"])
def test_auto_label_file_image_loader_matches_jax(image_tree, kwargs):
    kwargs = dict(kwargs, train_paths=[str(image_tree / "train")],
                  validation_paths=[str(image_tree / "validation")],
                  size=(12, 12), minibatch_size=8)
    jl, tl = _pair(jimage.AutoLabelFileImageLoader,
                   timage.AutoLabelFileImageLoader, **kwargs)
    assert tl.class_lengths == [0, 8, 20]
    assert tl.labels_mapping == {"blue": 0, "red": 1}
    assert tl.original_data.shape[1:] == tl.sample_shape \
        == jl.sample_shape
    for _ in range(3):
        jl.run()
        tl.run()
        _close(tl.minibatch_data.data, jl.minibatch_data.data)


def test_mirror_matches_jax_with_its_draws(image_tree, monkeypatch):
    """``mirror="random"``: TRAIN minibatches flip per sample (the port's
    draw patched to JAX's flips for each seed), the others never."""
    seen = []

    def draw(seed, n, device):
        seen.append(seed)
        return torch.from_numpy(numpy.array(jax.random.bernoulli(
            jax.random.key(seed), 0.5, (n,)))).to(device)

    monkeypatch.setattr(augment, "mirror_draw", draw)
    jl, tl = _pair(jimage.AutoLabelFileImageLoader,
                   timage.AutoLabelFileImageLoader,
                   train_paths=[str(image_tree / "train")],
                   validation_paths=[str(image_tree / "validation")],
                   size=(12, 12), minibatch_size=8, mirror="random")
    assert tl.has_fill_transforms and tl.jit_transform == "mirror"
    trained = 0
    for _ in range(6):
        jl.run()
        tl.run()
        _close(tl.minibatch_data.data, jl.minibatch_data.data)
        trained += tl.minibatch_class == TRAIN
    assert trained and len(seen) == trained


def test_file_list_image_loader_matches_jax(image_tree, tmp_path):
    lines = []
    for label in ("red", "blue"):
        for i in range(4):
            lines.append("validation/%s/%02d.png %s" % (label, i, label))
    (tmp_path / "val.txt").write_text("\n".join(lines) + "\n")
    listing = {str(i): {"path": "train/%s/%02d.png" % (label, i),
                        "label": [label]}
               for i, label in enumerate(["red", "blue"] * 5)}
    (tmp_path / "train.json").write_text(json.dumps(listing))
    jl, tl = _pair(jimage.FileListImageLoader, timage.FileListImageLoader,
                   path_to_val_text_file=str(tmp_path / "val.txt"),
                   path_to_train_text_file=str(tmp_path / "train.json"),
                   base_directory=str(image_tree), size=(12, 12),
                   minibatch_size=4, validation_ratio=0.2)
    assert tl.class_lengths == [0, 10, 8]


def _mse_tree(tmp_path, n=6, labeled=False):
    tree = tmp_path / "mse"
    (tree / "train" / "x").mkdir(parents=True)
    (tree / "targets").mkdir()
    for i in range(n):
        write_png(str(tree / "train" / "x" / ("%02d.png" % i)),
                  (i * 30, 100, 200 - i * 20))
        write_png(str(tree / "targets" / ("t%02d.png" % i)),
                  (200 - i * 20, i * 30, 50), size=(10, 14))
    return tree


def test_mse_image_loader_pairs_by_sorted_order(tmp_path):
    """Unlabeled: the i-th sample's target is the i-th sorted target
    image, scaled like the samples; the targets ride the gather."""
    tree = _mse_tree(tmp_path)
    jl, tl = _pair(jimage.FileImageLoaderMSE, timage.FileImageLoaderMSE,
                   train_paths=[str(tree / "train")],
                   target_paths=[str(tree / "targets")], size=(12, 12),
                   minibatch_size=3, target_normalization_type="none")
    assert tl.original_targets.shape == (6, 12, 12, 3)
    _close(tl.original_targets.data, jl.original_targets.data)
    for _ in range(2):
        jl.run()
        tl.run()
        _close(tl.minibatch_targets.data, jl.minibatch_targets.data)
        _close(tl.minibatch_targets.data,
               _np(tl.original_targets.data)[tl.minibatch_indices.data])


def test_mse_image_loader_maps_targets_by_label(tmp_path):
    """Labeled: a sample's target is the target image with its label
    (one per label); a target count that does not match an unlabeled
    set is refused, as in the JAX loader."""
    tree = _mse_tree(tmp_path, n=4)

    def labeled(module):
        class Labeled(module.FileImageLoaderMSE):
            def get_label_from_filename(self, filename):
                return os.path.basename(filename)[-6:-4]
        return Labeled

    jl, tl = _pair(labeled(jimage), labeled(timage),
                   train_paths=[str(tree / "train")],
                   target_paths=[str(tree / "targets")], size=(8, 8),
                   minibatch_size=2, target_normalization_type="mean_disp")
    assert tl.original_targets.shape == (4, 8, 8, 3)
    _close(tl.original_targets.data, jl.original_targets.data)
    os.unlink(str(tree / "targets" / "t03.png"))
    with pytest.raises(ValueError, match="one target per sample"):
        timage.FileImageLoaderMSE(
            _cpu_workflow(), train_paths=[str(tree / "train")],
            target_paths=[str(tree / "targets")], size=(8, 8),
            target_normalization_type="none").initialize()


def test_image_loader_trains_in_the_fused_tick(image_tree):
    """A convnet over the directory-scanned images with the random mirror
    trains through the fused tick (the mirror is its TRAIN transform)."""
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.standard import StandardWorkflow
    prng.get("default").seed(1)
    prng.get("loader").seed(1)
    wf = StandardWorkflow(
        DummyLauncher(), device="cpu",
        loader_cls=timage.AutoLabelFileImageLoader,
        loader_kwargs=dict(train_paths=[str(image_tree / "train")],
                           validation_paths=[str(image_tree / "validation")],
                           size=(12, 12), minibatch_size=8, mirror="random",
                           normalization_type="mean_disp"),
        layers=[{"type": "conv_tanh", "n_kernels": 4, "kx": 3, "ky": 3},
                {"type": "max_pooling", "kx": 2, "ky": 2},
                {"type": "softmax", "output_sample_shape": 2}],
        learning_rate=0.05, decision_kwargs=dict(max_epochs=3),
        name="images")
    wf.initialize()
    assert wf.fused_tick is not None
    wf.run()
    assert wf.decision.epochs_done == 3
