"""Image loading pipeline.

The port of ``veles_tpu/loader/image.py`` (reference
``veles/loader/image.py:106-705`` + ``fullbatch_image.py:56-266``):

- decode once, on the host, with PIL, imported only inside
  :func:`decode_image` (the card's machine has no PIL; an image loader
  runs where it does): color conversion, alpha blending over a
  background;
- scale and crop in numpy: :func:`scale_image` is Pillow's 8-bit bicubic
  resampling (``Resample.c``: the filter's support widened by the
  downscale factor, coefficients in 22-bit fixed point, a horizontal then
  a vertical pass, each rounded and clipped to uint8, alpha premultiplied
  for RGBA), so the arrays equal the JAX package's, which calls PIL;
- the dataset device-resident afterwards (FullBatchLoader), and the
  random mirror (``mirror="random"``) the loader's TRAIN transform
  (``ops/augment``), applied by the fill and by the fused tick alike.
"""

import numpy

from veles_tpu_torch.core import prng
from veles_tpu_torch.loader.base import TEST, VALID, TRAIN, register_loader
from veles_tpu_torch.loader.file_loader import (AutoLabelMixin, FileFilter,
                                                FileListScannerMixin,
                                                FileScannerMixin)
from veles_tpu_torch.loader.fullbatch import (FullBatchLoader,
                                              FullBatchLoaderMSE)

#: PIL modes for the supported color spaces.
_COLOR_MODES = {"RGB": "RGB", "GRAY": "L", "L": "L", "RGBA": "RGBA"}
#: Pillow's fixed-point precision for 8-bit resampling (Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def decode_image(source, color_space="RGB", background_color=None):
    """Decode an image file/path to float32 HWC (reference ImageLoader
    decode + background blending, ``image.py:406-443``). RGBA sources are
    alpha-blended over ``background_color`` when converting to RGB."""
    from PIL import Image
    img = Image.open(source)
    mode = _COLOR_MODES.get(color_space)
    if mode is None:
        raise ValueError("unsupported color_space %r" % color_space)
    if img.mode == "RGBA" and mode != "RGBA":
        background = Image.new(
            "RGBA", img.size,
            tuple(background_color or (0, 0, 0)) + (255,))
        img = Image.alpha_composite(background, img)
    if img.mode != mode:
        img = img.convert(mode)
    arr = numpy.asarray(img, dtype=numpy.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _bicubic(x):
    """Pillow's bicubic filter (a = -0.5, support 2), in its own order of
    operations."""
    x = abs(x)
    if x < 1.0:
        return (1.5 * x - 2.5) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * -0.5
    return 0.0


def _resample_axis(img, out_size, axis):
    """One resampling pass of uint8 ``img`` (H, W, C) along ``axis``, as
    Pillow's ``ImagingResampleHorizontal/Vertical_8bpc``."""
    in_size = img.shape[axis]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    src = numpy.moveaxis(img, axis, 0).astype(numpy.int64)
    out = numpy.empty((out_size,) + src.shape[1:], numpy.uint8)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = numpy.array([_bicubic((x + xmin - center + 0.5) * ss)
                         for x in range(xmax)])
        total = w.sum()
        if total != 0.0:
            w = w / total
        fixed = numpy.trunc(w * (1 << _PRECISION_BITS)
                            + numpy.where(w < 0, -0.5, 0.5))
        acc = (1 << (_PRECISION_BITS - 1)) + numpy.tensordot(
            fixed.astype(numpy.int64), src[xmin:xmin + xmax], axes=(0, 0))
        out[xx] = numpy.clip(acc >> _PRECISION_BITS, 0, 255)
    return numpy.moveaxis(out, 0, axis)


def _premultiply(arr):
    """Pillow's RGBA -> RGBa (and LA -> La): color * alpha / 255, rounded
    as ``MULDIV255``."""
    alpha = arr[..., -1:].astype(numpy.int64)
    tmp = arr[..., :-1].astype(numpy.int64) * alpha + 128
    color = ((tmp >> 8) + tmp) >> 8
    return numpy.concatenate([color, alpha], -1).astype(numpy.uint8)


def _unpremultiply(arr):
    """Pillow's RGBa -> RGBA: color * 255 / alpha, truncated and clipped;
    alpha 0 and 255 pass the color through."""
    alpha = arr[..., -1:].astype(numpy.int64)
    color = arr[..., :-1].astype(numpy.int64)
    divided = numpy.clip(255 * color // numpy.maximum(alpha, 1), 0, 255)
    color = numpy.where((alpha == 255) | (alpha == 0), color, divided)
    return numpy.concatenate([color, alpha], -1).astype(numpy.uint8)


def _resize_uint8(arr, target_hw):
    """Bicubic resize of uint8 HWC to (H, W), as ``PIL.Image.resize(...,
    BICUBIC)`` computes it: the horizontal pass, then the vertical one,
    alpha premultiplied around both."""
    th, tw = target_hw
    if arr.shape[:2] == (th, tw):
        return arr  # PIL returns a copy, without the alpha round trip
    alpha = arr.shape[2] in (2, 4)
    if alpha:
        arr = _premultiply(arr)
    if tw != arr.shape[1]:
        arr = _resample_axis(arr, tw, 1)
    if th != arr.shape[0]:
        arr = _resample_axis(arr, th, 0)
    return _unpremultiply(arr) if alpha else arr


def scale_image(arr, target_hw, maintain_aspect_ratio=False,
                background_color=0):
    """Bicubic resize to (H, W); with ``maintain_aspect_ratio`` the image
    is fit inside and centered on a background canvas (reference
    ``scale_image``, ``image.py:444-483``). The pixels are truncated to
    uint8 first, as the JAX package's PIL path does."""
    th, tw = target_hw
    h, w = arr.shape[:2]
    if (h, w) == (th, tw):
        return arr
    channels = arr.shape[2]
    src = arr.astype(numpy.uint8)
    if maintain_aspect_ratio:
        if w >= h:
            dw, dh = tw, max(1, int(round(tw * h / w)))
        else:
            dh, dw = th, max(1, int(round(th * w / h)))
        canvas = numpy.full((th, tw, channels), background_color,
                            numpy.float32)
        y0, x0 = (th - dh) // 2, (tw - dw) // 2
        canvas[y0:y0 + dh, x0:x0 + dw] = _resize_uint8(src, (dh, dw))
        return canvas
    return _resize_uint8(src, (th, tw)).astype(numpy.float32)


def crop_image(arr, crop_hw, offset="center", rng=None):
    """Cut a (H, W) window; ``offset`` is "center", "random", or explicit
    (y, x). Fractional crop sizes are ratios of the source (reference
    ``crop_image``, ``image.py:508-531``)."""
    h, w = arr.shape[:2]
    ch, cw = (int(c * s) if isinstance(c, float) else int(c)
              for c, s in zip(crop_hw, (h, w)))
    if ch > h or cw > w:
        raise ValueError("crop %s larger than image %s" % ((ch, cw), (h, w)))
    if offset == "center":
        y0, x0 = (h - ch) // 2, (w - cw) // 2
    elif offset == "random":
        gen = rng or prng.get("loader")
        y0 = int(gen.randint(0, h - ch + 1))
        x0 = int(gen.randint(0, w - cw + 1))
    else:
        y0, x0 = offset
    return arr[y0:y0 + ch, x0:x0 + cw]


class FullBatchImageLoader(FullBatchLoader):
    """Device-resident image dataset with load-time scale/crop and a
    random train-time mirror (reference ``FullBatchImageLoader``,
    ``fullbatch_image.py:56-177``).

    Subclasses (or mixins) provide the image source:
    ``get_keys(klass) -> [key...]``, ``get_image_label(key)``,
    ``get_image_data(key) -> float32 HWC`` (reference IImageLoader,
    ``image.py:83-104``).
    """

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.size = tuple(kwargs.pop("size"))
        self.color_space = kwargs.pop("color_space", "RGB")
        self.scale_maintain_aspect_ratio = kwargs.pop(
            "scale_maintain_aspect_ratio", False)
        self.crop = kwargs.pop("crop", None)
        self.crop_offset = kwargs.pop("crop_offset", "center")
        self.mirror = kwargs.pop("mirror", False)
        self.background_color = kwargs.pop("background_color", 0)
        if self.mirror not in (False, "random"):
            raise ValueError(
                "mirror must be False or 'random' (deterministic mirror "
                "inflation is replaced by in-tick random augmentation)")
        if self.mirror == "random":
            # the loader's TRAIN transform: the fill and the fused tick
            # apply ops/augment's mirror with the loader-drawn seeds
            kwargs["train_transform"] = "mirror"
        super().__init__(workflow, **kwargs)

    # -- image source contract ----------------------------------------------
    def get_keys(self, klass):
        raise NotImplementedError

    def get_image_label(self, key):
        raise NotImplementedError

    def get_image_data(self, key):
        """Decode one sample. Default: treat key as a file path."""
        return decode_image(key, self.color_space, self.background_color)

    # -- loading -------------------------------------------------------------
    @property
    def sample_shape(self):
        if self.crop:
            # fractional crops are ratios of the scaled size
            hw = tuple(int(c * s) if isinstance(c, float) else int(c)
                       for c, s in zip(self.crop, self.size))
        else:
            hw = self.size
        channels = 1 if self.color_space in ("GRAY", "L") else (
            4 if self.color_space == "RGBA" else 3)
        return (int(hw[0]), int(hw[1]), channels)

    def _load_one(self, key):
        arr = self.get_image_data(key)
        arr = scale_image(arr, self.size, self.scale_maintain_aspect_ratio,
                          self.background_color)
        if self.crop:
            arr = crop_image(arr, self.crop, self.crop_offset,
                             prng.get(self.prng_key))
        return arr

    def load_data(self):
        keys = getattr(self, "_prescanned_keys_", None) \
            or [self.get_keys(klass) for klass in (TEST, VALID, TRAIN)]
        self._prescanned_keys_ = None
        self.class_keys = keys
        total = sum(len(k) for k in keys)
        if not total:
            raise ValueError("%s found no images" % self.name)
        shape = self.sample_shape
        data = numpy.zeros((total,) + shape, numpy.float32)
        labels = []
        row = 0
        for klass in (TEST, VALID, TRAIN):
            for key in keys[klass]:
                arr = self._load_one(key)
                if arr.shape != shape:
                    raise ValueError("image %s decoded to %s, expected %s"
                                     % (key, arr.shape, shape))
                data[row] = arr
                labels.append(self.get_image_label(key))
                row += 1
        self._provided_data = data
        has_labels = any(l is not None for l in labels)
        self._provided_labels = labels if has_labels else None
        self._provided_lengths = [len(k) for k in keys]
        super().load_data()

class ImageLoaderMSEMixin:
    """Target-IMAGE regression tier (reference ``loader/image_mse.py:47-158``
    ImageLoaderMSEMixin): each sample's MSE target is itself an image.

    Target matching follows the reference contract:

    - labeled datasets: every target key carries a unique label
      (``get_image_label``); a sample's target is the target image with
      the SAME label (reference ``target_label_map``);
    - unlabeled datasets: the i-th sample (over TEST+VALID+TRAIN, serving
      order) maps to the i-th sorted target key — counts must match.

    Targets are decoded through the same scale/crop pipeline as the
    samples, so ``targets_shape`` equals the sample shape. Design note:
    the reference gathered target rows per minibatch on the host; here
    the per-sample target matrix is materialized once and rides the
    device-resident full-batch gather (labels sharing a target duplicate
    its rows).

    Host classes provide :meth:`get_target_keys` and the usual image
    source contract.
    """

    def get_target_keys(self):
        raise NotImplementedError

    def load_data(self):
        tkeys = sorted(self.get_target_keys())
        if len(set(tkeys)) < len(tkeys):
            raise ValueError("%s: duplicate target keys" % self.name)
        if not tkeys:
            raise ValueError("%s: no target images found" % self.name)
        targets = numpy.stack([self._load_one(k) for k in tkeys])
        tlabels = [self.get_image_label(k) for k in tkeys]
        has_tlabels = any(l is not None for l in tlabels)
        # scan ONCE and stash: FullBatchImageLoader.load_data reuses this
        # list, so the target rows stay aligned with the exact sample
        # serving order (a second walk could see filesystem changes)
        self._prescanned_keys_ = [self.get_keys(klass)
                                  for klass in (TEST, VALID, TRAIN)]
        sample_keys = [k for klass_keys in self._prescanned_keys_
                       for k in klass_keys]
        sample_labels = [self.get_image_label(k) for k in sample_keys]
        if any(l is not None for l in sample_labels) and has_tlabels:
            if len(set(tlabels)) < len(tlabels):
                raise ValueError("%s: targets have duplicate labels"
                                 % self.name)
            label_row = {l: i for i, l in enumerate(tlabels)}
            try:
                rows = [label_row[l] for l in sample_labels]
            except KeyError as e:
                raise ValueError("%s: no target image labeled %r"
                                 % (self.name, e.args[0])) from None
        else:
            if len(tkeys) != len(sample_keys):
                raise ValueError(
                    "%s: unlabeled MSE needs one target per sample "
                    "(%d targets, %d samples)"
                    % (self.name, len(tkeys), len(sample_keys)))
            rows = list(range(len(sample_keys)))
        self._provided_targets = targets[rows]
        self.targets_shape = targets.shape[1:]
        super().load_data()


@register_loader("file_image")
class FileImageLoader(FileFilter, FileScannerMixin, FullBatchImageLoader):
    """Images from recursive directory scans with MIME filtering
    (reference ``FileImageLoader``, ``file_image.py:53-177``). Subclasses
    define :meth:`get_label_from_filename`."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("file_type", "image")
        kwargs.setdefault("file_subtypes", ["png", "jpeg", "bmp"])
        FileFilter.__init__(
            self, **{k: kwargs.pop(k) for k in
                     ("ignored_files", "included_files", "file_type",
                      "file_subtypes") if k in kwargs})
        FileScannerMixin.__init__(
            self, **{k: kwargs.pop(k) for k in
                     ("test_paths", "validation_paths", "train_paths")
                     if k in kwargs})
        FullBatchImageLoader.__init__(self, workflow, **kwargs)

    def get_keys(self, klass):
        paths = (self.test_paths, self.validation_paths,
                 self.train_paths)[klass]
        return self.collect_keys(paths)

    def get_image_label(self, key):
        return self.get_label_from_filename(key)


@register_loader("auto_label_file_image")
class AutoLabelFileImageLoader(AutoLabelMixin, FileImageLoader):
    """Directory-scanned images labeled by path regexp, default = parent
    directory name (reference ``FullBatchAutoLabelFileImageLoader``,
    ``fullbatch_image.py:238-245``)."""

    def __init__(self, workflow, **kwargs):
        AutoLabelMixin.__init__(
            self, **{k: kwargs.pop(k) for k in ("label_regexp",)
                     if k in kwargs})
        FileImageLoader.__init__(self, workflow, **kwargs)


class FullBatchImageLoaderMSE(ImageLoaderMSEMixin, FullBatchImageLoader,
                              FullBatchLoaderMSE):
    """Device-resident image dataset with image targets (reference
    ``ImageLoaderMSE``, ``image_mse.py:119-124``). Subclasses provide the
    image source contract plus :meth:`get_target_keys`."""

    hide_from_registry = True


@register_loader("file_image_mse")
class FileImageLoaderMSE(FileFilter, FileScannerMixin,
                         FullBatchImageLoaderMSE):
    """Directory-scanned images with directory-scanned image targets
    (reference ``FileImageLoaderMSE``, ``image_mse.py:126-158``):
    ``target_paths`` roots are scanned with the same MIME filter."""

    def __init__(self, workflow, **kwargs):
        self.target_paths = kwargs.pop("target_paths")
        FileScannerMixin._check_paths(self.target_paths)
        kwargs.setdefault("file_type", "image")
        kwargs.setdefault("file_subtypes", ["png", "jpeg", "bmp"])
        FileFilter.__init__(
            self, **{k: kwargs.pop(k) for k in
                     ("ignored_files", "included_files", "file_type",
                      "file_subtypes") if k in kwargs})
        FileScannerMixin.__init__(
            self, **{k: kwargs.pop(k) for k in
                     ("test_paths", "validation_paths", "train_paths")
                     if k in kwargs})
        FullBatchImageLoaderMSE.__init__(self, workflow, **kwargs)

    def get_keys(self, klass):
        paths = (self.test_paths, self.validation_paths,
                 self.train_paths)[klass]
        return self.collect_keys(paths)

    def get_target_keys(self):
        return self.collect_keys(self.target_paths)

    def get_image_label(self, key):
        try:
            return self.get_label_from_filename(key)
        except NotImplementedError:
            # autoencoder-style unlabeled MSE: i-th sample <-> i-th target
            return None


@register_loader("file_list_image")
class FileListImageLoader(FileListScannerMixin, FullBatchImageLoader):
    """Images enumerated by index files (text ``path label`` lines or a
    JSON map; reference ``FileListImageLoader``, ``file_image.py:53`` +
    ``file_loader.py:150-203``)."""

    def __init__(self, workflow, **kwargs):
        FileListScannerMixin.__init__(
            self, **{k: kwargs.pop(k) for k in
                     ("path_to_test_text_file", "path_to_val_text_file",
                      "path_to_train_text_file", "base_directory")
                     if k in kwargs})
        FullBatchImageLoader.__init__(self, workflow, **kwargs)

    def get_keys(self, klass):
        index = (self.path_to_test_text_file, self.path_to_val_text_file,
                 self.path_to_train_text_file)[klass]
        if not index:
            return []
        return self.scan_files(index)

    def get_image_label(self, key):
        return self.get_label_from_filename(key)
