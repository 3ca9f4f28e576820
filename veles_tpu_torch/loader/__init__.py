"""Minibatch servers: the loader base, the device-resident full-batch
loader and its regression variant, the normalizers, and the file loaders
(idx, pickles, scanned files, sound, images, recorded minibatch
streams)."""

from veles_tpu_torch.loader.base import (  # noqa: F401
    CLASS_NAMES, Loader, LoaderMSEMixin, TEST, TRAIN, VALID,
    loader_registry, register_loader)
from veles_tpu_torch.loader.fullbatch import (  # noqa: F401
    FullBatchLoader, FullBatchLoaderMSE)
from veles_tpu_torch.loader.normalization import (  # noqa: F401
    make_normalizer, normalizer_registry)
from veles_tpu_torch.loader.image import (  # noqa: F401
    AutoLabelFileImageLoader, FileImageLoader, FileImageLoaderMSE,
    FileListImageLoader, FullBatchImageLoader, FullBatchImageLoaderMSE)
