"""Feature normalizers with a name registry.

The port of ``veles_tpu/loader/normalization.py`` (reference
``veles/normalization.py:110-636``) for the types the training path
uses: ``none``, ``linear`` and ``mean_disp``. A normalizer accumulates
statistics over the train split in numpy (``analyze``), exposes them as
a flat dict (``jit_state``) and normalizes a torch batch of any device
from that dict alone (``apply_state``, the fused tick's normalization;
``normalize`` runs it on a host numpy array).
"""

import numpy
import torch

#: MAPPING name -> class (reference NormalizerRegistry.normalizers).
normalizer_registry = {}


def register_normalizer(cls):
    normalizer_registry[cls.MAPPING] = cls
    return cls


def make_normalizer(name, **kwargs):
    """Instantiate a registered normalizer by MAPPING name."""
    try:
        cls = normalizer_registry[name]
    except KeyError:
        raise ValueError(
            "unknown normalization type %r (have: %s; the other types of "
            "the JAX package are a later slice of the port)"
            % (name, ", ".join(sorted(normalizer_registry)))) from None
    return cls(**kwargs)


def state_tensors(state, device):
    """A normalizer state with its arrays as tensors on ``device`` (floats
    stay floats): what ``apply_state`` takes."""
    return {key: (torch.from_numpy(val).to(device)
                  if isinstance(val, numpy.ndarray) else val)
            for key, val in state.items()}


def _feature_axes(batch):
    return tuple(range(1, batch.ndim))


class NormalizerBase:
    """Base contract (reference ``normalization.py:124``): ``analyze(data)``
    accumulates statistics; ``normalize(data)`` returns the normalized
    copy."""

    MAPPING = None
    #: stateless normalizers need no analyze() before normalize()
    STATELESS = False

    def __init__(self):
        self._initialized = False

    def analyze(self, data):
        data = numpy.asarray(data)
        if not self._initialized:
            self._initialize(data)
            self._initialized = True
        self._analyze(data)

    def _initialize(self, data):
        pass

    def _analyze(self, data):
        pass

    @property
    def is_initialized(self):
        return self._initialized or self.STATELESS

    def normalize(self, data):
        if not self.is_initialized:
            raise RuntimeError(
                "%s.normalize() before analyze()" % type(self).__name__)
        batch = torch.from_numpy(numpy.asarray(data, numpy.float32))
        return self.apply_state(batch, state_tensors(
            self.jit_state(), batch.device)).numpy()

    def jit_state(self):
        """Coefficients as a flat dict of numpy arrays and floats — the
        normalization inputs of the fused tick."""
        return {}

    @classmethod
    def apply_state(cls, batch, state):
        """Normalize the tensor ``batch`` (leading axis = samples) using
        only ``state`` (tensors or floats)."""
        raise NotImplementedError


@register_normalizer
class NoneNormalizer(NormalizerBase):
    """Identity (reference ``normalization.py:496``)."""

    MAPPING = "none"
    STATELESS = True

    @classmethod
    def apply_state(cls, batch, state):
        return batch


@register_normalizer
class MeanDispersionNormalizer(NormalizerBase):
    """Subtract the accumulated global mean and divide by (max - min);
    "dispersion" is the range (reference ``normalization.py:284-318``).
    Accumulates in float64."""

    MAPPING = "mean_disp"

    def _initialize(self, data):
        self._sum = numpy.zeros_like(data[0], dtype=numpy.float64)
        self._count = 0
        self._min = numpy.array(data[0], dtype=numpy.float64)
        self._max = numpy.array(data[0], dtype=numpy.float64)

    def _analyze(self, data):
        self._count += data.shape[0]
        self._sum += numpy.sum(data, axis=0, dtype=numpy.float64)
        numpy.minimum(self._min, numpy.min(data, axis=0), self._min)
        numpy.maximum(self._max, numpy.max(data, axis=0), self._max)

    def jit_state(self):
        mean = (self._sum / self._count).astype(numpy.float32)
        disp = (self._max - self._min).astype(numpy.float32)
        disp[disp == 0] = 1.0
        return {"mean": mean, "disp": disp}

    @classmethod
    def apply_state(cls, batch, state):
        return (batch - state["mean"]) / state["disp"]


@register_normalizer
class LinearNormalizer(NormalizerBase):
    """Samplewise rescale: each sample's own [min, max] maps to the target
    interval (reference ``normalization.py:347-395``). Uniform samples land
    on the interval midpoint."""

    MAPPING = "linear"
    STATELESS = True

    def __init__(self, interval=(-1, 1)):
        super().__init__()
        try:
            vmin, vmax = interval
        except (TypeError, ValueError):
            raise ValueError("interval must consist of two values") \
                from None
        for v in (vmin, vmax):
            if not isinstance(v, (int, float)):
                raise TypeError("interval bounds must be numbers")
        self.interval = (float(vmin), float(vmax))

    def jit_state(self):
        return {"imin": self.interval[0], "imax": self.interval[1]}

    @classmethod
    def apply_state(cls, batch, state):
        axes = _feature_axes(batch)
        dmin = batch.amin(dim=axes, keepdim=True)
        dmax = batch.amax(dim=axes, keepdim=True)
        imin, imax = state["imin"], state["imax"]
        diff = torch.where(dmax == dmin, torch.ones_like(dmax), dmax - dmin)
        scaled = (batch - dmin) * ((imax - imin) / diff) + imin
        return torch.where(dmax == dmin,
                           torch.full_like(batch, (imin + imax) / 2), scaled)
