"""Feature normalizers with a name registry.

The port of ``veles_tpu/loader/normalization.py`` (reference
``veles/normalization.py:110-636``): all eight types.

========== =====================================================
name        behavior
========== =====================================================
none        identity
mean_disp   subtract global mean, divide by (max - min)
linear      samplewise rescale of [min, max] to an interval
range_linear like linear but the global range is fixed at init
exp         samplewise softmax
pointwise   per-feature rescale of accumulated [min, max] to [-1, 1]
external_mean subtract a mean sample loaded from a file
internal_mean subtract the accumulated global mean sample
========== =====================================================

A normalizer accumulates statistics over the train split (``analyze``,
on the device of the tensor it is given; numpy arrays are analysed on
the CPU), exposes them as a flat dict (``jit_state``: tensors on that
device and floats) and normalizes a torch batch of any device from that
dict alone (``apply_state``, the fused tick's normalization; ``normalize``
runs it on a host numpy array). ``denormalize`` inverts it (the samplewise
types take the per-sample stats ``normalize_with_stats`` returns), and
``state`` / ``cls(state=...)`` round-trip the accumulated statistics
under the JAX package's attribute names, so ``convert`` can carry a JAX
normalizer's state across.
"""

import pickle

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
            "unknown normalization type %r (have: %s)"
            % (name, ", ".join(sorted(normalizer_registry)))) from None
    return cls(**kwargs)


def state_tensors(state, device):
    """A normalizer state with its arrays as tensors on ``device`` (floats
    stay floats): what ``apply_state`` takes."""
    return {key: (torch.as_tensor(val).to(device)
                  if isinstance(val, (numpy.ndarray, torch.Tensor)) else val)
            for key, val in state.items()}


def _feature_axes(batch):
    return tuple(range(1, batch.ndim))


def _tensor(data, dtype=None):
    """``data`` as a tensor (numpy arrays wrapped on the CPU), optionally
    cast."""
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(numpy.ascontiguousarray(data))
    return data if dtype is None else data.to(dtype)


def _like(result, data):
    """``result`` in the kind of container ``data`` came in: numpy for
    numpy, a tensor for a tensor."""
    if isinstance(data, torch.Tensor):
        return result
    return result.cpu().numpy()


def _per_sample(stat, ndim):
    """A per-sample statistic shaped to broadcast over a batch."""
    return stat.reshape((-1,) + (1,) * (ndim - 1))


class NormalizerBase:
    """Base contract (reference ``normalization.py:124``): ``analyze(data)``
    accumulates statistics over (possibly several) train-set passes;
    ``normalize(data)`` returns the normalized copy; ``denormalize`` inverts
    it. ``state``/``state=`` round-trip everything."""

    MAPPING = None
    #: stateless normalizers need no analyze() before normalize()
    STATELESS = False
    #: False when denormalize() needs per-call stats (samplewise types):
    #: such types cannot be MSE target normalizers (loader/base.py)
    INVERTIBLE_FROM_STATE = True

    def __init__(self, state=None):
        self._initialized = False
        if state is not None:
            if not isinstance(state, dict):
                raise TypeError("state must be a dict")
            self.__dict__.update(
                (key, torch.from_numpy(numpy.array(val))
                 if isinstance(val, numpy.ndarray) else val)
                for key, val in state.items())
            self._initialized = True

    # -- accumulation ---------------------------------------------------------
    def analyze(self, data):
        data = _tensor(data)
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

    def reset(self):
        self._initialized = False

    @property
    def state(self):
        """Everything needed to reconstruct via ``cls(state=...)``: the
        JAX package's attribute names, tensors where it holds arrays."""
        return {k: v for k, v in self.__dict__.items()
                if k != "_initialized" and not callable(v)}

    def analyze_and_normalize(self, data):
        self.analyze(data)
        return self.normalize(data)

    # -- application ----------------------------------------------------------
    def normalize(self, data):
        if not self.is_initialized:
            raise RuntimeError(
                "%s.normalize() before analyze()" % type(self).__name__)
        batch = _tensor(data, torch.float32)
        return _like(self.apply_state(
            batch, state_tensors(self.jit_state(), batch.device)), data)

    def denormalize(self, data, **kwargs):
        raise NotImplementedError

    def jit_state(self):
        """Coefficients as a flat dict of tensors and floats: the
        normalization inputs of the fused tick."""
        return {}

    @classmethod
    def apply_state(cls, batch, state):
        """Normalize the tensor ``batch`` (leading axis = samples) using
        only ``state`` (tensors on the batch's device, or floats)."""
        raise NotImplementedError


@register_normalizer
class NoneNormalizer(NormalizerBase):
    """Identity (reference ``normalization.py:496``)."""

    MAPPING = "none"
    STATELESS = True

    @classmethod
    def apply_state(cls, batch, state):
        return batch

    def denormalize(self, data, **kwargs):
        return data


@register_normalizer
class MeanDispersionNormalizer(NormalizerBase):
    """Subtract the accumulated global mean and divide by (max - min);
    "dispersion" is the range (reference ``normalization.py:284-318``).
    Accumulates in float64."""

    MAPPING = "mean_disp"

    def _initialize(self, data):
        self._sum = torch.zeros_like(data[0], dtype=torch.float64)
        self._count = 0
        self._min = data[0].to(torch.float64)
        self._max = data[0].to(torch.float64)

    def _analyze(self, data):
        self._count += data.shape[0]
        self._sum = self._sum + data.sum(dim=0, dtype=torch.float64)
        self._min = torch.minimum(self._min, data.amin(dim=0).double())
        self._max = torch.maximum(self._max, data.amax(dim=0).double())

    @property
    def coefficients(self):
        mean = (self._sum / self._count).float()
        disp = (self._max - self._min).float()
        disp[disp == 0] = 1.0
        return mean, disp

    def jit_state(self):
        mean, disp = self.coefficients
        return {"mean": mean, "disp": disp}

    @classmethod
    def apply_state(cls, batch, state):
        return (batch - state["mean"]) / state["disp"]

    def denormalize(self, data, **kwargs):
        batch = _tensor(data, torch.float32)
        mean, disp = (t.to(batch.device) for t in self.coefficients)
        return _like(batch * disp + mean, data)


class IntervalMixin:
    """Target-interval validation shared by linear normalizers (reference
    ``normalization.py:322-344``)."""

    def _set_interval(self, value):
        try:
            vmin, vmax = value
        except (TypeError, ValueError):
            raise ValueError("interval must consist of two values") \
                from None
        for v in (vmin, vmax):
            if not isinstance(v, (int, float)):
                raise TypeError("interval bounds must be numbers")
        self.interval = (float(vmin), float(vmax))


@register_normalizer
class LinearNormalizer(IntervalMixin, NormalizerBase):
    """Samplewise rescale: each sample's own [min, max] maps to the target
    interval (reference ``normalization.py:347-395``). Stateless: the
    per-sample (dmin, dmax) needed to invert come from
    :meth:`normalize_with_stats`. Uniform samples land on the interval
    midpoint."""

    MAPPING = "linear"
    STATELESS = True
    INVERTIBLE_FROM_STATE = False

    def __init__(self, state=None, interval=(-1, 1)):
        super().__init__(state)
        if state is None:
            self._set_interval(interval)

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

    def normalize_with_stats(self, data):
        batch = _tensor(data, torch.float32)
        axes = _feature_axes(batch)
        stats = {"dmin": batch.amin(dim=axes), "dmax": batch.amax(dim=axes)}
        out = self.apply_state(batch, self.jit_state())
        return _like(out, data), {k: _like(v, data)
                                  for k, v in stats.items()}

    def denormalize(self, data, **kwargs):
        batch = _tensor(data, torch.float32)
        dmin = _per_sample(_tensor(kwargs["dmin"], torch.float32).to(
            batch.device), batch.ndim)
        dmax = _per_sample(_tensor(kwargs["dmax"], torch.float32).to(
            batch.device), batch.ndim)
        imin, imax = self.interval
        diff = torch.where(dmax == dmin, torch.ones_like(dmax), dmax - dmin)
        out = (batch - imin) * (diff / (imax - imin)) + dmin
        return _like(torch.where(dmax == dmin, dmin.expand_as(out), out),
                     data)


@register_normalizer
class RangeLinearNormalizer(IntervalMixin, NormalizerBase):
    """Like linear but the *global* data range is fixed at first analyze and
    every later analyze must confirm it (reference
    ``normalization.py:398-464``): invertible from state alone."""

    MAPPING = "range_linear"

    def __init__(self, state=None, interval=(-1, 1)):
        super().__init__(state)
        if state is None:
            self._set_interval(interval)

    def _initialize(self, data):
        self._dmin = float(data.min())
        self._dmax = float(data.max())

    def _analyze(self, data):
        dmin, dmax = float(data.min()), float(data.max())
        if dmin != self._dmin or dmax != self._dmax:
            raise ValueError(
                "range_linear requires a stable global [min, max]: got "
                "[%f, %f], expected [%f, %f]" % (
                    dmin, dmax, self._dmin, self._dmax))

    def jit_state(self):
        return {"imin": self.interval[0], "imax": self.interval[1],
                "dmin": self._dmin,
                "diff": (self._dmax - self._dmin) or 1.0}

    @classmethod
    def apply_state(cls, batch, state):
        imin, imax = state["imin"], state["imax"]
        return (batch - state["dmin"]) \
            * ((imax - imin) / state["diff"]) + imin

    def denormalize(self, data, **kwargs):
        imin, imax = self.interval
        diff = (self._dmax - self._dmin) or 1.0
        return _like((_tensor(data, torch.float32) - imin)
                     * (diff / (imax - imin)) + self._dmin, data)


@register_normalizer
class ExponentNormalizer(NormalizerBase):
    """Samplewise softmax: subtract the sample max, exponentiate, divide by
    the sample sum (reference ``normalization.py:467-492``). Stateless; the
    per-sample (dmax, dsum) to invert come from
    :meth:`normalize_with_stats`."""

    MAPPING = "exp"
    STATELESS = True
    INVERTIBLE_FROM_STATE = False

    @classmethod
    def apply_state(cls, batch, state):
        axes = _feature_axes(batch)
        e = torch.exp(batch - batch.amax(dim=axes, keepdim=True))
        return e / e.sum(dim=axes, keepdim=True)

    def normalize_with_stats(self, data):
        batch = _tensor(data, torch.float32)
        axes = _feature_axes(batch)
        dmax = batch.amax(dim=axes)
        e = torch.exp(batch - _per_sample(dmax, batch.ndim))
        dsum = e.sum(dim=axes)
        return (_like(e / _per_sample(dsum, batch.ndim), data),
                {"dmax": _like(dmax, data), "dsum": _like(dsum, data)})

    def denormalize(self, data, **kwargs):
        batch = _tensor(data, torch.float32)
        dmax = _per_sample(_tensor(kwargs["dmax"]).to(batch.device),
                           batch.ndim)
        dsum = _per_sample(_tensor(kwargs["dsum"]).to(batch.device),
                           batch.ndim)
        return _like(torch.log(batch * dsum) + dmax, data)


@register_normalizer
class PointwiseNormalizer(NormalizerBase):
    """Accumulates per-feature [min, max] over analyze passes, then rescales
    each feature to [-1, 1] (reference ``normalization.py:511-562``).
    Constant features normalize to 0 and denormalize back to their constant
    value."""

    MAPPING = "pointwise"

    def _initialize(self, data):
        self._min = data[0].float()
        self._max = data[0].float()

    def _analyze(self, data):
        self._min = torch.minimum(self._min, data.amin(dim=0).float())
        self._max = torch.maximum(self._max, data.amax(dim=0).float())

    @property
    def coefficients(self):
        disp = self._max - self._min
        nz = disp != 0
        mul = torch.zeros_like(disp)
        mul[nz] = 2.0 / disp[nz]
        add = torch.zeros_like(disp)
        add[nz] = -1.0 - self._min[nz] * mul[nz]
        return mul, add

    def jit_state(self):
        mul, add = self.coefficients
        return {"mul": mul, "add": add}

    @classmethod
    def apply_state(cls, batch, state):
        return batch * state["mul"] + state["add"]

    def denormalize(self, data, **kwargs):
        batch = _tensor(data, torch.float32)
        mul, add = (t.to(batch.device) for t in self.coefficients)
        safe_mul = torch.where(mul == 0, torch.ones_like(mul), mul)
        out = (batch - add) / safe_mul
        return _like(torch.where(mul == 0, self._min.to(batch.device), out),
                     data)


class MeanNormalizerBase(NormalizerBase):
    """Mean-subtraction family with an optional scalar scale (reference
    ``normalization.py:566-590``)."""

    def __init__(self, state=None, scale=1):
        super().__init__(state)
        if state is None:
            if not isinstance(scale, (int, float)):
                raise TypeError("scale must be a scalar")
            self.scale = float(scale)

    @property
    def mean(self):
        raise NotImplementedError

    def jit_state(self):
        return {"mean": self.mean, "scale": self.scale}

    @classmethod
    def apply_state(cls, batch, state):
        return (batch - state["mean"]) * state["scale"]

    def denormalize(self, data, **kwargs):
        batch = _tensor(data, torch.float32)
        return _like(batch / self.scale + self.mean.to(batch.device), data)


@register_normalizer
class ExternalMeanNormalizer(MeanNormalizerBase):
    """Subtract a mean sample supplied externally: an image file, ``.npy``,
    a pickle, or an ndarray (reference ``normalization.py:593-633``). PIL
    is imported only to try an image file."""

    MAPPING = "external_mean"
    STATELESS = True

    def __init__(self, state=None, mean_source=None, scale=1):
        super().__init__(state, scale)
        if state is not None:
            return
        if mean_source is None:
            raise ValueError("external_mean requires mean_source=")
        self._mean = torch.from_numpy(self._load_mean(mean_source))

    @staticmethod
    def _load_mean(source):
        if isinstance(source, numpy.ndarray):
            return source.astype(numpy.float32)
        for attempt in ("image", "npy", "pickle"):
            try:
                if attempt == "image":
                    from PIL import Image
                    with open(source, "rb") as fin:
                        return numpy.array(Image.open(fin),
                                           dtype=numpy.float32)
                if attempt == "npy":
                    return numpy.load(source).astype(numpy.float32)
                with open(source, "rb") as fin:
                    loaded = pickle.load(fin)
                return numpy.asarray(loaded, numpy.float32)
            except Exception:
                continue
        raise ValueError("unable to load mean from %r" % (source,))

    @property
    def mean(self):
        return self._mean


@register_normalizer
class InternalMeanNormalizer(MeanNormalizerBase):
    """Subtract the mean sample accumulated over analyze passes (reference
    ``normalization.py:636-662``)."""

    MAPPING = "internal_mean"

    def _initialize(self, data):
        self._sum = torch.zeros_like(data[0], dtype=torch.float64)
        self._count = 0

    def _analyze(self, data):
        self._count += data.shape[0]
        self._sum = self._sum + data.sum(dim=0, dtype=torch.float64)

    @property
    def mean(self):
        return (self._sum / self._count).float()
