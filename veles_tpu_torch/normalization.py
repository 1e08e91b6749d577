"""Data normalization registry (the JAX package's ``normalization``).

Stateful host-side normalizers with the contract

    analyze(data)      — accumulate dataset statistics (callable
                         repeatedly over slabs — streaming-friendly);
    normalize(data)    — transform → returns the array;
    denormalize(data)  — inverse transform;
    state is picklable.

Loaders construct them by registry string (``normalizer_factory``).
They run on the host, in numpy, so the same data gives the JAX
package's bytes; the device-side normalizer of byte pipelines is
``veles_tpu_torch.mean_disp_normalizer``.  Their consumers are the image
loaders (``loader/image.py``).
"""

import numpy

from .registry import MappedObjectRegistry


class NormalizerRegistry(MappedObjectRegistry):
    """String → normalizer class."""
    registry = {}


def normalizer_factory(name, **kwargs):
    return NormalizerRegistry.get_factory(name)(**kwargs)


class NormalizerBase(object, metaclass=NormalizerRegistry):
    """Common machinery; subclasses fill _analyze/_apply/_invert."""

    def __init__(self, **kwargs):
        self.state = {}

    @property
    def is_analyzed(self):
        return bool(self.state)

    def analyze(self, data):
        self._analyze(numpy.asarray(data))

    def normalize(self, data):
        data = numpy.asarray(data, dtype=numpy.float32)
        if not self.is_analyzed:
            self.analyze(data)
        return self._apply(data)

    def denormalize(self, data):
        data = numpy.asarray(data, dtype=numpy.float32)
        return self._invert(data)

    # -- hooks --------------------------------------------------------------

    def _analyze(self, data):
        self.state["analyzed"] = True

    def _apply(self, data):
        raise NotImplementedError()

    def _invert(self, data):
        raise NotImplementedError()

    def __getstate__(self):
        return self.__dict__

    def __setstate__(self, state):
        self.__dict__.update(state)


class NoneNormalizer(NormalizerBase):
    """Identity ("none")."""
    MAPPING = "none"

    def _apply(self, data):
        return data

    def _invert(self, data):
        return data


class LinearNormalizer(NormalizerBase):
    """Linear map of the observed [min, max] onto [-1, 1]
    ("linear")."""
    MAPPING = "linear"

    def _analyze(self, data):
        mn = float(data.min())
        mx = float(data.max())
        if "min" in self.state:
            mn = min(mn, self.state["min"])
            mx = max(mx, self.state["max"])
        self.state["min"] = mn
        self.state["max"] = mx

    def _scale(self):
        spread = self.state["max"] - self.state["min"]
        return (spread / 2.0) or 1.0

    def _apply(self, data):
        mid = (self.state["max"] + self.state["min"]) / 2.0
        return (data - mid) / self._scale()

    def _invert(self, data):
        mid = (self.state["max"] + self.state["min"]) / 2.0
        return data * self._scale() + mid


class RangeLinearNormalizer(NormalizerBase):
    """Linear map of a given source interval onto a target interval
    ("range_linear"; e.g. bytes 0..255 → [-1, 1])."""
    MAPPING = "range_linear"

    def __init__(self, interval=(0, 255), target=(-1, 1), **kwargs):
        super(RangeLinearNormalizer, self).__init__(**kwargs)
        self.interval = tuple(interval)
        self.target = tuple(target)

    def _analyze(self, data):
        self.state["analyzed"] = True

    def _apply(self, data):
        a, b = self.interval
        c, d = self.target
        return (data - a) * ((d - c) / float(b - a)) + c

    def _invert(self, data):
        a, b = self.interval
        c, d = self.target
        return (data - c) * ((b - a) / float(d - c)) + a


class MeanDispersionNormalizer(NormalizerBase):
    """(x − mean) / (max − min) with per-feature statistics
    accumulated in streaming fashion ("mean_disp"; "disp" is the
    max − min spread, not the statistical dispersion)."""
    MAPPING = "mean_disp"

    def _analyze(self, data):
        flat = data.reshape(len(data), -1).astype(numpy.float64)
        s = self.state
        s.setdefault("n", 0)
        s.setdefault("sum", numpy.zeros(flat.shape[1]))
        s["n"] += len(flat)
        s["sum"] += flat.sum(axis=0)
        mn = flat.min(axis=0)
        mx = flat.max(axis=0)
        if "min" in s:
            mn = numpy.minimum(mn, s["min"])
            mx = numpy.maximum(mx, s["max"])
        s["min"] = mn
        s["max"] = mx
        s["shape"] = data.shape[1:]

    def _stats(self):
        s = self.state
        mean = s["sum"] / s["n"]
        disp = s["max"] - s["min"]
        disp[disp == 0] = 1.0
        shape = tuple(s["shape"])
        return (mean.reshape(shape).astype(numpy.float32),
                disp.reshape(shape).astype(numpy.float32))

    def _apply(self, data):
        mean, disp = self._stats()
        return (data - mean) / disp

    def _invert(self, data):
        mean, disp = self._stats()
        return data * disp + mean


class ExternalMeanNormalizer(NormalizerBase):
    """Subtracts a caller-provided mean array ("external_mean" — e.g.
    the ImageNet mean image file)."""
    MAPPING = "external_mean"

    def __init__(self, mean_source=None, **kwargs):
        super(ExternalMeanNormalizer, self).__init__(**kwargs)
        if mean_source is None:
            raise ValueError("external_mean requires mean_source")
        if isinstance(mean_source, str):
            mean_source = numpy.load(mean_source)
        self.mean = numpy.asarray(mean_source, dtype=numpy.float32)

    def _analyze(self, data):
        self.state["analyzed"] = True

    def _apply(self, data):
        return data - self.mean

    def _invert(self, data):
        return data + self.mean


class PointwiseNormalizer(NormalizerBase):
    """Per-feature linear map of observed per-feature [min,max] onto
    [-1, 1] ("pointwise")."""
    MAPPING = "pointwise"

    def _analyze(self, data):
        flat = data.reshape(len(data), -1)
        mn = flat.min(axis=0).astype(numpy.float64)
        mx = flat.max(axis=0).astype(numpy.float64)
        if "min" in self.state:
            mn = numpy.minimum(mn, self.state["min"])
            mx = numpy.maximum(mx, self.state["max"])
        self.state["min"] = mn
        self.state["max"] = mx
        self.state["shape"] = data.shape[1:]

    def _maps(self):
        s = self.state
        shape = tuple(s["shape"])
        mid = ((s["max"] + s["min"]) / 2.0).reshape(shape)
        half = ((s["max"] - s["min"]) / 2.0).reshape(shape)
        half[half == 0] = 1.0
        return (mid.astype(numpy.float32), half.astype(numpy.float32))

    def _apply(self, data):
        mid, half = self._maps()
        return (data - mid) / half

    def _invert(self, data):
        mid, half = self._maps()
        return data * half + mid
