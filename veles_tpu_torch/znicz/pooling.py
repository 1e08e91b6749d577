"""Pooling layer units (the JAX package's ``znicz.pooling``): max,
max-absolute and average pooling over NHWC inputs with kernel
``ky``×``kx`` and ``sliding`` stride.

The window count is in ceil mode (znicz pooled the ragged tail too).
The tail is padded EXPLICITLY — with −inf for max, +inf for min, 0 for
the average's sums — and the pool itself runs with no padding, so the
last window is the JAX package's and not PyTorch's own ``ceil_mode``
rule.  The pool runs on the NCHW view of the NHWC tensor (channels-last
strides, no copy).  The average divides by the count of real elements
in each window.

Max pooling routes a tied window's gradient to ONE element, as the JAX
package's reduce-window max does; ``tests/test_torch_conv.py`` pins
which one.  ``StochasticPooling`` is not yet ported (ROADMAP A4).
"""

import numpy
import torch
import torch.nn.functional as F

from .nn_units import ForwardBase
from .conv import _norm_padding, _norm_sliding, nchw, nhwc


class Pooling(ForwardBase):
    """Common geometry for pooling units."""

    hide_from_registry = True
    HAS_PARAMS = False

    def __init__(self, workflow, **kwargs):
        super(Pooling, self).__init__(workflow, **kwargs)
        self.kx = kwargs["kx"]
        self.ky = kwargs.get("ky", self.kx)
        self.sliding = _norm_sliding(kwargs.get("sliding", (self.kx,
                                                            self.ky)))
        self.padding = _norm_padding(kwargs.get("padding"))
        self.include_bias = False

    @property
    def trainables(self):
        return {}

    def output_spatial(self, in_h, in_w):
        (pt, pb), (pl, pr) = self.padding
        sh, sw = self.sliding
        out_h = -(-(in_h + pt + pb - self.ky) // sh) + 1
        out_w = -(-(in_w + pl + pr - self.kx) // sw) + 1
        return out_h, out_w

    def _window_padding(self, in_h, in_w):
        """((top, bottom), (left, right)) padding that covers the ragged
        tail (``Pooling._window_padding``)."""
        (pt, pb), (pl, pr) = self.padding
        sh, sw = self.sliding
        out_h, out_w = self.output_spatial(in_h, in_w)
        need_h = (out_h - 1) * sh + self.ky - (in_h + pt)
        need_w = (out_w - 1) * sw + self.kx - (in_w + pl)
        return (pt, max(pb, need_h)), (pl, max(pr, need_w))

    def _padded(self, x, value):
        """x (NHWC) padded by :meth:`_window_padding` with ``value``."""
        (pt, pb), (pl, pr) = self._window_padding(x.shape[1], x.shape[2])
        if not (pt or pb or pl or pr):
            return x
        return F.pad(x, (0, 0, pl, pr, pt, pb), value=value)

    def _max(self, x):
        """Windowed max over the −inf-padded NHWC tensor."""
        return nhwc(F.max_pool2d(nchw(self._padded(x, -float("inf"))),
                                 (self.ky, self.kx), self.sliding))

    def initialize(self, device=None, **kwargs):
        super(Pooling, self).initialize(device=device, **kwargs)
        batch, in_h, in_w, ch = self.input.shape
        out_h, out_w = self.output_spatial(in_h, in_w)
        self.output.mem = numpy.zeros((batch, out_h, out_w, ch),
                                      dtype=numpy.float32)
        self.output.initialize(self.device)


class MaxPooling(Pooling):
    """Max over each window (znicz ``MaxPooling``); ``MaxAbsPooling``
    keeps the signed value of the max-|x| element."""

    MAPPING = "max_pooling"
    ABS = False

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)  # pooling keeps the activation dtype
        hi = self._max(x)
        if self.ABS:
            lo = -self._max(-x)   # min over the +inf-padded tensor
            hi = torch.where(-lo > hi, lo, hi)
        write(self.output, hi)


class MaxAbsPooling(MaxPooling):
    MAPPING = "maxabs_pooling"
    ABS = True


class AvgPooling(Pooling):
    """Mean over each window (znicz ``AvgPooling``), summed in float32
    and divided by the window's count of real elements."""

    MAPPING = "avg_pooling"

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)
        window = (self.ky, self.kx)

        def window_sum(v):
            return nhwc(F.avg_pool2d(nchw(self._padded(v, 0.0)), window,
                                     self.sliding, divisor_override=1))

        ssum = window_sum(x.float())
        count = window_sum(torch.ones_like(x[:1, :, :, :1],
                                           dtype=torch.float32))
        write(self.output, (ssum / count).to(x.dtype))


class StochasticPooling(Pooling):
    """Stochastic pooling (znicz ``StochasticPooling``): not yet
    ported."""

    MAPPING = "stochastic_pooling"

    def __init__(self, workflow, **kwargs):
        raise NotImplementedError(
            "%s is not yet ported (ROADMAP A4)" % type(self).__name__)


class StochasticAbsPooling(StochasticPooling):
    MAPPING = "stochastic_abs_pooling"
