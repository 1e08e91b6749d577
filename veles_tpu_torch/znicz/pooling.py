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
which one.

Stochastic pooling (non-overlapping windows) picks one element of each
window with probability ∝ its activation in training — the Gumbel-max
trick, with the noise drawn from the step's seeded ``torch.Generator``
as dropout draws its mask, so not threefry's numbers — and outputs
the probability-weighted mean in inference.
"""

import numpy
import torch
import torch.nn.functional as F

from ..accelerated_units import select_by_training
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
    """Stochastic pooling (znicz ``StochasticPooling``): training picks
    one window element with probability ∝ its (non-negative)
    activation; inference outputs the probability-weighted mean.  Only
    non-overlapping windows (sliding == kernel) and no padding, as in
    the JAX package; the ragged tail is padded with zeros, and an
    all-zero window picks uniformly.  The output is float32."""

    MAPPING = "stochastic_pooling"
    ABS = False

    def __init__(self, workflow, **kwargs):
        super(StochasticPooling, self).__init__(workflow, **kwargs)
        if self.sliding != (self.ky, self.kx):
            raise ValueError(
                "%s supports only sliding == kernel" % self)
        if self.padding != ((0, 0), (0, 0)):
            raise ValueError("%s does not support padding" % self)

    def _patches(self, x):
        """(B, OH, OW, ky·kx, C) windows of an NHWC tensor, the ragged
        tail padded with zeros."""
        b, h, w, c = x.shape
        oh = -(-h // self.ky)
        ow = -(-w // self.kx)
        x = F.pad(x, (0, 0, 0, ow * self.kx - w, 0, oh * self.ky - h))
        x = x.reshape(b, oh, self.ky, ow, self.kx, c)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, oh, ow, self.ky * self.kx, c)

    def draw_gumbel(self, ctx, shape, device):
        """Standard Gumbel noise of ``shape`` from the step's generator:
        −log(−log(u)), u uniform in [tiny, 1) (the draw of
        ``jax.random.gumbel``)."""
        u = torch.rand(shape, generator=ctx.next_key(), device=device)
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(torch.clamp_min(u, tiny)))

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input).float()
        # The derivatives at 0 are jnp.abs's (+1, where torch.abs has
        # 0) and jnp.maximum's (a tie splits the gradient).
        p = self._patches(torch.where(x >= 0, x, -x) if self.ABS else x)
        v = self._patches(x)
        w = torch.maximum(p, torch.zeros_like(p))
        tot = w.sum(dim=3, keepdim=True)
        k = w.shape[3]
        probs = torch.where(tot > 0, w / torch.clamp_min(tot, 1e-30),
                            torch.full_like(w, 1.0 / k))

        def train_branch():
            g = self.draw_gumbel(ctx, probs.shape, probs.device)
            pick = torch.argmax(torch.log(probs + 1e-30) + g, dim=3)
            return torch.gather(v, 3, pick[:, :, :, None, :])[:, :, :, 0]

        def eval_branch():
            return (probs * v).sum(dim=3)

        write(self.output, select_by_training(ctx, train_branch,
                                              eval_branch))


class StochasticAbsPooling(StochasticPooling):
    """Stochastic pooling over |x| that outputs the picked element's
    signed value."""

    MAPPING = "stochastic_abs_pooling"
    ABS = True
