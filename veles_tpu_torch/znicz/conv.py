"""Convolutional layer units (the JAX package's ``znicz.conv``).

A Conv layer slides ``n_kernels`` filters of ``ky``×``kx`` over an NHWC
input with ``sliding`` stride and ``padding``, then applies the
activation.  The unit's boundary stays the JAX package's: activations
NHWC, weights HWIO (so carried-over weights are the same arrays).
Inside, the input is viewed as NCHW with channels-last strides (no
copy) and the weights are permuted to OIHW for ``F.conv2d``, whose
output comes back as an NHWC view.  The JAX package computes this conv
with ``lax.conv_general_dilated``, outside any Pallas kernel.

Operands, bias and activation are in the compute dtype (bfloat16 at
``precision_level`` 0), as in the JAX package: the conv's output is
rounded to it, the bias added in it, the activation applied in it.
TF32 stays off (``backends.resolve_device``), so a float32 conv on the
card is a float32 conv.

Geometry ergonomics follow the znicz units: ``padding`` is an int, an
(x, y) pair or a 4-tuple (left, top, right, bottom); ``sliding`` an
(x, y) pair.  Weight init: normal with stddev ``weights_stddev``
(default 1/sqrt(kx·ky·channels)).

Not yet ported (ROADMAP A4): ``space_to_depth`` (an MXU layout lever of
the TPU) and the tied transposed convolution ``Deconv``; both raise.
"""

import numpy
import torch
import torch.nn.functional as F

from . import nn_units
from .nn_units import ForwardBase


def _norm_padding(padding):
    """→ ((top, bottom), (left, right))."""
    if padding is None:
        return ((0, 0), (0, 0))
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    padding = tuple(padding)
    if len(padding) == 2:
        px, py = padding
        return ((py, py), (px, px))
    if len(padding) == 4:
        left, top, right, bottom = padding
        return ((top, bottom), (left, right))
    raise ValueError("bad padding %r" % (padding,))


def _norm_sliding(sliding):
    if sliding is None:
        return (1, 1)
    if isinstance(sliding, int):
        return (sliding, sliding)
    sx, sy = tuple(sliding)
    return (sy, sx)  # row-major (y, x) strides for NHWC


def nchw(x):
    """The NCHW view of an NHWC tensor (channels-last strides, no
    copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    """The NHWC view of an NCHW tensor."""
    return x.permute(0, 2, 3, 1)


def conv2d_nhwc(x, w, sliding, padding):
    """NHWC input, HWIO weights → NHWC output; ``padding`` is
    ((top, bottom), (left, right)), asymmetric padding taken by an
    explicit zero pad."""
    (pt, pb), (pl, pr) = padding
    if pt != pb or pl != pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        pt = pl = 0
    weight = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return nhwc(F.conv2d(nchw(x), weight, stride=sliding,
                         padding=(pt, pl)))


class Conv(ForwardBase):
    """2-D convolution, identity activation (znicz ``Conv``)."""

    MAPPING = "conv"

    def __init__(self, workflow, **kwargs):
        super(Conv, self).__init__(workflow, **kwargs)
        self.n_kernels = kwargs["n_kernels"]
        self.kx = kwargs["kx"]
        self.ky = kwargs.get("ky", self.kx)
        self.padding = _norm_padding(kwargs.get("padding"))
        self.sliding = _norm_sliding(kwargs.get("sliding"))
        if kwargs.get("space_to_depth"):
            raise NotImplementedError(
                "Conv(space_to_depth=...) is not yet ported (ROADMAP A4)")

    def output_spatial(self, in_h, in_w):
        (pt, pb), (pl, pr) = self.padding
        sh, sw = self.sliding
        out_h = (in_h + pt + pb - self.ky) // sh + 1
        out_w = (in_w + pl + pr - self.kx) // sw + 1
        return out_h, out_w

    def initialize(self, device=None, **kwargs):
        super(Conv, self).initialize(device=device, **kwargs)
        batch, in_h, in_w, in_ch = self.input.shape
        fan_in = self.kx * self.ky * in_ch
        if not self.weights:
            stddev = self.weights_stddev or (1.0 / numpy.sqrt(fan_in))
            w = numpy.zeros((self.ky, self.kx, in_ch, self.n_kernels),
                            dtype=numpy.float32)
            self.rand().fill_normal(w, stddev=stddev)
            self.weights.mem = w
            self.weights.initialize(self.device)
        if self.include_bias and not self.bias:
            b = numpy.zeros(self.n_kernels, dtype=numpy.float32)
            if self.bias_stddev:
                self.rand().fill_normal(b, stddev=self.bias_stddev)
            self.bias.mem = b
            self.bias.initialize(self.device)
        out_h, out_w = self.output_spatial(in_h, in_w)
        self.output.mem = numpy.zeros(
            (batch, out_h, out_w, self.n_kernels), dtype=numpy.float32)
        self.output.initialize(self.device)

    def activation(self, v):
        return v

    def tforward(self, read, write, params, ctx, state=None):
        cdt = self.compute_dtype
        y = conv2d_nhwc(read(self.input).to(cdt),
                        params["weights"].to(cdt), self.sliding,
                        self.padding)
        if self.include_bias:
            y = y + params["bias"].to(cdt)
        write(self.output, self.activation(y))


class ConvTanh(Conv):
    """Scaled tanh (znicz 1.7159·tanh(0.6666·x))."""

    MAPPING = "conv_tanh"

    def activation(self, v):
        return nn_units.act_tanh(v)


class ConvRelu(Conv):
    """Softplus log(1+e^x) — znicz's smooth "RELU" conv."""

    MAPPING = "conv_relu"

    def activation(self, v):
        return nn_units.act_softplus(v)


class ConvStrictRelu(Conv):
    """max(0, x) (znicz ``ConvStrictRELU``) — the AlexNet activation."""

    MAPPING = "conv_str"

    def activation(self, v):
        return nn_units.act_strict_relu(v)


class ConvSigmoid(Conv):
    MAPPING = "conv_sigmoid"

    def activation(self, v):
        return nn_units.act_sigmoid(v)


class Deconv(ForwardBase):
    """Transposed convolution with weights tied to a forward Conv
    (znicz ``Deconv``): not yet ported."""

    MAPPING = "deconv"
    HAS_PARAMS = False

    def __init__(self, workflow, **kwargs):
        raise NotImplementedError("Deconv is not yet ported (ROADMAP A4)")
