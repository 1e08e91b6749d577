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

``space_to_depth=f`` is accepted with the JAX package's checks (f must
equal both strides; the fold must tile the input) and computes the
strided convolution it equals.  In the JAX package the fold is an MXU
layout lever of the TPU — conv1 becomes a stride-1 conv over C·f²
channels, so few input channels stop wasting the 128-lane contraction.
cuDNN picks its own layout for a strided conv over three channels, so
the rearrangement is not carried over: its math is the strided conv's.

``Deconv`` is the transposed convolution with weights tied to a forward
conv (``get_weights_from``): ``F.conv_transpose2d`` with no padding,
cropped by the conv's (top, left) padding to the conv input's
geometry, with zeros for the trailing rows and columns no window
reached — the conv's input gradient, as the JAX package computes it by
``jax.vjp``.
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
    explicit zero pad.  The weights go to the convolution channels-last,
    except under a ``torch.func`` transform (the population step), which
    cannot lay a mapped tensor out by memory format: there the
    convolution takes the permuted view."""
    (pt, pb), (pl, pr) = padding
    if pt != pb or pl != pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        pt = pl = 0
    weight = w.permute(3, 2, 0, 1)
    if not torch._C._functorch.is_functorch_wrapped_tensor(weight):
        weight = weight.contiguous(memory_format=torch.channels_last)
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
        self.space_to_depth = int(kwargs.get("space_to_depth", 0))
        if self.space_to_depth:
            sh, sw = self.sliding
            if not (self.space_to_depth == sh == sw):
                raise ValueError(
                    "space_to_depth (%d) must equal both strides %r"
                    % (self.space_to_depth, self.sliding))

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

    def check_space_to_depth(self, in_h, in_w):
        """The JAX package's fold must tile the (padded) input: the
        folded stride-1 conv would otherwise emit a ragged-tail window
        the strided conv does not have."""
        f = self.space_to_depth
        (pt, pb), (pl, pr) = self.padding
        h, wd = in_h + pt + pb, in_w + pl + pr
        h2, w2 = -(-h // f), -(-wd // f)
        ky2, kx2 = -(-self.ky // f), -(-self.kx // f)
        if (h2 - ky2 + 1, w2 - kx2 + 1) != \
                ((h - self.ky) // f + 1, (wd - self.kx) // f + 1):
            raise ValueError(
                "space_to_depth=%d does not tile input %dx%d with "
                "kernel %dx%d" % (f, h, wd, self.ky, self.kx))

    def tforward(self, read, write, params, ctx, state=None):
        cdt = self.compute_dtype
        x = read(self.input)
        if self.space_to_depth:
            self.check_space_to_depth(x.shape[1], x.shape[2])
        y = conv2d_nhwc(x.to(cdt), params["weights"].to(cdt),
                        self.sliding, self.padding)
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


def conv2d_input_nhwc(y, w, in_hw, sliding, padding):
    """The transposed convolution: the input gradient of
    :func:`conv2d_nhwc` for the output cotangent ``y`` (NHWC) and HWIO
    weights ``w``, at the conv input's spatial size ``in_hw``."""
    (pt, _), (pl, _) = padding
    full = nhwc(F.conv_transpose2d(nchw(y), w.permute(3, 2, 0, 1),
                                   stride=sliding))
    h, wd = in_hw
    out = full[:, pt:pt + h, pl:pl + wd]
    short_h, short_w = h - out.shape[1], wd - out.shape[2]
    if short_h or short_w:
        out = F.pad(out, (0, 0, 0, short_w, 0, short_h))
    return out


class Deconv(ForwardBase):
    """Transposed convolution with weights tied to a forward Conv
    (znicz ``Deconv`` — the decoder half of conv autoencoder
    pretraining; ``get_weights_from`` names the conv whose filters are
    reused, trained through that conv and never through this unit)."""

    MAPPING = "deconv"
    HAS_PARAMS = False

    def __init__(self, workflow, **kwargs):
        super(Deconv, self).__init__(workflow, **kwargs)
        self.conv = kwargs["get_weights_from"]
        self.include_bias = False

    @property
    def trainables(self):
        return {}  # the tied weights belong to (and train via) conv

    def initialize(self, device=None, **kwargs):
        if not self.conv.is_initialized:
            raise AttributeError(
                "%s: tied conv %s not initialized yet" %
                (self.name, self.conv.name))
        super(Deconv, self).initialize(device=device, **kwargs)
        batch = self.input.shape[0]
        out_shape = self.conv.input.shape[1:]
        self.output.mem = numpy.zeros((batch,) + tuple(out_shape),
                                      dtype=numpy.float32)
        self.output.initialize(self.device)

    def tforward(self, read, write, params, ctx, state=None):
        cdt = self.compute_dtype
        conv = self.conv
        write(self.output, conv2d_input_nhwc(
            read(self.input).to(cdt), read(conv.weights).to(cdt),
            tuple(conv.input.shape[1:3]), conv.sliding, conv.padding))
