"""Standalone activation units (the JAX package's ``znicz.activation``).

Shape-preserving elementwise units usable between any two layers:
ForwardTanh, ForwardRelu (softplus), ForwardStrictRelu, ForwardSigmoid,
ForwardLog, ForwardTanhLog, ForwardSinCos, ForwardMul.  Each has a GD
registration (``gd.py``) so ``gd_for`` resolves; the backward is
autograd.  The map runs in float32 and the result keeps the input's
dtype (the bfloat16 activation stream stays narrow).
"""

import numpy
import torch

from . import nn_units
from .nn_units import ForwardBase


class ActivationForward(ForwardBase):
    """Shape-preserving elementwise unit."""

    hide_from_registry = True
    HAS_PARAMS = False

    @property
    def trainables(self):
        return {}

    def initialize(self, device=None, **kwargs):
        super(ActivationForward, self).initialize(device=device,
                                                  **kwargs)
        self.output.mem = numpy.zeros(self.input.shape,
                                      dtype=numpy.float32)
        self.output.initialize(self.device)

    def activation(self, v):
        raise NotImplementedError()

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)
        write(self.output, self.activation(x.float()).to(x.dtype))


class ForwardTanh(ActivationForward):
    MAPPING = "activation_tanh"

    def activation(self, v):
        return nn_units.act_tanh(v)


class ForwardRelu(ActivationForward):
    """Smooth ReLU: log(1 + e^x) (znicz ``ForwardRELU``)."""
    MAPPING = "activation_relu"

    def activation(self, v):
        return nn_units.act_softplus(v)


class ForwardStrictRelu(ActivationForward):
    MAPPING = "activation_str"

    def activation(self, v):
        return nn_units.act_strict_relu(v)


class ForwardSigmoid(ActivationForward):
    MAPPING = "activation_sigmoid"

    def activation(self, v):
        return nn_units.act_sigmoid(v)


class ForwardLog(ActivationForward):
    """log(x + sqrt(x² + 1)) — asinh (znicz ``ForwardLog``)."""
    MAPPING = "activation_log"

    def activation(self, v):
        return torch.asinh(v)


class ForwardTanhLog(ActivationForward):
    """A·tanh(B·x) for |x| <= D, a logarithm beyond (znicz
    ``ForwardTanhLog``): bounded like tanh near 0, unbounded growth
    beyond the threshold."""
    MAPPING = "activation_tanhlog"
    D = 3.0
    A = 1.7159
    B = 0.6666

    def activation(self, v):
        t = self.A * torch.tanh(self.B * v)
        edge = self.A * numpy.tanh(self.B * self.D)
        lg = torch.sign(v) * (edge + torch.log1p(v.abs() - self.D))
        return torch.where(v.abs() <= self.D, t, lg)


class ForwardSinCos(ActivationForward):
    """sin on even feature indices, cos on odd (znicz
    ``ForwardSinCos``)."""
    MAPPING = "activation_sincos"

    def activation(self, v):
        flat = v.reshape(v.shape[0], -1)
        even = torch.arange(flat.shape[1], device=v.device) % 2 == 0
        return torch.where(even, torch.sin(flat),
                           torch.cos(flat)).reshape(v.shape)


class ForwardMul(ActivationForward):
    """y = k·x with a learnable scalar k (znicz ``ForwardMul``)."""
    MAPPING = "activation_mul"
    HAS_PARAMS = True

    def __init__(self, workflow, **kwargs):
        super(ForwardMul, self).__init__(workflow, **kwargs)
        from ..memory import Vector
        self.factor = Vector(numpy.ones((), dtype=numpy.float32) *
                             kwargs.get("factor", 1.0))

    @property
    def trainables(self):
        return {"factor": self.factor}

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)
        write(self.output, (params["factor"] * x.float()).to(x.dtype))
