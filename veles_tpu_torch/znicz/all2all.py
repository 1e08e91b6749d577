"""Fully-connected (All2All) layer units (the JAX package's
``znicz.all2all``): output = activation(input·W + b).

The input flattens per sample in its own (NHWC) order, so a conv
stack's (B, H, W, C) output feeds the first FC layer as H·W·C features
in the same order as in the JAX package, and carried-over weights mean
the same thing.  The product rounds both operands to the compute dtype
(bfloat16 at ``precision_level`` 0) and multiplies them in float32, as
``jnp.dot(..., preferred_element_type=float32)`` does; bias and
activation follow in float32.
"""

import numpy
import torch

from . import nn_units
from .nn_units import ForwardBase, dot


class All2All(ForwardBase):
    """Linear layer (identity activation)."""

    MAPPING = "all2all"
    A = 1.0  # activation output scale (znicz ergonomics)

    def __init__(self, workflow, **kwargs):
        super(All2All, self).__init__(workflow, **kwargs)
        self.output_sample_shape = kwargs.get("output_sample_shape",
                                              kwargs.get("output_shape"))
        if isinstance(self.output_sample_shape, int):
            self.output_sample_shape = (self.output_sample_shape,)
        if self.output_sample_shape is None:
            raise ValueError("%s requires output_sample_shape" % self)

    @property
    def neurons_number(self):
        return int(numpy.prod(self.output_sample_shape))

    def initialize(self, device=None, **kwargs):
        super(All2All, self).initialize(device=device, **kwargs)
        batch = self.input.shape[0]
        fan_in = self.input.size // batch
        n_out = self.neurons_number
        if not self.weights:
            stddev = self.weights_stddev or (1.0 / numpy.sqrt(fan_in))
            w = numpy.zeros((fan_in, n_out), dtype=numpy.float32)
            self.rand().fill_normal(w, stddev=stddev)
            self.weights.mem = w
            self.weights.initialize(self.device)
        if self.include_bias and not self.bias:
            b = numpy.zeros(n_out, dtype=numpy.float32)
            if self.bias_stddev:
                self.rand().fill_normal(b, stddev=self.bias_stddev)
            self.bias.mem = b
            self.bias.initialize(self.device)
        self.output.mem = numpy.zeros(
            (batch,) + tuple(self.output_sample_shape), dtype=numpy.float32)
        self.output.initialize(self.device)

    def activation(self, v):
        return v

    def _linear(self, read, params):
        x = read(self.input)
        y = dot(x.reshape(x.shape[0], -1), params["weights"],
                self.compute_dtype)
        if self.include_bias:
            y = y + params["bias"]
        return y

    def tforward(self, read, write, params, ctx, state=None):
        y = self.activation(self._linear(read, params))
        write(self.output,
              y.reshape((y.shape[0],) + tuple(self.output_sample_shape)))


class All2AllTanh(All2All):
    """Scaled tanh activation (znicz 1.7159·tanh(0.6666·x))."""

    MAPPING = "all2all_tanh"
    A = nn_units.TANH_A

    def activation(self, v):
        return nn_units.act_tanh(v)


class All2AllRelu(All2All):
    """Softplus log(1+e^x) — znicz's smooth "RELU"."""

    MAPPING = "all2all_relu"

    def activation(self, v):
        return nn_units.act_softplus(v)


class All2AllStrictRelu(All2All):
    """max(0, x) (znicz ``All2AllStrictRELU``)."""

    MAPPING = "all2all_str"

    def activation(self, v):
        return nn_units.act_strict_relu(v)


class All2AllSigmoid(All2All):
    MAPPING = "all2all_sigmoid"

    def activation(self, v):
        return nn_units.act_sigmoid(v)


class All2AllSoftmax(All2All):
    """Softmax output layer: writes ``output`` (probabilities),
    ``logits`` (pre-activation, which the evaluator reads for a stable
    cross-entropy) and ``max_idx`` (the argmax)."""

    MAPPING = "softmax"

    def __init__(self, workflow, **kwargs):
        super(All2AllSoftmax, self).__init__(workflow, **kwargs)
        from ..memory import Vector
        self.logits = Vector()
        self.max_idx = Vector()

    def initialize(self, device=None, **kwargs):
        super(All2AllSoftmax, self).initialize(device=device, **kwargs)
        self.logits.mem = numpy.zeros(
            (self.input.shape[0], self.neurons_number),
            dtype=numpy.float32)
        self.logits.initialize(self.device)

    def tforward(self, read, write, params, ctx, state=None):
        logits = self._linear(read, params)
        write(self.logits, logits)
        write(self.output, torch.softmax(logits, dim=-1))
        write(self.max_idx, torch.argmax(logits, dim=-1))
