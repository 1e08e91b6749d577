"""RBM and tied-weight autoencoder pretraining units (the JAX package's
``znicz.rbm``).

Contrastive divergence as the gradient of a pseudo-loss: CD-k's update
is the gradient of the free-energy difference

    L = FE(v0) − FE(vk),   FE(v) = −v·b − Σ softplus(c + vW)

with the negative phase ``vk`` held constant (detached).  So
:class:`RBM` runs the Gibbs chain inside the step and sets L as the
step's loss; autograd yields the CD-k statistics ⟨v0ᵀh0⟩ − ⟨vkᵀhk⟩, and
the ordinary per-layer GD unit (momentum, weight decay) applies them.

The hidden samples are uniform draws below the hidden probabilities
(the semantics of ``jax.random.bernoulli``) from the step's seeded
``torch.Generator`` on the tensors' device (``StepContext.next_key``).
The generator draws other numbers than the JAX package's threefry key,
so a chain is held to the JAX package's statistically; ``draw_hidden``
is the seam through which tests hand both packages the same samples.

:class:`All2AllDeconv` is the tied-weight decoder half of an
autoencoder: y = act(x·Wᵀ + b) with W read from, and trained through,
the paired encoder.
"""

import numpy
import torch

from ..memory import Vector
from . import nn_units
from .evaluator import EvaluatorMSE
from .nn_units import ForwardBase, GradientDescentBase


def _softplus(v):
    """log(1 + eᵛ) without overflow (``jax.nn.softplus``)."""
    return torch.logaddexp(v, torch.zeros_like(v))


class RBM(ForwardBase):
    """Bernoulli-Bernoulli RBM layer trained by CD-k.

    Outputs: ``output`` — the hidden probabilities h0 (the features for
    stacking); ``reconstruction`` — the vk probabilities (for the
    evaluator).
    """

    MAPPING = "rbm"

    def __init__(self, workflow, **kwargs):
        super(RBM, self).__init__(workflow, **kwargs)
        self.output_sample_shape = kwargs.get("output_sample_shape",
                                              kwargs.get("output_shape"))
        if isinstance(self.output_sample_shape, int):
            self.output_sample_shape = (self.output_sample_shape,)
        self.cd_k = kwargs.get("cd_k", 1)
        self.mask = None  # linked: loader.minibatch_mask
        self.vbias = Vector()  # visible bias (b)
        self.reconstruction = Vector()

    @property
    def n_hidden(self):
        return int(numpy.prod(self.output_sample_shape))

    @property
    def trainables(self):
        t = {"weights": self.weights, "vbias": self.vbias}
        if self.include_bias:
            t["bias"] = self.bias  # hidden bias (c)
        return t

    def initialize(self, device=None, **kwargs):
        super(RBM, self).initialize(device=device, **kwargs)
        batch = self.input.shape[0]
        n_vis = self.input.size // batch
        n_hid = self.n_hidden
        if not self.weights:
            stddev = self.weights_stddev or (1.0 / numpy.sqrt(n_vis))
            w = numpy.zeros((n_vis, n_hid), dtype=numpy.float32)
            self.rand().fill_normal(w, stddev=stddev)
            self.weights.mem = w
            self.weights.initialize(self.device)
        if self.include_bias and not self.bias:
            self.bias.mem = numpy.zeros(n_hid, dtype=numpy.float32)
            self.bias.initialize(self.device)
        if not self.vbias:
            self.vbias.mem = numpy.zeros(n_vis, dtype=numpy.float32)
            self.vbias.initialize(self.device)
        self.output.mem = numpy.zeros(
            (batch,) + tuple(self.output_sample_shape), dtype=numpy.float32)
        self.output.initialize(self.device)
        self.reconstruction.mem = numpy.zeros((batch, n_vis),
                                              dtype=numpy.float32)
        self.reconstruction.initialize(self.device)

    def step_persist_vectors(self):
        return [self.output, self.reconstruction]

    @staticmethod
    def free_energy(v, w, b, c):
        return -(v @ b) - _softplus(c + v @ w).sum(dim=-1)

    def draw_hidden(self, ctx, p):
        """Binary hidden states: uniform draws below ``p``."""
        return (torch.rand(p.shape, generator=ctx.next_key(),
                           device=p.device) < p).to(torch.float32)

    def tforward(self, read, write, params, ctx, state=None):
        v0 = read(self.input)
        v0 = v0.reshape(v0.shape[0], -1).to(torch.float32)
        w = params["weights"]
        b = params["vbias"]
        c = params["bias"] if self.include_bias else 0.0
        h = torch.sigmoid(v0 @ w + c)
        write(self.output,
              h.reshape((v0.shape[0],) + tuple(self.output_sample_shape)))
        vk, hk = v0, h
        for _ in range(self.cd_k):
            hs = self.draw_hidden(ctx, hk.detach())
            vk = torch.sigmoid(hs @ w.T + b)
            hk = torch.sigmoid(vk @ w + c)
        vk = vk.detach()
        write(self.reconstruction, vk)
        # CD-k pseudo-loss: its gradient is the positive minus the
        # negative statistics.  Padded rows of a partial minibatch
        # carry none.
        per_sample = (self.free_energy(v0, w, b, c) -
                      self.free_energy(vk, w, b, c))
        if self.mask is not None:
            m = read(self.mask)
            loss = (per_sample * m).sum() / torch.clamp(m.sum(), min=1.0)
        else:
            loss = per_sample.mean()
        ctx.set_loss(loss)


class GDRBM(GradientDescentBase):
    """Momentum/decay applier of the CD statistics."""
    MAPPING = "rbm"


class EvaluatorRBM(EvaluatorMSE):
    """Reconstruction-MSE metrics of RBM pretraining: an EvaluatorMSE
    that does not set the step's loss — the RBM's CD pseudo-loss is the
    differentiated objective; this unit feeds the decision's epoch
    accounting."""

    OWNS_LOSS = False


class All2AllDeconv(ForwardBase):
    """Tied-weight dense decoder: y = act(x·Wᵀ + b) with W shared from
    the paired encoder All2All (``get_weights_from``).  Its own
    trainable is the visible bias."""

    MAPPING = "all2all_deconv"

    def __init__(self, workflow, **kwargs):
        super(All2AllDeconv, self).__init__(workflow, **kwargs)
        self.encoder = kwargs["get_weights_from"]
        self.vbias = Vector()

    @property
    def trainables(self):
        return {"vbias": self.vbias} if self.include_bias else {}

    def activation(self, v):
        return v

    def initialize(self, device=None, **kwargs):
        if not self.encoder.is_initialized:
            raise AttributeError(
                "%s: tied encoder %s not initialized yet" %
                (self.name, self.encoder.name))
        super(All2AllDeconv, self).initialize(device=device, **kwargs)
        batch = self.input.shape[0]
        n_vis = self.encoder.weights.shape[0]
        if not self.vbias:
            self.vbias.mem = numpy.zeros(n_vis, dtype=numpy.float32)
            self.vbias.initialize(self.device)
        self.output.mem = numpy.zeros((batch, n_vis), dtype=numpy.float32)
        self.output.initialize(self.device)

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        w = read(self.encoder.weights)  # tied: gradients reach the encoder
        y = x @ w.T
        if self.include_bias:
            y = y + params["vbias"]
        write(self.output, self.activation(y))


class All2AllDeconvSigmoid(All2AllDeconv):
    MAPPING = "all2all_deconv_sigmoid"

    def activation(self, v):
        return nn_units.act_sigmoid(v)


class All2AllDeconvTanh(All2AllDeconv):
    MAPPING = "all2all_deconv_tanh"

    def activation(self, v):
        return nn_units.act_tanh(v)


class GDA2ADeconv(GradientDescentBase):
    MAPPING = "all2all_deconv"


class GDA2ADeconvSigmoid(GradientDescentBase):
    MAPPING = "all2all_deconv_sigmoid"


class GDA2ADeconvTanh(GradientDescentBase):
    MAPPING = "all2all_deconv_tanh"
