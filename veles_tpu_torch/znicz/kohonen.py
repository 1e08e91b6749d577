"""Kohonen self-organizing map units (the JAX package's
``znicz.kohonen``).

The SOM update Δw_i = lr·h_σ(winner, i)·(x − w_i) is the negative
gradient of the pseudo-loss

    L = ½ Σ_batch Σ_i h_σ(winner, i) · ‖x − w_i‖²

with the winners and the neighbourhood h held constant (detached), so —
like the RBM's CD — the trainer sets L as the step's loss and the
ordinary GD unit applies the update inside the step.  The
neighbourhood radius σ decays with the count of trained ticks, kept
on the device as the trainer's ``ticks`` state.
"""

import numpy
import torch

from ..memory import Vector
from .nn_units import ForwardBase, GradientDescentBase


class KohonenForward(ForwardBase):
    """Winner-take-all forward: the squared distance of each sample to
    every neuron (``output``) and the best-matching unit's index
    (``winners``)."""

    MAPPING = "kohonen"

    def __init__(self, workflow, **kwargs):
        super(KohonenForward, self).__init__(workflow, **kwargs)
        #: SOM grid shape (y, x).
        self.shape = tuple(kwargs.get("shape", (8, 8)))
        self.include_bias = False
        self.winners = Vector()

    @property
    def n_neurons(self):
        return int(numpy.prod(self.shape))

    @property
    def trainables(self):
        return {"weights": self.weights}

    def initialize(self, device=None, **kwargs):
        super(KohonenForward, self).initialize(device=device, **kwargs)
        batch = self.input.shape[0]
        n_in = self.input.size // batch
        if not self.weights:
            stddev = self.weights_stddev or (1.0 / numpy.sqrt(n_in))
            w = numpy.zeros((self.n_neurons, n_in), dtype=numpy.float32)
            self.rand().fill_normal(w, stddev=stddev)
            self.weights.mem = w
            self.weights.initialize(self.device)
        self.output.mem = numpy.zeros((batch, self.n_neurons),
                                      dtype=numpy.float32)
        self.output.initialize(self.device)
        self.winners.mem = numpy.zeros(batch, dtype=numpy.int32)
        self.winners.initialize(self.device)

    def step_persist_vectors(self):
        return [self.output, self.winners]

    @staticmethod
    def distances(x, w):
        """‖x − w‖² expanded, so the x·wᵀ product is one matmul."""
        return ((x * x).sum(1, keepdim=True) - 2.0 * (x @ w.T) +
                (w * w).sum(1))

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        d = self.distances(x, params["weights"])
        write(self.output, d)
        write(self.winners, torch.argmin(d, dim=1).to(torch.int32))


class KohonenTrainer(ForwardBase):
    """Sets the SOM pseudo-loss whose gradient is the Kohonen update.
    ``forward`` is the paired KohonenForward; σ decays exponentially
    from ``sigma0`` to ``sigma_min`` with trained ticks."""

    MAPPING = "kohonen_trainer"
    HAS_PARAMS = False

    def __init__(self, workflow, **kwargs):
        super(KohonenTrainer, self).__init__(workflow, **kwargs)
        self.forward = kwargs["forward"]
        self.mask = None  # linked: loader.minibatch_mask
        self.sigma0 = kwargs.get("sigma0", max(self.forward.shape) / 2.0)
        self.sigma_min = kwargs.get("sigma_min", 0.5)
        self.sigma_decay = kwargs.get("sigma_decay", 0.999)
        self.ticks = Vector(numpy.zeros((), dtype=numpy.float32))
        self._grid = None

    @property
    def trainables(self):
        return {}

    @property
    def tstate(self):
        return {"ticks": self.ticks}

    def initialize(self, device=None, **kwargs):
        super(KohonenTrainer, self).initialize(device=device, **kwargs)
        gy, gx = self.forward.shape
        yy, xx = numpy.mgrid[0:gy, 0:gx]
        self._grid = numpy.stack(
            [yy.ravel(), xx.ravel()]).T.astype(numpy.float32)
        self.output.mem = numpy.zeros((), dtype=numpy.float32)

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        w = read(self.forward.weights)   # the parameter, through the bag
        d = self.forward.distances(x, w.detach())
        winners = torch.argmin(d, dim=1)
        grid = torch.as_tensor(self._grid, device=x.device)
        t = state["ticks"] if state is not None else \
            torch.zeros((), device=x.device)
        sigma = torch.clamp(self.sigma0 * torch.pow(
            torch.tensor(self.sigma_decay, dtype=torch.float32,
                         device=x.device), t), min=self.sigma_min)
        # The Gaussian neighbourhood of each sample's winner, constant
        # with respect to the differentiated parameters.
        gd2 = ((grid[winners][:, None, :] - grid[None, :, :]) ** 2).sum(-1)
        h = torch.exp(-gd2 / (2.0 * sigma ** 2)).detach()
        # Padded rows of a partial minibatch must not act as data points
        # at the origin.
        if self.mask is not None:
            m = read(self.mask)
            h = h * m[:, None]
            denom = torch.clamp(m.sum(), min=1.0)
        else:
            denom = float(x.shape[0])
        loss = 0.5 * (h * self.forward.distances(x, w)).sum() / denom
        ctx.set_loss(loss)
        ctx.add_metric("som_quant_err", torch.sqrt(
            torch.gather(d, 1, winners[:, None]).mean()))
        if state is not None:
            # σ decays with trained ticks only.
            return {"ticks": t + (1.0 if ctx.training else 0.0)}


class GDKohonen(GradientDescentBase):
    MAPPING = "kohonen"
