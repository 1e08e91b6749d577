"""Dropout unit (the JAX package's ``znicz.dropout``): inverted
dropout — training keeps each activation with probability 1 − ratio
and scales the kept ones by 1/(1 − ratio), so inference is the
identity.  The mask is drawn from the step's seeded ``torch.Generator``
(``StepContext.next_key``); autograd routes the gradient through the
same mask.  The generator draws other numbers than the JAX package's
threefry key, so the parity tests hand both packages the same masks.
"""

import numpy
import torch

from ..accelerated_units import select_by_training
from .nn_units import ForwardBase


class DropoutForward(ForwardBase):
    MAPPING = "dropout"
    HAS_PARAMS = False

    def __init__(self, workflow, **kwargs):
        super(DropoutForward, self).__init__(workflow, **kwargs)
        self.dropout_ratio = kwargs.get("dropout_ratio", 0.5)

    @property
    def trainables(self):
        return {}

    def initialize(self, device=None, **kwargs):
        super(DropoutForward, self).initialize(device=device, **kwargs)
        self.output.mem = numpy.zeros(self.input.shape,
                                      dtype=numpy.float32)
        self.output.initialize(self.device)

    def draw_mask(self, ctx, shape, keep, device):
        """The keep mask: uniform draws below ``keep`` (the semantics
        of ``jax.random.bernoulli``)."""
        return torch.rand(shape, generator=ctx.next_key(),
                          device=device) < keep

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)  # keeps the activation dtype
        keep = 1.0 - self.dropout_ratio

        def train_branch():
            mask = self.draw_mask(ctx, x.shape, keep, x.device)
            # The scale rounded to x's dtype first, as the JAX package's
            # weakly typed scalar is.
            scale = float(torch.tensor(1.0 / keep, dtype=x.dtype))
            return x * mask.to(x.dtype) * scale

        write(self.output, select_by_training(ctx, train_branch,
                                              lambda: x))
