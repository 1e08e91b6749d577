"""Input joiner unit (the JAX package's ``input_joiner``): concatenates
N input Vectors feature-wise into one float32 output — each input
flattened to (batch, features) — and sets ``offset_<i>`` /
``length_<i>`` so downstream units can address the sub-ranges.  In the
step it is one ``torch.cat``.
"""

import numpy
import torch

from .accelerated_units import TracedUnit
from .memory import Vector


class InputJoiner(TracedUnit):
    def __init__(self, workflow, **kwargs):
        super(InputJoiner, self).__init__(workflow, **kwargs)
        self.view_group = "WORKER"
        self.inputs = list(kwargs.get("inputs", ()))
        self.output = Vector()

    def link_inputs(self, *vectors):
        self.inputs.extend(vectors)
        return self

    def initialize(self, device=None, **kwargs):
        if not self.inputs:
            raise ValueError("%s has no inputs" % self)
        if any(not v for v in self.inputs):
            raise AttributeError(
                "%s: inputs not allocated yet" % self.name)
        super(InputJoiner, self).initialize(device=device, **kwargs)
        batch = self.inputs[0].shape[0]
        offset = 0
        for i, v in enumerate(self.inputs):
            length = v.size // batch
            setattr(self, "offset_%d" % i, offset)
            setattr(self, "length_%d" % i, length)
            offset += length
        self.output.mem = numpy.zeros((batch, offset),
                                      dtype=numpy.float32)
        self.output.initialize(self.device)

    def tforward(self, read, write, params, ctx, state=None):
        parts = []
        for v in self.inputs:
            x = read(v)
            parts.append(x.reshape(x.shape[0], -1).float())
        write(self.output, torch.cat(parts, dim=1))
