"""Mean/dispersion normalizer unit (the JAX package's
``mean_disp_normalizer``): the byte-image pipeline's normalization on
the device,

    y = (x − mean) · rdisp

with the per-feature ``mean`` and reciprocal dispersion ``rdisp`` from
the loader's dataset analysis (the AlexNet path).  It runs inside the
step, so the uint8 originals stay uint8 in device memory; the result is
computed in float32 and enters the conv stack in the compute dtype.
``mean`` and ``rdisp`` are step constants (``step_const_vectors``).
"""

import numpy

from .accelerated_units import TracedUnit, step_compute_dtype
from .memory import Vector


class MeanDispNormalizer(TracedUnit):
    """y = (x − mean)·rdisp, inside the step."""

    def __init__(self, workflow, **kwargs):
        super(MeanDispNormalizer, self).__init__(workflow, **kwargs)
        self.view_group = "WORKER"
        self.input = None   # linked: loader minibatch data (any dtype)
        self.mean = None    # linked: per-feature mean (sample shape)
        self.rdisp = None   # linked: per-feature 1/dispersion
        self.output = Vector()
        self.demand("input", "mean", "rdisp")

    def initialize(self, device=None, **kwargs):
        super(MeanDispNormalizer, self).initialize(device=device,
                                                   **kwargs)
        self.output.mem = numpy.zeros(self.input.shape,
                                      dtype=numpy.float32)
        self.output.initialize(self.device)

    def step_const_vectors(self):
        return [v for v in (self.mean, self.rdisp)
                if isinstance(v, Vector)]

    @property
    def compute_dtype(self):
        return step_compute_dtype()

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input).float()
        mean = read(self.mean).float()
        rdisp = read(self.rdisp).float()
        write(self.output, ((x - mean) * rdisp).to(self.compute_dtype))
