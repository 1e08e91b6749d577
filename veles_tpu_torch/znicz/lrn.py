"""Local response normalization unit (the JAX package's
``znicz.lrn``), cross-channel over the NHWC input's last axis::

    y = x / (k + alpha/n · Σ_{j∈window} x_j²)^beta

(AlexNet: k=2, n=5, alpha=1e-4, beta=0.75; the znicz defaults).

The knob ``root.common.engine.pallas_lrn`` keeps its JAX name and
chooses the path, with another default: unset or True, a CUDA tensor
launches the hand-written forward and backward kernels
(``ops/lrn.py``, B6/B7, on the register route of 16-byte vectors and
warp shuffles for AlexNet's n = 5, the wide route of shared-memory rows
for windows or storage offsets it does not take) and a CPU tensor takes
the plain banded version; False takes the plain banded version
(``ops.lrn.lrn_reference``) on any device — the only way to it on the
card.  (In the JAX package the kernel is opt-in, because it lost end to
end on the TPU for TPU-specific reasons; on the card it is measured,
both ways, by ``chip_smoke.py``.)
"""

import numpy

from ..config import root, get as config_get
from ..ops import lrn as ops_lrn
from .nn_units import ForwardBase


class LRNormalizerForward(ForwardBase):
    MAPPING = "norm"
    HAS_PARAMS = False

    def __init__(self, workflow, **kwargs):
        super(LRNormalizerForward, self).__init__(workflow, **kwargs)
        self.alpha = kwargs.get("alpha", 1e-4)
        self.beta = kwargs.get("beta", 0.75)
        self.k = kwargs.get("k", 2.0)
        self.n = kwargs.get("n", 5)

    @property
    def trainables(self):
        return {}

    def initialize(self, device=None, **kwargs):
        super(LRNormalizerForward, self).initialize(device=device,
                                                    **kwargs)
        self.output.mem = numpy.zeros(self.input.shape,
                                      dtype=numpy.float32)
        self.output.initialize(self.device)

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)
        if config_get(root.common.engine.pallas_lrn, True):
            fn = ops_lrn.lrn
        else:
            fn = ops_lrn.lrn_reference
        write(self.output, fn(x, self.n, self.alpha, self.beta, self.k))
