"""Per-layer gradient-descent trainer units (the JAX package's
``znicz.gd``).  The backward is autograd over the composed forward, so
every layer type shares one update (``GradientDescentBase`` with its
optimizer: momentum SGD with L2 decay by default); the per-type classes
keep the layer → trainer pairing of ``gd_for``: construct the GD unit
matching your layer and link it with ``target=layer``.
"""

from .nn_units import GradientDescentBase


class GradientDescent(GradientDescentBase):
    """Trainer for plain All2All layers."""
    MAPPING = "all2all"


class GDTanh(GradientDescentBase):
    MAPPING = "all2all_tanh"


class GDRelu(GradientDescentBase):
    MAPPING = "all2all_relu"


class GDStrictRelu(GradientDescentBase):
    MAPPING = "all2all_str"


class GDSigmoid(GradientDescentBase):
    MAPPING = "all2all_sigmoid"


class GDSoftmax(GradientDescentBase):
    MAPPING = "softmax"


# -- conv family ---------------------------------------------------------------

class GDConv(GradientDescentBase):
    MAPPING = "conv"


class GDConvTanh(GradientDescentBase):
    MAPPING = "conv_tanh"


class GDConvRelu(GradientDescentBase):
    MAPPING = "conv_relu"


class GDConvStrictRelu(GradientDescentBase):
    MAPPING = "conv_str"


class GDConvSigmoid(GradientDescentBase):
    MAPPING = "conv_sigmoid"


# -- pooling family (parameterless; kept so the layer → trainer pairing
# covers whole-stack construction) ------------------------------------------

class GDMaxPooling(GradientDescentBase):
    MAPPING = "max_pooling"


class GDMaxAbsPooling(GradientDescentBase):
    MAPPING = "maxabs_pooling"


class GDAvgPooling(GradientDescentBase):
    MAPPING = "avg_pooling"


# -- activations / dropout / LRN -------------------------------------------

class GDActivationTanh(GradientDescentBase):
    MAPPING = "activation_tanh"


class GDActivationRelu(GradientDescentBase):
    MAPPING = "activation_relu"


class GDActivationStrictRelu(GradientDescentBase):
    MAPPING = "activation_str"


class GDActivationSigmoid(GradientDescentBase):
    MAPPING = "activation_sigmoid"


class GDActivationLog(GradientDescentBase):
    MAPPING = "activation_log"


class GDActivationTanhLog(GradientDescentBase):
    MAPPING = "activation_tanhlog"


class GDActivationSinCos(GradientDescentBase):
    MAPPING = "activation_sincos"


class GDActivationMul(GradientDescentBase):
    MAPPING = "activation_mul"


class GDDropout(GradientDescentBase):
    MAPPING = "dropout"


class GDLRNormalizer(GradientDescentBase):
    MAPPING = "norm"
