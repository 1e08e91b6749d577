"""znicz — the neural-network layer library of the port.

Ported so far: the layer and trainer bases, the optimizer registry, the
FC family (all2all, standalone activations), conv, pooling, LRN,
dropout, the per-layer GD units, the softmax / MSE / LM evaluators, the
decision, the declarative ``StandardWorkflow``, the dense transformer
LM units, and the pretraining units (RBM, tied-weight deconv,
Kohonen).  Importing the package registers every layer
type, so ``StandardWorkflow`` resolves them by name.
"""

from .nn_units import (ForwardBase, GradientDescentBase,  # noqa: F401
                       gd_for)
from .all2all import (All2All, All2AllTanh, All2AllRelu,  # noqa: F401
                      All2AllStrictRelu, All2AllSigmoid,
                      All2AllSoftmax)
from .conv import (Conv, ConvTanh, ConvRelu, ConvStrictRelu,  # noqa: F401
                   ConvSigmoid, Deconv)
from .pooling import (Pooling, MaxPooling, MaxAbsPooling,  # noqa: F401
                      AvgPooling, StochasticPooling,
                      StochasticAbsPooling)
from .activation import (ActivationForward, ForwardTanh,  # noqa: F401
                         ForwardRelu, ForwardStrictRelu,
                         ForwardSigmoid, ForwardLog, ForwardTanhLog,
                         ForwardSinCos, ForwardMul)
from .dropout import DropoutForward  # noqa: F401
from .lrn import LRNormalizerForward  # noqa: F401
from .evaluator import EvaluatorSoftmax, EvaluatorMSE  # noqa: F401
from . import gd  # noqa: F401
from .attention import (Embedding, TransformerBlock,  # noqa: F401
                        LMHead, EvaluatorLM)
from .decision import DecisionBase, DecisionGD  # noqa: F401
from .rbm import (RBM, GDRBM, EvaluatorRBM, All2AllDeconv,  # noqa: F401
                  All2AllDeconvSigmoid, All2AllDeconvTanh, GDA2ADeconv,
                  GDA2ADeconvSigmoid, GDA2ADeconvTanh)
from .kohonen import (KohonenForward, KohonenTrainer,  # noqa: F401
                      GDKohonen)
from .standard_workflow import StandardWorkflow  # noqa: F401
