"""znicz — the neural-network layer library of the port.

Ported so far: the layer and trainer bases, the optimizer registry,
the evaluator base and the decision, and the dense transformer LM
units.  The MNIST FC family (all2all, activation, EvaluatorSoftmax,
gd, standard_workflow) follows in the next slice (ROADMAP A1); conv,
pooling and LRN with the conv slice (A4).
"""

from .nn_units import ForwardBase, GradientDescentBase  # noqa: F401
from .attention import (Embedding, TransformerBlock,  # noqa: F401
                        LMHead, EvaluatorLM)
from .decision import DecisionBase, DecisionGD  # noqa: F401
