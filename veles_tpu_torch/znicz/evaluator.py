"""Loss evaluator base (the JAX package's ``znicz.evaluator``).

The evaluator closes the forward chain: it computes the scalar loss
(``ctx.set_loss``, differentiated by the step) and the batch metrics
that the Decision unit consumes, and adds them into ON-DEVICE epoch
accumulators inside the step, so the host reads them once per
class-epoch.  The LM evaluator is ``znicz.attention.EvaluatorLM``; the
softmax and MSE evaluators come with the MNIST tick (ROADMAP A1).
"""

import numpy
import torch

from ..accelerated_units import TracedUnit
from ..config import root, get as config_get
from ..memory import Vector


class EvaluatorBase(TracedUnit):
    """Common evaluator machinery: ``epoch_acc`` is a (3 classes × 4)
    array of [err_sum, n_valid, loss_sum, n_ticks]; ``health_acc`` a
    (3 × 4) array of [non-finite ticks, grad-norm sum, grad-norm max,
    ticks] written by the step's health sentinel.  At
    ``precision_level`` >= 1 the epoch sums are Kahan-compensated
    (``epoch_acc_c`` holds the carry)."""

    hide_from_registry = True

    ACC_ERR, ACC_VALID, ACC_LOSS, ACC_TICKS = range(4)
    HEALTH_NONFINITE, HEALTH_GNORM_SUM, HEALTH_GNORM_MAX, \
        HEALTH_TICKS = range(4)

    def __init__(self, workflow, **kwargs):
        super(EvaluatorBase, self).__init__(workflow, **kwargs)
        self.view_group = "EVALUATOR"
        self.input = None        # linked: last layer's output/logits
        self.mask = None         # linked: loader.minibatch_mask
        self.minibatch_class_vec = None  # linked from the loader
        self.epoch_acc = Vector(numpy.zeros((3, 4), dtype=numpy.float32))
        self.epoch_acc_c = Vector(numpy.zeros((3, 4),
                                              dtype=numpy.float32))
        self.health_acc = Vector(numpy.zeros((3, 4),
                                             dtype=numpy.float32))
        self.demand("input")

    @staticmethod
    def _compensated():
        return config_get(root.common.engine.precision_level, 0) >= 1

    @property
    def tstate(self):
        state = {"epoch_acc": self.epoch_acc,
                 "health_acc": self.health_acc}
        if self._compensated():
            state["epoch_acc_c"] = self.epoch_acc_c
        return state

    def _accumulate(self, read, state, err_sum, n_valid, loss):
        if state is None:  # eager (per-unit) execution: no accumulator
            return None
        cls = read(self.minibatch_class_vec).long().reshape(1)
        # Padded block ticks (all-zero mask) must not count: gate the
        # whole row, including the tick counter, by validity.
        valid = (n_valid > 0).float()
        row = torch.stack([err_sum, n_valid, loss * valid, valid])[None]
        if "epoch_acc_c" in state:
            # Kahan step: the carry row absorbs the low-order bits a
            # plain f32 add would drop over a long epoch.
            acc = state["epoch_acc"].index_select(0, cls)
            carry = state["epoch_acc_c"].index_select(0, cls)
            y = row - carry
            t = acc + y
            new_carry = (t - acc) - y
            return {"epoch_acc": state["epoch_acc"].index_copy(0, cls, t),
                    "epoch_acc_c":
                        state["epoch_acc_c"].index_copy(0, cls,
                                                        new_carry)}
        return {"epoch_acc": state["epoch_acc"].index_add(0, cls, row)}

    def read_epoch_acc(self, cls):
        """Host fetch of one class's accumulated row (the epoch-boundary
        sync point)."""
        self.epoch_acc.map_read()
        return numpy.array(self.epoch_acc.mem[cls])

    def reset_epoch_acc(self, cls):
        self.epoch_acc.map_write()
        self.epoch_acc.mem[cls] = 0.0
        self.epoch_acc_c.map_write()
        self.epoch_acc_c.mem[cls] = 0.0

    def read_health_acc(self, cls):
        """Host fetch of one class's health row."""
        self.health_acc.map_read()
        return numpy.array(self.health_acc.mem[cls])

    def reset_health_acc(self, cls):
        self.health_acc.map_write()
        self.health_acc.mem[cls] = 0.0
