"""Loss evaluator base (the JAX package's ``znicz.evaluator``).

The evaluator closes the forward chain: it computes the scalar loss
(``ctx.set_loss``, differentiated by the step) and the batch metrics
that the Decision unit consumes, and adds them into ON-DEVICE epoch
accumulators inside the step, so the host reads them once per
class-epoch.  Here: the base, the masked softmax cross-entropy
(:class:`EvaluatorSoftmax`, with optional per-sample probability
capture) and the masked mean-squared error (:class:`EvaluatorMSE`); the
LM evaluator is ``znicz.attention.EvaluatorLM``.
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


class EvaluatorSoftmax(EvaluatorBase):
    """Masked softmax cross-entropy from the logits, and the error
    count.

    Links: ``input`` ← the softmax layer's ``logits``; ``labels`` ← the
    loader's ``minibatch_labels``; ``mask`` ← ``minibatch_mask``.
    """

    def __init__(self, workflow, **kwargs):
        super(EvaluatorSoftmax, self).__init__(workflow, **kwargs)
        self.labels = None
        # Per-sample probability capture: a (total_samples + 1,
        # n_classes) device buffer written at the minibatch indices
        # inside the step; the extra row takes the padded lanes.
        self.capture_outputs = False
        self.sample_indices = None
        self.capture = Vector()
        self.demand("labels", "mask", "minibatch_class_vec")

    def enable_capture(self, loader):
        """Arms probability capture (after initialize: the width comes
        from the allocated logits); the step picks the new state tensor
        up at its next fingerprint check."""
        self.capture_outputs = True
        self.sample_indices = loader.minibatch_indices
        width = int(self.input.shape[-1])
        self.capture.mem = numpy.zeros(
            (loader.total_samples + 1, width), dtype=numpy.float32)

    def read_capture(self):
        """Host copy of the captured per-sample probabilities (the trash
        row stripped)."""
        self.capture.map_read()
        return numpy.array(self.capture.mem[:-1])

    @property
    def tstate(self):
        state = dict(super(EvaluatorSoftmax, self).tstate)
        if self.capture_outputs and self.capture:
            state["capture"] = self.capture
        return state

    def tforward(self, read, write, params, ctx, state=None):
        logits = read(self.input)
        labels = read(self.labels).long()
        mask = read(self.mask)
        n_valid = torch.clamp_min(mask.sum(), 1.0)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
        loss = (nll * mask).sum() / n_valid
        pred = torch.argmax(logits, dim=-1)
        n_err = ((pred != labels).float() * mask).sum()
        ctx.set_loss(loss)
        ctx.add_metric("n_err", n_err)
        ctx.add_metric("n_valid", mask.sum())
        updates = self._accumulate(read, state, n_err, mask.sum(), loss)
        if state is not None and "capture" in state:
            idx = read(self.sample_indices).long()
            trash = state["capture"].shape[0] - 1
            safe = torch.where(mask > 0, idx, torch.full_like(idx, trash))
            updates = dict(updates or {})
            updates["capture"] = state["capture"].index_put(
                (safe,), torch.exp(logp) * mask[:, None])
        return updates


class EvaluatorMSE(EvaluatorBase):
    """Masked mean squared error against ``target`` (or, when the
    loader serves no targets, against ``fallback_target`` — usually the
    input, for autoencoders).  ``OWNS_LOSS = False`` subclasses compute
    the metrics without claiming the step's loss."""

    OWNS_LOSS = True

    def __init__(self, workflow, **kwargs):
        super(EvaluatorMSE, self).__init__(workflow, **kwargs)
        self.target = None
        self.fallback_target = None
        self.root_metric = kwargs.get("root", True)
        self.demand("target", "mask", "minibatch_class_vec")

    def tforward(self, read, write, params, ctx, state=None):
        tgt = self.target
        if not tgt and self.fallback_target is not None:
            tgt = self.fallback_target
        y = read(self.input).float()
        t = read(tgt).float()
        mask = read(self.mask)
        batch = y.shape[0]
        n_valid = torch.clamp_min(mask.sum(), 1.0)
        se = ((y.reshape(batch, -1) - t.reshape(batch, -1)) ** 2).sum(1)
        loss = (se * mask).sum() / n_valid
        if self.OWNS_LOSS:
            ctx.set_loss(loss)
        ctx.add_metric("mse", torch.sqrt(loss) if self.root_metric
                       else loss)
        ctx.add_metric("n_valid", mask.sum())
        # The error column carries the summed squared error, so the
        # decision can report the epoch's MSE.
        return self._accumulate(read, state, (se * mask).sum(),
                                mask.sum(), loss)
