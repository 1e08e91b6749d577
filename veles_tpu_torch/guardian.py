"""Training health guardian (the JAX package's ``guardian``):
non-finite and loss-spike detection at class-epoch boundaries.

* **Detection** costs no extra host sync: the step accumulates the
  tick's finiteness and gradient norm into the evaluator's
  ``health_acc`` row, which the Decision fetches with the epoch
  accumulator.  The guardian also keeps a rolling median of recent
  train losses and flags an epoch above ``spike_factor`` × median.
* **Recovery** policies: ``skip`` (default) — non-finite updates are
  dropped inside the step (the step's device gate), nothing else to
  do; ``lr_backoff`` — also multiplies every GD unit's learning rate
  by ``lr_backoff_factor`` (the port's step reads hyperparameters every
  tick, so nothing is re-traced); ``off`` — observe and count only.
  ``rollback`` restores from the snapshotter, which is not yet ported
  (ROADMAP A1): choosing it raises.

Every event increments ``resilience.stats`` counters
(``guardian.nan_ticks``, ``guardian.skipped``,
``guardian.lr_backoff``).
"""

import collections
import statistics

import numpy

from . import resilience
from .config import root, get as config_get
from .loader.base import TRAIN, CLASS_NAME
from .result_provider import IResultProvider
from .units import Unit

#: Recognized recovery policies ("off" observes and counts only).
POLICIES = ("off", "skip", "lr_backoff", "rollback")


class HealthGuardian(Unit, IResultProvider):
    """Watches the health rows the step accumulates and executes the
    configured policy at class-epoch boundaries.  Link it after the
    decision::

        guardian = HealthGuardian(wf, policy="skip")
        guardian.link_from(wf.decision)
        guardian.link_attrs(wf.loader, "minibatch_class",
                            "last_minibatch", "epoch_number")

    kwargs: ``policy`` (one of :data:`POLICIES`), ``spike_factor``,
    ``window`` (median window, epochs), ``lr_backoff_factor``,
    ``min_learning_rate``, ``decision`` (default
    ``workflow.decision``).
    """

    def __init__(self, workflow, **kwargs):
        self.policy = kwargs.get("policy", config_get(
            root.common.guardian.policy, "skip"))
        if self.policy not in POLICIES:
            raise ValueError(
                "unknown guardian policy %r (known: %s)"
                % (self.policy, ", ".join(POLICIES)))
        if self.policy == "rollback":
            raise NotImplementedError(
                "the guardian's rollback policy is not yet ported "
                "(ROADMAP A1 snapshotter)")
        self.spike_factor = float(kwargs.get("spike_factor", config_get(
            root.common.guardian.spike_factor, 4.0)))
        self.window = int(kwargs.get("window", config_get(
            root.common.guardian.window, 5)))
        self.lr_backoff_factor = float(
            kwargs.get("lr_backoff_factor", 0.5))
        self.min_learning_rate = float(
            kwargs.get("min_learning_rate", 1e-6))
        self.decision = kwargs.get("decision")
        super(HealthGuardian, self).__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.events = []
        self.lr_backoffs = 0
        self._loss_history = collections.deque(maxlen=self.window)
        self.demand("minibatch_class", "last_minibatch",
                    "epoch_number")

    def initialize(self, **kwargs):
        super(HealthGuardian, self).initialize(**kwargs)
        if self.decision is None:
            self.decision = getattr(self.workflow, "decision", None)
        self.workflow.health_device_skip = True

    @property
    def last_event(self):
        return self.events[-1] if self.events else None

    def loss_median(self):
        if not self._loss_history:
            return None
        return statistics.median(self._loss_history)

    def run(self):
        if not self.last_minibatch or self.decision is None:
            return
        self.check_class(self.minibatch_class)

    def check_class(self, cls):
        """Evaluates one class-epoch's health numbers (just fetched by
        the decision) and reacts."""
        nonfinite = float(self.decision.epoch_nonfinite[cls])
        loss = float(self.decision.epoch_loss[cls])
        if nonfinite:
            resilience.stats.incr("guardian.nan_ticks", int(nonfinite))
            # Recovery acts on train events only: eval ticks update no
            # weights.
            self.on_event("nan", cls,
                          "%d non-finite tick(s)" % int(nonfinite),
                          act=cls == TRAIN)
            return
        if cls != TRAIN:
            return
        if not numpy.isfinite(loss):
            self.on_event("nan", cls, "non-finite epoch loss")
            return
        median = self.loss_median()
        if median is not None and median > 0 and \
                loss > self.spike_factor * median:
            self.on_event(
                "spike", cls, "loss %.4g > %.3g x median %.4g"
                % (loss, self.spike_factor, median))
            return
        self._loss_history.append(loss)

    def on_event(self, kind, cls, detail, act=True):
        """Records a health event; executes the policy when ``act``."""
        self.warning("health event at epoch %d (%s %s): %s — "
                     "policy %s%s", self.epoch_number,
                     CLASS_NAME[cls], kind, detail, self.policy,
                     "" if act else " (eval class: observed only)")
        action = "observed"
        if act and self.policy == "skip":
            # The device gate already dropped the poison updates.
            action = "skipped"
            resilience.stats.incr("guardian.skipped")
        elif act and self.policy == "lr_backoff":
            action = "lr_backoff" if self.backoff_learning_rate() \
                else "skipped"
        event = {"epoch": int(self.epoch_number), "class": cls,
                 "kind": kind, "detail": detail, "action": action}
        self.events.append(event)
        return event

    def backoff_learning_rate(self):
        """Multiplies every GD unit's learning rate by
        ``lr_backoff_factor``, floored at ``min_learning_rate``."""
        from .znicz.nn_units import GradientDescentBase
        changed = False
        for unit in self.workflow.units:
            if not isinstance(unit, GradientDescentBase):
                continue
            for attr in ("learning_rate", "learning_rate_bias"):
                lr = getattr(unit, attr, None)
                if lr:
                    setattr(unit, attr,
                            max(lr * self.lr_backoff_factor,
                                self.min_learning_rate))
                    changed = True
        if not changed:
            resilience.stats.incr("guardian.skipped")
            return False
        self.lr_backoffs += 1
        resilience.stats.incr("guardian.lr_backoff")
        self.info("learning rates backed off by %.2f",
                  self.lr_backoff_factor)
        return True

    def get_metric_names(self):
        return ["guardian_events", "guardian_rollbacks"]

    def get_metric_values(self):
        return {"guardian_events": len(self.events),
                "guardian_rollbacks": 0}
