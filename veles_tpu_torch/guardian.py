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
  tick, so nothing is re-traced); ``rollback`` — restores every
  trainable and optimizer-state Vector in-process from the newest
  snapshot generation that verifies, loads and is finite
  (:func:`restore_vectors`), and reshuffles the loader's train order so
  the poison batch order is not replayed; ``off`` — observe and count
  only.

Every event increments ``resilience.stats`` counters
(``guardian.nan_ticks``, ``guardian.skipped``,
``guardian.lr_backoff``, ``guardian.rollbacks``); the deterministic
``step.nan`` chaos point makes every recovery path testable.
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


def init_parser(parser):
    """The guardian flags of the command line."""
    parser.add_argument(
        "--guardian-policy", default=None, choices=POLICIES,
        help="training health policy on NaN/loss-spike epochs: skip "
             "the poison updates in the step (default), back off the "
             "learning rate, roll back to the last good snapshot, or "
             "off (sets root.common.guardian.policy)")
    parser.add_argument(
        "--guardian-spike", type=float, default=None, metavar="K",
        help="flag a train epoch whose loss exceeds K x the rolling "
             "median as a spike (default 4.0; sets "
             "root.common.guardian.spike_factor)")
    parser.add_argument(
        "--guardian-window", type=int, default=None, metavar="N",
        help="rolling-median window in epochs for spike detection "
             "(default 5; sets root.common.guardian.window)")


def restore_vectors(dst_workflow, src_workflow):
    """Copies every matching trainable and optimizer-state Vector from
    ``src_workflow`` (an unpickled snapshot) into the live
    ``dst_workflow`` — in-process weight rollback, no restart.  Units
    pair by name, tensors by attribute; shape mismatches are skipped.
    Returns the number of tensors restored.  The copies land on the
    host copy (``Vector.mem``); the next tick uploads them.  A source
    holding optimizer slots the live run has no home for (it trained
    under another optimizer) raises."""
    from .memory import Vector
    from .znicz.optimizers import param_of_slot
    src_units = {u.name: u for u in src_workflow.units}
    restored = 0
    orphan_slots = []
    for unit in dst_workflow.units:
        src = src_units.get(unit.name)
        if src is None:
            continue
        for which in ("trainables", "tstate"):
            dst_vecs = getattr(unit, which, None)
            src_vecs = getattr(src, which, None)
            if not isinstance(dst_vecs, dict) or \
                    not isinstance(src_vecs, dict):
                continue
            if which == "tstate":
                orphan_slots.extend(
                    "%s/%s" % (unit.name, attr)
                    for attr in src_vecs
                    if param_of_slot(attr) and attr not in dst_vecs)
    if orphan_slots:
        raise ValueError(
            "rollback source holds optimizer slots the live run has no "
            "home for (%s) — it was trained under a different "
            "optimizer; nothing was restored" % ", ".join(orphan_slots))
    for unit in dst_workflow.units:
        src = src_units.get(unit.name)
        if src is None:
            continue
        for which in ("trainables", "tstate"):
            dst_vecs = getattr(unit, which, None)
            src_vecs = getattr(src, which, None)
            if not isinstance(dst_vecs, dict) or \
                    not isinstance(src_vecs, dict):
                continue
            for attr, dvec in dst_vecs.items():
                svec = src_vecs.get(attr)
                if not isinstance(dvec, Vector) or \
                        not isinstance(svec, Vector):
                    continue
                if not svec or not dvec or svec.shape != dvec.shape:
                    continue
                svec.map_read()
                dvec.mem = numpy.array(svec.mem)
                restored += 1
    return restored


class HealthGuardian(Unit, IResultProvider):
    """Watches the health rows the step accumulates and executes the
    configured policy at class-epoch boundaries.  Link it after the
    decision (after the snapshotter, when there is one)::

        guardian = HealthGuardian(wf, policy="rollback",
                                  snapshotter=snap)
        guardian.link_from(snap)
        guardian.link_attrs(wf.loader, "minibatch_class",
                            "last_minibatch", "epoch_number")

    kwargs: ``policy`` (one of :data:`POLICIES`), ``spike_factor``,
    ``window`` (median window, epochs), ``lr_backoff_factor``,
    ``min_learning_rate``, ``snapshotter`` (the rollback source;
    default the workflow's file snapshotter), ``decision`` (default
    ``workflow.decision``).
    """

    def __init__(self, workflow, **kwargs):
        self.policy = kwargs.get("policy", config_get(
            root.common.guardian.policy, "skip"))
        if self.policy not in POLICIES:
            raise ValueError(
                "unknown guardian policy %r (known: %s)"
                % (self.policy, ", ".join(POLICIES)))
        self.spike_factor = float(kwargs.get("spike_factor", config_get(
            root.common.guardian.spike_factor, 4.0)))
        self.window = int(kwargs.get("window", config_get(
            root.common.guardian.window, 5)))
        self.lr_backoff_factor = float(
            kwargs.get("lr_backoff_factor", 0.5))
        self.min_learning_rate = float(
            kwargs.get("min_learning_rate", 1e-6))
        self.snapshotter = kwargs.get("snapshotter")
        self.decision = kwargs.get("decision")
        super(HealthGuardian, self).__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.events = []
        self.rollbacks = 0
        self.lr_backoffs = 0
        self._loss_history = collections.deque(maxlen=self.window)
        self.demand("minibatch_class", "last_minibatch",
                    "epoch_number")

    def initialize(self, **kwargs):
        super(HealthGuardian, self).initialize(**kwargs)
        if self.decision is None:
            self.decision = getattr(self.workflow, "decision", None)
        if self.snapshotter is None:
            self.snapshotter = self._find_snapshotter()
        # The device gate drops non-finite updates inside the step for
        # skip/lr_backoff; rollback lets the poison land, so the
        # restore repairs a real corruption.
        self.workflow.health_device_skip = self.policy != "rollback"
        if self.policy == "rollback" and self.snapshotter is None:
            self.warning(
                "rollback policy but no snapshotter in the workflow "
                "— falling back to the skip policy (add a "
                "SnapshotterToFile, or pass snapshotter=)")
            self.policy = "skip"
            self.workflow.health_device_skip = True

    def _find_snapshotter(self):
        """The workflow's file snapshotter, when one was linked in
        (duck-typed on directory + prefix, so database backends are
        passed over: rollback restores from file generations)."""
        for unit in self.workflow.units:
            if unit is not self and \
                    getattr(unit, "directory", None) is not None and \
                    getattr(unit, "prefix", None) is not None and \
                    callable(getattr(unit, "export", None)):
                return unit
        return None

    @property
    def last_event(self):
        return self.events[-1] if self.events else None

    def health_status(self):
        """The heartbeat's ``health`` row."""
        return {"policy": self.policy,
                "events": len(self.events),
                "last_event": self.last_event,
                "rollbacks": self.rollbacks,
                "lr_backoffs": self.lr_backoffs,
                "loss_median": self.loss_median()}

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
        elif act and self.policy == "rollback":
            action = "rollback" if self.rollback() else "skipped"
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

    def rollback(self):
        """In-process weight rollback: restores Vectors from the newest
        snapshot generation that verifies, loads and holds finite
        weights, reshuffles the train order and resets the evaluator's
        accumulators.  Returns False — re-arming the device skip gate —
        when no usable generation exists (the poison hit before the
        first snapshot)."""
        from .snapshotter import (SnapshotterToFile, iter_generations,
                                  workflow_is_finite)
        snap = self.snapshotter
        directory = getattr(snap, "directory", None)
        candidates = list(iter_generations(
            directory, snap.prefix)) if directory else []
        for path in candidates:
            try:
                source = SnapshotterToFile.import_(path)
            except Exception as e:
                self.warning("rollback: cannot use %s (%s) — trying "
                             "the previous generation", path, e)
                continue
            if not workflow_is_finite(source):
                self.warning("rollback: %s holds non-finite weights "
                             "— trying the previous generation", path)
                continue
            restored = restore_vectors(self.workflow, source)
            loader = getattr(self.workflow, "loader", None)
            if loader is not None and hasattr(loader, "shuffle"):
                # Replaying the batch order that produced the poison
                # would poison the restored weights again.
                loader.shuffle()
            evaluator = getattr(self.decision, "evaluator", None)
            if evaluator is not None:
                for cls in range(3):
                    evaluator.reset_epoch_acc(cls)
                    evaluator.reset_health_acc(cls)
            self.rollbacks += 1
            resilience.stats.incr("guardian.rollbacks")
            self.info("rolled back %d tensors from %s and reshuffled "
                      "the train order", restored, path)
            return True
        # Nothing to restore from: the weights may hold the poison (the
        # gate was off).  Re-arm the gate so no further poison lands.
        self.warning("rollback requested but no usable snapshot "
                     "exists%s — weights may be poisoned; re-arming "
                     "the device skip gate",
                     "" if candidates else " (no generations found)")
        self.workflow.health_device_skip = True
        compiler = getattr(self.workflow, "_compiler_", None)
        if compiler is not None:
            compiler.invalidate()
        resilience.stats.incr("guardian.skipped")
        return False

    def get_metric_names(self):
        return ["guardian_events", "guardian_rollbacks"]

    def get_metric_values(self):
        return {"guardian_events": len(self.events),
                "guardian_rollbacks": self.rollbacks}
