"""Config-driven model workflow builder (the JAX package's
``znicz.standard_workflow``): a training workflow assembled from a
declarative ``layers`` list — each entry a dict with the layer's
registry ``type`` string, forward kwargs under ``"->"`` and trainer
kwargs under ``"<-"`` — plus a loader (by registry name or class), an
evaluator chosen by ``loss_function`` ("softmax", "mse" or "lm"), a
DecisionGD, the snapshotter (when a snapshot directory is configured)
and the health guardian.  The assembled graph::

    start → repeater → loader → forwards… → evaluator → decision
          → [snapshotter] → guardian → gd chain (output-first)
          → repeater (until decision.complete)

and every tick runs as one step (``accelerated_units.StepCompiler``).
"""

from ..accelerated_units import AcceleratedWorkflow
from ..config import root, get as config_get
from ..guardian import HealthGuardian
from ..loader.base import UserLoaderRegistry
from ..plumbing import Repeater
from ..snapshotter import link_snapshotter
from .decision import DecisionGD
from .evaluator import EvaluatorSoftmax, EvaluatorMSE
from .nn_units import ForwardUnitRegistry, gd_for


class StandardWorkflow(AcceleratedWorkflow):
    """Declarative layers → full training workflow."""

    def __init__(self, workflow, layers=None, loader_name=None,
                 loader_cls=None, loader_config=None,
                 decision_config=None, guardian_config=None,
                 snapshotter_config=None, loss_function="softmax",
                 **kwargs):
        super(StandardWorkflow, self).__init__(workflow, **kwargs)
        self.layer_configs = list(layers or [])
        self.loss_function = loss_function

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        if loader_cls is None:
            loader_cls = UserLoaderRegistry.get_factory(loader_name)
        self.loader = loader_cls(self, **dict(loader_config or {}))
        self.loader.link_from(self.repeater)

        self.forwards = []
        self.link_forwards()

        self.evaluator = self.link_evaluator()
        self.decision = self.link_decision(
            **dict(decision_config or {}))
        self.snapshotter = link_snapshotter(
            self, self.decision, **dict(snapshotter_config or {}))
        self.guardian = self.link_guardian(
            **dict(guardian_config or {}))
        self.gds = self.link_gds()

        last_gd = self.gds[-1] if self.gds else \
            (self.guardian or self.snapshotter or self.decision)
        self.repeater.link_from(last_gd)
        self.repeater.gate_block = self.decision.complete
        self.end_point.link_from(last_gd)
        self.end_point.gate_block = ~self.decision.complete

    def first_source(self):
        """(unit, vector) feeding the first layer — overridable to
        insert preprocessing units (AlexNet's mean-disp normalizer)."""
        return self.loader, self.loader.minibatch_data

    def link_forwards(self):
        prev, prev_vec = self.first_source()
        for i, cfg in enumerate(self.layer_configs):
            cfg = dict(cfg)
            type_name = cfg.pop("type")
            fwd_kwargs = dict(cfg.get("->", cfg.get("forward", {})))
            cls = ForwardUnitRegistry.get_factory(type_name)
            unit = cls(self, name="%s%d" % (type_name, i), **fwd_kwargs)
            unit.link_from(prev)
            unit.input = prev_vec
            self.forwards.append(unit)
            prev, prev_vec = unit, unit.output
        return self.forwards

    def link_evaluator(self):
        last = self.forwards[-1]
        if self.loss_function == "softmax":
            ev = EvaluatorSoftmax(self)
            # The pre-activation logits when the layer has them.
            ev.input = last.logits if hasattr(last, "logits") \
                else last.output
            ev.labels = self.loader.minibatch_labels
        elif self.loss_function == "mse":
            ev = EvaluatorMSE(self)
            ev.input = last.output
            ev.target = self.loader.minibatch_targets
            ev.fallback_target = self.loader.minibatch_data
        elif self.loss_function == "lm":
            from .attention import EvaluatorLM
            ev = EvaluatorLM(self)
            ev.input = last.output
            ev.labels = self.loader.minibatch_labels
        else:
            raise ValueError("unknown loss_function %r" %
                             self.loss_function)
        ev.link_from(last)
        ev.mask = self.loader.minibatch_mask
        ev.minibatch_class_vec = self.loader.minibatch_class_vec
        return ev

    def link_decision(self, **decision_config):
        decision = DecisionGD(self, evaluator=self.evaluator,
                              **decision_config)
        decision.link_from(self.evaluator)
        decision.link_attrs(
            self.loader, "minibatch_class", "last_minibatch",
            "epoch_ended", "epoch_number")
        return decision

    def link_guardian(self, **guardian_config):
        """The health guardian between the decision (or the
        snapshotter, its rollback source) and the GD chain; None when
        the policy is "off" (``guardian_config={"policy": "off"}`` or
        ``root.common.guardian.policy``)."""
        policy = guardian_config.get("policy", config_get(
            root.common.guardian.policy, "skip"))
        if policy == "off":
            return None
        guardian = HealthGuardian(self, decision=self.decision,
                                  snapshotter=self.snapshotter,
                                  **guardian_config)
        guardian.link_from(self.snapshotter or self.decision)
        guardian.link_attrs(
            self.loader, "minibatch_class", "last_minibatch",
            "epoch_number")
        return guardian

    def link_gds(self):
        """One trainer per trainable layer, output-first."""
        gds = []
        prev = self.guardian or self.snapshotter or self.decision
        for i in reversed(range(len(self.layer_configs))):
            layer = self.forwards[i]
            if not type(layer).HAS_PARAMS:
                continue
            cfg = dict(self.layer_configs[i])
            gd_kwargs = dict(cfg.get("<-", cfg.get("gd", {})))
            gd = gd_for(type(layer))(self, target=layer,
                                     name="gd_" + layer.name, **gd_kwargs)
            gd.link_from(prev)
            gds.append(gd)
            prev = gd
        return gds
