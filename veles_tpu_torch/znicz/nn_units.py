"""Base classes of the neural-network layer units (the JAX package's
``znicz.nn_units``).

* :class:`ForwardBase` — a forward layer with ``input``/``output``
  Vectors and optional ``weights``/``bias`` trainables;
* :class:`GradientDescentBase` — the per-layer trainer unit holding the
  update hyperparameters and optimizer slots; the backward comes from
  autograd over the composed forward, and the unit applies its
  optimizer's rule inside the same step.

The worker-sync and ZeRO wire methods of the JAX package's units
belong to the distributed control plane (ROADMAP A7) and are not here.
"""

import numpy
import torch

from .. import prng
from ..accelerated_units import TracedUnit
from ..config import root, get as config_get
from ..memory import Vector
from ..registry import MappedUnitRegistry
from . import optimizers


#: znicz scaled-tanh constants (1.7159·tanh(0.6666·x)).
TANH_A = 1.7159
TANH_B = 0.6666


# -- shared activation bodies (the all2all, conv and standalone
# activation families) ---------------------------------------------------


def act_tanh(v):
    return TANH_A * torch.tanh(TANH_B * v)


def act_softplus(v):
    """znicz "RELU": log(1 + e^x)."""
    return torch.nn.functional.softplus(v)


def act_strict_relu(v):
    """max(x, 0); a tie at 0 sends half the gradient each way, as
    ``jnp.maximum`` does (``torch.relu`` would send none)."""
    return torch.maximum(v, torch.zeros_like(v))


def act_sigmoid(v):
    return torch.sigmoid(v)


def dot(a, w, cdt):
    """``a @ w`` with both operands rounded to ``cdt`` and a float32
    result — the JAX package's ``jnp.dot(a.astype(cdt), w.astype(cdt),
    preferred_element_type=float32)``."""
    return torch.matmul(a.to(cdt).float(), w.to(cdt).float())


class ForwardUnitRegistry(MappedUnitRegistry):
    """String → forward-layer class."""
    registry = {}


class GDUnitRegistry(MappedUnitRegistry):
    """String → trainer class, under the MAPPING of its forward
    layer."""
    registry = {}


def gd_for(layer_or_mapping):
    """The GD unit class paired with a forward layer (by its MAPPING
    string)."""
    mapping = getattr(layer_or_mapping, "MAPPING", layer_or_mapping)
    return GDUnitRegistry.get_factory(mapping)


class ForwardBase(TracedUnit, metaclass=ForwardUnitRegistry):
    """A forward layer unit."""

    hide_from_registry = True

    #: Whether this layer type owns trainable parameters — static, so
    #: workflow builders can pair GD units before weights exist.
    HAS_PARAMS = True

    def __init__(self, workflow, **kwargs):
        super(ForwardBase, self).__init__(workflow, **kwargs)
        self.view_group = "WORKER"
        self.input = None            # linked Vector
        self.output = Vector()
        self.weights = Vector()
        self.bias = Vector()
        self.include_bias = kwargs.get("include_bias", True)
        self.weights_stddev = kwargs.get("weights_stddev")
        self.bias_stddev = kwargs.get("bias_stddev")
        self.prng_key = kwargs.get("prng_key", 0)
        self.demand("input")

    @property
    def trainables(self):
        t = {}
        if self.weights:
            t["weights"] = self.weights
        if self.include_bias and self.bias:
            t["bias"] = self.bias
        return t

    @property
    def compute_dtype(self):
        """Activation-stream dtype (see
        ``accelerated_units.step_compute_dtype``)."""
        from ..accelerated_units import step_compute_dtype
        return step_compute_dtype()

    def rand(self):
        return prng.get(self.prng_key)


class GradientDescentBase(TracedUnit, metaclass=GDUnitRegistry):
    """Per-layer trainer: hyperparameters and optimizer slots for its
    ``target`` forward unit; ``tupdate`` runs inside the step with the
    autograd gradient and delegates to the registered optimizer."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(GradientDescentBase, self).__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        self.target = kwargs.get("target")
        #: Update rule (optimizers registry).  An explicit kwarg pins
        #: it against the ``root.common.engine.optimizer`` override.
        self.optimizer = kwargs.get("optimizer") or config_get(
            root.common.engine.optimizer, "sgd")
        self._optimizer_explicit = "optimizer" in kwargs
        optimizers.get(self.optimizer)  # validate early
        #: Adam/Lion coefficients + epsilon; None = the optimizer's
        #: own default.
        self.beta1 = kwargs.get("beta1")
        self.beta2 = kwargs.get("beta2")
        self.eps = kwargs.get("eps")
        self.learning_rate = kwargs.get("learning_rate", 0.01)
        self.learning_rate_bias = kwargs.get(
            "learning_rate_bias", self.learning_rate)
        # L2 weight decay.
        self.weights_decay = kwargs.get("weights_decay", 0.0)
        self.weights_decay_bias = kwargs.get("weights_decay_bias", 0.0)
        # Momentum.
        self.gradient_moment = kwargs.get("gradient_moment", 0.0)
        self.gradient_moment_bias = kwargs.get(
            "gradient_moment_bias", self.gradient_moment)
        self._velocities = {}

    @property
    def tstate(self):
        return dict(self._velocities)

    @property
    def optimizer_obj(self):
        return optimizers.get(self.optimizer)

    def initialize(self, device=None, **kwargs):
        super(GradientDescentBase, self).initialize(
            device=device, **kwargs)
        if self.target is None:
            raise ValueError("%s has no target forward unit" % self)
        if not self.target.is_initialized:
            # Requeued by Workflow.initialize until the target's
            # weights exist.
            raise AttributeError(
                "%s: target %s not initialized yet" %
                (self.name, self.target.name))
        override = config_get(root.common.engine.optimizer, None)
        if override and not self._optimizer_explicit:
            optimizers.get(override)
            self.optimizer = override
        opt = self.optimizer_obj
        stale = sorted(
            s for s in self._velocities
            if not any(s.startswith(p) for p in opt.SLOT_PREFIXES))
        if stale:
            raise optimizers.SlotMismatchError(
                "%s holds optimizer slots %s that do not belong to "
                "optimizer %r (its slot prefixes: %s)"
                % (self.name, stale, self.optimizer,
                   ", ".join(opt.SLOT_PREFIXES) or "none"))
        for attr, vec in self.target.trainables.items():
            for slot, shape, dtype in opt.slots(attr, vec, self):
                if slot not in self._velocities:
                    v = Vector(numpy.zeros(shape, dtype=dtype))
                    v.initialize(self.device)
                    self._velocities[slot] = v

    def _hyper(self, attr):
        """(learning rate, weight decay, momentum) of ``attr``: the
        bias trio for "bias", the main trio otherwise."""
        if attr == "bias":
            return (self.learning_rate_bias, self.weights_decay_bias,
                    self.gradient_moment_bias)
        return (self.learning_rate, self.weights_decay,
                self.gradient_moment)

    def _hyper_dict(self, attr):
        """The hyperparameter dict handed to the optimizer's rule."""
        lr, decay, moment = self._hyper(attr)
        out = {"learning_rate": lr, "weights_decay": decay,
               "gradient_moment": moment}
        defaults = self.optimizer_obj.HYPER_DEFAULTS
        for name in ("beta1", "beta2", "eps"):
            own = getattr(self, name, None)
            out[name] = defaults.get(name) if own is None else own
        return out

    def tupdate(self, attr, param, grad, state, ctx):
        """Applies this unit's optimizer rule to one parameter."""
        return self.optimizer_obj.update(attr, param, grad, state,
                                         self._hyper_dict(attr))
