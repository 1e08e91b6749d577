"""Optimizer registry of the fused training step (the JAX package's
``znicz.optimizers``).

Every optimizer declares its slot names — ``velocity_<param>``,
``adam_m_<param>``, … — and per-slot dtypes; slots are ordinary
``tstate`` Vectors of the gradient-descent units, with the JAX
package's names, so :func:`~veles_tpu_torch.accelerated_units.
params_from_numpy` carries them across.  The update rule is a function
``update(attr, param, grad, state, hyper, traced=False) -> (new_param,
new_slots)`` of device tensors and Python-float hyperparameters — or,
with ``traced``, 0-dim tensors (the vmapped population step, where a
hyperparameter is a per-member input and no Python truth test may
touch it).  Each optimizer also declares which hyperparameters it reads
(``CONSUMED_HYPERS``), which the genetics may tune beyond the classic
learning rate / decay / momentum (``EXTRA_HYPERS``), and which need a
slot to have any effect (``SLOT_BACKED_HYPERS``).

``sgd`` (momentum SGD with L2 decay, the znicz rule) is the default.
"""

import numpy
import torch

#: name → Optimizer instance (optimizers are stateless).
OPTIMIZERS = {}


class SlotMismatchError(ValueError):
    """Optimizer slots present on a unit do not belong to the optimizer
    this run is configured with."""


def register(cls):
    """Class decorator: instantiates and registers an optimizer under
    its ``NAME``."""
    OPTIMIZERS[cls.NAME] = cls()
    return cls


def get(name):
    """The registered optimizer, or an error naming the known ones."""
    try:
        return OPTIMIZERS[name]
    except KeyError:
        raise ValueError(
            "unknown optimizer %r (known: %s)"
            % (name, ", ".join(sorted(OPTIMIZERS)))) from None


def init_parser(parser):
    """The optimizer and ZeRO flags of the command line."""
    parser.add_argument(
        "--optimizer", default=None, choices=sorted(OPTIMIZERS),
        help="update rule for GD units that do not pin one "
             "explicitly: sgd (momentum SGD, the default), adam, adamw "
             "or lion (sets root.common.engine.optimizer; resuming a "
             "snapshot under another optimizer than it was trained "
             "with fails with a slot-mismatch error)")
    parser.add_argument(
        "--zero", type=int, default=None, choices=(0, 1, 2),
        help="ZeRO optimizer-state sharding over the mesh's data axis of "
             "a distributed run: 1 partitions the optimizer slots (each "
             "data rank keeps and updates 1/dp), 2 also reduce-scatters "
             "the gradients feeding them, 0 disables (sets "
             "root.common.engine.zero)")


def slot_prefixes():
    """Every registered slot-name prefix, longest first."""
    out = set()
    for opt in OPTIMIZERS.values():
        out.update(opt.SLOT_PREFIXES)
    return tuple(sorted(out, key=len, reverse=True))


def param_of_slot(slot_name):
    """The parameter attr a slot name mirrors (``adam_m_weights`` →
    ``weights``), or None for a name with no registered prefix."""
    for prefix in slot_prefixes():
        if slot_name.startswith(prefix):
            return slot_name[len(prefix):]
    return None


class Optimizer(object):
    """One update rule + its slot/hyperparameter declarations."""

    NAME = None
    #: Slot-name prefixes this optimizer owns (unique per kind).
    SLOT_PREFIXES = ()
    #: Hyper leaf names beyond learning_rate/weights_decay/
    #: gradient_moment that the vmapped genetics may tune.
    EXTRA_HYPERS = ()
    #: Hyper names this rule reads (tuning one no unit's optimizer
    #: reads is a configuration error).
    CONSUMED_HYPERS = ("learning_rate", "weights_decay")
    #: hyper name → slot prefix that must be allocated for the hyper to
    #: have any effect.
    SLOT_BACKED_HYPERS = {}
    #: Defaults of beta1/beta2/eps when the GD unit does not set them.
    HYPER_DEFAULTS = {}

    def slots(self, attr, vec, gd):
        """Slot declarations for parameter ``attr`` (its Vector
        ``vec``) on GD unit ``gd``: yields ``(name, shape, dtype)``."""
        return ()

    def update(self, attr, param, grad, state, hyper, traced=False):
        """Returns ``(new_param, new_slots)``; ``hyper`` holds
        learning_rate/weights_decay/gradient_moment/beta1/beta2/eps —
        Python floats, or 0-dim tensors when ``traced``."""
        raise NotImplementedError()


@register
class SGD(Optimizer):
    """Momentum SGD with L2 decay: v ← μv − lr·(g + λp); p ← p + v."""

    NAME = "sgd"
    SLOT_PREFIXES = ("velocity_",)
    CONSUMED_HYPERS = ("learning_rate", "weights_decay",
                       "gradient_moment")
    SLOT_BACKED_HYPERS = {"gradient_moment": "velocity_"}

    def slots(self, attr, vec, gd):
        # Velocities exist only when the unit has any momentum at all.
        if gd.gradient_moment or gd.gradient_moment_bias:
            yield "velocity_" + attr, vec.shape, vec.dtype

    def update(self, attr, param, grad, state, hyper, traced=False):
        lr = hyper["learning_rate"]
        decay = hyper["weights_decay"]
        moment = hyper["gradient_moment"]
        slot = "velocity_" + attr
        if traced:
            # Tensor hypers: the momentum branch is decided by the
            # presence of the slot alone.
            g = grad + decay * param
            if slot in state:
                v = moment * state[slot] - lr * g
                return param + v, {slot: v}
            return param - lr * g, {}
        g = grad + decay * param if decay else grad
        if moment and slot in state:
            v = moment * state[slot] - lr * g
            return param + v, {slot: v}
        return param - lr * g, {}


@register
class Adam(Optimizer):
    """Adam: bias-corrected first/second moment EWMAs, L2 decay folded
    into the gradient.  Slots: ``adam_m_``/``adam_v_``
    (parameter-shaped, f32) and ``adam_t_`` (a scalar step count per
    parameter)."""

    NAME = "adam"
    SLOT_PREFIXES = ("adam_m_", "adam_v_", "adam_t_")
    EXTRA_HYPERS = ("beta1", "beta2", "eps")
    CONSUMED_HYPERS = ("learning_rate", "weights_decay",
                       "beta1", "beta2", "eps")
    HYPER_DEFAULTS = {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8}

    def slots(self, attr, vec, gd):
        yield "adam_m_" + attr, vec.shape, numpy.float32
        yield "adam_v_" + attr, vec.shape, numpy.float32
        yield "adam_t_" + attr, (), numpy.float32

    def _moments(self, attr, grad_eff, state, hyper):
        b1, b2 = hyper["beta1"], hyper["beta2"]
        t = state["adam_t_" + attr] + 1.0
        m = b1 * state["adam_m_" + attr] + (1.0 - b1) * grad_eff
        v = b2 * state["adam_v_" + attr] + \
            (1.0 - b2) * torch.square(grad_eff)
        mhat = m / (1.0 - b1 ** t)
        vhat = v / (1.0 - b2 ** t)
        direction = mhat / (torch.sqrt(vhat) + hyper["eps"])
        return direction, {"adam_m_" + attr: m, "adam_v_" + attr: v,
                           "adam_t_" + attr: t}

    def update(self, attr, param, grad, state, hyper, traced=False):
        lr, decay = hyper["learning_rate"], hyper["weights_decay"]
        g = grad + decay * param if (traced or decay) else grad
        direction, new_slots = self._moments(attr, g, state, hyper)
        return param - (lr * direction).to(param.dtype), new_slots


@register
class AdamW(Adam):
    """AdamW: Adam moments with DECOUPLED weight decay —
    p ← p − lr·(m̂/(√v̂+ε) + λp).  Shares Adam's slots."""

    NAME = "adamw"

    def update(self, attr, param, grad, state, hyper, traced=False):
        lr, decay = hyper["learning_rate"], hyper["weights_decay"]
        direction, new_slots = self._moments(attr, grad, state, hyper)
        step = lr * direction + (lr * decay) * param
        return param - step.to(param.dtype), new_slots


@register
class Lion(Optimizer):
    """Lion: u = sign(β1·m + (1−β1)·g); p ← p − lr·(u + λp);
    m ← β2·m + (1−β2)·g.  One slot per parameter."""

    NAME = "lion"
    SLOT_PREFIXES = ("lion_m_",)
    EXTRA_HYPERS = ("beta1", "beta2")
    CONSUMED_HYPERS = ("learning_rate", "weights_decay",
                       "beta1", "beta2")
    HYPER_DEFAULTS = {"beta1": 0.9, "beta2": 0.99}

    def slots(self, attr, vec, gd):
        yield "lion_m_" + attr, vec.shape, numpy.float32

    def update(self, attr, param, grad, state, hyper, traced=False):
        lr, decay = hyper["learning_rate"], hyper["weights_decay"]
        b1, b2 = hyper["beta1"], hyper["beta2"]
        m = state["lion_m_" + attr]
        u = torch.sign(b1 * m + (1.0 - b1) * grad)
        step = lr * u + (lr * decay) * param
        new_m = b2 * m + (1.0 - b2) * grad
        return param - step.to(param.dtype), {"lion_m_" + attr: new_m}
