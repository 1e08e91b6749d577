"""Accelerated units and the fused training tick (the JAX package's
``accelerated_units``, local paths).

A unit in the training loop is a :class:`TracedUnit` that contributes
a function of tensors (``tforward``); the workflow runs loader gather →
forward stack → loss → backward → optimizer updates as ONE step per
tick (:class:`StepCompiler`).  Data flow between units follows shared
:class:`~veles_tpu_torch.memory.Vector` identity: the step keys its
tensor bag by ``id(vector)``.  The backward is
``torch.autograd.grad`` over the composed forward; the per-layer
gradient-descent units keep their hyperparameters and optimizer slots
and apply their update rule inside the same step.

The JAX package traces the step once and runs it as one XLA program.
Here the step runs eagerly, tick by tick — no ``torch.compile``, no
CUDA graphs — with the same structure and the same gating:

* train tick (``train_core``): forward, loss, gradients, the global
  gradient norm, the health row and the non-finite gate, then the
  updates;
* infer tick (``infer_step``): forward only; the health row records
  loss finiteness with a zero gradient-norm contribution;
* block mode (``ticks_per_dispatch`` > 1): a loop of ticks over one
  block of same-class minibatches served at once; train ticks gate
  their updates by per-tick validity (an all-zero mask) and
  finiteness.  Validation ticks run forward only — the JAX block
  program also differentiates them (and discards the result), so the
  validation row of ``health_acc`` gets no gradient norm here.

Tensors stay on the device between ticks; the host reads the epoch
accumulators at epoch boundaries (and ``step_metrics`` when asked).
"""

import numpy
import torch

from .config import root, get as config_get
from .memory import Vector, torch_device
from .units import Unit
from .workflow import Workflow


class StepContext(object):
    """Per-tick context handed to every TracedUnit: the device random
    generator, the training flag, the loss slot and the metrics."""

    def __init__(self, generator=None, training=True):
        self.generator = generator
        self.training = training
        self.loss = None
        self.aux_loss = 0.0
        self.metrics = {}

    def next_key(self):
        """The step's seeded ``torch.Generator`` (the JAX package's
        per-use subkey of the threefry chain)."""
        if self.generator is None:
            raise ValueError("step was run without a random generator")
        return self.generator

    def add_metric(self, name, value):
        self.metrics[name] = value

    def set_loss(self, value):
        self.loss = value

    def add_aux_loss(self, value):
        """Accumulates an auxiliary objective that is ADDED to the
        evaluator's loss for differentiation but kept out of the
        reported metrics."""
        self.aux_loss = self.aux_loss + value


def step_compute_dtype():
    """Activation-stream dtype of the step: bfloat16 when
    ``root.common.engine.precision_level`` is 0 (default), float32
    above."""
    level = config_get(root.common.engine.precision_level, 0)
    return torch.bfloat16 if level == 0 else torch.float32


def select_by_training(ctx, train_fn, eval_fn):
    """The train or the eval branch of a unit, by the tick's training
    flag (a Python bool in every tick the port runs, block mode
    included)."""
    return train_fn() if ctx.training else eval_fn()


class AcceleratedUnit(Unit):
    """A unit owning device-resident Vectors: ``initialize`` binds the
    device and attaches every Vector attribute to it."""

    hide_from_registry = True

    def init_unpickled(self):
        super(AcceleratedUnit, self).init_unpickled()
        self._device_ = None

    @property
    def device(self):
        return self._device_

    @device.setter
    def device(self, value):
        self._device_ = value

    def initialize(self, device=None, **kwargs):
        super(AcceleratedUnit, self).initialize(**kwargs)
        if device is not None:
            self._device_ = device
        for vec in self._own_vectors():
            vec.initialize(self._device_)

    def _own_vectors(self):
        return [v for v in self.__dict__.values()
                if isinstance(v, Vector)]


class TracedUnit(AcceleratedUnit):
    """A unit participating in the fused step.

    Subclasses implement :meth:`tforward` and declare their tensors:
    ``trainables`` (attr → Vector, differentiated and updated),
    ``tstate`` (attr → Vector, carried and updated, not
    differentiated), and ordinary Vector inputs/outputs moved through
    the ``read``/``write`` callbacks.  ``run()`` delegates to the
    workflow: the first traced unit reached in a tick runs the step,
    the rest are no-ops.
    """

    hide_from_registry = True

    @property
    def trainables(self):
        return {}

    @property
    def tstate(self):
        return {}

    def tforward(self, read, write, params, ctx, state=None):
        """``read(vec)``/``write(vec, val)`` move tensors through the
        step's bag; ``params`` maps this unit's trainable attr names to
        tensors, ``state`` its tstate attr names (None when it has
        none); returns a dict of state updates (or None)."""
        raise NotImplementedError()

    def run(self):
        wf = self.workflow
        if isinstance(wf, AcceleratedWorkflow) and wf.fused:
            wf.execute_step(trigger=self)
        else:
            self.eager_run()

    def eager_run(self):
        """Single-unit forward outside the step."""
        ctx = StepContext(training=False)

        def read(vec):
            return vec.devmem

        def write(vec, val):
            vec.devmem = val

        params = {a: v.devmem for a, v in self.trainables.items()}
        state = {a: v.devmem for a, v in self.tstate.items()}
        with torch.no_grad():
            upd = self.tforward(read, write, params, ctx,
                                state=state or None) or {}
        for a, val in upd.items():
            self.tstate[a].devmem = val


class StepCompiler(object):
    """Runs the fused step of an AcceleratedWorkflow.

    ``compile()`` analyses the graph once (forward units in dependency
    order, each one's GD unit, the loader's per-tick batch vectors and
    device-resident constants, the health-row specs); ``execute`` and
    ``execute_block`` then run ticks.  Parameters and states are keyed
    "unit_name/attr" as in the JAX package.
    """

    def __init__(self, workflow):
        self.workflow = workflow
        self.forward_units = []
        self.gd_map = {}          # forward unit -> gd unit
        self.batch_vectors = []   # Vectors fed from the host each tick
        self.const_vectors = []   # large device-resident constants
        self._compiled = None
        self._fingerprint = None

    # -- graph analysis ----------------------------------------------------

    def analyze(self):
        from .znicz.nn_units import GradientDescentBase
        wf = self.workflow
        self.forward_units = [
            u for u in wf.units_in_dependency_order
            if isinstance(u, TracedUnit) and
            not isinstance(u, GradientDescentBase)]
        self.gd_map = {u.target: u for u in wf.units
                       if isinstance(u, GradientDescentBase) and
                       u.target is not None}
        self.batch_vectors = []
        self.const_vectors = []
        for u in wf.units:
            get_bv = getattr(u, "step_batch_vectors", None)
            if get_bv is not None:
                self.batch_vectors.extend(get_bv())
            get_cv = getattr(u, "step_const_vectors", None)
            if get_cv is not None:
                self.const_vectors.extend(get_cv())

    def param_name(self, unit, attr):
        return "%s/%s" % (unit.name, attr)

    def _collect(self, which):
        out = {}
        for u in self.forward_units:
            mapping = u.trainables if which == "params" else u.tstate
            for attr, vec in mapping.items():
                out[self.param_name(u, attr)] = vec
            if which == "state":
                gd = self.gd_map.get(u)
                if gd is not None:
                    for attr, vec in gd.tstate.items():
                        out[self.param_name(gd, attr)] = vec
        return out

    def fingerprint(self):
        """Shapes/dtypes of all step tensors — the re-analysis
        trigger."""
        return tuple(
            (vec.shape, str(vec.dtype))
            for vec in (list(self._collect("params").values()) +
                        list(self._collect("state").values()) +
                        self.batch_vectors))

    def compile(self):
        self.analyze()
        self._param_vecs = self._collect("params")
        self._state_vecs = self._collect("state")
        # Health sentinel: evaluators expose a ``health_acc`` state
        # row; each tick adds [non-finite, grad-norm sum, grad-norm
        # max, ticks] at the minibatch's class.
        self._health_specs = []
        for u in self.forward_units:
            if "health_acc" in u.tstate:
                cv = getattr(u, "minibatch_class_vec", None)
                self._health_specs.append(
                    (self.param_name(u, "health_acc"),
                     str(id(cv)) if cv is not None else None))
        # Non-finite updates are dropped on the device unless the
        # workflow wants the poison to land.
        self._device_skip = bool(getattr(self.workflow,
                                         "health_device_skip", True))
        self._fingerprint = self.fingerprint()
        self._compiled = True

    # -- the tick ----------------------------------------------------------

    def _run_forward(self, params, states, batch, consts, ctx):
        bag = {}
        for vec in self.batch_vectors:
            bag[id(vec)] = batch[str(id(vec))]
        for vec in self.const_vectors:
            bag[id(vec)] = consts[str(id(vec))]
        pname = self.param_name
        # Trainables are readable by OTHER units through the bag (the
        # tied LM head reads the embedding); gradient flows because
        # these are the differentiated inputs.
        for u in self.forward_units:
            for a, vec in u.trainables.items():
                bag[id(vec)] = params[pname(u, a)]

        def read(vec):
            try:
                return bag[id(vec)]
            except KeyError:
                raise KeyError(
                    "step read of vector %r not yet produced — check "
                    "that control links imply data order" % vec)

        def write(vec, val):
            bag[id(vec)] = val

        new_states = dict(states)
        for u in self.forward_units:
            uparams = {a: params[pname(u, a)] for a in u.trainables}
            ustate = {a: states[pname(u, a)] for a in u.tstate}
            upd = u.tforward(read, write, uparams, ctx,
                             state=ustate or None) or {}
            for a, val in upd.items():
                new_states[pname(u, a)] = val
        metrics = dict(ctx.metrics)
        loss = ctx.loss
        if loss is not None:
            metrics["loss"] = loss
            loss = loss + ctx.aux_loss
        return loss, metrics, new_states

    @staticmethod
    def global_grad_norm(grads):
        """sqrt(Σ g²) over every gradient, in the JAX package's (sorted
        key) order."""
        total = None
        for name in sorted(grads):
            term = torch.sum(torch.square(grads[name].float()))
            total = term if total is None else total + term
        return torch.sqrt(total)

    def _health_update(self, new_states, batch, gnorm, loss,
                       valid=None):
        """Adds this tick's health row — [non-finite, gnorm sum, gnorm
        max, ticks] at the minibatch's class — and returns the tick's
        finite flag (a bool tensor).  ``valid`` gates the whole row, so
        padded ticks neither count as healthy nor dilute the mean; a
        non-finite tick always counts."""
        finite = torch.isfinite(gnorm)
        if loss is not None:
            finite = finite & torch.isfinite(loss)
        f32 = finite.float()
        v = torch.ones((), device=gnorm.device) if valid is None else \
            (valid | ~finite).float()
        safe_gnorm = torch.where(finite, gnorm, torch.zeros_like(gnorm)) \
            * v
        for state_key, cvid in self._health_specs:
            acc = new_states[state_key]
            if cvid is not None and cvid in batch:
                cls = batch[cvid].long().reshape(1)
            else:
                cls = torch.full((1,), 2, dtype=torch.long,
                                 device=acc.device)  # TRAIN
            row = torch.stack([(1.0 - f32) * v, safe_gnorm,
                               torch.zeros_like(safe_gnorm), v])
            acc = acc.index_add(0, cls, row[None].to(acc.dtype))
            hit = torch.arange(acc.shape[0], device=acc.device) == cls
            col = acc[:, 2]
            acc = torch.cat([
                acc[:, :2],
                torch.where(hit, torch.maximum(col, safe_gnorm),
                            col)[:, None],
                acc[:, 3:]], dim=1)
            new_states[state_key] = acc
        return finite

    def _apply_updates(self, params, grads, new_states, gate):
        """Runs every GD unit's update rule; ``gate`` (None or a bool
        tensor) keeps the old values where it is False."""
        pname = self.param_name
        new_params = dict(params)
        for u in self.forward_units:
            gd = self.gd_map.get(u)
            if not u.trainables or gd is None:
                continue
            for attr in u.trainables:
                key = pname(u, attr)
                gstate = {a: new_states[pname(gd, a)] for a in gd.tstate}
                new_p, new_gs = gd.tupdate(attr, params[key], grads[key],
                                           gstate, None)
                if gate is not None:
                    new_p = torch.where(gate, new_p, params[key])
                new_params[key] = new_p
                for a, val in new_gs.items():
                    if gate is not None:
                        val = torch.where(gate, val,
                                          new_states[pname(gd, a)])
                    new_states[pname(gd, a)] = val
        return new_params, new_states

    def _train_tick(self, params, states, batch, consts, generator,
                    block=False):
        """``train_core`` (and, with ``block``, the body of
        ``block_core``): returns (new_params, new_states, metrics)."""
        ctx = StepContext(generator=generator, training=True)
        names = list(params)
        with torch.enable_grad():
            leaves = {n: params[n].detach().requires_grad_(True)
                      for n in names}
            loss, metrics, new_states = self._run_forward(
                leaves, states, batch, consts, ctx)
            if loss is None:
                raise ValueError(
                    "no unit called ctx.set_loss() — an evaluator must "
                    "be present in the step's chain")
            grads = torch.autograd.grad(
                loss, [leaves[n] for n in names], allow_unused=True)
        with torch.no_grad():
            grads = {n: torch.zeros_like(params[n]) if g is None else g
                     for n, g in zip(names, grads)}
            metrics = {k: v.detach() if isinstance(v, torch.Tensor)
                       else v for k, v in metrics.items()}
            new_states = {k: v.detach() for k, v in new_states.items()}
            nv = metrics.get("n_valid")
            valid = None if nv is None else nv > 0
            gate = valid if block else None
            if self._health_specs:
                gnorm = self.global_grad_norm(grads)
                metrics["grad_norm"] = gnorm
                finite = self._health_update(
                    new_states, batch, gnorm, metrics.get("loss"),
                    valid=valid)
                metrics["step_finite"] = finite
                if self._device_skip:
                    gate = finite if gate is None else gate & finite
            new_params, new_states = self._apply_updates(
                params, grads, new_states, gate)
        return new_params, new_states, metrics

    def _infer_tick(self, params, states, batch, consts, generator):
        """``infer_step``: returns (new_states, metrics)."""
        ctx = StepContext(generator=generator, training=False)
        with torch.no_grad():
            loss, metrics, new_states = self._run_forward(
                params, states, batch, consts, ctx)
            if self._health_specs and loss is not None:
                nv = metrics.get("n_valid")
                self._health_update(
                    new_states, batch, torch.zeros((), device=loss.device),
                    loss, valid=None if nv is None else nv > 0)
        return new_states, metrics

    # -- execution ---------------------------------------------------------

    def _ensure_compiled(self):
        if not self._compiled or self.fingerprint() != self._fingerprint:
            self.compile()

    def _device(self):
        for vec in self._param_vecs.values():
            return torch_device(vec.device)
        return torch.device("cpu")

    def _generator(self):
        from . import prng
        return prng.get().torch_generator(self._device())

    def _tick(self, batch, training, block=False):
        params = {n: v.devmem for n, v in self._param_vecs.items()}
        states = {n: v.devmem for n, v in self._state_vecs.items()}
        consts = {str(id(v)): v.devmem for v in self.const_vectors}
        if training:
            new_params, new_states, metrics = self._train_tick(
                params, states, batch, consts, self._generator(), block)
            for n, v in self._param_vecs.items():
                v.devmem = new_params[n]
        else:
            new_states, metrics = self._infer_tick(
                params, states, batch, consts, self._generator())
        for n, v in self._state_vecs.items():
            v.devmem = new_states[n]
        return metrics

    def execute(self, training=True):
        """Runs one tick on the loader's current minibatch; returns its
        metrics (device tensors)."""
        self._ensure_compiled()
        batch = {str(id(v)): v.devmem for v in self.batch_vectors}
        return self._tick(batch, training)

    def execute_block(self, blocks, training):
        """Runs K stacked ticks; ``blocks`` maps batch vector id →
        (K, ...) array.  One upload per block; every tick's metrics
        stay on the device (the evaluator's epoch accumulator)."""
        self._ensure_compiled()
        device = self._device()
        blocks = {k: torch.as_tensor(numpy.ascontiguousarray(v))
                  .to(device) for k, v in blocks.items()}
        ticks = next(iter(blocks.values())).shape[0] if blocks else 1
        for t in range(ticks):
            self._tick({k: v[t] for k, v in blocks.items()}, training,
                       block=True)
        return {}


class AcceleratedWorkflow(Workflow):
    """Workflow whose traced inner loop runs as one step per tick."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(AcceleratedWorkflow, self).__init__(workflow, **kwargs)
        self.fused = kwargs.get("fused", True)
        #: > 1 enables block mode: this many minibatches per dispatch.
        self.ticks_per_dispatch = kwargs.get("ticks_per_dispatch", 1)
        #: Weights frozen: every tick runs the infer step.
        self.frozen = kwargs.get("frozen", False)
        self.step_metrics = {}

    def init_unpickled(self):
        super(AcceleratedWorkflow, self).init_unpickled()
        self._compiler_ = None
        self._tick_id_ = 0
        self._step_done_tick_ = -1

    @property
    def compiler(self):
        if self._compiler_ is None:
            self._compiler_ = StepCompiler(self)
        return self._compiler_

    def begin_tick(self):
        """Called by the loader at the start of every minibatch tick."""
        self._tick_id_ += 1

    @property
    def training(self):
        """Whether the current tick is a training minibatch (the
        loader's flag; ``frozen`` forces inference)."""
        if self.frozen:
            return False
        for u in self.units:
            is_train = getattr(u, "minibatch_is_training", None)
            if is_train is not None:
                return bool(is_train)
        return True

    def execute_step(self, trigger):
        """Runs the step exactly once per tick, whichever traced unit
        fires first."""
        if self._step_done_tick_ == self._tick_id_:
            return
        self._step_done_tick_ = self._tick_id_
        self.step_metrics = self.compiler.execute(training=self.training)

    def execute_block(self, blocks, training=None):
        """Dispatches a stacked block of ticks."""
        if self._step_done_tick_ == self._tick_id_:
            return
        self._step_done_tick_ = self._tick_id_
        if training is None:
            training = self.training
        self.compiler.execute_block(blocks, training)
        self.step_metrics = {}


def params_from_numpy(workflow, arrays):
    """Loads parameters and optimizer slots into a port workflow from
    ``{unit.name: {attr: ndarray}}`` — e.g. the JAX package's workflow
    of the same construction, read from its Vectors with ``map_read``.
    ``attr`` names a trainable or a ``tstate`` entry (optimizer slots
    of a GD unit, accumulators).  Shapes must match; an unknown unit or
    attribute raises.  Returns the workflow."""
    by_name = {u.name: u for u in workflow.units}
    for unit_name, attrs in arrays.items():
        unit = by_name.get(unit_name)
        if unit is None:
            raise KeyError("workflow %s has no unit %r" %
                           (workflow.name, unit_name))
        vectors = dict(getattr(unit, "tstate", {}))
        vectors.update(getattr(unit, "trainables", {}))
        for attr, arr in attrs.items():
            vec = vectors.get(attr)
            if vec is None:
                raise KeyError("unit %s has no parameter or state %r" %
                               (unit_name, attr))
            arr = numpy.asarray(arr)
            if tuple(arr.shape) != tuple(vec.shape):
                raise ValueError("%s/%s: shape %s, expected %s" % (
                    unit_name, attr, arr.shape, vec.shape))
            vec.mem = arr.astype(vec.dtype, copy=True)
    return workflow
