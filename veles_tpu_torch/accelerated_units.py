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
  validation row of ``health_acc`` gets no gradient norm here;
* hyperparameter overrides (``execute``/``execute_block`` with
  ``hypers``, :meth:`StepCompiler._hyper_program`): the GD units'
  learning rate, decay, momentum or betas come from a float32 tensor
  instead of the units' Python floats — one population member's genes;
* under a mesh (``workflow.mesh``, :mod:`.parallel`): every rank runs
  the same tick on its slice of the placements — batch vectors split on
  the data axis, each parameter's local shard (gathered, differentiably,
  for units that do not take shards themselves), the loss scaled by
  ``1 / ranks`` and each gradient summed over the ranks holding copies
  of its shard, the update on the shard (on a ZeRO partition of it,
  then all-gathered); each placed parameter and state stays this rank's
  shard between ticks (``Vector.hold``) and is gathered to full size
  only when a full copy is read (:meth:`StepCompiler.gather_state`);
* the population block (:meth:`StepCompiler.compile_population`):
  ``torch.func.vmap`` of one tick over a leading member axis of the
  parameters, the states and the hyperparameter vectors, with the
  minibatch, the constants and the random generator shared by every
  member (``randomness="same"``: all members draw the same dropout
  masks, as the JAX package's broadcast key gives them).  Its train
  tick differentiates with ``torch.func.grad`` over the same forward
  (``torch.autograd.grad`` does not compose with ``vmap``); the health
  row, the non-finite gate and the epoch accumulators are per member.

Tensors stay on the device between ticks; the host reads the epoch
accumulators at epoch boundaries (and ``step_metrics`` when asked).

On the data plane (``server``, ``client``) an :class:`AcceleratedWorkflow`
is either the master — it serves jobs (the loader's indices, the
trainables) from ``generate_data_for_slave``, folds the workers' updates
and metrics back in ``apply_data_from_slave`` and closes each (epoch,
class) bucket of its decision once every job of it is answered — or a
worker, whose ``do_job`` runs a job's ticks: one tick, or a multi-tick
job as one block (``--job-ticks``).
"""

import numpy
import torch

from . import resilience
from .config import root, get as config_get
from .memory import Vector, torch_device
from .units import Unit
from .workflow import Workflow


class StepContext(object):
    """Per-tick context handed to every TracedUnit: the device random
    generator, the training flag, the loss slot and the metrics."""

    def __init__(self, generator=None, training=True, batch_group=None):
        self.generator = generator
        self.training = training
        #: The process group the minibatch is split over (a mesh's data
        #: axis), or None.
        self.batch_group = batch_group
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

    def batch_sum(self, value):
        """``value`` summed over the ranks that split the minibatch
        (differentiably); the value itself without a mesh.  Evaluators
        sum their per-sample terms through it, so the loss and the
        counts are the whole minibatch's on every rank."""
        if self.batch_group is None:
            return value
        from .parallel import collectives
        return collectives.all_reduce(value, self.batch_group)

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
        self.persist_vectors = []  # unit outputs kept after the tick
        self._outputs = {}
        self._compiled = None
        self._fingerprint = None
        self._hyper_vals_ = {}    # (names, values) -> hyper vector
        self._hyper_progs_ = {}   # (mode, names) -> program
        self._view = None         # this rank's view of the mesh
        self._held = {}           # placed shards between ticks
        self._scattered = set()   # ZeRO-2 gradients kept partitioned
        self._pin_ = None         # a population job's step stream
        # Per-geometry FLOP count for the live MFU gauge
        # (observability.attribution); 0 = tried, unavailable.
        self._step_flops_ = {}

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
        self.persist_vectors = []
        for u in wf.units:
            get_bv = getattr(u, "step_batch_vectors", None)
            if get_bv is not None:
                self.batch_vectors.extend(get_bv())
            get_cv = getattr(u, "step_const_vectors", None)
            if get_cv is not None:
                self.const_vectors.extend(get_cv())
            get_pv = getattr(u, "step_persist_vectors", None)
            if get_pv is not None:
                self.persist_vectors.extend(get_pv())

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
        if self._held:
            self.gather_state()
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
        self._compile_placements()
        self._step_flops_ = {}
        self._note_optimizer_stats()
        self._compiled = True

    def _note_optimizer_stats(self):
        """Publishes the optimizer observability gauges
        (``optimizer.state_bytes`` / ``optimizer.shard_frac`` with an
        ``optimizer.kind`` label): one walk per compile, not per
        dispatch."""
        gds = list(dict.fromkeys(self.gd_map.values()))
        if not gds:
            return
        kinds = sorted({getattr(gd, "optimizer", "sgd") for gd in gds})
        state_bytes = sum(vec.nbytes for gd in gds
                          for vec in gd.tstate.values())
        zero = getattr(self.workflow, "_zero_", None)
        shard_frac = 1.0 / zero[1] if zero and zero[1] else 1.0
        from .observability import attribution
        attribution.note_optimizer("+".join(kinds), state_bytes,
                                   shard_frac)

    def _compile_placements(self):
        """This rank's view of the workflow's mesh, the placements of
        the step tensors and the ZeRO axis of each parameter (None
        without a mesh)."""
        from .znicz.optimizers import param_of_slot
        mesh = getattr(self.workflow, "mesh", None)
        if mesh is None:
            self._view = None
            return
        from .parallel.mesh import placement_of
        from .parallel.placed import RankView, zero_axis
        self._place = {n: placement_of(v) for n, v in
                       list(self._param_vecs.items()) +
                       list(self._state_vecs.items())}
        self._batch_place = {str(id(v)): placement_of(v)
                             for v in self.batch_vectors}
        # The evaluators sum over the axis that splits the minibatch
        # (none when every batch vector is replicated).
        split = {a for p in self._batch_place.values() for a in p if a}
        self._view = RankView(mesh, split.pop() if split else None)
        self._zero = {}
        zero = getattr(self.workflow, "_zero_", None)
        self._zero_level = zero[0] if zero else 0
        for u, gd in self.gd_map.items():
            for slot in gd.tstate:
                attr = param_of_slot(slot)
                key = self.param_name(u, attr) if attr else None
                if key in self._place:
                    z = zero_axis(self._place[key],
                                  self._place[self.param_name(gd, slot)])
                    if z is not None:
                        self._zero[key] = z

    def gather_state(self):
        """Writes the shards the step holds — placed parameters and
        partitioned states — back into their Vectors at full size (a
        collective: every rank of the mesh calls it; a held Vector's
        first full read does).  A Vector written since its hold keeps
        what was written."""
        if not self._held:
            return
        view = self._view
        held, self._held = self._held, {}
        vecs = {**self._param_vecs, **self._state_vecs}
        for name in sorted(held):
            vec = vecs[name]
            if vec.holder is self:
                vec.devmem = view.gather_full(held[name], self._place[name])

    def _local(self, name, vec):
        """This rank's slice of a step tensor under the mesh: the shard
        the step holds, else the slice of the Vector's full value."""
        if vec.holder is self and name in self._held:
            return self._held[name]
        self._held.pop(name, None)
        return self._view.local(vec.devmem, self._place[name])

    def _keep(self, name, vec, value):
        """Stores a tick's new value: a placed tensor's shard stays with
        the step (the Vector is held), anything else goes into its
        Vector."""
        if self._view is not None and any(self._place[name]):
            self._held[name] = value
            vec.hold(self)
        else:
            vec.devmem = value

    # -- the tick ----------------------------------------------------------

    def _run_forward(self, params, states, batch, consts, ctx):
        bag = {}
        for vec in self.batch_vectors:
            bag[id(vec)] = batch[str(id(vec))]
        for vec in self.const_vectors:
            bag[id(vec)] = consts[str(id(vec))]
        pname = self.param_name
        view = self._view
        if view is not None:
            # A unit that does not take shards (no ``PLACED``) computes
            # with the whole parameter, gathered from the shards.
            params = dict(params)
            for u in self.forward_units:
                if getattr(u, "PLACED", False):
                    continue
                for a in u.trainables:
                    key = pname(u, a)
                    if any(self._place[key]):
                        params[key] = view.gather(params[key],
                                                  self._place[key])
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
        # Outputs a unit asks to keep (the RBM's reconstruction, the
        # SOM's winners) land in their Vectors after the tick.
        self._outputs = {id(v): bag[id(v)] for v in self.persist_vectors
                         if id(v) in bag}
        metrics = dict(ctx.metrics)
        loss = ctx.loss
        if loss is not None:
            metrics["loss"] = loss
            loss = loss + ctx.aux_loss
        return loss, metrics, new_states

    def _grad_norm(self, grads):
        """The global gradient norm; under a mesh each distinct shard
        counts once (a sum over the mesh of Σ g² / copies)."""
        view = self._view
        if view is None:
            return self.global_grad_norm(grads)
        from .parallel import collectives
        total = None
        for name in sorted(grads):
            copies = view.copies(self._place[name])
            if name in self._scattered:
                copies //= view.mesh.shape[self._zero[name]]
            term = torch.sum(torch.square(grads[name].float())) / copies
            total = term if total is None else total + term
        total = collectives.all_reduce(
            total.reshape(1), view.mesh.group(view.mesh.axis_names))
        return torch.sqrt(total[0])

    def _reduce_grads(self, grads):
        """Sums each gradient over the ranks holding copies of its
        shard; at ZeRO level 2 a ZeRO'd gradient is reduce-scattered
        over its ZeRO axis instead (the rank keeps its partition)."""
        from .parallel import collectives
        view = self._view
        self._scattered = set()
        groups = {}
        for name in grads:
            axes = view.copy_axes(self._place[name])
            z = self._zero.get(name)
            if z is not None and self._zero_level >= 2:
                axes = tuple(a for a in axes if a != z)
                self._scattered.add(name)
            groups[name] = view.mesh.group(axes)
        grads = collectives.reduce_gradients(grads, groups)
        for name in sorted(self._scattered):
            grads[name] = collectives.reduce_scatter(
                grads[name], 0, view.mesh.group(self._zero[name]))
        return grads

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

    def _apply_updates(self, params, grads, new_states, gate, hypers=None):
        """Runs every GD unit's update rule; ``gate`` (None or a bool
        tensor) keeps the old values where it is False; ``hypers``
        (``{name: 0-dim tensor}``) overrides the units'
        hyperparameters."""
        pname = self.param_name
        new_params = dict(params)
        zero = self._zero if self._view is not None else {}
        for u in self.forward_units:
            gd = self.gd_map.get(u)
            if not u.trainables or gd is None:
                continue
            for attr in u.trainables:
                key = pname(u, attr)
                gstate = {a: new_states[pname(gd, a)] for a in gd.tstate}
                p, g = params[key], grads[key]
                z = zero.get(key)
                if z is not None:
                    # ZeRO: the update on this rank's partition of dim
                    # 0 (its slots hold only that), then an all-gather.
                    n = self._view.mesh.shape[z]
                    size = p.shape[0] // n
                    start = self._view.coords[z] * size
                    p = p.narrow(0, start, size)
                    if key not in self._scattered:
                        g = g.narrow(0, start, size)
                new_p, new_gs = gd.tupdate(attr, p, g, gstate, None,
                                           hypers=hypers)
                if gate is not None:
                    new_p = torch.where(gate, new_p, p)
                if z is not None:
                    from .parallel import collectives
                    new_p = collectives.all_gather(
                        new_p, 0, self._view.mesh.group(z))
                new_params[key] = new_p
                for a, val in new_gs.items():
                    if gate is not None:
                        val = torch.where(gate, val,
                                          new_states[pname(gd, a)])
                    new_states[pname(gd, a)] = val
        return new_params, new_states

    def _train_tick(self, params, states, batch, consts, generator,
                    block=False, hypers=None):
        """``train_core`` (and, with ``block``, the body of
        ``block_core``): returns (new_params, new_states, metrics)."""
        view = self._view
        ctx = StepContext(generator=generator, training=True,
                          batch_group=view.batch_group() if view
                          else None)
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
            # Under a mesh every rank computes the same loss: each
            # differentiates 1/ranks of it, and the copies' gradients
            # sum below.
            seed = None if view is None else \
                torch.full_like(loss, 1.0 / view.world)
            grads = torch.autograd.grad(
                loss, [leaves[n] for n in names], grad_outputs=seed,
                allow_unused=True)
        with torch.no_grad():
            grads = {n: torch.zeros_like(params[n]) if g is None else g
                     for n, g in zip(names, grads)}
            self._scattered = set()
            if view is not None:
                grads = self._reduce_grads(grads)
            metrics = {k: v.detach() if isinstance(v, torch.Tensor)
                       else v for k, v in metrics.items()}
            new_states = {k: v.detach() for k, v in new_states.items()}
            return self._finish_train(params, grads, new_states, metrics,
                                      batch, block, hypers)

    def _finish_train(self, params, grads, new_states, metrics, batch,
                      block, hypers):
        """The rest of a train tick after the gradients: the health
        row, the gate (per-tick validity in block mode, finiteness) and
        the updates."""
        nv = metrics.get("n_valid")
        valid = None if nv is None else nv > 0
        gate = valid if block else None
        if self._health_specs:
            gnorm = self._grad_norm(grads)
            metrics["grad_norm"] = gnorm
            finite = self._health_update(
                new_states, batch, gnorm, metrics.get("loss"),
                valid=valid)
            metrics["step_finite"] = finite
            if self._device_skip:
                gate = finite if gate is None else gate & finite
        new_params, new_states = self._apply_updates(
            params, grads, new_states, gate, hypers)
        return new_params, new_states, metrics

    def _member_train(self, params, states, batch, consts, generator,
                      hypers):
        """One member's gated block train tick, composable with
        ``torch.func.vmap``: the gradients by ``torch.func.grad`` over
        :meth:`_run_forward`, then :meth:`_finish_train` with the
        member's hyperparameters.  Returns (new_params, new_states)."""
        def loss_fn(p):
            ctx = StepContext(generator=generator, training=True)
            loss, metrics, new_states = self._run_forward(
                p, states, batch, consts, ctx)
            if loss is None:
                raise ValueError(
                    "no unit called ctx.set_loss() — an evaluator must "
                    "be present in the step's chain")
            metrics = {k: v for k, v in metrics.items()
                       if isinstance(v, torch.Tensor)}
            return loss, (metrics, new_states)

        grads, (metrics, new_states) = torch.func.grad(
            loss_fn, has_aux=True)(params)
        with torch.no_grad():
            new_params, new_states, _ = self._finish_train(
                params, grads, dict(new_states), metrics, batch, True,
                hypers)
        return new_params, new_states

    def _infer_tick(self, params, states, batch, consts, generator):
        """``infer_step``: returns (new_states, metrics)."""
        view = self._view
        ctx = StepContext(generator=generator, training=False,
                          batch_group=view.batch_group() if view
                          else None)
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

    def invalidate(self):
        """Drops the analysed step: the next tick re-analyses the graph
        (and re-reads ``health_device_skip`` and the mesh).  Held
        shards go back into their Vectors first."""
        if self._held:
            self.gather_state()
        self._compiled = None

    def _ensure_compiled(self):
        if not self._compiled or self.fingerprint() != self._fingerprint:
            self.compile()

    def _device(self):
        for vec in self._param_vecs.values():
            return torch_device(vec.device)
        return torch.device("cpu")

    def _generator(self):
        """The step's ``torch.Generator``: generator 0's stream on the
        step's device, or the stream a population job pinned."""
        pin = getattr(self, "_pin_", None)
        if pin is not None:
            if pin["gen"] is None:
                gen = torch.Generator(device=self._device())
                state = pin["key"].get("state")
                if state is None:
                    gen.manual_seed(int(pin["key"]["seed"]))
                else:
                    gen.set_state(torch.from_numpy(
                        numpy.array(state, dtype=numpy.uint8)))
                pin["gen"] = gen
            return pin["gen"]
        from . import prng
        return prng.get().torch_generator(self._device())

    def pin_stream(self, key):
        """Until :meth:`unpin_stream`, the step draws from the stream
        ``key`` names — ``{"seed": s}`` (a fresh stream seeded with
        ``s``, as generator 0's is) or ``{"seed": s, "state": bytes}``
        (the stream at that state) — instead of generator 0's: a
        population member's step keys, drawn by the master and kept
        across requeues (the JAX package's job ``rng`` key)."""
        self._pin_ = {"key": dict(key), "gen": None}

    def unpin_stream(self):
        """Ends the pin; returns the key of the stream where it
        stopped (the member's next job starts there)."""
        pin, self._pin_ = getattr(self, "_pin_", None), None
        if pin is None:
            return None
        if pin["gen"] is None:
            return pin["key"]
        return {"seed": pin["key"]["seed"],
                "state": pin["gen"].get_state().numpy().copy()}

    def _tick(self, batch, training, block=False, hypers=None):
        consts = {str(id(v)): v.devmem for v in self.const_vectors}
        view = self._view
        if view is None:
            params = {n: v.devmem for n, v in self._param_vecs.items()}
            states = {n: v.devmem for n, v in self._state_vecs.items()}
        else:
            params = {n: self._local(n, v)
                      for n, v in self._param_vecs.items()}
            states = {n: self._local(n, v)
                      for n, v in self._state_vecs.items()}
            batch = {k: view.local(t, self._batch_place.get(k, ()))
                     for k, t in batch.items()}
        if training:
            if hypers:
                names, hvals = self._hyper_values(hypers)
                new_params, new_states, metrics = self._hyper_program(
                    "block" if block else "train", names)(
                    params, states, batch, consts, self._generator(),
                    hvals)
            else:
                new_params, new_states, metrics = self._train_tick(
                    params, states, batch, consts, self._generator(),
                    block)
            for n, v in self._param_vecs.items():
                self._keep(n, v, new_params[n])
        else:
            new_states, metrics = self._infer_tick(
                params, states, batch, consts, self._generator())
        for n, v in self._state_vecs.items():
            self._keep(n, v, new_states[n])
        for v in self.persist_vectors:
            if id(v) in self._outputs:
                v.devmem = self._outputs[id(v)].detach()
        self._outputs = {}
        return metrics

    def _dispatch(self, key, ticks, mode, run):
        """Runs one dispatch (``run()``, ``ticks`` ticks) inside its
        ``step.dispatch`` span and attribution's event pair.
        The first dispatch of each geometry ``key`` runs under the FLOP
        counter when a peak is known (the MFU denominator), and is
        left untimed (the counter slows the host)."""
        from .observability import attribution, tracing
        device = self._device()
        flops = count = None
        if attribution.enabled() and \
                attribution.peak_flops(device) is not None:
            flops = self._step_flops_.get(key)
            count = flops is None
        timer = attribution.begin_step(ticks=ticks, flops=flops,
                                       device=device, timed=not count)
        with tracing.span("step.dispatch", mode=mode, ticks=ticks):
            if count:
                out, self._step_flops_[key] = \
                    attribution.count_flops(run)
            else:
                out = run()
        attribution.end_step(timer, device=device)
        return out

    def execute(self, training=True, hypers=None):
        """Runs one tick on the loader's current minibatch; returns its
        metrics (device tensors).  ``hypers`` (``{name: float}``, train
        ticks only) overrides the GD units' hyperparameters through
        :meth:`_hyper_program`."""
        self._ensure_compiled()
        batch = {str(id(v)): v.devmem for v in self.batch_vectors}
        mode = "train" if training else "infer"
        return self._dispatch(
            (mode,), 1, mode,
            lambda: self._tick(batch, training, hypers=hypers))

    def execute_block(self, blocks, training, hypers=None):
        """Runs K stacked ticks; ``blocks`` maps batch vector id →
        (K, ...) block: a numpy array (the full-batch loader's index
        blocks), uploaded once per block, or a tensor already on the
        step's device (a streamed loader's staged block), taken as it
        is — a tensor on another device raises rather than taking a
        second trip through the host.  Every tick's metrics stay on the
        device (the evaluator's epoch accumulator).  ``hypers`` as in
        :meth:`execute`."""
        self._ensure_compiled()
        blocks = self._block_tensors(blocks)
        ticks = self._block_ticks(blocks)

        def run():
            for t in range(ticks):
                self._tick({k: v[t] for k, v in blocks.items()},
                           training, block=True, hypers=hypers)
            return {}
        return self._dispatch(("block", ticks, bool(training)), ticks,
                              "block", run)

    def _block_tensors(self, blocks):
        device = self._device()
        return {k: self._block_tensor(k, v, device)
                for k, v in blocks.items()}

    @staticmethod
    def _block_ticks(blocks):
        return next(iter(blocks.values())).shape[0] if blocks else 1

    # -- hyperparameter overrides and the population block ---------------

    #: Bound of the cache of hyperparameter vectors on the device (one
    #: per distinct value tuple).
    HYPER_VALS_CAP = 64

    def _hyper_values(self, hypers):
        """(names, float32 vector on the step's device) for a
        ``{name: float}`` override dict, cached per distinct value
        tuple (least recently used out past ``HYPER_VALS_CAP``)."""
        names = tuple(sorted(hypers))
        key = (names, tuple(float(hypers[n]) for n in names))
        cache = self._hyper_vals_
        cached = cache.pop(key, None)
        if cached is None:
            cached = torch.tensor([hypers[n] for n in names],
                                  dtype=torch.float32,
                                  device=self._device())
        cache[key] = cached
        while len(cache) > self.HYPER_VALS_CAP:
            cache.pop(next(iter(cache)))
        return names, cached

    def _hyper_program(self, mode, names):
        """A train tick whose GD hyperparameters come from ONE float32
        vector ``hvals`` aligned with ``names`` — the single-member form
        of :meth:`compile_population`'s hyperparameters: ``fn(params,
        states, batch, consts, generator, hvals) -> (new_params,
        new_states, metrics)``.  ``mode`` "train" is an ungated tick,
        "block" a tick of a block (gated by its validity).  Cached per
        (mode, names)."""
        progs = self._hyper_progs_
        prog = progs.get((mode, names))
        if prog is None:
            block = mode == "block"

            def prog(params, states, batch, consts, generator, hvals):
                hypers = {n: hvals[i] for i, n in enumerate(names)}
                return self._train_tick(params, states, batch, consts,
                                        generator, block, hypers)
            progs[(mode, names)] = prog
        return prog

    def compile_population(self, hyper_names):
        """The population block step over the hyperparameters named by
        ``hyper_names``: ``fn(pop_params, pop_states, blocks, consts,
        generator, training, pop_hypers) -> (pop_params, pop_states)``,
        where every parameter and state carries a leading member axis
        (:meth:`population_arrays`) and ``pop_hypers`` is a (P,
        len(hyper_names)) float32 tensor.  Each of the block's ticks is
        ONE ``torch.func.vmap`` over the members — a train tick through
        :meth:`_member_train`, a validation tick through the infer tick
        — with the tick's minibatch, the constants and the generator
        shared (``randomness="same"``).  The kernels of the path see the
        members folded into their batch (their ``vmap`` rules)."""
        self._ensure_compiled()
        names = tuple(hyper_names)

        def pop_block(pop_params, pop_states, blocks, consts, generator,
                      training, pop_hypers):
            blocks = self._block_tensors(blocks)
            for t in range(self._block_ticks(blocks)):
                batch = {k: v[t] for k, v in blocks.items()}
                if training:
                    def member(p, s, h, batch=batch):
                        hypers = {n: h[i] for i, n in enumerate(names)}
                        return self._member_train(p, s, batch, consts,
                                                  generator, hypers)
                    pop_params, pop_states = torch.func.vmap(
                        member, randomness="same")(
                        pop_params, pop_states, pop_hypers)
                else:
                    def member(p, s, batch=batch):
                        return self._infer_tick(p, s, batch, consts,
                                                generator)[0]
                    pop_states = torch.func.vmap(
                        member, randomness="same")(pop_params,
                                                   pop_states)
                self._outputs = {}
            return pop_params, pop_states

        self._pop_block = pop_block
        return pop_block

    def population_arrays(self, pop_size):
        """The current parameters and states tiled to a leading axis of
        ``pop_size`` members, each member owning its memory (every
        member starts from the same weights)."""
        self._ensure_compiled()

        def tile(vectors):
            return {n: v.devmem.unsqueeze(0).expand(
                (pop_size,) + tuple(v.devmem.shape)).clone()
                for n, v in vectors.items()}
        return tile(self._param_vecs), tile(self._state_vecs)

    @staticmethod
    def _block_tensor(key, value, device):
        if isinstance(value, torch.Tensor):
            if value.device != device:
                raise ValueError(
                    "block %s is on %s but the step runs on %s" %
                    (key, value.device, device))
            return value
        return torch.as_tensor(numpy.ascontiguousarray(value)).to(device)


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
        #: The rank mesh of a parallel style (``parallel.mesh``); never
        #: pickled — a restore re-places on the topology it finds.
        self.mesh = None
        self._parallel_style_ = None
        self._zero_ = None
        self._compiler_ = None
        self._tick_id_ = 0
        self._step_done_tick_ = -1
        # Master: each worker's in-flight jobs as ((epoch, class),
        # last minibatch, epoch ended), the count per bucket, and the
        # buckets whose last minibatch was served (bucket → epoch
        # ended).  Worker: the current job's meta.
        self._inflight_by_slave_ = {}
        self._inflight_count_ = {}
        self._finish_pending_ = {}
        self._job_meta_ = None

    def __getstate__(self):
        """The last tick's metrics are device tensors of this process:
        a snapshot leaves them out."""
        if self._compiler_ is not None and self._compiler_._held:
            self._compiler_.gather_state()
        state = super(AcceleratedWorkflow, self).__getstate__()
        state["step_metrics"] = {}
        state.pop("mesh", None)
        return state

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
        try:
            # step.nan chaos point (the process-wide plan): the poison
            # rides the real minibatch through the real step.
            resilience.effective(None).check("step.nan")
        except resilience.InjectedStepNaN:
            self._poison_minibatch()
        self.step_metrics = self.compiler.execute(training=self.training)

    def _poison_minibatch(self):
        """Feeds NaN into the current tick's minibatch mask (the loader
        rewrites it at its next serve, so exactly one tick is
        poisoned): the loss and every gradient go NaN inside the step —
        the bad-record case the health sentinel exists to catch."""
        loader = getattr(self, "loader", None)
        mask = getattr(loader, "minibatch_mask", None)
        if mask is None or not mask:
            self.warning("step.nan fired but the workflow has no "
                         "loader mask to poison — ignored")
            return
        mask.map_write()
        mask.mem[...] = numpy.nan
        self.warning("chaos: poisoned minibatch (epoch %s, class %s)",
                     getattr(loader, "epoch_number", "?"),
                     getattr(loader, "minibatch_class", "?"))

    def execute_block(self, blocks, training=None, hypers=None):
        """Dispatches a stacked block of ticks."""
        if self._step_done_tick_ == self._tick_id_:
            return
        self._step_done_tick_ = self._tick_id_
        try:
            resilience.effective(None).check("step.nan")
        except resilience.InjectedStepNaN:
            # The stacked blocks (numpy arrays or device tensors) were
            # already copied out of the loader vectors: poison the
            # block's first tick in place.
            loader = getattr(self, "loader", None)
            mask = getattr(loader, "minibatch_mask", None)
            mask_id = str(id(mask)) if mask is not None else None
            if mask_id in blocks:
                blocks[mask_id][0, ...] = numpy.nan
                self.warning("chaos: poisoned first tick of block")
            else:
                self.warning("step.nan fired but the block carries "
                             "no loader mask to poison — ignored")
        if training is None:
            training = self.training
        self.compiler.execute_block(blocks, training, hypers=hypers)
        self.step_metrics = {}

    # -- the data plane: master and worker ------------------------------------

    @property
    def decision_unit(self):
        return getattr(self, "decision", None)

    def should_stop_serving(self):
        """The master's serve predicate (consulted by the Server)."""
        d = self.decision_unit
        if d is not None:
            return bool(d.complete)
        return bool(self.stopped)

    def generate_data_for_slave(self, slave=None):
        """A job: the units' pieces (the loader's indices, the
        trainables) plus the serve-time flags the master's decision
        needs echoed back with the update."""
        loader = getattr(self, "loader", None)
        # The serve below advances epoch_number when it hands out the
        # epoch's last minibatch: the value before it is the one every
        # job of this epoch agrees on, and keys its bucket.
        epoch_key = loader.epoch_number if loader is not None else None
        data = super(AcceleratedWorkflow,
                     self).generate_data_for_slave(slave)
        if loader is not None:
            meta = {
                "minibatch_class": loader.minibatch_class,
                "last_minibatch": bool(loader.last_minibatch),
                "epoch_ended": bool(loader.epoch_ended),
                "epoch_number": loader.epoch_number,
                "epoch_key": epoch_key,
                "weights_version": self.weights_version,
            }
            data["__job__"] = meta
            key = (epoch_key, meta["minibatch_class"])
            self._inflight_by_slave_.setdefault(slave, []).append(
                (key, meta["last_minibatch"], meta["epoch_ended"]))
            self._inflight_count_[key] = \
                self._inflight_count_.get(key, 0) + 1
        return data

    def apply_data_from_master(self, data):
        super(AcceleratedWorkflow, self).apply_data_from_master(data)
        if data and "__job__" in data:
            self._job_meta_ = data["__job__"]

    def do_job(self, data, update, callback):
        """A worker's job: applies the master's data and runs the job's
        ticks — one tick, or a multi-tick job (``--job-ticks``) as one
        block — then returns the updated trainables with the metrics
        (a block's from the evaluator's epoch accumulator, reset
        before and read after)."""
        self.apply_data_from_master(data)
        if update is not None:
            self.apply_update_from_master(update)
        meta = self._job_meta_ or {}
        # A population job pins the step's stream to the member's key,
        # drawn by the master, so a member's trajectory does not depend
        # on how members interleave on this worker; the key where the
        # stream stopped rides back with the update.  Other jobs draw
        # from this worker's own stream.
        key = meta.get("rng")
        if key is not None:
            self.compiler.pin_stream(key)
            try:
                result = self._run_job(meta)
            finally:
                next_key = self.compiler.unpin_stream()
            result["__job__"]["rng"] = next_key
        else:
            result = self._run_job(meta)
        callback(result)

    def _run_job(self, meta):
        """Runs the job's ticks; returns the update with its metrics
        and the echoed job meta."""
        from .loader.base import TRAIN
        cls = meta.get("minibatch_class", TRAIN)
        training = cls == TRAIN
        hypers = meta.get("hypers") or None
        loader = getattr(self, "loader", None)
        take_block = getattr(loader, "take_staged_block", None)
        block = take_block() if take_block is not None else None
        self.begin_tick()
        if block is not None:
            host_metrics = self._run_job_block(block, cls, training,
                                               hypers=hypers)
        else:
            metrics = self.compiler.execute(training=training,
                                            hypers=hypers)
            host_metrics = {k: float(v) for k, v in metrics.items()
                            if isinstance(v, torch.Tensor) and
                            v.numel() == 1}
        result = self.generate_data_for_master()
        result["__metrics__"] = host_metrics
        # The echoed meta keys the master's bucket; the step key and
        # the hyper overrides were inputs, not accounting.
        result["__job__"] = {k: v for k, v in meta.items()
                             if k not in ("rng", "hypers")}
        return result

    def _run_job_block(self, block, cls, training, hypers=None):
        """Runs a multi-tick job's block; returns its metrics summed
        over the block ("ticks" marks them so for the decision)."""
        ev = getattr(self, "evaluator", None)
        if ev is not None and hasattr(ev, "reset_epoch_acc"):
            ev.reset_epoch_acc(cls)
            ev.reset_health_acc(cls)
        self.execute_block(block, training, hypers=hypers)
        metrics = {}
        if ev is not None and hasattr(ev, "read_epoch_acc"):
            row = ev.read_epoch_acc(cls)
            metrics = {"n_err": float(row[0]),
                       "n_valid": float(row[1]),
                       "loss": float(row[2]),
                       "ticks": float(row[3])}
            ev.reset_epoch_acc(cls)
            health = ev.read_health_acc(cls)
            metrics["nonfinite"] = float(health[0])
            metrics["grad_norm_sum"] = float(health[1])
            ev.reset_health_acc(cls)
        return metrics

    def apply_data_from_slave(self, data, slave=None):
        """Master side: folds a worker's update and books its metrics."""
        meta = (data or {}).pop("__job__", None)
        metrics = (data or {}).pop("__metrics__", None)
        if meta is not None:
            key = (meta.get("epoch_key"), meta.get("minibatch_class"))
            if not self._release_inflight(slave, key):
                # An untracked job was already dropped and requeued (a
                # blacklisted worker): its batch trains again, so its
                # update and metrics are discarded.
                return
            # One answered job = one entry of the loader's pending
            # record; what remains is what a drop requeues.
            loader = getattr(self, "loader", None)
            if loader is not None:
                loader.apply_data_from_slave(None, slave)
        super(AcceleratedWorkflow, self).apply_data_from_slave(
            data, slave)
        try:
            d = self.decision_unit
            if d is None or meta is None:
                return
            cls = meta.get("minibatch_class")
            epoch = meta.get("epoch_key")
            key = (epoch, cls)
            if metrics is not None and \
                    hasattr(d, "accumulate_remote"):
                d.accumulate_remote(cls, metrics, epoch)
            if meta.get("last_minibatch"):
                # Other jobs of this (epoch, class) may still be out:
                # the class finishes once they are answered.
                self._finish_pending_[key] = bool(
                    meta.get("epoch_ended"))
            self._maybe_finish_remote(key)
        finally:
            # A deferred snapshot fires even for a workflow without a
            # decision.
            self._notify_if_drained()

    def total_inflight_jobs(self):
        """Jobs served and not yet answered or requeued (the
        snapshotter defers a checkpoint until none is)."""
        return sum(self._inflight_count_.values())

    def _notify_if_drained(self):
        if self._inflight_count_:
            return
        for unit in self.units:
            drained = getattr(unit, "on_jobs_drained", None)
            if drained is not None:
                drained()

    def _release_inflight(self, slave, key):
        """Removes one tracked job of ``slave`` in bucket ``key``;
        False when none is tracked (a drop released it)."""
        lst = self._inflight_by_slave_.get(slave)
        if not lst:
            return False
        for i, (k, _last, _ended) in enumerate(lst):
            if k == key:
                lst.pop(i)
                break
        else:
            return False
        if not lst:
            self._inflight_by_slave_.pop(slave, None)
        n = self._inflight_count_.get(key, 0)
        if n <= 1:
            self._inflight_count_.pop(key, None)
        else:
            self._inflight_count_[key] = n - 1
        return True

    def _maybe_finish_remote(self, key):
        """Fires the deferred epoch-boundary decision once every job
        served for (epoch, class) has been answered or requeued."""
        if key not in self._finish_pending_ or \
                self._inflight_count_.get(key, 0) > 0:
            return
        epoch_ended = self._finish_pending_.pop(key)
        d = self.decision_unit
        if d is None:
            return
        epoch, cls = key
        if hasattr(d, "finish_remote_class"):
            d.finish_remote_class(cls, epoch)
            # The guardian reacts as it would in one process (a
            # rollback restores the master's Vectors, which ship with
            # the next jobs).
            guardian = getattr(self, "guardian", None)
            if guardian is not None and hasattr(guardian, "check_class"):
                guardian.check_class(cls)
            if epoch_ended:
                d.on_epoch_ended()

    def drop_slave(self, slave=None):
        """A dropped worker's jobs are requeued by the loader; their
        accounting is released here, and a dropped epoch's last
        minibatch restores the epoch boundary (the loader serves that
        batch again with ``last_minibatch`` False)."""
        super(AcceleratedWorkflow, self).drop_slave(slave)
        entries = list(self._inflight_by_slave_.get(slave, ()))
        for key, was_last, epoch_ended in entries:
            self._release_inflight(slave, key)
            if was_last:
                self._finish_pending_.setdefault(key, epoch_ended)
            self._maybe_finish_remote(key)
        self._notify_if_drained()


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


def population_from_numpy(workflow, arrays):
    """The population counterpart of :func:`params_from_numpy`: member
    parameters and states — a leading member axis over every parameter,
    optimizer slot and accumulator — from ``{unit.name: {attr: (P, ...)
    ndarray}}`` (e.g. the JAX package's ``population_arrays`` read back
    to the host).  Returns ``(pop_params, pop_states)`` on the step's
    device, keyed as :meth:`StepCompiler.population_arrays` keys them:
    its tiling of the current values, with every array given put in
    place.  An unknown unit or attribute, another member count or
    another shape raises."""
    compiler = workflow.compiler
    sizes = {numpy.shape(a)[0] for attrs in arrays.values()
             for a in attrs.values()}
    if len(sizes) != 1:
        raise ValueError("population arrays disagree on the member "
                         "count: %s" % sorted(sizes))
    pop = sizes.pop()
    pop_params, pop_states = compiler.population_arrays(pop)
    by_name = {u.name: u for u in workflow.units}
    for unit_name, attrs in arrays.items():
        if unit_name not in by_name:
            raise KeyError("workflow %s has no unit %r" %
                           (workflow.name, unit_name))
        for attr, arr in attrs.items():
            key = compiler.param_name(by_name[unit_name], attr)
            target = pop_params if key in pop_params else pop_states
            if key not in target:
                raise KeyError("unit %s has no parameter or state %r" %
                               (unit_name, attr))
            arr = numpy.asarray(arr)
            if tuple(arr.shape) != tuple(target[key].shape):
                raise ValueError("%s: shape %s, expected %s" % (
                    key, arr.shape, tuple(target[key].shape)))
            target[key] = torch.as_tensor(arr.copy()).to(
                device=target[key].device, dtype=target[key].dtype)
    return pop_params, pop_states
