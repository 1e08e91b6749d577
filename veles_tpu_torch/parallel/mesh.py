"""Rank meshes, parameter placements and the parallel styles (the JAX
package's ``parallel.mesh``).

The JAX package annotates tensors with ``NamedSharding``s over a device
mesh and lets XLA insert the collectives.  The port splits that in two:

* **the layout**, plain data: a :class:`Mesh` is a grid of ranks over
  named axes, and every step tensor carries a *placement* — a tuple
  with one mesh axis (or None) per dimension, the JAX package's
  ``PartitionSpec`` — in ``Vector.placement``.  The appliers below set
  the same placements the JAX package's set shardings, so the layout
  can be built, checked and rebuilt with no process group at all;
* **the execution** on ``torch.distributed``: :meth:`Mesh.group` makes
  one process group per line of ranks along a set of axes (NCCL on the
  card, gloo for a CPU world), and the step (``accelerated_units``)
  runs every rank's slice of the placements: batch vectors split on the
  data axis, each parameter's local shard, gradients summed over the
  ranks that hold copies of a shard, the Megatron all-reduce after each
  row-parallel product, the sequence ring, the expert ``all_to_all``
  and the stage hand-off.

Between ticks a placed parameter or state lives only as each rank's
shard inside the step (``Vector.hold``), as a sharded ``jax.Array``
holds only its shard; a full read — a snapshot's pickle, an export, a
host read (``map_read``, ``map_read_all``) or a rebuild — gathers it
back first (:func:`gather_state`, a collective), so none of them ever
sees a shard.  Neither a mesh's groups nor a placement are pickled:
a restore re-places on whatever topology exists then.
"""

import numpy


def P(*axes):
    """A placement: one mesh axis name (or None) per dimension."""
    return tuple(axes)


class Mesh(object):
    """Ranks on a grid of named axes (``jax.sharding.Mesh`` over
    ranks).  ``shape`` maps axis → size in axis order; ``ranks`` is the
    grid."""

    def __init__(self, ranks, axis_names, sizes):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.ranks = numpy.asarray(ranks, dtype=numpy.int64).reshape(
            tuple(sizes))
        self._groups_ = {}

    @property
    def size(self):
        return int(self.ranks.size)

    def __repr__(self):
        return "Mesh(%s, ranks=%s)" % (self.shape, self.ranks.ravel().tolist())

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_groups_"] = {}
        return state

    def coords(self, rank):
        """{axis: index} of ``rank`` on the grid."""
        where = numpy.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError("rank %d is not on %r" % (rank, self))
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def line(self, axes, rank):
        """The ranks that share every coordinate of ``rank`` but those
        of ``axes``, in grid order (the group a collective over
        ``axes`` runs in)."""
        axes = tuple(a for a in self.axis_names if a in axes)
        coords = self.coords(rank)
        index = tuple(slice(None) if a in axes else coords[a]
                      for a in self.axis_names)
        return self.ranks[index].ravel().tolist()

    def group(self, axes):
        """The process group of this rank's line along ``axes`` (an
        axis name or a tuple), created on first use — only by the
        line's members.  None when ``axes`` is empty (nothing to
        reduce over)."""
        import torch.distributed as dist
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in self.axis_names if a in axes)
        if not axes:
            return None
        if not dist.is_initialized():
            raise RuntimeError(
                "a step over %r needs torch.distributed to be "
                "initialized (the launcher's distributed mode)" % self)
        key = frozenset(axes)
        if key not in self._groups_:
            ranks = self.line(axes, dist.get_rank())
            self._groups_[key] = dist.new_group(
                ranks=ranks, use_local_synchronization=True)
        return self._groups_[key]

    def axis_index(self, axis, rank=None):
        """This rank's index along ``axis``."""
        if rank is None:
            import torch.distributed as dist
            rank = dist.get_rank() if dist.is_initialized() else \
                int(self.ranks.ravel()[0])
        return self.coords(rank)[axis]


def make_mesh(ranks=None, axes=None):
    """A Mesh over ``ranks`` (default: every rank of the world, or rank
    0 alone without one); ``axes`` maps name → size with -1 = the
    remaining ranks (default: one ``data`` axis)."""
    if ranks is None:
        import torch.distributed as dist
        ranks = list(range(dist.get_world_size())) \
            if dist.is_initialized() else [0]
    ranks = list(ranks)
    if axes is None:
        axes = {"data": len(ranks)}
    names = list(axes)
    sizes = [axes[n] for n in names]
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        sizes[sizes.index(-1)] = len(ranks) // known
    count = 1
    for s in sizes:
        count *= s
    return Mesh(ranks[:count], names, sizes)


def placement_of(vec):
    """A Vector's placement, () (replicated) when it has none."""
    return getattr(vec, "placement", None) or ()


def _set_mesh(workflow, mesh):
    workflow.mesh = mesh
    workflow.compiler.invalidate()


def apply_dp_sharding(workflow, mesh, axis="data"):
    """Data parallelism: per-tick batch vectors split on ``axis`` (dim
    0) where their batch divides it, everything else replicated.  The
    step then sums every gradient over the axis."""
    compiler = workflow.compiler
    compiler.analyze()
    n = mesh.shape[axis]

    def batch_placement(vec):
        shape = vec.shape
        return P(axis) if shape and shape[0] % n == 0 else P()

    for vec in compiler.batch_vectors:
        vec.placement = batch_placement(vec)
    for vec in compiler._collect("params").values():
        vec.placement = P()
    for vec in compiler._collect("state").values():
        vec.placement = P()
    for vec in compiler.const_vectors:
        vec.placement = P()
    for vec in compiler.persist_vectors:
        vec.placement = batch_placement(vec)
    _set_mesh(workflow, mesh)
    workflow._parallel_style_ = ("dp", axis)
    return workflow


def _transformer_tp_plan(unit, n_model, model_axis):
    """Megatron placements for one transformer-family unit, or None
    when its geometry does not divide the model axis: q/k/v (split or
    fused, head-major) and ``w1`` column-parallel, ``wo`` and ``w2``
    row-parallel, the MoE experts' trailing dims likewise (their leading
    expert dim is the expert axis's), the pipelined stack's likewise
    (its leading stage dim is the stage axis's), an untied LM head's
    vocab and the embedding's embed dim sharded."""
    from ..znicz.attention import (Embedding, LMHead, MoETransformerBlock,
                                   PipelinedTransformerStack,
                                   TransformerBlock)
    if isinstance(unit, (TransformerBlock, PipelinedTransformerStack)):
        inp = getattr(unit, "input", None)
        if inp is None or inp.shape is None:
            return None
        embed = inp.shape[-1]
        hidden = embed * unit.mlp_ratio
        if embed % n_model or hidden % n_model or unit.n_heads % n_model:
            return None
        col, row, vec, rep = ((None, model_axis), (model_axis, None),
                              (model_axis,), ())
        plan = {"wq": col, "wk": col, "wv": col, "wo": row,
                "bq": vec, "bk": vec, "bv": vec, "bo": rep,
                "wqkv": col, "bqkv": vec,
                "ln1_g": rep, "ln1_b": rep, "ln2_g": rep, "ln2_b": rep,
                "w1": col, "b1": vec, "w2": row, "b2": rep}
        if isinstance(unit, MoETransformerBlock):
            plan.update({"router": rep,
                         "w1": (None,) + col, "b1": (None,) + vec,
                         "w2": (None,) + row, "b2": (None,) + rep})
        elif isinstance(unit, PipelinedTransformerStack):
            plan = {k: (None,) + v for k, v in plan.items()}
        return {name: P(*axes) for name, axes in plan.items()
                if name in unit.trainables}
    if isinstance(unit, LMHead):
        plan = {}
        w = unit.trainables.get("weights")
        if w and w.shape[-1] % n_model == 0:
            plan["weights"] = P(None, model_axis)
            if unit.trainables.get("bias"):
                plan["bias"] = P(model_axis)
        return plan or None
    if isinstance(unit, Embedding):
        w = unit.trainables.get("weights")
        if w is None or not w or w.shape[-1] % n_model:
            return None
        plan = {"weights": P(None, model_axis)}
        if unit.pos:
            plan["pos"] = P(None, model_axis)
        return plan
    return None


def _gd_of(workflow):
    return {gd.target: gd for gd in getattr(workflow, "gds", [])
            if getattr(gd, "target", None) is not None}


def _mirror_slots(gd, params):
    """Optimizer slots take their parameter's placement BY NAME
    (``velocity_wq`` ← ``wq``; shapes alone collide)."""
    if gd is None:
        return
    from ..znicz.optimizers import param_of_slot
    for name, vec in gd.tstate.items():
        target = params.get(param_of_slot(name) or name)
        if vec and target is not None and \
                tuple(vec.shape) == tuple(target.shape):
            vec.placement = target.placement


def apply_dp_tp_sharding(workflow, mesh, data_axis="data",
                         model_axis="model"):
    """Data × tensor parallelism: the Megatron plan on the transformer
    family (:func:`_transformer_tp_plan`), an All2All layer's weights
    column-sharded where its width divides the model axis, slots
    mirroring their parameter; layers that do not divide stay
    replicated."""
    from ..znicz.all2all import All2All
    apply_dp_sharding(workflow, mesh, axis=data_axis)
    n_model = mesh.shape[model_axis]
    gd_of = _gd_of(workflow)
    sharded = 0
    for unit in getattr(workflow, "forwards", []):
        plan = _transformer_tp_plan(unit, n_model, model_axis)
        if plan:
            for pname, spec in plan.items():
                unit.trainables[pname].placement = spec
            _mirror_slots(gd_of.get(unit), unit.trainables)
            sharded += 1
            continue
        if not isinstance(unit, All2All):
            continue
        weights = unit.trainables.get("weights")
        if weights is None or not weights or weights.shape[-1] % n_model:
            continue
        weights.placement = P(None, model_axis)
        bias = unit.trainables.get("bias")
        if bias:
            bias.placement = P(model_axis)
        sharded += 1
        gd = gd_of.get(unit)
        if gd is not None:
            for vec in gd.tstate.values():
                if vec and tuple(vec.shape) == tuple(weights.shape):
                    vec.placement = P(None, model_axis)
                elif vec and bias and \
                        tuple(vec.shape) == tuple(bias.shape):
                    vec.placement = P(model_axis)
    if sharded == 0:
        workflow.warning(
            "apply_dp_tp_sharding: no layer geometry divides the model "
            "axis (%d) — the workflow runs data-parallel only" % n_model)
    workflow._parallel_style_ = ("dp_tp", data_axis, model_axis)
    return workflow


def apply_dp_tp_sp_sharding(workflow, mesh, data_axis="data",
                            model_axis="model", seq_axis="seq",
                            sp_kernel=None):
    """Data × tensor × sequence parallelism: the Megatron placements,
    and every unit declaring ``seq_axis`` runs its attention sequence-
    parallel on its local heads; ``sp_kernel`` overrides the ring kernel
    of those units."""
    apply_dp_tp_sharding(workflow, mesh, data_axis=data_axis,
                         model_axis=model_axis)
    sp_blocks = 0
    for unit in getattr(workflow, "forwards", []):
        if getattr(unit, "seq_axis", None) != seq_axis:
            continue
        if sp_kernel is not None:
            unit.sp_kernel = sp_kernel
        sp_blocks += 1
    if sp_blocks == 0:
        workflow.warning(
            "apply_dp_tp_sp_sharding: no forward unit declares "
            "seq_axis=%r — attention runs without sequence "
            "parallelism" % seq_axis)
    workflow._parallel_style_ = ("dp_tp_sp", data_axis, model_axis,
                                 seq_axis)
    return workflow


def apply_dp_sp_sharding(workflow, mesh, data_axis="data",
                         seq_axis="seq"):
    """Data × sequence parallelism: batches split on ``data_axis``;
    every unit declaring ``seq_axis`` runs its attention over the
    sequence shards of that axis (the ring or Ulysses)."""
    apply_dp_sharding(workflow, mesh, axis=data_axis)
    ring_blocks = sum(getattr(unit, "seq_axis", None) == seq_axis
                      for unit in getattr(workflow, "forwards", []))
    if ring_blocks == 0:
        workflow.warning(
            "apply_dp_sp_sharding: no forward unit declares seq_axis=%r "
            "— the workflow runs data-parallel only" % seq_axis)
    workflow._parallel_style_ = ("dp_sp", data_axis, seq_axis)
    return workflow


def _overlay_leading_axis(workflow, mesh, params_attr, count_attr,
                          lead_axis):
    """Puts ``lead_axis`` on dim 0 of every ``params_attr`` Vector
    (stage_params / expert_params) of a unit whose ``count_attr``
    divides the axis, over whatever trailing axes are set, and re-points
    the mirroring slots by name.  Returns the units overlaid."""
    from ..znicz.optimizers import param_of_slot
    n_lead = mesh.shape[lead_axis]
    gd_of = _gd_of(workflow)
    overlaid = 0
    for unit in getattr(workflow, "forwards", []):
        stacked = getattr(unit, params_attr, None)
        if stacked is None or getattr(unit, count_attr) % n_lead:
            continue
        for vec in stacked.values():
            cur = placement_of(vec)
            axes = list(cur) + [None] * (len(vec.shape) - len(cur))
            axes[0] = lead_axis
            vec.placement = P(*axes)
        overlaid += 1
        gd = gd_of.get(unit)
        if gd is not None:
            for name, vec in gd.tstate.items():
                target = stacked.get(param_of_slot(name) or name)
                if vec and target is not None and \
                        tuple(vec.shape) == tuple(target.shape):
                    vec.placement = target.placement
    return overlaid


def apply_dp_ep_sharding(workflow, mesh, data_axis="data",
                         expert_axis="expert"):
    """Data × expert parallelism: each MoE block's expert-stacked
    parameters (leading ``n_experts`` dim) and their slots split on
    ``expert_axis``; the block dispatches tokens to the experts' ranks
    by ``all_to_all``.  Blocks whose ``n_experts`` does not divide stay
    replicated."""
    apply_dp_sharding(workflow, mesh, axis=data_axis)
    if _overlay_leading_axis(workflow, mesh, "expert_params",
                             "n_experts", expert_axis) == 0:
        workflow.warning(
            "apply_dp_ep_sharding: no MoE block's n_experts divides the "
            "expert axis (%d) — the workflow runs data-parallel only"
            % mesh.shape[expert_axis])
    workflow._parallel_style_ = ("dp_ep", data_axis, expert_axis)
    return workflow


def apply_dp_pp_sharding(workflow, mesh, data_axis="data",
                         stage_axis="stage"):
    """Data × pipeline parallelism: each pipelined stack's stage-stacked
    parameters (leading ``n_blocks`` dim) and their slots split on
    ``stage_axis``; the stack runs its schedule over that axis with the
    stage hand-off by point-to-point.  Stacks whose ``n_blocks`` does
    not divide stay replicated and run sequentially."""
    apply_dp_sharding(workflow, mesh, axis=data_axis)
    if _overlay_leading_axis(workflow, mesh, "stage_params", "n_blocks",
                             stage_axis) == 0:
        workflow.warning(
            "apply_dp_pp_sharding: no pipelined stack's n_blocks divides "
            "the stage axis (%d) — the workflow runs data-parallel only"
            % mesh.shape[stage_axis])
    workflow._parallel_style_ = ("dp_pp", data_axis, stage_axis)
    return workflow


def apply_dp_pp_tp_sharding(workflow, mesh, data_axis="data",
                            stage_axis="stage", model_axis="model"):
    """Data × pipeline × tensor parallelism: the Megatron plan, then the
    stage axis over the stacks' leading dim."""
    apply_dp_tp_sharding(workflow, mesh, data_axis=data_axis,
                         model_axis=model_axis)
    if _overlay_leading_axis(workflow, mesh, "stage_params", "n_blocks",
                             stage_axis) == 0:
        workflow.warning(
            "apply_dp_pp_tp_sharding: no pipelined stack's n_blocks "
            "divides the stage axis (%d) — the workflow runs dp×tp only"
            % mesh.shape[stage_axis])
    workflow._parallel_style_ = ("dp_pp_tp", data_axis, stage_axis,
                                 model_axis)
    return workflow


def apply_dp_ep_tp_sharding(workflow, mesh, data_axis="data",
                            expert_axis="expert", model_axis="model"):
    """Data × expert × tensor parallelism: the Megatron plan on each
    expert's trailing dims, then the expert axis over dim 0."""
    apply_dp_tp_sharding(workflow, mesh, data_axis=data_axis,
                         model_axis=model_axis)
    if _overlay_leading_axis(workflow, mesh, "expert_params",
                             "n_experts", expert_axis) == 0:
        workflow.warning(
            "apply_dp_ep_tp_sharding: no MoE block's n_experts divides "
            "the expert axis (%d) — the workflow runs dp×tp only"
            % mesh.shape[expert_axis])
    workflow._parallel_style_ = ("dp_ep_tp", data_axis, expert_axis,
                                 model_axis)
    return workflow


def apply_zero_sharding(workflow, mesh=None, data_axis="data", level=1):
    """ZeRO-1/2 over ``data_axis``, after a style applier: every GD
    slot whose dim 0 divides the axis and is not owned by another axis
    gains the data axis there, so each data rank keeps and updates 1/dp
    of the optimizer state and of each parameter, then all-gathers the
    parameter.  Level 2 reduce-scatters the gradients feeding the
    partitioned update instead of all-reducing them.  Scalar slots stay
    replicated."""
    from ..znicz.nn_units import GradientDescentBase
    if mesh is None:
        mesh = getattr(workflow, "mesh", None)
    if mesh is None or data_axis not in mesh.shape:
        raise ValueError(
            "apply_zero_sharding needs a mesh carrying axis %r — apply a "
            "dp/dp×tp/... sharding first" % data_axis)
    dp = mesh.shape[data_axis]
    workflow.compiler.analyze()
    sharded = 0
    for gd in [u for u in workflow.units
               if isinstance(u, GradientDescentBase)]:
        for vec in gd.tstate.values():
            if not vec or not vec.shape:
                continue
            if dp <= 1 or vec.shape[0] % dp:
                continue
            cur = placement_of(vec)
            axes = list(cur) + [None] * (len(vec.shape) - len(cur))
            if axes[0] is not None:
                continue
            axes[0] = data_axis
            vec.placement = P(*axes)
            sharded += 1
    if sharded == 0:
        workflow.warning(
            "apply_zero_sharding: no optimizer slot's leading dimension "
            "divides the data axis (%d) — optimizer state stays "
            "replicated" % dp)
    workflow._zero_ = (level, dp if sharded else 1, data_axis)
    workflow.compiler.invalidate()
    return workflow


def _style_appliers():
    return {"dp_tp": apply_dp_tp_sharding, "dp_sp": apply_dp_sp_sharding,
            "dp_ep": apply_dp_ep_sharding, "dp_pp": apply_dp_pp_sharding}


def _seq_axis_fits(workflow, n_seq):
    """Whether every sequence-parallel unit can run over an n_seq-wide
    seq axis: S % n_seq == 0, and heads % n_seq == 0 for Ulysses."""
    for u in getattr(workflow, "forwards", []):
        if not getattr(u, "seq_axis", None):
            continue
        shape = getattr(getattr(u, "input", None), "shape", None)
        if shape and len(shape) >= 2 and shape[1] % n_seq:
            return False
        if getattr(u, "sp_mode", None) == "ulysses" and \
                getattr(u, "n_heads", 0) % n_seq:
            return False
    return True


def _rebuild_styled_mesh(workflow, ranks, n, style):
    """Re-forms the workflow's non-DP layout over ``ranks`` when
    divisibility allows; returns the new mesh or None (→ dp).  A shrink
    keeps the old data-axis size first, then tries 2, and the other
    axis must keep >= 2 ranks; a growth keeps the other axis's exact
    size and widens the data axis.  A 3-axis dp×tp×sp keeps model and
    seq exactly, else keeps tp, else keeps sp."""
    old_mesh = getattr(workflow, "mesh", None)
    if style[0] in _style_appliers() and len(style) == 3:
        name, data_axis, other_axis = style
        old_data = old_mesh.shape.get(data_axis) if old_mesh else None
        old_other = old_mesh.shape.get(other_axis) if old_mesh else None
        candidates = [old_data, 2]
        if old_data and old_other and n > old_data * old_other and \
                n % old_other == 0:
            candidates.insert(0, n // old_other)
        seen = set()
        for candidate in candidates:
            if not candidate or candidate in seen:
                continue
            seen.add(candidate)
            if n % candidate == 0 and n // candidate >= 2:
                if name == "dp_sp" and \
                        not _seq_axis_fits(workflow, n // candidate):
                    continue
                mesh = make_mesh(ranks, {data_axis: candidate,
                                         other_axis: n // candidate})
                kwargs = {"data_axis": data_axis,
                          {"dp_tp": "model_axis", "dp_sp": "seq_axis",
                           "dp_ep": "expert_axis",
                           "dp_pp": "stage_axis"}[name]: other_axis}
                _style_appliers()[name](workflow, mesh, **kwargs)
                return mesh
        return None
    if style[0] == "dp_tp_sp" and len(style) == 4:
        _, data_axis, model_axis, seq_axis = style
        if old_mesh is None:
            return None
        m = old_mesh.shape.get(model_axis)
        s = old_mesh.shape.get(seq_axis)
        if not m or not s:
            return None
        if n % (m * s) == 0 and _seq_axis_fits(workflow, s):
            mesh = make_mesh(ranks, {data_axis: n // (m * s),
                                     model_axis: m, seq_axis: s})
            apply_dp_tp_sp_sharding(workflow, mesh, data_axis=data_axis,
                                    model_axis=model_axis,
                                    seq_axis=seq_axis)
            return mesh
        if m >= 2 and n % m == 0:
            mesh = make_mesh(ranks, {data_axis: n // m, model_axis: m})
            apply_dp_tp_sharding(workflow, mesh, data_axis=data_axis,
                                 model_axis=model_axis)
            return mesh
        if s >= 2 and n % s == 0 and _seq_axis_fits(workflow, s):
            mesh = make_mesh(ranks, {data_axis: n // s, seq_axis: s})
            apply_dp_sp_sharding(workflow, mesh, data_axis=data_axis,
                                 seq_axis=seq_axis)
            return mesh
    return None


def gather_state(workflow):
    """Puts the step's held shards (placed parameters, partitioned
    optimizer slots) back into their Vectors at full size (a collective over the current mesh: every
    rank calls it)."""
    compiler = getattr(workflow, "_compiler_", None)
    if compiler is not None:
        compiler.gather_state()


def _abandon_groups(mesh):
    """Drops ``mesh``'s process groups with no collective on them: a
    NCCL communicator is aborted (a wait on a dead member never ends),
    a gloo group is left unused."""
    groups, mesh._groups_ = list(mesh._groups_.values()), {}
    import torch.distributed as dist
    if not dist.is_initialized():
        return
    from torch.distributed import distributed_c10d
    for group in groups:
        if group is None or dist.get_backend(group) != "nccl":
            continue
        try:
            distributed_c10d._abort_process_group(group)
        except Exception:  # the communicator may be gone already
            pass


def rebuild_mesh(workflow, surviving_ranks=None, axis="data",
                 requeue_in_flight=True, epoch=None):
    """Membership change at mesh granularity, shrink and growth alike:
    re-forms the mesh over ``surviving_ranks`` (default: the world's)
    with the same style where it divides, else data parallelism,
    re-applies ZeRO, requeues what the loader had in flight (at least
    once), and stamps the membership epoch (``epoch``, else one more
    than the last).

    A rank of the old mesh missing from ``surviving_ranks`` is lost: it
    is never waited on.  Its old groups are dropped (a NCCL one
    aborted) and the survivors meet in new ones at the next tick.
    Parameters placed only by data parallelism are replicated, so under
    dp (and dp×sp without ZeRO) the survivors train on with nothing
    missing.  A step holding shards between ticks (tp, ep, pp, ZeRO)
    lost the dead rank's with it: that raises
    :class:`~veles_tpu_torch.resilience.LostRankError`, whose recovery
    is a restart from the newest snapshot (``Launcher.resume_latest``)
    — where the single-process JAX package still reads a lost device's
    shard, a dead process cannot answer.  Without a lost rank the held
    shards are gathered over the old mesh first."""
    from .. import resilience
    from ..observability import metrics
    if surviving_ranks is None:
        import torch.distributed as dist
        surviving_ranks = list(range(dist.get_world_size())) \
            if dist.is_initialized() else [0]
    ranks = list(surviving_ranks)
    n = len(ranks)
    prior = getattr(workflow, "mesh", None)
    old_n = prior.size if prior is not None else None
    style = getattr(workflow, "_parallel_style_", None) or ("dp", axis)
    alive = set(ranks)
    lost = [] if prior is None else sorted(
        int(r) for r in prior.ranks.ravel() if int(r) not in alive)
    if lost:
        compiler = getattr(workflow, "_compiler_", None)
        held = sorted(getattr(compiler, "_held", None) or ())
        if held:
            raise resilience.LostRankError(
                "rank(s) %s of %r are gone with their shards of %s — the "
                "survivors cannot re-form in process; restart from the "
                "newest snapshot (Launcher.resume_latest)" %
                (lost, prior, ", ".join(held)))
        _abandon_groups(prior)
    else:
        gather_state(workflow)
    mesh = _rebuild_styled_mesh(workflow, ranks, n, style)
    if mesh is None:
        if style[0] != "dp":
            workflow.warning(
                "rebuild_mesh: %d survivors cannot hold the %s layout — "
                "falling back to data parallelism" % (n, style[0]))
        mesh = make_mesh(ranks, {axis: n})
        apply_dp_sharding(workflow, mesh, axis=axis)
    zero = getattr(workflow, "_zero_", None)
    if zero:
        level, _old_dp, zaxis = zero
        apply_zero_sharding(workflow, mesh,
                            data_axis=zaxis if zaxis in mesh.shape
                            else axis, level=level)
    workflow.compiler.invalidate()
    loader = getattr(workflow, "loader", None)
    if loader is not None:
        in_flight = list(getattr(loader, "_in_flight_", []))
        loader._in_flight_ = []
        if requeue_in_flight:
            loader.failed_minibatches.extend(in_flight)
        invalidate = getattr(loader, "invalidate_staged", None)
        if invalidate is not None:
            invalidate()
    workflow._membership_epoch_ = int(epoch) if epoch is not None \
        else getattr(workflow, "_membership_epoch_", 0) + 1
    resilience.stats.incr("membership.rebuilds")
    if old_n is not None and n > old_n:
        resilience.stats.incr("membership.grow")
    elif old_n is not None and n < old_n:
        resilience.stats.incr("membership.shrink")
    metrics.registry.gauge("membership.epoch").set(
        workflow._membership_epoch_)
    return mesh
