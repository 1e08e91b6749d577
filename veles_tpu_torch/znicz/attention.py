"""Transformer LM units (the JAX package's ``znicz.attention``, dense).

An embedding, a pre-LN transformer block (split or fused QKV
projections) whose attention runs through ``ops.attention`` — the
hand-written flash kernels on the card — a tied LM head and the
next-token evaluator, plus their gradient-descent units.  Each block
can rematerialize (``torch.utils.checkpoint``, non-reentrant): its
forward runs again inside the backward instead of keeping its
activations — except under a ``torch.func`` transform (the population
step), whose ``grad`` does not take the checkpoint's saved-tensor hooks:
there every block keeps its activations.

At ``precision_level`` 0 the activation stream is bfloat16 and every
projection multiplies bfloat16-rounded operands with a float32 result,
as the JAX package's ``jnp.dot(..., preferred_element_type=float32)``
does: the operands are rounded, then multiplied in float32.

Under a mesh (:mod:`..parallel`) the transformer units take their
parameter shards themselves (``PLACED``): a Megatron column shard holds
whole heads, and the all-reduce after each row-parallel product runs
over the model axis; a block declaring ``seq_axis`` runs its attention
sequence-parallel; the MoE block dispatches to the experts' ranks; the
pipelined stack runs its schedule over the stage axis.
"""

import functools

import numpy
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import root, get as config_get
from ..memory import Vector
from .nn_units import ForwardBase, GradientDescentBase, dot as _dot
from .evaluator import EvaluatorBase


def remat_enabled(unit_flag):
    """Whether a transformer unit should rematerialize (``torch.utils.checkpoint``)
    its block application: the unit kwarg wins when set, otherwise
    ``root.common.engine.remat`` (default off).  Remat trades ~1/3 more
    FLOPs (forward re-run in backward) for O(layers) → O(1) residual
    activation memory per block — THE long-context/deep-stack enabler:
    ring attention already gives O(S/N) attention memory, but without
    remat the backward still stores every block's full residual
    stream."""
    if unit_flag is not None:
        return bool(unit_flag)
    return bool(config_get(root.common.engine.remat, False))


def fused_qkv_enabled(unit_flag):
    """Whether a transformer unit computes q/k/v with ONE (E, 3E)
    matmul (the attention fast path's stage (a)): the unit kwarg wins
    when set, otherwise ``root.common.engine.fused_qkv`` (default
    off).  The fused weight's column layout is HEAD-MAJOR —
    ``[q_h | k_h | v_h]`` per head — so a Megatron column shard of
    the 3E dim holds whole heads' q/k/v together and the
    (B, S, H, 3, D) reshape splits q/k/v on a replicated axis (no
    resharding), which is what lets the fused projection compose
    with tensor parallelism."""
    if unit_flag is not None:
        return bool(unit_flag)
    return bool(config_get(root.common.engine.fused_qkv, False))


def fuse_qkv_arrays(wq, wk, wv, n_heads):
    """Fuses three projection arrays into the head-major (…, 3·O)
    layout.  Trailing-dim based, so it handles (E, O) weights, (O,)
    biases, and stage-stacked (L, E, O) weights alike."""
    wq, wk, wv = (numpy.asarray(w) for w in (wq, wk, wv))
    O = wq.shape[-1]
    D = O // n_heads
    parts = [w.reshape(w.shape[:-1] + (n_heads, 1, D))
             for w in (wq, wk, wv)]
    return numpy.ascontiguousarray(
        numpy.concatenate(parts, axis=-2).reshape(
            wq.shape[:-1] + (3 * O,)))


#: The per-projection parameter names the fused layout replaces.
_QKV_NAMES = ("wq", "wk", "wv", "bq", "bk", "bv")


def qkv_param_names(names, fused):
    """Rewrites a canonical PARAM_NAMES tuple for the fused layout:
    wq/wk/wv → wqkv, bq/bk/bv → bqkv (order of first occurrence)."""
    if not fused:
        return tuple(names)
    out = []
    for n in names:
        if n in _QKV_NAMES:
            repl = "wqkv" if n.startswith("w") else "bqkv"
            if repl not in out:
                out.append(repl)
        else:
            out.append(n)
    return tuple(out)


def _layer_norm(x, gamma, beta, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.reciprocal(torch.sqrt(var + eps)) * gamma +
            beta).to(x.dtype)


def transformer_block_apply(params, x, n_heads, causal, cdt,
                            attend=None, mlp=None, reduce=None):
    """Pure pre-LN block: x + MHA(LN(x)), then + MLP(LN(·)).  ``mlp``
    receives the post-LN activations (B, S, E) and returns the FFN
    output to be residual-added; None → the dense w1/w2 MLP.

    The projections may be Megatron shards: q/k/v (or the head-major
    fused qkv) and ``w1`` column shards hold whole heads and a slice of
    the hidden units, ``wo`` and ``w2`` the matching row shards, and
    ``reduce`` (the all-reduce over the model axis; None → identity)
    sums the row-parallel products before their biases."""
    from ..ops import attention as A
    B, S, E = x.shape
    D = E // n_heads
    if reduce is None:
        def reduce(t):
            return t

    def dot(a, w, b):
        return _dot(a, w, cdt) + b

    h = _layer_norm(x, params["ln1_g"], params["ln1_b"])
    if "wqkv" in params:
        # One (E, 3E) product; the head-major column layout makes the
        # q/k/v split a reshape + index.
        qkv = dot(h, params["wqkv"], params["bqkv"]).reshape(
            B, S, -1, 3, D)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    else:
        q = dot(h, params["wq"], params["bq"]).reshape(B, S, -1, D)
        k = dot(h, params["wk"], params["bk"]).reshape(B, S, -1, D)
        v = dot(h, params["wv"], params["bv"]).reshape(B, S, -1, D)
    if attend is None:
        attend = functools.partial(A.attention, causal=causal)
    attn = attend(q.to(cdt), k.to(cdt), v.to(cdt)).reshape(B, S, -1)
    x = x + (reduce(_dot(attn, params["wo"], cdt)) + params["bo"])
    h = _layer_norm(x, params["ln2_g"], params["ln2_b"])
    if mlp is not None:
        x = x + mlp(h)
    else:
        h = torch.relu(dot(h, params["w1"], params["b1"]))
        x = x + (reduce(_dot(h, params["w2"], cdt)) + params["b2"])
    return x.float()


def _row_reduce(unit, vec, dim):
    """The model-axis all-reduce of a unit whose row-parallel weight
    ``vec`` is split on ``dim`` (None when it is not)."""
    mesh = getattr(unit.workflow, "mesh", None)
    placement = getattr(vec, "placement", None) or ()
    axis = placement[dim] if len(placement) > dim else None
    if mesh is None or axis is None:
        return None
    from ..parallel import collectives
    group = mesh.group(axis)
    return lambda t: collectives.all_reduce(t, group)


def _block_param_shapes(embed, hidden, fused_qkv=False):
    """Parameter geometry of one dense pre-LN block — single source
    of truth for TransformerBlock and the pipelined stack (which
    prepends a stage dim).  ``fused_qkv`` swaps the three (E, E)
    projections for the single (E, 3E) fused weight.

    Dict ORDER is load-bearing: initialization draws from the seeded
    prng in iteration order, so the unfused layout must keep the
    historical ordering bit-for-bit (seeded trajectories — and the
    tests pinning them — depend on it)."""
    if fused_qkv:
        proj = {"wqkv": (embed, 3 * embed), "wo": (embed, embed),
                "bqkv": (3 * embed,), "bo": (embed,)}
    else:
        proj = {"wq": (embed, embed), "wk": (embed, embed),
                "wv": (embed, embed), "wo": (embed, embed),
                "bq": (embed,), "bk": (embed,), "bv": (embed,),
                "bo": (embed,)}
    shapes = {"ln1_g": (embed,), "ln1_b": (embed,)}
    shapes.update(proj)
    shapes.update({
        "ln2_g": (embed,), "ln2_b": (embed,),
        "w1": (embed, hidden), "b1": (hidden,),
        "w2": (hidden, embed), "b2": (embed,),
    })
    return shapes


class Embedding(ForwardBase):
    """Token + learned positional embedding: int tokens (B, S) →
    activations (B, S, E)."""

    MAPPING = "embedding"

    def __init__(self, workflow, **kwargs):
        super(Embedding, self).__init__(workflow, **kwargs)
        self.vocab_size = kwargs["vocab_size"]
        self.embed_dim = kwargs["embed_dim"]
        self.max_len = kwargs.get("max_len")
        self.include_bias = False
        self.pos = Vector()

    @property
    def trainables(self):
        t = {"weights": self.weights} if self.weights else {}
        if self.pos:
            t["pos"] = self.pos
        return t

    def initialize(self, device=None, **kwargs):
        super(Embedding, self).initialize(device=device, **kwargs)
        batch, seq = self.input.shape[:2]
        max_len = self.max_len or seq
        if not self.weights:
            stddev = self.weights_stddev or 0.02
            w = numpy.zeros((self.vocab_size, self.embed_dim),
                            dtype=numpy.float32)
            self.rand().fill_normal(w, stddev=stddev)
            self.weights.mem = w
            self.weights.initialize(self.device)
        if not self.pos:
            p = numpy.zeros((max_len, self.embed_dim),
                            dtype=numpy.float32)
            self.rand().fill_normal(p, stddev=0.02)
            self.pos.mem = p
            self.pos.initialize(self.device)
        self.output.mem = numpy.zeros(
            (batch, seq, self.embed_dim), dtype=numpy.float32)
        self.output.initialize(self.device)

    def tforward(self, read, write, params, ctx, state=None):
        tokens = read(self.input).long()
        out = F.embedding(tokens, params["weights"]) + \
            params["pos"][:tokens.shape[1]]
        write(self.output, out.to(self.compute_dtype))


class TransformerBlock(ForwardBase):
    """Pre-LN transformer block: x + MHA(LN(x)), then + MLP(LN(·)).

    kwargs: ``n_heads``; ``mlp_ratio`` (default 4); ``causal`` (default
    True); ``remat`` (None → ``root.common.engine.remat``);
    ``fused_qkv`` (None → ``root.common.engine.fused_qkv``, frozen at
    construction); ``seq_axis`` — when set AND the workflow's mesh
    carries that axis, attention runs sequence-parallel
    (``ops.attention.sequence_parallel_attention``) in ``sp_mode``
    ("ring" or "ulysses") with the ring kernel ``sp_kernel`` (None → the
    ``sp_ring_kernel`` knob).
    """

    MAPPING = "transformer_block"
    #: Takes its parameter shards under a mesh (see the module doc).
    PLACED = True

    PARAM_NAMES = ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo",
                   "bq", "bk", "bv", "bo",
                   "ln2_g", "ln2_b", "w1", "b1", "w2", "b2")

    def __init__(self, workflow, **kwargs):
        super(TransformerBlock, self).__init__(workflow, **kwargs)
        self.n_heads = kwargs.get("n_heads", 4)
        self.mlp_ratio = kwargs.get("mlp_ratio", 4)
        self.causal = kwargs.get("causal", True)
        self.seq_axis = kwargs.get("seq_axis")
        #: "ring" (k/v shards go round, O(S/N) memory) or "ulysses"
        #: (two all-to-alls, dense local attention).
        self.sp_mode = kwargs.get("sp_mode", "ring")
        from ..ops.attention import SP_MODES
        if self.sp_mode not in SP_MODES:
            raise ValueError("unknown sp_mode %r — valid: %s" %
                             (self.sp_mode, list(SP_MODES)))
        #: Ring-kernel override: None → the ``sp_ring_kernel`` knob.
        self.sp_kernel = kwargs.get("sp_kernel")
        self.remat = kwargs.get("remat")
        self.fused_qkv = fused_qkv_enabled(kwargs.get("fused_qkv"))
        self.params = {name: Vector()
                       for name in qkv_param_names(self.PARAM_NAMES,
                                                   self.fused_qkv)}

    @property
    def trainables(self):
        return {n: v for n, v in self.params.items() if v}

    def initialize(self, device=None, **kwargs):
        super(TransformerBlock, self).initialize(device=device,
                                                 **kwargs)
        batch, seq, embed = self.input.shape
        if embed % self.n_heads:
            raise ValueError("embed dim %d not divisible by %d heads"
                             % (embed, self.n_heads))
        hidden = embed * self.mlp_ratio
        stddev = self.weights_stddev or (1.0 / numpy.sqrt(embed))
        shapes = _block_param_shapes(embed, hidden,
                                     fused_qkv=self.fused_qkv)
        for name, shape in shapes.items():
            vec = self.params[name]
            if vec:
                continue
            arr = numpy.zeros(shape, dtype=numpy.float32)
            if name.startswith("w"):
                self.rand().fill_normal(arr, stddev=stddev)
            elif name.endswith("_g"):
                arr[...] = 1.0
            vec.mem = arr
            vec.initialize(self.device)
        self.output.mem = numpy.zeros((batch, seq, embed),
                                      dtype=numpy.float32)
        self.output.initialize(self.device)

    def _attend(self, q, k, v):
        from ..ops import attention as A
        mesh = getattr(self.workflow, "mesh", None)
        seq_axis = getattr(self, "seq_axis", None)
        if seq_axis and mesh is not None and seq_axis in mesh.shape:
            return A.sequence_parallel_attention(
                q, k, v, mesh, seq_axis, causal=self.causal,
                mode=getattr(self, "sp_mode", "ring"),
                kernel=getattr(self, "sp_kernel", None))
        return A.attention(q, k, v, causal=self.causal)

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)
        reduce = _row_reduce(self, self.params["wo"], 0)

        def apply(p, h):
            return transformer_block_apply(
                p, h, self.n_heads, self.causal, self.compute_dtype,
                attend=self._attend, reduce=reduce)

        if remat_enabled(self.remat) and torch.is_grad_enabled() and \
                not torch._C._functorch.is_functorch_wrapped_tensor(x):
            out = checkpoint(apply, params, x, use_reentrant=False)
        else:
            out = apply(params, x)
        write(self.output, out)


class MoETransformerBlock(TransformerBlock):
    """Transformer block whose MLP is a top-k Mixture-of-Experts
    (``ops.moe``).  Expert parameters carry a leading ``n_experts``
    dim; under a mesh with an expert axis (``apply_dp_ep_sharding``)
    each rank holds its experts and the block dispatches tokens to them
    by ``all_to_all`` (``moe_ffn_parallel``).

    kwargs beyond TransformerBlock: ``n_experts``; ``capacity_factor``
    (default 1.25); ``aux_weight`` — load-balance loss weight (default
    0.01); ``top_k`` (default ``root.common.engine.moe_top_k`` or 1);
    ``router_z_weight`` (default ``root.common.engine.moe_router_z`` or
    0); ``expert_axis``; ``minibatch_class_vec`` and ``minibatch_mask``
    — the loader's, which bucket the router-health rows by class and
    gate padded ticks out.

    ``moe_acc`` is the (3 classes × 2 + n_experts) router-health
    accumulator — [aux_sum, ticks, load_0 … load_{E−1}] — added to
    inside the step and read at epoch boundaries.
    """

    MAPPING = "moe_transformer_block"

    PARAM_NAMES = ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo",
                   "bq", "bk", "bv", "bo",
                   "ln2_g", "ln2_b", "router",
                   "w1", "b1", "w2", "b2")

    def __init__(self, workflow, **kwargs):
        self.n_experts = kwargs.get("n_experts", 4)
        self.capacity_factor = kwargs.get("capacity_factor", 1.25)
        self.aux_weight = kwargs.get("aux_weight", 0.01)
        top_k = kwargs.get("top_k")
        if top_k is None:
            top_k = config_get(root.common.engine.moe_top_k, 1)
        self.top_k = int(top_k)
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError(
                "top_k=%d must satisfy 1 <= k <= n_experts=%d"
                % (self.top_k, self.n_experts))
        z_weight = kwargs.get("router_z_weight")
        if z_weight is None:
            z_weight = config_get(root.common.engine.moe_router_z, 0.0)
        self.router_z_weight = float(z_weight)
        self.expert_axis = kwargs.get("expert_axis")
        self.minibatch_class_vec = kwargs.get("minibatch_class_vec")
        self.minibatch_mask = kwargs.get("minibatch_mask")
        self.moe_acc = Vector()
        super(MoETransformerBlock, self).__init__(workflow, **kwargs)

    @property
    def tstate(self):
        state = dict(super(MoETransformerBlock, self).tstate)
        if not self.moe_acc:
            self.moe_acc.mem = numpy.zeros((3, 2 + self.n_experts),
                                           dtype=numpy.float32)
        state["moe_acc"] = self.moe_acc
        return state

    def read_moe_acc(self, cls):
        """Host fetch of one class's router row — [aux_sum, ticks,
        per-expert load]."""
        acc = self.tstate["moe_acc"]
        acc.map_read()
        return numpy.array(acc.mem[cls])

    def reset_moe_acc(self, cls):
        acc = self.tstate["moe_acc"]
        acc.map_write()
        acc.mem[cls] = 0.0

    def initialize(self, device=None, **kwargs):
        batch, seq, embed = self.input.shape
        hidden = embed * self.mlp_ratio
        stddev = self.weights_stddev or (1.0 / numpy.sqrt(embed))
        E = self.n_experts
        moe_shapes = {
            "router": (embed, E),
            "w1": (E, embed, hidden), "b1": (E, hidden),
            "w2": (E, hidden, embed), "b2": (E, embed),
        }
        for name, shape in moe_shapes.items():
            vec = self.params[name]
            if vec:
                continue
            arr = numpy.zeros(shape, dtype=numpy.float32)
            if name in ("router", "w1", "w2"):
                self.rand().fill_normal(arr, stddev=stddev)
            vec.mem = arr
            vec.initialize(device if device is not None else self.device)
        self.tstate["moe_acc"].initialize(device)
        super(MoETransformerBlock, self).initialize(device=device,
                                                    **kwargs)

    @property
    def expert_params(self):
        """The expert-stacked Vectors (leading n_experts dim) — what
        ``apply_dp_ep_sharding`` splits."""
        return {n: self.params[n] for n in ("w1", "b1", "w2", "b2")}

    def _moe(self, h2d, p, ctx):
        """The routed FFN over (T, D) tokens: plain without a mesh, the
        parallel dispatch under one."""
        from ..ops import moe as M
        mesh = getattr(self.workflow, "mesh", None)
        top_k = getattr(self, "top_k", 1)
        args = (h2d, p["router"], p["w1"], p["b1"], p["w2"], p["b2"])
        if mesh is None:
            return M.moe_ffn_topk(*args,
                                  capacity_factor=self.capacity_factor,
                                  top_k=top_k)
        lead = (getattr(self.params["w1"], "placement", None) or
                (None,))[0]
        return M.moe_ffn_parallel(
            *args, capacity_factor=self.capacity_factor, top_k=top_k,
            data_group=ctx.batch_group,
            expert_group=mesh.group(lead) if lead else None,
            reduce=_row_reduce(self, self.params["w2"], 1))

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)
        B, S, E = x.shape
        reduce = _row_reduce(self, self.params["wo"], 0)

        def apply(p, h0):
            box = {}

            def mlp(h):
                y, aux, z, load = self._moe(h.reshape(B * S, E), p, ctx)
                box["aux"], box["z"], box["load"] = aux, z, load
                return y.reshape(B, S, E)

            out = transformer_block_apply(
                p, h0, self.n_heads, self.causal, self.compute_dtype,
                attend=self._attend, mlp=mlp, reduce=reduce)
            return out, box["aux"], box["z"], box["load"]

        if remat_enabled(self.remat) and torch.is_grad_enabled() and \
                not torch._C._functorch.is_functorch_wrapped_tensor(x):
            out, aux, z, load = checkpoint(apply, params, x,
                                           use_reentrant=False)
        else:
            out, aux, z, load = apply(params, x)
        total_aux = self.aux_weight * aux
        if self.router_z_weight:
            total_aux = total_aux + self.router_z_weight * z
        ctx.add_aux_loss(total_aux)
        ctx.add_metric("%s_max_expert_load" % self.name,
                       load.max() / torch.clamp_min(load.sum(), 1.0))
        write(self.output, out)
        if state is not None and "moe_acc" in state:
            # Router-health row at the minibatch's class; a padded
            # block tick (all-zero mask) is gated out whole.
            cvec = self.minibatch_class_vec
            cls = read(cvec).long().reshape(1) if cvec is not None \
                else torch.full((1,), 2, dtype=torch.long,
                                device=x.device)
            mvec = self.minibatch_mask
            valid = (ctx.batch_sum(read(mvec).sum()) > 0).float() \
                if mvec is not None else torch.ones((), device=x.device)
            row = torch.cat([
                torch.stack([aux.float().detach(),
                             torch.ones((), device=x.device)]),
                load.float()]) * valid
            return {"moe_acc": state["moe_acc"].index_add(
                0, cls, row[None])}


class PipelinedTransformerStack(ForwardBase):
    """N homogeneous transformer blocks as ONE unit with stage-stacked
    parameters (leading ``n_blocks`` dim) — the pipeline-parallel
    formulation (``ops.pipeline``): under a mesh with the stage axis
    the stack splits over its ranks, the minibatch into
    ``n_microbatches``, and activations go stage to stage by point-to-
    point; without it the same stacked parameters run as a plain loop
    (the same function, so pipelined vs sequential parity is testable).
    ``schedule`` (None → ``root.common.engine.pp_schedule`` or "gpipe")
    and ``n_chunks`` (interleaved; None → ``root.common.engine.
    pp_chunks``) pick the schedule.
    """

    MAPPING = "pipelined_transformer_stack"
    PLACED = True

    def __init__(self, workflow, **kwargs):
        super(PipelinedTransformerStack, self).__init__(workflow,
                                                        **kwargs)
        self.n_blocks = kwargs.get("n_blocks", 4)
        self.n_heads = kwargs.get("n_heads", 4)
        self.mlp_ratio = kwargs.get("mlp_ratio", 4)
        self.causal = kwargs.get("causal", True)
        self.stage_axis = kwargs.get("stage_axis")
        self.n_microbatches = kwargs.get("n_microbatches", 4)
        schedule = kwargs.get("schedule")
        if schedule is None:
            schedule = config_get(root.common.engine.pp_schedule, "gpipe")
        from ..ops.pipeline import SCHEDULES
        if schedule not in SCHEDULES:
            raise ValueError("unknown pipeline schedule %r — valid: %s"
                             % (schedule, list(SCHEDULES)))
        self.schedule = schedule
        n_chunks = kwargs.get("n_chunks")
        if n_chunks is None:
            n_chunks = config_get(root.common.engine.pp_chunks, None)
        self.n_chunks = n_chunks
        self.remat = kwargs.get("remat")
        self.fused_qkv = fused_qkv_enabled(kwargs.get("fused_qkv"))
        self.params = {name: Vector()
                       for name in qkv_param_names(
                           TransformerBlock.PARAM_NAMES, self.fused_qkv)}

    @property
    def trainables(self):
        return {n: v for n, v in self.params.items() if v}

    def initialize(self, device=None, **kwargs):
        super(PipelinedTransformerStack, self).initialize(
            device=device, **kwargs)
        batch, seq, embed = self.input.shape
        if embed % self.n_heads:
            raise ValueError("embed dim %d not divisible by %d heads"
                             % (embed, self.n_heads))
        hidden = embed * self.mlp_ratio
        stddev = self.weights_stddev or (1.0 / numpy.sqrt(embed))
        shapes = _block_param_shapes(embed, hidden,
                                     fused_qkv=self.fused_qkv)
        for name, shape in shapes.items():
            vec = self.params[name]
            if vec:
                continue
            arr = numpy.zeros((self.n_blocks,) + shape,
                              dtype=numpy.float32)
            if name.startswith("w"):
                self.rand().fill_normal(arr, stddev=stddev)
            elif name.endswith("_g"):
                arr[...] = 1.0
            vec.mem = arr
            vec.initialize(self.device)
        self.output.mem = numpy.zeros((batch, seq, embed),
                                      dtype=numpy.float32)
        self.output.initialize(self.device)

    @property
    def stage_params(self):
        """The stage-stacked Vectors — what ``apply_dp_pp_sharding``
        splits on the stage axis."""
        return dict(self.trainables)

    def tforward(self, read, write, params, ctx, state=None):
        from ..ops import pipeline as PL
        x = read(self.input)
        cdt = self.compute_dtype
        reduce = _row_reduce(self, self.params["wo"], 1)

        def block_fn(p, h):
            return transformer_block_apply(p, h, self.n_heads,
                                           self.causal, cdt,
                                           reduce=reduce)

        mesh = getattr(self.workflow, "mesh", None)
        lead = (getattr(self.params["wo"], "placement", None) or
                (None,))[0]
        if self.stage_axis and mesh is not None and \
                lead == self.stage_axis:
            out = PL.pipeline(block_fn, params, x, mesh, self.stage_axis,
                              self.n_microbatches,
                              schedule=self.schedule,
                              n_chunks=self.n_chunks)
        else:
            fn = block_fn
            if remat_enabled(self.remat) and torch.is_grad_enabled() and \
                    not torch._C._functorch.is_functorch_wrapped_tensor(x):
                def fn(p, h):
                    return checkpoint(block_fn, p, h, use_reentrant=False)
            out = PL.sequential_stack(fn, params, x)
        write(self.output, out)


class GDPipelinedStack(GradientDescentBase):
    MAPPING = "pipelined_transformer_stack"


class LMHead(ForwardBase):
    """Tied or free projection to vocabulary logits:
    (B, S, E) → (B, S, V)."""

    MAPPING = "lm_head"

    def __init__(self, workflow, **kwargs):
        super(LMHead, self).__init__(workflow, **kwargs)
        self.vocab_size = kwargs["vocab_size"]
        #: Weight tying to an Embedding unit (gradients flow to the
        #: embedding through the read).
        self.tie_to = kwargs.get("tie_to")

    @property
    def trainables(self):
        if self.tie_to is not None:
            return {"bias": self.bias} if self.include_bias and \
                self.bias else {}
        return super(LMHead, self).trainables

    def initialize(self, device=None, **kwargs):
        if self.tie_to is not None and \
                not self.tie_to.is_initialized:
            raise AttributeError("%s: tied embedding %s not "
                                 "initialized yet" %
                                 (self.name, self.tie_to.name))
        super(LMHead, self).initialize(device=device, **kwargs)
        batch, seq, embed = self.input.shape
        if self.tie_to is None and not self.weights:
            stddev = self.weights_stddev or (1.0 / numpy.sqrt(embed))
            w = numpy.zeros((embed, self.vocab_size),
                            dtype=numpy.float32)
            self.rand().fill_normal(w, stddev=stddev)
            self.weights.mem = w
            self.weights.initialize(self.device)
        if self.include_bias and not self.bias:
            self.bias.mem = numpy.zeros(self.vocab_size,
                                        dtype=numpy.float32)
            self.bias.initialize(self.device)
        self.output.mem = numpy.zeros(
            (batch, seq, self.vocab_size), dtype=numpy.float32)
        self.output.initialize(self.device)

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)
        if self.tie_to is not None:
            w = read(self.tie_to.weights).t()
        else:
            w = params["weights"]
        y = _dot(x, w, self.compute_dtype)
        if self.include_bias:
            y = y + params["bias"]
        write(self.output, y)


class EvaluatorLM(EvaluatorBase):
    """Next-token cross-entropy over (B, S, V) logits vs (B, S) labels,
    with a per-SAMPLE validity mask; rides the on-device epoch
    accumulator (n_err/n_valid count tokens)."""

    def __init__(self, workflow, **kwargs):
        super(EvaluatorLM, self).__init__(workflow, **kwargs)
        self.labels = None
        self.demand("labels", "mask", "minibatch_class_vec")

    def tforward(self, read, write, params, ctx, state=None):
        logits = read(self.input)
        labels = read(self.labels).long()
        mask = read(self.mask)
        tok_mask = mask[:, None] * torch.ones(
            (1, labels.shape[1]), dtype=torch.float32, device=mask.device)
        # Sums over the whole minibatch, also when a mesh splits it.
        n_tok = ctx.batch_sum(tok_mask.sum())
        n_valid = torch.clamp_min(n_tok, 1.0)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        loss = ctx.batch_sum((nll * tok_mask).sum()) / n_valid
        pred = torch.argmax(logits, dim=-1)
        n_err = ctx.batch_sum(((pred != labels).float() * tok_mask).sum())
        ctx.set_loss(loss)
        ctx.add_metric("n_err", n_err)
        ctx.add_metric("n_valid", n_tok)
        return self._accumulate(read, state, n_err, n_tok, loss)


class GDEmbedding(GradientDescentBase):
    MAPPING = "embedding"


class GDTransformerBlock(GradientDescentBase):
    MAPPING = "transformer_block"


class GDMoETransformerBlock(GradientDescentBase):
    MAPPING = "moe_transformer_block"


class GDLMHead(GradientDescentBase):
    MAPPING = "lm_head"
