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

The MoE block and the pipelined stack wait for ROADMAP A6.
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
                            attend=None, mlp=None):
    """Pure pre-LN block: x + MHA(LN(x)), then + MLP(LN(·)).  ``mlp``
    receives the post-LN activations (B, S, E) and returns the FFN
    output to be residual-added; None → the dense w1/w2 MLP."""
    from ..ops import attention as A
    B, S, E = x.shape

    def dot(a, w, b):
        return _dot(a, w, cdt) + b

    h = _layer_norm(x, params["ln1_g"], params["ln1_b"])
    if "wqkv" in params:
        # One (E, 3E) product; the head-major column layout makes the
        # q/k/v split a reshape + index.
        qkv = dot(h, params["wqkv"], params["bqkv"]).reshape(
            B, S, n_heads, 3, -1)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    else:
        q = dot(h, params["wq"], params["bq"]).reshape(B, S, n_heads, -1)
        k = dot(h, params["wk"], params["bk"]).reshape(B, S, n_heads, -1)
        v = dot(h, params["wv"], params["bv"]).reshape(B, S, n_heads, -1)
    if attend is None:
        attend = functools.partial(A.attention, causal=causal)
    attn = attend(q.to(cdt), k.to(cdt), v.to(cdt)).reshape(B, S, E)
    x = x + dot(attn, params["wo"], params["bo"])
    h = _layer_norm(x, params["ln2_g"], params["ln2_b"])
    if mlp is not None:
        x = x + mlp(h)
    else:
        h = torch.relu(dot(h, params["w1"], params["b1"]))
        x = x + dot(h, params["w2"], params["b2"])
    return x.float()


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
    construction).  ``seq_axis`` (sequence-parallel attention) waits
    for ROADMAP A6.
    """

    MAPPING = "transformer_block"

    PARAM_NAMES = ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo",
                   "bq", "bk", "bv", "bo",
                   "ln2_g", "ln2_b", "w1", "b1", "w2", "b2")

    def __init__(self, workflow, **kwargs):
        super(TransformerBlock, self).__init__(workflow, **kwargs)
        self.n_heads = kwargs.get("n_heads", 4)
        self.mlp_ratio = kwargs.get("mlp_ratio", 4)
        self.causal = kwargs.get("causal", True)
        if kwargs.get("seq_axis"):
            raise NotImplementedError(
                "sequence-parallel attention (seq_axis=%r) is not yet "
                "ported (ROADMAP A6)" % kwargs["seq_axis"])
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
        return A.attention(q, k, v, causal=self.causal)

    def tforward(self, read, write, params, ctx, state=None):
        x = read(self.input)

        def apply(p, h):
            return transformer_block_apply(
                p, h, self.n_heads, self.causal, self.compute_dtype,
                attend=self._attend)

        if remat_enabled(self.remat) and torch.is_grad_enabled() and \
                not torch._C._functorch.is_functorch_wrapped_tensor(x):
            out = checkpoint(apply, params, x, use_reentrant=False)
        else:
            out = apply(params, x)
        write(self.output, out)


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
        n_valid = torch.clamp_min(tok_mask.sum(), 1.0)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        loss = (nll * tok_mask).sum() / n_valid
        pred = torch.argmax(logits, dim=-1)
        n_err = ((pred != labels).float() * tok_mask).sum()
        ctx.set_loss(loss)
        ctx.add_metric("n_err", n_err)
        ctx.add_metric("n_valid", tok_mask.sum())
        return self._accumulate(read, state, n_err, tok_mask.sum(),
                                loss)


class GDEmbedding(GradientDescentBase):
    MAPPING = "embedding"


class GDTransformerBlock(GradientDescentBase):
    MAPPING = "transformer_block"


class GDLMHead(GradientDescentBase):
    MAPPING = "lm_head"
