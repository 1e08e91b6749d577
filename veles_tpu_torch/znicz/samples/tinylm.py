"""TinyLM — a causal transformer language-model workflow (the JAX
package's ``znicz/samples/tinylm.py``, dense path).

Embedding → N × TransformerBlock → LMHead (tied weights) → EvaluatorLM
→ DecisionGD → per-unit GD, the whole tick one fused step.

The bundled dataset is the **first-token recall** task: every label
equals the sequence's FIRST token, so the model cannot succeed without
attending across the whole (causal) context.  Run::

    python -m veles_tpu_torch veles_tpu_torch/znicz/samples/tinylm.py \
        --device cpu

(the default device is the CUDA card).  ``n_experts`` builds
Mixture-of-Experts blocks, ``pipelined`` one stage-stacked
PipelinedTransformerStack, ``seq_axis`` sequence-parallel attention —
each engaging its parallelism once a mesh carries the axis
(``veles_tpu_torch.parallel``).
"""

import numpy

from ...config import root, get as config_get
from ...loader.fullbatch import FullBatchLoader
from ...plumbing import Repeater
from ...accelerated_units import AcceleratedWorkflow
from ..attention import (Embedding, EvaluatorLM, GDEmbedding, GDLMHead,
                         GDMoETransformerBlock, GDPipelinedStack,
                         GDTransformerBlock, LMHead, MoETransformerBlock,
                         PipelinedTransformerStack, TransformerBlock)
from ..decision import DecisionGD


class FirstTokenLoader(FullBatchLoader):
    """Synthetic sequences whose every label is the first token."""

    MAPPING = "first_token_loader"

    def __init__(self, workflow, **kwargs):
        super(FirstTokenLoader, self).__init__(workflow, **kwargs)
        self.vocab_size = kwargs.get("vocab_size", 16)
        self.seq_len = kwargs.get("seq_len", 32)
        self.n_train = kwargs.get("n_train", 512)
        self.n_valid = kwargs.get("n_valid", 128)

    def load_data(self):
        rng = numpy.random.RandomState(7)
        n = self.n_valid + self.n_train
        tokens = rng.randint(0, self.vocab_size,
                             (n, self.seq_len)).astype(numpy.int32)
        labels = numpy.repeat(tokens[:, :1], self.seq_len, axis=1)
        self.original_data.mem = tokens
        self.original_labels.mem = labels.astype(numpy.int32)
        self.class_lengths = [0, self.n_valid, self.n_train]


class TinyLMWorkflow(AcceleratedWorkflow):
    """The LM training workflow."""

    def __init__(self, workflow, vocab_size=16, seq_len=32,
                 embed_dim=32, n_heads=4, n_blocks=1,
                 minibatch_size=64, learning_rate=0.01,
                 gradient_moment=0.9, max_epochs=8, seq_axis=None,
                 sp_mode="ring", sp_kernel=None, n_experts=0,
                 expert_axis=None, top_k=None, router_z_weight=None,
                 pipelined=False, stage_axis=None, n_microbatches=4,
                 schedule=None, n_chunks=None, fused_qkv=None,
                 loader_cls=FirstTokenLoader, loader_config=None,
                 **kwargs):
        super(TinyLMWorkflow, self).__init__(workflow, **kwargs)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        self.loader = loader_cls(
            self, minibatch_size=minibatch_size,
            vocab_size=vocab_size, seq_len=seq_len,
            **(loader_config or {}))
        self.loader.link_from(self.repeater)

        self.embedding = Embedding(
            self, vocab_size=vocab_size, embed_dim=embed_dim,
            name="embedding")
        self.embedding.link_from(self.loader)
        self.embedding.input = self.loader.minibatch_data

        self.forwards = [self.embedding]
        prev = self.embedding
        if pipelined and n_experts:
            raise ValueError(
                "pipelined=True with n_experts>0 is not supported — the "
                "pipelined stack holds dense blocks only")
        if pipelined:
            stack = PipelinedTransformerStack(
                self, n_blocks=n_blocks, n_heads=n_heads, causal=True,
                stage_axis=stage_axis, n_microbatches=n_microbatches,
                schedule=schedule, n_chunks=n_chunks,
                fused_qkv=fused_qkv, name="stack")
            stack.link_from(prev)
            stack.input = prev.output
            self.forwards.append(stack)
            prev = stack
            n_blocks = 0
        for i in range(n_blocks):
            if n_experts:
                block = MoETransformerBlock(
                    self, n_heads=n_heads, causal=True,
                    seq_axis=seq_axis, sp_mode=sp_mode,
                    sp_kernel=sp_kernel, n_experts=n_experts,
                    top_k=top_k, router_z_weight=router_z_weight,
                    fused_qkv=fused_qkv, expert_axis=expert_axis,
                    minibatch_class_vec=self.loader.minibatch_class_vec,
                    minibatch_mask=self.loader.minibatch_mask,
                    name="block%d" % i)
            else:
                block = TransformerBlock(
                    self, n_heads=n_heads, causal=True,
                    seq_axis=seq_axis, sp_mode=sp_mode,
                    sp_kernel=sp_kernel, fused_qkv=fused_qkv,
                    name="block%d" % i)
            block.link_from(prev)
            block.input = prev.output
            self.forwards.append(block)
            prev = block

        self.head = LMHead(self, vocab_size=vocab_size,
                           tie_to=self.embedding, name="head")
        self.head.link_from(prev)
        self.head.input = prev.output
        self.forwards.append(self.head)

        self.evaluator = EvaluatorLM(self)
        self.evaluator.link_from(self.head)
        self.evaluator.input = self.head.output
        self.evaluator.labels = self.loader.minibatch_labels
        self.evaluator.mask = self.loader.minibatch_mask
        self.evaluator.minibatch_class_vec = \
            self.loader.minibatch_class_vec

        self.decision = DecisionGD(self, max_epochs=max_epochs,
                                   evaluator=self.evaluator)
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "last_minibatch",
            "epoch_ended", "epoch_number")

        gd_kw = {"learning_rate": learning_rate,
                 "gradient_moment": gradient_moment}
        self.gds = []
        prev_gd = self.decision
        for unit in reversed(self.forwards):
            cls = {Embedding: GDEmbedding,
                   TransformerBlock: GDTransformerBlock,
                   MoETransformerBlock: GDMoETransformerBlock,
                   PipelinedTransformerStack: GDPipelinedStack,
                   LMHead: GDLMHead}[type(unit)]
            gd = cls(self, target=unit, **gd_kw)
            gd.link_from(prev_gd)
            self.gds.append(gd)
            prev_gd = gd

        self.repeater.link_from(prev_gd)
        self.repeater.gate_block = self.decision.complete
        self.end_point.link_from(prev_gd)
        self.end_point.gate_block = ~self.decision.complete


def run(load, main):
    cfg = root.tinylm
    load(TinyLMWorkflow,
         vocab_size=config_get(cfg.vocab_size, 16),
         seq_len=config_get(cfg.seq_len, 32),
         embed_dim=config_get(cfg.embed_dim, 32),
         n_heads=config_get(cfg.n_heads, 4),
         n_blocks=config_get(cfg.n_blocks, 1),
         n_experts=config_get(cfg.n_experts, 0),
         top_k=config_get(cfg.top_k, None),
         router_z_weight=config_get(cfg.router_z_weight, None),
         pipelined=config_get(cfg.pipelined, False),
         schedule=config_get(cfg.schedule, None),
         n_chunks=config_get(cfg.n_chunks, None),
         minibatch_size=config_get(cfg.minibatch_size, 64),
         learning_rate=config_get(cfg.learning_rate, 0.01),
         max_epochs=config_get(cfg.max_epochs, 8))
    main()
