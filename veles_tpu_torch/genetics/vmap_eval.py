"""Vmapped population evaluation (the JAX package's
``genetics.vmap_eval``): one population step per generation instead of
one run per chromosome.

Applicability: every ``Tune`` leaf must name a gradient-descent
hyperparameter (``learning_rate``, ``weights_decay``,
``gradient_moment``, their ``_bias`` variants, or a registered
optimizer's extra hypers such as Adam's betas).  These become tensor
inputs of the step (``GradientDescentBase.tupdate``'s ``hypers``),
applied to every GD unit.  Tunes that change shapes (layer sizes, the
batch) stay on the per-chromosome path.

Mechanics: the model workflow is built and initialized ONCE; its
parameters and states are tiled to a leading member axis (every
chromosome starts from the same weights);
``StepCompiler.compile_population`` maps the block step over
(params, states, hypers) with ``torch.func.vmap``, the minibatch shared;
the loader's own schedule drives the epochs; each chromosome's fitness
is read from its row of the evaluator's epoch accumulator at class
boundaries, as ``DecisionGD`` reads it (fitness = 1 − the minimum
validation error, or train error where there is no validation set).
"""

import numpy
import torch

from .. import prng
from ..config import root
from ..error import Bug
from ..launcher import Launcher
from ..loader.base import TRAIN, VALID

#: The classic GD hyper leaves (always tunable).
BASE_HYPER_ATTRS = frozenset((
    "learning_rate", "learning_rate_bias",
    "weights_decay", "weights_decay_bias",
    "gradient_moment", "gradient_moment_bias",
))


def hyper_attrs():
    """Tune leaf names the vmapped path can turn into step inputs: the
    classic learning rate / decay / momentum set plus every registered
    optimizer's extra hypers."""
    from ..znicz.optimizers import OPTIMIZERS
    names = set(BASE_HYPER_ATTRS)
    for opt in OPTIMIZERS.values():
        names.update(opt.EXTRA_HYPERS)
    return frozenset(names)


def hyper_names(tunes):
    """The hyper layout for a tune set, or ``None`` when any tune is not
    a (uniquely named) GD/optimizer hyperparameter."""
    attrs = hyper_attrs()
    names = []
    for path, _tune in tunes:
        leaf = path.rsplit(".", 1)[-1]
        if leaf not in attrs or leaf in names:
            return None
        names.append(leaf)
    return tuple(names) if names else None


def build_workflow(module, seed, device="cuda"):
    """Builds and initializes the model workflow on ``device`` without
    running it (the population driver owns the epoch loop)."""
    prng.reset()
    prng.get(0).seed(seed)
    state = {}

    def load(WorkflowClass, **kwargs):
        launcher = Launcher()
        wf = WorkflowClass(launcher, **kwargs)
        state["launcher"], state["wf"] = launcher, wf
        return wf, False

    def main(**kwargs):
        kwargs.setdefault("device", device)
        state["launcher"].initialize(**kwargs)

    module.run(load, main)
    return state["wf"], state["launcher"]


class PopulationEvaluator(object):
    """Evaluates a whole generation's chromosomes in one vmapped
    training run on ``device`` (the CUDA card unless it names the
    CPU)."""

    def __init__(self, module, tunes, seed, epochs=None, device="cuda"):
        self.names = hyper_names(tunes)
        if self.names is None:
            raise Bug("tunes are not all uniquely-named GD "
                      "hyperparameters — use the per-chromosome path")
        self.module = module
        self.seed = seed
        self.epochs = epochs
        #: The members' parameters and states after the last evaluate.
        self.last_population = None
        # Each Tune's default goes into the config, so the workflow is
        # built from plain numbers; the genes ride the hyper tensors.
        from .core import apply_genes
        apply_genes(root, tunes, [t.default for _, t in tunes])
        self.workflow, self.launcher = build_workflow(module, seed,
                                                      device)
        # The loader's schedule, so that every generation replays the
        # SAME epoch walk (reseeding alone is not enough: the shuffles
        # compose on the previous generation's last permutation).
        loader = self.workflow.loader
        loader.shuffled_indices.map_read()
        self._loader_indices = numpy.array(
            loader.shuffled_indices.mem, copy=True)
        self._loader_offset = loader.global_offset
        self._loader_epoch = loader.epoch_number
        compiler = self.workflow.compiler
        compiler.compile_population(self.names)
        if not any(n.endswith("/epoch_acc")
                   for n in compiler._state_vecs):
            raise Bug("population evaluation needs an EvaluatorBase "
                      "epoch accumulator in the step's chain")
        self._check_tuned_hypers()

    def _check_tuned_hypers(self):
        """Every tuned name must be read by at least one GD unit's
        optimizer, and a slot-backed hyper (sgd's gradient_moment
        needs velocity slots) must have its slots allocated."""
        from ..znicz.nn_units import GradientDescentBase
        gds = [u for u in self.workflow.units
               if isinstance(u, GradientDescentBase)]
        for name in self.names:
            base = name[:-len("_bias")] if name.endswith("_bias") \
                else name
            consumers = [gd for gd in gds
                         if base in gd.optimizer_obj.CONSUMED_HYPERS]
            if not consumers:
                raise Bug(
                    "tuning %s but no GD unit's optimizer consumes "
                    "it (optimizers in this workflow: %s) — tune a "
                    "hyperparameter the configured optimizer reads"
                    % (name, ", ".join(sorted(
                        {gd.optimizer for gd in gds}) or ["none"])))
            for gd in consumers:
                prefix = gd.optimizer_obj.SLOT_BACKED_HYPERS.get(base)
                if prefix and not any(
                        s.startswith(prefix) for s in gd.tstate):
                    raise Bug(
                        "tuning gradient_moment requires momentum "
                        "slots: give the GD units a nonzero baseline "
                        "gradient_moment so velocities are allocated"
                        if prefix == "velocity_" else
                        "tuning %s requires %s* slots on %s, which "
                        "were never allocated" %
                        (name, prefix, gd.name))

    def evaluate(self, genes_matrix, epochs=None):
        """Trains every chromosome for ``epochs`` full epochs; returns
        the fitness vector (1 − min validation error, or 1 − min train
        error for loaders with no validation set)."""
        wf = self.workflow
        loader = wf.loader
        compiler = wf.compiler
        device = compiler._device()
        genes = numpy.asarray(genes_matrix, dtype=numpy.float32)
        pop = genes.shape[0]
        epochs = epochs or self.epochs or \
            getattr(wf, "max_epochs", None) or \
            getattr(getattr(wf, "decision", None), "max_epochs",
                    None) or 3
        self.last_population = None
        pop_params, pop_states = compiler.population_arrays(pop)
        pop_hypers = torch.as_tensor(genes).to(device)
        consts = {str(id(v)): v.devmem for v in compiler.const_vectors}
        acc_keys = [n for n in pop_states
                    if n.endswith("/epoch_acc") or
                    n.endswith("/epoch_acc_c")]
        K = max(int(getattr(wf, "ticks_per_dispatch", 1) or 1), 8)
        min_err = {VALID: numpy.full(pop, numpy.inf),
                   TRAIN: numpy.full(pop, numpy.inf)}
        saw_class = {VALID: False, TRAIN: False}
        # The same randomness and data schedule in every generation:
        # reseed the generators and restore the loader's first
        # permutation, offset and epoch, so the epoch-end shuffles
        # replay the same sequence.
        prng.get(0).seed(self.seed)
        if getattr(loader, "prng_key", 0) != 0:
            prng.get(loader.prng_key).seed(self.seed)
        loader.shuffled_indices.map_write()
        loader.shuffled_indices.mem[...] = self._loader_indices
        loader.global_offset = self._loader_offset
        loader.epoch_number = self._loader_epoch
        generator = compiler._generator()
        start_epoch = loader.epoch_number
        while loader.epoch_number - start_epoch < epochs:
            blocks = loader.serve_block(K)
            cls = int(loader.minibatch_class)
            pop_params, pop_states = compiler._pop_block(
                pop_params, pop_states, blocks, consts, generator,
                cls == TRAIN, pop_hypers)
            if loader.last_minibatch and cls in min_err:
                for name in acc_keys:
                    if not name.endswith("/epoch_acc"):
                        continue
                    acc = pop_states[name].cpu().numpy()  # (P, 3, 4)
                    err = acc[:, cls, 0] / numpy.maximum(
                        acc[:, cls, 1], 1.0)
                    min_err[cls] = numpy.minimum(min_err[cls], err)
                    saw_class[cls] = True
                # The class's epoch closed: zero its accumulator rows
                # (as DecisionGD does after its fetch).
                for name in acc_keys:
                    pop_states[name][:, cls] = 0.0
        self.last_population = (pop_params, pop_states)
        cls = VALID if saw_class[VALID] else TRAIN
        return 1.0 - min_err[cls]
