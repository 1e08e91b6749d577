"""On-device sub-population backend (the JAX package's
``population.vmap_backend``): one device job evaluates a whole
generation.

When every GA tune is a GD/optimizer hyperparameter, the vmapped
population path (:mod:`veles_tpu_torch.genetics.vmap_eval`) trains
every chromosome of a generation in one population step on one device.
The population engine hands a generation's gene matrix to
:meth:`VmapSubPopulation.evaluate` and gets the fitness vector back.
"""

from .. import resilience
from ..config import root, get as config_get
from ..error import Bug


class VmapSubPopulation(object):
    """Generation evaluator backend over ``PopulationEvaluator``;
    :meth:`applicable` gates it as the genetics standalone path gates
    its vmap evaluator."""

    def __init__(self, module, tunes, seed, epochs=None, device="cuda"):
        from ..genetics.vmap_eval import PopulationEvaluator
        self._evaluator = PopulationEvaluator(module, tunes, seed,
                                              epochs=epochs,
                                              device=device)

    @staticmethod
    def applicable(module, tunes):
        """True when the vmapped path can carry these tunes (every leaf
        a uniquely named GD/optimizer hyper) and the config enables it
        (``root.common.population.vmap``, default on)."""
        from ..genetics.vmap_eval import hyper_names
        if not bool(config_get(root.common.population.vmap, True)):
            return False
        return hyper_names(tunes) is not None

    def evaluate(self, genes_matrix):
        """The fitness vector of one generation's gene matrix — one
        vmapped device job over the whole sub-population."""
        fitnesses = self._evaluator.evaluate(genes_matrix)
        resilience.stats.incr("population.vmap_generations")
        return fitnesses

    def run_population(self, population, log=None):
        """Drives a genetics Population to completion, one vmapped
        device job per generation."""
        while not population.complete:
            batch = []
            while True:
                got = population.acquire(owner="vmap")
                if got is None:
                    break
                batch.append(got)
            if not batch:
                raise Bug("population stalled: nothing pending yet "
                          "generation incomplete")
            fitnesses = self.evaluate(
                [genes for _, genes in batch])
            for (index, _), fitness in zip(batch, fitnesses):
                if log is not None:
                    log("chromosome %d -> fitness %.6f", index,
                        float(fitness))
                population.record(index, float(fitness))
        return population.best
