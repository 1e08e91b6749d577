"""Genetic hyperparameter optimization (the JAX package's
``genetics``).

Config leaves wrapped in :class:`veles_tpu_torch.config.Tune` become
genes; an outer loop evaluates model runs and evolves the population.
:mod:`.core` holds the GA engine, :mod:`.vmap_eval` evaluates a whole
generation as one vmapped population step, and :mod:`.optimizer` drives
a run (standalone here; the coordinator and worker modes wait for the
data plane, ROADMAP A7a).
"""

from .core import (Chromosome, Population, applied_genes,  # noqa: F401
                   collect_tunes)
from .optimizer import GeneticsOptimizer  # noqa: F401
