"""The genetic-algorithm engine (the JAX package's ``genetics.core``).

Config leaves wrapped in ``Tune(default, min, max)`` become real-valued
genes; a fixed-size population evolves by fitness-proportional
selection, BLX-α blend crossover and clipped gaussian mutation, with
elitism, and fitness is read from a finished model run.  The draws are
the JAX package's numpy draws, in the same order, so the same seed
evolves the same genes in both packages.  Evaluation bookkeeping
(pending / in flight / owner) lives in the :class:`Population`, so the
local loop and a coordinator drive the same object.
"""

import collections
import contextlib

import numpy

from ..config import Config, Tune, override_scope
from ..error import Bug
from ..logger import Logger


def collect_tunes(node, prefix=""):
    """Walks a config (sub)tree and returns ``[(path, Tune), ...]``
    sorted by path — the gene layout (reference:
    genetics/config.py:164 ``fix_config`` walk)."""
    found = []
    for key, value in node.items():
        path = "%s.%s" % (prefix, key) if prefix else key
        if isinstance(value, Tune):
            found.append((path, value))
        elif isinstance(value, Config):
            found.extend(collect_tunes(value, path))
    found.sort(key=lambda p: p[0])
    return found


def apply_genes(root_node, tunes, genes):
    """Writes concrete gene values into the config tree, replacing the
    ``Tune`` leaves (integer tunes round)."""
    if len(tunes) != len(genes):
        raise Bug("gene/tune layout mismatch: %d tunes vs %d genes — "
                  "coordinator and worker must run with identical "
                  "Tune() config overrides" % (len(tunes), len(genes)))
    for (path, tune), value in zip(tunes, genes):
        parts = path.split(".")
        node = root_node
        for part in parts[:-1]:
            node = getattr(node, part)
        setattr(node, parts[-1], _concrete(tune, value))


def _concrete(tune, value):
    if isinstance(tune.default, int) and isinstance(tune.min, int) \
            and isinstance(tune.max, int):
        return int(round(value))
    return float(value)


@contextlib.contextmanager
def applied_genes(root_node, tunes, genes):
    """Gene overrides as a SCOPE: concrete values are written into the
    config tree for the duration and the touched leaves restored
    exactly (the ``Tune`` objects included) on exit.

    :func:`apply_genes` mutates the global tree destructively — fine
    for a subprocess evaluation that exits afterwards, but an
    in-process multi-member evaluation (genetics standalone mode,
    population lineage builds) leaks one chromosome's genes into the
    next chromosome's run.  Every in-process evaluation path wraps the
    run in this scope instead."""
    if len(tunes) != len(genes):
        raise Bug("gene/tune layout mismatch: %d tunes vs %d genes — "
                  "coordinator and worker must run with identical "
                  "Tune() config overrides" % (len(tunes), len(genes)))
    overrides = {path: _concrete(tune, value)
                 for (path, tune), value in zip(tunes, genes)}
    with override_scope(root_node, overrides):
        yield


class Chromosome(object):
    """One candidate: a gene vector + its measured fitness
    (reference: genetics/core.py:133)."""

    def __init__(self, genes, origin="random"):
        self.genes = numpy.asarray(genes, dtype=numpy.float64)
        self.origin = origin
        self.fitness = None

    def overrides(self, tunes):
        """``{path: concrete value}`` for logging/subprocess argv."""
        return {path: _concrete(tune, g)
                for (path, tune), g in zip(tunes, self.genes)}

    def __repr__(self):
        return "Chromosome(%s, fitness=%s)" % (
            numpy.array2string(self.genes, precision=4), self.fitness)


class Population(Logger):
    """A fixed-size evolving population with evaluation bookkeeping
    (reference: genetics/core.py:371).

    kwargs: ``generations`` — evolve this many generations then stop
    (None = run until ``stagnation`` generations without improvement);
    ``elite_ratio`` — survivors per generation; ``mutation_rate`` —
    per-gene mutation probability; ``seed`` — GA's own RNG seed
    (independent of model-evaluation seeding).
    """

    def __init__(self, tunes, size, generations=None, **kwargs):
        super(Population, self).__init__()
        if not tunes:
            raise Bug("no Tune() leaves found in the config tree — "
                      "nothing to optimize (wrap values as "
                      "root.x.y = Tune(default, min, max))")
        if size < 2:
            raise Bug("population size must be >= 2")
        self.tunes = list(tunes)
        self.size = int(size)
        self.generations = generations
        self.elite_count = max(1, int(
            self.size * kwargs.get("elite_ratio", 0.25)))
        self.mutation_rate = kwargs.get("mutation_rate", 0.2)
        self.blend_alpha = kwargs.get("blend_alpha", 0.5)
        self.stagnation = kwargs.get("stagnation", 8)
        self._rng = numpy.random.RandomState(
            kwargs.get("seed", 0xA11CE))
        self.generation = 0
        self.best = None
        self.history = []  # best fitness per completed generation
        self._lo = numpy.array([t.min for _, t in self.tunes],
                               dtype=numpy.float64)
        self._hi = numpy.array([t.max for _, t in self.tunes],
                               dtype=numpy.float64)
        defaults = numpy.array(
            [float(t.default) for _, t in self.tunes])
        self.chromosomes = [Chromosome(defaults, origin="default")]
        while len(self.chromosomes) < self.size:
            self.chromosomes.append(Chromosome(
                self._rng.uniform(self._lo, self._hi),
                origin="random"))
        self._pending = collections.deque(range(self.size))
        self._inflight = {}  # index -> owner

    # -- evaluation bookkeeping (local loop AND coordinator use this) ------

    def acquire(self, owner="local"):
        """Takes the next unevaluated chromosome; ``None`` when none
        is pending (all evaluated or in flight)."""
        if not self._pending:
            return None
        index = self._pending.popleft()
        self._inflight[index] = owner
        return index, self.chromosomes[index].genes.copy()

    def record(self, index, fitness):
        """Stores a measured fitness; evolves the generation when it
        was the last outstanding one."""
        self._inflight.pop(index, None)
        chromo = self.chromosomes[index]
        if chromo.fitness is None:
            chromo.fitness = float(fitness)
        if self._generation_evaluated():
            self._on_generation_done()

    def release(self, owner):
        """Requeues every chromosome in flight with a dropped owner
        (coordinator's ``drop_slave`` path)."""
        for index, who in list(self._inflight.items()):
            if who == owner:
                del self._inflight[index]
                self._pending.appendleft(index)

    def _generation_evaluated(self):
        return not self._pending and not self._inflight and \
            all(c.fitness is not None for c in self.chromosomes)

    # -- evolution ---------------------------------------------------------

    @property
    def complete(self):
        """True once the final generation has been fully evaluated."""
        if not self._generation_evaluated():
            return False
        if self.generations is not None:
            return self.generation + 1 >= self.generations
        return self._stagnated()

    def _stagnated(self):
        if len(self.history) < self.stagnation + 1:
            return False
        recent = self.history[-self.stagnation:]
        return max(recent) <= self.history[-self.stagnation - 1]

    def _on_generation_done(self):
        ranked = sorted(self.chromosomes,
                        key=lambda c: c.fitness, reverse=True)
        if self.best is None or \
                ranked[0].fitness > self.best.fitness:
            self.best = Chromosome(ranked[0].genes,
                                   origin="best-g%d" % self.generation)
            self.best.fitness = ranked[0].fitness
        self.history.append(ranked[0].fitness)
        self.info(
            "generation %d done: best %.6f, mean %.6f (%s)",
            self.generation, ranked[0].fitness,
            float(numpy.mean([c.fitness for c in self.chromosomes])),
            ", ".join("%s=%s" % kv
                      for kv in ranked[0].overrides(self.tunes)
                      .items()))
        if not self.complete:
            self._evolve(ranked)

    def _evolve(self, ranked):
        """Elitism + roulette parents + BLX-α crossover + gaussian
        mutation (reference operator families: core.py:514-801)."""
        elite = [Chromosome(c.genes, origin="elite")
                 for c in ranked[:self.elite_count]]
        for e, src in zip(elite, ranked[:self.elite_count]):
            e.fitness = src.fitness  # survivors keep their score
        fitnesses = numpy.array([c.fitness for c in ranked])
        weights = fitnesses - fitnesses.min() + 1e-9
        probs = weights / weights.sum()
        children = []
        while len(elite) + len(children) < self.size:
            i, j = self._rng.choice(len(ranked), size=2, p=probs)
            children.append(self._child(ranked[i], ranked[j]))
        self.generation += 1
        self.chromosomes = elite + children
        # Only the new children need evaluation.
        self._pending = collections.deque(
            range(len(elite), self.size))
        self._inflight.clear()

    def _child(self, p1, p2):
        lo = numpy.minimum(p1.genes, p2.genes)
        hi = numpy.maximum(p1.genes, p2.genes)
        span = hi - lo
        genes = self._rng.uniform(lo - self.blend_alpha * span,
                                  hi + self.blend_alpha * span)
        mutate = self._rng.random_sample(len(genes)) < \
            self.mutation_rate
        sigma = 0.1 * (self._hi - self._lo)
        genes = numpy.where(
            mutate, genes + self._rng.normal(0.0, 1.0,
                                             len(genes)) * sigma,
            genes)
        return Chromosome(numpy.clip(genes, self._lo, self._hi),
                          origin="child-g%d" % (self.generation + 1))
