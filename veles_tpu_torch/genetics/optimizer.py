"""Optimization run modes (the JAX package's ``genetics.optimizer``).

* **standalone** — evaluates chromosomes in this process: a whole
  generation at once through the vmapped population evaluator
  (:mod:`.vmap_eval`) when every tune is a GD hyperparameter, otherwise
  one in-process run (or one ``python -m veles_tpu_torch`` child
  process, ``root.common.genetics.subprocess``) per chromosome; evolves
  and repeats.
* **coordinator** (``-l``) — an :class:`OptimizationWorkflow` served
  by a :class:`~veles_tpu_torch.server.Server`: jobs are chromosomes,
  updates are fitnesses, a dropped worker's chromosomes requeue;
* **worker** (``-m``) — the same workflow evaluates chromosomes in
  this process in a :class:`~veles_tpu_torch.client.Client`'s loop and
  reports their fitness.

Every evaluation run is seeded the same (``--random-seed`` or 1234), so
chromosomes differ only in their genes.  Runs go to the device the
command line names (``--device``; the CUDA card by default).
"""

import json
import os
import subprocess
import sys
import tempfile

from ..config import root
from ..error import Bug
from ..harness import FITNESS_KEY, run_workflow_module, seed_to_int
from ..json_encoders import dump_json
from ..launcher import Launcher
from ..logger import Logger
from ..workflow import Workflow
from .core import Population, applied_genes, collect_tunes, _concrete


def evaluate_chromosome(module, tunes, genes, seed,
                        fitness_key=FITNESS_KEY, device="cuda"):
    """Runs the model module once on ``device`` with the chromosome's
    genes in the config tree (as a scope: the touched leaves are put
    back afterwards); returns the fitness scalar."""
    with applied_genes(root, tunes, genes):
        wf = run_workflow_module(module, seed=seed, device=device)
        results = wf.gather_results()
    if fitness_key not in results:
        raise Bug("model results carry no %r — the workflow needs an "
                  "IResultProvider exposing a fitness metric (the "
                  "Decision unit provides it)" % fitness_key)
    return float(results[fitness_key])


def evaluate_chromosome_subprocess(module_path, tunes, genes, seed,
                                   fitness_key=FITNESS_KEY,
                                   extra_argv=(), timeout=None,
                                   device="cuda"):
    """The same through a ``python -m veles_tpu_torch`` child process
    on ``device`` (full isolation at the cost of a start per run);
    ``timeout`` (seconds) bounds the child."""
    overrides = ["root.%s=%r" % (path, _concrete(tune, gene))
                 for (path, tune), gene in zip(tunes, genes)]
    with tempfile.NamedTemporaryFile(
            mode="r", suffix=".json", delete=False) as tmp:
        result_path = tmp.name
    try:
        argv = [sys.executable, "-m", "veles_tpu_torch", module_path] + \
            overrides + ["--result-file", result_path,
                         "--random-seed", str(seed),
                         "--device", device,
                         "-v", "warning"] + list(extra_argv)
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise Bug("evaluation subprocess failed (rc=%d): %s" %
                      (proc.returncode, proc.stderr[-1000:]))
        with open(result_path) as fin:
            results = json.load(fin)["results"]
        return float(results[fitness_key])
    finally:
        try:
            os.unlink(result_path)
        except OSError:
            pass


class OptimizationWorkflow(Workflow):
    """The GA as a workflow the data plane drives: jobs are
    chromosomes, updates are fitnesses.  The same class serves both
    sides: the coordinator holds the live population, a worker only
    evaluates (in this process, on ``device``)."""

    def __init__(self, launcher, module, population=None, seed=1234,
                 device="cuda", **kwargs):
        super(OptimizationWorkflow, self).__init__(launcher, **kwargs)
        self.module = module
        self.population = population
        self.eval_seed = seed
        self.device = device
        self.negotiates_on_connect = False

    # -- the Server's hooks ------------------------------------------------

    def should_stop_serving(self):
        return self.population is not None and \
            self.population.complete

    def generate_data_for_slave(self, slave=None):
        got = self.population.acquire(owner=slave)
        if got is None:
            return None
        index, genes = got
        return {"index": index, "genes": genes}

    def generate_initial_data_for_slave(self, slave=None):
        return None

    def apply_data_from_slave(self, data, slave=None):
        self.population.record(data["index"], data["fitness"])

    def drop_slave(self, slave=None):
        self.population.release(slave)

    def do_job(self, data, update, callback):
        """Worker side: evaluates one chromosome in this process."""
        fitness = evaluate_chromosome(
            self.module, self._tunes_cached, data["genes"],
            self.eval_seed, device=self.device)
        callback({"index": data["index"], "fitness": fitness})

    @property
    def _tunes_cached(self):
        # Captured once: the layout of the config's Tune leaves.
        if not hasattr(self, "_tunes_"):
            self._tunes_ = collect_tunes(root)
        return self._tunes_

    @property
    def checksum(self):
        """Coordinator and workers must optimize the same model module,
        not merely share this file."""
        base = super(OptimizationWorkflow, self).checksum
        mod = self.module
        name = "none" if mod is None else os.path.basename(
            getattr(mod, "__file__", None) or
            getattr(mod, "__name__", "module"))
        return base + "_" + name


class GeneticsOptimizer(Logger):
    """Drives an optimization run in the mode the command line chose."""

    def __init__(self, main, size, generations=None, **kwargs):
        super(GeneticsOptimizer, self).__init__()
        self.main = main
        self.module = main.module
        args = main.args
        self.listen_address = getattr(args, "listen_address", None)
        self.master_address = getattr(args, "master_address", None)
        self.result_file = args.result_file
        self.device = getattr(args, "device", "cuda")
        self.seed = seed_to_int(args.random_seed)
        self.subprocess_mode = kwargs.get("subprocess_mode", bool(
            root.common.genetics.get("subprocess", False)))
        self.tunes = collect_tunes(root)
        self.population = None
        #: The coordinator's server, once it listens (its ``port``).
        self.server = None
        if not self.master_address:
            self.population = Population(
                self.tunes, size, generations,
                seed=self.seed,
                **{k: v for k, v in kwargs.items()
                   if k in ("elite_ratio", "mutation_rate",
                            "blend_alpha", "stagnation")})

    def run(self):
        if self.master_address:
            self._run_worker()
        elif self.listen_address:
            self._run_coordinator()
        else:
            self._run_standalone()
        if self.population is not None:
            return self.population.best
        return None

    # -- modes -------------------------------------------------------------

    def _run_standalone(self):
        pop = self.population
        evaluator = self._make_vmap_evaluator()
        while not pop.complete:
            if evaluator is not None:
                batch = []
                while True:
                    got = pop.acquire()
                    if got is None:
                        break
                    batch.append(got)
                if not batch:
                    raise Bug("population stalled: nothing pending "
                              "yet generation incomplete")
                fitnesses = evaluator.evaluate(
                    [genes for _, genes in batch])
                for (index, _), fitness in zip(batch, fitnesses):
                    self.debug("chromosome %d -> fitness %.6f",
                               index, fitness)
                    pop.record(index, float(fitness))
                continue
            got = pop.acquire()
            if got is None:
                raise Bug("population stalled: nothing pending yet "
                          "generation incomplete")
            index, genes = got
            if self.subprocess_mode:
                fitness = evaluate_chromosome_subprocess(
                    self.module.__file__, self.tunes, genes,
                    self.seed, device=self.device)
            else:
                fitness = evaluate_chromosome(
                    self.module, self.tunes, genes, self.seed,
                    device=self.device)
            self.debug("chromosome %d -> fitness %.6f", index,
                       fitness)
            pop.record(index, fitness)
        self._finish()

    def _make_vmap_evaluator(self):
        """The vmapped generation evaluator when every tune is a GD
        hyperparameter; None → the per-chromosome path."""
        if self.subprocess_mode or not bool(
                root.common.genetics.get("vmap", True)):
            return None
        from .vmap_eval import PopulationEvaluator, hyper_names
        if hyper_names(self.tunes) is None:
            return None
        try:
            return PopulationEvaluator(self.module, self.tunes,
                                       self.seed, device=self.device)
        except Bug as e:
            self.warning("vmapped population evaluation unavailable "
                         "(%s); using per-chromosome runs", e)
            return None

    def _run_coordinator(self):
        from ..server import Server
        wf = OptimizationWorkflow(Launcher(), self.module,
                                  population=self.population,
                                  seed=self.seed, device=self.device)
        server = self.server = Server(self.listen_address, wf)
        try:
            server.wait()
        finally:
            server.stop()
            server.join(timeout=10.0)
        self._finish()

    def _run_worker(self):
        from ..client import Client
        wf = OptimizationWorkflow(Launcher(), self.module,
                                  seed=self.seed, device=self.device)
        Client(self.master_address, wf).run()

    def _finish(self):
        best = self.population.best
        if best is None:
            self.warning("optimization produced no evaluated "
                         "chromosome")
            return
        overrides = best.overrides(self.tunes)
        self.info("optimization done after %d generation(s): best "
                  "fitness %.6f with %s",
                  self.population.generation + 1, best.fitness,
                  ", ".join("%s=%s" % kv for kv in overrides.items()))
        if self.result_file:
            dump_json({
                "mode": "genetics",
                "generations": self.population.generation + 1,
                "population": self.population.size,
                "best_fitness": best.fitness,
                "best_config": {"root.%s" % k: v
                                for k, v in overrides.items()},
                "history": self.population.history,
            }, self.result_file)
            self.info("optimization results -> %s", self.result_file)
