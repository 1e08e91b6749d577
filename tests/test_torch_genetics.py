"""The port's genetics (``veles_tpu_torch.genetics``) against the JAX
package's, on the CPU.

* The GA engine: the same tunes give the same gene layout, and the same
  seed and fitnesses evolve the same genes, generation by generation,
  bit for bit (the numpy draws are the JAX package's).
* The vmapped MNIST evaluator: the port's ``PopulationEvaluator`` and
  the JAX package's, given the same genes, read the same fitnesses —
  within 1e-6 for the members whose training is stable (lr 0.005 and
  0.08: the fitness is a count of errors over the validation set, and
  float noise does not move it) and within JAX's own 0.02 for the lr-0.3
  member, which diverges to chance level, where the two packages' float
  roundings take different paths.
* Inside the port, the vmapped population equals per-chromosome runs
  (``evaluate_chromosome``) within 1e-6, two generations with the same
  genes read equal fitnesses, and topology tunes are rejected.
* ``--optimize`` through the command line, the subprocess evaluation,
  and the coordinator/worker modes over a socket (jobs are chromosomes,
  updates are fitnesses), run under
  ``test_torch_network.kept_process_state``.

Every test restores both packages' ``root`` trees (``_kept_roots``)."""

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy
import pytest
import torch

import veles_tpu.prng as jprng
from veles_tpu.config import Tune as JTune, root as jroot
from veles_tpu.genetics import (Population as JPopulation,
                                collect_tunes as jcollect)
from veles_tpu.genetics.vmap_eval import \
    PopulationEvaluator as JEvaluator

from veles_tpu_torch import prng as tprng
from veles_tpu_torch import resilience
from veles_tpu_torch.__main__ import Main, import_workflow_module
from veles_tpu_torch.config import Tune, root as troot
from veles_tpu_torch.error import Bug
from veles_tpu_torch.genetics import (Population, applied_genes,
                                      collect_tunes)
from veles_tpu_torch.genetics.core import apply_genes
from veles_tpu_torch.genetics.optimizer import (
    GeneticsOptimizer, evaluate_chromosome,
    evaluate_chromosome_subprocess)
from veles_tpu_torch.genetics.vmap_eval import (PopulationEvaluator,
                                                hyper_names)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TMNIST = os.path.join(REPO, "veles_tpu_torch", "znicz", "samples",
                      "mnist.py")
JMNIST = os.path.join(REPO, "veles_tpu", "znicz", "samples", "mnist.py")
GENES = [[0.005], [0.08], [0.3]]
#: The members of GENES whose training is stable.
STABLE = [0, 1]


def _config_nodes(node):
    out = [(node, dict(node.__dict__))]
    for _, value in node.items():
        if isinstance(value, type(node)):
            out.extend(_config_nodes(value))
    return out


#: No dataset directory: both MNIST samples take scikit-learn's digits.
NO_DATASETS = "/nonexistent/veles-datasets"


def _clean_slate():
    """The knobs these tests read, set alike in both trees whatever an
    earlier test file left there: no ``root.mnist`` settings, no
    snapshot, guardian or population settings, the default precision,
    optimizer and loader, and no dataset directory."""
    for r in (jroot, troot):
        r.mnist.reset()
        r.ga_test.reset()
        for key in ("snapshotter", "guardian", "snapshot_disabled",
                    "genetics", "population"):
            r.common.__dict__.pop(key, None)
        r.common.engine.__dict__.pop("optimizer", None)
        r.common.engine.precision_level = 0
        r.common.loader.train_ratio = 1.0
        r.common.loader.shuffle_limit = -1
    troot.common.__dict__.pop("dirs", None)
    for r in (jroot, troot):
        r.common.dirs.datasets = NO_DATASETS


@pytest.fixture(autouse=True)
def _kept_roots():
    """Both packages' whole config trees, the port's generators and
    chaos plan, put back after the test, which starts from
    ``_clean_slate``; at most two
    intra-op threads during it (the suite runs files in parallel
    workers)."""
    saved = _config_nodes(jroot) + _config_nodes(troot)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    _clean_slate()
    tprng.reset()
    resilience.reset()
    yield
    torch.set_num_threads(threads)
    for node, state in saved:
        node.__dict__.clear()
        node.__dict__.update(state)
    tprng.reset()
    resilience.reset()


def _set_lr_tune(r, tune_cls, epochs=2):
    r.mnist.max_epochs = epochs
    r.mnist.learning_rate = tune_cls(0.01, 0.0001, 0.5)


def _port_evaluator(seed=42):
    _set_lr_tune(troot, Tune)
    tunes = [(p, t) for p, t in collect_tunes(troot)
             if p == "mnist.learning_rate"]
    assert hyper_names(tunes) == ("learning_rate",)
    tprng.reset()
    module = import_workflow_module(TMNIST)
    return PopulationEvaluator(module, tunes, seed=seed, device="cpu"), \
        module, tunes


def _synthetic(r, tune_cls):
    r.ga_test.x = tune_cls(0.0, -1.0, 1.0)
    r.ga_test.y = tune_cls(0.0, -1.0, 1.0)
    r.ga_test.n = tune_cls(4, 1, 9)


def test_collect_apply_and_scoped_genes_match_jax():
    _synthetic(jroot, JTune)
    _synthetic(troot, Tune)
    jt, tt = jcollect(jroot.ga_test), collect_tunes(troot.ga_test)
    assert [p for p, _ in tt] == [p for p, _ in jt] == ["n", "x", "y"]
    with applied_genes(troot.ga_test, tt, [2.7, 0.5, -0.25]):
        assert (troot.ga_test.n, troot.ga_test.x, troot.ga_test.y) == \
            (3, 0.5, -0.25)
    # The scope puts the Tune objects back.
    assert [t for _, t in collect_tunes(troot.ga_test)] == \
        [t for _, t in tt]
    apply_genes(troot.ga_test, tt, [2.7, 0.5, -0.25])
    assert troot.ga_test.get("n") == 3
    with pytest.raises(Bug):
        Population([], 4)


@pytest.mark.parametrize("size,generations,seed", [(12, 6, 3), (4, 3, 1),
                                                   (7, 5, 0xA11CE)])
def test_evolution_gives_jax_genes_for_the_same_seed(size, generations,
                                                     seed):
    """Both engines driven with the same fitness function evolve the
    same chromosomes (origin, genes bit for bit), the same history and
    the same best."""
    _synthetic(jroot, JTune)
    _synthetic(troot, Tune)
    target = numpy.array([5.0, 0.7, -0.3])

    def fitness(genes):
        return -float(numpy.sum((genes - target) ** 2))

    pops = [JPopulation(jcollect(jroot.ga_test), size, generations,
                        seed=seed),
            Population(collect_tunes(troot.ga_test), size, generations,
                       seed=seed)]
    while not pops[0].complete:
        assert not pops[1].complete
        genes = [[c.genes.copy() for c in p.chromosomes] for p in pops]
        for a, b in zip(*genes):
            assert numpy.array_equal(a, b)
        assert [c.origin for c in pops[0].chromosomes] == \
            [c.origin for c in pops[1].chromosomes]
        for p in pops:
            got = p.acquire()
            while got is not None:
                p.record(got[0], fitness(got[1]))
                got = p.acquire()
    assert pops[1].complete
    assert pops[0].history == pops[1].history
    assert numpy.array_equal(pops[0].best.genes, pops[1].best.genes)
    assert pops[1].best.fitness > -1.0


def test_vmapped_mnist_fitness_matches_jax():
    """The port's vmapped evaluator and the JAX package's read the same
    fitnesses for the same genes (stable members within 1e-6, the
    diverging lr-0.3 member within 0.02)."""
    evaluator, _, _ = _port_evaluator()
    got = evaluator.evaluate(GENES)
    _set_lr_tune(jroot, JTune)
    jtunes = [(p, t) for p, t in jcollect(jroot)
              if p == "mnist.learning_rate"]
    from veles_tpu.__main__ import import_workflow_module as jimport
    jprng.reset()
    want = JEvaluator(jimport(JMNIST), jtunes, seed=42).evaluate(GENES)
    assert got.shape == want.shape == (3,)
    numpy.testing.assert_allclose(got[STABLE], want[STABLE], atol=1e-6)
    numpy.testing.assert_allclose(got, want, atol=0.02)
    assert got[1] > 0.8


def test_vmapped_population_matches_sequential():
    """The counterpart of ``tests/test_genetics.py::
    test_vmapped_population_matches_sequential``, held tighter: the
    vmapped generation equals per-chromosome in-process runs within
    1e-6 (JAX holds 0.02)."""
    evaluator, module, tunes = _port_evaluator()
    vmapped = evaluator.evaluate(GENES)
    sequential = []
    for g in GENES:
        tprng.reset()
        sequential.append(evaluate_chromosome(module, tunes, list(g),
                                              seed=42, device="cpu"))
    numpy.testing.assert_allclose(vmapped, sequential, atol=1e-6)
    assert vmapped[1] > 0.8


def test_evaluator_is_generation_stable():
    evaluator, _, _ = _port_evaluator(seed=7)
    first = evaluator.evaluate([[0.02], [0.2]])
    second = evaluator.evaluate([[0.02], [0.2]])
    assert numpy.array_equal(first, second)
    members = evaluator.last_population[0]
    assert all(t.shape[0] == 2 for t in members.values())


def test_topology_and_unconsumed_tunes_are_rejected():
    troot.ga_test.learning_rate = Tune(0.01, 0.001, 0.1)
    troot.ga_test.n_layers = Tune(2, 1, 4)
    assert hyper_names(collect_tunes(troot.ga_test)) is None
    troot.ga_test.reset()
    troot.ga_test.sub.learning_rate = Tune(0.01, 0.001, 0.1)
    troot.ga_test.other.learning_rate = Tune(0.02, 0.001, 0.1)
    assert hyper_names(collect_tunes(troot.ga_test)) is None
    # beta1 is a GA-tunable name (Adam's), but MNIST's GD units run sgd.
    troot.mnist.max_epochs = 1
    troot.mnist.beta1 = Tune(0.9, 0.8, 0.99)
    tunes = [(p, t) for p, t in collect_tunes(troot)
             if p == "mnist.beta1"]
    assert hyper_names(tunes) == ("beta1",)
    with pytest.raises(Bug, match="no GD unit's optimizer consumes"):
        PopulationEvaluator(import_workflow_module(TMNIST), tunes,
                            seed=1, device="cpu")


def test_optimize_cli(tmp_path):
    """``--optimize 4:2`` on the CPU: the counterpart of
    ``tests/test_genetics.py::test_optimize_mnist_cli``."""
    result = tmp_path / "ga.json"
    rc = Main([TMNIST, "root.mnist.max_epochs=2",
               "root.mnist.learning_rate=Tune(0.0005, 0.0001, 0.5)",
               "--optimize", "4:2", "--device", "cpu",
               "--result-file", str(result),
               "--random-seed", "42", "-v", "warning"]).run()
    assert rc == 0
    data = json.loads(result.read_text())
    assert data["mode"] == "genetics"
    assert data["generations"] == 2 and data["population"] == 4
    assert len(data["history"]) == 2
    assert data["best_fitness"] > data["history"][0] - 1e-9
    assert data["best_fitness"] > 0.5
    assert "root.mnist.learning_rate" in data["best_config"]


def test_optimize_per_chromosome_path_matches_the_vmapped(tmp_path):
    """``root.common.genetics.vmap = False`` evaluates each chromosome
    in its own in-process run: the same history and best genes as the
    vmapped generation (fitnesses within 1e-6)."""
    runs = []
    for vmap in ("True", "False"):
        result = tmp_path / ("ga_%s.json" % vmap)
        rc = Main([TMNIST, "root.mnist.max_epochs=2",
                   "root.mnist.learning_rate=Tune(0.01, 0.0001, 0.5)",
                   "root.common.genetics.vmap=%s" % vmap,
                   "--optimize", "3:2", "--device", "cpu",
                   "--result-file", str(result),
                   "--random-seed", "42", "-v", "warning"]).run()
        assert rc == 0
        runs.append(json.loads(result.read_text()))
    assert runs[0]["best_config"] == runs[1]["best_config"]
    assert runs[0]["history"] == pytest.approx(runs[1]["history"],
                                               abs=1e-6)


def test_subprocess_evaluation_matches_in_process(monkeypatch):
    """One chromosome through ``python -m veles_tpu_torch`` in a child
    process (bounded by a timeout) reads the in-process fitness."""
    troot.mnist.max_epochs = 2
    troot.mnist.learning_rate = Tune(0.01, 0.0001, 0.5)
    tunes = [(p, t) for p, t in collect_tunes(troot)
             if p == "mnist.learning_rate"]
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", REPO + (os.pathsep + path
                                             if path else ""))
    child = evaluate_chromosome_subprocess(
        TMNIST, tunes, [0.08], seed=42, timeout=300, device="cpu",
        extra_argv=["root.mnist.max_epochs=2"])
    here = evaluate_chromosome(import_workflow_module(TMNIST), tunes,
                               [0.08], seed=42, device="cpu")
    assert child == pytest.approx(here, abs=1e-6)
    assert child > 0.8


@pytest.mark.parametrize("mode", ["listen_address", "master_address"])
def test_coordinator_and_worker_raise_naming_a7a(mode):
    """The coordinator (``-l``) and worker (``-m``) modes, which raised
    until the fleet was ported, now run: ``GeneticsOptimizer`` on the
    side ``mode`` names, an ``OptimizationWorkflow`` over a socket on
    the other, a 2-chromosome generation of MNIST learning rates; every
    fitness recorded equals the chromosome evaluated in this process."""
    from test_torch_network import joined, kept_process_state, stopped
    from veles_tpu_torch.client import Client
    from veles_tpu_torch.genetics.optimizer import OptimizationWorkflow
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.server import Server
    troot.mnist.max_epochs = 1
    troot.mnist.minibatch_size = 200
    troot.mnist.learning_rate = Tune(0.01, 0.001, 0.1)
    module = import_workflow_module(TMNIST)
    tunes = collect_tunes(troot)
    with kept_process_state():
        args = SimpleNamespace(listen_address=None, master_address=None,
                               result_file=None, random_seed="42",
                               device="cpu")
        main = SimpleNamespace(module=module, args=args)
        if mode == "listen_address":
            args.listen_address = "127.0.0.1:0"
            opt = GeneticsOptimizer(main, 2, 1)
            t = threading.Thread(target=opt.run, name="test-ga")
            t.start()
            end = time.monotonic() + 30
            while opt.server is None and time.monotonic() < end:
                time.sleep(0.02)
            assert opt.server is not None, "the coordinator never listened"
            client = Client("127.0.0.1:%d" % opt.server.port,
                            OptimizationWorkflow(Launcher(), module,
                                                 seed=42, device="cpu"),
                            reconnect_attempts=1)
            client.run()
            joined(t, 60)
            pop = opt.population
        else:
            pop = Population(tunes, 2, 1, seed=42)
            master = OptimizationWorkflow(Launcher(), module,
                                          population=pop)
            server = Server("127.0.0.1:0", master)
            args.master_address = "127.0.0.1:%d" % server.port
            assert GeneticsOptimizer(main, 2, 1).run() is None
            server.wait(timeout=60)
            stopped(server)
    assert pop.complete
    for chromosome in pop.chromosomes:
        want = evaluate_chromosome(module, tunes, chromosome.genes,
                                   seed=42, device="cpu")
        assert chromosome.fitness == want


def test_distributed_chromosome_jobs():
    """A coordinator and two workers over real sockets: chromosomes
    out, fitnesses back, three generations of a synthetic fitness (two
    workers exercise the nothing-pending poll while one holds a
    generation's last chromosome)."""
    from test_torch_network import joined, kept_process_state, stopped
    from veles_tpu_torch.client import Client
    from veles_tpu_torch.genetics.optimizer import OptimizationWorkflow
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.server import Server
    _synthetic(troot, Tune)
    tunes = collect_tunes(troot)[1:]
    target = numpy.array([0.25, 0.75])

    class SyntheticOptWorkflow(OptimizationWorkflow):
        def do_job(self, data, update, callback):
            genes = numpy.asarray(data["genes"])
            callback({"index": data["index"],
                      "fitness": -float(numpy.sum((genes - target) ** 2))})

    with kept_process_state():
        pop = Population(tunes, size=6, generations=3, seed=7)
        server = Server("127.0.0.1:0",
                        SyntheticOptWorkflow(Launcher(), None,
                                             population=pop))
        threads = []
        for _ in range(2):
            client = Client("127.0.0.1:%d" % server.port,
                            SyntheticOptWorkflow(Launcher(), None),
                            reconnect_attempts=1)
            threads.append(threading.Thread(target=client.run,
                                            name="test-client"))
            threads[-1].start()
        server.wait(timeout=60)
        for t in threads:
            joined(t)
        stopped(server)
    assert pop.complete
    assert len(pop.history) == 3
    assert pop.best.fitness > -0.5
