"""The port's ensembles (``veles_tpu_torch.ensemble``) against the JAX
package's, on the CPU.

* The round trip through the command line — the counterpart of
  ``tests/test_ensemble.py::test_ensemble_round_trip``: ``--ensemble-train
  3:0.8`` trains three seed-varied MNIST instances on 80 % of the train
  set and snapshots them; ``--ensemble-test`` restores each, runs one
  frozen epoch with probability capture and averages the probabilities
  into one ensemble error, with JAX's gates.
* Both packages' ``EnsembleTrainer`` and ``EnsembleTester`` on the same
  argv and seed: the same instance seeds; the instances' fitnesses, the
  frozen validation errors and the joint ensemble error within 1e-6 (each
  is a count of errors over the validation set, and the two packages'
  f32 roundings do not move a count here).
* ``--train-ratio`` shrinks the train set, and
  ``--ensemble-population`` trains the instances as population lineages
  with the sequential path's seeds, fitnesses and snapshots.

Every test restores both packages' ``root`` trees, and snapshots go to
the test's temporary directory."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

import veles_tpu.prng as jprng
from veles_tpu.config import root as jroot
from veles_tpu.ensemble import (EnsembleTester as JTester,
                                EnsembleTrainer as JTrainer)

from veles_tpu_torch import prng as tprng
from veles_tpu_torch import resilience
from veles_tpu_torch.__main__ import Main, import_workflow_module
from veles_tpu_torch.config import root as troot
from veles_tpu_torch.ensemble import EnsembleTester, EnsembleTrainer
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.loader.base import TRAIN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TMNIST = os.path.join(REPO, "veles_tpu_torch", "znicz", "samples",
                      "mnist.py")
JMNIST = os.path.join(REPO, "veles_tpu", "znicz", "samples", "mnist.py")


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


def test_ensemble_round_trip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the default snapshot directory
    ens_file = tmp_path / "ens.json"
    rc = Main([TMNIST, "root.mnist.max_epochs=4",
               "root.mnist.learning_rate=0.1",
               "--ensemble-train", "3:0.8", "--device", "cpu",
               "--result-file", str(ens_file),
               "--random-seed", "77", "-v", "warning"]).run()
    assert rc == 0
    desc = json.loads(ens_file.read_text())
    assert desc["mode"] == "ensemble-train"
    assert desc["size"] == 3 and len(desc["instances"]) == 3
    assert len({inst["seed"] for inst in desc["instances"]}) == 3
    for inst in desc["instances"]:
        assert os.path.isfile(inst["snapshot"])
        assert os.path.abspath(inst["snapshot"]).startswith(
            os.path.realpath(str(tmp_path)))
        assert inst["fitness"] > 0.7
        assert inst["train_ratio"] == 0.8
    test_file = tmp_path / "ens_test.json"
    rc = Main([TMNIST, "--ensemble-test", str(ens_file), "--device", "cpu",
               "--result-file", str(test_file), "-v", "warning"]).run()
    assert rc == 0
    report = json.loads(test_file.read_text())
    assert report["mode"] == "ensemble-test" and report["size"] == 3
    errs = [inst["validation_err"] for inst in report["instances"]]
    assert report["ensemble_validation_err"] <= max(errs) + 1e-9
    assert report["ensemble_validation_err"] < 0.12


def _main(module, seed, result_file):
    args = SimpleNamespace(random_seed=str(seed), result_file=result_file,
                           device="cpu", ensemble_population=False)
    return SimpleNamespace(module=module, args=args)


def test_ensemble_matches_jax(tmp_path):
    for r in (jroot, troot):
        r.mnist.max_epochs = 3
        r.mnist.learning_rate = 0.1
    from veles_tpu.__main__ import import_workflow_module as jimport
    runs = {}
    for name, module, trainer, tester, reset in (
            ("jax", jimport(JMNIST), JTrainer, JTester, jprng.reset),
            ("port", import_workflow_module(TMNIST), EnsembleTrainer,
             EnsembleTester, tprng.reset)):
        reset()
        desc_file = str(tmp_path / ("%s.json" % name))
        desc = trainer(_main(module, 77, desc_file), 2, 0.8,
                       snapshot_dir=str(tmp_path / name)).run()
        reset()
        kw = {"device": "cpu"} if name == "port" else {}
        report = tester(None, desc_file, **kw).run()
        runs[name] = desc, report
    (jdesc, jrep), (tdesc, trep) = runs["jax"], runs["port"]
    assert [i["seed"] for i in tdesc["instances"]] == \
        [i["seed"] for i in jdesc["instances"]]
    assert tdesc["fitnesses"] == pytest.approx(jdesc["fitnesses"],
                                               abs=1e-6)
    assert [i["validation_err"] for i in trep["instances"]] == \
        pytest.approx([i["validation_err"] for i in jrep["instances"]],
                      abs=1e-6)
    assert trep["ensemble_validation_err"] == pytest.approx(
        jrep["ensemble_validation_err"], abs=1e-6)
    assert trep["mean_probability_margin"] == pytest.approx(
        jrep["mean_probability_margin"], rel=1e-4)


def test_train_ratio_shrinks_train_set():
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    sizes = []
    for ratio in (0.5, 1.0):
        troot.common.loader.train_ratio = ratio
        tprng.reset()
        tprng.get(0).seed(1)
        launcher = Launcher()
        wf = MnistWorkflow(launcher, max_epochs=1, learning_rate=0.1)
        launcher.initialize(device="cpu")
        sizes.append(wf.loader.class_lengths[TRAIN])
    assert sizes[0] <= sizes[1] * 0.5 + 1


def test_ensemble_population_raises_naming_a7a(tmp_path):
    """``--ensemble-population`` no longer raises: ``--ensemble-train
    2:0.8`` through the population scheduler gives the sequential path's
    instance seeds, bit-equal fitnesses, train ratio and snapshots (the
    JAX package's ``test_ensemble_population_matches_sequential``)."""
    troot.mnist.max_epochs = 2
    troot.mnist.minibatch_size = 200
    module = import_workflow_module(TMNIST)
    descs = {}
    for name, population in (("seq", False), ("pop", True)):
        main = _main(module, 42, str(tmp_path / ("%s.json" % name)))
        main.args.ensemble_population = population
        main.args.listen_address = main.args.master_address = None
        main.args.pbt = False
        tprng.reset()
        EnsembleTrainer(main, 2, 0.8,
                        snapshot_dir=str(tmp_path / name)).run()
        descs[name] = json.loads((tmp_path / ("%s.json" % name))
                                 .read_text())
    seq, pop = descs["seq"], descs["pop"]
    assert [i["seed"] for i in seq["instances"]] == \
        [i["seed"] for i in pop["instances"]]
    for a, b in zip(seq["instances"], pop["instances"]):
        assert a["fitness"] == b["fitness"], a["index"]
        assert a["train_ratio"] == b["train_ratio"] == 0.8
        assert os.path.isfile(b["snapshot"])
