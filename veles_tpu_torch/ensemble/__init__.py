"""Model ensembles (the JAX package's ``ensemble``): train N varied
instances, test them jointly.

``--ensemble-train N:RATIO`` trains N instances in this process, each
with its own seed and ``RATIO`` of the train set, snapshots each and
writes a description JSON with their results and fitnesses;
``--ensemble-test FILE`` restores every instance from its snapshot,
runs one frozen evaluation epoch on it while the softmax evaluator
captures every sample's probabilities on the device, and averages the
probabilities across instances into one ensemble error.  With
``--ensemble-population`` the instances train as population lineages
(``train`` mode) — on the fleet under ``-l``, in an in-process loopback
otherwise — with the same seeds, snapshots and description.
"""

import gzip
import json
import os
import pickle

import numpy

from ..config import root, get as config_get, override_scope
from ..error import Bug
from ..harness import (FITNESS_KEY, run_workflow_module, seed_to_int)
from ..json_encoders import dump_json
from ..launcher import Launcher
from ..loader.base import VALID, TRAIN
from ..logger import Logger
from ..snapshotter import SnapshotterToFile


class EnsembleTrainer(Logger):
    """Trains N instances with varied seeds/train subsets
    (reference: model_workflow.py:50)."""

    def __init__(self, main, instances, train_ratio=1.0, **kwargs):
        super(EnsembleTrainer, self).__init__()
        self.main = main
        self.module = main.module
        args = main.args
        self.instances = int(instances)
        self.train_ratio = float(train_ratio)
        self.base_seed = seed_to_int(args.random_seed)
        stem = os.path.splitext(os.path.basename(
            getattr(self.module, "__file__", "workflow")))[0]
        self.result_file = args.result_file or \
            "%s_ensemble.json" % stem
        self.snapshot_dir = kwargs.get("snapshot_dir") or config_get(
            root.common.dirs.snapshots, "snapshots")
        self.stem = stem
        self.device = getattr(args, "device", "cuda")

    #: Seed stride between instances (the population scheduler's too).
    SEED_STRIDE = 1000003

    def _variation_overrides(self):
        """The per-instance config variation as dotted-path overrides,
        applied through ``config.override_scope`` so that it cannot leak
        into another instance or a later run."""
        return {"common.loader.train_ratio": self.train_ratio}

    def _snapshot_workflow(self, index, wf):
        os.makedirs(self.snapshot_dir, exist_ok=True)
        snapshot = os.path.join(
            self.snapshot_dir,
            "ensemble_%s_%02d.pickle.gz" % (self.stem, index))
        with gzip.open(snapshot, "wb") as fout:
            pickle.dump(wf, fout, protocol=pickle.HIGHEST_PROTOCOL)
        return snapshot

    def _describe(self, index, seed, wf):
        results = wf.gather_results()
        return {"index": index, "seed": seed,
                "train_ratio": self.train_ratio,
                "snapshot": self._snapshot_workflow(index, wf),
                "results": results,
                "fitness": results.get(FITNESS_KEY)}

    def _train_one(self, index, seed):
        with override_scope(root, self._variation_overrides()):
            wf = run_workflow_module(self.module, seed=seed,
                                     device=self.device)
        return self._describe(index, seed, wf)

    def _payload(self, instances):
        fitnesses = [inst["fitness"] for inst in instances
                     if inst["fitness"] is not None]
        payload = {
            "mode": "ensemble-train",
            "workflow": getattr(self.module, "__file__",
                                self.module.__name__),
            "size": self.instances,
            "train_ratio": self.train_ratio,
            "instances": instances,
            "fitnesses": fitnesses,
        }
        dump_json(payload, self.result_file)
        self.info("ensemble description -> %s", self.result_file)
        return payload

    def run(self):
        if getattr(self.main.args, "ensemble_population", False):
            return self.run_on_population()
        instances = []
        for i in range(self.instances):
            seed = self.base_seed + i * self.SEED_STRIDE
            self.info("training ensemble instance %d/%d (seed %d, "
                      "train_ratio %.2f)", i + 1, self.instances,
                      seed, self.train_ratio)
            instances.append(self._train_one(i, seed))
        return self._payload(instances)

    def run_on_population(self):
        """``--ensemble-train`` through the population scheduler
        (``--ensemble-population``): the instances become ``train``
        lineages — trained by the workers attached to a coordinator
        (``-l``), self-driven in this process otherwise — and give the
        sequential path's per-instance snapshots and description, bit
        for bit."""
        from ..population import PopulationEngine
        engine = PopulationEngine(
            main=self.main, size=self.instances, mode="train",
            seed_stride=self.SEED_STRIDE,
            base_overrides=self._variation_overrides())
        # The engine schedules; the description JSON is this class's.
        engine.result_file = None
        engine.run()
        master = engine.master
        if master is None:
            return None  # a worker: the coordinator reports
        instances = []
        for i, member in enumerate(master.members):
            if member.wf is None:
                continue
            instances.append(self._describe(i, member.seed, member.wf))
        return self._payload(instances)


class EnsembleTester(Logger):
    """Runs a saved ensemble jointly over the evaluation data
    (reference: test_workflow.py:50)."""

    def __init__(self, main, ensemble_file, **kwargs):
        super(EnsembleTester, self).__init__()
        self.ensemble_file = ensemble_file
        self.result_file = (main.args.result_file
                            if main is not None else None) or \
            os.path.splitext(ensemble_file)[0] + "_test.json"
        self.device = kwargs.get("device") or getattr(
            getattr(main, "args", None), "device", "cuda")

    def _test_one(self, inst):
        """One frozen evaluation epoch over a restored instance,
        capturing per-sample probabilities."""
        wf = SnapshotterToFile.import_(inst["snapshot"])
        launcher = Launcher()
        launcher.add_ref(wf)
        decision = getattr(wf, "decision", None)
        if decision is None:
            raise Bug("ensemble instance %r has no decision unit"
                      % inst["snapshot"])
        # One more (frozen) epoch: raise the stop BEFORE initialize —
        # the stop condition is re-evaluated there.  The fail window
        # must widen too: an instance stopped by fail_iterations
        # (not max_epochs) keeps should_stop() true otherwise and the
        # evaluation epoch silently never runs.
        trained_epochs = decision.epoch_number
        decision.max_epochs = trained_epochs + 1
        if hasattr(decision, "fail_iterations"):
            decision.fail_iterations = float("inf")
        wf.frozen = True
        launcher.initialize(device=self.device, snapshot=True)
        evaluator = getattr(wf, "evaluator", None)
        capture = hasattr(evaluator, "enable_capture")
        if capture:
            evaluator.enable_capture(wf.loader)
        launcher.run()
        if decision.epoch_number != trained_epochs + 1:
            raise Bug("frozen evaluation epoch did not run for %r "
                      "(epoch stayed at %d)" %
                      (inst["snapshot"], decision.epoch_number))
        metrics = {
            "validation_err": decision.epoch_metrics[VALID],
            "train_err": decision.epoch_metrics[TRAIN],
        }
        probs = evaluator.read_capture() if capture else None
        return wf, metrics, probs

    def run(self):
        with open(self.ensemble_file) as fin:
            desc = json.load(fin)
        per_instance = []
        prob_sum = None
        labels = None
        val_slice = None
        for inst in desc["instances"]:
            wf, metrics, probs = self._test_one(inst)
            self.info("instance %d: frozen validation err %s",
                      inst["index"], metrics["validation_err"])
            per_instance.append(
                {"index": inst["index"], **metrics})
            if probs is not None:
                prob_sum = probs if prob_sum is None \
                    else prob_sum + probs
                loader = wf.loader
                if labels is None and loader.original_labels:
                    loader.original_labels.map_read()
                    labels = numpy.array(loader.original_labels.mem)
                    ends = loader.class_end_offsets
                    val_slice = slice(ends[VALID - 1] if VALID else 0,
                                      ends[VALID])
        payload = {
            "mode": "ensemble-test",
            "ensemble": self.ensemble_file,
            "size": len(per_instance),
            "instances": per_instance,
        }
        if prob_sum is not None and labels is not None and \
                val_slice.stop > val_slice.start:
            mean_probs = prob_sum / len(per_instance)
            pred = numpy.argmax(mean_probs[val_slice], axis=-1)
            truth = labels[val_slice]
            err = float(numpy.mean(pred != truth))
            payload["ensemble_validation_err"] = err
            payload["mean_probability_margin"] = float(
                numpy.mean(numpy.max(mean_probs[val_slice], axis=-1)))
            self.info("ensemble of %d: joint validation err %.4f",
                      len(per_instance), err)
        dump_json(payload, self.result_file)
        self.info("ensemble test results -> %s", self.result_file)
        return payload
