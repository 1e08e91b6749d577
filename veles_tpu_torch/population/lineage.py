"""Member lineages: one long-lived weight/slot lineage per population
member (the JAX package's ``population.lineage``).

A lineage is a member's whole training identity on the master: its own
built and initialized workflow (weights, optimizer slots, loader
position, decision metrics), its own generator registry
(``prng.scoped`` — member A's shuffles and step keys never advance
member B's streams), its config overrides (GA genes, ensemble
variation — applied through ``config.override_scope`` around the build
and put back after), and its job bookkeeping (the one job in flight,
requeued step keys, exploit markers).

A member trained over the fleet is bit-identical to the same module
trained alone with the member's seed: the lineage's workflow is built
as a standalone run builds it, every job carries the member's step key
— the state of the member's step stream where its last job left it,
which the worker's step draws from (``StepCompiler.pin_stream``) and
hands back advanced — and a dropped job's key is re-served with its
requeued ticks, so churn never forks the trajectory.
"""

import numpy

from .. import prng
from ..config import root, override_scope
from ..error import Bug
from ..harness import FITNESS_KEY
from ..loader.base import VALID
from ..logger import Logger
from ..memory import Vector


def build_member_workflow(module, seed, overrides=None, device="cuda"):
    """Builds and initializes ``module``'s workflow on ``device`` as a
    standalone run would (without running it), with ``overrides``
    applied around construction and initialize through
    ``config.override_scope``, so they never leak into a sibling's
    build.  Returns (workflow, launcher)."""
    from ..launcher import Launcher
    state = {}

    def load(WorkflowClass, **kwargs):
        launcher = Launcher()
        wf = WorkflowClass(launcher, **kwargs)
        state["launcher"], state["wf"] = launcher, wf
        return wf, False

    def main(**kwargs):
        kwargs.setdefault("device", device)
        state["launcher"].initialize(**kwargs)

    with override_scope(root, overrides or {}):
        prng.reset()
        prng.get(0).seed(seed)
        module.run(load, main)
    if "wf" not in state:
        raise Bug("workflow module %r never called load() — a "
                  "population member cannot be built from it"
                  % getattr(module, "__name__", module))
    return state["wf"], state["launcher"]


class Lineage(Logger):
    """One member's weight/slot lineage and its job bookkeeping.
    Mutated only under the :class:`PopulationMaster`'s member-table
    lock; the summary accessors read plain numbers."""

    def __init__(self, member_id, module, seed, overrides=None,
                 hypers=None, origin="seed", device="cuda"):
        super(Lineage, self).__init__()
        self.member_id = member_id
        self.module = module
        self.seed = int(seed)
        self.device = device
        #: Config overrides (dotted path → value): GA genes, the
        #: ensemble's train_ratio.
        self.overrides = dict(overrides or {})
        #: Hyperparameter overrides shipped with every job (leaf name →
        #: float): how a member's genes reach the worker's step without
        #: a program per member.
        self.hypers = dict(hypers or {})
        self.origin = origin
        #: PBT lineage generation: one more per exploit.
        self.generation = 0
        self.rng = {}           # the member's own generator registry
        self.wf = None
        self.launcher = None
        #: The member's step key: the state of its step stream where
        #: its last job left it (see the module's docstring).
        self.step_key = None
        # One job in flight at a time: folds are serialized per member,
        # so the lineage is always exactly what the worker computed.
        self.outstanding = None   # (slave, key, ticks) of that job
        self.affinity = None      # the worker holding its synced base
        self.last_served = 0.0
        #: Keys of dropped jobs, re-served with the requeued ticks.
        self.requeued_keys = []
        self.jobs_done = 0
        self.ticks_done = 0
        #: Exploit markers: worker id → leader member id, recorded when
        #: the master adopted the leader's synced base for that worker.
        self.exploit_rebase = {}
        self.val_epochs = 0
        self.last_pbt_check = 0
        self.fitness = None       # the latest completed epoch's
        self.best_fitness = None
        self.last_good = None     # (val_epochs, {key: array})
        self.rollbacks = 0
        self.retired = False

    def build(self):
        """Builds the member's workflow inside its own generator scope:
        initial weights come from the member's seed, as a standalone
        run's do, and the step key starts the member's step stream."""
        with prng.scoped(self.rng):
            self.wf, self.launcher = build_member_workflow(
                self.module, self.seed, self.overrides, self.device)
            self.step_key = {"seed": prng.get(0).device_seed}
        return self

    @property
    def built(self):
        return self.wf is not None

    def scope(self):
        """The member's generator scope: every lineage operation that
        can draw (loader walks, builds) runs inside it."""
        return prng.scoped(self.rng)

    def draw_job_key(self):
        """The job's step key: a requeued key first (a dropped job's
        ticks re-serve with the key they were first served with), else
        where the member's stream stands."""
        if self.requeued_keys:
            return self.requeued_keys.pop()
        return dict(self.step_key)

    def advance_key(self, key):
        """Takes the key of the stream where the member's last job
        stopped (the worker's reply)."""
        if key is not None:
            self.step_key = dict(key)

    def requeue_outstanding(self):
        """Puts the in-flight job back: its key is re-served with the
        loader's requeued ticks."""
        if self.outstanding is None:
            return False
        self.requeued_keys.append(self.outstanding[1])
        self.outstanding = None
        return True

    def retire(self):
        """Frees the workflow and the last-good snapshot (a GA lineage
        retires once its fitness is recorded)."""
        self.wf = None
        self.launcher = None
        self.rng = {}
        self.last_good = None
        self.requeued_keys = []
        self.retired = True

    # -- fitness -----------------------------------------------------------

    @property
    def decision(self):
        return getattr(self.wf, "decision", None) if self.wf else None

    @property
    def complete(self):
        if self.retired:
            return True
        d = self.decision
        if d is None:
            return bool(self.wf.stopped) if self.wf else False
        return bool(d.complete)

    def refresh_fitness(self):
        """The latest completed validation epoch's fitness, 1 − err
        (the decision's ``EvaluationFitness``)."""
        d = self.decision
        if d is None or not getattr(d, "epoch_metrics", None):
            return self.fitness
        err = d.epoch_metrics[VALID]
        if err is None:
            return self.fitness
        self.fitness = 1.0 - float(err)
        if self.best_fitness is None or self.fitness > self.best_fitness:
            self.best_fitness = self.fitness
        return self.fitness

    def final_fitness(self):
        """The fitness a standalone evaluation reports (1 − the minimal
        validation error)."""
        results = self.wf.gather_results() if self.wf else {}
        if FITNESS_KEY in results:
            return float(results[FITNESS_KEY])
        return self.fitness

    # -- the per-lineage guardian ------------------------------------------

    def _state_vectors(self):
        for unit in self.wf.units:
            for which in ("trainables", "tstate"):
                vecs = getattr(unit, which, None)
                if not isinstance(vecs, dict):
                    continue
                for attr, vec in vecs.items():
                    if isinstance(vec, Vector) and vec:
                        yield "%s/%s" % (unit.name, attr), vec

    def record_good(self):
        """Copies the weights and slots to the host as the member's
        last-good generation (after a healthy train epoch)."""
        snap = {}
        for key, vec in self._state_vectors():
            vec.map_read()
            snap[key] = numpy.array(vec.mem)
        self.last_good = (self.val_epochs, snap)

    def rollback_last_good(self):
        """Restores the member's own last-good weights and slots (never
        a sibling's); the next job ships them as an exact XOR delta.
        False when no good generation was recorded."""
        if self.last_good is None:
            return False
        epoch, snap = self.last_good
        restored = 0
        for key, vec in self._state_vectors():
            src = snap.get(key)
            if src is None or src.shape != vec.shape:
                continue
            vec.mem = numpy.array(src)
            restored += 1
        self.rollbacks += 1
        self.info("member %s rolled back %d tensors to its own "
                  "last-good generation (val epoch %d)",
                  self.member_id, restored, epoch)
        return True

    def status_row(self):
        row = {"generation": self.generation, "jobs": self.jobs_done,
               "ticks": self.ticks_done, "val_epochs": self.val_epochs}
        if self.fitness is not None:
            row["fitness"] = round(self.fitness, 6)
        return row
