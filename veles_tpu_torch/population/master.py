"""The population master: lineages scheduled as fleet jobs (the JAX
package's ``population.master``).

GA individuals, PBT members, and ensemble instances are *lineages*
(:mod:`veles_tpu_torch.population.lineage`) the master schedules across the
worker fleet over the ordinary Server job protocol: a population job
wraps one member's multi-tick job (the member id tags it), worker
deltas fold into that member's lineage only, a dropped worker's
member ticks requeue with their original step keys, and per-lineage
guardian policy rolls a poisoned member back from its OWN last-good
generation — never a sibling's.

Scheduling modes:

* ``train`` — fixed seed-varied members (ensemble training on the
  fleet), each running to its decision's completion;
* ``ga`` — generation-synchronous: chromosomes from
  :class:`veles_tpu_torch.genetics.core.Population` become fresh
  lineages (genes
  applied per-lineage through ``config.override_scope``, and shipped
  to workers as step hyperparameters), evaluate → select → mutate;
* ``pbt`` — asynchronous Population Based Training: when a member's
  fitness lags the population quantile at its ``--pbt-interval``
  check, exploit copies the leader's weights as a DELTA ship (the
  member's synced base is re-pointed at the leader's, so the wire
  carries an xor delta against state the worker already holds — no
  full-weight transfer) plus ``--pbt-perturb``-perturbed hypers.

The lineages' workflows live on ``device`` (the engine's, the CUDA card
unless the command line asks for the CPU); the master never runs their
steps, it folds the workers' updates into them.

Counters (``resilience.stats``): ``population.jobs``, ``.ticks``,
``.requeues``, ``.stale_updates``, ``.exploits``, ``.nan_epochs``,
``.rollbacks``.  Gauges (the process metrics registry):
``population.members``, ``.active``, ``.member_fitness{member}``,
``.member_generation{member}``.
"""

import time
import weakref

import numpy

from .. import resilience
from ..config import root, get as config_get
from ..distributable import SniffedLock
from ..error import Bug
from ..loader.base import TRAIN, VALID
from ..workflow import Workflow
from .lineage import Lineage

#: Live masters in this process (:func:`live_population_summary`).
_LIVE_MASTERS = weakref.WeakSet()


def live_population_summary():
    """Member counts, fitness and lineage generations across this
    process's live population masters, or None when none runs."""
    masters = [m for m in list(_LIVE_MASTERS) if m.members]
    if not masters:
        return None
    out = {"masters": len(masters)}
    members = 0
    active = 0
    exploits = 0
    requeues = 0
    rollbacks = 0
    fitness = {}
    generation = {}
    best = None
    for master in masters:
        snap = master.population_summary()
        members += snap["members"]
        active += snap["active"]
        exploits += snap["exploits"]
        requeues += snap["requeues"]
        rollbacks += snap["rollbacks"]
        fitness.update(snap.get("fitness") or {})
        generation.update(snap.get("generation") or {})
        b = snap.get("best_fitness")
        if b is not None and (best is None or b > best):
            best = b
    out.update(members=members, active=active, exploits=exploits,
               requeues=requeues, rollbacks=rollbacks)
    if best is not None:
        out["best_fitness"] = best
    if fitness:
        out["fitness"] = fitness
    if generation:
        out["generation"] = generation
    return out


def population_checksum(module):
    """Coordinator and workers must run the same population protocol
    over the same model module: the checksum covers both (the base
    ``Workflow.checksum`` differs between the master and worker
    classes, which live in different files)."""
    import hashlib
    import os
    parts = []
    for fname in ("master.py", "worker.py", "lineage.py"):
        path = os.path.join(os.path.dirname(
            os.path.abspath(__file__)), fname)
        try:
            with open(path, "rb") as fin:
                parts.append(fin.read())
        except OSError:
            parts.append(fname.encode())
    digest = hashlib.sha1(b"".join(parts)).hexdigest()
    name = "none" if module is None else os.path.basename(
        getattr(module, "__file__", None) or
        getattr(module, "__name__", "module"))
    return "%s_population_%s" % (digest, name)


class PopulationMaster(Workflow):
    """The master side of the population engine, driven by a
    :class:`~veles_tpu_torch.server.Server` (or the in-process loopback)
    through the workflow's distributed hooks.  The member-table lock
    guards the table against the summary readers; the summary path
    takes only that lock."""

    MODES = ("train", "ga", "pbt")

    def __init__(self, launcher, module, **kwargs):
        super(PopulationMaster, self).__init__(launcher, **kwargs)
        self.module = module
        self.mode = kwargs.get("mode", "train")
        if self.mode not in self.MODES:
            raise Bug("unknown population mode %r (known: %s)"
                      % (self.mode, ", ".join(self.MODES)))
        self.negotiates_on_connect = False
        self.size = int(kwargs.get("size", 2))
        self.seed = int(kwargs.get("seed", 1234))
        #: Seed stride between members (ensemble convention).
        self.seed_stride = int(kwargs.get("seed_stride", 1000003))
        self.pbt_interval = int(kwargs.get("pbt_interval", config_get(
            root.common.population.pbt_interval, 1)))
        self.pbt_quantile = float(kwargs.get(
            "pbt_quantile",
            config_get(root.common.population.pbt_quantile, 0.25)))
        self.pbt_perturb = float(kwargs.get(
            "pbt_perturb",
            config_get(root.common.population.pbt_perturb, 1.2)))
        self.guardian_policy = kwargs.get("guardian_policy") or \
            config_get(root.common.guardian.policy, "skip")
        #: The device of the lineages' workflows.
        self.device = kwargs.get("device", "cuda")
        #: Config overrides {path: value} applied to every lineage's
        #: build (the ensemble's train_ratio), under its genes.
        self.base_overrides = dict(kwargs.get("base_overrides") or {})
        self._lock = SniffedLock(name="population.members")
        self._members = {}        # guarded-by: _lock
        self._order = []          # guarded-by: _lock
        self._slave_protos = {}   # guarded-by: _lock
        #: Retired member ids not yet announced to each worker: they
        #: ride the next job to it as a ``retire`` marker, and the
        #: worker frees those members' sync contexts (a long GA run
        #: would otherwise keep one per evaluated chromosome).
        self._retire_pending = {}  # guarded-by: _lock
        self._version_seq = 1     # guarded-by: _lock
        self._done = False        # guarded-by: _lock
        self.exploits = 0         # guarded-by: _lock
        self.requeues = 0         # guarded-by: _lock
        self.rollbacks = 0        # guarded-by: _lock
        self.best = None          # (member_id, fitness, hypers)
        self.last_exploit_ms = None
        # GA: the genetics population drives the generations, and
        # chromosomes become lineages on demand.
        self._ga_pop = None
        self._ga_tunes = None
        self._ga_live = {}        # chromosome index -> Lineage
        #: PBT's own generator (hyper init, perturbation draws), never
        #: a lineage's, whose streams replay a standalone run's.
        self._pbt_rng = numpy.random.RandomState(self.seed ^ 0x9B7)
        with self._lock:
            if self.mode == "ga":
                self._init_ga_locked(kwargs)
            else:
                self._init_members_locked(kwargs)
        _LIVE_MASTERS.add(self)
        self._publish_gauges()

    # -- member construction -----------------------------------------------

    def _hyper_leaves(self, tunes):
        """The hyper names of ``tunes``; raises :class:`Bug` unless
        every tune is a uniquely named GD hyperparameter (genes reach
        the workers as step inputs, so topology tunes cannot ride
        fleet lineages)."""
        from ..genetics.vmap_eval import hyper_names
        names = hyper_names(tunes)
        if names is None:
            raise Bug(
                "population fleet scheduling requires every Tune leaf "
                "to be a uniquely-named GD/optimizer hyperparameter "
                "(genes ship to workers as step inputs); "
                "topology tunes need the standalone --optimize "
                "per-chromosome path")
        return names

    def _init_ga_locked(self, kwargs):
        from ..genetics.core import Population, collect_tunes
        self._ga_tunes = collect_tunes(root)
        self._hyper_leaves(self._ga_tunes)
        self._ga_pop = Population(
            self._ga_tunes, self.size,
            kwargs.get("generations"), seed=self.seed,
            **{k: v for k, v in kwargs.items()
               if k in ("elite_ratio", "mutation_rate",
                        "blend_alpha", "stagnation")})

    def _init_members_locked(self, kwargs):
        from ..genetics.core import collect_tunes, _concrete
        tunes = collect_tunes(root)
        hyper_leaves = ()
        if tunes and self.mode == "pbt":
            hyper_leaves = self._hyper_leaves(tunes)
        for i in range(self.size):
            overrides = dict(self.base_overrides)
            hypers = {}
            if self.mode == "pbt" and tunes:
                # The initial spread: uniform over each tune's range
                # (member 0 keeps the defaults, the hand-tuned
                # baseline).
                for (path, tune), leaf in zip(tunes, hyper_leaves):
                    if i == 0:
                        value = _concrete(tune, float(tune.default))
                    else:
                        value = _concrete(tune, self._pbt_rng.uniform(
                            tune.min, tune.max))
                    overrides[path] = value
                    hypers[leaf] = float(value)
            member = Lineage(
                "m%d" % i, self.module,
                self.seed + i * self.seed_stride,
                overrides=overrides, hypers=hypers or None,
                origin=self.mode, device=self.device)
            self._register_locked(member)

    def _register_locked(self, member):
        member.build()
        member.wf._weights_version_ = self._version_seq
        self._version_seq += 1
        for slave, proto in self._slave_protos.items():
            member.wf.note_slave_protocol(slave, proto)
        self._members[member.member_id] = member
        self._order.append(member.member_id)
        return member

    @property
    def members(self):
        return [self._members[mid] for mid in self._order]

    # -- the Server's hooks ------------------------------------------------

    @property
    def checksum(self):
        return population_checksum(self.module)

    def note_slave_protocol(self, slave, proto):
        with self._lock:
            self._slave_protos[slave] = dict(proto or {})
            for member in self.members:
                member.wf.note_slave_protocol(slave, proto)

    def slave_protocol(self, slave):
        return self._slave_protos.get(slave) or {}

    def generate_initial_data_for_slave(self, slave=None):
        return None

    def should_stop_serving(self):
        with self._lock:
            return self._finished_locked()

    def _finished_locked(self):
        if self._done:
            return True
        if self.mode == "ga":
            done = self._ga_pop.complete
        else:
            done = all(m.complete for m in self.members)
        if done:
            self._done = True
            self._record_best_locked()
        return done

    def _record_best_locked(self):
        candidates = [(m.fitness, m) for m in self.members
                      if m.fitness is not None]
        if self.mode == "ga" and self._ga_pop.best is not None:
            best = self._ga_pop.best
            self.best = ("ga", float(best.fitness),
                         dict(best.overrides(self._ga_tunes)))
        elif candidates:
            fit, m = max(candidates, key=lambda p: p[0])
            self.best = (m.member_id, float(fit), dict(m.hypers))

    # -- job generation ----------------------------------------------------

    def generate_data_for_slave(self, slave=None):
        with self._lock:
            if self._finished_locked():
                return None
            member = self._pick_member_locked(slave)
            if member is None:
                return None
            with member.scope():
                inner = member.wf.generate_data_for_slave(slave)
            key = member.draw_job_key()
            meta = inner.get("__job__")
            if meta is None:
                meta = inner["__job__"] = {}
            meta["rng"] = key
            if member.hypers:
                meta["hypers"] = dict(member.hypers)
            ticks = 1
            for piece in inner.values():
                if isinstance(piece, dict) and "block" in piece:
                    ticks = len(piece["block"]["classes"])
                    break
            member.outstanding = (slave, key, ticks)
            member.affinity = slave
            member.last_served = time.time()
            member.jobs_done += 1
            resilience.stats.incr("population.jobs")
            job = {"m": member.member_id, "data": inner}
            leader = member.exploit_rebase.pop(slave, None)
            if leader is not None:
                job["exploit"] = leader
            retired = self._retire_pending.pop(slave, None)
            if retired:
                job["retire"] = retired
            return job

    def _pick_member_locked(self, slave):
        """One member, one job in flight (folds stay serialized per
        lineage, so the fold lands the worker's exact values), picked
        by :meth:`FleetScheduler.pick_affine`: a member whose synced
        base this worker holds (its job ships a delta), else a fresh
        one, else the least recently served (one full ship, then
        deltas again)."""
        if self.mode == "ga":
            self._refill_ga_locked()
        candidates = [m for m in self.members
                      if m.built and m.outstanding is None and
                      not m.complete]
        if self.mode == "ga":
            live = set(self._ga_live.values())
            candidates = [m for m in candidates if m in live]
        from ..fleet import FleetScheduler
        return FleetScheduler.pick_affine(
            candidates, slave,
            affinity_of=lambda m: m.affinity,
            age_of=lambda m: m.last_served)

    def _refill_ga_locked(self):
        """Builds lineages for the pending chromosomes of the current
        generation (genes applied per lineage through the override
        scope: the global tree never changes)."""
        from ..genetics.core import _concrete
        while True:
            got = self._ga_pop.acquire(owner="population")
            if got is None:
                return
            index, genes = got
            overrides = dict(self.base_overrides)
            hypers = {}
            for (path, tune), gene in zip(self._ga_tunes, genes):
                value = _concrete(tune, gene)
                overrides[path] = value
                hypers[path.rsplit(".", 1)[-1]] = float(value)
            member = Lineage(
                "g%dc%d" % (self._ga_pop.generation, index),
                self.module, self.seed, overrides=overrides,
                hypers=hypers, origin="ga", device=self.device)
            member.ga_index = index
            self._register_locked(member)
            self._ga_live[index] = member

    # -- folds -------------------------------------------------------------

    def apply_data_from_slave(self, data, slave=None):
        with self._lock:
            mid = (data or {}).get("m")
            member = self._members.get(mid)
            if member is None or member.outstanding is None or \
                    member.outstanding[0] != slave:
                # A stale reply (the job was requeued after a drop, or
                # the member retired): the batch trains again
                # elsewhere, so this fold is dropped.
                resilience.stats.incr("population.stale_updates")
                return
            inner = data.get("data") or {}
            meta = dict(inner.get("__job__") or {})
            ticks = member.outstanding[2]
            with member.scope():
                member.wf.apply_data_from_slave(inner, slave)
            member.advance_key(meta.get("rng"))
            member.outstanding = None
            member.ticks_done += ticks
            resilience.stats.incr("population.ticks", ticks)
            member.wf._weights_version_ = self._version_seq
            self._version_seq += 1
            if meta.get("last_minibatch"):
                self._on_class_epoch_locked(
                    member, meta.get("minibatch_class"))
            if member.complete:
                self._on_member_complete_locked(member)
            self._publish_gauges()

    def _on_class_epoch_locked(self, member, cls):
        if cls == VALID:
            member.val_epochs += 1
            member.refresh_fitness()
            if self.mode == "pbt":
                self._maybe_exploit_locked(member)
        elif cls == TRAIN:
            self._guardian_check_locked(member)

    def _guardian_check_locked(self, member):
        """The per-lineage guardian: a poisoned train epoch rolls the
        member back to its own last-good generation; a healthy one
        becomes the new last-good."""
        d = member.decision
        if d is None:
            return
        nonfinite = float(getattr(
            d, "epoch_nonfinite", (0.0, 0.0, 0.0))[TRAIN])
        loss = d.epoch_loss[TRAIN]
        healthy = nonfinite == 0.0 and (
            loss is None or numpy.isfinite(float(loss)))
        if healthy:
            member.record_good()
            return
        resilience.stats.incr("population.nan_epochs")
        if self.guardian_policy == "rollback" and \
                member.rollback_last_good():
            self.rollbacks += 1
            resilience.stats.incr("population.rollbacks")

    def _on_member_complete_locked(self, member):
        fitness = member.final_fitness()
        if fitness is not None:
            member.fitness = fitness
            if member.best_fitness is None or \
                    fitness > member.best_fitness:
                member.best_fitness = fitness
        self.info("member %s complete: fitness %s after %d jobs",
                  member.member_id, fitness, member.jobs_done)
        if self.mode == "ga":
            index = getattr(member, "ga_index", None)
            if index in self._ga_live:
                del self._ga_live[index]
                self._ga_pop.record(index, float(fitness or 0.0))
                # A recorded chromosome's model is dead weight: retire
                # frees the workflow and guardian snapshot here, and
                # the retire marker on each worker's next job frees
                # its sync context there.
                member.retire()
                for slave in self._slave_protos:
                    self._retire_pending.setdefault(slave, []) \
                        .append(member.member_id)

    # -- PBT exploit (exploit-as-delta) ------------------------------------

    def _maybe_exploit_locked(self, member):
        if member.val_epochs - member.last_pbt_check < \
                self.pbt_interval:
            return
        member.last_pbt_check = member.val_epochs
        scored = [(m.fitness, m) for m in self.members
                  if m.fitness is not None]
        if len(scored) < 2 or member.fitness is None:
            return
        fits = numpy.array([f for f, _ in scored])
        cut = float(numpy.quantile(fits, self.pbt_quantile))
        if member.fitness > cut:
            return
        leader = max((p for p in scored if p[1] is not member),
                     key=lambda p: p[0], default=(None, None))[1]
        if leader is None or leader.fitness <= member.fitness:
            return
        self.exploit(member, leader)

    def exploit(self, member, leader):
        """Copies the leader's weights and slots into the member's
        lineage and re-points the member's synced bases at the
        leader's, so the next job ships an XOR delta against state the
        worker already holds for the leader: an exploit costs delta
        bytes, never a full ship.

        The copied generation is the leader's last-shipped state at its
        affinity worker (its synced base there), bit-identical to what
        that worker holds, so the follow-up delta collapses to
        unchanged markers.  Asynchronous PBT takes the one job of
        staleness by design; a leader with no shipped state (never
        served) is copied from its live weights, and the next job
        full-ships."""
        t0 = time.time()
        l_units = {u.name: u for u in leader.wf.units}
        src_worker = leader.affinity \
            if leader.affinity in self._slave_protos else None
        copied = False
        if src_worker is not None and int(
                self._slave_protos[src_worker].get("zero") or 0) == 1:
            copied = self._adopt_shipped_locked(
                member, l_units, src_worker)
        if not copied:
            from ..guardian import restore_vectors
            restore_vectors(member.wf, leader.wf)
        for slave in self._slave_protos:
            adopted = copied and slave == src_worker and \
                self._adopt_synced_locked(member, l_units, slave)
            if adopted:
                member.exploit_rebase[slave] = leader.member_id
            else:
                # No base this worker holds can carry the exploit:
                # the member's stale bases go, so the next job to it
                # full-ships.
                for unit in member.wf.units:
                    for attr in ("_synced_", "_slot_synced_"):
                        synced = getattr(unit, attr, None)
                        if isinstance(synced, dict):
                            synced.pop(slave, None)
                member.exploit_rebase.pop(slave, None)
        self._post_exploit_locked(member, leader, t0)

    def _adopt_shipped_locked(self, member, l_units, slave):
        """Overwrites the member's weights and slots with the leader's
        last-shipped generation at ``slave``; all or nothing (a partial
        copy would mix two generations)."""
        results = []
        for unit in member.wf.units:
            src = l_units.get(unit.name)
            adopt = getattr(unit, "adopt_shipped_values", None)
            if adopt is None or src is None:
                continue
            results.append(adopt(src, slave))
        results = [r for r in results if r is not None]
        return bool(results) and all(results)

    def _adopt_synced_locked(self, member, l_units, slave):
        results = []
        for unit in member.wf.units:
            src = l_units.get(unit.name)
            adopt = getattr(unit, "adopt_synced_from", None)
            if adopt is None or src is None:
                continue
            results.append(adopt(src, slave))
        results = [r for r in results if r is not None]
        return bool(results) and all(results)

    def _post_exploit_locked(self, member, leader, t0):
        if member.hypers:
            # Explore: the copied leader's hypers perturbed (clipped to
            # the tune ranges).
            base = dict(leader.hypers or member.hypers)
            from ..genetics.core import collect_tunes
            spans = {path.rsplit(".", 1)[-1]: tune
                     for path, tune in collect_tunes(root)}
            for name, value in base.items():
                factor = self.pbt_perturb if self._pbt_rng.rand() < \
                    0.5 else 1.0 / self.pbt_perturb
                new = float(value) * factor
                tune = spans.get(name)
                if tune is not None:
                    new = float(numpy.clip(new, tune.min, tune.max))
                member.hypers[name] = new
        member.generation += 1
        member.last_good = None  # a pre-exploit snapshot is obsolete
        self.exploits += 1
        resilience.stats.incr("population.exploits")
        exploit_ms = (time.time() - t0) * 1000.0
        self.last_exploit_ms = exploit_ms
        self.info(
            "PBT exploit: %s (fitness %.4f) adopted leader %s "
            "(%.4f), hypers %s, %.1f ms",
            member.member_id, member.fitness or 0.0,
            leader.member_id, leader.fitness or 0.0, member.hypers,
            exploit_ms)

    # -- drops -------------------------------------------------------------

    def drop_slave(self, slave=None):
        with self._lock:
            for member in self.members:
                if not member.built:
                    continue
                if member.outstanding is not None and \
                        member.outstanding[0] == slave:
                    member.requeue_outstanding()
                    self.requeues += 1
                    resilience.stats.incr("population.requeues")
                if member.affinity == slave:
                    member.affinity = None
                with member.scope():
                    member.wf.drop_slave(slave)
            self._slave_protos.pop(slave, None)
            self._retire_pending.pop(slave, None)
            self._publish_gauges()

    # -- observability -----------------------------------------------------

    def population_summary(self):
        """Member fitness and lineage generations, with the exploit,
        requeue and rollback counts."""
        with self._lock:
            members = self.members
            out = {"members": len(members),
                   "mode": self.mode,
                   "active": sum(1 for m in members
                                 if m.built and not m.complete),
                   "exploits": self.exploits,
                   "requeues": self.requeues,
                   "rollbacks": self.rollbacks,
                   "jobs": sum(m.jobs_done for m in members)}
            fitness = {m.member_id: round(m.fitness, 6)
                       for m in members if m.fitness is not None}
            if fitness:
                out["fitness"] = fitness
                out["best_fitness"] = max(fitness.values())
                out["mean_fitness"] = round(
                    sum(fitness.values()) / len(fitness), 6)
            generation = {m.member_id: m.generation for m in members}
            if generation:
                out["generation"] = generation
            if self.mode == "ga" and self._ga_pop is not None:
                out["ga_generation"] = self._ga_pop.generation
            return out

    def _publish_gauges(self):
        """The population.* gauges of the process metrics registry."""
        from ..observability import metrics
        reg = metrics.registry
        members = self.members
        reg.gauge("population.members").set(len(members))
        reg.gauge("population.active").set(
            sum(1 for m in members if m.built and not m.complete))
        for m in members:
            labels = {"member": m.member_id}
            if m.fitness is not None:
                reg.gauge("population.member_fitness",
                          labels).set(m.fitness)
            reg.gauge("population.member_generation",
                      labels).set(m.generation)
