"""The worker side of the population engine (the JAX package's
``population.worker``): member contexts over one built model workflow.

A worker serves many members of a population, but builds the module
workflow ONCE: a population job establishes its member's state from
the wire (weights full/delta, slot shards, loader indices, the
member's step key and hyperparameters), so the only per-member state
the worker must keep is each member's delta-session sync bases — the
``(base, version, residual)`` snapshots ``ForwardBase`` and
``GradientDescentBase`` expose through ``export_sync_state`` and
``import_sync_state``.  Those contexts are swapped around every job by
member id, so lineages interleaved on one worker never cross-apply a
delta.  Everything else a job needs arrives with it: the weights and
slots are set from the member's base, the step draws from the member's
stream (``StepCompiler.pin_stream``) and the member's hyperparameters
enter the step as one vector, so no member leaves a tensor, a value or
a program of its own in force for the next.

An ``exploit`` marker on a job (PBT's exploit as a delta) re-bases the
member's context on the leader's context this worker already holds,
mirroring the master's synced-base adoption: the wire then carries only
the XOR delta between the member's new (copied) weights and the leader
state already here.
"""

from .. import resilience
from ..error import Bug
from ..workflow import Workflow
from .lineage import build_member_workflow
from .master import population_checksum


class PopulationWorker(Workflow):
    """Runs member-tagged population jobs on one built model workflow
    on ``device`` (driven by a :class:`~veles_tpu_torch.client.Client`;
    the master's side is
    :class:`~veles_tpu_torch.population.master.PopulationMaster`)."""

    def __init__(self, launcher, module, seed=1234, device="cuda",
                 **kwargs):
        super(PopulationWorker, self).__init__(launcher, **kwargs)
        self.module = module
        self.build_seed = int(seed)
        self.device = device
        self.negotiates_on_connect = False
        self._inner = None
        self._contexts = {}   # member id -> {unit name: sync state}
        self.jobs_done = 0

    @property
    def inner(self):
        """The model workflow, built at first use with the module's
        default config (member genes ride as hyperparameters; weights
        and slots come from the wire, so the build seed only shapes
        tensors)."""
        if self._inner is None:
            self._inner, _launcher = build_member_workflow(
                self.module, self.build_seed, device=self.device)
        return self._inner

    @property
    def checksum(self):
        return population_checksum(self.module)

    def note_net_proto(self, proto):
        super(PopulationWorker, self).note_net_proto(proto)
        self.inner.note_net_proto(proto)

    # -- member contexts ---------------------------------------------------

    def _sync_units(self):
        for unit in self.inner.units:
            if hasattr(unit, "export_sync_state"):
                yield unit

    def _export_context(self):
        return {unit.name: unit.export_sync_state()
                for unit in self._sync_units()}

    def _install_context(self, ctx):
        for unit in self._sync_units():
            unit.import_sync_state(
                ctx.get(unit.name) if ctx else None)

    @staticmethod
    def _copy_context(ctx):
        """A member context's copy for an exploit's re-basing: the base
        dicts are copied (their arrays are rebound, never changed in
        place, so sharing them is safe)."""
        out = {}
        for name, state in ctx.items():
            base, version, residual = (
                tuple(state) + (None,) * (3 - len(state))
            ) if state else (None, None, None)
            out[name] = (dict(base) if base is not None else None,
                         version,
                         dict(residual) if residual is not None
                         else None)
        return out

    def _adopt_exploit(self, member, leader):
        """Re-bases ``member``'s context on ``leader``'s (the marker
        rides only jobs whose master adopted the leader's synced base
        for this worker, so a missing leader context means the session
        lost sync — the protocol error, reconnect and full rebase
        recover it)."""
        ctx = self._contexts.get(leader)
        if ctx is None:
            self.warning(
                "exploit marker names member %r but this worker "
                "holds no context for it — the delta will rebase "
                "through the protocol-error reconnect path", leader)
            resilience.stats.incr("population.exploit_miss")
            return
        self._contexts[member] = self._copy_context(ctx)
        resilience.stats.incr("population.exploit_adopt")

    # -- job execution -----------------------------------------------------

    def do_job(self, data, update, callback):
        member = (data or {}).get("m")
        if member is None:
            raise Bug("population job carries no member id — "
                      "coordinator/worker build mismatch")
        # Retire markers: recorded GA chromosomes' contexts go.
        for retired in data.get("retire") or ():
            self.drop_member(retired)
        leader = data.get("exploit")
        if leader is not None:
            self._adopt_exploit(member, leader)
        self._install_context(self._contexts.get(member))
        try:
            replies = []
            self.inner.do_job(data["data"], None, replies.append)
        finally:
            self._contexts[member] = self._export_context()
        self.jobs_done += 1
        callback({"m": member, "data": replies[0]})

    def drop_member(self, member):
        """Forgets a member's context (a retired GA chromosome)."""
        self._contexts.pop(member, None)
