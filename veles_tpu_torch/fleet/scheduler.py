"""Fleet-wide membership accounting and placement (the JAX package's
``fleet.scheduler``).

Every join and leave of a worker bumps a monotonically increasing
**membership epoch**, published as the ``membership.epoch`` gauge, so
"did the fleet change shape, and when?" has an answer without reading
worker logs; :func:`wire_mesh_rebuild` makes ``rebuild_mesh`` follow the
epochs.  Leaves are classified: a **drain** (the worker finished its
in-flight job, shipped the update and said ``bye``) or a **drop**
(crash, hang, dead peer).  A drain requeues nothing, so the tick order
survives it.

:class:`FleetScheduler` also holds the placement policies every
subsystem shares:

* rank assignment for joiners — the lowest free slot shard rank
  (:meth:`FleetScheduler.lowest_free_rank`);
* affinity scheduling — the population master's affinity-first /
  fresh-next / steal-oldest member pick
  (:meth:`FleetScheduler.pick_affine`), which keeps a lineage's jobs on
  the worker that holds its synced base, so they ship deltas;
* respawn placement — the launcher's least-loaded node
  (:meth:`FleetScheduler.least_loaded`).

Counters (``resilience.stats``): ``fleet.join``, ``fleet.leave``,
``fleet.drain``.  Gauges (the process metrics registry):
``membership.epoch``, ``fleet.size``.
"""

import logging
import threading
import time
import weakref

from collections import deque

from .. import resilience

#: Live schedulers in this process (:func:`live_fleet_summary`).
_LIVE_SCHEDULERS = weakref.WeakSet()


def live_fleet_summary():
    """Epoch, size and event counts across this process's live
    schedulers, or None when no membership event has happened yet."""
    scheds = [s for s in list(_LIVE_SCHEDULERS) if s.epoch > 0]
    if not scheds:
        return None
    out = {"schedulers": len(scheds), "epoch": 0, "size": 0,
           "joins": 0, "leaves": 0, "drains": 0}
    last = None
    for sched in scheds:
        snap = sched.snapshot()
        out["epoch"] = max(out["epoch"], snap["epoch"])
        for key in ("size", "joins", "leaves", "drains"):
            out[key] += snap[key]
        event = snap.get("last_event")
        if event is not None and (last is None or event[0] > last[0]):
            last = event
    if last is not None:
        out["last_event"] = list(last)
    return out


class FleetScheduler(object):
    """Epoch-numbered membership registry and the shared placement
    policy.  Thread-safe: the server's per-worker threads call
    :meth:`join` and :meth:`leave` concurrently.  The placement
    primitives are static, so subsystems with their own bookkeeping
    (the population master's member table, the launcher's process
    table) reuse the policy without this registry."""

    #: Depth of the event ring.
    MAX_EVENTS = 64

    def __init__(self):
        self._lock = threading.Lock()
        self.epoch = 0
        self.members = {}  # sid -> {"mid", "power", "joined", "epoch"}
        self.joins = 0
        self.leaves = 0
        self.drains = 0
        self.events = deque(maxlen=self.MAX_EVENTS)
        self._epoch_callbacks = []  # guarded-by: _lock
        _LIVE_SCHEDULERS.add(self)

    def on_epoch_change(self, callback):
        """Subscribes ``callback(epoch, event, sid)`` to every epoch
        bump (``event`` is "join", "drain" or "drop").  Callbacks run on
        the thread that caused the bump, outside the scheduler's lock;
        one that raises is logged, and stays subscribed."""
        with self._lock:
            self._epoch_callbacks.append(callback)

    def _notify_epoch(self, epoch, event, sid):
        with self._lock:
            callbacks = list(self._epoch_callbacks)
        for cb in callbacks:
            try:
                cb(epoch, event, sid)
            except Exception:
                logging.getLogger("FleetScheduler").exception(
                    "epoch-change callback failed (epoch %d %s %s)",
                    epoch, event, sid)

    def join(self, sid, mid=None, power=1.0):
        """Admits ``sid``; returns the new membership epoch."""
        with self._lock:
            self.epoch += 1
            self.joins += 1
            self.members[sid] = {
                "mid": mid, "power": power,
                "joined": time.time(), "epoch": self.epoch}
            self.events.append((self.epoch, "join", sid))
            epoch = self.epoch
        resilience.stats.incr("fleet.join")
        self._publish_gauges()
        self._notify_epoch(epoch, "join", sid)
        return epoch

    def leave(self, sid, clean=False):
        """Retires ``sid``; returns the new membership epoch.
        ``clean`` marks a drain (an orderly ``bye``) rather than a drop;
        an sid that never joined (its handshake died before admission)
        leaves the epoch untouched."""
        with self._lock:
            if self.members.pop(sid, None) is None:
                return self.epoch
            self.epoch += 1
            self.leaves += 1
            if clean:
                self.drains += 1
            event = "drain" if clean else "drop"
            self.events.append((self.epoch, event, sid))
            epoch = self.epoch
        resilience.stats.incr("fleet.leave")
        if clean:
            resilience.stats.incr("fleet.drain")
        self._publish_gauges()
        self._notify_epoch(epoch, event, sid)
        return epoch

    @property
    def size(self):
        return len(self.members)

    def snapshot(self):
        """Epoch, size and event counts (with the last event)."""
        with self._lock:
            out = {"epoch": self.epoch, "size": len(self.members),
                   "joins": self.joins, "leaves": self.leaves,
                   "drains": self.drains}
            if self.events:
                out["last_event"] = tuple(self.events[-1])
        return out

    def _publish_gauges(self):
        from ..observability import metrics
        reg = metrics.registry
        with self._lock:
            reg.gauge("membership.epoch").set(self.epoch)
            reg.gauge("fleet.size").set(len(self.members))

    # -- placement policy (stateless, shared) ------------------------------

    @staticmethod
    def lowest_free_rank(world, held):
        """The lowest shard rank in ``range(world)`` not in ``held``, or
        None when every rank is taken: ranks vacated by leavers are
        refilled first."""
        taken = set(held)
        for rank in range(world):
            if rank not in taken:
                return rank
        return None

    @staticmethod
    def pick_affine(candidates, worker, affinity_of, age_of):
        """Affinity-first placement over ``candidates``: a candidate
        whose affinity is ``worker`` (the one served longest ago — its
        synced base lives there, so its job ships a delta), else the
        first fresh candidate (no affinity yet), else the stalest
        candidate overall.  None when ``candidates`` is empty."""
        candidates = list(candidates)
        if not candidates:
            return None
        affine = [c for c in candidates if affinity_of(c) == worker]
        if affine:
            return min(affine, key=age_of)
        fresh = [c for c in candidates if affinity_of(c) is None]
        if fresh:
            return fresh[0]
        return min(candidates, key=age_of)

    @staticmethod
    def least_loaded(items, load_of):
        """The item with the smallest load (ties: first in order), or
        None when ``items`` is empty."""
        items = list(items)
        if not items:
            return None
        return min(items, key=load_of)

    def __repr__(self):
        return "FleetScheduler(epoch=%d, size=%d)" % (
            self.epoch, len(self.members))


def wire_mesh_rebuild(scheduler, workflow, rebuild=None):
    """Makes mesh rebuilds follow ``scheduler``'s membership epochs:
    exactly one ``rebuild(workflow, epoch=epoch)`` per epoch bump,
    stamped with that epoch (a stale or repeated epoch is dropped).
    ``rebuild`` defaults to :func:`veles_tpu_torch.parallel.mesh
    .rebuild_mesh`, resolved at this call.  Returns the subscribed
    callback."""
    if rebuild is None:
        from ..parallel.mesh import rebuild_mesh as rebuild

    state = {"last": scheduler.epoch}
    state_lock = threading.Lock()

    def _on_epoch(epoch, event, sid):
        with state_lock:
            if epoch <= state["last"]:
                return
            state["last"] = epoch
        rebuild(workflow, epoch=epoch)

    scheduler.on_epoch_change(_on_epoch)
    return _on_epoch
