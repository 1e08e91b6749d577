"""Fleet-wide membership accounting (the JAX package's
``fleet.scheduler``, its membership half).

Every join and leave of a worker bumps a monotonically increasing
**membership epoch**, published as the ``membership.epoch`` gauge, so
"did the fleet change shape, and when?" has an answer without reading
worker logs.  Leaves are classified: a **drain** (the worker finished
its in-flight job, shipped the update and said ``bye``) or a **drop**
(crash, hang, dead peer).  A drain requeues nothing, so the tick order
survives it.

The server admits ZeRO-over-the-wire joiners at the lowest free slot
shard rank (:meth:`FleetScheduler.lowest_free_rank`).  The rebuild of a
mesh after a lost rank, the launcher's fleet mode and its heartbeats are
ROADMAP A7a-ii: :func:`wire_mesh_rebuild` raises, naming it.

Counters (``resilience.stats``): ``fleet.join``, ``fleet.leave``,
``fleet.drain``.  Gauges (the process metrics registry):
``membership.epoch``, ``fleet.size``.
"""

import threading
import time

from collections import deque

from .. import resilience


class FleetScheduler(object):
    """Epoch-numbered membership registry.  Thread-safe: the server's
    per-worker threads call :meth:`join` and :meth:`leave`
    concurrently."""

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
            self.events.append(
                (self.epoch, "drain" if clean else "drop", sid))
            epoch = self.epoch
        resilience.stats.incr("fleet.leave")
        if clean:
            resilience.stats.incr("fleet.drain")
        self._publish_gauges()
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

    def __repr__(self):
        return "FleetScheduler(epoch=%d, size=%d)" % (
            self.epoch, len(self.members))


def wire_mesh_rebuild(scheduler, workflow, rebuild=None):
    """Mesh rebuilds following the fleet's membership epochs: the
    rebuild after a lost rank is not yet ported (ROADMAP A7a-ii)."""
    raise NotImplementedError(
        "wire_mesh_rebuild: a mesh rebuild that follows the fleet's "
        "membership is not yet ported (ROADMAP A7a-ii)")
