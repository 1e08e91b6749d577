"""Replica router: prefix-affinity consistent hashing over N engines.

One :class:`~veles_tpu_torch.serving.engine.ServingEngine` per process was
the ceiling; the router is the tier above — a front that holds N
engine replicas and places every generate where its KV already is.

**Routing key.**  The same chained sha1 the
:class:`~veles_tpu_torch.export.KVBlockPool` prefix cache hashes prompts
with: the FIRST full-block digest of the prompt (whole-prompt bytes
for sub-block prompts).  Two requests sharing a system prompt share
their first block, hence their key, hence their replica — so the
block-level prefix cache hits ACROSS the fleet (one replica prefills
the shared prefix once; its siblings never see those prompts), not
just within one pool.

**Placement.**  Consistent hashing on a ring of
:data:`ReplicaRouter.VNODES` virtual points per replica: adding or
draining one replica remaps only the key ranges adjacent to its
points (~1/N of traffic), so the rest of the fleet keeps its warm
prefix caches through a membership change.  Classify traffic has no
prefix to be affine to and routes least-loaded
(:meth:`~veles_tpu_torch.fleet.FleetScheduler.least_loaded` — the shared
placement policy, not a bespoke one).

**Membership.**  Every add/drain is a
:class:`~veles_tpu_torch.fleet.FleetScheduler` join/leave — replica
changes are numbered membership epochs on the same gauge the
training fleet uses (``membership.epoch``), and
:meth:`ReplicaRouter.scale_hint` closes the loop as the
fleet's first load-following consumer: replica count tracks offered
load via queue-depth/TTFT signals.  A DRAINING replica leaves the
ring first (new work re-routes immediately), then finishes its
in-flight streams (``engine.stop(drain=True)``), then leaves the
fleet cleanly — drain-without-drop, gated in
``tests/test_torch_fabric.py``.
"""

import bisect
import hashlib
import logging
import threading
import weakref

import numpy

from ...fleet import FleetScheduler
from ...logger import Logger
from ..admission import ServiceUnavailable
from .disagg import unpack_kv_payload

#: Live routers in this process — the launcher heartbeat's ``fabric``
#: section and the web_status fabric row pull from here (mirrors the
#: serving/population/fleet live registries).
_LIVE_ROUTERS = weakref.WeakSet()


def live_fabric_summary():
    """Aggregate across this process's live routers for the
    heartbeat ``fabric`` section, or None when no fabric runs."""
    routers = [r for r in list(_LIVE_ROUTERS) if len(r)]
    if not routers:
        return None
    out = {"routers": len(routers), "replicas": 0, "draining": 0,
           "routed": 0, "reroutes": 0}
    hits = misses = 0
    for router in routers:
        snap = router.occupancy()
        out["replicas"] += snap["replicas"]
        out["draining"] += snap["draining"]
        out["routed"] += snap["routed"]
        out["reroutes"] += snap["reroutes"]
        hits += snap["prefix_hits"]
        misses += snap["prefix_misses"]
    if hits + misses:
        out["prefix_hit_rate"] = round(
            hits / float(hits + misses), 4)
    return out


class ReplicaHandle(object):
    """One replica as the router sees it: the engine, its fleet
    identity, and its drain state."""

    __slots__ = ("name", "engine", "state")

    def __init__(self, name, engine):
        self.name = name
        self.engine = engine
        self.state = "up"  # up | draining

    def queue_depth(self):
        try:
            return self.engine.queue_depth_now()
        except Exception as e:
            logging.getLogger("ReplicaRouter").debug(
                "queue-depth probe failed on %s: %s", self.name, e)
            return 0


class ReplicaRouter(Logger):
    """Prefix-affine front over N engine replicas.

    Thread-safe: HTTP handler threads route concurrently with
    operator add/drain calls and the heartbeat's ``occupancy()``.
    The ring lock covers PLACEMENT only — never a device call, so a
    slow replica cannot stall routing for its siblings.
    """

    #: Virtual ring points per replica: enough that key ranges stay
    #: balanced (stddev ~ 1/sqrt(VNODES)) at small fleet sizes,
    #: cheap enough to rebuild on every membership change.
    VNODES = 64

    def __init__(self, fleet=None, registry=None, prefill=None,
                 target_depth=4):
        super(ReplicaRouter, self).__init__()
        self.fleet = fleet if fleet is not None else FleetScheduler()
        self.registry = registry
        self.prefill = prefill
        self.target_depth = int(target_depth)
        self._lock = threading.Lock()
        self._replicas = {}  # name -> ReplicaHandle, guarded-by: _lock
        self._ring = []  # sorted [(point, name)], guarded-by: _lock
        self._points = []  # ring points only (bisect), guarded-by: _lock
        self.routed = 0  # guarded-by: _lock
        self.reroutes = 0  # guarded-by: _lock
        self.adopted_blocks = 0  # guarded-by: _lock
        _LIVE_ROUTERS.add(self)

    # -- membership --------------------------------------------------------

    def add_replica(self, name, engine):
        """Admits an engine replica under ``name``; its key ranges
        move over on the next route.  Bumps the fleet membership
        epoch (a replica join IS a fleet join)."""
        name = str(name)
        handle = ReplicaHandle(name, engine)
        with self._lock:
            if name in self._replicas:
                raise ValueError("replica %r already routed" % name)
            self._replicas[name] = handle
            self._rebuild_ring_locked()
        epoch = self.fleet.join(name, mid="fabric")
        self._publish_gauges()
        self.info("replica %s joined the fabric (epoch %d, %d up)",
                  name, epoch, len(self))
        return handle

    def drain_replica(self, name, timeout=None):
        """Retires a replica WITHOUT dropping its work: the ring
        forgets it first (new requests re-route to the surviving
        replicas), its in-flight streams run to completion
        (``stop(drain=True)``), and only then does it leave the
        fleet — as a clean drain, never a drop."""
        name = str(name)
        with self._lock:
            handle = self._replicas.get(name)
            if handle is None or handle.state != "up":
                raise ValueError("replica %r is not up" % name)
            handle.state = "draining"
            self._rebuild_ring_locked()
        self._publish_gauges()
        try:
            handle.engine.stop(drain=True, timeout=timeout)
        finally:
            with self._lock:
                self._replicas.pop(name, None)
                self._rebuild_ring_locked()
            epoch = self.fleet.leave(name, clean=True)
            self._publish_gauges()
            self.info("replica %s drained out of the fabric "
                      "(epoch %d, %d up)", name, epoch, len(self))

    def _rebuild_ring_locked(self):
        ring = []
        for name, handle in self._replicas.items():
            if handle.state != "up":
                continue
            for i in range(self.VNODES):
                point = hashlib.sha1(
                    ("%s#%d" % (name, i)).encode()).digest()
                ring.append((point, name))
        ring.sort()
        self._ring = ring
        self._points = [point for point, _ in ring]

    def __len__(self):
        with self._lock:
            return len(self._replicas)

    def replica_names(self):
        with self._lock:
            return sorted(self._replicas)

    # -- placement ---------------------------------------------------------

    @staticmethod
    def route_key(tokens, block_size=16):
        """The routing digest: sha1 of the prompt's FIRST full block
        of tokens (whole prompt when shorter) — byte-identical to the
        first entry of ``KVBlockPool.prefix_chain``, so requests that
        would share cached blocks share a replica."""
        tokens = numpy.ascontiguousarray(tokens, dtype=numpy.int32)
        head = tokens[:int(block_size)]
        return hashlib.sha1(head.tobytes()).digest()

    def _pick(self, key):
        """The ring replica owning ``key``, plus the fallback order
        after it (each surviving replica once, ring order) — the
        failover walk a draining/stopped first choice falls through."""
        with self._lock:
            ring = self._ring
            if not ring:
                raise ServiceUnavailable(
                    "no serving replica is up", retry_after=1.0)
            at = bisect.bisect_right(self._points, key)
            order = []
            for off in range(len(ring)):
                name = ring[(at + off) % len(ring)][1]
                if name not in order:
                    order.append(name)
            return [self._replicas[n] for n in order
                    if n in self._replicas]

    def pick_replica(self, tokens):
        """The replica a prompt routes to (no side effects) — tests
        and the bench assert affinity through this."""
        block_size = self._block_size()
        return self._pick(self.route_key(tokens, block_size))[0]

    def _block_size(self):
        with self._lock:
            for handle in self._replicas.values():
                pool = getattr(handle.engine, "kv_pool", None)
                if pool is not None:
                    return pool.block_size
        return 16

    # -- request plane -----------------------------------------------------

    def submit_generate(self, tokens, max_new, temperature=0.0,
                        seed=0, deadline=None, tenant=None):
        """Routes one generate to its prefix-affine replica (failing
        over ring-order past draining/stopped replicas), after
        tenant admission when a registry is configured.  Blocking,
        same contract as the engine call it wraps."""
        if self.registry is not None:
            self.registry.admit(tenant)
        tokens = numpy.ascontiguousarray(tokens, dtype=numpy.int32)
        flat = tokens[0] if tokens.ndim == 2 else tokens
        block_size = self._block_size()
        candidates = self._pick(self.route_key(flat, block_size))
        payload = None
        if self.prefill is not None and \
                len(flat) >= 2 * block_size:
            # Disaggregation: the prefill worker fills every full
            # block EXCEPT the last off the decode thread (the
            # decode replica must still extend at least one token's
            # worth to derive first logits, so ship len-1 blocks and
            # let its tail extension stay one chunk).
            payload = self.prefill.prefill_payload(flat)
        last_error = None
        for at, handle in enumerate(candidates):
            try:
                if payload is not None:
                    self._adopt(handle, flat, payload)
                out = handle.engine.submit_generate(
                    tokens, max_new, temperature=temperature,
                    seed=seed, deadline=deadline)
            except ServiceUnavailable as e:
                # This replica is draining/stopped/breaker-held —
                # the SERVER's state, so the next ring replica gets
                # the request instead of the client getting a 503.
                last_error = e
                continue
            with self._lock:
                self.routed += 1
                self.reroutes += at
            return out
        raise last_error if last_error is not None else \
            ServiceUnavailable("no serving replica is up",
                               retry_after=1.0)

    def _adopt(self, handle, tokens, payload):
        """Ships the prefilled KV into the chosen replica — the wire
        round-trip (pack → frames → unpack) runs even in-process so
        loopback tests exercise the real format."""
        obj = unpack_kv_payload(payload)
        if obj is None:
            return
        # Hold back the LAST shipped block: the decode replica's
        # tail extension must cover >= 1 token beyond the adopted
        # prefix to derive the first logits without a COW re-feed.
        obj["n_blocks"] = int(obj["n_blocks"]) - 1
        if obj["n_blocks"] < 1:
            return
        obj["blocks"] = obj["blocks"][:, :, :obj["n_blocks"]]
        obj["tokens"] = obj["tokens"][
            :obj["n_blocks"] * int(obj["block_size"])]
        try:
            n = handle.engine.adopt_kv_prefix(obj["tokens"], obj)
        except Exception:
            self.exception("KV adoption on %s failed — prefilling "
                           "locally", handle.name)
            return
        if n:
            with self._lock:
                self.adopted_blocks += n

    def submit_classify(self, x, deadline=None, tenant=None):
        """Classify traffic has no KV affinity: least-loaded
        placement (the shared fleet policy) over the up replicas."""
        if self.registry is not None:
            self.registry.admit(tenant)
        with self._lock:
            up = [h for h in self._replicas.values()
                  if h.state == "up"]
        handle = FleetScheduler.least_loaded(
            up, ReplicaHandle.queue_depth)
        if handle is None:
            raise ServiceUnavailable("no serving replica is up",
                                     retry_after=1.0)
        out = handle.engine.submit_classify(x, deadline=deadline)
        with self._lock:
            self.routed += 1
        return out

    # -- load following ----------------------------------------------------

    def scale_hint(self):
        """The load-following signal: +1 when the
        fleet's mean queue depth runs past ``target_depth`` (add a
        replica), -1 when a >1-replica fleet idles under a quarter
        of it (drain one), else 0.  The CALLER (launcher, operator,
        bench) owns the actuation — the router only measures."""
        with self._lock:
            up = [h for h in self._replicas.values()
                  if h.state == "up"]
        if not up:
            return 1
        depth = sum(h.queue_depth() for h in up) / float(len(up))
        if depth > self.target_depth:
            return 1
        if len(up) > 1 and depth < self.target_depth / 4.0:
            return -1
        return 0

    # -- observability -----------------------------------------------------

    def occupancy(self):
        """The ``/stats`` fabric section + heartbeat payload:
        membership, routing tallies, and the CROSS-REPLICA prefix
        cache aggregated over every replica pool."""
        with self._lock:
            handles = list(self._replicas.values())
            out = {
                "replicas": len(handles),
                "draining": sum(1 for h in handles
                                if h.state != "up"),
                "ring_points": len(self._ring),
                "routed": self.routed,
                "reroutes": self.reroutes,
                "adopted_blocks": self.adopted_blocks,
            }
        hits = misses = 0
        per_replica = {}
        for handle in handles:
            entry = {"state": handle.state,
                     "queue_depth": handle.queue_depth()}
            pool = getattr(handle.engine, "kv_pool", None)
            if pool is not None:
                occ = pool.occupancy()
                hits += occ["prefix_hits"]
                misses += occ["prefix_misses"]
                entry["blocks_used"] = occ["blocks_used"]
                entry["blocks_total"] = occ["blocks_total"]
                entry["prefix_hits"] = occ["prefix_hits"]
            per_replica[handle.name] = entry
        out["prefix_hits"] = hits
        out["prefix_misses"] = misses
        if hits + misses:
            out["prefix_hit_rate"] = round(
                hits / float(hits + misses), 4)
        out["per_replica"] = per_replica
        out["epoch"] = self.fleet.epoch
        if self.registry is not None:
            out["registry"] = self.registry.snapshot()
        return out

    def _publish_gauges(self):
        """fabric.* gauges on the process registry (scraped on
        ``/metrics``)."""
        from ...observability import metrics
        reg = metrics.registry
        with self._lock:
            up = sum(1 for h in self._replicas.values()
                     if h.state == "up")
            reg.gauge("fabric.replicas").set(up)
            reg.gauge("fabric.ring_points").set(len(self._ring))

    def stop(self, drain=True, timeout=None):
        """Stops every replica (draining by default) and the prefill
        worker; the router routes 503 afterwards."""
        for name in self.replica_names():
            try:
                self.drain_replica(name, timeout=timeout) if drain \
                    else self._stop_one(name, timeout)
            except ValueError:
                pass
        if self.prefill is not None:
            self.prefill.stop(drain=drain, timeout=timeout)

    def _stop_one(self, name, timeout):
        with self._lock:
            handle = self._replicas.pop(name, None)
            self._rebuild_ring_locked()
        if handle is not None:
            handle.engine.stop(drain=False, timeout=timeout)
            self.fleet.leave(name, clean=False)

    def __repr__(self):
        return "ReplicaRouter(replicas=%d, epoch=%d)" % (
            len(self), self.fleet.epoch)
