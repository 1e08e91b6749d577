"""The resilience layer: deadlines, deterministic fault injection,
retries, resilience-event accounting and the crash-resume walk (the
JAX package's resilience module).

* :class:`Deadline` — a wall-clock budget;
* :class:`FaultInjector` — a seeded, *schedulable* chaos engine with
  named injection points.  A plan like
  ``serve.device_fault@serve.device_fault:3,seed:42`` reproduces the
  same failure sequence every run: faults trigger on logical event
  counters, never on wall time;
* :data:`stats` — a thread-safe counter registry over the process
  metrics registry.

* :class:`RetryPolicy` — exponential backoff with seeded jitter;
* :func:`iter_snapshots` / :func:`latest_snapshot` — the crash-resume
  walk over snapshot pointers and their families' generations.

The serving engine consults ``serve.device_fault`` before every device
call, and the hot-reload verifier ``serve.reload_corrupt`` after it
reads an artifact.  The snapshotter consults ``snapshot.write`` and
``snapshot.corrupt`` on every export, and the training step
``step.nan`` on every tick.  The data plane's points:

========================  ================================================
point                     consulted by
========================  ================================================
``net.send``              :class:`network_common.Channel` before a frame
``net.recv``              :class:`network_common.Channel` before a read
``net.connect``           :class:`client.Client` before dialing
``worker.job``            :class:`client.Client` before executing a job
``fleet.join``            :class:`server.Server` while admitting a joiner
``master.crash``          :class:`server.Server` after serving/applying
========================  ================================================

Faults: ``net.drop`` (send dies), ``net.recv_drop`` (read dies),
``net.connect_fail`` (dial refused), ``worker.kill`` (worker death),
``worker.hang`` (worker stalls — the watchdog's case),
``worker.preempt`` (planned preemption — the worker drains and says
bye), ``fleet.join`` (a joiner's admission dies mid-handshake),
``master.crash`` (coordinator death).  A plan is interpreted per
process: every participant installs the same plan, and each rule fires
off that process's own logical counters (a worker ticks ``job`` per
job received, the master per job served).

Chaos-plan grammar (comma-separated entries)::

    seed:<int>              seed for probabilistic rules
    <fault>@<counter>:<n>   one-shot: fire when counter == n
    <fault>@<n>             one-shot at the n-th check of the fault's
                            own injection point
    <fault>%<p>             fire with probability p per check (seeded)
"""

import threading
import time

import numpy


# -- errors ----------------------------------------------------------------

class ResilienceError(Exception):
    """Base for resilience-layer errors."""


class InjectedFault(ResilienceError):
    """Base for injector-raised faults; carries the rule that fired."""

    def __init__(self, fault, counter=None, count=None):
        super(InjectedFault, self).__init__(
            "injected fault %s (%s=%s)" % (fault, counter, count))
        self.fault = fault
        self.counter = counter
        self.count = count


class HandshakeRejected(ResilienceError):
    """The coordinator is alive and refused this worker (checksum or
    version mismatch, protocol violation): permanent, so the worker
    does not walk its reconnect schedule against it."""


class ProtocolError(ResilienceError):
    """The peer spoke a desynchronized wire dialect (a delta against a
    missing or mismatched base version, an unknown trainable):
    session-fatal but recoverable — the worker reconnects with a fresh
    id and the master rebases it with a full weights ship."""


class LostRankError(ResilienceError):
    """A rank of the mesh is gone and took state no survivor holds (a
    tensor-, expert- or pipeline-parallel shard, a ZeRO slot shard):
    the run cannot re-form in process.  Recover by restarting from the
    newest snapshot (``Launcher.resume_latest``)."""


class InjectedNetworkFault(InjectedFault, ConnectionError):
    """A dropped frame or connection.  A ConnectionError, so the
    dead-peer handling catches it unchanged: injected faults exercise
    the real recovery code."""


class WorkerKilled(InjectedFault):
    """Simulated worker process death (``--slave-death-probability``)."""


class WorkerHang(InjectedFault):
    """Simulated worker stall: the job never completes, which drives
    the coordinator's adaptive-timeout watchdog."""

    def __init__(self, fault, counter=None, count=None,
                 seconds=3600.0):
        super(WorkerHang, self).__init__(fault, counter, count)
        self.seconds = seconds


class WorkerPreempted(InjectedFault):
    """Simulated preemption notice: a planned departure — the client
    finishes the in-flight job, ships the update, sends ``bye`` and
    leaves; the master records a retirement, not a drop.  Past the
    ``--preempt-grace`` budget the drain degrades to an abrupt drop."""


class MasterCrash(InjectedFault):
    """Simulated coordinator death: every socket dies abruptly, with no
    cleanup — recovery comes from the atomic snapshot."""


class SnapshotWriteFault(InjectedFault, OSError):
    """A failed checkpoint write (disk full, NFS hiccup)."""


class InjectedStepNaN(InjectedFault):
    """A poisoned training tick: the step executor
    (``AcceleratedWorkflow.execute_step``) catches this and feeds NaN
    into the minibatch mask, so the NaN flows through the real step —
    loss, gradients and the health sentinel all see it the way a bad
    record would produce it."""


class InjectedSnapshotCorruption(InjectedFault):
    """Bit-rot on a just-written snapshot: the snapshotter catches this
    and flips one byte of the blob after the manifest was computed, so
    checksum verification must reject it on resume."""


class InjectedDeviceFault(InjectedFault):
    """A device failure during a serving decode call (a CUDA error,
    a lost card): the serving engine's supervisor
    catches it on the device thread, rebuilds the KV pool, and
    re-adopts surviving streams from their request-side token
    prefixes — the exact recovery path a real device fault drives."""


class InjectedReloadCorruption(InjectedFault):
    """Bit-rot on a serving artifact about to be hot-deployed: the
    reload verifier catches this and flips one byte of the blob it
    just read, so the sha256 manifest gate must reject the artifact
    and the old weights must keep serving."""


# -- stats -----------------------------------------------------------------

class ResilienceStats(object):
    """Thread-safe named event counters (``incr``/``get``/
    ``snapshot``), a thin shim over a typed
    :class:`~veles_tpu_torch.observability.metrics.MetricsRegistry`:
    each name is a Counter series, so everything incremented here is
    also scrapeable as Prometheus text at ``GET /metrics``."""

    def __init__(self, registry=None):
        if registry is None:
            from .observability.metrics import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry

    def incr(self, name, n=1):
        self.registry.counter(name).inc(n)

    def get(self, name):
        counter = self.registry.peek(name)
        return counter.value if counter is not None else 0

    def snapshot(self):
        """name → value over the counters (the historical flat-dict
        shape; gauges/histograms sharing the registry stay out)."""
        return self.registry.counters_snapshot()

    def reset(self):
        """Drops the counters only: gauges and histograms sharing the
        registry belong to their own subsystems."""
        self.registry.reset(kind="counter")


def _global_registry():
    from .observability.metrics import registry
    return registry


#: The process-wide resilience event registry, shimmed onto the
#: process metrics registry (observability.metrics.registry).
stats = ResilienceStats(registry=_global_registry())

#: prng registry key of the retry-jitter stream — distinct from the
#: model and loader generators (0, 1, …), so retry jitter never
#: perturbs training randomness.
PRNG_KEY = 201


# -- deadline --------------------------------------------------------------

class Deadline(object):
    """A wall-clock budget.  ``Deadline(None)`` never expires."""

    def __init__(self, seconds=None):
        self.seconds = seconds
        self._start = time.monotonic()

    @property
    def expired(self):
        return self.seconds is not None and self.remaining() <= 0.0

    def remaining(self):
        if self.seconds is None:
            return float("inf")
        return self.seconds - (time.monotonic() - self._start)

    def clamp(self, delay):
        """Bounds a sleep to the remaining budget (never negative)."""
        return max(0.0, min(delay, self.remaining()))


def _process_phase():
    """A stable pseudo-random value in [0, 1) per process (machine id +
    pid): constant within a process, distinct across processes, so
    retries of many processes do not redial in lock-step."""
    if _phase[0] is None:
        import os
        import uuid
        _phase[0] = ((uuid.getnode() * 1000003 + os.getpid())
                     % 997) / 997.0
    return _phase[0]


_phase = [None]


# -- retry policy ----------------------------------------------------------

class RetryPolicy(object):
    """Exponential backoff with seeded jitter.

    ``delay(attempt)`` = min(base·factor^attempt, max) scaled by a
    uniform draw in [1-jitter, 1+jitter] from the :mod:`prng` resilience
    stream (deterministic given seed and draw order) and by the stable
    per-process phase.  ``rng`` is a private jitter source
    (``random.Random``-like); None uses the shared resilience stream.
    """

    def __init__(self, max_attempts=5, base_delay=0.2, factor=2.0,
                 max_delay=30.0, jitter=0.25, deadline=None,
                 rng=None):
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.factor = float(factor)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.rng = rng

    def delay(self, attempt):
        try:
            grown = self.base_delay * self.factor ** attempt
        except OverflowError:
            grown = self.max_delay
        d = min(grown, self.max_delay)
        if self.jitter:
            if self.rng is not None:
                rng = self.rng
            else:
                from . import prng
                rng = prng.get(PRNG_KEY)
            d *= 1.0 + rng.uniform(-self.jitter, self.jitter)
            d *= 1.0 + self.jitter * (_process_phase() - 0.5)
        if self.deadline is not None:
            d = self.deadline.clamp(d)
        return max(0.0, d)

    def delays(self):
        """Yields the backoff before each retry (``max_attempts``
        values)."""
        for attempt in range(self.max_attempts):
            yield self.delay(attempt)

    def call(self, fn, retry_on=(OSError,), on_retry=None,
             sleep=time.sleep, stat=None):
        """Calls ``fn()`` with retries.  ``on_retry(attempt, exc)``
        observes each failure; ``stat`` names a counter incremented
        per retry.  The last exception propagates when attempts (or
        the deadline) are exhausted."""
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as e:
                expired = (self.deadline is not None and
                           self.deadline.expired)
                if attempt >= self.max_attempts or expired:
                    raise
                if stat:
                    stats.incr(stat)
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(self.delay(attempt))
                attempt += 1


# -- fault injection -------------------------------------------------------

#: fault name -> (injection point, exception class)
FAULTS = {
    "net.drop": ("net.send", InjectedNetworkFault),
    "net.recv_drop": ("net.recv", InjectedNetworkFault),
    "net.connect_fail": ("net.connect", InjectedNetworkFault),
    "worker.kill": ("worker.job", WorkerKilled),
    "worker.hang": ("worker.job", WorkerHang),
    "worker.preempt": ("worker.job", WorkerPreempted),
    "fleet.join": ("fleet.join", InjectedNetworkFault),
    "master.crash": ("master.crash", MasterCrash),
    "snapshot.fail": ("snapshot.write", SnapshotWriteFault),
    "snapshot.corrupt": ("snapshot.corrupt", InjectedSnapshotCorruption),
    "step.nan": ("step.nan", InjectedStepNaN),
    "serve.device_fault": ("serve.device_fault", InjectedDeviceFault),
    "serve.reload_corrupt": ("serve.reload_corrupt",
                             InjectedReloadCorruption),
}

#: The valid injection-point names.
POINTS = tuple(sorted({p for p, _ in FAULTS.values()}))


class _Rule(object):
    """One parsed chaos-plan entry."""

    __slots__ = ("fault", "point", "exc", "counter", "at",
                 "probability", "fired")

    def __init__(self, fault, counter=None, at=None,
                 probability=None):
        if fault not in FAULTS:
            raise ValueError(
                "unknown fault %r (known: %s)" %
                (fault, ", ".join(sorted(FAULTS))))
        self.fault = fault
        self.point, self.exc = FAULTS[fault]
        self.counter = counter or self.point
        self.at = at
        self.probability = probability
        self.fired = False

    def __repr__(self):
        if self.probability is not None:
            return "%s%%%g" % (self.fault, self.probability)
        return "%s@%s:%d" % (self.fault, self.counter, self.at)


class FaultInjector(object):
    """A seeded, schedulable fault injector.

    Code under test calls :meth:`tick` to advance logical counters
    (``job`` per job, …) and :meth:`check` at injection points; a
    rule whose condition holds raises its fault exception.  Each
    ``check(point)`` also auto-ticks a counter named after the point,
    so ``net.drop@net.send:30`` needs no explicit ticking.

    Every fired rule is appended to :attr:`fired` as
    ``(fault, counter, count)`` — two runs with the same plan, seed,
    and logical event sequence produce identical logs, which is the
    determinism contract chaos tests assert.
    """

    def __init__(self, plan="", seed=0):
        self.plan = plan or ""
        self.seed = seed
        self._rules = []
        self._by_point = {}
        self.counters = {}
        self.fired = []
        self._lock = threading.Lock()
        for entry in (e.strip() for e in self.plan.split(",")):
            if not entry:
                continue
            if entry.startswith("seed:"):
                self.seed = int(entry[5:])
                continue
            self._rules.append(self._parse_rule(entry))
        for rule in self._rules:
            self._by_point.setdefault(rule.point, []).append(rule)
        self._rng = numpy.random.RandomState(self.seed & 0xFFFFFFFF)

    @staticmethod
    def _parse_rule(entry):
        if "%" in entry:
            fault, _, p = entry.partition("%")
            return _Rule(fault, probability=float(p))
        if "@" in entry:
            fault, _, cond = entry.partition("@")
            if ":" in cond:
                counter, _, n = cond.rpartition(":")
                return _Rule(fault, counter=counter, at=int(n))
            return _Rule(fault, at=int(cond))
        raise ValueError(
            "bad chaos entry %r — expected fault@counter:N, fault@N, "
            "fault%%p, or seed:N" % entry)

    @property
    def active(self):
        return bool(self._rules)

    def add_rule(self, entry):
        """Appends one parsed entry (``--slave-death-probability``
        folds into the injector this way)."""
        rule = self._parse_rule(entry)
        self._rules.append(rule)
        self._by_point.setdefault(rule.point, []).append(rule)
        return rule

    def tick(self, counter, n=1):
        """Advances a named logical counter (``job``, ``update``, …)."""
        if not self._rules:
            return
        with self._lock:
            self.counters[counter] = self.counters.get(counter, 0) + n

    def check(self, point, **ctx):
        """Consults the injector at a named point; raises the first
        triggering rule's fault.  No-op (and allocation-free) without
        rules."""
        if not self._rules:
            return
        with self._lock:
            count = self.counters.get(point, 0) + 1
            self.counters[point] = count
            rules = self._by_point.get(point)
            if not rules:
                return
            for rule in rules:
                if self._triggers(rule):
                    self.fired.append(
                        (rule.fault, rule.counter,
                         self.counters.get(rule.counter, 0)))
                    stats.incr("chaos." + rule.fault)
                    raise rule.exc(
                        rule.fault, rule.counter,
                        self.counters.get(rule.counter, 0))

    def _triggers(self, rule):
        if rule.probability is not None:
            return float(self._rng.random_sample()) < rule.probability
        if rule.fired:
            return False
        if self.counters.get(rule.counter, 0) >= rule.at:
            rule.fired = True
            return True
        return False

    def __repr__(self):
        return "FaultInjector(%r, seed=%d)" % (self.plan, self.seed)


#: The process-wide injector — the null one unless a plan was
#: installed; its ``check`` is then a cheap early return.
_default = FaultInjector()
_install_lock = threading.Lock()


def get_injector():
    """The process-wide injector."""
    return _default


def effective(injector):
    """The injector a component should consult: its explicit one, or
    the process-wide one."""
    return injector if injector is not None else _default


def install(plan_or_injector, seed=0):
    """Installs the process-wide injector (from a plan string or an
    instance) and returns it."""
    global _default
    with _install_lock:
        if isinstance(plan_or_injector, FaultInjector):
            _default = plan_or_injector
        else:
            _default = FaultInjector(plan_or_injector or "", seed=seed)
        return _default


def reset():
    """Restores the null injector and clears the counters."""
    global _default
    with _install_lock:
        _default = FaultInjector()
    stats.reset()


# -- crash-resume helpers --------------------------------------------------

def iter_snapshots(directory, prefix=None):
    """Yields snapshot paths named by ``*_current.lnk`` pointers in
    ``directory``, newest pointer first, then — per pointer family —
    the family's older generations (newest first).  ``prefix`` narrows
    the search to one family.  A dangling pointer falls through to the
    family's surviving generations; the caller verifies each candidate
    and walks on."""
    import glob
    import os
    if not directory or not os.path.isdir(directory):
        return
    pattern = ("%s_current.lnk" % prefix) if prefix \
        else "*_current.lnk"
    links = glob.glob(os.path.join(directory, pattern))

    def _mtime(path):
        try:
            return os.path.getmtime(path)
        except OSError:
            return 0.0  # pruned between glob and sort: sorts last

    links.sort(key=_mtime, reverse=True)
    from .snapshotter import SnapshotterToFile, iter_generations
    for link in links:
        seen = set()
        try:
            target = SnapshotterToFile.resolve(link)
        except FileNotFoundError:
            target = None  # dangling/empty: the walk takes over
        if target is not None and os.path.isfile(target):
            seen.add(os.path.abspath(target))
            yield target
        family = os.path.basename(link)[:-len("_current.lnk")]
        for path in iter_generations(os.path.dirname(link), family):
            if os.path.abspath(path) in seen:
                continue
            seen.add(os.path.abspath(path))
            yield path


def latest_snapshot(directory, prefix=None):
    """The newest resumable snapshot path, or None."""
    for path in iter_snapshots(directory, prefix):
        return path
    return None
