"""The resilience layer's serving half: deadlines, deterministic
fault injection, and resilience-event accounting.

Ported from the JAX package's resilience module, keeping what the
serving engine uses:

* :class:`Deadline` — a wall-clock budget;
* :class:`FaultInjector` — a seeded, *schedulable* chaos engine with
  named injection points.  A plan like
  ``serve.device_fault@serve.device_fault:3,seed:42`` reproduces the
  same failure sequence every run: faults trigger on logical event
  counters, never on wall time;
* :data:`stats` — a thread-safe counter registry over the process
  metrics registry.

The serving engine consults ``serve.device_fault`` before every device
call, and the hot-reload verifier ``serve.reload_corrupt`` after it
reads an artifact.  The control-plane points of the JAX package
(network, worker, snapshot) come with the distributed slice.

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


def _global_registry():
    from .observability.metrics import registry
    return registry


#: The process-wide resilience event registry, shimmed onto the
#: process metrics registry (observability.metrics.registry).
stats = ResilienceStats(registry=_global_registry())


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


# -- fault injection -------------------------------------------------------

#: fault name -> (injection point, exception class)
FAULTS = {
    "serve.device_fault": ("serve.device_fault", InjectedDeviceFault),
    "serve.reload_corrupt": ("serve.reload_corrupt",
                             InjectedReloadCorruption),
}

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


#: Null injector: ``check`` is a cheap early return.
_default = FaultInjector()


def effective(injector):
    """The injector a component should consult: its explicit one, or
    the null injector."""
    return injector if injector is not None else _default
