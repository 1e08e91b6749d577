"""Serving observability: the numbers behind ``GET /stats``.

Reuses the counter idiom (:class:`veles_tpu_torch.resilience
.ResilienceStats` — a thread-safe named-counter registry) and adds
the serving-specific shapes counters can't carry: a batch-occupancy
histogram (how full do coalesced batches run?), p50/p99 latency over
a sliding window per endpoint (including TTFT and inter-token
latency for the paged decode path), point-in-time gauges (KV-pool
occupancy), and a sliding-window decode token rate — the same
numbers the ``bench.py --serve`` soak reports, live.
"""

import collections
import threading
import time
import weakref

from ..resilience import ResilienceStats


class LatencyWindow(object):
    """A fixed-size ring of recent latencies (seconds) with
    percentile readout.  A ring, not a reservoir: serving latency is
    non-stationary (compiles, warmup) and operators want the RECENT
    distribution."""

    def __init__(self, size=512):
        self.size = int(size)
        self._ring = [0.0] * self.size
        self._n = 0  # total observations ever
        self._lock = threading.Lock()

    def observe(self, seconds):
        with self._lock:
            self._ring[self._n % self.size] = float(seconds)
            self._n += 1

    def percentile(self, p):
        """The p-th percentile (0..100) of the window, or None when
        empty (nearest-rank on the sorted window)."""
        with self._lock:
            n = min(self._n, self.size)
            if n == 0:
                return None
            window = sorted(self._ring[:n])
        rank = min(n - 1, max(0, int(round(p / 100.0 * (n - 1)))))
        return window[rank]

    @property
    def count(self):
        with self._lock:
            return self._n


class ServingStats(object):
    """Counters + occupancy histogram + latency windows for one
    engine.  ``snapshot()`` is the ``/stats`` payload body."""

    #: Seconds of history behind ``decode_tok_per_sec`` — long
    #: enough to smooth step jitter, short enough that the rate
    #: reflects the CURRENT load, not the whole process lifetime.
    RATE_WINDOW = 30.0

    #: Batch-occupancy histogram bucket bounds (rows per executed
    #: device batch) for the Prometheus view of ``_occupancy``.
    ROW_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

    def __init__(self, window=512):
        # One typed registry per engine: counters (through the
        # shim API), latency histograms, and gauges — rendered as
        # Prometheus text by the ModelServer's ``GET /metrics``
        # alongside the process-wide registry.
        from ..observability.metrics import MetricsRegistry
        self.registry = MetricsRegistry()
        self.counters = ResilienceStats(registry=self.registry)
        self._occupancy = {}  # rows-per-executed-batch -> count
        self._latency = {}  # kind -> LatencyWindow
        self._window = int(window)
        self._gauges = {}  # name -> latest value (pool occupancy &c)
        self._tokens = collections.deque()  # (monotonic, n) events
        self._lock = threading.Lock()

    def incr(self, name, n=1):
        self.counters.incr(name, n)

    def get(self, name):
        return self.counters.get(name)

    def observe_batch(self, kind, rows, latency_seconds):
        """One executed device batch: ``rows`` real rows coalesced,
        end-to-end device latency in seconds."""
        self.counters.incr("batches.%s" % kind)
        self.registry.histogram(
            "serving.batch_rows", labels={"kind": kind},
            buckets=self.ROW_BUCKETS).observe(rows)
        with self._lock:
            self._occupancy[int(rows)] = \
                self._occupancy.get(int(rows), 0) + 1
            win = self._latency.get(kind)
            if win is None:
                win = self._latency[kind] = LatencyWindow(self._window)
        win.observe(latency_seconds)
        self.registry.histogram(
            "serving.latency_seconds",
            labels={"kind": "batch.%s" % kind}).observe(
            latency_seconds)

    def observe_request(self, kind, latency_seconds):
        """One completed request (queue wait + device time)."""
        self.counters.incr("requests.%s" % kind)
        self.observe_latency("request.%s" % kind, latency_seconds)

    def observe_latency(self, key, seconds):
        """One sample into the named latency window — the paged
        decode path feeds ``ttft.generate`` (submit → first token)
        and ``itl.decode`` (one decode step = one inter-token gap
        for every riding row) through this."""
        with self._lock:
            win = self._latency.get(key)
            if win is None:
                win = self._latency[key] = LatencyWindow(self._window)
        win.observe(seconds)
        self.registry.histogram(
            "serving.latency_seconds",
            labels={"kind": key}).observe(seconds)

    def gauge(self, name):
        """The latest value of a named gauge, or None — the engine's
        EWMA speculative gauges read back through this."""
        with self._lock:
            return self._gauges.get(name)

    def set_gauge(self, name, value):
        """Point-in-time value (KV blocks used, active decode rows);
        the latest write wins and rides ``snapshot()`` — and the
        typed registry, so ``/metrics`` scrapes it too."""
        with self._lock:
            self._gauges[name] = value
        try:
            self.registry.gauge("serving.%s" % name).set(
                float(value))
        except (TypeError, ValueError):
            pass

    def refresh_gauges(self):
        """Recomputes the derived gauges (sliding-window token rate)
        right before a scrape/snapshot."""
        self.set_gauge("decode_tok_per_sec",
                       round(self.tokens_per_second(), 2))

    def note_tokens(self, n):
        """``n`` tokens generated now — feeds the sliding-window
        ``decode_tok_per_sec`` rate."""
        now = time.monotonic()
        with self._lock:
            self._tokens.append((now, int(n)))
            self._prune_tokens_locked(now)

    def _prune_tokens_locked(self, now):
        cutoff = now - self.RATE_WINDOW
        while self._tokens and self._tokens[0][0] < cutoff:
            self._tokens.popleft()

    def tokens_per_second(self):
        now = time.monotonic()
        with self._lock:
            self._prune_tokens_locked(now)
            if not self._tokens:
                return 0.0
            total = sum(n for _, n in self._tokens)
            span = max(now - self._tokens[0][0], 0.1)
        return total / span

    def snapshot(self):
        rate = self.tokens_per_second()
        with self._lock:
            occupancy = {str(k): v for k, v
                         in sorted(self._occupancy.items())}
            latency = {
                kind: {"count": win.count,
                       "p50_ms": _ms(win.percentile(50)),
                       "p99_ms": _ms(win.percentile(99))}
                for kind, win in self._latency.items()}
            gauges = dict(self._gauges)
        out = {"counters": self.counters.snapshot(),
               "batch_occupancy": occupancy,
               "latency": latency,
               "decode_tok_per_sec": round(rate, 2)}
        if gauges:
            out["gauges"] = gauges
        return out


def _ms(seconds):
    return None if seconds is None else round(seconds * 1000.0, 3)


#: Live engines in this process (weak: a dropped engine vanishes on
#: its own) — :func:`live_serving_summary` pulls a compact serving
#: summary from here (tok/s, weight version, speculation, pool blocks
#: and bytes) without the engines holding references to its readers.
_LIVE_ENGINES = weakref.WeakSet()


def register_engine(engine):
    _LIVE_ENGINES.add(engine)


def unregister_engine(engine):
    _LIVE_ENGINES.discard(engine)


def live_serving_summary():
    """A small aggregate across this process's running engines, or None
    when nothing serves."""
    engines = [e for e in list(_LIVE_ENGINES)
               if getattr(e, "_thread", None) is not None]
    if not engines:
        return None
    out = {"engines": len(engines),
           "tok_per_sec": round(sum(
               e.stats.tokens_per_second() for e in engines), 2),
           "queue_depth": sum(
               e.queue_depth_now() for e in engines)}
    versions = [e.weight_version for e in engines
                if getattr(e, "weight_version", None)]
    if versions:
        out["weight_version"] = max(versions)
    spec_rates = [e.stats.gauge("spec.accept_rate") for e in engines
                  if getattr(e, "spec_mode", "off") != "off"]
    spec_rates = [r for r in spec_rates if r is not None]
    if spec_rates:
        # The worst accept rate leads: a fleet member whose drafts
        # stopped landing is the one the operator wants to see.
        out["spec_accept_rate"] = min(spec_rates)
        tps = [e.stats.gauge("spec.tokens_per_step")
               for e in engines
               if getattr(e, "spec_mode", "off") != "off"]
        tps = [t for t in tps if t is not None]
        if tps:
            out["spec_tokens_per_step"] = round(
                sum(tps) / len(tps), 3)
    breakers = {getattr(e, "_breaker", "closed") for e in engines}
    if breakers - {"closed"}:
        # Degraded state leads the row: a rebuilding/tripped breaker
        # is exactly what the operator opened the dashboard for.
        out["breaker"] = sorted(breakers - {"closed"})[0]
    used = total = bytes_used = bytes_total = 0
    dtypes = set()
    for e in engines:
        pool = getattr(e, "kv_pool", None)
        if pool is None:
            continue
        occ = pool.occupancy()
        used += occ["blocks_used"]
        total += occ["blocks_total"]
        bytes_used += occ.get("bytes_used", 0)
        bytes_total += occ.get("bytes_total", 0)
        dtypes.add(occ.get("storage_dtype", "f32"))
    if total:
        out["kv_blocks_used"] = used
        out["kv_blocks_total"] = total
        if bytes_total:
            # The byte figures make the quantized-pool win visible
            # on the dashboard: same block count, a fraction of the
            # HBM.
            out["kv_bytes_used"] = bytes_used
            out["kv_bytes_total"] = bytes_total
        if dtypes:
            out["kv_dtype"] = "/".join(sorted(dtypes))
    return out
