"""Low-overhead cross-node span tracing with Chrome-trace export.

The operator question this answers: *where did this minibatch spend
its 40 ms* — master job generation, serialization, the wire, the
worker's fused step, or the fold back into the master's weights.
Each stage is a **span** (``with trace.span("net.send"): ...``); the
collected spans export as Chrome trace-event JSON (``--trace-out
trace.json``) loadable in ``chrome://tracing`` / Perfetto, with each
process's spans on its own track.

Design constraints, in order:

1. **Disabled is free.**  Tracing defaults OFF; ``span()`` then
   returns a shared no-op context manager — one module-bool check
   and zero allocation per call, so instrumentation can sit on the
   per-frame wire path.
2. **One aligned timeline.**  Worker spans ride the job wire
   protocol back to the master (a handshake-negotiated optional
   field — old peers never see it), with the worker's clock offset
   estimated from request/reply timestamp pairs piggybacked on the
   job cycle (:class:`ClockSync`, the classic NTP half-RTT
   estimator, best-of = the minimum-RTT sample).  The master ingests
   the shifted spans, so the exported trace shows ``server.dispatch
   → net.serialize → net.send → worker.step → net.fold`` as one
   timeline across processes.
3. **Bounded memory.**  The collector is a ring (default 16384
   spans); a forgotten ``--trace-out`` on a week-long run costs a
   fixed few MB, never an OOM.

Timestamps are wall-clock (``time.time``) microseconds — the only
clock whose cross-process offset the sync can estimate — durations
are ``perf_counter`` deltas (immune to NTP slew mid-span).
"""

import itertools
import json
import os
import threading
import time
from collections import deque

#: Module-level enable flag — THE fast-path check.  Reads are
#: racy-by-design (a span started just before disable() still
#: records; fine).
_enabled = False

_DEFAULT_RING = 16384
_collector = deque(maxlen=_DEFAULT_RING)
_collector_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def enable(ring=None):
    """Turns span collection on (idempotent).  ``ring`` resizes the
    bounded collector."""
    global _enabled, _collector
    if ring is not None and ring != _collector.maxlen:
        with _collector_lock:
            _collector = deque(_collector, maxlen=int(ring))
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled():
    return _enabled


def clear():
    """Drops collected spans (test isolation)."""
    with _collector_lock:
        _collector.clear()


def reset():
    """Disable + clear + restore the default ring size (test
    isolation)."""
    global _collector
    disable()
    with _collector_lock:
        _collector = deque(maxlen=_DEFAULT_RING)


def spans():
    """A snapshot list of the collected span dicts."""
    with _collector_lock:
        return list(_collector)


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _record(span_dict):
    capture_buf = getattr(_local, "capture", None)
    if capture_buf is not None:
        capture_buf.append(span_dict)
        return
    with _collector_lock:
        _collector.append(span_dict)


class _NullSpan(object):
    """The shared disabled-path span: enter/exit/set are no-ops."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def finish(self):
        pass

    def cancel(self):
        pass


_NULL = _NullSpan()


class Span(object):
    """One live span.  Use via ``with span(...)`` or the manual
    :func:`begin`/:meth:`finish` pair (for spans that close in a
    later call on the same thread, like the master's per-job
    dispatch window)."""

    __slots__ = ("name", "attrs", "ts", "id", "parent", "trace_id",
                 "_t0", "_done")

    def __init__(self, name, attrs, detached=False):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        if detached:
            # A root span that neither reads nor joins the thread's
            # stack: long-lived windows (the master's per-job
            # dispatch) that may OVERLAP on one handler thread under
            # pipelined workers — stack nesting would chain sibling
            # windows into parent/child.  Children attach explicitly
            # (tracing.attach / the wire trace context).
            self.trace_id, self.parent = self.id, None
            self.ts = time.time() * 1e6
            self._t0 = time.perf_counter()
            self._done = False
            return
        stack = _stack()
        if stack:
            parent = stack[-1]
            self.parent = parent.id
            self.trace_id = parent.trace_id
        else:
            remote = getattr(_local, "remote", None)
            if remote is not None:
                self.trace_id, self.parent = remote
            else:
                self.trace_id, self.parent = self.id, None
        self.ts = time.time() * 1e6
        self._t0 = time.perf_counter()
        self._done = False
        stack.append(self)

    def set(self, **attrs):
        self.attrs.update(attrs)

    def cancel(self):
        """Discards the span unrecorded (a dispatch window opened
        for a job that never materialized)."""
        self._done = True
        stack = _stack()
        if self in stack:
            stack.remove(self)

    def finish(self):
        if self._done:
            return
        self._done = True
        dur = (time.perf_counter() - self._t0) * 1e6
        stack = _stack()
        if self in stack:
            stack.remove(self)
        _record({
            "name": self.name, "ts": self.ts, "dur": dur,
            "id": self.id, "parent": self.parent,
            "trace_id": self.trace_id,
            "tid": threading.get_ident() & 0xFFFFFFFF,
            "attrs": self.attrs or None,
        })

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


def span(name, **attrs):
    """The tracing entry point: a context manager recording one span.
    Near-free when tracing is disabled."""
    if not _enabled:
        return _NULL
    return Span(name, attrs)


def begin(name, detached=False, **attrs):
    """Manually-closed span (pair with ``span.finish()``); returns
    the no-op singleton when disabled, so callers need no branch.
    ``detached=True`` makes it a stack-free root window (see
    :class:`Span`)."""
    if not _enabled:
        return _NULL
    return Span(name, attrs, detached=detached)


def current():
    """(trace_id, span_id) of the innermost active span on this
    thread — the context to propagate across the wire — or
    (None, None)."""
    stack = getattr(_local, "stack", None)
    if stack:
        top = stack[-1]
        return top.trace_id, top.id
    remote = getattr(_local, "remote", None)
    if remote is not None:
        return remote
    return None, None


class capture(object):
    """Context manager diverting this THREAD's finishing spans into a
    private list (yielded) instead of the global collector — how a
    worker gathers exactly its job's spans for shipping, even when
    master and worker share a process (loopback tests)."""

    def __init__(self):
        self._prev = None
        self.buf = []

    def __enter__(self):
        self._prev = getattr(_local, "capture", None)
        _local.capture = self.buf
        return self.buf

    def __exit__(self, *exc):
        _local.capture = self._prev
        return False


class attach(object):
    """Adopts a remote parent context: spans opened on this thread
    (with an empty local stack) become children of the remote span,
    sharing its trace id — how a worker's ``worker.step`` nests under
    the master's ``server.dispatch``."""

    def __init__(self, trace_id, parent_id):
        self._ctx = (trace_id, parent_id)
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_local, "remote", None)
        _local.remote = self._ctx
        return self

    def __exit__(self, *exc):
        _local.remote = self._prev
        return False


def shift(span_dicts, offset_seconds):
    """Spans re-timestamped by ``offset_seconds`` (worker clock →
    master clock; ``offset = master - worker``)."""
    delta = offset_seconds * 1e6
    return [dict(d, ts=d["ts"] + delta) for d in span_dicts]


def ingest(span_dicts, proc=None):
    """Folds remote (already clock-shifted) spans into the local
    collector, tagged with the originating process label."""
    for d in span_dicts:
        if not isinstance(d, dict) or "name" not in d:
            continue
        d = dict(d)
        if proc is not None:
            d["proc"] = proc
        _record(d)


# -- clock alignment -------------------------------------------------------

class ClockSync(object):
    """Remote-clock offset estimation from request/reply timestamp
    pairs (piggybacked on the job protocol): for an exchange sent at
    local ``t0``, answered with remote timestamp ``tr``, received at
    local ``t1``, the midpoint estimator gives ``offset ≈ tr -
    (t0+t1)/2`` with error bounded by half the exchange's RTT — so
    the MINIMUM-RTT sample wins (NTP's core trick)."""

    __slots__ = ("offset", "rtt", "samples")

    def __init__(self):
        self.offset = 0.0
        self.rtt = float("inf")
        self.samples = 0

    def sample(self, local_send, remote_ts, local_recv):
        rtt = local_recv - local_send
        if rtt < 0:
            return  # clock stepped mid-exchange; discard
        self.samples += 1
        if rtt <= self.rtt:
            self.rtt = rtt
            self.offset = remote_ts - (local_send + local_recv) / 2.0

    def to_remote(self, local_ts):
        return local_ts + self.offset

    def state(self):
        return {"offset": self.offset, "rtt": self.rtt,
                "samples": self.samples}


# -- export ----------------------------------------------------------------

def chrome_trace_events(span_dicts=None, default_proc=None):
    """Builds the Chrome trace-event list: one complete ("ph":"X")
    event per span plus process_name metadata events, pid-numbered
    per distinct process label."""
    if span_dicts is None:
        span_dicts = spans()
    if default_proc is None:
        default_proc = "master/%d" % os.getpid()
    pids = {}
    events = []
    for d in span_dicts:
        proc = d.get("proc") or default_proc
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pid, "tid": 0,
                           "args": {"name": proc}})
        args = dict(d.get("attrs") or {})
        args["span_id"] = d.get("id")
        if d.get("parent") is not None:
            args["parent_id"] = d["parent"]
        if d.get("trace_id") is not None:
            args["trace_id"] = d["trace_id"]
        events.append({
            "ph": "X", "cat": "veles",
            "name": d["name"],
            "ts": d["ts"], "dur": d.get("dur", 0.0),
            "pid": pid, "tid": d.get("tid", 0),
            "args": args,
        })
    return events


def export_chrome_trace(path=None, span_dicts=None,
                        default_proc=None):
    """Writes (and returns) the Chrome trace JSON object
    ``{"traceEvents": [...]}``.  ``path=None`` only returns it."""
    obj = {"traceEvents": chrome_trace_events(span_dicts,
                                              default_proc),
           "displayTimeUnit": "ms"}
    if path:
        with open(path, "w") as fout:
            json.dump(obj, fout)
    return obj
