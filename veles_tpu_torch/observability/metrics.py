"""Typed metrics: counters, gauges, histograms behind one registry,
with Prometheus text exposition.

The platform grew three generations of ad-hoc accounting — the
flat counter registry (``resilience.stats``), the serving-private
``ServingStats`` windows, and one-off gauges riding heartbeats.  This
module is the single substrate underneath all of them:

* :class:`Counter` — monotonic event count (``net.bytes_sent``,
  ``chaos.net.drop``);
* :class:`Gauge` — point-in-time value, latest write wins
  (``device.mfu``, ``serving.kv_blocks_used``);
* :class:`Histogram` — cumulative-bucket distribution
  (``serving.latency_seconds``), the Prometheus shape;
* :class:`MetricsRegistry` — a thread-safe name→metric map with
  optional labels per series.

``resilience.stats`` remains the API every existing call site uses —
it is now a thin shim over the process-wide :data:`registry` (see
:class:`veles_tpu_torch.resilience.ResilienceStats`), so every counter that
used to live in the flat dict automatically gains Prometheus
exposition at ``GET /metrics`` (web_status and the serving
ModelServer) without touching its increment site.

Exposition notes: metric names are sanitized to the Prometheus
charset (dots → underscores), counters gain the conventional
``_total`` suffix, label values are escaped per the text-format spec
(backslash, double-quote, newline), and every family is preceded by
its ``# TYPE`` line.
"""

import re
import threading

#: Default histogram bucket upper bounds (seconds-flavored: latency
#: is the dominant histogram user).  +Inf is implicit.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class Counter(object):
    """Monotonic counter.  ``inc`` only — a counter that goes down is
    a gauge wearing the wrong hat."""

    kind = "counter"
    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name, labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(object):
    """Point-in-time value; the latest ``set`` wins."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name, labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = value

    def add(self, delta):
        with self._lock:
            self._value += delta

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram(object):
    """Cumulative-bucket histogram (the Prometheus shape: ``le``
    buckets + ``_sum`` + ``_count``)."""

    kind = "histogram"
    __slots__ = ("name", "labels", "bounds", "_counts", "_sum",
                 "_count", "_lock")

    def __init__(self, name, labels=None, buckets=None):
        self.name = name
        self.labels = dict(labels or {})
        self.bounds = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.bounds) + 1)  # + +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value):
        value = float(value)
        with self._lock:
            i = len(self.bounds)
            for j, bound in enumerate(self.bounds):
                if value <= bound:
                    i = j
                    break
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def snapshot(self):
        """(cumulative_bucket_counts, sum, count) — cumulative per
        the exposition format."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cumulative = []
        acc = 0
        for c in counts:
            acc += c
            cumulative.append(acc)
        return cumulative, s, total


def _series_key(name, labels):
    if not labels:
        return name
    return (name, tuple(sorted(labels.items())))


class MetricsRegistry(object):
    """Thread-safe name→metric map.  ``counter``/``gauge``/
    ``histogram`` create-or-return a series; reads go through the
    unlocked dict fast path (CPython dict reads are atomic) with a
    locked fallback for creation."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, labels, **kwargs):
        key = _series_key(name, labels)
        metric = self._metrics.get(key)
        if metric is not None:
            return metric
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                metric = cls(name, labels, **kwargs)
                self._metrics[key] = metric
            return metric

    def counter(self, name, labels=None):
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name, labels=None):
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name, labels=None, buckets=None):
        return self._get_or_create(Histogram, name, labels,
                                   buckets=buckets)

    def peek(self, name, labels=None):
        """The existing series, or None — never creates (reads must
        not pollute the exposition with zero-valued series)."""
        return self._metrics.get(_series_key(name, labels))

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def reset(self, kind=None):
        """Drops series — all of them, or only those of one ``kind``
        ("counter"/"gauge"/"histogram")."""
        with self._lock:
            for key in [k for k, m in self._metrics.items()
                        if kind is None or m.kind == kind]:
                del self._metrics[key]

    def remove_prefix(self, prefix):
        """Drops every series whose name starts with ``prefix`` (a
        subsystem clearing exactly its own state)."""
        with self._lock:
            for key in [k for k, m in self._metrics.items()
                        if m.name.startswith(prefix)]:
                del self._metrics[key]

    def counters_snapshot(self):
        """name → value over the counter series only (the flat-dict
        shape the ``stats.snapshot()`` contract promises)."""
        return {m.name: m.value for m in self.metrics()
                if m.kind == "counter" and not m.labels}


#: The process-wide registry: ``resilience.stats`` shims onto it and
#: ``GET /metrics`` renders it.
registry = MetricsRegistry()


# -- Prometheus text exposition --------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

#: Content type of the text exposition format.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"



def sanitize_name(name, prefix="veles"):
    """Dotted internal name → Prometheus metric name."""
    out = _NAME_RE.sub("_", str(name))
    if prefix and not out.startswith(prefix):
        out = "%s_%s" % (prefix, out)
    if out[0].isdigit():
        out = "_" + out
    return out


def escape_label_value(value):
    """Label-value escaping per the text format: backslash, newline,
    double-quote."""
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _format_labels(labels):
    if not labels:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (_NAME_RE.sub("_", str(k)),
                     escape_label_value(v))
        for k, v in sorted(labels.items()))


def _format_value(v):
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v in (float("inf"), float("-inf")):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


def render_prometheus(registries, extra_samples=(), prefix="veles"):
    """Renders one or more registries (plus ``extra_samples``:
    an iterable of ``(name, labels_dict, value)`` exposed as gauges)
    into the Prometheus text exposition format.  Families are grouped
    so each emits exactly one ``# TYPE`` line."""
    families = {}  # exposed name -> (kind, [lines])

    def family(name, kind):
        fam = families.get(name)
        if fam is None:
            fam = families[name] = (kind, [])
        return fam[1]

    for reg in registries:
        for metric in reg.metrics():
            name = sanitize_name(metric.name, prefix)
            if metric.kind == "counter":
                family(name + "_total", "counter").append(
                    "%s_total%s %s" % (name,
                                       _format_labels(metric.labels),
                                       _format_value(metric.value)))
            elif metric.kind == "gauge":
                family(name, "gauge").append(
                    "%s%s %s" % (name, _format_labels(metric.labels),
                                 _format_value(metric.value)))
            else:  # histogram
                lines = family(name, "histogram")
                cumulative, total_sum, count = metric.snapshot()
                bounds = list(metric.bounds) + [float("inf")]
                for bound, c in zip(bounds, cumulative):
                    labels = dict(metric.labels)
                    labels["le"] = "+Inf" if bound == float("inf") \
                        else _format_value(float(bound))
                    lines.append("%s_bucket%s %d" % (
                        name, _format_labels(labels), c))
                lines.append("%s_sum%s %s" % (
                    name, _format_labels(metric.labels),
                    _format_value(total_sum)))
                lines.append("%s_count%s %d" % (
                    name, _format_labels(metric.labels), count))
    for name, labels, value in extra_samples:
        try:
            value = float(value)
        except (TypeError, ValueError):
            continue
        family(sanitize_name(name, prefix), "gauge").append(
            "%s%s %s" % (sanitize_name(name, prefix),
                         _format_labels(labels),
                         _format_value(value)))
    out = []
    for name in sorted(families):
        kind, lines = families[name]
        out.append("# TYPE %s %s" % (name, kind))
        out.extend(lines)
    return "\n".join(out) + "\n"
