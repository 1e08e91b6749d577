"""Observability of the port: span tracing, typed metrics, dispatch-span
and MFU attribution.

* :mod:`.tracing` — ``span("net.send")`` context managers feeding a
  bounded ring collector, cross-node clock alignment, and Chrome
  trace-event export (``--trace-out``);
* :mod:`.metrics` — counters/gauges/histograms in a process registry
  with Prometheus text exposition (``GET /metrics`` on the serving
  ModelServer); ``resilience.stats`` is a thin shim over it;
* :mod:`.attribution` — a CUDA-event stream span around each dispatch,
  ``FlopCounterMode`` FLOPs per geometry → a live MFU gauge, and the
  ``--xprof DIR`` capture window (``torch.profiler``).

Tracing defaults OFF and costs one module-bool check per span; metrics
are passive counters; attribution records two CUDA events per
dispatched block of ticks and reads them once they have completed
(``root.common.observability.attribution=False`` disables).
"""

from . import metrics, tracing, attribution  # noqa: F401


def init_parser(parser):
    """The observability flags of the command line."""
    parser.add_argument(
        "--trace-out", default=None, metavar="FILE",
        help="enable span tracing and write a Chrome trace-event "
             "JSON (chrome://tracing / Perfetto) here at exit; "
             "worker spans ride the job protocol back to the "
             "master and land on one aligned timeline")
    parser.add_argument(
        "--trace-ring", type=int, default=None, metavar="N",
        help="bounded span-collector size (default 16384 spans; "
             "oldest dropped first)")
    parser.add_argument(
        "--xprof", default=None, metavar="DIR",
        help="open a torch.profiler capture window (CPU and CUDA "
             "activities) around the next --xprof-steps dispatches "
             "and write its Chrome trace into DIR")
    parser.add_argument(
        "--xprof-steps", type=int, default=4, metavar="N",
        help="dispatches inside the --xprof capture window "
             "(default 4)")
