"""Dispatch-span and MFU attribution for the training tick.

``StepCompiler`` dispatches are asynchronous on the card: a host clock
around the call measures the enqueue, not the device.  This module
closes the gap without adding a host sync to the tick: around each
dispatch the compiler records a pair of CUDA events on the step's
stream (:func:`begin_step` / :func:`end_step`), and the pair is read
once it has completed — at the next :func:`begin_step`, or at
:func:`perf_summary`, which queries first and waits only when asked to
(``wait=True``, at the end of a run).  On the CPU the delta is a
``perf_counter`` one.

What the pair measures is the dispatch's STREAM SPAN: the time between
the two events on the stream.  That is not device-busy time: it also
holds every stretch in which the stream waited for the host inside the
dispatch (between the ticks of a multi-tick dispatch, or between the
launches of one tick when the host enqueues slower than the card runs).
So ``device.step_ms`` and ``device_s_total`` (the JAX package's names,
kept) are spans, an upper bound on the busy time, and the MFU, which
divides the dispatch's FLOPs by that span, is a lower bound on the MFU
of the busy time.  An idle share cannot be read from them.

FLOPs per dispatch come from ``torch.utils.flop_counter
.FlopCounterMode`` over one tick per geometry (:func:`count_flops`),
and only when a peak is known (the MFU denominator).  The hand-written
kernels launch through ``ctypes`` and are invisible to the counter, so
their wrappers report their own FLOPs (:func:`report_flops`) by a
formula equal to what the counter sees of their plain versions: the
count is the same whichever route runs.  Combined with the stream span
that gives a live MFU gauge in the process metrics registry and the
``perf`` summary.

Also owns the ``--xprof DIR`` capture window: a ``torch.profiler``
window (CPU and CUDA activities) opened at the next dispatch and closed
after N of them, written into DIR as a Chrome trace.

Knobs (``root.common.observability``):

* ``attribution`` (default True) — the events and their reads; off,
  the tick runs without them;
* ``peak_tflops`` — the MFU denominator; defaults from the table below,
  None on any other card and on the CPU (the span still publishes;
  the MFU gauge stays silent).

Everything here is accounting around an unchanged computation: the
bits a tick computes are the same with attribution on, off or absent.
"""

import collections
import logging
import os
import threading
import time

#: ``torch.cuda.get_device_name()`` → peak dense bf16 TFLOP/s, the MFU
#: denominator: NVIDIA's data sheet for the H100 SXM5 (989 TFLOP/s
#: without sparsity, at the full power limit; the card this table was
#: written against reports "NVIDIA H100 80GB HBM3, 700.00 W" through
#: nvidia-smi).  A card set below 700 W runs slower under load, so
#: its MFU reads low against this figure.
DEVICE_PEAK_TFLOPS = (
    ("NVIDIA H100 80GB HBM3", 989.0),
)

#: EWMA smoothing for the live gauges (per dispatch).
EWMA_ALPHA = 0.25

_lock = threading.Lock()
_state = {
    "device_ms": None,     # EWMA stream span per dispatch, ms
    "mfu": None,           # EWMA model-flop utilization
    "flops": None,         # last per-dispatch FLOP estimate
    "dispatches": 0,
    "ticks": 0,
    "device_s_total": 0.0,
}
_xprof = {"dir": None, "steps": 0, "done": 0, "started": False,
          "prof": None, "path": None}
#: Optimizer observability (StepCompiler.compile publishes once per
#: compile): the configured kind(s), total slot bytes, and the ZeRO
#: shard fraction each dp rank persistently stores (1.0 = replicated).
_optimizer = {"kind": None, "state_bytes": None, "shard_frac": None}
#: MoE router observability (DecisionGD publishes per class-epoch
#: from the blocks' moe_acc accumulators): mean load-balance aux per
#: tick and the worst expert-load share (1/E = balanced, 1.0 =
#: collapsed).
_moe = {"aux_loss": None, "max_load_frac": None, "n_experts": None}
_timer = time.perf_counter  # injectable for tests
#: (configured peak, device) -> resolved FLOP/s (constant per process;
#: never paid per dispatch).
_peak_cache = {}
#: CUDA event pairs recorded but not yet read, oldest first.
_pending = collections.deque()
_pending_lock = threading.Lock()
#: The FLOPs the kernels report while a tick is counted (a one-element
#: list), else None.  Process-wide, not per thread: a CUDA backward
#: runs on autograd's device thread.
_reported = [None]


def _config(name, default):
    from ..config import root, get as config_get
    return config_get(getattr(root.common.observability, name),
                      default)


def enabled():
    """Device-time attribution on?  (Default True.)"""
    return bool(_config("attribution", True))


def reset():
    """Clears accumulated attribution state, the unread event pairs, an
    open capture window, AND this module's ``device.*``,
    ``optimizer.*`` and ``moe.*`` series in the process registry (test
    isolation)."""
    with _lock:
        _state.update(device_ms=None, mfu=None, flops=None,
                      dispatches=0, ticks=0, device_s_total=0.0)
        _optimizer.update(kind=None, state_bytes=None,
                          shard_frac=None)
        _moe.update(aux_loss=None, max_load_frac=None,
                    n_experts=None)
    with _pending_lock:
        _pending.clear()
    prof = _xprof["prof"]
    if prof is not None:
        try:
            prof.__exit__(None, None, None)
        except Exception as e:
            logging.getLogger("attribution").debug(
                "closing the capture window failed: %s", e)
    _xprof.update(dir=None, steps=0, done=0, started=False, prof=None,
                  path=None)
    _peak_cache.clear()
    _reported[0] = None
    from . import metrics
    metrics.registry.remove_prefix("device.")
    metrics.registry.remove_prefix("optimizer.")
    metrics.registry.remove_prefix("moe.")


def _device_name(device):
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return ""
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return ""
    return torch.cuda.get_device_name(device)


def peak_flops(device=None):
    """The MFU denominator in FLOP/s, or None when unknown: the
    configured ``peak_tflops``, else the table's figure for the card
    ``device`` (default: the current CUDA card) names.  None on the CPU
    and on any card the table does not hold.  Memoized — this sits on
    the per-dispatch path."""
    configured = _config("peak_tflops", None)
    key = (configured, str(device))
    if key in _peak_cache:
        return _peak_cache[key]
    if configured:
        peak = float(configured) * 1e12
    else:
        try:
            name = _device_name(device)
        except Exception as e:
            logging.getLogger("attribution").debug(
                "device-name probe failed: %s", e)
            name = ""
        peak = None
        for card, tflops in DEVICE_PEAK_TFLOPS:
            if name == card:
                peak = tflops * 1e12
                break
    _peak_cache[key] = peak
    return peak


# -- FLOPs -----------------------------------------------------------------

def counting():
    """True while a tick runs under :func:`count_flops`."""
    return _reported[0] is not None


def report_flops(n):
    """A kernel wrapper's FLOPs by its formula, added to the counted
    tick's total; a no-op outside :func:`count_flops`."""
    box = _reported[0]
    if box is not None:
        with _lock:
            box[0] += int(n)


def count_flops(fn):
    """Runs ``fn()`` once under ``FlopCounterMode`` and returns
    ``(result, flops)``: the counter's total plus what the kernels
    reported.  The counter passes every op through unchanged."""
    from torch.utils.flop_counter import FlopCounterMode
    box = [0]
    _reported[0] = box
    try:
        with FlopCounterMode(display=False) as counter:
            out = fn()
        total = counter.get_total_flops() + box[0]
    finally:
        _reported[0] = None
    return out, total


# -- xprof capture window --------------------------------------------------

def configure_xprof(directory, steps=4):
    """Arms the capture window: a ``torch.profiler`` trace spanning
    the next ``steps`` dispatches (opened lazily at the first one),
    written into ``directory`` as a Chrome trace."""
    _xprof.update(dir=directory, steps=int(steps), done=0,
                  started=False, prof=None, path=None)


def xprof_trace():
    """The path of the last capture window's trace, or None."""
    return _xprof["path"]


def _xprof_step_begin():
    if _xprof["dir"] is None or _xprof["started"] \
            or _xprof["done"] >= _xprof["steps"]:
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        _xprof.update(prof=prof, started=True)
    except Exception:
        # The operator explicitly asked for a capture (--xprof):
        # a disarm must be LOUD, not a mystery empty directory.
        logging.getLogger("attribution").exception(
            "xprof capture could not start — disarming")
        _xprof["dir"] = None


def _xprof_step_end():
    if not _xprof["started"]:
        return
    _xprof["done"] += 1
    if _xprof["done"] < _xprof["steps"]:
        return
    prof, directory = _xprof["prof"], _xprof["dir"]
    _xprof.update(started=False, dir=None, prof=None)
    try:
        prof.__exit__(None, None, None)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "trace_%d_%d.json" % (
            os.getpid(), int(time.time() * 1e3)))
        prof.export_chrome_trace(path)
        _xprof["path"] = path
    except Exception:
        logging.getLogger("attribution").exception(
            "xprof capture could not be written into %s", directory)


# -- per-dispatch hooks (called by StepCompiler) ---------------------------

class _StepTimer(object):
    __slots__ = ("t0", "ticks", "flops", "device", "start", "end")

    def __init__(self, ticks, flops, device):
        self.t0 = _timer()
        self.ticks = ticks
        self.flops = flops
        self.device = device
        self.start = self.end = None


def begin_step(ticks=1, flops=None, device=None, timed=True):
    """Called right before a dispatch on ``device`` (a
    ``torch.device``; None = the host clock).  Folds the event pairs of
    earlier dispatches that have completed, then returns a timer token
    for :func:`end_step`, or None when nothing here is active or the
    dispatch is not ``timed`` (it still counts in a capture window)."""
    _xprof_step_begin()
    if not enabled() or not timed:
        return None
    _drain(wait=False)
    timer = _StepTimer(ticks, flops, device)
    if device is not None and device.type == "cuda":
        import torch
        timer.start = torch.cuda.Event(enable_timing=True)
        timer.start.record(torch.cuda.current_stream(device))
    return timer


def end_step(timer, device=None):
    """Called right after the dispatch returns.  On the card it
    records the closing event and leaves the pair to be read once it
    has completed (no host sync); on the CPU it folds the host delta
    into the live gauges at once."""
    if timer is not None and timer.start is not None:
        import torch
        timer.end = torch.cuda.Event(enable_timing=True)
        timer.end.record(torch.cuda.current_stream(device))
        with _pending_lock:
            _pending.append(timer)
    _xprof_step_end()
    if timer is None or timer.start is not None:
        return None
    return record_step(_timer() - timer.t0, flops=timer.flops,
                       ticks=timer.ticks, device=timer.device)


def _drain(wait):
    """Folds the recorded event pairs, oldest first: those that have
    completed, or (``wait``) all of them."""
    while True:
        with _pending_lock:
            if not _pending:
                return
            timer = _pending[0]
            if not wait and not timer.end.query():
                return
            _pending.popleft()
        timer.end.synchronize()
        record_step(timer.start.elapsed_time(timer.end) / 1e3,
                    flops=timer.flops, ticks=timer.ticks,
                    device=timer.device)


def record_step(device_seconds, flops=None, ticks=1, device=None):
    """Folds one measured dispatch (``device_seconds``: its stream
    span, see the module's docstring) into the attribution state and
    the metrics registry — separated from :func:`end_step` so tests
    can drive the MFU plumbing with a fake device timer."""
    from . import metrics
    device_seconds = max(float(device_seconds), 1e-9)
    mfu = None
    peak = peak_flops(device) if flops else None
    if flops and peak:
        mfu = float(flops) / device_seconds / peak
    with _lock:
        ms = device_seconds * 1e3
        prev = _state["device_ms"]
        _state["device_ms"] = ms if prev is None else \
            prev + EWMA_ALPHA * (ms - prev)
        if mfu is not None:
            prev = _state["mfu"]
            _state["mfu"] = mfu if prev is None else \
                prev + EWMA_ALPHA * (mfu - prev)
        if flops:
            _state["flops"] = float(flops)
        _state["dispatches"] += 1
        _state["ticks"] += int(ticks)
        _state["device_s_total"] += device_seconds
        snap = dict(_state)
    reg = metrics.registry
    reg.counter("device.dispatches").inc()
    reg.counter("device.ticks").inc(int(ticks))
    reg.gauge("device.step_ms").set(round(snap["device_ms"], 3))
    if snap["mfu"] is not None:
        reg.gauge("device.mfu").set(round(snap["mfu"], 4))
    if snap["flops"] is not None:
        reg.gauge("device.flops_per_dispatch").set(snap["flops"])
    return snap


def note_optimizer(kind, state_bytes, shard_frac=1.0):
    """Publishes the optimizer observability gauges (called by
    ``StepCompiler.compile`` once per compile): ``optimizer.
    state_bytes`` and ``optimizer.shard_frac`` in the process metrics
    registry, labeled with the optimizer kind, plus the ``perf``
    summary fields."""
    with _lock:
        _optimizer.update(kind=str(kind),
                          state_bytes=int(state_bytes),
                          shard_frac=float(shard_frac))
    from . import metrics
    reg = metrics.registry
    labels = {"kind": str(kind)}
    reg.gauge("optimizer.state_bytes",
              labels=labels).set(int(state_bytes))
    reg.gauge("optimizer.shard_frac",
              labels=labels).set(round(float(shard_frac), 6))


def note_moe(aux_loss, max_load_frac, n_experts, expert_shares=None):
    """Publishes the MoE router gauges (called by DecisionGD at
    epoch boundaries from the blocks' ``moe_acc`` rows):
    ``moe.aux_loss`` (mean load-balance aux per tick) and
    ``moe.expert_load`` (per-expert share, labeled by block and
    expert index) in the process metrics registry, plus the ``perf``
    summary fields — the live router-collapse signal."""
    with _lock:
        _moe.update(aux_loss=float(aux_loss),
                    max_load_frac=float(max_load_frac),
                    n_experts=int(n_experts))
    from . import metrics
    reg = metrics.registry
    reg.gauge("moe.aux_loss").set(round(float(aux_loss), 6))
    reg.gauge("moe.max_load_frac").set(
        round(float(max_load_frac), 6))
    for (block, idx), share in (expert_shares or {}).items():
        reg.gauge("moe.expert_load",
                  labels={"block": str(block),
                          "expert": str(idx)}).set(
            round(float(share), 6))


def moe_summary():
    """The last published MoE router stats, or None when no MoE
    epoch has completed."""
    with _lock:
        if _moe["aux_loss"] is None:
            return None
        return dict(_moe)


def optimizer_summary():
    """The last published optimizer stats, or None before the first
    compiled step."""
    with _lock:
        if _optimizer["kind"] is None:
            return None
        return dict(_optimizer)


def perf_summary(wait=False):
    """Live dispatch span and MFU for this process's tick, or None
    before the first measured dispatch: ``step_ms`` is the EWMA of the
    dispatch's stream span, ``device_s_total`` the sum of the spans, and
    ``mfu`` the FLOPs over the span against the peak (a lower bound; see
    the module's docstring).  Completed event pairs are folded first;
    ``wait`` waits for the rest (the end of a run) — without it a tick
    in flight is never blocked on."""
    _drain(wait)
    with _lock:
        if not _state["dispatches"]:
            return None
        out = {
            "dispatches": _state["dispatches"],
            "ticks": _state["ticks"],
            "step_ms": round(_state["device_ms"], 3)
            if _state["device_ms"] is not None else None,
            "device_s_total": round(_state["device_s_total"], 3),
        }
        if _state["mfu"] is not None:
            out["mfu"] = round(_state["mfu"], 4)
        if _state["flops"] is not None:
            out["flops_per_dispatch"] = _state["flops"]
        if _optimizer["kind"] is not None:
            out["optimizer"] = _optimizer["kind"]
            out["optimizer_state_bytes"] = _optimizer["state_bytes"]
            out["optimizer_shard_frac"] = _optimizer["shard_frac"]
        if _moe["aux_loss"] is not None:
            out["moe_aux_loss"] = round(_moe["aux_loss"], 6)
            out["moe_max_load_frac"] = round(_moe["max_load_frac"],
                                             6)
    return out
