"""The port's observability (``veles_tpu_torch.observability``) against
the JAX package's, on the CPU.

* tracing: the same span dicts give the same Chrome trace events in
  both packages; ``ClockSync`` gives the same offset on a synthetic
  skew; spans nest, capture and attach as JAX's do; a loopback master
  and worker (threads, port 0, tracing on) produce one timeline with
  both process tracks and every ``worker.step`` inside its
  ``server.dispatch``;
* attribution: ``record_step`` on a fake timer gives JAX's gauges and
  ``perf_summary``; the FLOP count of a tiny MNIST tick and a tiny
  TinyLM tick is the same on the plain route and on the kernel route
  (``_launch`` stubbed), and within a stated tolerance of JAX's
  ``estimate_flops``; ticks (in-process, and the jobs of a loopback
  master and worker) give the same bits with attribution on, off or
  absent; ``--xprof`` writes a trace file.

Every test puts the tracing switch, the span ring and attribution's
state back (``_clean``).
"""

import json
import os
import threading

import numpy
import pytest
import torch

from veles_tpu.observability import attribution as jattr
from veles_tpu.observability import tracing as jtrace

from veles_tpu_torch.observability import attribution as tattr
from veles_tpu_torch.observability import metrics as tmetrics
from veles_tpu_torch.observability import tracing as ttrace

from test_torch_network import kept_process_state

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' tracing and attribution state, and both config
    trees' ``observability`` nodes, put back after each test."""
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root as troot
    saved = [(r.common.observability,
              dict(r.common.observability.__dict__))
             for r in (jroot, troot)]
    try:
        yield
    finally:
        for mod in (ttrace, jtrace, tattr, jattr):
            mod.reset()
        for node, state in saved:
            node.__dict__.clear()
            node.__dict__.update(state)


def _peak(tflops):
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root as troot
    for r in (jroot, troot):
        r.common.observability.peak_tflops = tflops


# -- tracing -----------------------------------------------------------------


SPANS = [
    {"name": "server.dispatch", "ts": 1.0e15, "dur": 900.0, "id": 1,
     "parent": None, "trace_id": 1, "tid": 7, "attrs": {"worker": "w1"}},
    {"name": "net.send", "ts": 1.0e15 + 10, "dur": 20.0, "id": 2,
     "parent": 1, "trace_id": 1, "tid": 7, "attrs": None},
    {"name": "worker.step", "ts": 1.0e15 + 50, "dur": 700.5, "id": 9,
     "parent": 1, "trace_id": 1, "tid": 3, "attrs": {"pid": 11},
     "proc": "worker:w1/0"},
    {"name": "net.fold", "ts": 1.0e15 + 800, "dur": 50.0, "id": 4,
     "parent": 1, "trace_id": 1, "tid": 7},
]


def test_chrome_trace_events_match_jax(tmp_path):
    """The same span dicts give the same events, process tracks and
    JSON file in both packages."""
    got = ttrace.chrome_trace_events(SPANS, default_proc="master/1")
    assert got == jtrace.chrome_trace_events(SPANS,
                                             default_proc="master/1")
    names = {e["args"]["name"] for e in got if e["ph"] == "M"}
    assert names == {"master/1", "worker:w1/0"}
    path = str(tmp_path / "t.json")
    obj = ttrace.export_chrome_trace(path, SPANS, default_proc="m")
    with open(path) as fin:
        assert json.load(fin) == json.loads(json.dumps(
            jtrace.export_chrome_trace(None, SPANS, default_proc="m")))
    assert obj["displayTimeUnit"] == "ms"


def test_clock_sync_matches_jax():
    """Request/reply samples against a remote clock 2.5 s ahead with
    varying delays: the same minimum-RTT offset estimate and state in
    both packages, within half the best RTT of the true skew."""
    rng = numpy.random.RandomState(3)
    tsync, jsync = ttrace.ClockSync(), jtrace.ClockSync()
    t = 1000.0
    for _ in range(40):
        up, serve, down = rng.uniform(0.001, 0.05, 3)
        remote = t + up + serve / 2 + 2.5
        for sync in (tsync, jsync):
            sync.sample(t, remote, t + up + serve + down)
        t += 1.0
    tsync.sample(5.0, 1.0, 4.0)  # a clock step: discarded
    jsync.sample(5.0, 1.0, 4.0)
    assert tsync.state() == jsync.state()
    assert abs(tsync.offset - 2.5) <= tsync.rtt / 2
    assert tsync.to_remote(10.0) == jsync.to_remote(10.0)


def test_spans_nest_capture_attach_and_shift():
    """Disabled spans are the shared no-op; enabled ones nest by
    thread, ``capture`` diverts a thread's spans, ``attach`` parents
    them under a remote context, ``shift``/``ingest`` move them onto
    the master's clock and track — the JAX package's semantics, held
    by running the same script through both modules."""
    def script(tr):
        assert tr.span("x") is tr.span("y")  # disabled: the singleton
        tr.enable(ring=8)
        with tr.span("outer", a=1):
            with tr.span("inner"):
                ctx = tr.current()
        with tr.capture() as buf:
            with tr.attach(77, 5):
                with tr.span("remote.child"):
                    pass
        window = tr.begin("window", detached=True, w=2)
        window.finish()
        tr.ingest(tr.shift(buf, 1.5), proc="worker:w")
        for i in range(10):
            with tr.span("ring%d" % i):
                pass
        out = tr.spans()
        return ctx, buf, out

    (tctx, tbuf, tout), (jctx, jbuf, jout) = script(ttrace), \
        script(jtrace)
    assert len(tout) == len(jout) == 8  # the ring keeps the newest 8

    def shape(spans):
        return [(s["name"], s.get("proc"), s["parent"] is None,
                 s["trace_id"] == s["id"]) for s in spans]
    assert shape(tout) == shape(jout)
    assert [(s["name"], s["trace_id"], s["parent"]) for s in tbuf] == \
        [("remote.child", 77, 5)]
    assert [(s["name"], s["trace_id"], s["parent"]) for s in jbuf] == \
        [("remote.child", 77, 5)]
    assert tctx[0] is not None and jctx[0] is not None


def test_loopback_master_and_worker_trace_one_timeline():
    """A master and a worker of the protocol workflow over loopback, in
    threads on port 0, with tracing on: the worker is granted ``trace``,
    its ``worker.step`` spans come home shifted, and the exported trace
    holds the master's and the worker's tracks, every ``worker.step``
    strictly inside the ``server.dispatch`` span it names as parent,
    with the same trace id; ``net.serialize``, ``net.send`` and
    ``net.fold`` ride the dispatch windows."""
    from test_torch_network import (InstrumentedWorkflow, joined,
                                    stopped)
    from veles_tpu_torch.client import Client
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.server import Server
    with kept_process_state():
        ttrace.enable()
        master = InstrumentedWorkflow(Launcher())
        worker = InstrumentedWorkflow(Launcher())
        server = Server("127.0.0.1:0", master)
        client = Client("127.0.0.1:%d" % server.port, worker,
                        reconnect_attempts=1)
        t = threading.Thread(target=client.run, name="test-client")
        t.start()
        server.wait(timeout=60)
        joined(t, 60)
        stopped(server)
        spans = ttrace.spans()
    events = ttrace.chrome_trace_events(spans)
    tracks = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert any(n.startswith("master/") for n in tracks)
    assert any(n.startswith("worker:") for n in tracks)
    by_id = {s["id"]: s for s in spans if not s.get("proc")}
    steps = [s for s in spans if s["name"] == "worker.step"]
    assert len(steps) == InstrumentedWorkflow.job_limit
    for step in steps:
        dispatch = by_id[step["parent"]]
        assert dispatch["name"] == "server.dispatch"
        assert dispatch["trace_id"] == step["trace_id"]
        assert dispatch["ts"] < step["ts"]
        assert step["ts"] + step["dur"] < dispatch["ts"] + dispatch["dur"]
    names = {s["name"] for s in spans}
    assert {"net.serialize", "net.send", "net.fold"} <= names
    assert client.clock.samples >= 1


# -- attribution -------------------------------------------------------------


def test_record_step_gauges_match_jax():
    """Fake device timings through ``record_step``: the same EWMA
    state, MFU and ``perf_summary`` in both packages (peak 2 TFLOP/s
    configured), the same optimizer and MoE fields, and the ``device.*``
    gauges in the port's registry."""
    _peak(2.0)
    for d, f, k in ((0.010, 1.0e10, 1), (0.020, 1.0e10, 2),
                    (0.005, 2.0e10, 4)):
        snaps = [m.record_step(d, flops=f, ticks=k)
                 for m in (tattr, jattr)]
        assert snaps[0] == snaps[1]
    for m in (tattr, jattr):
        m.note_optimizer("adam", 4096, 0.25)
        m.note_moe(0.125, 0.5, 4, {("blk", 0): 0.5})
    assert tattr.perf_summary() == jattr.perf_summary()
    assert tattr.optimizer_summary() == jattr.optimizer_summary()
    assert tattr.moe_summary() == jattr.moe_summary()
    reg = tmetrics.registry
    assert reg.peek("device.dispatches").value == 3
    assert reg.peek("device.mfu").value == \
        round(tattr.perf_summary()["mfu"], 4)
    tattr.reset()
    assert reg.peek("device.dispatches") is None
    assert tattr.perf_summary() is None


def test_peak_table_names_only_the_h100():
    """No peak on the CPU or an unknown card; the H100's data-sheet
    figure under its exact name; the configured value wins."""
    assert tattr.peak_flops(torch.device("cpu")) is None
    assert dict(tattr.DEVICE_PEAK_TFLOPS) == {"NVIDIA H100 80GB HBM3":
                                              989.0}
    _peak(3.0)
    tattr._peak_cache.clear()
    assert tattr.peak_flops(torch.device("cpu")) == 3.0e12


def _mnist(seed=4):
    from veles_tpu_torch import prng
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    prng.reset()
    prng.get(0).seed(seed)
    launcher = Launcher()
    wf = MnistWorkflow(launcher, minibatch_size=100, max_epochs=1,
                       layers=(16, 10))
    launcher.initialize(device="cpu")
    return wf


def _tinylm(seed=4):
    from test_torch_training import _build
    return _build(seed=seed, port_only=True)


def _counted_tick(wf):
    """Ticks through the workflow's dispatch (peak configured) until a
    train tick has run under the FLOP counter; returns the counts by
    geometry (the validation tick's and the train tick's)."""
    for _ in range(50):
        wf.loader.run()
        if ("train",) in wf.compiler._step_flops_:
            return dict(wf.compiler._step_flops_)
    raise AssertionError("no train tick in 50")


def _stub_kernels(monkeypatch):
    """The kernel route on the CPU: ``attention._try_kernel`` takes the
    flash Functions for CPU tensors, their wrappers take the kernel
    branch, and ``_launch`` computes the plain result into the outputs
    out of the counter's sight — as a kernel is."""
    from torch.utils._python_dispatch import _disable_current_modes
    from veles_tpu_torch.ops import attention as A
    from veles_tpu_torch.ops import flash_attention as FA

    def try_kernel(q, k, v, causal, kv_len=None, mode=None,
                   precision=None):
        return FA.flash_attention(
            q, k, v, causal=causal, kv_len=kv_len,
            operand_dtype=A.attention_compute_dtype(precision))

    def launch(fn, name, *args):
        geo = args[-10:]
        causal, q_off, k_off, kv_len = (bool(geo[6]), geo[7], geo[8],
                                        None if geo[9] < 0 else geo[9])
        od = {v: k for k, v in FA._CODES.items()}[args[1]]
        t = args[2:-10]
        with _disable_current_modes(), torch.no_grad():
            if "fwd" in fn:
                out, lse = FA.flash_attention_reference(
                    t[0], t[1], t[2], causal, q_off, k_off, kv_len, od)
                t[3].copy_(out)
                t[4].copy_(lse)
            elif "dq" in fn:
                t[6].copy_(FA.flash_attention_dq_reference(
                    *t[:6], causal, q_off, k_off, kv_len, od))
            else:
                dk, dv = FA.flash_attention_dkv_reference(
                    *t[:6], causal, q_off, k_off, kv_len, od)
                t[6].copy_(dk)
                t[7].copy_(dv)

    monkeypatch.setattr(A, "_try_kernel", try_kernel)
    monkeypatch.setattr(FA, "_on_card", lambda t: True)
    monkeypatch.setattr(FA, "_launch", launch)
    FA.reset_launches()
    return FA


@pytest.mark.parametrize("build", ["mnist", "tinylm"])
def test_flops_same_on_plain_and_kernel_route(build, monkeypatch):
    """A train tick's FLOPs on the plain route equal those on the
    kernel route, where the counter sees no attention product and the
    wrappers report theirs (``_report_flops``); the kernel route
    launched B1-B3 (TinyLM)."""
    _peak(1.0)
    make = _mnist if build == "mnist" else _tinylm
    plain = _counted_tick(make())
    assert plain and all(v > 0 for v in plain.values())
    tattr.reset()
    _peak(1.0)
    FA = _stub_kernels(monkeypatch)
    kernel = _counted_tick(make())
    assert kernel == plain
    if build == "tinylm":
        assert FA.flash_forward.launches > 0
        assert FA.flash_dq.launches == FA.flash_dkv.launches > 0


def test_flops_near_jax_estimate():
    """The TinyLM train tick's count against JAX's ``estimate_flops``
    of the same geometry's train step (XLA's HLO cost model): within
    25 %.  XLA counts every elementwise op too (the softmax, the layer
    norms, the optimizer), which ``FlopCounterMode`` leaves out; the
    matrix products agree."""
    import jax
    from test_torch_training import _build
    _peak(1.0)
    jwf, twf = _build(seed=4)
    port = _counted_tick(twf)[("train",)]
    comp = jwf.compiler
    comp.compile()
    params = {n: v.devmem for n, v in comp._param_vecs.items()}
    states = {n: v.devmem for n, v in comp._state_vecs.items()}
    batch = {str(id(v)): v.devmem for v in comp.batch_vectors}
    consts = {str(id(v)): v.devmem for v in comp.const_vectors}
    want = jattr.estimate_flops(comp._train, params, states, batch,
                                consts, jax.random.PRNGKey(0))
    assert want is not None
    assert abs(port - want) <= 0.25 * want, (port, want)


def test_ticks_same_bits_with_attribution_on_off_absent():
    """Three MNIST runs from one seed — attribution on with a peak (the
    first tick counted), off, and on without a peak — end on the same
    weights bit for bit; the run with attribution on published device
    time and MFU."""
    from veles_tpu_torch.config import root as troot
    results = []
    for on, peak in ((True, 1.0), (False, None), (True, None)):
        tattr.reset()
        troot.common.observability.attribution = on
        troot.common.observability.peak_tflops = peak
        wf = _mnist()
        wf.workflow.run()
        results.append({u.name: {a: numpy.array(v.mem) for a, v in
                                 (getattr(u, "trainables", None) or
                                  {}).items()} for u in wf.units})
        if on and peak:
            perf = tattr.perf_summary(wait=True)
            assert perf["step_ms"] > 0 and 0 < perf["mfu"]
            assert perf["optimizer"] == "sgd"
    for other in results[1:]:
        for unit, attrs in results[0].items():
            for attr, arr in attrs.items():
                assert numpy.array_equal(other[unit][attr], arr)


def test_loopback_jobs_same_bits_with_attribution_on_off(tmp_path):
    """A port master and worker over loopback (fp32 deltas, jobs of two
    ticks), run twice from one seed: with tracing and attribution on
    and a peak configured (the worker's first job of each geometry
    under the FLOP counter), then with both off.  The master's weights
    end equal bit for bit; only the first run published a dispatch span
    and an MFU."""
    from test_torch_network import (_loopback, _port_mlp, trainables,
                                    write_mnist_idx)
    from veles_tpu_torch.client import Client
    from veles_tpu_torch.config import root as troot
    from veles_tpu_torch.server import Server
    write_mnist_idx(str(tmp_path))
    weights, perfs, steps = [], [], []
    with kept_process_state():
        troot.common.dirs.datasets = str(tmp_path)
        troot.common.engine.precision_level = 1
        troot.common.net.job_ticks = 2
        troot.common.net.codec = "none"
        for on in (True, False):
            tattr.reset()
            ttrace.reset()
            if on:
                ttrace.enable()
            troot.common.observability.attribution = on
            troot.common.observability.peak_tflops = 1.0 if on else None
            master, client = _loopback(_port_mlp, Server, Client, 2)
            assert client.jobs_done > 0
            weights.append(trainables(master))
            perfs.append(tattr.perf_summary(wait=True))
            steps.append(sum(s["name"] == "worker.step"
                             for s in ttrace.spans()))
    assert steps[0] > 0 and steps[1] == 0
    on, off = weights
    assert sorted(on) == sorted(off) and on
    for name in on:
        assert numpy.array_equal(on[name], off[name]), name
    # The MFU is published (rounded to 4 places, a loaded host's long
    # span may read 0.0 against the 1 TFLOP/s peak).
    assert perfs[0]["step_ms"] > 0 and "mfu" in perfs[0]
    assert perfs[0]["flops_per_dispatch"] > 0
    assert perfs[1] is None


def test_xprof_window_writes_a_trace(tmp_path):
    """``configure_xprof(DIR, 2)``: the torch.profiler window opens at
    the next dispatch and closes after two, writing a Chrome trace into
    DIR with the ticks' ops in it."""
    tattr.configure_xprof(str(tmp_path / "xprof"), 2)
    wf = _mnist()
    wf.loader.run()
    assert tattr.xprof_trace() is None
    wf.loader.run()
    path = tattr.xprof_trace()
    assert path and os.path.dirname(path) == str(tmp_path / "xprof")
    with open(path) as fin:
        trace = json.load(fin)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names)
