"""The port's web-status dashboard (``veles_tpu_torch.web_status``) and
the launcher's heartbeats against the JAX package's, on the CPU.

Each test of the JAX package's ``tests/test_web_status.py`` has its
counterpart here on the port (update and dashboard, the serving row, the
live serving summary, the command round trip, the unknown master, the
stale-master GC, heartbeats of a training run, escaping, the token, the
graph and plot panels, the payload's graph and plots, oversized plots),
and the parity tests hold the port against JAX: the same update gives
the same ``/api/status`` (minus the age) and the same HTML page; the
same MNIST run, trained alike in both packages, gives the same heartbeat
JSON minus ids and times (error rates within one sample of the
validation set, the perf row's counts exactly, the DOT graph exactly).
A ``pause`` queued through ``/service`` reaches a master's worker
through a heartbeat and is applied (``Server.pause_slave``), then
``resume``.

Every server binds port 0 and every test runs under
``test_torch_network.kept_process_state``; heartbeat waits poll with a
deadline.
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest

from veles_tpu.web_status import WebStatusServer as JaxWebStatusServer

from veles_tpu_torch import prng as tprng
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.web_status import WebStatusServer

from test_torch_network import (MLP, kept_process_state, joined,
                                write_mnist_idx)


@pytest.fixture(autouse=True)
def _process_state():
    """``kept_process_state``, with both packages' attribution (whose
    totals ride the perf row) cleared before and after."""
    from veles_tpu.observability import attribution as jattr
    from veles_tpu_torch.observability import attribution as tattr
    with kept_process_state():
        for mod in (tattr, jattr):
            mod.reset()
        try:
            yield
        finally:
            for mod in (tattr, jattr):
                mod.reset()


@pytest.fixture
def status_server():
    srv = WebStatusServer(host="127.0.0.1", port=0, expiry=30.0).start()
    yield srv
    srv.stop()


@pytest.fixture
def mnist_data(tmp_path):
    """Synthetic MNIST files for both packages, f32 activations."""
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root as troot
    write_mnist_idx(str(tmp_path))
    for r in (jroot, troot):
        r.common.dirs.datasets = str(tmp_path)
        r.common.engine.precision_level = 1
    return jroot, troot


def _post(port, path, payload, token=None):
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["X-Status-Token"] = token
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=json.dumps(payload).encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=30) as resp:
        return resp.read().decode()


def _poll(predicate, timeout=30.0, what="the condition"):
    """Polls ``predicate`` until it returns a true value or the deadline
    passes (a failure naming ``what``)."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        value = predicate()
        if value:
            return value
        time.sleep(0.02)
    pytest.fail("timed out after %.0f s waiting for %s" % (timeout, what))


UPDATE = {
    "id": "m1", "workflow": "MnistWorkflow", "mode": "standalone",
    "epoch": 4, "runtime": 12.5, "metrics": {"validation_err": 0.05},
    "slaves": {"w/1": {"state": "WORK", "jobs_done": 7,
                       "jobs_per_s": 1.5}},
    "serving": {"engines": 1, "tok_per_sec": 1234.5},
    "perf": {"dispatches": 3, "step_ms": 2.5, "mfu": 0.25},
    "health": {"policy": "skip", "events": 1},
    "comms": {"net.bytes_sent": 100}, "resilience": {"net.drop": 0},
    "population": {"members": 2}, "fabric": {"replicas": 2},
    "fleet": {"epoch": 3},
    "graph": 'digraph G { a [label="<b>"]; a -> b; }',
}


def test_update_and_dashboard_match_jax():
    """The same update posted to the port's dashboard and to the JAX
    package's gives the same reply, ``/api/status`` (minus the age), HTML
    page and ``/metrics`` gauges of the master."""
    port = WebStatusServer(host="127.0.0.1", port=0).start()
    jax = JaxWebStatusServer(host="127.0.0.1", port=0).start()
    try:
        replies = [_post(s.port, "/update", json.loads(json.dumps(UPDATE)))
                   for s in (port, jax)]
        assert replies[0] == replies[1] == {"commands": []}
        statuses = [json.loads(_get(s.port, "/api/status"))
                    for s in (port, jax)]
        for status in statuses:
            assert status["m1"].pop("age") >= 0.0
        assert statuses[0] == statuses[1]
        assert statuses[0]["m1"]["workflow"] == "MnistWorkflow"
        page = _get(port.port, "/")
        assert page == _get(jax.port, "/")
        assert "MnistWorkflow" in page and "w/1" in page

        def gauges(text):
            return sorted(line for line in text.splitlines()
                          if 'master="m1"' in line and
                          "heartbeat_age" not in line)
        assert gauges(_get(port.port, "/metrics")) == \
            gauges(_get(jax.port, "/metrics"))
        assert any("perf_step_ms" in g for g in gauges(
            _get(port.port, "/metrics")))
    finally:
        port.stop()
        jax.stop()


def test_dashboard_renders_serving_row(status_server):
    _post(status_server.port, "/update", {
        "id": "m-serve", "workflow": "ServeWorkflow",
        "serving": {"engines": 1, "tok_per_sec": 1234.5,
                    "kv_blocks_used": 40, "kv_blocks_total": 64,
                    "queue_depth": 2}})
    page = _get(status_server.port, "/")
    assert "serving" in page and "1234.5" in page
    assert "kv_blocks_used" in page


def test_live_serving_summary_aggregates_engines():
    """A started engine of the port shows in the heartbeat's serving
    summary; a stopped one drops out."""
    from veles_tpu_torch.serving import ServingEngine
    from veles_tpu_torch.serving.metrics import live_serving_summary

    class Model(object):
        max_position = None

        def forward(self, x):
            return numpy.asarray(x)

    def engines():
        return (live_serving_summary() or {}).get("engines", 0)

    engine = ServingEngine(Model(), max_batch=2)
    before = engines()  # another file's engine may still be live
    engine.start()
    try:
        summary = live_serving_summary()
        assert summary["engines"] == before + 1
        assert "tok_per_sec" in summary
        payload = Launcher().status_payload("m/1")
        assert payload["serving"]["engines"] == before + 1
    finally:
        engine.stop()
    assert engines() == before


def test_service_command_roundtrip(status_server):
    _post(status_server.port, "/update", {"id": "m2", "workflow": "X"})
    _post(status_server.port, "/service",
          {"master": "m2", "command": "pause", "slave": "w/9"})
    reply = _post(status_server.port, "/update", {"id": "m2"})
    assert reply["commands"] == [{"command": "pause", "slave": "w/9"}]
    assert _post(status_server.port, "/update", {"id": "m2"}) == \
        {"commands": []}


@pytest.mark.parametrize("body", [{"master": "ghost", "command": "pause"},
                                  {"master": "m3", "command": "explode"}])
def test_unknown_master_or_command_is_400(status_server, body):
    _post(status_server.port, "/update", {"id": "m3", "workflow": "X"})
    req = urllib.request.Request(
        "http://127.0.0.1:%d/service" % status_server.port,
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_stale_masters_gc():
    srv = WebStatusServer(host="127.0.0.1", port=0, expiry=0.2).start()
    try:
        _post(srv.port, "/update", {"id": "old", "workflow": "X"})
        assert "old" in srv.status()
        _poll(lambda: "old" not in srv.status(), 10.0,
              "the stale master's removal")
    finally:
        srv.stop()


def _port_mnist(launcher, seed=5):
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    tprng.reset()
    tprng.get(0).seed(seed)
    return MnistWorkflow(launcher, **MLP)


def _jax_mnist(seed=5):
    import veles_tpu.prng as jprng
    from veles_tpu.launcher import Launcher as JLauncher
    from veles_tpu.znicz.samples.mnist import MnistWorkflow
    jprng.reset()
    jprng.get(0).seed(seed)
    launcher = JLauncher()
    return launcher, MnistWorkflow(launcher, **MLP)


def test_launcher_heartbeats_reach_dashboard(status_server, mnist_data):
    """A training run of the port posts heartbeats with its epoch and
    live metrics; they end with the run."""
    launcher = Launcher(status_address="127.0.0.1:%d" % status_server.port,
                        heartbeat_interval=0.05)
    wf = _port_mnist(launcher)
    launcher.initialize(device="cpu")
    _poll(status_server.status, 30.0, "the first heartbeat")
    launcher.run()
    assert launcher._heartbeat_thread is None
    status = status_server.status()
    assert len(status) == 1
    info = next(iter(status.values()))
    assert info["workflow"] == "MnistWorkflow"
    assert info["mode"] == "standalone"
    assert info["epoch"] >= 1
    assert "validation_err" in info.get("metrics", {})
    assert info["graph"] == wf.generate_graph(write_on_disk=False)
    assert launcher.heartbeats >= 1


#: Heartbeat rows fed by process-wide registries of live objects.
LIVE_ROWS = ("serving", "fabric", "population", "fleet")
#: Counters the JAX package keeps and the port has no counterpart of:
#: its lock-order analysis counts the XLA compiles.
JAX_ONLY_COUNTERS = ("analysis.",)


def test_heartbeat_json_matches_jax(mnist_data):
    """The same MNIST run (same files, seed and f32 activations) in both
    packages: the heartbeat JSON is the same but for ids and times (and
    the rows of live objects elsewhere in the process) — the rows
    present, the epoch, mode and workflow exactly, the error rates
    within one validation sample, the perf row's counts and optimizer
    fields exactly (its device times are the packages' own), the
    resilience counters but JAX's compile count, and the DOT graph.  The
    resilience counters are process-wide, and an earlier test file on
    this worker may have counted into either package's: the counts the
    two runs added are compared."""
    from veles_tpu import resilience as jresilience
    from veles_tpu_torch import resilience as tresilience
    before = (tresilience.stats.snapshot(), jresilience.stats.snapshot())
    launcher = Launcher()
    _port_mnist(launcher)
    launcher.initialize(device="cpu")
    launcher.run()
    jlauncher, _ = _jax_mnist()
    jlauncher.initialize()
    jlauncher.run()
    got = launcher.status_payload("m/1")
    want = jlauncher.status_payload("m/1")
    # The rows of live engines, fabrics, population masters and fleet
    # schedulers anywhere in the process: an earlier test file on this
    # worker may have left one of either package's alive.
    for row in LIVE_ROWS:
        got.pop(row, None)
        want.pop(row, None)
    times = ("runtime",)
    timed_perf = ("step_ms", "device_s_total", "mfu")

    def added(row, counts):
        return {k: v - counts.get(k, 0) for k, v in row.items()
                if v != counts.get(k, 0)
                and not k.startswith(JAX_ONLY_COUNTERS)}

    assert added(got.pop("resilience", {}), before[0]) == \
        added(want.pop("resilience", {}), before[1])
    assert sorted(got) == sorted(want)
    for key in times:
        assert got.pop(key) >= 0.0 and want.pop(key) >= 0.0
    n_valid = float(jlauncher.workflow.decision.epoch_n_valid[1])
    gm, wm = got.pop("metrics"), want.pop("metrics")
    assert sorted(gm) == sorted(wm)
    for name in wm:
        assert abs(gm[name] - wm[name]) <= 1.0 / n_valid + 1e-12, name
    gp, wp = got.pop("perf"), want.pop("perf")
    assert sorted(gp) == sorted(wp)
    for name in wp:
        if name not in timed_perf:
            assert gp[name] == wp[name], name
    assert got == want
    assert got["graph"].startswith("digraph MnistWorkflow {")


def test_heartbeat_html_is_escaped(status_server):
    _post(status_server.port, "/update", {
        "id": "evil", "workflow": "<script>alert(1)</script>",
        "mode": "master", "runtime": "NaN-ish",
        "slaves": {"<img src=x>": {"state": "<b>w</b>", "jobs_done": 1}}})
    page = _get(status_server.port, "/")
    assert "<script>alert" not in page
    assert "&lt;script&gt;" in page
    assert "<img src=x>" not in page


def test_post_token_enforcement():
    srv = WebStatusServer(host="127.0.0.1", port=0, token="sekrit").start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, "/update", {"id": "m1", "workflow": "W"})
        assert e.value.code == 403
        assert _post(srv.port, "/update", {"id": "m1", "workflow": "W"},
                     token="sekrit") == {"commands": []}
        assert "m1" in srv.status()
    finally:
        srv.stop()


TINY_PNG = (  # 1x1 transparent PNG
    b"\x89PNG\r\n\x1a\n\x00\x00\x00\rIHDR\x00\x00\x00\x01\x00\x00"
    b"\x00\x01\x08\x06\x00\x00\x00\x1f\x15\xc4\x89\x00\x00\x00\n"
    b"IDATx\x9cc\x00\x01\x00\x00\x05\x00\x01\r\n-\xb4\x00\x00\x00"
    b"\x00IEND\xaeB`\x82")


def test_dashboard_renders_graph_and_plots(status_server):
    _post(status_server.port, "/update", {
        "id": "m2", "workflow": "AlexNet", "mode": "standalone",
        "graph": 'digraph G { a [label="<script>evil()</script>"]; '
                 "a -> b; }",
        "plots": {"train_err": base64.b64encode(TINY_PNG).decode(),
                  "evil": base64.b64encode(
                      b"<script>alert(1)</script>").decode(),
                  "junk": "%%%not-base64%%%"}})
    page = _get(status_server.port, "/")
    assert "workflow graph (DOT)" in page
    assert "a -&gt; b" in page
    assert "<script>evil()" not in page
    assert "data:image/png;base64," in page
    assert "train_err" in page
    assert base64.b64encode(b"<script>alert(1)</script>").decode() \
        not in page
    assert "alert(1)" not in page


def _plots_dir(tmp_path, troot):
    plots = tmp_path / "plots"
    plots.mkdir()
    troot.common.dirs.plots = str(plots)
    return plots


def test_launcher_payload_carries_graph_and_plots(tmp_path):
    """The payload carries the workflow's DOT, and the newest PNGs of
    the plots directory within the per-plot byte budget."""
    from veles_tpu_torch.config import root as troot
    from veles_tpu_torch.dummy import DummyWorkflow
    launcher = Launcher()
    launcher.workflow = DummyWorkflow()
    plots = _plots_dir(tmp_path, troot)
    (plots / "err.png").write_bytes(TINY_PNG)
    (plots / "huge.png").write_bytes(
        b"\x89PNG\r\n\x1a\n" + b"0" * (Launcher.PLOT_BYTES_MAX + 1))
    payload = launcher.status_payload("mid/1")
    assert payload["graph"].startswith("digraph")
    assert payload["graph"] == launcher.workflow.generate_graph(
        write_on_disk=False)
    assert list(payload["plots"]) == ["err"]
    assert base64.b64decode(payload["plots"]["err"]) == TINY_PNG
    # Unchanged plots ride no second time.
    assert "plots" not in launcher.status_payload("mid/1")


def test_oversized_plots_do_not_erase_dashboard(tmp_path):
    from veles_tpu_torch.config import root as troot
    from veles_tpu_torch.dummy import DummyWorkflow
    launcher = Launcher()
    launcher.workflow = DummyWorkflow()
    plots = _plots_dir(tmp_path, troot)
    (plots / "good.png").write_bytes(TINY_PNG)
    assert list(launcher.status_payload("m/1")["plots"]) == ["good"]
    (plots / "good.png").unlink()
    (plots / "huge.png").write_bytes(
        b"\x89PNG\r\n\x1a\n" + b"0" * (Launcher.PLOT_BYTES_MAX + 1))
    assert "plots" not in launcher.status_payload("m/2")


def test_pause_and_resume_reach_the_worker(status_server, mnist_data):
    """A master launcher (``listen_address``) with a loopback worker
    thread: its heartbeats list the worker; a ``pause`` queued through
    ``/service`` comes back on a beat and pauses that worker
    (``Server.pause_slave``), a ``resume`` resumes it, and the run then
    ends with every epoch trained."""
    from veles_tpu_torch.client import Client
    from veles_tpu_torch.config import root as troot
    troot.common.net.codec = "none"
    launcher = Launcher(listen_address="127.0.0.1:0",
                        status_address="127.0.0.1:%d" % status_server.port,
                        heartbeat_interval=0.05)
    _port_mnist(launcher)
    launcher.initialize(device="cpu")
    worker_launcher = Launcher()
    worker = _port_mnist(worker_launcher)
    worker_launcher.initialize(device="cpu")
    server = launcher.server
    # Every job waits for the test's word, so the run is still going
    # when the commands arrive.
    gate = threading.Event()
    apply = launcher.workflow.apply_data_from_slave

    def gated_apply(data, slave=None):
        gate.wait(60)
        apply(data, slave)

    launcher.workflow.apply_data_from_slave = gated_apply
    client = Client("127.0.0.1:%d" % server.port, worker,
                    reconnect_attempts=1)
    runner = threading.Thread(target=launcher.run, name="test-master")
    runner.start()
    t = threading.Thread(target=client.run, name="test-client")
    t.start()
    try:
        def listed():
            for mid, info in status_server.status().items():
                if info.get("slaves"):
                    return mid, next(iter(info["slaves"]))
        mid, sid = _poll(listed, 30.0, "the worker in a heartbeat")
        _post(status_server.port, "/service",
              {"master": mid, "command": "pause", "slave": sid})
        _poll(lambda: server.slaves[sid].paused, 30.0, "the pause")
        assert launcher.commands[0] == {"command": "pause", "slave": sid,
                                        "done": "paused"}
        _post(status_server.port, "/service",
              {"master": mid, "command": "resume", "slave": sid})
        _poll(lambda: not server.slaves[sid].paused, 30.0, "the resume")
        assert launcher.commands[1]["done"] == "resumed"
    finally:
        gate.set()
        joined(runner, 120)
        joined(t, 60)
    assert launcher.workflow.decision.epoch_number == MLP["max_epochs"]


def test_stop_command_ends_a_standalone_run(status_server, mnist_data):
    """``stop`` through ``/service`` ends a standalone run early; the
    command is recorded as done."""
    launcher = Launcher(status_address="127.0.0.1:%d" % status_server.port,
                        heartbeat_interval=0.05)
    wf = _port_mnist(launcher)
    wf.decision.max_epochs = 10 ** 6
    launcher.initialize(device="cpu")
    runner = threading.Thread(target=launcher.run, name="test-run")
    runner.start()
    try:
        mid = _poll(lambda: next(iter(status_server.status()), None),
                    30.0, "the first heartbeat")
        _post(status_server.port, "/service",
              {"master": mid, "command": "stop"})
    finally:
        joined(runner, 120)
    assert launcher.commands == [{"command": "stop", "slave": None,
                                  "done": "stopped"}]
    assert wf.decision.epoch_number < 10 ** 6
