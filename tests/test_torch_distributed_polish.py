"""The data plane's polish on the port (the JAX package's
``tests/test_distributed_polish.py``): pipelined workers, the respawn
hook, periodic power re-measurement, a master and a worker as two
processes of the command line, the precision levels, and snapshots
coordinated with the jobs in flight.  Every test runs under
``kept_process_state`` (``test_torch_network.py``); the two processes
of the command line run under a deadline after which they are killed
and their output shown.
"""

import itertools
import json
import os
import pickle
import re
import subprocess
import sys
import threading
import time

import pytest

import veles_tpu_torch.prng as tprng
from veles_tpu_torch.client import Client
from veles_tpu_torch.config import root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.server import Server

from test_torch_network import (InstrumentedWorkflow, handshook_channel,
                                joined, kept_process_state, run_client,
                                stopped)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DATASETS = "/nonexistent/veles-datasets"
#: Seconds the two processes of the command line may take.
DEADLINE = 90


@pytest.fixture(autouse=True)
def _process_state():
    with kept_process_state():
        root.common.dirs.datasets = NO_DATASETS
        yield


def _mnist(seed, **kwargs):
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    kwargs.setdefault("max_epochs", 5)
    kwargs.setdefault("learning_rate", 0.1)
    kwargs.setdefault("gradient_moment", 0.5)
    tprng.reset()
    tprng.get(0).seed(seed)
    launcher = Launcher()
    wf = MnistWorkflow(launcher, **kwargs)
    launcher.initialize(device="cpu")
    return wf


def test_async_slave_pipelining_converges():
    """Pipelined workers (job N+1 requested before update N lands) keep
    training correct at a staleness-safe learning rate."""
    kw = dict(gradient_moment=0.0, max_epochs=6, learning_rate=0.03)
    master = _mnist(77, **kw)
    server = Server("127.0.0.1:0", master)
    clients = [Client("127.0.0.1:%d" % server.port, _mnist(77, **kw),
                      async_mode=True, reconnect_attempts=0)
               for _ in range(2)]
    threads = [run_client(c) for c in clients]
    server.wait(timeout=120)
    for t in threads:
        joined(t, 60)
    stopped(server)
    assert bool(master.decision.complete)
    assert master.decision.epoch_number == 6
    assert master.decision.min_validation_err < 0.25
    assert sum(c.jobs_done for c in clients) > 0
    assert master.total_inflight_jobs() == 0


def test_respawn_hook_relaunches_dropped_worker():
    """A worker that dies mid-job is respawned through the hook and the
    run completes."""
    master = InstrumentedWorkflow(Launcher())
    master.job_limit = 4
    respawned = []

    def respawn(desc):
        client = Client("127.0.0.1:%d" % server.port,
                        InstrumentedWorkflow(Launcher()),
                        reconnect_attempts=0)
        respawned.append((desc.mid, client, run_client(client)))

    server = Server("127.0.0.1:0", master, respawn=respawn)
    chan, _ = handshook_channel(server, master)
    chan.send({"cmd": "job_request"})
    assert chan.recv()["cmd"] == "job"
    chan.close()  # crash
    server.wait(timeout=60)
    for _, _, t in respawned:
        joined(t)
    stopped(server)
    assert len(respawned) == 1
    assert master.applied_from_slave == master.job_limit - 1
    assert master.dropped


def test_respawn_gives_up_after_max():
    master = InstrumentedWorkflow(Launcher())
    master.job_limit = 1000000
    calls = []
    server = Server("127.0.0.1:0", master,
                    respawn=lambda desc: calls.append(desc.mid),
                    max_respawns=2)
    try:
        class FakeDesc(object):
            mid = "m"
            id = "m/1"
        for _ in range(5):
            server._maybe_respawn(FakeDesc())
        deadline = time.time() + 10
        while len(calls) < 2 and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(1.0)
        assert len(calls) == 2
    finally:
        stopped(server)


def test_periodic_power_remeasure(monkeypatch):
    """Workers re-measure and report their power; the master's worker
    table follows.  The measurement itself is a timed ``torch.matmul``
    on the worker's device."""
    from veles_tpu_torch import client as tclient
    assert tclient.measure_computing_power(repeats=1, n=64) > 0
    powers = itertools.chain([2.0], itertools.count(8.0))
    monkeypatch.setattr(tclient, "measure_computing_power",
                        lambda *a, **k: next(powers))
    master = InstrumentedWorkflow(Launcher())
    master.job_limit = 4
    server = Server("127.0.0.1:0", master)
    client = Client("127.0.0.1:%d" % server.port,
                    InstrumentedWorkflow(Launcher()), measure_power=True,
                    power_interval=0.0, reconnect_attempts=0)
    seen = []
    orig_apply = server._apply_update

    def spy(desc, data):
        seen.append(desc.power)
        return orig_apply(desc, data)

    server._apply_update = spy
    client.run()
    stopped(server)
    assert client.power > 2.0
    assert any(p > 2.0 for p in seen)


def _cli(tmp_path, name, extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "veles_tpu_torch",
            os.path.join(REPO, "veles_tpu_torch", "znicz", "samples",
                         "mnist.py"),
            "--device", "cpu", "--random-seed", "5", "-v", "info",
            "--result-file", str(tmp_path / (name + ".json")),
            "root.mnist.max_epochs=2",
            "root.common.dirs.datasets=%r" % NO_DATASETS] + extra
    return subprocess.Popen(argv, env=env, cwd=str(tmp_path),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_master_and_worker_processes_of_the_command_line(tmp_path):
    """``-l 127.0.0.1:0`` and ``-m`` as two processes: the master logs
    the port it bound, the worker trains the two epochs, both exit 0
    and the master's results hold the epochs."""
    master = _cli(tmp_path, "master", ["-l", "127.0.0.1:0"])
    procs, lines, port = [master], [], None
    end = time.monotonic() + DEADLINE
    try:
        while port is None and time.monotonic() < end:
            line = master.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"coordinator listening on [\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port, "the master never listened:\n" + "".join(lines)
        procs.append(_cli(tmp_path, "worker",
                          ["-m", "127.0.0.1:%d" % port,
                           "--reconnect-attempts", "0"]))
        outs = []
        for p in procs:
            out = p.communicate(
                timeout=max(1.0, end - time.monotonic()))[0]
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail("the command line's master and worker passed their "
                    "%d s deadline" % DEADLINE)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs[0] = "".join(lines) + outs[0]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    result = json.load(open(str(tmp_path / "master.json")))
    assert result["mode"] == "master"
    assert result["results"]["epochs"] == 2
    assert result["results"]["min_validation_err"] < 0.3


def test_precision_level_1_compensated_accumulation():
    """Level 1 (f32 streams, Kahan epoch sums) over the data plane: the
    worker's block metrics carry the compensated sums and the run
    converges."""
    root.common.engine.precision_level = 1
    root.common.net.job_ticks = 4
    master = _mnist(1234, max_epochs=3)
    server = Server("127.0.0.1:0", master)
    worker = _mnist(1234, max_epochs=3)
    t = run_client(Client("127.0.0.1:%d" % server.port, worker,
                          reconnect_attempts=0))
    server.wait(timeout=120)
    joined(t, 60)
    stopped(server)
    assert "epoch_acc_c" in worker.evaluator.tstate
    assert master.decision.epoch_number == 3
    assert master.gather_results()["min_validation_err"] < 0.15


def test_precision_level_2_highest_matmul():
    root.common.engine.precision_level = 2
    wf = _mnist(1234, max_epochs=2)
    wf.workflow.run()
    assert wf.gather_results()["min_validation_err"] < 0.2


def test_coordinated_snapshot_defers_until_drained(tmp_path):
    """A snapshot asked for while a job is in flight waits until the
    queue drains, and the checkpoint resumes and finishes training."""
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    master = _mnist(77, max_epochs=3)
    snap = SnapshotterToFile(master, directory=str(tmp_path),
                             prefix="coord", time_interval=0.0,
                             compression="")
    snap.initialize()
    job = master.generate_data_for_slave("w1")
    assert master.total_inflight_jobs() == 1
    snap.run()
    assert snap._deferred and snap.destination is None
    worker = _mnist(77, max_epochs=3)
    replies = []
    worker.do_job(job, None, replies.append)
    master.apply_data_from_slave(replies[0], "w1")
    assert master.total_inflight_jobs() == 0
    assert not snap._deferred
    assert snap.destination and os.path.isfile(snap.destination)
    with open(snap.destination, "rb") as fin:
        resumed = pickle.load(fin)
    launcher = Launcher()
    launcher.add_ref(resumed)
    launcher.initialize(device="cpu", snapshot=True)
    resumed.run()
    assert resumed.decision.epoch_number == 3
    assert resumed.gather_results()["min_validation_err"] < 0.2


def test_drop_slave_fires_deferred_snapshot(tmp_path):
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    master = _mnist(5, max_epochs=2)
    snap = SnapshotterToFile(master, directory=str(tmp_path),
                             prefix="dropcoord", time_interval=0.0,
                             compression="")
    snap.initialize()
    master.generate_data_for_slave("w9")
    snap.run()
    assert snap._deferred
    master.drop_slave("w9")
    assert not snap._deferred
    assert snap.destination and os.path.isfile(snap.destination)
    # The dropped job's minibatch went back to the loader's queue and
    # rides the checkpoint.
    assert len(master.loader.failed_minibatches) == 1


def test_sigterm_drains_a_worker_and_the_handler_comes_back():
    """SIGTERM on a worker's launcher drains it: the in-flight job
    finishes, ``bye`` goes out, the master records a retirement, not a
    drop; the handler the launcher replaced is put back after."""
    import signal
    from veles_tpu_torch import resilience
    before = signal.getsignal(signal.SIGTERM)
    master = InstrumentedWorkflow(Launcher())
    master.job_limit = 1000000
    server = Server("127.0.0.1:0", master)
    launcher = Launcher(master_address="127.0.0.1:%d" % server.port,
                        slave_kwargs={"reconnect_attempts": 0})
    slave = InstrumentedWorkflow(launcher)
    launcher.initialize(device="cpu")
    fired = threading.Event()
    orig = slave.do_job

    def do_job(data, update, callback):
        if not fired.is_set():
            fired.set()
            os.kill(os.getpid(), signal.SIGTERM)
        orig(data, update, callback)

    slave.do_job = do_job
    launcher.run()
    # The master retires the worker on its handler thread, after the
    # worker's run has returned.
    deadline = time.monotonic() + 10
    while server.slaves and time.monotonic() < deadline:
        time.sleep(0.01)
    stopped(server)
    assert signal.getsignal(signal.SIGTERM) is before
    assert resilience.stats.get("client.drain") == 1
    assert resilience.stats.get("server.goodbye") == 1
    assert resilience.stats.get("server.drop") == 0
    assert slave.jobs_run >= 1
