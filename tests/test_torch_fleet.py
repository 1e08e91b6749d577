"""The elastic fleet on the port (the JAX package's
``tests/test_fleet.py``): the scheduler's membership epochs and
placement policy held to the JAX package's ``FleetScheduler`` on the same
event sequences, preemption as a drain over real sockets, the
``fleet.join`` fault, parole, ``max_inflight=1``, the in-process elastic
walk bit-equal to a fixed fleet, ``wire_mesh_rebuild``, the launcher's
fleet mode (a ``--nodes local`` master that spawns a worker process on
the CPU and respawns it after a SIGKILL) and the command line's
``--nodes`` and ``--blacklist-cooldown``.  The 8→5→8 socket soak is
marked slow, as the JAX package's is.

Every test runs under ``test_torch_network.kept_process_state``: no
thread or listening socket outlives it, and the launcher test fails if
a worker process does.  The scheduler registry starts empty in each
test (garbage from an earlier test on the same worker is collected).
"""

import gc
import os
import signal
import sys
import threading
import time

import numpy
import pytest

import veles_tpu_torch.prng as tprng
from veles_tpu_torch import resilience
from veles_tpu_torch.client import Client
from veles_tpu_torch.config import root
from veles_tpu_torch.fleet import (FleetScheduler, live_fleet_summary,
                                   scheduler, wire_mesh_rebuild)
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.observability import metrics
from veles_tpu_torch.resilience import FaultInjector
from veles_tpu_torch.server import Server, SlaveDescription
from veles_tpu_torch.units import TrivialUnit
from veles_tpu_torch.workflow import Workflow

from test_torch_network import joined, kept_process_state, stopped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "veles_tpu_torch", "znicz", "samples",
                     "mnist.py")
NO_DATASETS = "/nonexistent/veles-datasets"
DELTA_PROTO = {"tensor": True, "delta": True, "codec": "none",
               "dtype": "fp32", "ticks": 1}
#: Seconds the launcher's worker processes may take, all told.
DEADLINE = 120


@pytest.fixture(autouse=True)
def _process_state():
    with kept_process_state():
        root.common.dirs.datasets = NO_DATASETS
        gc.collect()
        scheduler._LIVE_SCHEDULERS.clear()
        yield


class LedgerWorkflow(Workflow):
    """A master/worker workflow whose job ledger proves exactly-once
    accounting: every job id is applied exactly once, across worker
    deaths and requeues (the JAX package's ``test_resilience``
    workflow)."""

    def __init__(self, launcher, total_jobs=6, **kwargs):
        super(LedgerWorkflow, self).__init__(launcher, **kwargs)
        self.body = TrivialUnit(self)
        self.body.link_from(self.start_point)
        self.end_point.link_from(self.body)
        self.total_jobs = total_jobs
        self.next_job = 1
        self.done = {}          # job id -> apply count (must be 1)
        self.outstanding = {}   # slave id -> [job ids in flight]
        self.requeued = []
        self.requeue_log = []
        self.jobs_run = 0       # worker side

    def generate_data_for_slave(self, slave=None):
        if self.requeued:
            n = self.requeued.pop(0)
        elif self.next_job <= self.total_jobs:
            n = self.next_job
            self.next_job += 1
        else:
            return None
        self.outstanding.setdefault(slave, []).append(n)
        return {"n": n}

    def apply_data_from_slave(self, data, slave=None):
        n = data["echo"]
        lst = self.outstanding.get(slave, [])
        if n not in lst:
            return
        lst.remove(n)
        self.done[n] = self.done.get(n, 0) + 1

    def drop_slave(self, slave=None):
        for n in self.outstanding.pop(slave, []):
            self.requeued.append(n)
            self.requeue_log.append(n)

    def should_stop_serving(self):
        return (len(self.done) >= self.total_jobs and
                not self.requeued and
                not any(self.outstanding.values()))

    def do_job(self, data, update, callback):
        self.jobs_run += 1
        callback({"echo": data["n"]})


def _start_client(addr, injector=None, attempts=100, delay=0.02):
    slave = LedgerWorkflow(Launcher())
    client = Client(addr, slave, injector=injector,
                    reconnect_attempts=attempts, reconnect_delay=delay)
    thread = threading.Thread(target=client.run, name="test-client")
    thread.start()
    return client, thread, slave


def _ended(clients_threads):
    for client, thread in clients_threads:
        client.stop()
        joined(thread)


# -- FleetScheduler: membership epochs and placement, vs the JAX package --


#: One event sequence: (op, sid, clean) — a never-joined leave included.
EVENTS = [("join", "w1", None), ("join", "w2", None),
          ("leave", "w1", True), ("leave", "w2", False),
          ("leave", "ghost", False), ("join", "w3", None)]


def _replay(sched):
    out = []
    for op, sid, clean in EVENTS:
        out.append(sched.join(sid, mid="m" + sid) if op == "join" else
                   sched.leave(sid, clean=clean))
    snap = sched.snapshot()
    return out, snap


def test_membership_epoch_numbers_every_event_as_jax():
    """The same joins, drains, drops and a never-joined leave give the
    same epochs, snapshot, counters and gauges as the JAX package's
    scheduler."""
    from veles_tpu.fleet import FleetScheduler as JFleetScheduler
    got, snap = _replay(FleetScheduler())
    want, jsnap = _replay(JFleetScheduler())
    assert got == want == [1, 2, 3, 4, 4, 5]
    assert snap == jsnap
    assert snap["last_event"] == (5, "join", "w3")
    assert resilience.stats.get("fleet.join") == 3
    assert resilience.stats.get("fleet.leave") == 2
    assert resilience.stats.get("fleet.drain") == 1
    assert metrics.registry.peek("membership.epoch").value == 5
    assert metrics.registry.peek("fleet.size").value == 1


def test_live_fleet_summary():
    """Only schedulers that saw an event count; the summary sums them
    and keeps the newest event."""
    assert live_fleet_summary() is None
    quiet = FleetScheduler()
    a, b = FleetScheduler(), FleetScheduler()
    for sid in ("w1", "w2", "w4"):
        a.join(sid)
    b.join("w3")
    b.leave("w3", clean=True)
    summary = live_fleet_summary()
    assert summary == {"schedulers": 2, "epoch": 3, "size": 3,
                       "joins": 4, "leaves": 1, "drains": 1,
                       "last_event": [3, "join", "w4"]}
    assert quiet.epoch == 0


def test_lowest_free_rank_heals_holes_first():
    from veles_tpu.fleet import FleetScheduler as JFleetScheduler
    for world, held in ((4, ()), (4, (0, 2, 3)), (2, (0, 1)),
                        (3, (2,))):
        assert FleetScheduler.lowest_free_rank(world, held) == \
            JFleetScheduler.lowest_free_rank(world, held)
    assert FleetScheduler.lowest_free_rank(4, (0, 2, 3)) == 1
    assert FleetScheduler.lowest_free_rank(2, (0, 1)) is None


def test_pick_affine_and_least_loaded_as_jax():
    """Affinity first (the least recently served), then a fresh
    candidate, then the stalest; least-loaded with stable ties — each
    pick the JAX package's on the same candidates."""
    from veles_tpu.fleet import FleetScheduler as JFleetScheduler
    mems = [{"id": "a", "aff": "w1", "age": 5.0},
            {"id": "b", "aff": "w1", "age": 3.0},
            {"id": "c", "aff": None, "age": 0.0},
            {"id": "d", "aff": "w2", "age": 1.0}]
    busy = [m for m in mems if m["aff"] is not None]

    def aff(m):
        return m["aff"]

    def age(m):
        return m["age"]

    picks = []
    for sched in (FleetScheduler, JFleetScheduler):
        picks.append([
            (sched.pick_affine(c, w, aff, age) or {}).get("id")
            for c, w in ((mems, "w1"), (mems, "w3"), (busy, "w3"),
                         ([], "w1"))])
    assert picks[0] == picks[1] == ["b", "c", "d", None]
    load = {"n1": 2, "n2": 1, "n3": 1}
    assert FleetScheduler.least_loaded(("n1", "n2", "n3"),
                                       load.__getitem__) == "n2"
    assert FleetScheduler.least_loaded((), len) is None


def test_wire_mesh_rebuild_exactly_one_rebuild_per_epoch():
    """Every epoch bump triggers exactly one rebuild stamped with that
    epoch; a stale or repeated epoch is dropped; a rebuild that raises
    is logged and the subscription survives; the default target is
    ``parallel.mesh.rebuild_mesh``, resolved at the call."""
    sched = FleetScheduler()
    calls = []

    def recorder(workflow, epoch=None):
        calls.append((workflow, epoch))

    sentinel = object()
    cb = wire_mesh_rebuild(sched, sentinel, rebuild=recorder)
    sched.join("a")
    sched.join("b")
    sched.leave("a", clean=True)
    sched.leave("b", clean=False)
    assert calls == [(sentinel, 1), (sentinel, 2), (sentinel, 3),
                     (sentinel, 4)]
    cb(2, "join", "late")
    assert len(calls) == 4

    def flaky(workflow, epoch=None):
        calls.append((workflow, epoch))
        if epoch == 5:
            raise RuntimeError("mesh re-form failed")

    sched2 = FleetScheduler()
    wire_mesh_rebuild(sched2, sentinel, rebuild=flaky)
    for sid in ("w0", "w1", "w2", "w3"):
        sched2.join(sid)
    del calls[:]
    sched2.join("w4")
    sched2.leave("w4", clean=True)
    assert [e for _, e in calls] == [5, 6]

    # The default target: a real rebuild of a workflow's mesh, stamped.
    from veles_tpu_torch.parallel import mesh as pmesh
    seen = []
    real = pmesh.rebuild_mesh
    pmesh.rebuild_mesh = lambda wf, epoch=None: seen.append(epoch)
    try:
        sched3 = FleetScheduler()
        wire_mesh_rebuild(sched3, sentinel)
    finally:
        pmesh.rebuild_mesh = real
    sched3.join("x")
    assert seen == [1]


# -- preemption is a drain, not a crash (real sockets) ---------------------


def test_preempt_retires_clean_goodbye_not_drop():
    """``worker.preempt`` chaos: the noticed worker finishes its job,
    ships the update, says bye, and the run completes on the survivor
    — ``server.goodbye``, never ``server.drop``, no requeue, and the
    fleet records the drain.  The survivor dials once the preempted
    worker has left, so the preemption's job number cannot depend on
    how the two share the jobs."""
    master = LedgerWorkflow(Launcher(), total_jobs=8)
    server = Server("127.0.0.1:0", master)
    addr = "127.0.0.1:%d" % server.port
    injector = FaultInjector("worker.preempt@job:2")
    preempted, t1, _ = _start_client(addr, injector=injector)
    joined(t1)
    survivor, t2, _ = _start_client(addr)
    server.wait(timeout=30)
    assert not server.is_running
    _ended([(survivor, t2)])
    stopped(server)
    assert injector.fired == [("worker.preempt", "job", 2)]
    assert len(master.done) == 8
    assert all(v == 1 for v in master.done.values())
    assert not master.requeue_log
    assert preempted._draining
    assert resilience.stats.get("client.preempt") == 1
    assert resilience.stats.get("client.drain") == 1
    assert resilience.stats.get("server.goodbye") >= 1
    assert resilience.stats.get("server.drop") == 0
    assert resilience.stats.get("server.requeue") == 0
    snap = server.fleet.snapshot()
    assert snap["joins"] == 2 and snap["drains"] >= 1


def test_fleet_join_fault_rides_dead_peer_path():
    """``fleet.join`` chaos kills an admission at the membership seam:
    the worker sees a dead peer and redials; exactly one epoch is ever
    minted for it."""
    master = LedgerWorkflow(Launcher(), total_jobs=4)
    injector = FaultInjector("fleet.join@1")
    server = Server("127.0.0.1:0", master, injector=injector)
    client, thread, _ = _start_client("127.0.0.1:%d" % server.port)
    server.wait(timeout=30)
    _ended([(client, thread)])
    stopped(server)
    assert len(master.done) == 4
    assert all(v == 1 for v in master.done.values())
    assert injector.fired == [("fleet.join", "fleet.join", 1)]
    assert server.fleet.snapshot()["joins"] == 1


def test_clean_bye_during_probation_grants_parole():
    """An orderly departure with nothing outstanding clears the
    machine's blacklist entry (parole); a drop, or a bye with work in
    flight, keeps it."""
    master = LedgerWorkflow(Launcher())
    server = Server("127.0.0.1:0", master)
    try:
        desc = SlaveDescription("s1", "mach1", 1.0, ("127.0.0.1", 1))
        desc.probation = True
        with server._lock:
            server._slaves["s1"] = desc
            server._blacklist["mach1"] = time.time()
        server.fleet.join("s1", "mach1")
        server._drop(desc, clean=True)
        assert not desc.probation
        assert "mach1" not in server._blacklist
        assert resilience.stats.get("server.parole") == 1
        assert resilience.stats.get("server.goodbye") == 1
        assert server.fleet.snapshot()["drains"] == 1

        desc2 = SlaveDescription("s2", "mach2", 1.0, ("127.0.0.1", 2))
        desc2.probation = True
        with server._lock:
            server._slaves["s2"] = desc2
            server._blacklist["mach2"] = time.time()
        server.fleet.join("s2", "mach2")
        server._drop(desc2, clean=False)
        assert "mach2" in server._blacklist

        desc3 = SlaveDescription("s3", "mach3", 1.0, ("127.0.0.1", 3))
        desc3.probation = True
        with server._lock:
            server._slaves["s3"] = desc3
            server._blacklist["mach3"] = time.time()
            server._outstanding["s3"] = 1
        server.fleet.join("s3", "mach3")
        server._drop(desc3, clean=True)
        assert "mach3" in server._blacklist
        assert resilience.stats.get("server.requeue") == 1
        assert resilience.stats.get("server.parole") == 1
    finally:
        stopped(server)


def test_max_inflight_serializes_dispatch():
    """``max_inflight=1``: with three eager workers at most one job is
    ever outstanding."""
    master = LedgerWorkflow(Launcher(), total_jobs=12)
    seen = {"max": 0}
    orig = master.generate_data_for_slave

    def probed(slave=None):
        job = orig(slave)
        seen["max"] = max(seen["max"], sum(
            len(v) for v in master.outstanding.values()))
        return job

    # The instance, not a subclass: the handshake vets the checksum.
    master.generate_data_for_slave = probed
    server = Server("127.0.0.1:0", master, max_inflight=1)
    addr = "127.0.0.1:%d" % server.port
    clients = [_start_client(addr)[:2] for _ in range(3)]
    server.wait(timeout=30)
    _ended(clients)
    stopped(server)
    assert len(master.done) == 12
    assert all(v == 1 for v in master.done.values())
    assert seen["max"] == 1


# -- the elastic walk: bit-equal to a fixed fleet --------------------------


def _mnist(seed, **kwargs):
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    kwargs.setdefault("max_epochs", 2)
    kwargs.setdefault("learning_rate", 0.1)
    # Momentum-free: slots stay on the workers by default, so a
    # worker's output depends only on (synced weights, minibatch).
    kwargs.setdefault("gradient_moment", 0.0)
    tprng.reset()
    tprng.get(0).seed(seed)
    launcher = Launcher()
    wf = MnistWorkflow(launcher, **kwargs)
    launcher.initialize(device="cpu")
    return wf


def _final_trainables(master):
    out = {}
    for unit in master.units:
        for attr, vec in (getattr(unit, "trainables", None) or {}).items():
            vec.map_read()
            out["%s/%s" % (unit.name, attr)] = numpy.array(vec.mem)
    return out


def _drive_serialized(master, schedule, proto, max_cycles=6000):
    """One job in flight at a time (``max_inflight=1`` in process):
    ``schedule(k)`` names the worker of the k-th job and may grow or
    shrink the fleet.  Returns each session's first job."""
    first_jobs = {}
    registered = set()
    k = 0
    for _ in range(max_cycles):
        if master.should_stop_serving():
            return first_jobs
        sid, wf = schedule(k)
        if sid not in registered:
            master.note_slave_protocol(sid, proto)
            wf.note_net_proto(proto)
            registered.add(sid)
        job = master.generate_data_for_slave(sid)
        if job is None:
            continue
        first_jobs.setdefault(sid, job)
        replies = []
        wf.do_job(job, None, replies.append)
        master.apply_data_from_slave(replies[0], sid)
        k += 1
    raise AssertionError("dispatch did not converge in %d cycles"
                         % max_cycles)


def test_elastic_walk_matches_fixed_fleet_bit_for_bit():
    """The fleet walks 3→1→3 mid-training — two drains, then two late
    joiners that full-ship — under serialized dispatch, and the final
    trainables equal a fixed single-worker run's bit for bit."""
    ref_worker = _mnist(4242)
    ref_master = _mnist(4242)  # built last, as in every run below
    _drive_serialized(ref_master, lambda k: ("w1", ref_worker),
                      DELTA_PROTO)
    assert ref_master.decision.epoch_number == 2
    ref = _final_trainables(ref_master)

    workers = {"w1": _mnist(4242), "w2": _mnist(4242),
               "w3": _mnist(4242)}
    late = {"w4": _mnist(4242), "w5": _mnist(4242)}
    master = _mnist(4242)
    fleet = FleetScheduler()
    for sid in sorted(workers):
        fleet.join(sid)

    def schedule(k):
        if k == 12:
            for sid in ("w2", "w3"):
                workers.pop(sid)
                fleet.leave(sid, clean=True)
        if k == 20:
            for sid in sorted(late):
                workers[sid] = late[sid]
                fleet.join(sid)
        live = sorted(workers)
        sid = live[k % len(live)]
        return sid, workers[sid]

    first_jobs = _drive_serialized(master, schedule, DELTA_PROTO)
    assert master.decision.epoch_number == 2
    snap = fleet.snapshot()
    assert snap["epoch"] == 7 and snap["drains"] == 2
    pieces = [("F" in p) for p in first_jobs["w4"].values()
              if isinstance(p, dict) and ("F" in p or "D" in p)]
    assert pieces and all(pieces)
    elastic = _final_trainables(master)
    assert set(elastic) == set(ref) and ref
    for key in ref:
        assert ref[key].dtype == elastic[key].dtype
        assert numpy.array_equal(ref[key], elastic[key]), key


def _start_mnist_worker(addr, wf):
    client = Client(addr, wf, reconnect_attempts=300,
                    reconnect_delay=0.05)
    thread = threading.Thread(target=client.run, name="test-client")
    thread.start()
    return client, thread


def _await_retires(n, deadline=30.0):
    """Waits until ``n`` sessions retired (goodbye or drop): ``_drop``
    runs in each handler thread's ``finally``."""
    limit = time.time() + deadline
    while time.time() < limit:
        if resilience.stats.get("server.goodbye") + \
                resilience.stats.get("server.drop") >= n:
            return
        time.sleep(0.01)


@pytest.mark.slow
def test_elastic_soak_8_5_8_socket_bit_parity():
    """An 8-worker MNIST fleet walks 8→5→8 over real sockets — three
    workers drain, three late joiners full-ship — under
    ``max_inflight=1``, and the final weights equal a fixed
    single-worker run's bit for bit; every leave is a goodbye."""
    ref_worker = _mnist(777)
    ref_master = _mnist(777)
    ref_server = Server("127.0.0.1:0", ref_master, max_inflight=1)
    client, thread = _start_mnist_worker(
        "127.0.0.1:%d" % ref_server.port, ref_worker)
    ref_server.wait(timeout=900)
    _ended([(client, thread)])
    stopped(ref_server)
    ref = _final_trainables(ref_master)
    _await_retires(1)

    resilience.reset()
    worker_wfs = [_mnist(777) for _ in range(11)]
    master = _mnist(777)
    applied = {"n": 0}
    orig_apply = master.apply_data_from_slave

    def counting_apply(data, slave=None):
        out = orig_apply(data, slave)
        applied["n"] += 1
        return out

    master.apply_data_from_slave = counting_apply
    server = Server("127.0.0.1:0", master, max_inflight=1)
    addr = "127.0.0.1:%d" % server.port

    def wait_applied(threshold, deadline=600.0):
        limit = time.time() + deadline
        while applied["n"] < threshold and time.time() < limit:
            time.sleep(0.01)
        assert applied["n"] >= threshold

    fleet8 = [_start_mnist_worker(addr, wf) for wf in worker_wfs[:8]]
    wait_applied(12)
    for c, _t in fleet8[:3]:
        c.drain()
    for _c, t in fleet8[:3]:
        joined(t, 120)
    wait_applied(20)
    joiners = [_start_mnist_worker(addr, wf) for wf in worker_wfs[8:]]
    server.wait(timeout=900)
    _ended(fleet8[3:] + joiners)
    _await_retires(11)
    stopped(server)
    assert resilience.stats.get("server.drop") == 0
    assert resilience.stats.get("server.requeue") == 0
    assert resilience.stats.get("server.goodbye") == 11
    assert resilience.stats.get("client.drain") == 3
    snap = server.fleet.snapshot()
    assert snap["joins"] == 11 and snap["drains"] == 11
    assert snap["epoch"] == 22
    assert master.decision.epoch_number == 2
    elastic = _final_trainables(master)
    for key in ref:
        assert numpy.array_equal(ref[key], elastic[key]), key


# -- the launcher's fleet mode and the command line ------------------------


def test_launcher_spawns_and_respawns_a_killed_worker(tmp_path):
    """``Launcher(listen_address, nodes=["local"], worker_argv=...)``
    spawns a worker process of the command line on the CPU; after the
    server applied 3 of its jobs the worker is SIGKILLed — the server
    drops it and requeues its job, the launcher respawns it on the
    least-loaded node, the run completes with every minibatch trained,
    and ``run`` reaps both processes."""
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    argv = [MNIST, "root.common.dirs.datasets=%r" % NO_DATASETS,
            "root.mnist.max_epochs=2", "--device", "cpu",
            "--random-seed", "3", "-v", "warning",
            "--reconnect-attempts", "5"]
    launcher = Launcher(listen_address="127.0.0.1:0", nodes=["local"],
                        worker_argv=argv)
    tprng.get(0).seed(3)
    master = MnistWorkflow(launcher, max_epochs=2)
    applied = {"n": 0}
    orig_apply = master.apply_data_from_slave

    def counting_apply(data, slave=None):
        out = orig_apply(data, slave)
        applied["n"] += 1
        if applied["n"] == 3:
            launcher.worker_processes[0][1].send_signal(signal.SIGKILL)
        return out

    master.apply_data_from_slave = counting_apply
    launcher.initialize(device="cpu")
    timer = threading.Timer(DEADLINE, launcher.stop)
    timer.start()
    try:
        launcher.run()
    finally:
        timer.cancel()
        codes = launcher.reap_workers(timeout=10.0)
    procs = launcher.worker_processes
    assert len(procs) == 2 and [n for n, _ in procs] == ["local"] * 2
    assert codes == [-signal.SIGKILL, 0]
    assert resilience.stats.get("server.drop") == 1
    assert resilience.stats.get("server.respawn") == 1
    assert bool(master.decision.complete)
    assert master.decision.epoch_number == 2
    assert not master.loader.failed_minibatches
    assert master.total_inflight_jobs() == 0
    assert server_epochs(launcher) == [(1, "join"), (2, "drop"),
                                       (3, "join"), (4, "drain")]


def server_epochs(launcher):
    return [(e, kind) for e, kind, _sid in launcher.server.fleet.events]


def test_cli_nodes_build_the_workers_command_line():
    """``-l ... --nodes local,host2`` hands the launcher both nodes and
    the worker's half of the command line (the coordinator's own flags
    left out, ``--device`` kept, ``-m {master}`` last);
    ``--blacklist-cooldown`` sets the server's cooldown key, as the JAX
    command line does."""
    from veles_tpu_torch.__main__ import Main
    main = Main([MNIST, "root.mnist.max_epochs=1", "-l", "0.0.0.0:0",
                 "--nodes", "local, host2", "--device", "cpu",
                 "--random-seed", "5", "--job-ticks", "2",
                 "--net-dtype", "bf16", "--blacklist-cooldown", "7.5",
                 "--reconnect-attempts", "4"])
    main.parse()
    main.apply_subsystem_flags()
    assert root.common.server.blacklist_cooldown == 7.5
    kw = main._launcher_kwargs()
    assert kw["nodes"] == ["local", "host2"]
    assert kw["worker_argv"] == [
        MNIST, "root.mnist.max_epochs=1", "--random-seed", "5",
        "--device", "cpu", "--reconnect-attempts", "4",
        "--net-dtype", "bf16", "-m", "{master}"]
    launcher = Launcher(**kw)
    assert launcher._worker_command("h:1")[:3] == [
        sys.executable, "-m", "veles_tpu_torch"]
    assert launcher._worker_command("h:1")[-2:] == ["-m", "h:1"]
    assert "-l" not in kw["worker_argv"]
    from veles_tpu.__main__ import Main as JMain
    jmain = JMain([MNIST, "-l", "0.0.0.0:0", "--nodes", "local",
                   "--blacklist-cooldown", "7.5"])
    jmain.parse()
    from veles_tpu.config import root as jroot
    jmain.apply_subsystem_flags()
    assert jroot.common.server.blacklist_cooldown == 7.5
