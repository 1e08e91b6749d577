"""Workflow lifecycle for this process (the JAX package's
``launcher``).

``initialize`` resolves the device — the CUDA card unless the caller
asks for the CPU — and initializes the workflow on it
(``snapshot=True`` after a resume: the units keep their unpickled
state and put their Vectors on the device); ``run`` drives the
workflow's graph to completion on this thread; ``stop`` ends it;
``resume_latest`` adopts the newest verified snapshot of a directory.

The distributed mode (``mode="distributed"`` with
``coordinator_address``, ``num_processes`` and ``process_id`` — the
command line's ``--jax-*`` flags) runs every process as one rank of a
``torch.distributed`` world: ``initialize`` joins it (once per process,
whatever the number of launchers), with NCCL when the device is a CUDA
card — rank ``r`` on card ``r % cards`` — and gloo only for a CPU
device the caller asked for; then it applies data parallelism over the
world's mesh, and ZeRO at ``root.common.engine.zero``'s level.

The data plane's modes: ``listen_address`` makes the process the
coordinator (master) — ``initialize`` starts a
:class:`~veles_tpu_torch.server.Server` over the workflow, and ``run``
waits for it to finish — and ``master_address`` a worker, whose ``run``
is a :class:`~veles_tpu_torch.client.Client`'s job loop (SIGTERM drains
it: the in-flight job finishes, its update ships, ``bye`` goes out).
``chaos`` installs a fault-injection plan process-wide.

The fleet mode: a master given ``nodes`` spawns one worker per node
when it initializes — ``"local"`` (or ``"localhost"``) a
``python -m veles_tpu_torch`` subprocess of this machine, any other
host the same command through ``ssh -o BatchMode=yes`` — running
``worker_argv`` with ``{master}`` replaced by the master's address; a
dropped worker respawns through the same spawner on the node with the
fewest live workers (``Server.respawn``).  The master's ``run`` reaps
its workers when the server stops, and ``stop`` ends them: no worker
process outlives its launcher.  With ``--trace-out`` the master or a
standalone run writes the collected spans as a Chrome trace at the end
of ``run`` (a worker's spans ride the job protocol to its master).

Web-status heartbeats: with ``status_address`` (default
``root.common.web.url``) a master or standalone launcher posts
:meth:`status_payload` to the dashboard's ``/update`` every
``heartbeat_interval`` seconds (``root.common.web.interval``, 5) from
``initialize`` until ``run`` ends, and once more then (the dashboard
shows how the run ended), with ``X-Status-Token`` when
``status_token`` (``root.common.web.token``) is set.  The payload holds
the workflow, mode, runtime and epoch, the decision's error rates and
the rows ``health``, ``slaves``, ``comms``, ``resilience``, ``perf``
(``attribution.perf_summary``), ``serving``, ``fabric``, ``population``
and ``fleet``, the DOT graph on the first beat and every twelfth, and
the newest plot PNGs of ``root.common.dirs.plots`` within
:attr:`Launcher.PLOT_BYTES_MAX` each and :attr:`Launcher.PLOTS_PER_BEAT`
a beat.  The dashboard's reply carries its queued commands:
``pause`` and ``resume`` of one worker (``Server.pause_slave``,
``resume_slave``) and ``stop``; :attr:`Launcher.commands` keeps each
command taken with what it did.  ``root.common.graphics.enabled``
starts the process-wide graphics server at ``initialize``.
"""

import importlib
import json
import os
import subprocess
import sys
import threading
import time

from . import resilience
from .backends import resolve_device
from .config import root, get as config_get
from .logger import Logger


class Launcher(Logger):
    """Owns the workflow of this process."""

    def __init__(self, **kwargs):
        super(Launcher, self).__init__()
        self._mode = kwargs.get("mode", "standalone")
        self.listen_address = kwargs.get("listen_address")
        self.master_address = kwargs.get("master_address")
        if self.listen_address and self._mode == "standalone":
            self._mode = "master"
        if self.master_address and self._mode == "standalone":
            self._mode = "slave"
        self.slave_kwargs = dict(kwargs.get("slave_kwargs") or {})
        # A chaos plan installed process-wide reaches every Channel,
        # Server, Client and Snapshotter without explicit wiring.
        chaos = kwargs.get("chaos")
        if chaos:
            self.injector = resilience.install(chaos)
            self.info("chaos plan installed: %s", chaos)
        else:
            self.injector = kwargs.get("injector")
        self.server = None
        self.client = None
        self.coordinator_address = kwargs.get("coordinator_address")
        self.num_processes = int(kwargs.get("num_processes", 1))
        self.process_id = int(kwargs.get("process_id", 0))
        self.workflow = None
        self.device = None
        self._running = threading.Event()
        self._finished = threading.Event()
        self._start_time = None
        # The fleet mode: worker hosts and the command line they run.
        self.nodes = list(kwargs.get("nodes") or [])
        self.worker_argv = list(kwargs.get("worker_argv") or [])
        # The server's respawn hook fires from its drop threads while
        # the main thread may be spawning or stopping.
        self._procs_lock = threading.Lock()
        self._worker_procs = []  # guarded-by: _procs_lock
        # Web-status heartbeats; the dashboard's queued commands ride
        # each beat's reply.
        self.status_address = kwargs.get(
            "status_address", config_get(root.common.web.url, None))
        self.heartbeat_interval = float(kwargs.get(
            "heartbeat_interval", config_get(root.common.web.interval,
                                             5.0)))
        self.status_token = kwargs.get(
            "status_token", config_get(root.common.web.token, None))
        self.heartbeats = 0
        self.commands = []
        self._heartbeat_thread = None
        self._heartbeat_stop = threading.Event()
        self._graph_dot_ = None
        self._beat_count_ = 0
        self._plots_sent_ = None
        self._plots_cache_ = {}
        self.graphics_server = None

    @property
    def mode(self):
        return self._mode

    @property
    def is_master(self):
        return self._mode == "master" or (
            self._mode == "distributed" and self.process_id == 0)

    @property
    def is_slave(self):
        return self._mode == "slave" or (
            self._mode == "distributed" and self.process_id != 0)

    @property
    def is_running(self):
        return self._running.is_set()

    def add_ref(self, workflow):
        self.workflow = workflow
        workflow.workflow = self

    def del_ref(self, workflow):
        if self.workflow is workflow:
            self.workflow = None

    def resume_latest(self, directory=None, prefix=None,
                      expect_class=None):
        """Crash-resume: loads the newest snapshot named by a
        ``*_current.lnk`` pointer in ``directory`` (default
        ``root.common.dirs.snapshots``), walking back over corrupt,
        unhealthy or unloadable generations, adopts it as this
        launcher's workflow and returns it — or None when there is
        nothing to resume.  ``expect_class`` guards shared directories:
        only a snapshot holding an instance of that class is adopted;
        others are skipped with a warning."""
        directory = directory or config_get(
            root.common.dirs.snapshots, "snapshots")
        from .snapshotter import SnapshotterToFile
        for path in resilience.iter_snapshots(directory, prefix):
            try:
                workflow = SnapshotterToFile.import_(path)
            except Exception as e:
                self.warning("crash-resume: cannot load %s (%s) — "
                             "trying the next snapshot", path, e)
                continue
            if expect_class is not None and \
                    not isinstance(workflow, expect_class):
                self.warning(
                    "crash-resume: skipping %s — it holds a %s, not "
                    "the %s this invocation trains", path,
                    type(workflow).__name__, expect_class.__name__)
                continue
            self.add_ref(workflow)
            resilience.stats.incr("master.resume")
            self.info("crash-resume: adopted snapshot %s (%s)", path,
                      type(workflow).__name__)
            return workflow
        return None

    def initialize(self, device="cuda", **kwargs):
        """Resolves ``device`` ("cuda" — the default — or "cpu", a
        ``torch.device`` or a ``backends.Device``; a missing card
        raises) and initializes the workflow on it; ``kwargs``
        (``snapshot=True`` on a resume) reach every unit.  In the
        distributed mode the process joins the world first and the
        workflow's step goes data-parallel over it afterwards."""
        distributed = self._mode == "distributed"
        if distributed and str(device) == "cuda":
            import torch
            from .backends import CUDADevice
            count = torch.cuda.device_count()
            device = CUDADevice(self.process_id % count) if count else \
                device
        self.device = resolve_device(device)
        if distributed:
            self._join_world()
        self.workflow.initialize(device=self.device, **kwargs)
        if distributed:
            self._apply_data_parallelism()
        if self.is_master and self.listen_address:
            from .server import Server
            self.server = Server(self.listen_address, self.workflow,
                                 on_stopped=self.on_workflow_finished,
                                 injector=self.injector)
        elif self.is_slave and self.master_address:
            from .client import Client
            slave_kwargs = dict(self.slave_kwargs)
            slave_kwargs.setdefault("injector", self.injector)
            self.client = Client(self.master_address, self.workflow,
                                 **slave_kwargs)
        if config_get(root.common.graphics.enabled, False):
            from .graphics_server import GraphicsServer
            self.graphics_server = GraphicsServer.launch()
        if self.status_address and not self.is_slave:
            self._start_heartbeats()
        if self.nodes and self.server is not None:
            self.launch_remote_workers()
            self.server.respawn = lambda desc: \
                self._spawn_worker(self._node_of(desc))
        return self

    # -- the fleet mode: worker spawn ----------------------------------------

    def _master_endpoint(self):
        """The address a remote worker dials: the listen host (this
        machine's name for a wildcard) and the server's port."""
        import socket
        host = self.listen_address.rsplit(":", 1)[0] \
            if ":" in self.listen_address else self.listen_address
        if host in ("", "0.0.0.0", "::"):
            host = socket.getfqdn()
        return "%s:%d" % (host, self.server.port)

    def _worker_command(self, master):
        """``python -m veles_tpu_torch`` with ``worker_argv``,
        ``{master}`` replaced by ``master`` (and ``-m master`` added
        when the argv names no master)."""
        argv = [arg.replace("{master}", master)
                for arg in self.worker_argv]
        if "-m" not in argv and "--master-address" not in argv:
            argv += ["-m", master]
        return [sys.executable, "-m", "veles_tpu_torch"] + argv

    def _spawn_worker(self, node):
        """Starts one worker on ``node``; returns its process."""
        import shlex
        local = node in ("local", "localhost")
        cmd = self._worker_command(
            "127.0.0.1:%d" % self.server.port if local
            else self._master_endpoint())
        env = None
        if local:
            # The child imports this package from where the master
            # did, whatever its working directory.
            parent = os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (parent, env.get("PYTHONPATH")) if p)
        else:
            remote = "cd %s && exec %s" % (
                shlex.quote(os.getcwd()),
                " ".join(shlex.quote(a) for a in cmd))
            cmd = ["ssh", "-o", "BatchMode=yes", node, remote]
        self.info("spawning worker on %s: %s", node, " ".join(cmd))
        with self._procs_lock:
            proc = subprocess.Popen(cmd, env=env)
            self._worker_procs.append((node, proc))
        return proc

    def launch_remote_workers(self):
        for node in self.nodes:
            self._spawn_worker(node)

    def _node_of(self, desc):
        """The node of a dropped worker's respawn: the one with the
        fewest live worker processes (a dead worker's process has
        exited, so its node shows the gap), by
        :meth:`FleetScheduler.least_loaded`."""
        if not self.nodes:
            return "local"
        alive = {node: 0 for node in self.nodes}
        with self._procs_lock:
            procs = list(self._worker_procs)
        for node, proc in procs:
            if proc.poll() is None and node in alive:
                alive[node] += 1
        from .fleet import FleetScheduler
        return FleetScheduler.least_loaded(self.nodes,
                                           lambda n: alive[n])

    @property
    def worker_processes(self):
        """(node, ``subprocess.Popen``) of every worker spawned."""
        with self._procs_lock:
            return list(self._worker_procs)

    def reap_workers(self, timeout=30.0):
        """Waits up to ``timeout`` seconds for the spawned workers to
        exit (they end after the master's last ``bye``), then
        terminates, and at last kills, any that did not; returns their
        exit codes in spawn order."""
        with self._procs_lock:
            procs = list(self._worker_procs)
        end = time.monotonic() + timeout
        for _node, proc in procs:
            try:
                proc.wait(max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.terminate()
        for _node, proc in procs:
            try:
                proc.wait(5.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        return [proc.returncode for _node, proc in procs]

    def _join_world(self):
        """``init_process_group`` for this rank, unless the process is
        in a world already; the backend follows the device (NCCL for a
        CUDA card, gloo for the CPU) and a world of the other backend
        raises."""
        import torch.distributed as dist
        backend = "nccl" if self.device.torch_device.type == "cuda" \
            else "gloo"
        if dist.is_initialized():
            if dist.get_backend() != backend:
                raise RuntimeError(
                    "this process is in a %s world, but a %s device "
                    "needs %s" % (dist.get_backend(),
                                  self.device.torch_device.type, backend))
            return
        address = self.coordinator_address
        if "://" not in address:
            address = "tcp://" + address
        if backend == "nccl":
            import torch
            torch.cuda.set_device(self.device.torch_device)
        dist.init_process_group(backend, init_method=address,
                                world_size=self.num_processes,
                                rank=self.process_id)
        self.info("distributed: rank %d of %d (%s)", self.process_id,
                  self.num_processes, backend)

    def _apply_data_parallelism(self):
        """Data parallelism over the world (the JAX launcher's
        multi-controller SPMD), ZeRO at ``root.common.engine.zero``."""
        if not hasattr(self.workflow, "compiler"):
            self.warning(
                "distributed mode requested but %s has no fused-step "
                "compiler — every process runs the whole workflow "
                "redundantly", type(self.workflow).__name__)
            return
        from .parallel import (make_mesh, apply_dp_sharding,
                               apply_zero_sharding)
        apply_dp_sharding(self.workflow, make_mesh())
        zero = int(config_get(root.common.engine.zero, 0) or 0)
        if zero:
            apply_zero_sharding(self.workflow, self.workflow.mesh,
                                level=zero)

    def run(self):
        """Runs the workflow to completion on this thread: the
        master waits for its server, a worker runs its client's job
        loop, a standalone process runs the graph."""
        self._start_time = time.time()
        self._running.set()
        self._finished.clear()
        try:
            if self.server is not None:
                self.server.wait()
                if self.server.crashed:
                    # A crashed coordinator must not look like a clean
                    # exit (no results file, a nonzero exit code).
                    raise resilience.MasterCrash("master.crash")
                if self.server.failure is not None:
                    raise self.server.failure
            elif self.client is not None:
                from .client import install_sigterm_drain
                previous = install_sigterm_drain(self.client)
                try:
                    self.client.run()
                finally:
                    if previous is not None:
                        import signal
                        signal.signal(signal.SIGTERM, previous)
            else:
                self.workflow.run()
                self._finished.wait()
        finally:
            self._running.clear()
            self.stop_heartbeats()
            if self.server is not None:
                self.server.stop()
                self.server.join(timeout=10.0)
                if self.nodes:
                    self.reap_workers()
                slaves = self.server.all_slaves
                if slaves:
                    self.info("Worker throughput: %s", "; ".join(
                        "%s=%d jobs (%.2f/s)" % (
                            sid, desc.jobs_done, desc.jobs_per_second)
                        for sid, desc in sorted(slaves.items())))
            self.workflow.print_stats()
            self._export_trace()

    def _export_trace(self):
        """Writes the collected spans as Chrome trace-event JSON when
        ``--trace-out`` armed tracing (master or standalone only — a
        worker's spans already rode the job protocol home)."""
        from .observability import tracing
        path = config_get(root.common.observability.trace_out, None)
        if not path or self.is_slave or not tracing.enabled():
            return
        try:
            obj = tracing.export_chrome_trace(path)
        except OSError as e:
            self.warning("cannot write trace %s: %s", path, e)
            return
        self.info("trace -> %s (%d events)", path,
                  len(obj["traceEvents"]))

    def on_workflow_finished(self):
        self._finished.set()

    # -- web-status heartbeats ------------------------------------------------

    def _start_heartbeats(self):
        self._heartbeat_stop.clear()
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="veles-heartbeat")
        self._heartbeat_thread.start()

    def stop_heartbeats(self):
        """Ends the heartbeats and joins their thread (``run`` does at
        its end; a dry run that stops after ``initialize`` calls it)."""
        self._heartbeat_stop.set()
        thread = self._heartbeat_thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(15.0)
        self._heartbeat_thread = None

    def _heartbeat_loop(self):
        """One beat every ``heartbeat_interval`` seconds and a last one
        when the heartbeats stop (the end of ``run``, or ``stop``), so
        the dashboard shows how the run ended."""
        from .network_common import machine_id
        url = self.status_address
        if not url.startswith("http"):
            url = "http://" + url
        url = url.rstrip("/") + "/update"
        mid = "%s/%d" % (machine_id(), os.getpid())
        while True:
            last = self._heartbeat_stop.wait(self.heartbeat_interval)
            self._beat(url, mid)
            if last:
                return

    def _beat(self, url, mid):
        import urllib.request
        from .json_encoders import dumps_json
        try:
            headers = {"Content-Type": "application/json"}
            if self.status_token:
                headers["X-Status-Token"] = self.status_token
            req = urllib.request.Request(
                url, data=dumps_json(self.status_payload(mid)).encode(),
                headers=headers)
            with urllib.request.urlopen(req, timeout=10) as resp:
                reply = json.loads(resp.read())
            self.heartbeats += 1
            for cmd in reply.get("commands", []):
                self._apply_command(cmd)
        except Exception as e:
            self.debug("heartbeat failed: %s", e)

    def status_payload(self, mid):
        """One heartbeat's JSON (see the module's docstring)."""
        wf = self.workflow
        loader = getattr(wf, "loader", None)
        decision = getattr(wf, "decision", None)
        payload = {
            "id": mid,
            "workflow": type(wf).__name__ if wf else None,
            "mode": self.mode,
            "runtime": self.runtime,
            "epoch": getattr(loader, "epoch_number", None),
            "running": self.is_running,
        }
        if decision is not None:
            metrics = {}
            if getattr(decision, "epoch_metrics", None):
                for cls, name in enumerate(("test", "validation",
                                            "train")):
                    v = decision.epoch_metrics[cls]
                    if v is not None:
                        metrics["%s_err" % name] = float(v)
            payload["metrics"] = metrics
        guardian = getattr(wf, "guardian", None)
        if guardian is not None and hasattr(guardian, "health_status"):
            payload["health"] = guardian.health_status()
        if self.server is not None:
            payload["slaves"] = {
                sid: {"state": desc.state,
                      "jobs_done": desc.jobs_done,
                      "jobs_per_s": round(desc.jobs_per_second, 2),
                      "power": desc.power,
                      "blacklisted": desc.blacklisted}
                for sid, desc in self.server.slaves.items()}
        # One snapshot feeds both rows (two would disagree within a
        # beat): net.* is the comms row, device.* rides the perf row.
        events = resilience.stats.snapshot()
        net = {k: v for k, v in events.items() if k.startswith("net.")}
        if net:
            payload["comms"] = net
        events = {k: v for k, v in events.items()
                  if not k.startswith(("net.", "device."))}
        if events:
            payload["resilience"] = events
        for section, provider in self._SUMMARIES:
            try:
                module, name = provider.rsplit(".", 1)
                summary = getattr(importlib.import_module(
                    module, __package__), name)()
            except Exception as e:
                self.debug("%s heartbeat section unavailable: %s",
                           section, e)
                summary = None
            if summary:
                payload[section] = summary
        # The DOT text rides the first beat and every twelfth (the
        # dashboard carries the last one over); plots ride when a PNG
        # changed.
        if wf is not None and self._graph_dot_ is None:
            try:
                self._graph_dot_ = wf.generate_graph(write_on_disk=False)
            except Exception as e:
                self.debug("workflow graph render failed: %s", e)
                self._graph_dot_ = ""
        self._beat_count_ += 1
        if self._graph_dot_ and (self._beat_count_ == 1 or
                                 self._beat_count_ % 12 == 0):
            payload["graph"] = self._graph_dot_
        plots = self._collect_plots()
        if plots is not None:
            payload["plots"] = plots
        return payload

    #: (heartbeat section, provider of its summary) — each provider
    #: returns None when nothing of its kind is live in this process.
    _SUMMARIES = (
        ("perf", ".observability.attribution.perf_summary"),
        ("serving", ".serving.metrics.live_serving_summary"),
        ("fabric", ".serving.fabric.live_fabric_summary"),
        ("population", ".population.master.live_population_summary"),
        ("fleet", ".fleet.live_fleet_summary"),
    )

    #: Per-plot and per-beat byte budgets of the heartbeat's plots.
    PLOT_BYTES_MAX = 256 * 1024
    PLOTS_PER_BEAT = 4

    def _collect_plots(self):
        """Base64 of the newest plot PNGs, or None when nothing changed
        since the last beat (the encodings are cached by path, mtime and
        size)."""
        import base64
        import glob
        plot_dir = config_get(root.common.dirs.plots, None)
        if not plot_dir or not os.path.isdir(plot_dir):
            return None
        entries = []
        for path in glob.glob(os.path.join(plot_dir, "*.png")):
            try:
                st = os.stat(path)
            except OSError:
                continue  # deleted between glob and stat
            # An oversized file never ships, nor counts as sent.
            if st.st_size > self.PLOT_BYTES_MAX:
                continue
            entries.append((st.st_mtime, path, st.st_size))
        entries.sort(reverse=True)
        keys = tuple((p, m, s) for m, p, s in
                     entries[:self.PLOTS_PER_BEAT])
        if keys == self._plots_sent_ or not keys:
            # Unchanged, or nothing eligible: no section, so the
            # dashboard keeps the plots it shows.
            return None
        out = {}
        cache = self._plots_cache_
        for mtime, path, size in entries[:self.PLOTS_PER_BEAT]:
            name = os.path.splitext(os.path.basename(path))[0]
            cached = cache.get(path)
            if cached is not None and cached[0] == (mtime, size):
                out[name] = cached[1]
                continue
            try:
                with open(path, "rb") as fin:
                    blob = base64.b64encode(fin.read()).decode()
            except OSError:
                continue
            cache[path] = ((mtime, size), blob)
            out[name] = blob
        live = {p for _, p, _ in entries}
        for path in [p for p in cache if p not in live]:
            del cache[path]
        self._plots_sent_ = keys
        return out

    def _apply_command(self, cmd):
        """A dashboard command from a heartbeat's reply: ``stop``, or
        ``pause``/``resume`` of the worker ``slave`` of this master.
        Recorded in :attr:`commands` with what it did."""
        name = cmd.get("command")
        sid = cmd.get("slave")
        self.info("dashboard command: %s %s", name, sid or "")
        done = "ignored"
        if name == "stop":
            self.stop()
            done = "stopped"
        elif self.server is not None and sid:
            if name == "pause":
                self.server.pause_slave(sid)
                done = "paused"
            elif name == "resume":
                self.server.resume_slave(sid)
                done = "resumed"
        self.commands.append(dict(cmd, done=done))

    def stop(self):
        self.stop_heartbeats()
        with self._procs_lock:
            procs = list(self._worker_procs)
        for _node, proc in procs:
            if proc.poll() is None:
                proc.terminate()
        if self.server is not None:
            self.server.stop()
        if self.client is not None:
            self.client.stop()
        if self.workflow is not None and self.workflow.is_running:
            self.workflow.stop()
        self._finished.set()
        self._running.clear()
        if procs:
            self.reap_workers(timeout=10.0)

    @property
    def runtime(self):
        if self._start_time is None:
            return 0.0
        return time.time() - self._start_time
