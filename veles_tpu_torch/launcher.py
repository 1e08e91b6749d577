"""Workflow lifecycle for this process (the JAX package's
``launcher``, local mode).

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
Master/worker modes, web-status heartbeats and remote worker spawn
wait for ROADMAP A7/A8: asking for them raises.
"""

import threading
import time

from . import resilience
from .backends import resolve_device
from .config import root, get as config_get
from .logger import Logger


class Launcher(Logger):
    """Owns the workflow of this process, in local mode."""

    def __init__(self, **kwargs):
        super(Launcher, self).__init__()
        for key in ("listen_address", "master_address", "nodes",
                    "status_address"):
            if kwargs.get(key):
                raise NotImplementedError(
                    "Launcher(%s=...): master/worker and fleet modes "
                    "are not yet ported (ROADMAP A7)" % key)
        self._mode = kwargs.get("mode", "standalone")
        self.coordinator_address = kwargs.get("coordinator_address")
        self.num_processes = int(kwargs.get("num_processes", 1))
        self.process_id = int(kwargs.get("process_id", 0))
        self.workflow = None
        self.device = None
        self._running = threading.Event()
        self._finished = threading.Event()
        self._start_time = None

    @property
    def mode(self):
        return self._mode

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
        return self

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
        """Runs the workflow to completion on this thread."""
        self._start_time = time.time()
        self._running.set()
        self._finished.clear()
        try:
            self.workflow.run()
            self._finished.wait()
        finally:
            self._running.clear()
            self.workflow.print_stats()

    def on_workflow_finished(self):
        self._finished.set()

    def stop(self):
        if self.workflow is not None and self.workflow.is_running:
            self.workflow.stop()
        self._finished.set()
        self._running.clear()

    @property
    def runtime(self):
        if self._start_time is None:
            return 0.0
        return time.time() - self._start_time
