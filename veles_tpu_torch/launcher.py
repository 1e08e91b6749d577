"""Workflow lifecycle for this process (the JAX package's
``launcher``, local mode).

``initialize`` resolves the device — the CUDA card unless the caller
asks for the CPU — and initializes the workflow on it; ``run`` drives
the workflow's graph to completion on this thread; ``stop`` ends it.
Master/worker modes, web-status heartbeats and remote worker spawn
wait for ROADMAP A7/A8: asking for them raises.
"""

import threading
import time

from .backends import resolve_device
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
        self.workflow = None
        self.device = None
        self._running = threading.Event()
        self._finished = threading.Event()
        self._start_time = None

    @property
    def mode(self):
        return "standalone"

    @property
    def is_running(self):
        return self._running.is_set()

    def add_ref(self, workflow):
        self.workflow = workflow
        workflow.workflow = self

    def del_ref(self, workflow):
        if self.workflow is workflow:
            self.workflow = None

    def initialize(self, device="cuda", **kwargs):
        """Resolves ``device`` ("cuda" — the default — or "cpu", a
        ``torch.device`` or a ``backends.Device``; a missing card
        raises) and initializes the workflow on it."""
        self.device = resolve_device(device)
        self.workflow.initialize(device=self.device, **kwargs)
        return self

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
