"""Workflow lifecycle for this process (the JAX package's
``launcher``, local mode).

``initialize`` resolves the device — the CUDA card unless the caller
asks for the CPU — and initializes the workflow on it
(``snapshot=True`` after a resume: the units keep their unpickled
state and put their Vectors on the device); ``run`` drives the
workflow's graph to completion on this thread; ``stop`` ends it;
``resume_latest`` adopts the newest verified snapshot of a directory.
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
        (``snapshot=True`` on a resume) reach every unit."""
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
