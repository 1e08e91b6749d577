"""Dummy launcher and workflow (the JAX package's ``dummy``): satisfy
the launcher and workflow contracts so a single unit can be built and
run on its own, in tests and micro-benchmarks.

``DummyLauncher.initialize`` takes its device as :class:`Launcher`
does: the CUDA card unless the caller asks for the CPU, and a missing
card raises — there is no automatic choice of device.
"""

from .backends import resolve_device
from .launcher import Launcher
from .workflow import Workflow


class DummyLauncher(Launcher):
    """Standalone-mode launcher that never blocks."""

    def initialize(self, device="cuda", **kwargs):
        self.device = resolve_device(device)
        if self.workflow is not None:
            self.workflow.initialize(device=self.device, **kwargs)
        return self

    def on_workflow_finished(self):
        self._finished.set()


class DummyWorkflow(Workflow):
    """A workflow pre-wired to a DummyLauncher."""

    def __init__(self, **kwargs):
        super(DummyWorkflow, self).__init__(DummyLauncher(), **kwargs)
