"""Graph-skeleton units (the JAX package's ``plumbing``): the loop
entry, the start and the end of a workflow."""

from .units import TrivialUnit


class Repeater(TrivialUnit):
    """Loop entry point: both the start link and the loop-back link
    feed it, and ANY single incoming fire opens the gate (otherwise
    the first iteration would wait for the loop-back edge forever)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("view_group", "PLUMBING")
        super(Repeater, self).__init__(workflow, **kwargs)

    def open_gate(self, src):
        for s in self._links_from:
            self._gate_visited_[s] = False
        return True


class StartPoint(TrivialUnit):
    """The workflow's entry unit."""


class EndPoint(TrivialUnit):
    """The workflow's exit unit; running it finishes the workflow."""

    def run(self):
        self.workflow.on_workflow_finished()

    def open_gate(self, src):
        # Like Repeater: any path reaching the end point finishes the
        # run — waiting for all branches would deadlock gated ones.
        for s in self._links_from:
            self._gate_visited_[s] = False
        return True
