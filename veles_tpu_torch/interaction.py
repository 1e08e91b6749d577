"""Interactive shell unit (the JAX package's ``interaction``).

:class:`Shell` is a workflow unit that opens a shell wherever it is
linked, so the user can inspect and change live state between ticks:
IPython when importable, the stdlib's ``code`` console otherwise — both
see ``workflow``, ``launcher``, ``units`` (name → unit) and numpy in
their namespace.
``commands=[...]`` executes a scripted list instead of reading stdin
(automation + tests); ``once=True`` drops the shell after its first
firing.
"""

import code

import numpy

from .units import Unit


class Shell(Unit):
    """Embedded interactive shell."""

    def __init__(self, workflow, **kwargs):
        super(Shell, self).__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.commands = kwargs.get("commands")
        self.once = kwargs.get("once", False)
        self.banner = kwargs.get(
            "banner", "veles_tpu_torch shell — `workflow`, `launcher`, "
                      "`units`, `numpy` are in scope; ^D resumes "
                      "the run")
        self._fired = False

    def namespace(self):
        wf = self.workflow
        return {
            "workflow": wf,
            "launcher": getattr(wf, "launcher", None),
            "units": {u.name: u for u in wf.units},
            "numpy": numpy,
        }

    def run(self):
        if self.once and self._fired:
            return
        self._fired = True
        ns = self.namespace()
        if self.commands is not None:
            console = code.InteractiveConsole(ns)
            for command in self.commands:
                console.push(command)
            return
        try:
            from IPython import embed
            embed(user_ns=ns, banner1=self.banner,
                  colors="neutral")
        except ImportError:
            code.interact(banner=self.banner, local=ns)
