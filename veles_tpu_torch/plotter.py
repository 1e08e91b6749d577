"""Plotter unit base (the JAX package's ``plotter``).

A plotter captures host-side data when its gate fires and, when
``root.common.graphics.enabled`` allows it and the launcher runs a
graphics server, publishes ``{"kind": "plot", "name", "cls_name",
"data"}`` for viewer processes to draw.  The class goes by name: a
viewer resolves it against its own list of plotter families, so a
payload cannot carry a class.

Subclasses implement ``plot_data() -> dict`` (a host snapshot of the
linked values, read through ``map_read``: a Vector on the card is
copied to the host once, at the gate) and ``render(data, fig)``, a
staticmethod that draws on a matplotlib figure and runs only in the
viewer (``graphics_client``) or the publisher.
"""

from .config import root, get as config_get
from .units import Unit


class Plotter(Unit):
    """Base plotter."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(Plotter, self).__init__(workflow, **kwargs)
        self.view_group = "PLOTTER"
        self.clear_plot = kwargs.get("clear_plot", False)
        self.redraw_plot = kwargs.get("redraw_plot", True)
        self.last_data = None

    @property
    def graphics_server(self):
        launcher = getattr(self.workflow, "launcher", None)
        return getattr(launcher, "graphics_server", None)

    def plot_data(self):
        raise NotImplementedError()

    @staticmethod
    def render(data, fig):
        raise NotImplementedError()

    def run(self):
        # The capture always happens (the publisher reports from
        # last_data); only the live stream is gated on the config.
        self.last_data = self.plot_data()
        if not config_get(root.common.graphics.enabled, True):
            return
        server = self.graphics_server
        if server is not None:
            server.publish({"kind": "plot", "name": self.name,
                            "cls_name": type(self).__name__,
                            "data": self.last_data})
