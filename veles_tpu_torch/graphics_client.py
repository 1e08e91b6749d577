"""Matplotlib viewer process (the JAX package's ``graphics_client``).

Connects to a :class:`veles_tpu_torch.graphics_server.GraphicsServer`,
receives plot payloads through :func:`safe_loads` — a restricted
unpickler that lets containers and numpy arrays through and nothing
callable, since the stream is not authenticated — renders each with its
plotter family's ``render`` and writes the figure to the output
directory (Agg by default: headless PNG/PDF/SVG; ``--backend WebAgg``
for live browser plotting).

Run: ``python -m veles_tpu_torch.graphics_client host:port [-o DIR]
[--backend Agg] [--format png|pdf|svg]``.
"""

import argparse
import io
import os
import pickle
import sys

from .logger import Logger
from .network_common import connect, recv_message


class RestrictedUnpickler(pickle.Unpickler):
    """Defangs the plot stream: the viewer may sit on an
    unauthenticated socket, and a stock ``pickle.loads`` there is
    arbitrary code execution (the data plane's channels counter the same
    threat with an HMAC).  Only containers, numpy array reconstruction,
    and nothing callable are allowed through."""

    _ALLOWED = {
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy.core.numeric", "_frombuffer"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy._core.numeric", "_frombuffer"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super(RestrictedUnpickler, self).find_class(
                module, name)
        raise pickle.UnpicklingError(
            "plot payloads may not reference %s.%s" % (module, name))


def safe_loads(blob):
    """Unpickles one plot payload with :class:`RestrictedUnpickler`."""
    return RestrictedUnpickler(io.BytesIO(blob)).load()


def _plotter_registry():
    """Name → class for every known plotter family (the viewer-side
    whitelist matching plotter.py's by-name payloads)."""
    from . import plotting_units
    from .plotter import Plotter
    registry = {}
    for name in dir(plotting_units):
        obj = getattr(plotting_units, name)
        if isinstance(obj, type) and issubclass(obj, Plotter):
            registry[obj.__name__] = obj
    return registry


class GraphicsClient(Logger):
    def __init__(self, address, output_dir=None, backend="Agg",
                 fmt="png"):
        super(GraphicsClient, self).__init__()
        import matplotlib
        matplotlib.use(backend)
        self.address = address
        from .config import root, get as config_get
        self.output_dir = output_dir or config_get(
            root.common.dirs.plots,
            os.path.join(os.path.expanduser("~"), ".veles_tpu_torch",
                         "plots"))
        self.fmt = fmt
        self.rendered = 0
        self._sock = None

    def run(self, max_payloads=None):
        """Subscribes and renders until the server goes away (or
        ``max_payloads`` figures were drawn — test hook)."""
        import matplotlib.pyplot as plt
        os.makedirs(self.output_dir, exist_ok=True)
        registry = _plotter_registry()
        self._sock = connect(self.address, timeout=30.0)
        self.info("subscribed to %s; plots -> %s", self.address,
                  self.output_dir)
        while True:
            try:
                payload = recv_message(self._sock,
                                       loads=safe_loads)
            except Exception as e:
                self.warning("rejected malformed payload: %s", e)
                continue
            if payload is None:
                self.info("server closed; rendered %d figures",
                          self.rendered)
                return self.rendered
            if payload.get("kind") != "plot":
                continue
            cls = registry.get(payload.get("cls_name"))
            if cls is None:
                self.warning("unknown plotter family %r",
                             payload.get("cls_name"))
                continue
            try:
                fig = plt.figure(figsize=(8, 6))
                cls.render(payload["data"], fig)
                out = os.path.join(
                    self.output_dir, "%s.%s" %
                    (payload["name"].replace(" ", "_"), self.fmt))
                fig.savefig(out)
                plt.close(fig)
                self.rendered += 1
                self.debug("rendered %s", out)
            except Exception as e:
                self.warning("failed to render %r: %s",
                             payload.get("name"), e)
            if max_payloads is not None and \
                    self.rendered >= max_payloads:
                return self.rendered

    def stop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


def main(argv=None):
    parser = argparse.ArgumentParser(prog="veles_tpu_torch.graphics_client")
    parser.add_argument("address", help="graphics server host:port")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--backend", default="Agg")
    parser.add_argument("--format", default="png",
                        choices=("png", "pdf", "svg"))
    args = parser.parse_args(argv)
    client = GraphicsClient(args.address, output_dir=args.output,
                            backend=args.backend, fmt=args.format)
    try:
        client.run()
    except KeyboardInterrupt:
        client.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
