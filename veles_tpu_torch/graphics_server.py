"""Graphics pub/sub server: live plot streaming to viewer processes
(the JAX package's ``graphics_server``).

Plotter units publish their payloads here; any number of
:mod:`veles_tpu_torch.graphics_client` processes subscribe over plain
TCP with the data plane's length-prefixed frames (``network_common``)
and redraw with matplotlib.  A payload is ``{"kind": "plot", "name",
"cls_name", "data"}`` with plain data: the viewer looks the class up by
name in its own list of plotter families and calls its static
``render(data, fig)``; nothing of the unit graph crosses the wire.

``launch()`` returns the process-wide server (``Launcher.initialize``
starts it when ``root.common.graphics.enabled`` is set), bound to
``root.common.graphics.host``:``port`` (default ``0.0.0.0:0``, any free
port; :attr:`GraphicsServer.port` tells which).
"""

import socket
import threading

from .config import root, get as config_get
from .logger import Logger
from .network_common import send_message, parse_address


class GraphicsServer(Logger):
    """Accepts subscriber connections and broadcasts plot payloads."""

    _instance = None

    def __init__(self, address=None):
        super(GraphicsServer, self).__init__()
        if address is None:
            address = "%s:%d" % (
                config_get(root.common.graphics.host, "0.0.0.0"),
                config_get(root.common.graphics.port, 0))
        host, port = parse_address(address)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(8)
        self._subscribers = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.published = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="veles-graphics-accept")
        self._accept_thread.start()
        self.info("graphics server on port %d", self.port)

    @classmethod
    def launch(cls):
        """The process-wide server, created on first use."""
        if cls._instance is None or cls._instance._stop.is_set():
            cls._instance = cls()
        return cls._instance

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._subscribers.append(conn)
            self.debug("viewer connected from %s", addr)

    def publish(self, payload):
        """Broadcasts one payload; dead subscribers are dropped."""
        with self._lock:
            alive = []
            for conn in self._subscribers:
                try:
                    send_message(conn, payload)
                    alive.append(conn)
                except OSError:
                    try:
                        conn.close()
                    except OSError:
                        pass
            self._subscribers = alive
            self.published += 1

    @property
    def subscriber_count(self):
        with self._lock:
            return len(self._subscribers)

    def stop(self):
        """Closes the listener (shut down first: a bare close does not
        wake the accept), every subscriber, and joins the accept
        thread."""
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            for conn in self._subscribers:
                try:
                    conn.close()
                except OSError:
                    pass
            self._subscribers = []
        self._accept_thread.join(5.0)
        if GraphicsServer._instance is self:
            GraphicsServer._instance = None
