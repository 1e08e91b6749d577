"""Class-scoped logging and the structured event timeline (the JAX
package's ``logger``).

Every framework object mixes in :class:`Logger` and gets a per-class
logger plus ``event()``, which records begin/end/single timeline
records.  :func:`setup_logging` installs the root handler once, with
:class:`ColorFormatter` on a terminal and an optional file copy.  The
records go to the process-wide :class:`EventSink`: a bounded in-memory
ring (what the heartbeat and the publisher read) and, after
:func:`set_event_sink_path`, one JSON line each in a file.
"""

import json
import logging
import os
import sys
import threading
import time

_COLORS = {
    logging.DEBUG: "\033[37m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[1;31m",
}
_RESET = "\033[0m"


class ColorFormatter(logging.Formatter):
    """Colors a record by its level when the standard error is a
    terminal."""

    def format(self, record):
        msg = super(ColorFormatter, self).format(record)
        if sys.stderr.isatty():
            return "%s%s%s" % (_COLORS.get(record.levelno, ""), msg, _RESET)
        return msg


_setup_lock = threading.Lock()
_configured = [False]


def setup_logging(level=logging.INFO, filename=None):
    """Installs the root handler once (later calls only set the level);
    ``filename`` adds a plain copy of every record in that file."""
    with _setup_lock:
        rootlog = logging.getLogger()
        if _configured[0]:
            rootlog.setLevel(level)
            return
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(ColorFormatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        rootlog.addHandler(handler)
        rootlog.setLevel(level)
        if filename:
            fh = logging.FileHandler(filename)
            fh.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname).1s %(name)s: %(message)s"))
            rootlog.addHandler(fh)
        _configured[0] = True


class EventSink(object):
    """The event timeline: ``{"name", "phase" (B/E/I), "ts", "pid",
    "cls", **info}`` records in a ring of ``ring_size`` and, with a
    ``path``, appended to that file as JSON lines."""

    def __init__(self, path=None):
        self._path = path
        self._file = None
        self._lock = threading.Lock()
        self.ring = []
        self.ring_size = 4096

    def emit(self, record):
        with self._lock:
            self.ring.append(record)
            if len(self.ring) > self.ring_size:
                del self.ring[:len(self.ring) - self.ring_size]
            if self._path is not None:
                if self._file is None:
                    os.makedirs(os.path.dirname(self._path) or ".",
                                exist_ok=True)
                    self._file = open(self._path, "a")
                self._file.write(json.dumps(record) + "\n")
                self._file.flush()

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


_sink = EventSink()


def set_event_sink_path(path):
    """Closes the current sink and starts one writing to ``path``
    (None: the ring alone)."""
    global _sink
    _sink.close()
    _sink = EventSink(path)


def get_event_sink():
    return _sink


class Logger(object):
    """Mixin granting ``self.debug/info/warning/error/exception`` and
    ``event``."""

    def __init__(self, **kwargs):
        super(Logger, self).__init__()
        self._logger_ = logging.getLogger(type(self).__name__)

    @property
    def logger(self):
        if not hasattr(self, "_logger_") or self._logger_ is None:
            self._logger_ = logging.getLogger(type(self).__name__)
        return self._logger_

    def debug(self, msg, *args):
        self.logger.debug(msg, *args)

    def info(self, msg, *args):
        self.logger.info(msg, *args)

    def warning(self, msg, *args):
        self.logger.warning(msg, *args)

    def error(self, msg, *args):
        self.logger.error(msg, *args)

    def exception(self, msg="", *args):
        self.logger.exception(msg, *args)

    def event(self, name, etype="single", **info):
        """Records a timeline event; ``etype`` is ``begin``, ``end`` or
        ``single``."""
        phase = {"begin": "B", "end": "E", "single": "I"}[etype]
        rec = {"name": name, "phase": phase, "ts": time.time(),
               "pid": os.getpid(), "cls": type(self).__name__}
        rec.update(info)
        _sink.emit(rec)
