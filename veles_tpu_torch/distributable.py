"""Pickling base class, the unit data lock and the distribution hooks
(the JAX package's ``distributable`` module).

* :class:`SniffedLock` — a lock that logs a suspected deadlock.  The
  JAX package's version also reports every acquisition to a
  lock-order recorder (its ``analysis.runtime`` module); that recorder
  is not ported yet (ROADMAP A8b), so this lock only sniffs.
* :class:`Pickleable` — attributes ending with ``_`` are transient:
  left out of pickles and recreated by ``init_unpickled``.
* :class:`Distributable` — the unit data lock (a deadlock-sniffing
  lock that guards a unit's distributed state against the data plane's
  threads; the workflow takes it around every unit's hook) and the
  default (no-op) hooks of the master/worker contract: what a unit
  ships to a worker, what it folds back from one, and what it requeues
  when a worker is lost.
"""

import logging
import threading

from .logger import Logger

#: Seconds after which a lock acquisition is logged as a suspected
#: deadlock.
DEADLOCK_TIME = 4.0


class SniffedLock(object):
    """A lock whose acquisition sniffs for deadlocks: if it cannot be
    taken within ``deadline`` seconds a warning names the lock, then
    acquisition blocks normally.  High-confusion-cost bugs in a
    threaded server announce themselves instead of hanging
    silently."""

    def __init__(self, name="lock", deadline=DEADLOCK_TIME,
                 logger=None):
        self._lock = threading.Lock()
        self.name = name
        self.deadline = deadline
        self._log = logger or logging.getLogger("SniffedLock")

    def acquire(self, blocking=True, timeout=-1):
        if not blocking or 0 <= timeout <= self.deadline:
            return self._lock.acquire(blocking, timeout)
        if self._lock.acquire(timeout=self.deadline):
            return True
        self._log.warning(
            "possible deadlock: %r not acquired after %.1fs "
            "(holder still running?); continuing to wait",
            self.name, self.deadline)
        if timeout < 0:
            return self._lock.acquire()
        return self._lock.acquire(timeout=timeout - self.deadline)

    def release(self):
        self._lock.release()

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class Pickleable(Logger):
    """Base class whose attributes ending with ``_`` are excluded from
    pickling and recreated by :meth:`init_unpickled`."""

    def __init__(self, **kwargs):
        super(Pickleable, self).__init__(**kwargs)
        self.init_unpickled()

    def init_unpickled(self):
        """Recreates transient (underscore-suffixed) state; called from
        both ``__init__`` and ``__setstate__``."""
        self._logger_ = None  # recreated lazily by Logger.logger

    def __getstate__(self):
        return {key: value for key, value in self.__dict__.items()
                if not key.endswith("_")}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.init_unpickled()


class Distributable(Pickleable):
    """The unit data lock and the default (no-op) hooks of the
    master/worker contract."""

    def __init__(self, **kwargs):
        #: Whether the unit ships state in the handshake (the
        #: workflow's ``generate_initial_data_for_slave``).
        self.negotiates_on_connect = kwargs.get(
            "negotiates_on_connect", False)
        super(Distributable, self).__init__(**kwargs)

    def init_unpickled(self):
        super(Distributable, self).init_unpickled()
        self._data_lock_ = SniffedLock(
            name="%s.data_lock" % type(self).__name__)

    def data_threadsafe(self):
        """The unit's data lock as a context manager: guards the
        generate/apply state against the data plane's threads, with
        deadlock sniffing."""
        return self._data_lock_

    # -- master side ---------------------------------------------------------

    def generate_data_for_slave(self, slave=None):
        """State shipped to a joining or requesting worker."""
        return None

    def apply_data_from_slave(self, data, slave=None):
        """Aggregation point of a worker's result."""

    def drop_slave(self, slave=None):
        """Worker lost: requeue its outstanding work."""

    # -- worker side ---------------------------------------------------------

    def generate_data_for_master(self):
        return None

    def apply_data_from_master(self, data):
        pass
