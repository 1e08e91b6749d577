"""Workflow: the unit-graph container and host-side run driver (the
JAX package's ``workflow``).

It owns the unit set plus StartPoint/EndPoint, initializes units in
dependency order with partial-init requeue, drives a deterministic
FIFO queue of control events from the StartPoint until the EndPoint
runs, and gathers results.  For the data plane it aggregates the
master/worker contract over its units (each under the unit's data
lock), runs a worker's job (``do_job``), keeps the wire protocol each
worker negotiated and the master's weights version.
"""

import collections
import hashlib
import inspect
import threading
import time

from .error import Bug
from .mutable import Bool
from .plumbing import StartPoint, EndPoint
from .result_provider import IResultProvider
from .units import Container


class Workflow(Container):
    """A directed graph of units."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self._units = []
        self._stopped_b = Bool(False)
        self._finished_ = threading.Event()
        self._queue_ = collections.deque()
        self.result_file = kwargs.get("result_file")
        super(Workflow, self).__init__(workflow, **kwargs)
        self.negotiates_on_connect = True
        self.start_point = StartPoint(self)
        self.end_point = EndPoint(self)

    def init_unpickled(self):
        super(Workflow, self).init_unpickled()
        self._finished_ = threading.Event()
        self._queue_ = collections.deque()
        self._run_time_started_ = time.time()
        # The wire protocol, renegotiated per session: the master keys
        # each worker's, a worker holds its session's; units consult
        # them in their distributed hooks.
        self._slave_proto_ = {}
        self._net_proto_ = {}
        self._weights_version_ = 0

    # -- ownership ---------------------------------------------------------

    @property
    def launcher(self):
        """The owning launcher (walks up through parent workflows)."""
        parent = self._workflow
        if parent is None:
            return None
        if isinstance(parent, Workflow):
            return parent.launcher
        return parent

    @property
    def workflow(self):
        return self._workflow

    @workflow.setter
    def workflow(self, value):
        self._workflow = value

    @property
    def is_main(self):
        return not isinstance(self._workflow, Workflow)

    @property
    def units(self):
        return list(self._units)

    @property
    def units_in_dependency_order(self):
        return self._topological_order()

    def add_ref(self, unit):
        """Registers a unit; names are made unique (step-state keys
        depend on it)."""
        if unit is self:
            raise Bug("a workflow cannot contain itself")
        if unit not in self._units:
            taken = {u.name for u in self._units}
            if unit.name in taken:
                i = 1
                while "%s_%d" % (unit.name, i) in taken:
                    i += 1
                unit.name = "%s_%d" % (unit.name, i)
            self._units.append(unit)
        unit.workflow = self

    def del_ref(self, unit):
        if unit in self._units:
            self._units.remove(unit)

    def __getitem__(self, name):
        for unit in self._units:
            if unit.name == name:
                return unit
        raise KeyError(name)

    # -- stopping ----------------------------------------------------------

    @property
    def stopped(self):
        return bool(self._stopped_b)

    @stopped.setter
    def stopped(self, value):
        self._stopped_b <<= value

    @property
    def is_running(self):
        return not self._finished_.is_set()

    # -- initialize --------------------------------------------------------

    def initialize(self, **kwargs):
        """Initializes units in dependency order; units raising
        AttributeError (unmet demands) are requeued until a full pass
        makes no progress."""
        self._is_initialized = True
        pending = self._topological_order()
        for _ in range(len(pending) + 2):
            if not pending:
                break
            retry = []
            errors = {}
            for unit in pending:
                if unit is self:
                    continue
                try:
                    unit.initialize(**kwargs)
                except AttributeError as e:
                    errors[unit] = e
                    retry.append(unit)
            if len(retry) == len(pending):
                details = "; ".join(
                    "%s: %s" % (u.name, e) for u, e in errors.items())
                raise AttributeError(
                    "workflow initialize deadlock — units with unmet "
                    "demands: %s" % details)
            pending = retry
        self.debug("%s initialized (%d units)", self.name,
                   len(self._units))
        return self

    def _topological_order(self):
        """Kahn's algorithm over control links; units left on a cycle
        (the Repeater loop) follow in insertion order."""
        units = list(self._units)
        indeg = {u: 0 for u in units}
        for u in units:
            for dst in u.links_to:
                if dst in indeg:
                    indeg[dst] += 1
        queue = collections.deque(u for u in units if indeg[u] == 0)
        order = []
        seen = set()
        while queue:
            u = queue.popleft()
            if u in seen:
                continue
            seen.add(u)
            order.append(u)
            for dst in u.links_to:
                if dst in indeg:
                    indeg[dst] -= 1
                    if indeg[dst] <= 0 and dst not in seen:
                        queue.append(dst)
        order.extend(u for u in units if u not in seen)
        return order

    # -- run driver --------------------------------------------------------

    def schedule(self, dst, src):
        """Enqueues a (unit, fired-from) control event."""
        self._queue_.append((dst, src))

    def run(self):
        """Runs the graph to completion: StartPoint fires, events are
        drained until the EndPoint runs or the queue empties."""
        self._finished_.clear()
        self.stopped = False
        self._run_time_started_ = time.time()
        self.start_point._run_timed()
        self.start_point.run_dependent()
        while self._queue_ and not self._finished_.is_set():
            dst, src = self._queue_.popleft()
            dst.check_gate_and_run(src)
        if not self._finished_.is_set():
            self.on_workflow_finished()

    def on_workflow_finished(self):
        self._finished_.set()
        self._queue_.clear()
        launcher = self.launcher
        if self.is_main and launcher is not None:
            launcher.on_workflow_finished()

    def stop(self):
        """Requests a stop: loop units observe ``stopped`` and gate
        out."""
        self.stopped = True
        for unit in self._units:
            if unit is not self:
                unit.stop()
        self.on_workflow_finished()

    # -- a worker's job ----------------------------------------------------

    def do_job(self, data, update, callback):
        """Runs one coordinator-issued job on this worker: applies the
        master's data, runs the graph, hands the result back."""
        self.apply_data_from_master(data)
        if update is not None:
            self.apply_update_from_master(update)
        self.run()
        callback(self.generate_data_for_master())

    # -- the distributed contract, aggregated over the units ------------------

    def _members(self):
        return [u for u in self._units if u is not self]

    def generate_data_for_slave(self, slave=None):
        data = {}
        for unit in self._members():
            with unit.data_threadsafe():
                piece = unit.generate_data_for_slave(slave)
            if piece is not None:
                data[unit.name] = piece
        return data

    def generate_initial_data_for_slave(self, slave=None):
        """Handshake-time data of the units that negotiate on
        connect."""
        data = {}
        for unit in self._members():
            if not getattr(unit, "negotiates_on_connect", False):
                continue
            with unit.data_threadsafe():
                piece = unit.generate_data_for_slave(slave)
            if piece is not None:
                data[unit.name] = piece
        return data

    def apply_data_from_slave(self, data, slave=None):
        for unit in self._members():
            if data and unit.name in data:
                with unit.data_threadsafe():
                    unit.apply_data_from_slave(data[unit.name], slave)
        if self.is_main:
            # One version bump per applied worker update (nested
            # workflows defer to the main one).
            self.bump_weights_version()

    def apply_data_from_master(self, data):
        for unit in self._members():
            if data and unit.name in data:
                with unit.data_threadsafe():
                    unit.apply_data_from_master(data[unit.name])

    def apply_update_from_master(self, update):
        self.apply_data_from_master(update)

    def generate_data_for_master(self):
        data = {}
        for unit in self._members():
            piece = unit.generate_data_for_master()
            if piece is not None:
                data[unit.name] = piece
        return data

    def drop_slave(self, slave=None):
        for unit in self._members():
            unit.drop_slave(slave)
        self._slave_proto_.pop(slave, None)

    # -- the negotiated wire protocol --------------------------------------

    def note_slave_protocol(self, slave, proto):
        """Master side: records the protocol negotiated with one worker
        (delta sync, job ticks, wire dtype)."""
        self._slave_proto_[slave] = dict(proto or {})

    def slave_protocol(self, slave):
        """The protocol negotiated with ``slave`` ({} = the legacy
        pickle-compat dialect); nested workflows ask their parent."""
        proto = self._slave_proto_.get(slave)
        if proto is None and isinstance(self._workflow, Workflow):
            return self._workflow.slave_protocol(slave)
        return proto or {}

    def note_net_proto(self, proto):
        """Worker side: records this session's negotiated protocol."""
        self._net_proto_ = dict(proto or {})

    @property
    def net_proto(self):
        """The worker session's negotiated protocol ({} = legacy)."""
        if not self._net_proto_ and isinstance(self._workflow, Workflow):
            return self._workflow.net_proto
        return self._net_proto_

    @property
    def weights_version(self):
        """The master's weights version: one more per applied worker
        update; jobs carry it, so staleness is observable and delta
        bases are verifiable.  Nested workflows read the main one's."""
        if isinstance(self._workflow, Workflow):
            return self._workflow.weights_version
        return self._weights_version_

    def bump_weights_version(self):
        if isinstance(self._workflow, Workflow):
            return self._workflow.bump_weights_version()
        self._weights_version_ += 1
        return self._weights_version_

    # -- introspection -----------------------------------------------------

    def generate_graph(self, filename=None, write_on_disk=True):
        """The control graph as Graphviz DOT text (the start and end
        points as circles); written to ``filename`` when given and
        ``write_on_disk``."""
        lines = ["digraph %s {" % type(self).__name__.replace(" ", "_")]
        ids = {u: "u%d" % i for i, u in enumerate(self._units)}
        for u in self._units:
            shape = "rect"
            if u is self.start_point or u is self.end_point:
                shape = "circle"
            lines.append('  %s [label="%s" shape=%s];' %
                         (ids[u], u.name, shape))
        for u in self._units:
            for dst in u.links_to:
                if dst in ids:
                    lines.append("  %s -> %s;" % (ids[u], ids[dst]))
        lines.append("}")
        text = "\n".join(lines)
        if write_on_disk and filename is not None:
            with open(filename, "w") as fout:
                fout.write(text)
        return text

    def print_stats(self, top_number=5):
        """Logs the top-N units by accumulated run time."""
        stats = sorted(((u.run_time, u) for u in self._units
                        if u is not self),
                       key=lambda p: p[0], reverse=True)
        total = sum(p[0] for p in stats) or 1e-12
        self.info("Run time: %.2fs; top units:",
                  time.time() - self._run_time_started_)
        for rt, u in stats[:top_number]:
            self.info("  %-24s %8.3fs (%4.1f%%, %d runs)",
                      u.name, rt, 100.0 * rt / total, u.run_count)

    def gather_results(self):
        """Collects metrics from IResultProvider units into a dict."""
        results = {}
        for unit in self._units:
            if isinstance(unit, IResultProvider) and unit is not self:
                values = unit.get_metric_values()
                if isinstance(values, dict):
                    results.update(values)
                else:
                    results.update(zip(unit.get_metric_names(), values))
        return results

    @property
    def checksum(self):
        """SHA1 of the defining source file plus the class name."""
        try:
            with open(inspect.getsourcefile(type(self)), "rb") as fin:
                data = fin.read()
        except (TypeError, OSError):
            data = type(self).__name__.encode()
        return hashlib.sha1(data).hexdigest() + "_" + type(self).__name__

    # -- pickling ----------------------------------------------------------

    def __getstate__(self):
        """Pickles exclude the launcher (it holds process state)."""
        state = super(Workflow, self).__getstate__()
        if not isinstance(state.get("_workflow"), Workflow):
            state["_workflow"] = None
        return state
