"""The dataflow unit model (the JAX package's ``units``).

A workflow is a directed graph of units with

  * **control links** — ``dst.link_from(src)``; a unit runs when ALL
    of its incoming links have fired (``open_gate``);
  * **gates** — ``gate_block`` suppresses run and propagation,
    ``gate_skip`` propagates without running; both are lazily
    evaluated :class:`~veles_tpu_torch.mutable.Bool` expressions;
  * **attribute links** — ``dst.link_attrs(src, "weights", ...)``
    aliases data attributes;
  * **demands** — ``self.demand("minibatch_data")`` declares required
    attributes, verified at initialize time.

The host graph driver is a synchronous FIFO work queue owned by the
Workflow; the device work of a training tick happens inside the fused
step (see ``accelerated_units``).
"""

import time

from .distributable import Distributable
from .error import Bug
from .mutable import Bool, LinkableAttribute
from .registry import UnitRegistry

_MUTABLE_TYPES_CACHE = [None]


def _mutable_types():
    """Types that link by reference (both sides see one object)."""
    if _MUTABLE_TYPES_CACHE[0] is None:
        import numpy
        from .memory import Vector
        _MUTABLE_TYPES_CACHE[0] = (Vector, Bool, list, dict, set,
                                   bytearray, numpy.ndarray)
    return _MUTABLE_TYPES_CACHE[0]


class Unit(Distributable, metaclass=UnitRegistry):
    """A node in the workflow graph."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.name = kwargs.get("name", type(self).__name__)
        self.view_group = kwargs.get("view_group", "PLUMBING")
        self._links_from = {}
        self._links_to = {}
        self.gate_block = Bool(False)
        self.gate_skip = Bool(False)
        self._demanded = set()
        self._linked_attrs = {}
        self._workflow = None
        self._is_initialized = False
        self._stopped = False
        self.run_time = 0.0
        self.run_count = 0
        super(Unit, self).__init__(**kwargs)
        if workflow is not None:
            workflow.add_ref(self)

    def init_unpickled(self):
        super(Unit, self).init_unpickled()
        self._gate_visited_ = {}

    # -- identity ----------------------------------------------------------

    @property
    def workflow(self):
        return self._workflow

    @workflow.setter
    def workflow(self, value):
        if self._workflow is not None and value is not None \
                and value is not self._workflow:
            self._workflow.del_ref(self)
        self._workflow = value

    @property
    def is_initialized(self):
        return self._is_initialized

    @property
    def stopped(self):
        """True when this unit or its workflow was stopped."""
        if self._stopped:
            return True
        return self.workflow.stopped if self.workflow is not None else False

    @stopped.setter
    def stopped(self, value):
        self._stopped = bool(value)

    def __repr__(self):
        return '<%s "%s">' % (type(self).__name__, self.name)

    # -- control links -----------------------------------------------------

    @property
    def links_from(self):
        return self._links_from

    @property
    def links_to(self):
        return self._links_to

    def link_from(self, *sources):
        """Adds control dependencies; self runs after ALL sources
        fired."""
        for src in sources:
            self._links_from[src] = True
            src._links_to[self] = True
            self._gate_visited_.setdefault(src, False)
        return self

    def open_gate(self, src):
        """Marks the link from ``src`` as fired; True when every
        incoming link has fired (the visited flags then reset for the
        next loop iteration)."""
        if src not in self._links_from:
            raise Bug("open_gate from non-linked unit %s -> %s" %
                      (src, self))
        self._gate_visited_[src] = True
        if all(self._gate_visited_.get(s, False)
               for s in self._links_from):
            for s in self._links_from:
                self._gate_visited_[s] = False
            return True
        return False

    # -- attribute links ---------------------------------------------------

    def link_attrs(self, other, *args, two_way=False):
        """Aliases attributes from ``other``: each arg is a name (same
        on both sides) or ``(my_name, other_name)``.  Mutable values
        link by reference; immutables through a live
        :class:`LinkableAttribute` entry resolved on access."""
        for arg in args:
            if isinstance(arg, tuple):
                mine, theirs = arg
            else:
                mine = theirs = arg
            value = getattr(other, theirs)
            if isinstance(value, _mutable_types()):
                setattr(self, mine, value)
            else:
                self._linked_attrs[mine] = LinkableAttribute(
                    other, theirs, two_way=two_way)
        return self

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        linked = self.__dict__.get("_linked_attrs")
        if linked and name in linked:
            return linked[name].get()
        raise AttributeError("%r has no attribute %r (demanded: %s)" %
                             (self, name, sorted(self._demanded)
                              if "_demanded" in self.__dict__ else "?"))

    def __getattribute__(self, name):
        if not name.startswith("_"):
            linked = object.__getattribute__(self, "__dict__").get(
                "_linked_attrs")
            if linked is not None and name in linked:
                return linked[name].get()
        return object.__getattribute__(self, name)

    def __setattr__(self, name, value):
        if not name.startswith("_"):
            linked = self.__dict__.get("_linked_attrs")
            if linked is not None and name in linked:
                entry = linked[name]
                if entry.two_way:
                    entry.set(value)
                    return
                # One-way link: a local assignment breaks the link.
                del linked[name]
        object.__setattr__(self, name, value)

    def demand(self, *attrs):
        """Declares required attributes; the workflow retries
        ``initialize`` until they are satisfied."""
        self._demanded.update(attrs)

    def verify_interface(self):
        missing = [a for a in sorted(self._demanded)
                   if not self._has_attr(a)]
        if missing:
            raise AttributeError(
                "%s lacks demanded attribute(s): %s" %
                (self, ", ".join(missing)))

    def _has_attr(self, name):
        if name in self._linked_attrs:
            try:
                self._linked_attrs[name].get()
                return True
            except AttributeError:
                return False
        return hasattr(self, name) and getattr(self, name) is not None

    # -- lifecycle ---------------------------------------------------------

    def initialize(self, **kwargs):
        """Verifies demands; subclasses extend.  May raise
        AttributeError → the workflow requeues this unit."""
        self.verify_interface()
        self._is_initialized = True

    def run(self):
        pass

    def stop(self):
        """Called on workflow stop for units holding external
        resources."""

    # -- execution ---------------------------------------------------------

    def _run_timed(self):
        t0 = time.time()
        try:
            self.run()
        finally:
            self.run_time += time.time() - t0
            self.run_count += 1

    def check_gate_and_run(self, src):
        """The hot-loop body: open the gate, honour the gates, run,
        schedule the dependents."""
        if not self.open_gate(src):
            return
        if self.gate_block:
            return
        if self.stopped:
            self.warning("%s's run() was called after stop() — check "
                         "the control-flow links of workflow %s",
                         self.name, self.workflow)
            return
        if not self.gate_skip:
            if self._is_initialized or self.workflow is None:
                self._run_timed()
            else:
                raise Bug("%s run before initialize" % self)
        self.run_dependent()

    def run_dependent(self):
        """Schedules all downstream units."""
        wf = self.workflow
        for dst in self._links_to:
            if wf is not None:
                wf.schedule(dst, self)
            else:
                dst.check_gate_and_run(self)


class TrivialUnit(Unit):
    """Concrete no-op unit."""

    def run(self):
        pass


class Container(Unit):
    """Marker base for units containing other units."""
    hide_from_registry = True
