"""Lazily-evaluated boolean expressions and attribute linking (the JAX
package's ``mutable``).

``Bool`` builds a small expression DAG over ``&``, ``|``, ``~`` whose
truth value is computed on demand, so a gate condition like
``~decision.complete`` keeps tracking its source after it is
reassigned with ``<<=``.
"""

import operator


class Bool(object):
    """A mutable, lazily-evaluated boolean value.

    >>> a, b = Bool(True), Bool(False)
    >>> c = a & ~b
    >>> bool(c)
    True
    >>> a <<= False       # rebind a's value; c tracks it
    >>> bool(c)
    False
    """

    __slots__ = ("_value", "_op", "_sources", "on_true", "on_false")

    def __init__(self, value=False):
        if isinstance(value, Bool):
            value = bool(value)
        self._value = bool(value)
        self._op = None
        self._sources = ()
        # Optional callbacks fired by <<= on edge transitions.
        self.on_true = None
        self.on_false = None

    def __bool__(self):
        if self._op is None:
            return self._value
        return self._op(*[bool(s) for s in self._sources])

    def __ilshift__(self, value):
        """``b <<= x`` assigns a new value in place, preserving object
        identity so derived expressions keep tracking it."""
        if self._op is not None:
            raise ValueError(
                "cannot assign to a derived Bool expression")
        old = self._value
        self._value = bool(value)
        if self._value and not old and self.on_true is not None:
            self.on_true(self)
        if not self._value and old and self.on_false is not None:
            self.on_false(self)
        return self

    # Operators use module-level named functions so expression nodes
    # pickle (lambdas would not).

    @staticmethod
    def _derived(op, *sources):
        b = Bool()
        b._op = op
        b._sources = tuple(s if isinstance(s, Bool) else Bool(s)
                           for s in sources)
        return b

    def __and__(self, other):
        return Bool._derived(_and, self, other)

    __rand__ = __and__

    def __or__(self, other):
        return Bool._derived(_or, self, other)

    __ror__ = __or__

    def __xor__(self, other):
        return Bool._derived(operator.xor, self, other)

    __rxor__ = __xor__

    def __invert__(self):
        return Bool._derived(operator.not_, self)

    def __repr__(self):
        kind = "derived" if self._op is not None else "value"
        return "<Bool %s %s>" % (kind, bool(self))

    def __getstate__(self):
        # Callbacks are re-attached by their owners after unpickling.
        return {"value": self._value, "op": self._op,
                "sources": self._sources}

    def __setstate__(self, state):
        self._value = state["value"]
        self._op = state["op"]
        self._sources = state["sources"]
        self.on_true = None
        self.on_false = None


def _and(x, y):
    return x and y


def _or(x, y):
    return x or y


class LinkableAttribute(object):
    """Table entry aliasing ``obj.name`` to ``src.src_name``; classes
    that support linking (``Unit``) consult their ``_linked_attrs``
    table in ``__getattr__``/``__setattr__``."""

    __slots__ = ("src", "src_name", "two_way")

    def __init__(self, src, src_name, two_way=False):
        self.src = src
        self.src_name = src_name
        self.two_way = two_way

    def get(self):
        return getattr(self.src, self.src_name)

    def set(self, value):
        setattr(self.src, self.src_name, value)

    def __repr__(self):
        return "<link -> %s.%s>" % (
            getattr(self.src, "name", self.src), self.src_name)
