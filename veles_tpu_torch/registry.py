"""Class registries (the JAX package's ``registry``): metaclasses that
catalogue every concrete unit subclass and map ``MAPPING`` strings to
classes (forward layers to their gradient-descent units, loaders).

The port keeps registries of its own: importing the JAX package's
classes beside these would make both claim the same ``MAPPING``.
"""

from .error import AlreadyExistsError, NotExistsError


class UnitRegistry(type):
    """Metaclass cataloguing every Unit subclass."""

    units = set()

    def __init__(cls, name, bases, clsdict):
        super(UnitRegistry, cls).__init__(name, bases, clsdict)
        if not clsdict.get("hide_from_registry", False):
            UnitRegistry.units.add(cls)

    @staticmethod
    def find(name):
        for cls in UnitRegistry.units:
            if cls.__name__ == name:
                return cls
        raise NotExistsError("no unit class named %s" % name)


class MappedObjectRegistry(type):
    """Metaclass for string → class factories: concrete metaclass
    subclasses declare ``registry = {}``; classes built with them set
    ``MAPPING = "some-name"``."""

    registry = None

    def __init__(cls, name, bases, clsdict):
        super(MappedObjectRegistry, cls).__init__(name, bases, clsdict)
        mapping = clsdict.get("MAPPING")
        registry = type(cls).registry
        if mapping is None or registry is None:
            return
        if mapping in registry and registry[mapping] is not cls:
            raise AlreadyExistsError(
                "MAPPING %r is already taken by %s" %
                (mapping, registry[mapping]))
        registry[mapping] = cls

    @classmethod
    def get_factory(mcs, mapping):
        if mcs.registry is None or mapping not in mcs.registry:
            raise NotExistsError(
                "no %s registered as %r (have: %s)" %
                (mcs.__name__, mapping,
                 sorted(mcs.registry or ())))
        return mcs.registry[mapping]


class MappedUnitRegistry(UnitRegistry, MappedObjectRegistry):
    """Combined metaclass for unit hierarchies that are also
    string-mapped factories."""
    registry = None
