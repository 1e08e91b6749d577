"""Avatar unit (the JAX package's ``avatar``): clones a declared set
of attributes and Vectors from a source unit on each run, decoupling a
consumer from the producer's mutation cadence (e.g. keep a loader's
minibatch while the loader moves on).  A Vector is cloned through its
host copy (``map_read``), so the clone is the source's data at that
run, on the host.
"""

import copy

import numpy

from .memory import Vector
from .units import Unit


class Avatar(Unit):
    def __init__(self, workflow, **kwargs):
        super(Avatar, self).__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.source = kwargs.get("source")
        self.attrs = list(kwargs.get("attrs", ()))
        self._clones = {}

    def clone_attr(self, name):
        if name not in self.attrs:
            self.attrs.append(name)
        return self

    def initialize(self, **kwargs):
        super(Avatar, self).initialize(**kwargs)
        if self.source is None:
            raise ValueError("%s has no source unit" % self)
        self.run()  # prime the clones so consumers can initialize

    def run(self):
        for name in self.attrs:
            value = getattr(self.source, name)
            if isinstance(value, Vector):
                if not value:
                    continue
                value.map_read()
                mirror = self._clones.get(name)
                if mirror is None:
                    mirror = Vector(numpy.array(value.mem))
                    self._clones[name] = mirror
                    setattr(self, name, mirror)
                else:
                    mirror.mem = numpy.array(value.mem)
            else:
                setattr(self, name, copy.deepcopy(value))
