"""Fleet membership: epoch-numbered join and leave events (the JAX
package's ``fleet``, its membership half).  See
:mod:`veles_tpu_torch.fleet.scheduler`.
"""

from .scheduler import FleetScheduler, wire_mesh_rebuild  # noqa: F401
