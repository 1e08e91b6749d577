"""Fleet membership: epoch-numbered join and leave events and the
placement policies every job kind shares (the JAX package's
``fleet``).  See :mod:`veles_tpu_torch.fleet.scheduler`.
"""

from .scheduler import (  # noqa: F401
    FleetScheduler,
    live_fleet_summary,
    wire_mesh_rebuild,
)
