"""Meshes of ranks and the parallel styles (the JAX package's
``parallel``): data, tensor, sequence, expert and pipeline parallelism
and ZeRO on ``torch.distributed``."""

from .mesh import (Mesh, P, make_mesh, apply_dp_sharding,  # noqa: F401
                   apply_dp_tp_sharding, apply_dp_tp_sp_sharding,
                   apply_dp_sp_sharding, apply_dp_ep_sharding,
                   apply_dp_pp_sharding, apply_dp_pp_tp_sharding,
                   apply_dp_ep_tp_sharding, apply_zero_sharding,
                   gather_state, rebuild_mesh)
