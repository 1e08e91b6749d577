"""Serving fabric: the tier above one :class:`ServingEngine`.

The port of the JAX package's ``serving.fabric``, which holds no JAX.
Three legs:

* :mod:`~veles_tpu_torch.serving.fabric.router` — a replica router that
  consistent-hashes requests on the prompt-prefix sha1 the
  :class:`~veles_tpu_torch.export.KVBlockPool` already computes, so the
  block-level prefix cache hits across the fleet; replica add/drain
  rides :class:`~veles_tpu_torch.fleet.FleetScheduler` membership epochs,
  and ``scale_hint()`` is the fleet's first load-following signal;
* :mod:`~veles_tpu_torch.serving.fabric.disagg` — prefill/decode
  disaggregation: a prefill worker fills KV blocks and ships them to
  decode replicas as versioned tensors over the zero-copy
  framing;
* :mod:`~veles_tpu_torch.serving.fabric.registry` — the multi-tenant model
  registry: tenant → artifact + quota, per-tenant ``TokenBucket``
  admission with 429/403 isolation.
"""

from .disagg import (KV_WIRE_FMT, PrefillWorker,  # noqa: F401
                     pack_kv_payload, unpack_kv_payload)
from .registry import (ModelRegistry, TenantUnknown,  # noqa: F401
                       parse_tenant_spec)
from .router import (ReplicaHandle, ReplicaRouter,  # noqa: F401
                     live_fabric_summary)
