"""The serving subsystem of the port: the layer between the HTTP
handlers (:mod:`veles_tpu_torch.restful`) and the device.

* :mod:`~veles_tpu_torch.serving.buckets` — shape-bucketing policy and
  the bounded per-shape cache whose counters ``/stats`` reports;
* :mod:`~veles_tpu_torch.serving.admission` — per-client token-bucket
  rate limiting, queue-depth backpressure (429 + ``Retry-After``), and
  deadline errors;
* :mod:`~veles_tpu_torch.serving.metrics` — queue/batch/latency
  counters behind ``/stats`` and ``/metrics``;
* :mod:`~veles_tpu_torch.serving.engine` — the
  :class:`~veles_tpu_torch.serving.engine.ServingEngine`: a bounded
  request queue and a dedicated device thread, running LM generate
  traffic through decode-step continuous batching on a paged KV block
  pool (f32, bf16, int8 or fp8 planes);
* :mod:`~veles_tpu_torch.serving.speculation` — speculative decoding's
  drafters (n-gram prompt lookup, draft model), the acceptance rule and
  the per-row adaptive draft budget;
* :mod:`~veles_tpu_torch.serving.reload` — artifact verification
  against its sha256 manifest and the watcher behind hot reload.

The serving fabric of the JAX package (replicas, disaggregated prefill,
tenants) is not ported yet.
"""

from .admission import (AdmissionError, DeadlineExceeded,  # noqa: F401,E501
                        EngineStopped, PoolExhausted, QueueFull,
                        RateLimited, RateLimiter, ServiceUnavailable,
                        TokenBucket)
from .buckets import BucketPolicy, CompileCache, next_pow2  # noqa: F401
from .engine import ServingEngine  # noqa: F401
from .metrics import ServingStats, live_serving_summary  # noqa: F401
from .reload import (ArtifactRejected, ArtifactWatcher,  # noqa: F401
                     read_verified, resolve_artifact)
from .speculation import (MAX_SPEC_K, NGramDrafter,  # noqa: F401
                          accept_lengths, check_draft_compat)
