"""Multi-tenant model registry: tenant → artifact + quota.

One engine has hot reload (``swap_weights``/``reload``); this
generalizes the mapping side of that machinery into a REGISTRY the
fabric consults per request: which model artifact serves this tenant,
and is the tenant inside its quota?  Admission is per-tenant
:class:`~veles_tpu_torch.serving.admission.TokenBucket` — the buckets
serve per-client limiting; here they get tenants —
so one tenant's flood drains only its OWN bucket: sibling tenants
keep their full rate (the 429/403 isolation contract, asserted in
``tests/test_torch_fabric.py``).

Refusals map to HTTP exactly like single-engine admission:

* :class:`TenantUnknown` — tenancy is configured and the request
  named no registered tenant (403: retrying cannot help);
* :class:`~veles_tpu_torch.serving.admission.RateLimited` — the tenant's
  bucket is dry (429 + ``Retry-After`` from the bucket's refill
  horizon).

Per-tenant traffic is visible as labeled series on ``/metrics``
(``tenant.requests{tenant=…}`` / ``tenant.rejected{tenant=…}``) and
as the ``tenants`` table in the ``/stats`` fabric section.
"""

import threading
import time

from ..admission import AdmissionError, RateLimited, TokenBucket


class TenantUnknown(AdmissionError):
    """Tenancy is configured and this request named no registered
    tenant — a 403, not a 429: no amount of retrying admits an
    unknown tenant."""

    status = 403


def parse_tenant_spec(spec):
    """``NAME=RATE[:BURST][@ARTIFACT]`` → ``(name, rate, burst,
    artifact)`` — the ``--tenant`` / ``--serve-tenant`` CLI grammar.
    ``RATE`` is requests/second; ``BURST`` defaults to the bucket's
    own default (max(1, rate)); ``ARTIFACT`` is an optional per-
    tenant model path (omitted: the tenant serves the default
    artifact)."""
    spec = str(spec)
    if "=" not in spec:
        raise ValueError(
            "tenant spec %r is not NAME=RATE[:BURST][@ARTIFACT]"
            % spec)
    name, rest = spec.split("=", 1)
    name = name.strip()
    if not name:
        raise ValueError("tenant spec %r has an empty name" % spec)
    artifact = None
    if "@" in rest:
        rest, artifact = rest.split("@", 1)
        artifact = artifact.strip() or None
    burst = None
    if ":" in rest:
        rest, burst = rest.split(":", 1)
        burst = float(burst)
    rate = float(rest)
    return name, rate, burst, artifact


class ModelRegistry(object):
    """Thread-safe tenant table.  HTTP handler threads call
    :meth:`admit` concurrently with operator :meth:`register` /
    :meth:`snapshot` calls; each tenant's bucket serializes on the
    registry lock (admission is a token check, never device work)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants = {}  # guarded-by: _lock
        self.admitted = 0  # guarded-by: _lock
        self.rejected = 0  # guarded-by: _lock

    def register(self, name, rate=None, burst=None, artifact=None):
        """Adds (or replaces) a tenant.  ``rate`` is requests/second
        for the tenant's bucket; None = unmetered (registered for
        artifact mapping/metrics, never 429'd)."""
        name = str(name)
        bucket = None
        if rate is not None:
            bucket = TokenBucket(rate, burst, clock=self._clock)
        with self._lock:
            self._tenants[name] = {
                "bucket": bucket, "rate": rate, "burst": burst,
                "artifact": artifact, "admitted": 0, "rejected": 0}
        return name

    def configured(self):
        """True once any tenant is registered — the switch between
        open access (no tenancy) and 403-on-unknown."""
        with self._lock:
            return bool(self._tenants)

    def tenants(self):
        with self._lock:
            return sorted(self._tenants)

    def __len__(self):
        with self._lock:
            return len(self._tenants)

    def artifact_for(self, name):
        """The tenant's model artifact path, or None (serve the
        default artifact)."""
        with self._lock:
            entry = self._tenants.get(str(name))
            return entry["artifact"] if entry else None

    def admit(self, tenant):
        """Admission for one request from ``tenant`` (None = the
        anonymous tenant, admitted iff a tenant named ``default`` is
        registered or no tenancy is configured).  Returns the
        resolved tenant name; raises :class:`TenantUnknown` (403) or
        :class:`RateLimited` (429 + ``Retry-After``).  Isolation is
        structural: each tenant refills its own bucket, so a flood
        from one tenant never consumes a sibling's tokens."""
        name = "default" if tenant is None else str(tenant)
        with self._lock:
            if not self._tenants:
                return name
            entry = self._tenants.get(name)
            if entry is None:
                self.rejected += 1
                raise TenantUnknown(
                    "tenant %r is not registered" % name)
            bucket = entry["bucket"]
            if bucket is not None and not bucket.try_acquire():
                entry["rejected"] += 1
                self.rejected += 1
                self._tenant_counter("tenant.rejected", name)
                raise RateLimited(
                    "tenant %s over its %g req/s quota" %
                    (name, bucket.rate),
                    retry_after=bucket.retry_after())
            entry["admitted"] += 1
            self.admitted += 1
            self._tenant_counter("tenant.requests", name)
        return name

    @staticmethod
    def _tenant_counter(name, tenant):
        """One labeled tick on the process registry — the
        ``serving.*{tenant=…}``-style per-tenant series ``/metrics``
        scrapes (the NAME stays a call-site literal; only
        the label varies)."""
        from ...observability import metrics
        metrics.registry.counter(name,
                                 labels={"tenant": tenant}).inc()

    def snapshot(self):
        """The ``/stats`` fabric ``tenants`` table: per-tenant quota
        + admitted/rejected tallies."""
        with self._lock:
            tenants = {
                name: {"rate": e["rate"],
                       "admitted": e["admitted"],
                       "rejected": e["rejected"],
                       "artifact": e["artifact"]}
                for name, e in self._tenants.items()}
            return {"tenants": tenants, "admitted": self.admitted,
                    "rejected": self.rejected}
