"""RESTful model serving: :class:`ModelServer`.

The port of ``veles_tpu/restful.py``'s standalone server: an exported
LM artifact served over HTTP through the
:class:`~veles_tpu_torch.serving.ServingEngine`.  HTTP threads only
enqueue into a bounded queue; the engine's device thread coalesces
requests (paged continuous batching for LM artifacts).  Admission
control fronts the queue: per-client token-bucket rate limiting
(``--rate-limit``), 429 + ``Retry-After`` backpressure when the queue
or the KV pool is full, 503 + ``Retry-After`` while draining, and
per-request deadlines that cancel abandoned work.

Endpoints: ``GET /health`` (never touches the device), ``POST /api``
(the LM forward), ``POST /api/generate`` (gated by ``X-Status-Token``
when the server holds a ``token``), ``POST /admin/reload`` (hot weight
reload of a named or the watched artifact; only with a ``token``),
``GET /stats`` and ``GET /metrics`` (Prometheus text).  With
``reload_watch`` an :class:`~veles_tpu_torch.serving.reload
.ArtifactWatcher` hot-swaps every new manifest-verified artifact the
target names.

Two forms, as in the JAX package:

* :class:`ModelServer` — standalone: ``ModelServer(artifact).serve()``
  or ``python -m veles_tpu_torch.serve model.veles.tgz``;
* :class:`RESTfulAPI` — a unit linked after a workflow's decision: when
  training completes it exports the workflow (``export_workflow``) and
  serves the artifact from the same process, on the workflow's device.
  Its knobs arrive as kwargs, with defaults from the ``--serve-*`` flags
  of the command line (:func:`init_parser`, ``root.common.serving``).

The serving fabric (``fabric_replicas``, ``fabric_disagg``,
``tenant``): N engine replicas behind a prefix-affinity
:class:`~veles_tpu_torch.serving.fabric.ReplicaRouter`, each with its
own queue, device thread and KV pool over one shared model, an optional
prefill worker whose KV the decode replicas adopt, and per-tenant
quotas keyed by the ``X-Tenant`` header (403 for an unknown tenant, 429
+ ``Retry-After`` over quota); ``/stats`` gains a ``fabric`` section
and ``/metrics`` the ``fabric.*`` and ``tenant.*`` series.  A fabric
of more than one engine refuses a hot reload (``reload_watch``,
``/admin/reload``: 501) until a reload reaches every engine (ROADMAP
A8b).
"""

import base64
import time

import numpy

from .config import root
from .error import Bug
from .export import KV_DTYPES, ExportedModel, export_workflow
from .http_common import JsonHttpServer, JsonRequestHandler
from .resilience import Deadline
from .serving import AdmissionError, RateLimiter, ServingEngine
from .serving.reload import (ArtifactRejected, ArtifactWatcher,
                             read_verified, resolve_artifact)
from .units import Unit


def init_parser(parser):
    """The serving flags of the in-workflow :class:`RESTfulAPI` unit,
    handed to ``root.common.serving`` by ``__main__``."""
    parser.add_argument(
        "--serve-max-batch", type=int, default=None, metavar="N",
        help="serving: max rows coalesced into one device batch "
             "(default 8)")
    parser.add_argument(
        "--serve-queue-depth", type=int, default=None, metavar="N",
        help="serving: bounded request-queue depth; requests beyond "
             "it get 429 + Retry-After (default 64)")
    parser.add_argument(
        "--serve-rate-limit", type=float, default=None, metavar="R",
        help="serving: per-client token-bucket rate in requests/s "
             "(default: no limit)")
    parser.add_argument(
        "--serve-deadline", type=float, default=None, metavar="SEC",
        help="serving: per-request deadline; expired requests are "
             "cancelled unserved (default 30)")
    parser.add_argument(
        "--serve-token", default=None, metavar="SECRET",
        help="serving: require X-Status-Token on /api/generate")
    parser.add_argument(
        "--serve-warmup", action="store_true",
        help="serving: run the bucket grid once at startup, so the "
             "first request pays no first-call costs")
    parser.add_argument(
        "--serve-kv-blocks", type=int, default=None, metavar="N",
        help="serving: paged KV cache pool size in blocks (default: "
             "sized so max-batch rows can each hold a full-length "
             "sequence)")
    parser.add_argument(
        "--serve-kv-block-size", type=int, default=None, metavar="N",
        help="serving: tokens per paged KV cache block (default 16)")
    parser.add_argument(
        "--serve-kv-dtype", default=None, choices=KV_DTYPES,
        help="serving: paged KV cache storage dtype (default f32); "
             "int8/fp8 quantize per (block, head) with f32 scales")
    parser.add_argument(
        "--serve-weight-dtype", default=None, choices=("f32", "int8"),
        help="serving: decode-matmul weight storage (default f32); "
             "int8 = weight-only quantization with per-output-channel "
             "scales")
    parser.add_argument(
        "--serve-no-paged", action="store_true",
        help="serving: disable paged decode-step batching and fall "
             "back to whole-request generate batching")
    parser.add_argument(
        "--serve-spec", action="store_true",
        help="serving: speculative decoding with the prompt-lookup "
             "(n-gram) drafter; greedy output equals plain paged decode")
    parser.add_argument(
        "--serve-spec-draft", default=None, metavar="PATH",
        help="serving: speculative draft model artifact (same "
             "vocabulary); implies --serve-spec")
    parser.add_argument(
        "--serve-spec-max-k", type=int, default=None, metavar="K",
        help="serving: max draft tokens verified per dispatch "
             "(1..15, default 4)")
    parser.add_argument(
        "--serve-spec-draft-blocks", type=int, default=None,
        metavar="N",
        help="serving: draft-model KV pool size in blocks (default: "
             "the target pool's size)")
    parser.add_argument(
        "--serve-drain-timeout", type=float, default=None,
        metavar="SEC",
        help="serving: graceful-stop budget — admissions close with "
             "503 + Retry-After and live decode rows get this long to "
             "finish (default 30)")
    parser.add_argument(
        "--serve-reload-watch", default=None, metavar="PATH",
        help="serving: hot-reload watch target — a serving artifact or "
             "a snapshotter *_current.lnk pointer; a new "
             "manifest-verified artifact is swapped in without dropping "
             "live streams")
    parser.add_argument(
        "--serve-reload-poll", type=float, default=None, metavar="SEC",
        help="serving: reload-watch poll interval (default 5)")
    parser.add_argument(
        "--serve-fabric-replicas", type=int, default=None, metavar="N",
        help="serving fabric: run N engine replicas behind the "
             "prefix-affinity router (default 1: no fabric)")
    parser.add_argument(
        "--serve-fabric-disagg", action="store_true",
        help="serving fabric: disaggregate prefill from decode — a "
             "dedicated prefill worker fills KV blocks and ships "
             "them to the decode replicas over the tensor wire")
    parser.add_argument(
        "--serve-tenant", action="append", default=None,
        metavar="NAME=RATE[:BURST][@ARTIFACT]",
        help="serving fabric: register a tenant with a token-bucket "
             "quota (repeatable); once any tenant is registered, "
             "requests without a known X-Tenant get 403 and "
             "over-quota tenants get 429 + Retry-After without "
             "shedding siblings")


#: The ``root.common.serving`` keys :class:`RESTfulAPI` takes its
#: defaults from (the JAX package's list).
SERVING_KEYS = ("max_batch", "queue_depth", "rate_limit", "deadline",
                "token", "warmup", "kv_blocks", "kv_block_size",
                "kv_dtype", "paged", "drain_timeout", "reload_watch",
                "reload_poll", "spec", "spec_draft", "spec_max_k",
                "spec_draft_blocks", "fabric_replicas", "fabric_disagg",
                "tenant")


def serving_config_defaults():
    """Serving kwargs from ``root.common.serving`` (set by the
    ``--serve-*`` flags or a config file); explicit unit kwargs win."""
    out = {}
    for key in SERVING_KEYS:
        value = root.common.serving.get(key)
        if value is not None:
            out[key] = value
    return out


def _decode_input(payload, input_shape):
    """Accepts {"input": nested lists} or {"input": base64, "shape":
    [...]} (reference accepted both forms, restful_api.py:137-165)."""
    if "input" not in payload:
        raise Bug("request JSON lacks 'input'")
    raw = payload["input"]
    if isinstance(raw, str):
        blob = base64.b64decode(raw)
        x = numpy.frombuffer(blob, dtype=numpy.float32).copy()
        shape = payload.get("shape")
        if shape:
            x = x.reshape(shape)
    else:
        x = numpy.asarray(raw, dtype=numpy.float32)
    sample = int(numpy.prod(input_shape)) if input_shape else x.size
    if x.ndim == 1 and sample and x.size == sample:
        x = x[None]  # single flat sample
    if x.ndim >= 1 and sample and x.size % sample == 0:
        return x.reshape(-1, sample)
    raise Bug("input of %d elements does not tile %d-element samples"
              % (x.size, sample))


class ModelServer(JsonHttpServer):
    """Serves an exported artifact over HTTP through the serving
    engine (bounded queue, dynamic batching, admission control)."""

    def __init__(self, model, host="0.0.0.0", port=8180, token=None,
                 max_batch=8, queue_depth=64, rate_limit=None,
                 deadline=30.0, warmup=False, policy=None,
                 paged=None, kv_blocks=None, kv_block_size=16,
                 kv_dtype=None, drain_timeout=30.0, reload_watch=None,
                 reload_poll=5.0, spec=False, spec_draft=None,
                 spec_max_k=4, spec_draft_blocks=None, fabric_replicas=1,
                 fabric_disagg=False, tenant=None, device="cuda"):
        if isinstance(model, str):
            model = ExportedModel(model, device=device)
        self.token = token
        self.deadline = deadline
        self.warmup = warmup

        def build_engine():
            # Replicas share the model (its weights and caches) but own
            # their queue, device thread and KV pool.
            return ServingEngine(
                model, max_batch=max_batch, queue_depth=queue_depth,
                policy=policy, default_deadline=deadline, paged=paged,
                kv_blocks=kv_blocks, kv_block_size=kv_block_size,
                kv_dtype=kv_dtype, spec=spec, spec_draft=spec_draft,
                spec_max_k=spec_max_k,
                spec_draft_blocks=spec_draft_blocks,
                drain_timeout=drain_timeout)

        self.engine = build_engine()
        self.fabric = None
        self._fabric_engines = [self.engine]
        fabric_replicas = int(fabric_replicas or 1)
        if fabric_replicas > 1 or fabric_disagg or tenant:
            from .serving.fabric import (ModelRegistry, PrefillWorker,
                                         ReplicaRouter,
                                         parse_tenant_spec)
            registry = None
            if tenant:
                registry = ModelRegistry()
                specs = [tenant] if isinstance(tenant, str) \
                    else list(tenant)
                for entry in specs:
                    name, rate, burst, artifact = \
                        parse_tenant_spec(entry) \
                        if isinstance(entry, str) else entry
                    registry.register(name, rate=rate, burst=burst,
                                      artifact=artifact)
            prefill = PrefillWorker(build_engine()) \
                if fabric_disagg else None
            self.fabric = ReplicaRouter(registry=registry,
                                        prefill=prefill)
            self.fabric.add_replica("r0", self.engine)
            for i in range(1, fabric_replicas):
                engine = build_engine()
                self._fabric_engines.append(engine)
                self.fabric.add_replica("r%d" % i, engine)
        if reload_watch is not None:
            self._refuse_fabric_reload()
        self.limiter = RateLimiter(rate_limit) if rate_limit else None
        self.reload_watch = reload_watch
        self.reload_poll = reload_poll
        self.watcher = None

        class Handler(JsonRequestHandler):
            def do_GET(self):
                outer = self.outer
                if self.path in ("/", "/health"):
                    m = outer.model.manifest
                    self.reply(200, {
                        "status": "ok",
                        "workflow": m.get("workflow"),
                        "units": [u["type"] for u in m["units"]],
                        "input": m["input"], "output": m["output"],
                        "queue_depth":
                            outer.engine.queue_depth_now(),
                    })
                elif self.path == "/stats":
                    self.reply(200, outer.stats_payload())
                elif self.path == "/metrics":
                    from .observability.metrics import CONTENT_TYPE
                    self.reply(200, outer.metrics_text(),
                               CONTENT_TYPE)
                else:
                    self.reply(404, {"error": "not found"})

            def _admit(self):
                """Rate-limit gate; replies 429 and returns False
                when the client's bucket is dry."""
                outer = self.outer
                if outer.limiter is None:
                    return True
                try:
                    outer.limiter.admit(self.client_id())
                    return True
                except AdmissionError as e:
                    outer.engine.stats.incr("rejected.rate_limited")
                    self.reply(e.status, {"error": str(e)},
                               headers=_retry_headers(e))
                    return False

            def _deadline(self, payload):
                """The request's deadline: client-suggested (clamped
                to the server budget) or the server default."""
                budget = self.outer.deadline
                try:
                    want = float(payload.get("deadline", budget))
                except (TypeError, ValueError):
                    want = budget
                if budget is None:
                    return Deadline(want) if want else None
                return Deadline(max(0.0, min(want, budget)))

            def _tenant(self, payload):
                """Tenant identity: the ``X-Tenant`` header wins, else
                ``payload["tenant"]``, else anonymous (the ``default``
                tenant when tenancy is configured)."""
                tenant = self.headers.get("X-Tenant")
                if tenant is None and isinstance(payload, dict):
                    tenant = payload.get("tenant")
                return tenant

            def do_POST(self):
                outer = self.outer
                if self.path == "/api/generate":
                    self._generate()
                    return
                if self.path == "/admin/reload":
                    self._admin_reload()
                    return
                if self.path != "/api":
                    self.reply(404, {"error": "not found"})
                    return
                try:
                    # Read the body BEFORE any early reply — closing
                    # the socket with the request unread resets the
                    # client's connection instead of delivering the
                    # status.
                    payload = self.read_json()
                except Exception as e:
                    self.reply(400, {"error": str(e)})
                    return
                if not self._admit():
                    return
                try:
                    x = _decode_input(
                        payload,
                        outer.model.manifest["input"]["sample_shape"])
                except Exception as e:  # malformed request -> 400
                    outer.warning("bad /api request: %s", e)
                    self.reply(400, {"error": str(e)})
                    return
                try:
                    probs = outer.submit_classify(
                        x, deadline=self._deadline(payload),
                        tenant=self._tenant(payload))
                    flat = probs.reshape(probs.shape[0], -1)
                    self.reply(200, {
                        "output": flat,
                        "labels": numpy.argmax(flat, axis=-1),
                    })
                except AdmissionError as e:  # backpressure/deadline
                    self.reply(e.status, {"error": str(e)},
                               headers=_retry_headers(e))
                except Bug as e:  # client-shaped fault -> 400
                    self.reply(400, {"error": str(e)})
                except Exception:  # server-side fault -> 500
                    outer.exception("/api forward failed")
                    self.reply(500,
                               {"error": "internal server error"})

            def _generate(self):
                """POST /api/generate — KV-cache incremental decoding
                over an LM artifact: {"tokens": [[...]],
                "max_new_tokens": N, "temperature": T, "seed": S} →
                {"tokens": full sequences, "generated": new part}.
                Decode steps of concurrent requests coalesce into
                shape-bucketed batches on the device thread.  When
                the server holds a token, the X-Status-Token header
                must match (the same shared-secret gate web_status
                uses for graphviz rendering — compile-heavy surfaces
                are not left open)."""
                outer = self.outer
                try:
                    # Drain the body before any early reply (see
                    # do_POST).
                    payload = self.read_json()
                except Exception as e:
                    self.reply(400, {"error": str(e)})
                    return
                if outer.token is not None and \
                        not self.check_token(outer.token):
                    self.reply(403, {"error": "bad token"})
                    return
                if not self._admit():
                    return
                try:
                    tokens = numpy.atleast_2d(numpy.asarray(
                        payload["tokens"], dtype=numpy.int32))
                    max_new = int(payload.get("max_new_tokens", 32))
                    cap = outer.engine.policy.new_cap or 4096
                    if not 1 <= max_new <= cap:
                        # Same bound the engine enforces (its
                        # policy.new_cap) — checked here too so the
                        # refusal costs no queue slot.
                        raise Bug("max_new_tokens out of range "
                                  "(1..%d)" % cap)
                    temperature = float(
                        payload.get("temperature", 0.0))
                    seed = int(payload.get("seed", 0))
                except Exception as e:
                    outer.warning("bad /api/generate request: %s", e)
                    self.reply(400, {"error": str(e)})
                    return
                try:
                    full = outer.submit_generate(
                        tokens, max_new, temperature=temperature,
                        seed=seed, deadline=self._deadline(payload),
                        tenant=self._tenant(payload))
                except AdmissionError as e:
                    self.reply(e.status, {"error": str(e)},
                               headers=_retry_headers(e))
                    return
                except Bug as e:
                    # Not-an-LM artifact / over-long request: the
                    # client's problem, with the reason.
                    self.reply(400, {"error": str(e)})
                    return
                except Exception:
                    outer.exception("/api/generate failed")
                    self.reply(500,
                               {"error": "internal server error"})
                    return
                self.reply(200, {
                    "tokens": full,
                    "generated": full[:, tokens.shape[1]:],
                })

            def _admin_reload(self):
                """POST /admin/reload — hot weight reload of a named
                (``{"artifact": path}``) or the watched artifact;
                ``{"draft": true}`` reloads the speculative draft
                model.  AUTHENTICATED: the server must hold a token and
                the X-Status-Token header must match — an open
                endpoint that loads operator-supplied paths would be an
                arbitrary-file primitive, so tokenless servers refuse
                outright."""
                outer = self.outer
                try:
                    payload = self.read_json()
                except Exception as e:
                    self.reply(400, {"error": str(e)})
                    return
                if outer.token is None:
                    self.reply(403, {"error": "reload requires the "
                                              "server to hold a "
                                              "--token"})
                    return
                if not self.check_token(outer.token):
                    self.reply(403, {"error": "bad token"})
                    return
                path = payload.get("artifact")
                try:
                    if payload.get("draft"):
                        version = outer.reload_draft_artifact(path)
                    else:
                        version = outer.reload_artifact(path)
                except ArtifactRejected as e:
                    self.reply(409, {"error": str(e)})
                    return
                except Bug as e:
                    self.reply(501, {"error": str(e)})
                    return
                except AdmissionError as e:
                    self.reply(e.status, {"error": str(e)},
                               headers=_retry_headers(e))
                    return
                except Exception as e:
                    outer.exception("/admin/reload failed")
                    self.reply(500, {"error": str(e)})
                    return
                self.reply(200, {"status": "reloaded",
                                 "weight_version": version})

        super(ModelServer, self).__init__(
            Handler, host=host, port=port,
            thread_name="veles-model-server")

    @property
    def model(self):
        """The CURRENTLY served model — owned by the engine, so a
        drain-and-swap reload is visible to /health and /stats the
        moment it lands."""
        return self.engine.model

    def submit_generate(self, tokens, max_new, temperature=0.0, seed=0,
                        deadline=None, tenant=None):
        """Generate through the fabric when one is configured (tenant
        admission and prefix-affine replica routing), else straight
        into the single engine."""
        if self.fabric is not None:
            return self.fabric.submit_generate(
                tokens, max_new, temperature=temperature, seed=seed,
                deadline=deadline, tenant=tenant)
        return self.engine.submit_generate(
            tokens, max_new, temperature=temperature, seed=seed,
            deadline=deadline)

    def submit_classify(self, x, deadline=None, tenant=None):
        if self.fabric is not None:
            return self.fabric.submit_classify(x, deadline=deadline,
                                               tenant=tenant)
        return self.engine.submit_classify(x, deadline=deadline)

    def reload_artifact(self, path=None, require_manifest=None):
        """Verify-and-reload: ``path`` (default: whatever the watch
        target currently names) is read once, gated through its sha256
        sidecar manifest (and the ``serve.reload_corrupt`` chaos
        point), and hot-swapped into the engine.  Manifests are
        REQUIRED for watcher-driven reloads and optional for explicit
        operator paths.  Returns the new weight version; raises
        :class:`~veles_tpu_torch.serving.reload.ArtifactRejected` and
        keeps the old weights on any verification failure."""
        self._refuse_fabric_reload()
        explicit = path is not None
        if path is None:
            if self.reload_watch is None:
                raise ArtifactRejected(
                    "no artifact named and no --reload-watch target "
                    "configured")
            path = resolve_artifact(self.reload_watch)
            if path is None:
                raise ArtifactRejected(
                    "watch target %s names no serving artifact yet"
                    % self.reload_watch)
        if require_manifest is None:
            require_manifest = not explicit
        blob = read_verified(path, injector=self.engine.injector,
                             require_manifest=require_manifest)
        version = self.engine.reload(blob)
        self.engine.stats.incr("reload.artifacts")
        self.info("hot-reloaded %s -> weight version %d", path,
                  version)
        return version

    def reload_draft_artifact(self, path):
        """Verify-and-reload for the speculative DRAFT model: read once
        through the same sha256-sidecar gate, vocabulary-checked
        against the served model, and hot-swapped into the drafter."""
        self._refuse_fabric_reload()
        if path is None:
            raise ArtifactRejected(
                "a draft reload needs an explicit artifact path")
        blob = read_verified(path, injector=self.engine.injector,
                             require_manifest=False)
        version = self.engine.reload_draft(blob)
        self.engine.stats.incr("spec.draft_artifacts")
        self.info("hot-reloaded draft %s -> draft version %d", path,
                  version)
        return version

    def _refuse_fabric_reload(self):
        """A reload swaps the weights of ``self.engine`` (replica r0)
        alone.  With more replicas or a prefill worker, which share the
        model, the others would go on serving prefix caches and shipping
        KV computed under the old weights at an unchanged weight
        version, and the swap would race their device threads.  Until a
        reload reaches every engine at one step boundary (ROADMAP A8b),
        such a fabric refuses it."""
        if len(self._fabric_engines) > 1 or (
                self.fabric is not None and self.fabric.prefill is not None):
            raise Bug("a hot reload under the serving fabric (%d "
                      "replicas%s) would reach replica r0 alone: "
                      "reloading every engine is not yet ported "
                      "(ROADMAP A8b)" % (
                          len(self._fabric_engines),
                          ", disaggregated prefill"
                          if self.fabric.prefill is not None else ""))

    def _on_watch_change(self, path):
        self.reload_artifact(path, require_manifest=True)

    def stats_payload(self):
        """The /stats body: engine + compile-cache observability."""
        payload = self.engine.stats.snapshot()
        payload["queue_depth"] = self.engine.queue_depth_now()
        payload["max_batch"] = self.engine.max_batch
        payload["weight_version"] = self.engine.weight_version
        cache = getattr(self.model, "compile_cache", None)
        if cache is not None:
            payload["compile_cache"] = cache.stats()
        pool = self.engine.kv_pool
        if pool is not None:
            payload["kv_pool"] = pool.occupancy()
        if self.limiter is not None:
            payload["rate_limit"] = {"rate": self.limiter.rate,
                                     "clients": len(self.limiter)}
        if self.fabric is not None:
            payload["fabric"] = self.fabric.occupancy()
        return payload

    def metrics_text(self):
        """``GET /metrics``: Prometheus text exposition of the
        process registry (chaos.* counters — the resilience shim
        feeds it) plus this engine's serving registry (request/batch
        counters, latency histograms, KV-pool gauges), with the
        derived gauges refreshed at scrape time."""
        from .observability import metrics as obs_metrics
        stats = self.engine.stats
        stats.refresh_gauges()
        stats.set_gauge("queue_depth", self.engine.queue_depth_now())
        pool = self.engine.kv_pool
        if pool is not None:
            occ = pool.occupancy()
            stats.set_gauge("kv_blocks_used", occ["blocks_used"])
            stats.set_gauge("kv_blocks_total", occ["blocks_total"])
        return obs_metrics.render_prometheus(
            [obs_metrics.registry, stats.registry])

    def _spin_up(self):
        for engine in self._fabric_engines:
            engine.start()
        if self.fabric is not None and self.fabric.prefill is not None:
            self.fabric.prefill.engine.start()
        if self.warmup:
            # The replicas share the model: warming the first warms the
            # programs for the whole fabric.
            self.engine.warmup()
        if self.reload_watch is not None and self.watcher is None:
            self.watcher = ArtifactWatcher(
                self.reload_watch, self._on_watch_change,
                poll=self.reload_poll).start()

    def start(self):
        self._spin_up()
        return super(ModelServer, self).start()

    def serve(self):
        self._spin_up()
        self.info("serving model on port %d (POST /api)", self.port)
        super(ModelServer, self).serve()

    def stop(self, drain=False, timeout=None):
        """``drain=True`` is the graceful path: the engine closes
        admissions (503 + Retry-After), live decode rows finish
        within the drain budget, THEN the listener goes down — so
        every in-flight HTTP response is delivered and late arrivals
        get an honest 503 instead of a connection reset."""
        if self.watcher is not None:
            self.watcher.stop()
            self.watcher = None
        if drain:
            if self.fabric is not None:
                self.fabric.stop(drain=True, timeout=timeout)
            else:
                self.engine.stop(drain=True, timeout=timeout)
            super(ModelServer, self).stop()
        else:
            super(ModelServer, self).stop()
            if self.fabric is not None:
                self.fabric.stop(drain=False, timeout=timeout)
            else:
                self.engine.stop()


def _retry_headers(e):
    if e.retry_after is None:
        return None
    return {"Retry-After": "%d" % max(1, round(e.retry_after))}


class RESTfulAPI(Unit):
    """In-workflow serving unit (the JAX package's ``RESTfulAPI``):
    link it after the decision with ``gate_block = ~decision.complete``;
    when training completes it exports the workflow to
    ``artifact_path`` (gzip level 9, as the JAX package's unit does)
    and serves it through :class:`ModelServer` on the workflow's
    device — the CUDA card unless the workflow was initialized on the
    CPU — in a background thread (``blocking=True`` serves on the
    caller's thread instead).  The knobs are the
    ``--serve-*`` flags' (:func:`serving_config_defaults`) or kwargs,
    the serving fabric's (``fabric_replicas``, ``fabric_disagg``,
    ``tenant``) included.
    ``export_seconds`` and ``start_seconds`` (the server's load and
    warmup) are read after ``run``."""

    def __init__(self, workflow, **kwargs):
        super(RESTfulAPI, self).__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        kwargs = dict(serving_config_defaults(), **kwargs)
        self.host = kwargs.get("host", "0.0.0.0")
        self.port = kwargs.get("port", 8180)
        self.artifact_path = kwargs.get("artifact_path",
                                        "served.veles.tgz")
        self.blocking = kwargs.get("blocking", False)
        self.max_batch = kwargs.get("max_batch", 8)
        self.queue_depth = kwargs.get("queue_depth", 64)
        self.rate_limit = kwargs.get("rate_limit", None)
        self.deadline = kwargs.get("deadline", 30.0)
        self.token = kwargs.get("token", None)
        self.warmup = kwargs.get("warmup", False)
        self.paged = kwargs.get("paged", None)
        self.kv_blocks = kwargs.get("kv_blocks", None)
        self.kv_block_size = kwargs.get("kv_block_size", 16)
        self.kv_dtype = kwargs.get("kv_dtype", None)
        self.drain_timeout = kwargs.get("drain_timeout", 30.0)
        self.reload_watch = kwargs.get("reload_watch", None)
        self.reload_poll = kwargs.get("reload_poll", 5.0)
        self.spec = kwargs.get("spec", False)
        self.spec_draft = kwargs.get("spec_draft", None)
        self.spec_max_k = kwargs.get("spec_max_k", 4)
        self.spec_draft_blocks = kwargs.get("spec_draft_blocks", None)
        self.fabric_replicas = kwargs.get("fabric_replicas", 1)
        self.fabric_disagg = kwargs.get("fabric_disagg", False)
        self.tenant = kwargs.get("tenant", None)
        self.device = "cuda"
        self.server = None
        self.export_seconds = None
        self.start_seconds = None

    def init_unpickled(self):
        super(RESTfulAPI, self).init_unpickled()
        self.server = None

    def __getstate__(self):
        state = super(RESTfulAPI, self).__getstate__()
        state["server"] = None
        return state

    def initialize(self, device=None, **kwargs):
        super(RESTfulAPI, self).initialize(**kwargs)
        if device is not None:
            self.device = getattr(device, "name", None) or \
                getattr(device, "type", None) or str(device)

    def run(self):
        if self.server is not None:
            return
        t0 = time.monotonic()
        export_workflow(self.workflow, self.artifact_path)
        self.export_seconds = time.monotonic() - t0
        t0 = time.monotonic()
        self.server = ModelServer(
            self.artifact_path, host=self.host, port=self.port,
            token=self.token, max_batch=self.max_batch,
            queue_depth=self.queue_depth, rate_limit=self.rate_limit,
            deadline=self.deadline, warmup=self.warmup,
            paged=self.paged, kv_blocks=self.kv_blocks,
            kv_block_size=self.kv_block_size, kv_dtype=self.kv_dtype,
            drain_timeout=self.drain_timeout,
            reload_watch=self.reload_watch,
            reload_poll=self.reload_poll, spec=self.spec,
            spec_draft=self.spec_draft, spec_max_k=self.spec_max_k,
            spec_draft_blocks=self.spec_draft_blocks,
            fabric_replicas=self.fabric_replicas,
            fabric_disagg=self.fabric_disagg, tenant=self.tenant,
            device=self.device)
        self.port = self.server.port
        self.info("serving %s on port %d (%s)", self.artifact_path,
                  self.port, self.device)
        if self.blocking:
            self.start_seconds = time.monotonic() - t0
            self.server.serve()
        else:
            self.server.start()
            self.start_seconds = time.monotonic() - t0

    def stop(self, drain=True, timeout=None):
        """Stops the server — by default draining it: admissions close,
        live decode rows finish within the drain budget, then the
        listener goes down."""
        if self.server is not None:
            self.server.stop(drain=drain, timeout=timeout)
            self.server = None
        super(RESTfulAPI, self).stop()
