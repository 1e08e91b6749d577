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

Not yet ported: the serving fabric (replicas, disaggregated prefill,
tenants) and the in-workflow ``RESTfulAPI`` unit.
"""

import base64

import numpy

from .error import Bug
from .export import ExportedModel
from .http_common import JsonHttpServer, JsonRequestHandler
from .resilience import Deadline
from .serving import AdmissionError, RateLimiter, ServingEngine
from .serving.reload import (ArtifactRejected, ArtifactWatcher,
                             read_verified, resolve_artifact)


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
                 spec_max_k=4, spec_draft_blocks=None, device="cuda"):
        if isinstance(model, str):
            model = ExportedModel(model, device=device)
        self.token = token
        self.deadline = deadline
        self.warmup = warmup
        self.engine = ServingEngine(
            model, max_batch=max_batch, queue_depth=queue_depth,
            policy=policy, default_deadline=deadline, paged=paged,
            kv_blocks=kv_blocks, kv_block_size=kv_block_size,
            kv_dtype=kv_dtype, spec=spec, spec_draft=spec_draft,
            spec_max_k=spec_max_k, spec_draft_blocks=spec_draft_blocks,
            drain_timeout=drain_timeout)
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
                    probs = outer.engine.submit_classify(
                        x, deadline=self._deadline(payload))
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
                    full = outer.engine.submit_generate(
                        tokens, max_new, temperature=temperature,
                        seed=seed, deadline=self._deadline(payload))
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

    def reload_artifact(self, path=None, require_manifest=None):
        """Verify-and-reload: ``path`` (default: whatever the watch
        target currently names) is read once, gated through its sha256
        sidecar manifest (and the ``serve.reload_corrupt`` chaos
        point), and hot-swapped into the engine.  Manifests are
        REQUIRED for watcher-driven reloads and optional for explicit
        operator paths.  Returns the new weight version; raises
        :class:`~veles_tpu_torch.serving.reload.ArtifactRejected` and
        keeps the old weights on any verification failure."""
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
        self.engine.start()
        if self.warmup:
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
            self.engine.stop(drain=True, timeout=timeout)
            super(ModelServer, self).stop()
        else:
            super(ModelServer, self).stop()
            self.engine.stop()


def _retry_headers(e):
    if e.retry_after is None:
        return None
    return {"Retry-After": "%d" % max(1, round(e.retry_after))}
