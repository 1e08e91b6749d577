"""The serving engine: HTTP I/O decoupled from device execution.

The port of ``veles_tpu/serving/engine.py``, which holds no JAX: the
scheduling is the same code, and the device work happens behind the
model's entry points (:class:`veles_tpu_torch.export.ExportedModel`).

One dedicated device thread owns the model; HTTP handler threads only
enqueue.  Two scheduling regimes share the thread:

* **Classify / dense generate** — the device thread drains the
  bounded queue in arrival order, coalescing every compatible waiting
  request into one padded batch: classify requests sharing a sample
  width ride one ``forward``, dense generate requests sharing a
  (prompt-bucket, decode-bucket) pair ride one ``generate_bucketed``
  call with per-request length masking.

* **Paged decode** (models exposing the block-pool surface) —
  Orca-style iteration-level scheduling over a vLLM-style
  :class:`~veles_tpu_torch.export.KVBlockPool`: a request is prefilled
  once (riding the bucketed-chunk ``paged_extend`` program, adopting
  any cached prompt prefix), then its block table joins the
  PERSISTENT decode batch, which advances every active row one token
  per ``paged_step`` call.  Rows join at any token boundary, retire
  the moment their budget is met (freeing their blocks immediately),
  and a straggler no longer holds a whole batch hostage.  Batch and
  table widths round to power-of-two buckets, pad rows carry
  all-trash tables.

Admission is enforced at the door (:mod:`.admission`): a full queue
raises :class:`~veles_tpu_torch.serving.admission.QueueFull`; under
paged decode the binding limit is the BLOCK POOL — a request whose
worst-case block need does not fit on top of what is already
committed raises
:class:`~veles_tpu_torch.serving.admission.PoolExhausted` (both become
429 + ``Retry-After`` at the HTTP layer).  A request whose deadline
expires while queued — or mid-decode — is cancelled without spending
another device millisecond on it.

* **Speculative decoding** (``spec=True``: n-gram prompt-lookup
  drafting; ``spec_draft``: a second exported LM proposing through its
  own pool) — rows holding drafts ride one ``paged_verify`` dispatch of
  K+1 positions; the longest prefix matching the target's own sampled
  stream is accepted, so greedy and sampled output are the plain
  stream's; rejected blocks are rewound at the same boundary.

* **Hot weight reload** (:meth:`ServingEngine.reload`) — a
  same-geometry artifact swaps in place at a decode-step boundary
  (live rows keep their tables, the prefix cache is flushed); another
  geometry drains and swaps the whole model and pool.

The KV storage plane (``kv_dtype``: f32, bf16, int8, fp8) and the weight
mode live behind the model's paged surface; the engine only passes the
plane through and reports it (``quant.kv.<dtype>``, ``kv_bytes_*``).

* **KV export and adoption** (:meth:`ServingEngine.export_kv_prefix`,
  :meth:`ServingEngine.adopt_kv_prefix`) — the halves of the fabric's
  disaggregated prefill: a prompt's cached full blocks leave one pool
  as a float32 host array and enter another, both on the device
  thread's op queue, refused across weight versions.
"""

import collections
import threading
import time

import numpy

from .. import resilience
from ..distributable import SniffedLock
from ..error import Bug
from ..logger import Logger
from ..resilience import Deadline
from .admission import (DeadlineExceeded, EngineStopped,
                        PoolExhausted, QueueFull, ServiceUnavailable)
from .buckets import BucketPolicy, next_pow2
from .metrics import ServingStats, register_engine, unregister_engine
from .speculation import (MAX_SPEC_K, NO_DRAFTS, NGramDrafter,
                          SpecState, accept_lengths,
                          check_draft_compat)


class _Request(object):
    """One queued unit of work.  ``key`` groups coalescible requests;
    ``rows`` is the device-batch budget it consumes."""

    __slots__ = ("kind", "key", "rows", "x", "tokens", "length",
                 "max_new", "temperature", "seed", "deadline",
                 "result", "error", "event", "t_submit",
                 "kv_commit", "row_results", "rows_done", "replays")

    def __init__(self, kind, key, rows, deadline):
        self.kind = kind
        self.key = key
        self.rows = rows
        self.x = None
        self.tokens = None
        self.length = 0
        self.max_new = 0
        self.temperature = 0.0
        self.seed = 0
        self.deadline = deadline
        self.result = None
        self.error = None
        self.event = threading.Event()
        self.t_submit = time.monotonic()
        self.kv_commit = 0         # blocks reserved at admission
        self.row_results = None    # per-row generated-token lists
        self.rows_done = 0
        self.replays = 0           # supervised pool-rebuild replays


class _PagedRow(object):
    """One active row of the persistent decode batch: its block
    table, its write position, and the token it feeds next.  Block
    tables are allocated LAZILY — the prompt span at adoption, then
    one block at a time as the write position advances — so a row
    only ever holds blocks for tokens that exist (admission still
    reserves the worst case, so growth cannot dead-lock the pool).
    ``spec``/``draft_row`` carry the speculative-decoding state when
    the engine runs with a drafter."""

    __slots__ = ("req", "row_idx", "table", "n_blocks", "pos", "tok",
                 "gen", "prior", "chunk", "prefix_chain", "spec",
                 "draft_row")

    def __init__(self, req, row_idx, table, n_blocks):
        self.req = req
        self.row_idx = row_idx
        self.table = table          # physical block ids, in order
        self.n_blocks = n_blocks    # real entries in the table
        self.pos = 0                # next cache write position
        self.tok = 0                # last token (fed next step)
        self.gen = None             # generated tokens so far
        self.prior = 0              # cached positions at prefill
        self.chunk = None           # prompt remainder to prefill
        self.prefix_chain = None    # prompt block digests (reused)
        self.spec = None            # SpecState (speculation on)
        self.draft_row = None       # _DraftRow (draft-model drafter)


class _DraftRow(object):
    """The draft model's mirror of a target row: its own block table
    in the DRAFT pool plus the position/token cursor — advanced
    while drafting, re-synced to the target after every verify
    (rejected draft k/v beyond the cursor is masked until
    overwritten, so a plain cursor reset is a full rewind)."""

    __slots__ = ("table", "n_blocks", "pos", "tok")

    def __init__(self, table, n_blocks):
        self.table = table
        self.n_blocks = n_blocks
        self.pos = 0
        self.tok = 0


class ServingEngine(Logger):
    """Bounded queue + device thread + dynamic batching over a model
    exposing ``forward(x)`` (and, for LM artifacts,
    ``generate_bucketed(...)`` — :class:`veles_tpu_torch.export
    .ExportedModel` provides both; any duck-typed model with the same
    surface serves too).  When the model also exposes the paged
    surface (``make_kv_pool`` / ``paged_extend`` / ``paged_step``),
    generate traffic runs through decode-step continuous batching by
    default (``paged=False`` opts out)."""

    def __init__(self, model, max_batch=8, queue_depth=64,
                 policy=None, stats=None, default_deadline=30.0,
                 paged=None, kv_blocks=None, kv_block_size=16,
                 kv_dtype=None,
                 injector=None, max_replays=2, breaker_limit=3,
                 breaker_window=60.0, drain_timeout=30.0,
                 spec=False, spec_draft=None, spec_max_k=4,
                 spec_draft_blocks=None, spec_adaptive=True):
        super(ServingEngine, self).__init__()
        self.max_batch = int(max_batch)
        self.queue_depth = int(queue_depth)
        self._policy_explicit = policy is not None
        self._paged_arg = paged
        self.stats = stats or ServingStats()
        self.default_deadline = default_deadline
        self.kv_block_size = int(kv_block_size)
        self.kv_blocks = kv_blocks
        #: KV cache storage dtype ("f32"/"bf16"/"int8"/"fp8", None =
        #: config / f32).  Passed through to ``make_kv_pool``; the
        #: quantization itself lives entirely behind the paged
        #: surface in export.py.
        self.kv_dtype = kv_dtype
        self.kv_pool = None
        self._adopt_model(model, policy)
        #: Speculative decoding: "off" | "ngram" (prompt-lookup
        #: drafting, no second model) | "draft" (a second exported
        #: LM proposes greedily through its own paged pool).
        self.spec_mode = "draft" if spec_draft is not None else \
            ("ngram" if spec else "off")
        self.spec_max_k = int(spec_max_k)
        self.spec_adaptive = bool(spec_adaptive)
        self.spec_draft_blocks = spec_draft_blocks
        self.draft_model = None
        self.draft_pool = None
        self._drafter = NGramDrafter()
        #: EWMA speculative gauges (device thread only).
        self._spec_accept_ewma = None
        self._spec_tps_ewma = None
        self._spec_gate_skips = 0
        if self.spec_mode != "off":
            if not 1 <= self.spec_max_k <= MAX_SPEC_K:
                raise Bug("--spec-max-k must lie in 1..%d (the "
                          "flash-decode verify width), got %d" %
                          (MAX_SPEC_K, self.spec_max_k))
            if not self.paged:
                raise Bug("speculative decoding requires the paged "
                          "decode path (an LM artifact without "
                          "--no-paged-decode)")
            if not hasattr(model, "paged_verify"):
                raise Bug("speculative decoding requested but the "
                          "model exposes no paged_verify surface")
        if self.spec_mode == "draft":
            draft = spec_draft
            if not hasattr(draft, "weights"):
                draft = self._load_model(draft)
            check_draft_compat(model, draft)
            self.draft_model = draft
        #: Fault injector consulted at the ``serve.device_fault`` /
        #: ``serve.reload_corrupt`` points; None injects nothing.
        self.injector = injector
        #: Per-request supervised-recovery budget: how many pool
        #: rebuilds a single request may be replayed through before
        #: it fails with the device error.
        self.max_replays = int(max_replays)
        #: Circuit breaker: more than ``breaker_limit`` pool rebuilds
        #: inside ``breaker_window`` seconds trips the engine to
        #: permanent-fail (a device that faults this often is not
        #: recovering; restarts/reschedules are the operator's move).
        self.breaker_limit = int(breaker_limit)
        self.breaker_window = float(breaker_window)
        #: Default budget for ``stop(drain=True)``.
        self.drain_timeout = float(drain_timeout)
        #: Monotonic weight generation served by this engine — bumped
        #: by every successful :meth:`reload` (in-place or
        #: drain-and-swap) and surfaced as the ``weight_version``
        #: gauge on /stats, /metrics and the live serving summary.
        self.weight_version = int(getattr(model, "weight_version",
                                          None) or 1)
        # The engine condition rides a SniffedLock so stuck
        # acquisitions self-report.
        self._cond = threading.Condition(
            SniffedLock(name="ServingEngine.cond"))
        self._pending = collections.deque()     # guarded-by: _cond
        self._paged_wait = collections.deque()  # guarded-by: _cond
        self._rows = []                         # guarded-by: _cond
        self._kv_committed = 0                  # guarded-by: _cond
        self._thread = None
        self._stopped = False                   # guarded-by: _cond
        self._draining = False                  # guarded-by: _cond
        # closed | rebuilding | tripped
        self._breaker = "closed"                # guarded-by: _cond
        # rebuild timestamps
        self._rebuilds = collections.deque()    # guarded-by: _cond
        # device-thread ops
        self._ops = collections.deque()         # guarded-by: _cond
        # full swap quiescing
        self._reload_waiting = False            # guarded-by: _cond
        #: Device thread mid-iteration (a taken batch or an adoption
        #: whose rows are not yet in ``_rows``): drain and quiesce
        #: must wait on this too, or work in the adoption window
        #: would be invisible to them and die at the hard stop.
        self._busy = False                      # guarded-by: _cond
        # kind -> recent device-batch cost, and its number of samples
        self._batch_ewma = {}                   # guarded-by: _cond
        self._batch_samples = {}                # guarded-by: _cond

    def _load_model(self, path_or_file):
        """An artifact (a path or a file object) loaded as an
        :class:`~veles_tpu_torch.export.ExportedModel` on the served
        model's device."""
        from ..export import ExportedModel
        return ExportedModel(path_or_file,
                             device=getattr(self.model, "device", "cuda"))

    def _adopt_model(self, model, policy=None):
        """Binds ``model`` as the served model: caches its geometry
        and recomputes the paged-surface support and bucket policy —
        shared by the constructor and the drain-and-swap reload
        path."""
        self.model = model
        # Cached once: ExportedModel.max_position re-parses the unit
        # chain per access, too heavy for the per-request hot path.
        self._max_position = getattr(model, "max_position", None)
        if policy is not None:
            self.policy = policy
        elif not self._policy_explicit:
            self.policy = BucketPolicy(
                max_batch=self.max_batch,
                prompt_cap=self._max_position)
        supported = bool(
            self._max_position and
            hasattr(model, "make_kv_pool") and
            hasattr(model, "paged_extend") and
            hasattr(model, "paged_step"))
        paged = self._paged_arg
        if paged is None:
            self.paged = supported
        else:
            self.paged = bool(paged)
            if self.paged and not supported:
                raise Bug("paged decode requested but the model has "
                          "no paged surface (make_kv_pool / "
                          "paged_extend / paged_step + max_position)")

    # -- lifecycle ---------------------------------------------------------

    def _default_kv_blocks(self):
        """Pool sizing when the operator doesn't say: every one of
        ``max_batch`` concurrent rows can hold a full-length
        sequence, plus the trash block and headroom for resident
        prefix-cache entries."""
        per_row = -(-int(self._max_position) // self.kv_block_size)
        return self.max_batch * per_row + 1 + 16

    def _ensure_pool(self):
        if self.paged and self.kv_pool is None:
            n = self.kv_blocks or self._default_kv_blocks()
            self.kv_pool = self.model.make_kv_pool(
                n, self.kv_block_size, kv_dtype=self.kv_dtype)
            self.info("paged KV pool: %d blocks x %d slots, "
                      "storage %s (block 0 = trash)", n,
                      self.kv_block_size, self.kv_pool.kv_dtype)
            # e.g. quant.kv.int8 — which storage dtype this engine's
            # pools were built with, visible next to the shed/usage
            # counters it changes.
            self.stats.incr("quant.kv.%s" % self.kv_pool.kv_dtype)
        if self.spec_mode == "draft" and self.draft_pool is None:
            n = self.spec_draft_blocks or self.kv_blocks or \
                self._default_kv_blocks()
            self.draft_pool = self.draft_model.make_kv_pool(
                n, self.kv_block_size, kv_dtype=self.kv_dtype)
            self.info("speculative draft pool: %d blocks x %d slots",
                      n, self.kv_block_size)
        return self.kv_pool

    def start(self):
        if self._thread is not None:
            return self
        self._ensure_pool()
        with self._cond:
            self._stopped = False
            self._draining = False
        self.stats.set_gauge("weight_version", self.weight_version)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="veles-serving-device")
        self._thread.start()
        register_engine(self)
        return self

    #: Retry-After quoted to requests a non-draining stop() caught
    #: still queued: the horizon a supervised restart usually needs
    #: before the replacement replica takes traffic.
    RESTART_RETRY_AFTER = 5.0

    def stop(self, drain=False, timeout=None):
        """Stops the engine.  ``drain=False`` (the default) cancels
        everything immediately; ``drain=True`` is the graceful path:
        admissions close (503 + ``Retry-After``), queued-but-
        unstarted requests are failed with
        :class:`~veles_tpu_torch.serving.admission.ServiceUnavailable`
        (their clients retry the restarted replica), live decode rows
        run to completion up to ``timeout`` (default
        :attr:`drain_timeout`), and the final stats are flushed to
        the log before the device thread exits."""
        if drain and self._thread is not None:
            budget = self.drain_timeout if timeout is None else \
                float(timeout)
            with self._cond:
                self._draining = True
                live_reqs = {row.req for row in self._rows}
                self._fail_queued_locked(
                    "serving engine is draining for shutdown",
                    retry_after=max(1.0, budget))
                self._cond.notify_all()
            deadline = Deadline(budget)
            drained = True
            while True:
                with self._cond:
                    # _busy covers the adoption window: requests the
                    # device thread already took from the queue but
                    # whose rows are not in _rows yet — they count
                    # as live, or they would die at the hard stop.
                    live = len(self._rows) + int(self._busy)
                    live_reqs.update(row.req for row in self._rows)
                if not live:
                    break
                if deadline.expired:
                    drained = False
                    self.warning("drain timeout: %d live decode "
                                 "row(s) still running", live)
                    break
                time.sleep(0.005)
            done = sum(1 for req in live_reqs
                       if req.result is not None)
            if done:
                self.stats.incr("drained.requests", done)
            if not drained:
                self.stats.incr("drained.timeouts")
            self.info("drain %s (%d request(s) decoded to "
                      "completion) — final stats: %s",
                      "complete" if drained else "timed out", done,
                      self.stats.snapshot().get("counters"))
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        unregister_engine(self)
        # Anything still queued or mid-decode is cancelled, not
        # silently dropped — a blocked submitter must wake with an
        # error (503: the server's state, retryable, never a client
        # fault).  Queued-but-unstarted requests get ServiceUnavail-
        # able + Retry-After: a well-behaved client retries them
        # verbatim against the restarting replica.
        for req in {row.req for row in self._rows}:
            self._fail_req(req, EngineStopped("serving engine "
                                              "stopped"))
        with self._cond:
            self._fail_queued_locked(
                "serving engine stopped — retry against the "
                "restarted replica",
                retry_after=self.RESTART_RETRY_AFTER)
        # Unblock any reload waiting on the device thread.
        with self._cond:
            ops, self._ops = list(self._ops), collections.deque()
        for op in ops:
            op["error"] = EngineStopped("serving engine stopped")
            op["event"].set()

    def _fail_queued_locked(self, reason, retry_after):
        """Fails every queued-but-unstarted request with 503 +
        ``Retry-After`` (caller holds the lock)."""
        while self._pending:
            req = self._pending.popleft()
            req.error = ServiceUnavailable(reason,
                                           retry_after=retry_after)
            req.event.set()
        while self._paged_wait:
            req = self._paged_wait.popleft()
            self._kv_committed -= req.kv_commit
            req.error = ServiceUnavailable(reason,
                                           retry_after=retry_after)
            req.event.set()

    # -- hot weight reload -------------------------------------------------

    def reload(self, model_or_path, timeout=60.0):
        """Swaps in new weights WITHOUT dropping live streams.

        ``model_or_path`` is an already-verified model object, a
        path, or a file object holding an artifact.  Same-geometry
        artifacts do an IN-PLACE weight swap applied by the device
        thread at a decode-step boundary — the compile-cache accounting
        and the KV pool survive (live rows keep their tables; only the
        prompt-prefix cache is flushed, its entries hold old-weight
        k/v); different-geometry artifacts fall back to
        DRAIN-AND-SWAP: admissions close (503 + ``Retry-After``),
        in-flight work runs to completion, then the whole model (and
        pool) is replaced.  Returns the new monotonically-increased
        :attr:`weight_version`.  Blocks up to ``timeout`` seconds;
        raises whatever the swap raised (the old weights keep serving
        on any failure)."""
        new = model_or_path
        if not hasattr(new, "weights"):
            new = self._load_model(new)
        try:
            same = bool(self.model.same_geometry(new))
        except AttributeError:
            same = False  # duck-typed model: full swap only
        if self._thread is None:
            return self._apply_reload(new, same)
        op = {"new": new, "same": same, "event": threading.Event(),
              "result": None, "error": None}
        with self._cond:
            if self._stopped:
                raise EngineStopped("serving engine is not running")
            self._ops.append(op)
            self._cond.notify_all()
        if not op["event"].wait(timeout):
            # CANCEL the op: a reload the caller was told failed
            # must never land later behind their back (an operator
            # retry would then double-apply).  If it cannot be
            # removed, the device thread is applying it RIGHT NOW —
            # wait briefly for the definitive outcome instead.
            with self._cond:
                try:
                    self._ops.remove(op)
                    cancelled = True
                except ValueError:
                    cancelled = False
                if cancelled and not self._ops:
                    # Admissions were closed for a pending full
                    # swap; with the queue now empty nobody else
                    # owns that hold — reopen.  (Remaining ops keep
                    # it: their own apply/cancel clears it.)
                    self._reload_waiting = False
                self._cond.notify_all()
            if not cancelled and op["event"].wait(10.0):
                if op["error"] is not None:
                    raise op["error"]
                return op["result"]
            raise ServiceUnavailable(
                "reload cancelled: live work did not quiesce within "
                "%gs" % timeout, retry_after=timeout)
        if op["error"] is not None:
            raise op["error"]
        return op["result"]

    def reload_draft(self, model_or_path, timeout=60.0):
        """Hot-swaps the speculative DRAFT model through the same
        export/reload chain as the target: geometry-checked like
        ``swap_weights`` (same-geometry drafts swap weights in
        place; different geometry replaces the model and rebuilds
        the draft pool), applied by the device thread at a decode
        boundary.  Live rows drop their draft mirrors and re-arm on
        their next drafting round; target streams never notice.
        Raises on incompatibility (``check_draft_compat``) with the
        old draft still serving.  Also the RECOVERY path after a
        draft fault degraded the engine to the n-gram drafter: a
        successful reload restores draft-model drafting."""
        if self.draft_model is None and self.spec_mode != "draft":
            raise Bug("no draft model is configured "
                      "(--spec-draft) — nothing to reload")
        new = model_or_path
        if not hasattr(new, "weights"):
            new = self._load_model(new)
        check_draft_compat(self.model, new)
        if self._thread is None:
            return self._apply_draft_reload(new)
        done, result = self._device_op({"new": new, "draft": True},
                                       timeout)
        if not done:
            raise ServiceUnavailable(
                "draft reload did not apply within %gs" % timeout,
                retry_after=timeout)
        return result

    def _apply_draft_reload(self, new):
        """Device-thread body of :meth:`reload_draft`: live mirrors
        are released (their k/v belongs to the old draft), then the
        weights swap in place when the geometry matches or the
        model+pool are replaced outright.  Live rows get FRESH empty
        mirrors — the stale-mirror catch-up in
        :meth:`_draft_model_propose` refills each one with prompt +
        emitted on its next drafting round, so long-lived streams
        keep speculating across the reload."""
        if not self.paged or not hasattr(self.model, "paged_verify"):
            # A drain-and-swap may have replaced the TARGET with a
            # model that cannot speculate (spec_mode went "off");
            # re-arming the draft against it would fault every
            # verify into the circuit breaker.
            raise Bug("the served model has no paged_verify surface "
                      "— swap a speculation-capable target before "
                      "reloading the draft")
        with self._cond:
            live = list(self._rows)
        for row in live:
            self._release_draft(row)
        try:
            same = bool(self.draft_model.same_geometry(new))
        except AttributeError:
            same = False
        if same:
            self.draft_model.swap_weights(new.weights)
        else:
            self.draft_model = new
        # A reload also RECOVERS a drafter degraded to n-gram by an
        # earlier draft fault: the pool rebuild below starts clean.
        self.spec_mode = "draft"
        if not same or self.draft_pool is None:
            self.draft_pool = None
            try:
                self._ensure_pool()
            except Exception:
                # A failed rebuild must not leave spec_mode pointing
                # at a pool that does not exist — the next adoption
                # would kill the device thread.  Degrade exactly like
                # a draft fault; the error still reaches the caller.
                self.spec_mode = "ngram"
                self.stats.incr("spec.draft_degraded")
                self.warning("draft pool rebuild failed — degrading "
                             "to the n-gram drafter")
                raise
        pool = self.draft_pool
        for row in live:
            if row.spec is None:
                continue
            ids = pool.alloc(1)
            if ids is None:
                self.stats.incr("spec.draft_degraded")
                continue
            row.draft_row = _DraftRow(ids, 1)  # catch-up refills
        self.stats.incr("spec.draft_reloads")
        self.info("draft model reloaded (%s), %d live mirror(s) "
                  "re-armed", "in-place" if same
                  else "replaced + pool rebuilt", len(live))
        return getattr(self.draft_model, "weight_version", 1)

    def _device_op(self, op, timeout):
        """Runs ``op`` on the device thread at a decode-step boundary
        (the op queue of a reload) and returns ``(done, result)``;
        ``done`` is False when the timeout expired first (the op is
        withdrawn).  Without a device thread the caller applies it."""
        op.update(same=True, event=threading.Event(), result=None,
                  error=None)
        with self._cond:
            if self._stopped:
                raise EngineStopped("serving engine is not running")
            self._ops.append(op)
            self._cond.notify_all()
        if not op["event"].wait(timeout):
            with self._cond:
                try:
                    self._ops.remove(op)
                except ValueError:
                    pass
            return False, None
        if op["error"] is not None:
            raise op["error"]
        return True, op["result"]

    def adopt_kv_prefix(self, tokens, payload, timeout=30.0):
        """Adopts remotely-prefilled KV blocks into this engine's pool —
        the decode-side half of prefill/decode disaggregation
        (:mod:`veles_tpu_torch.serving.fabric.disagg`).  ``payload`` is
        an unpacked disagg dict (``unpack_kv_payload``): full-block k/v
        tensors plus the ``weight_version`` they were computed under.
        The write rides the device-thread op queue, as an in-place
        reload does, because writing ``pool.storage`` from another
        thread would race the decode step.  Returns the number of
        blocks adopted (0 = refused: version skew, a dense engine, pool
        exhaustion or the timeout — adoption is an optimization; the
        prompt simply prefills locally)."""
        if not self.paged:
            return 0
        if int(payload.get("weight_version", -1)) != \
                int(self.weight_version):
            # KV computed under other weights must never serve this
            # model — exactly why reload() flushes the prefix cache.
            self.stats.incr("kv.adopt_stale")
            return 0
        if self._thread is None:
            return self._apply_kv_adopt(tokens, payload)
        done, result = self._device_op({"kv": (tokens, payload)},
                                       timeout)
        return result if done else 0

    def export_kv_prefix(self, tokens, timeout=30.0):
        """Exports the prompt's cached full KV blocks for the wire — the
        prefill-side half of disaggregation.  Returns ``(n_blocks,
        blocks, block_size, weight_version)`` with ``blocks`` the
        ``(L, 2, n, bs, H, D)`` host array from ``export_kv_blocks``,
        or None when the engine is dense, the pool holds no COMPLETE
        chain for the prompt (the caller prefills once and retries), or
        the timeout expires.  Rides the device-thread op queue for the
        same reason adoption does."""
        if not self.paged:
            return None
        if self._thread is None:
            return self._apply_kv_export(tokens)
        return self._device_op({"kv_export": tokens}, timeout)[1]

    def _apply_kv_export(self, tokens):
        """Device-thread body of :meth:`export_kv_prefix`."""
        self._ensure_pool()
        pool = self.kv_pool
        if pool is None or len(tokens) < pool.block_size:
            return None
        chain = pool.prefix_chain(tokens)
        if not chain:
            return None
        n, ids = pool.export_prefix_blocks(tokens, chain=chain)
        if n < len(chain):
            # Partial coverage would ship a prefix the decode side must
            # finish anyway — the caller prefills locally once and
            # re-exports the full chain.
            if n:
                pool.release(ids)
            return None
        try:
            blocks = self.model.export_kv_blocks(pool, ids)
        finally:
            pool.release(ids)
        return (n, blocks, pool.block_size, self.weight_version)

    def _apply_kv_adopt(self, tokens, payload):
        """Device-thread body of :meth:`adopt_kv_prefix`."""
        self._ensure_pool()
        pool = self.kv_pool
        if pool is None or \
                pool.block_size != int(payload["block_size"]):
            return 0
        chain = pool.prefix_chain(tokens)
        n = min(int(payload["n_blocks"]), len(chain))
        if n <= 0:
            return 0
        blocks = payload["blocks"]

        def write(ids):
            self.model.import_kv_blocks(pool, ids,
                                        blocks[:, :, :len(ids)])

        ids = pool.adopt_prefix_blocks(tokens, n, write_fn=write,
                                       chain=chain)
        if ids is None:
            self.stats.incr("kv.adopt_shed")
            return 0
        self.stats.incr("kv.adopt")
        return len(ids)

    def _apply_kv_op(self, op):
        """Runs a KV export or adoption op on the device thread; a
        failure reaches the caller, and the prompt prefills locally."""
        try:
            if op.get("kv_export") is not None:
                op["result"] = self._apply_kv_export(op["kv_export"])
            else:
                op["result"] = self._apply_kv_adopt(*op["kv"])
        except Exception as e:
            self.exception("KV %s failed — the prompt prefills locally "
                           "instead", "export" if op.get("kv_export")
                           is not None else "adoption")
            op["error"] = e
        finally:
            op["event"].set()

    def _apply_reload_op(self, op):
        if op.get("kv_export") is not None or op.get("kv"):
            self._apply_kv_op(op)
            return
        if op.get("draft"):
            try:
                op["result"] = self._apply_draft_reload(op["new"])
            except Exception as e:  # surfaced to reload_draft()
                self.exception("draft reload failed — the old draft "
                               "keeps proposing")
                op["error"] = e
            finally:
                op["event"].set()
            return
        try:
            op["result"] = self._apply_reload(op["new"], op["same"])
        except Exception as e:  # surfaced to the reload() caller
            self.exception("reload failed — old weights keep serving")
            op["error"] = e
        finally:
            with self._cond:
                self._reload_waiting = False
                self._cond.notify_all()
            op["event"].set()

    def _apply_reload(self, new, same):
        t0 = time.monotonic()
        if same:
            self.model.swap_weights(new.weights)
            if self.kv_pool is not None:
                dropped = self.kv_pool.drop_prefixes()
                if dropped:
                    self.debug("reload: flushed %d cached prefixes",
                               dropped)
            self.stats.incr("reload.inplace")
        else:
            # The device thread only applies a full swap once the
            # engine is quiet, so nothing references the old model or
            # pool anymore.  Adoption can still FAIL (explicit
            # paged=True against a surface-less artifact, pool build
            # OOM) — restore every mutated binding so "old weights
            # keep serving" stays true.
            old = (self.model, self._max_position, self.policy,
                   self.paged, self.kv_pool)
            try:
                self._adopt_model(new)
                self.kv_pool = None
                self._ensure_pool()
            except BaseException:
                (self.model, self._max_position, self.policy,
                 self.paged, self.kv_pool) = old
                raise
            if self.spec_mode != "off":
                # The swapped-in model must still carry the spec
                # surface (and match the draft's token space); a
                # mismatch disables speculation, never the swap.
                try:
                    if not self.paged or \
                            not hasattr(new, "paged_verify"):
                        raise Bug("new model has no paged_verify "
                                  "surface")
                    if self.spec_mode == "draft":
                        check_draft_compat(new, self.draft_model)
                except Bug as e:
                    self.warning("speculation disabled after model "
                                 "swap: %s", e)
                    self.spec_mode = "off"
                    self.draft_pool = None
            self.stats.incr("reload.swap")
        self.weight_version += 1
        self.stats.set_gauge("weight_version", self.weight_version)
        self.stats.observe_latency("reload.apply",
                                   time.monotonic() - t0)
        self.info("weights reloaded (%s) -> version %d",
                  "in-place" if same else "drain-and-swap",
                  self.weight_version)
        return self.weight_version

    def queue_depth_now(self):
        with self._cond:
            return len(self._pending) + len(self._paged_wait)

    def _drain_estimate_locked(self):
        """Retry-After for a rejected request: how long the current
        queue should take to drain, from the recent device-batch
        cost PER REQUEST KIND and the queue's actual kind mix — a
        multi-second generate batch must not poison the estimate a
        cheap classify flood is quoted (each drained batch retires
        up to ``max_batch`` queued requests of its kind).  Floors at
        1 s; a kind with no signal yet claims that floor."""
        counts = {}
        for req in self._pending:
            counts[req.kind] = counts.get(req.kind, 0) + 1
        if self._paged_wait:
            counts["generate"] = counts.get("generate", 0) + \
                len(self._paged_wait)
        total = 0.0
        for kind, n in counts.items():
            ewma = self._batch_ewma.get(kind)
            if ewma is None:
                total += 1.0  # no signal for this kind: the floor
                continue
            total += -(-n // max(1, self.max_batch)) * ewma
        return min(60.0, max(1.0, total))

    def _pool_retry_locked(self):
        """Retry-After for a pool-exhausted rejection: blocks free up
        when the CLOSEST active row retires, so quote its remaining
        decode steps at the recent per-step cost."""
        if not self._rows:
            return 1.0
        remaining = min(row.req.max_new - len(row.gen or ())
                        for row in self._rows)
        step = self._batch_ewma.get("decode", 0.05)
        if self.spec_mode != "off" and self._spec_tps_ewma:
            # Speculating rows retire tokens-per-step times faster,
            # at the verify dispatch's own (separately-keyed) cost.
            vstep = self._batch_ewma.get("verify", step)
            return min(60.0, max(1.0, remaining * vstep / max(
                self._spec_tps_ewma, 1.0)))
        return min(60.0, max(1.0, remaining * step))

    # -- submission (HTTP handler threads) ---------------------------------

    def _admission_gate_locked(self):
        """The server-state checks every submission passes before it
        may cost a queue slot: a stopped engine, a drain in progress,
        and the supervised-recovery circuit breaker (503 +
        ``Retry-After`` while the KV pool rebuilds; permanent-fail
        once tripped)."""
        if self._stopped:
            raise EngineStopped("serving engine is not running")
        if self._draining or self._reload_waiting:
            self.stats.incr("rejected.draining")
            raise ServiceUnavailable(
                "serving engine is %s — retry shortly" %
                ("draining" if self._draining
                 else "swapping models"),
                retry_after=max(1.0, self._drain_estimate_locked()))
        if self._breaker == "tripped":
            self.stats.incr("rejected.breaker")
            raise ServiceUnavailable(
                "circuit breaker tripped: %d KV pool rebuilds inside "
                "%.0f s — the device is not recovering" %
                (len(self._rebuilds), self.breaker_window))
        if self._breaker == "rebuilding":
            self.stats.incr("rejected.breaker")
            raise ServiceUnavailable(
                "KV pool rebuilding after a device fault",
                retry_after=1.0)

    def _enqueue(self, req):
        with self._cond:
            self._admission_gate_locked()
            if len(self._pending) >= self.queue_depth:
                self.stats.incr("rejected.queue_full")
                raise QueueFull(
                    "request queue at depth %d" % self.queue_depth,
                    retry_after=self._drain_estimate_locked())
            self._pending.append(req)
            self._cond.notify()
        return self._finish_wait(req)

    def _finish_wait(self, req):
        """Blocks the submitter on the request's completion event,
        surfacing device-thread stalls as 504 and re-raising any
        error the device thread attached."""
        budget = req.deadline.remaining() if req.deadline is not None \
            else None
        finished = req.event.wait(
            timeout=None if budget is None or budget == float("inf")
            else budget + 60.0)
        if not finished:
            # A device-thread stall is the SERVER's fault — surface
            # it as 504 (DeadlineExceeded), never as a client error.
            self.stats.incr("stalled.requests")
            raise DeadlineExceeded(
                "the device thread did not answer within the "
                "request budget")
        if req.error is not None:
            raise req.error
        self.stats.observe_request(  # lint-ok: VL301 req.kind is
            req.kind, time.monotonic() - req.t_submit)  # set from
        # the "classify"/"generate" literals at construction only
        return req.result

    def submit_classify(self, x, deadline=None):
        """Blocking: a (B, features) float batch through the forward
        chain; returns the (B, ...) output for exactly these rows.
        Requests wider than ``max_batch`` are split into sequential
        chunks (the pre-engine handler accepted any batch size; the
        engine preserves that, it just bounds DEVICE batches)."""
        x = numpy.asarray(x, dtype=numpy.float32)
        if x.ndim == 1:
            x = x[None]
        deadline = self._deadline(deadline)
        self._check_deadline_eager(deadline)
        if x.shape[0] > self.max_batch:
            return numpy.concatenate([
                self.submit_classify(x[at:at + self.max_batch],
                                     deadline=deadline)
                for at in range(0, x.shape[0], self.max_batch)],
                axis=0)
        req = _Request("classify", ("c",) + tuple(x.shape[1:]),
                       x.shape[0], deadline)
        req.x = x
        return self._enqueue(req)

    def submit_generate(self, tokens, max_new, temperature=0.0,
                        seed=0, deadline=None):
        """Blocking: autoregressive decode for one request (possibly
        multi-row); returns the (B, prompt+max_new) full sequences.
        Under paged decode the request's rows join the persistent
        step batch after prefill and retire independently."""
        tokens = numpy.atleast_2d(
            numpy.asarray(tokens, dtype=numpy.int32))
        max_new = int(max_new)
        if max_new < 1:
            # Must be rejected HERE: downstream only ever sees the
            # decode BUCKET (>= the floor), so a negative/zero budget
            # would otherwise slice garbage into a 200 response.
            raise Bug("max_new_tokens must be >= 1")
        cap = self.policy.new_cap
        if cap is not None and max_new > cap:
            # Past the cap, bucket_of degrades to one key per
            # distinct value — exactly the per-request shape thrash
            # bucketing exists to prevent — so the cap is a hard
            # request limit, for direct callers and HTTP alike.
            raise Bug("max_new_tokens %d exceeds the serving cap "
                      "(%d)" % (max_new, cap))
        # Seeds fold into 32 bits (the PRNG key width): an arbitrary-
        # precision client int must not reach the device thread,
        # where an int64 overflow would 500 every request coalesced
        # into the same batch.
        seed = int(seed) & 0xFFFFFFFF
        # The ORIGINAL deadline is resolved once and threaded through
        # every chunk of an oversized request — the caller's budget
        # is end-to-end, not per chunk — and an (almost-)expired
        # budget fails fast instead of half-generating.
        deadline = self._deadline(deadline)
        self._check_deadline_eager(deadline)
        if tokens.shape[0] > self.max_batch:
            return numpy.concatenate([
                self.submit_generate(
                    tokens[at:at + self.max_batch], max_new,
                    temperature=temperature, seed=seed + at,
                    deadline=deadline)
                for at in range(0, tokens.shape[0],
                                self.max_batch)], axis=0)
        if tokens.shape[1] < 1:
            raise Bug("prompt must contain at least one token")
        limit = self._max_position
        if limit is not None and \
                tokens.shape[1] + max_new > limit:
            raise Bug(
                "prompt %d + %d new tokens exceeds the model's "
                "positional table (%d)" %
                (tokens.shape[1], max_new, limit))
        if self.paged:
            return self._submit_paged(tokens, max_new, temperature,
                                      seed, deadline)
        s_bucket = self.policy.prompt_bucket(tokens.shape[1])
        m_bucket = self.policy.new_bucket(max_new)
        if limit is not None:
            # The padded prefill embeds positions 0..s_bucket-1; a
            # bucket beyond the table would fail eagerly inside the
            # build, so clamp here (bucket_of never goes below the
            # true length).
            s_bucket = min(s_bucket, limit)
        req = _Request("generate", ("g", s_bucket, m_bucket),
                       tokens.shape[0], deadline)
        req.tokens = tokens
        req.length = tokens.shape[1]
        req.max_new = int(max_new)
        req.temperature = float(temperature)
        req.seed = int(seed)
        return self._enqueue(req)

    def _submit_paged(self, tokens, max_new, temperature, seed,
                      deadline):
        """Paged admission: the binding resource is the BLOCK POOL,
        not the queue — a request reserves its worst-case block need
        at the door and is shed with 429 :class:`PoolExhausted` when
        the reservation does not fit on top of what queued and
        active requests already hold.  (Prefix sharing can only make
        the realized need smaller, so reservations never over-admit.)
        """
        req = _Request("generate", ("pg",), tokens.shape[0], deadline)
        req.tokens = tokens
        req.length = tokens.shape[1]
        req.max_new = int(max_new)
        req.temperature = float(temperature)
        req.seed = int(seed)
        per_row = -(-(req.length + req.max_new) // self.kv_block_size)
        req.kv_commit = per_row * req.rows
        req.row_results = [None] * req.rows
        with self._cond:
            self._admission_gate_locked()
            pool = self._ensure_pool()
            if req.kv_commit > pool.usable:
                raise Bug(
                    "request needs %d KV blocks but the pool holds "
                    "%d — raise --kv-blocks or shrink the request" %
                    (req.kv_commit, pool.usable))
            if len(self._paged_wait) >= self.queue_depth:
                # The pool is the PRIMARY shed point, but the queue
                # bound stays live as the payload-memory backstop —
                # tiny requests could otherwise park thousands of
                # handler threads on a big pool.
                self.stats.incr("rejected.queue_full")
                raise QueueFull(
                    "request queue at depth %d" % self.queue_depth,
                    retry_after=self._drain_estimate_locked())
            if self._kv_committed + req.kv_commit > pool.usable:
                self.stats.incr("rejected.pool_exhausted")
                raise PoolExhausted(
                    "KV pool exhausted: %d blocks committed, %d "
                    "more needed, %d usable" %
                    (self._kv_committed, req.kv_commit, pool.usable),
                    retry_after=self._pool_retry_locked())
            self._kv_committed += req.kv_commit
            self._paged_wait.append(req)
            self._cond.notify()
        return self._finish_wait(req)

    def _check_deadline_eager(self, deadline):
        if deadline is not None and deadline.expired:
            self.stats.incr("cancelled.deadline")
            raise DeadlineExceeded(
                "deadline expired before submission")

    def _deadline(self, deadline):
        if deadline is not None:
            return deadline
        if self.default_deadline is None:
            return None
        return Deadline(self.default_deadline)

    # -- device thread -----------------------------------------------------

    def _loop(self):
        while True:
            with self._cond:
                while not (self._pending or self._paged_wait or
                           self._rows or self._ops or self._stopped):
                    self._cond.wait(0.5)
                if self._stopped:
                    return
                op = None
                if self._ops:
                    head = self._ops[0]
                    if head["same"] or self._quiet_locked():
                        # In-place swaps apply at ANY decode-step
                        # boundary; a full model swap waits for the
                        # engine to quiesce (drain-and-swap) with
                        # admissions closed meanwhile.
                        op = self._ops.popleft()
                    else:
                        self._reload_waiting = True
                batch = None
                adopt = []
                if op is None:
                    if self._pending:
                        batch = self._take_batch_locked()
                    adopt = self._take_paged_locked()
                self._busy = bool(batch or adopt)
            if op is not None:
                self._apply_reload_op(op)
                continue
            try:
                if adopt:
                    self._paged_prefill(adopt)
                if batch:
                    self._execute(batch)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()
            if self._rows:
                self._paged_step_once()

    def _quiet_locked(self):
        """No queued, adopting, or live work — the drain-and-swap
        quiesce condition (caller holds the lock)."""
        return not (self._pending or self._paged_wait or
                    self._rows or self._busy)

    def _take_batch_locked(self):
        """Head-of-queue plus every compatible waiting request, up to
        ``max_batch`` device rows.  Later incompatible requests stay
        queued in order."""
        head = self._pending.popleft()
        batch, rows = [head], head.rows
        for req in list(self._pending):
            if rows >= self.max_batch:
                break
            if req.key == head.key and \
                    rows + req.rows <= self.max_batch:
                self._pending.remove(req)
                batch.append(req)
                rows += req.rows
        return batch

    def _take_paged_locked(self):
        """Paged requests adopted at this token boundary: FIFO, as
        many as fit beside the active rows (the step batch is capped
        at ``max_batch`` device rows).  Requests whose deadline
        expired while waiting are cancelled here, unserved."""
        out = []
        rows = len(self._rows)
        while self._paged_wait:
            req = self._paged_wait[0]
            if req.deadline is not None and req.deadline.expired:
                self._paged_wait.popleft()
                self._kv_committed -= req.kv_commit
                self._cancel(req)
                continue
            if rows + req.rows > self.max_batch:
                break
            self._paged_wait.popleft()
            out.append(req)
            rows += req.rows
        return out

    def _cancel(self, req):
        self.stats.incr("cancelled.deadline")
        req.error = DeadlineExceeded(
            "deadline expired after %.3fs in queue" %
            (time.monotonic() - req.t_submit))
        req.event.set()

    def _execute(self, batch):
        live = []
        for req in batch:
            if req.deadline is not None and req.deadline.expired:
                self._cancel(req)
            else:
                live.append(req)
        if not live:
            return
        t0 = time.monotonic()
        try:
            # Dense batches carry no cross-request device state: a
            # fault (injected or real) fails THIS batch only and the
            # clients retry — no pool rebuild needed.
            resilience.effective(self.injector).check(
                "serve.device_fault")
            if live[0].kind == "classify":
                self._run_classify(live)
            else:
                self._run_generate(live)
            dt = time.monotonic() - t0
            self.stats.observe_batch(  # lint-ok: VL301 kind is a
                live[0].kind, sum(r.rows for r in live), dt)
            # construction-time literal ("classify"/"generate")
            self._note_ewma(live[0].kind, dt)
        except Exception as e:
            for req in live:
                if req.error is None:
                    req.error = e
        finally:
            for req in live:
                req.event.set()

    def _note_ewma(self, kind, dt):
        with self._cond:
            ewma = self._batch_ewma.get(kind)
            self._batch_ewma[kind] = dt if ewma is None \
                else 0.8 * ewma + 0.2 * dt
            self._batch_samples[kind] = self._batch_samples.get(kind, 0) + 1

    def _run_classify(self, live):
        x = numpy.concatenate([r.x for r in live], axis=0)
        n = x.shape[0]
        bucket = self.policy.batch_bucket(n)
        y = numpy.asarray(self.model.forward_bucketed(x, bucket))
        at = 0
        for req in live:
            req.result = y[at:at + req.rows]
            at += req.rows

    def _run_generate(self, live):
        _, s_bucket, m_bucket = live[0].key
        rows = sum(r.rows for r in live)
        b_bucket = self.policy.batch_bucket(rows)
        prompts = numpy.zeros((b_bucket, s_bucket), numpy.int32)
        lengths = numpy.ones(b_bucket, numpy.int32)
        temps = numpy.zeros(b_bucket, numpy.float32)
        seeds = numpy.zeros(b_bucket, numpy.int64)
        at = 0
        for req in live:
            for i in range(req.rows):
                prompts[at, :req.length] = req.tokens[i]
                lengths[at] = req.length
                temps[at] = req.temperature
                # Per-row sampling streams: rows of one request fold
                # the row index into the request seed (independent
                # draws, deterministic per request), masked to the
                # 32-bit PRNG key width.
                seeds[at] = (req.seed + i) & 0xFFFFFFFF
                at += 1
        gen = numpy.asarray(self.model.generate_bucketed(
            prompts, lengths, m_bucket, temps, seeds))
        at = 0
        for req in live:
            new = gen[at:at + req.rows, :req.max_new]
            req.result = numpy.concatenate([req.tokens, new], axis=1)
            at += req.rows

    # -- paged decode: prefill + persistent step batch ---------------------

    def _paged_prefill(self, reqs):
        """Adopt freshly taken requests into the decode batch: per
        row, match the longest cached prompt prefix (adopting its
        blocks, COW-copying the last one when the first write would
        land inside it), allocate the remainder of the table, and
        run ONE coalesced ``paged_extend`` over every adopted row —
        different prefix depths ride together because each row
        carries its own ``prior``/``chunk_len``."""
        pool = self.kv_pool
        rows = []
        for req in reqs:
            req_rows, failed = [], None
            for i in range(req.rows):
                try:
                    row = self._build_paged_row(req, i)
                except Exception as e:
                    # A device fault inside COW (a CUDA error, OOM)
                    # must fail THIS request, never escape and kill
                    # the device thread — the dense path's _execute
                    # invariant, kept here.
                    self.exception("paged row adoption failed")
                    failed = e
                    break
                if row is None:
                    # Defensive: admission's worst-case reservation
                    # should make this unreachable; if it happens,
                    # shed with the same 429 + accounting the
                    # door-time path uses.
                    self.stats.incr("rejected.pool_exhausted")
                    with self._cond:
                        retry = self._pool_retry_locked()
                    failed = PoolExhausted(
                        "KV pool exhausted during adoption",
                        retry_after=retry)
                    break
                req_rows.append(row)
            if failed is not None:
                for row in req_rows:
                    self._release_row_blocks(row)
                with self._cond:
                    self._kv_committed -= req.kv_commit
                req.error = failed
                req.event.set()
                continue
            rows.extend(req_rows)
        if not rows:
            return
        try:
            self._run_paged_extend(rows)
        except Exception as e:
            self.exception("paged prefill failed")
            self._recover_prefill_fault(rows, e)
            return
        now = time.monotonic()
        live = []
        for row in rows:
            req = row.req
            self.stats.observe_latency("ttft.generate",
                                       now - req.t_submit)
            try:
                pool.register_prefix(req.tokens[row.row_idx],
                                     row.table,
                                     chain=row.prefix_chain)
            except Exception:
                # Losing a cache registration costs a future prefix
                # hit, never the request.
                self.exception("prefix registration failed")
            if req.max_new <= len(row.gen):
                self._retire_row(row)
            else:
                live.append(row)
        if live:
            if self.spec_mode != "off":
                self._spec_adopt(live)
            with self._cond:
                self._rows.extend(live)
        self.stats.note_tokens(len(rows))
        self.stats.incr("tokens.generated", len(rows))
        self._update_gauges()

    def _build_paged_row(self, req, i):
        """Block table + prefill plan for one request row, or None
        when the pool cannot supply it (structurally rare: the
        admission reservation covers the worst case, and ``alloc``
        evicts cached prefixes under pressure)."""
        pool = self.kv_pool
        tokens_row = req.tokens[i]
        length = req.length
        # LAZY tables: the prompt span only — decode blocks arrive
        # one at a time as the write position advances (and leave
        # immediately on speculative rewind), so the pool holds
        # blocks for tokens that exist, not for worst-case budgets.
        # Admission still reserves the worst case, so growth can
        # always be satisfied (alloc evicts cached prefixes under
        # pressure before refusing).
        table_blocks = pool.blocks_for(length)
        chain = pool.prefix_chain(tokens_row[:length])
        k_full, shared = pool.lookup_prefix(tokens_row[:length],
                                            chain=chain)
        if shared and k_full * pool.block_size == length:
            # The WHOLE prompt is cached: re-feed only its last
            # token to recover the first logits.  That write lands
            # at position len-1 — inside the last shared block — so
            # copy-on-write gives this row a private copy first.
            fresh_block = pool.cow_copy(shared[-1])
            if fresh_block is None:
                pool.release(shared)
                return None
            pool.release([shared[-1]])
            shared[-1] = fresh_block
            prior = length - 1
        else:
            prior = k_full * pool.block_size
        fresh_needed = table_blocks - len(shared)
        fresh = pool.alloc(fresh_needed) if fresh_needed > 0 else []
        if fresh is None:
            pool.release(shared)
            return None
        row = _PagedRow(req, i, shared + fresh, table_blocks)
        row.prior = prior
        row.chunk = tokens_row[prior:length]
        row.prefix_chain = chain
        return row

    def _run_paged_extend(self, rows, replay=False):
        """Coalesced chunk prefill for the adopted rows, grouped by
        (chunk bucket, table-width bucket): rows of one group share
        one dispatch, rows of different geometry get their own —
        coalescing a 1-token prefix-refeed beside a long fresh
        prefill would otherwise mint a (short-chunk, long-table)
        shape per MIX, an unbounded, unwarmable set.
        ``replay=True`` is the supervised-recovery path: a row that
        already emitted tokens keeps its (tok, gen) state — the
        freshly sampled token is discarded, because the request
        already holds it and the NEXT step must sample at PRNG fold
        index ``len(gen)``, exactly where the uninjected run would
        be."""
        groups = {}
        for row in rows:
            key = (self.policy.prompt_bucket(max(len(row.chunk), 1)),
                   next_pow2(row.n_blocks))
            groups.setdefault(key, []).append(row)
        for group in groups.values():
            self._run_paged_extend_group(group, replay=replay)

    def _run_paged_extend_group(self, rows, replay=False):
        pool = self.kv_pool
        n = len(rows)
        B = self.policy.batch_bucket(n)
        Sc = self.policy.prompt_bucket(max(len(r.chunk)
                                           for r in rows))
        limit = self._max_position
        if limit is not None:
            Sc = min(Sc, limit)
        T = next_pow2(max(r.n_blocks for r in rows))
        tables = numpy.zeros((B, T), numpy.int32)
        tokens = numpy.zeros((B, Sc), numpy.int32)
        prior = numpy.zeros(B, numpy.int32)
        clens = numpy.ones(B, numpy.int32)
        temps = numpy.zeros(B, numpy.float32)
        seeds = numpy.zeros(B, numpy.uint32)
        for at, row in enumerate(rows):
            req = row.req
            tables[at, :row.n_blocks] = row.table
            tokens[at, :len(row.chunk)] = row.chunk
            prior[at] = row.prior
            clens[at] = len(row.chunk)
            temps[at] = req.temperature
            seeds[at] = (req.seed + row.row_idx) & 0xFFFFFFFF
        t0 = time.monotonic()
        resilience.effective(self.injector).check(
            "serve.device_fault")
        tok0 = self.model.paged_extend(pool, tables, tokens, prior,
                                       clens, temps, seeds)
        dt = time.monotonic() - t0
        self.stats.observe_batch("prefill", n, dt)
        # Prefill cost is what a queued generate request waits on —
        # it feeds the "generate" drain estimate.
        self._note_ewma("generate", dt)
        for at, row in enumerate(rows):
            row.pos = row.prior + len(row.chunk)
            if replay and row.gen:
                row.tok = row.gen[-1]
            else:
                row.tok = int(tok0[at])
                row.gen = [row.tok]

    def _paged_step_once(self):
        """Advance every active decode row — the heart of
        iteration-level scheduling: rows of different requests, ages,
        and lengths share the call; finished rows retire immediately
        and new requests are adopted at the next boundary.  With
        speculation on, rows holding draft proposals ride ONE
        ``paged_verify`` dispatch (up to K+1 tokens each) while the
        rest ride the plain one-token ``paged_step`` — both pinned at
        ``max_batch`` rows, so the spec/plain mix never recompiles
        the hot programs."""
        progress = {}
        for row in self._rows:
            req = row.req
            if req.deadline is not None and req.deadline.expired:
                progress[req] = max(progress.get(req, 0),
                                    len(row.gen or ()))
        for req, done in progress.items():
            self.stats.incr("cancelled.deadline")
            self._fail_req(req, DeadlineExceeded(
                "deadline expired after %d of %d tokens" %
                (done, req.max_new)))
        rows = list(self._rows)
        if not rows:
            self._update_gauges()
            return
        spec_rows = self._plan_drafts(rows) \
            if self.spec_mode != "off" else []
        if spec_rows:
            # EVERY active row rides the one verify dispatch — rows
            # without drafts as zero-draft columns (column 0 IS a
            # plain step), so a mixed spec/plain batch never pays a
            # second dispatch.
            ok = self._verify_once(rows)
        else:
            ok = self._plain_step_once(rows)
        if ok:
            self._update_gauges()

    def _shed_unwritable(self, rows, span_of):
        """Grows every row's table to its write span (``span_of(row)``
        = the last position this dispatch writes).  Structurally
        this cannot fail — admission reserves the worst case — but
        if it ever does, the whole REQUEST is shed with the
        door-time 429, and every sibling row of a shed request is
        dropped from the batch too: ``_fail_req`` nulls their
        tables, and dispatching a nulled row would kill the device
        thread.  Returns the dispatchable rows."""
        pool = self.kv_pool
        failed = set()
        for row in rows:
            if row.req in failed:
                continue
            if not self._ensure_writable(pool, row, span_of(row)):
                failed.add(row.req)
        if not failed:
            return rows
        with self._cond:
            retry = self._pool_retry_locked()
        for req in failed:
            self.stats.incr("rejected.pool_exhausted")
            self._fail_req(req, PoolExhausted(
                "KV pool exhausted growing a decode row",
                retry_after=retry))
        return [r for r in rows if r.req not in failed]

    def _plain_step_once(self, rows):
        """One-token decode for rows without accepted drafts.
        Returns False after a device fault (recovery ran)."""
        pool = self.kv_pool
        rows = self._shed_unwritable(rows, lambda row: row.pos)
        if not rows:
            return True
        n = len(rows)
        # The step batch is PINNED at max_batch (pad rows carry
        # all-trash tables): the active-row count changes at every
        # join/retire boundary, so one static width per table bucket
        # keeps the hottest program at a fixed, warmed set of
        # shapes.
        B = self.max_batch
        T = next_pow2(max(r.n_blocks for r in rows))
        tables = numpy.zeros((B, T), numpy.int32)
        pos = numpy.zeros(B, numpy.int32)
        tok = numpy.zeros(B, numpy.int32)
        gen_idx = numpy.zeros(B, numpy.int32)
        temps = numpy.zeros(B, numpy.float32)
        seeds = numpy.zeros(B, numpy.uint32)
        for at, row in enumerate(rows):
            req = row.req
            tables[at, :row.n_blocks] = row.table
            pos[at] = row.pos
            tok[at] = row.tok
            gen_idx[at] = len(row.gen)
            temps[at] = req.temperature
            seeds[at] = (req.seed + row.row_idx) & 0xFFFFFFFF
        t0 = time.monotonic()
        try:
            resilience.effective(self.injector).check(
                "serve.device_fault")
            new_tok = self.model.paged_step(pool, tables, pos, tok,
                                            gen_idx, temps, seeds)
        except Exception as e:
            self.exception("paged decode step failed")
            self._supervised_recover(rows, e)
            return False
        dt = time.monotonic() - t0
        self.stats.observe_batch("decode", n, dt)
        self.stats.observe_latency("itl.decode", dt)
        self._note_ewma("decode", dt)
        self.stats.note_tokens(n)
        self.stats.incr("tokens.generated", n)
        finished = []
        for at, row in enumerate(rows):
            row.tok = int(new_tok[at])
            row.gen.append(row.tok)
            if row.spec is not None:
                row.spec.extend_ctx([row.tok])
            row.pos += 1
            if len(row.gen) >= row.req.max_new:
                finished.append(row)
        for row in finished:
            self._retire_row(row)
        return True

    # -- speculative decoding ----------------------------------------------

    def _spec_adopt(self, rows):
        """Arms speculation for freshly adopted rows: the host-side
        context buffer prompt-lookup matches against, and — under
        the draft-model drafter — a mirror row prefilled through the
        draft pool in ONE coalesced extend.  Failures degrade rows
        to plain decode, never the requests."""
        for row in rows:
            req = row.req
            st = SpecState(self.spec_max_k,
                           req.length + req.max_new)
            st.extend_ctx(req.tokens[row.row_idx][:req.length])
            st.extend_ctx([row.tok])
            row.spec = st
        if self.spec_mode != "draft":
            return
        pool = self.draft_pool
        armed = []
        for row in rows:
            n = pool.blocks_for(row.req.length)
            ids = pool.alloc(n)
            if ids is None:
                # Draft blocks are not admission-reserved — a full
                # draft pool degrades the row to plain decode.
                self.stats.incr("spec.draft_degraded")
                continue
            row.draft_row = _DraftRow(ids, n)
            armed.append(row)
        if armed:
            self._draft_prefill(armed)

    def _draft_prefill(self, rows, chunks=None):
        """Coalesced draft-pool prefill, grouped by (chunk, table)
        bucket exactly like the target's :meth:`_run_paged_extend`
        — a 1-token catch-up chunk beside a long fresh prompt would
        otherwise mint an unbounded shape set on the DRAFT
        model's cache too.  ``chunks`` (default: each row's full
        prompt) land at each row's draft cursor.  On a draft fault
        the drafter is degraded to n-gram and the target rows keep
        decoding untouched."""
        if chunks is None:
            chunks = {id(row): row.req.tokens[row.row_idx]
                      [:row.req.length] for row in rows}
        groups = {}
        for row in rows:
            key = (self.policy.prompt_bucket(
                       max(len(chunks[id(row)]), 1)),
                   next_pow2(row.draft_row.n_blocks))
            groups.setdefault(key, []).append(row)
        for group in groups.values():
            if not self._draft_prefill_group(group, chunks):
                return False
        return True

    def _draft_prefill_group(self, rows, chunks):
        pool = self.draft_pool
        n = len(rows)
        B = self.policy.batch_bucket(n)
        Sc = self.policy.prompt_bucket(
            max(len(chunks[id(r)]) for r in rows))
        limit = self._max_position
        if limit is not None:
            Sc = min(Sc, limit)
        T = next_pow2(max(r.draft_row.n_blocks for r in rows))
        tables = numpy.zeros((B, T), numpy.int32)
        tokens = numpy.zeros((B, Sc), numpy.int32)
        prior = numpy.zeros(B, numpy.int32)
        clens = numpy.ones(B, numpy.int32)
        temps = numpy.zeros(B, numpy.float32)
        seeds = numpy.zeros(B, numpy.uint32)
        for at, row in enumerate(rows):
            drow = row.draft_row
            chunk = chunks[id(row)]
            tables[at, :drow.n_blocks] = drow.table
            tokens[at, :len(chunk)] = chunk
            prior[at] = drow.pos
            clens[at] = len(chunk)
        try:
            # The sampled token is discarded: the draft only ever
            # proposes from the target's REAL tokens.
            self.draft_model.paged_extend(pool, tables, tokens,
                                          prior, clens, temps, seeds)
        except Exception:
            self.exception("draft prefill failed")
            self._degrade_draft(rows)
            return False
        for at, row in enumerate(rows):
            row.draft_row.pos = int(prior[at]) + int(clens[at])
            row.draft_row.tok = row.tok
        return True

    def _degrade_draft(self, rows=None):
        """A draft-model dispatch failed: release every mirror row
        and fall back to the free n-gram drafter — speculation stays
        on, the broken draft pool is out of the loop, and the target
        streams never notice (drafts are proposals, not truth)."""
        self.stats.incr("spec.draft_faults")
        self.warning("draft-model drafter failed — degrading to the "
                     "n-gram drafter")
        with self._cond:
            live = list(self._rows)
        for row in set(live).union(rows or ()):
            self._release_draft(row)
        self.spec_mode = "ngram"
        self.draft_pool = None

    def _plan_drafts(self, rows):
        """Draft proposals for this round: host-side n-gram matching
        (no device work) or K batched greedy draft-model steps.  Returns the
        rows that ride ``paged_verify``; each has its table grown to
        cover the verify span (a row the pool cannot cover decodes
        plain this round)."""
        t0 = time.monotonic()
        pool = self.kv_pool
        want = []
        for row in rows:
            st = row.spec
            if st is None:
                continue
            st.drafts = None
            remaining = row.req.max_new - len(row.gen)
            if remaining <= 1:
                continue
            k = min(st.budget(self.spec_max_k, self.spec_adaptive),
                    remaining - 1)
            if k >= 1:
                want.append((row, k))
        if not want or not self._spec_gate(rows, want):
            return []
        if self.spec_mode == "draft":
            proposals = self._draft_model_propose(
                [rw for rw, _k in want],
                max(k for _rw, k in want))
            for row, k in want:
                d = proposals.get(id(row))
                if d is not None and len(d):
                    row.spec.drafts = d[:k]
        else:
            for row, k in want:
                st = row.spec
                d = self._drafter.propose(st.ctx, st.n_ctx, k)
                if len(d):
                    st.drafts = d
        out = []
        for row, _k in want:
            st = row.spec
            if st.drafts is None:
                continue
            if not self._ensure_writable(pool, row,
                                         row.pos + len(st.drafts)):
                st.drafts = None
                continue
            out.append(row)
        if out:
            self._note_spec_gauge("spec.draft_ms",
                                  (time.monotonic() - t0) * 1000.0)
        return out

    #: Assumed verify/step dispatch-cost ratio before both EWMAs
    #: have real signal.
    SPEC_COST_RATIO = 2.5
    #: Gated-off iterations before one forced verify round — keeps
    #: the acceptance estimates fresh so a stream that TURNS
    #: repetitive is rediscovered.
    SPEC_GATE_PROBE = 64
    #: Dispatches of each kind measured before their cost ratio takes
    #: the place of SPEC_COST_RATIO: one slow sample (a cold first call,
    #: a busy host) would otherwise close the gate for good, since a
    #: closed gate measures no more verifies.
    SPEC_GATE_MIN_SAMPLES = 3

    def _spec_gate(self, rows, want):
        """Iteration-level speculation gate: a verify dispatch costs
        ~(verify/decode cost ratio)× a plain step over the same
        pinned batch, so the EXPECTED accepted tokens (per-row draft
        budget × acceptance EWMA) must cover the premium for the
        whole riding batch; otherwise everyone plain-steps this
        round and the drafters (and the draft model's K dispatches)
        cost nothing."""
        v = self._batch_ewma.get("verify")
        s = self._batch_ewma.get("decode")
        seen = min(self._batch_samples.get("verify", 0),
                   self._batch_samples.get("decode", 0))
        ratio = (v / s) if v and s and \
            seen >= self.SPEC_GATE_MIN_SAMPLES else self.SPEC_COST_RATIO
        a_est = sum(k * rw.spec.ewma for rw, k in want)
        need = max(0.0, ratio - 1.0) * len(rows)
        if a_est >= need or \
                self._spec_gate_skips >= self.SPEC_GATE_PROBE:
            self._spec_gate_skips = 0
            return True
        self._spec_gate_skips += 1
        return False

    def _draft_model_propose(self, rows, k_round):
        """``k_round`` batched greedy one-token steps through the
        draft model's own pool — K cheap dispatches propose K tokens
        for every drafting row at once.  Mirrors that fell behind
        the target (their row rode plain steps, or a recovery
        replay) are caught up with one coalesced draft extend first.
        Returns {id(row): tokens}; a draft fault degrades the
        drafter and proposes nothing this round."""
        pool = self.draft_pool
        rows = [r for r in rows if r.draft_row is not None]
        out = {}
        if not rows:
            return out
        stale, synced = [], []
        for row in rows:
            drow = row.draft_row
            if drow.pos > row.pos:
                # Mirror ran ahead (rejected drafts): junk past the
                # cursor is masked until overwritten — a cursor
                # reset IS the rewind.
                drow.pos = row.pos
                drow.tok = row.tok
                synced.append(row)
            elif drow.pos < row.pos:
                stale.append(row)
            else:
                drow.tok = row.tok
                synced.append(row)
        if stale:
            chunks = {}
            ok = []
            for row in stale:
                drow = row.draft_row
                chunk = row.spec.ctx[drow.pos:row.pos]
                if self._ensure_writable(pool, drow, row.pos - 1):
                    chunks[id(row)] = chunk
                    ok.append(row)
                else:
                    self.stats.incr("spec.draft_degraded")
            if ok and not self._draft_prefill(ok, chunks=chunks):
                return {}
            synced.extend(r for r in ok
                          if r.draft_row is not None)
        rows = [r for r in synced if r.draft_row is not None]
        if not rows:
            return out
        out = {id(r): [] for r in rows}
        B = self.max_batch
        try:
            for _j in range(int(k_round)):
                live = []
                for row in rows:
                    drow = row.draft_row
                    if self._ensure_writable(pool, drow, drow.pos):
                        live.append(row)
                    else:
                        self.stats.incr("spec.draft_degraded")
                rows = live
                if not rows:
                    break
                T = next_pow2(max(r.draft_row.n_blocks
                                  for r in rows))
                tables = numpy.zeros((B, T), numpy.int32)
                pos = numpy.zeros(B, numpy.int32)
                tok = numpy.zeros(B, numpy.int32)
                gidx = numpy.zeros(B, numpy.int32)
                temps = numpy.zeros(B, numpy.float32)  # greedy
                seeds = numpy.zeros(B, numpy.uint32)
                for at, row in enumerate(rows):
                    drow = row.draft_row
                    tables[at, :drow.n_blocks] = drow.table
                    pos[at] = drow.pos
                    tok[at] = drow.tok
                new = self.draft_model.paged_step(
                    pool, tables, pos, tok, gidx, temps, seeds)
                for at, row in enumerate(rows):
                    drow = row.draft_row
                    drow.pos += 1
                    drow.tok = int(new[at])
                    out[id(row)].append(drow.tok)
        except Exception:
            self.exception("draft-model drafting failed")
            self._degrade_draft(rows)
            return {}
        return {key: numpy.asarray(v, numpy.int32)
                for key, v in out.items()}

    def _verify_once(self, rows):
        """One ``paged_verify`` dispatch for the WHOLE active batch:
        rows holding drafts score current + K draft positions, rows
        without ride as zero-draft columns (their column 0 is
        exactly a plain step).  The target accepts each row's
        longest prefix matching its own sampled stream (greedy ⇒
        argmax ⇒ bit-identical to plain decode), emits the bonus
        token, and REWINDS — rejected positions roll the write
        cursor back and whole rejected blocks return to the pool.
        Returns False after a device fault (supervised recovery
        ran)."""
        pool = self.kv_pool

        def span_of(row):
            st = row.spec
            d = st.drafts if st is not None else None
            return row.pos + (len(d) if d is not None else 0)

        rows = self._shed_unwritable(rows, span_of)
        if not rows:
            return True
        n = len(rows)
        B = self.max_batch
        K = self.spec_max_k
        tables = numpy.zeros((B, next_pow2(max(r.n_blocks
                                               for r in rows))),
                             numpy.int32)
        pos = numpy.zeros(B, numpy.int32)
        toks = numpy.zeros((B, K + 1), numpy.int32)
        drafts = numpy.zeros((B, K), numpy.int32)
        dlens = numpy.zeros(B, numpy.int64)
        gen_idx = numpy.zeros(B, numpy.int32)
        temps = numpy.zeros(B, numpy.float32)
        seeds = numpy.zeros(B, numpy.uint32)
        for at, row in enumerate(rows):
            req = row.req
            st = row.spec
            d = st.drafts if st is not None and \
                st.drafts is not None else NO_DRAFTS
            tables[at, :row.n_blocks] = row.table
            pos[at] = row.pos
            toks[at, 0] = row.tok
            toks[at, 1:1 + len(d)] = d
            drafts[at, :len(d)] = d
            dlens[at] = len(d)
            gen_idx[at] = len(row.gen)
            temps[at] = req.temperature
            seeds[at] = (req.seed + row.row_idx) & 0xFFFFFFFF
        t0 = time.monotonic()
        try:
            resilience.effective(self.injector).check(
                "serve.device_fault")
            target = self.model.paged_verify(pool, tables, pos, toks,
                                             dlens, gen_idx, temps,
                                             seeds)
        except Exception as e:
            self.exception("speculative verify failed")
            self._supervised_recover(rows, e)
            return False
        dt = time.monotonic() - t0
        self.stats.observe_batch("verify", n, dt)
        # Keyed on DISPATCH kind: a K+1-wide verify costs more than
        # a one-token step, and folding it into the "decode" EWMA
        # would poison the Retry-After quotes non-speculative
        # clients get.
        self._note_ewma("verify", dt)
        acc = accept_lengths(drafts[:n], dlens[:n], target[:n])
        emitted = 0
        accepted_total = 0
        drafted_total = 0
        rewound = 0
        finished = []
        for at, row in enumerate(rows):
            st = row.spec
            a = int(acc[at])
            d = st.drafts if st is not None and \
                st.drafts is not None else NO_DRAFTS
            new_toks = [int(t) for t in d[:a]]
            new_toks.append(int(target[at, a]))
            row.gen.extend(new_toks)
            row.pos += a + 1
            row.tok = new_toks[-1]
            rewound += self._rewind_row_table(pool, row)
            if st is not None:
                st.drafts = None
                st.extend_ctx(new_toks)
                st.update(a, len(d), self.spec_max_k,
                          self.spec_adaptive)
            emitted += a + 1
            accepted_total += a
            drafted_total += len(d)
            if len(row.gen) >= row.req.max_new:
                finished.append(row)
        # ITL stays a PER-TOKEN gap: a verify advances each riding
        # row by (accepted+1) tokens in one dispatch, so the honest
        # inter-token sample is the dispatch wall over the average
        # tokens emitted — not the raw dispatch wall, which would
        # read as a latency REGRESSION exactly when speculation is
        # winning.
        self.stats.observe_latency("itl.decode",
                                   dt * n / max(emitted, 1))
        self.stats.note_tokens(emitted)
        self.stats.incr("tokens.generated", emitted)
        self.stats.incr("spec.drafted", drafted_total)
        self.stats.incr("spec.accepted", accepted_total)
        self.stats.incr("spec.rounds")
        if rewound:
            self.stats.incr("spec.rewound_blocks", rewound)
        self._note_spec_round(accepted_total, drafted_total,
                              emitted, n, dt)
        for row in finished:
            self._retire_row(row)
        return True

    def _note_spec_round(self, accepted, drafted, emitted, rows, dt):
        """EWMA speculative gauges after one verify round — the
        ``serving.spec.*`` family on /stats, /metrics, and the live
        serving summary."""
        rate = accepted / float(max(drafted, 1))
        ewma = self._spec_accept_ewma
        self._spec_accept_ewma = rate if ewma is None \
            else 0.8 * ewma + 0.2 * rate
        tps = emitted / float(max(rows, 1))
        ewma = self._spec_tps_ewma
        self._spec_tps_ewma = tps if ewma is None \
            else 0.8 * ewma + 0.2 * tps
        self.stats.set_gauge("spec.accept_rate",
                             round(self._spec_accept_ewma, 4))
        self.stats.set_gauge("spec.mean_accepted_len",
                             round(accepted / float(max(rows, 1)),
                                   3))
        self.stats.set_gauge("spec.tokens_per_step",
                             round(self._spec_tps_ewma, 3))
        self._note_spec_gauge("spec.verify_ms", dt * 1000.0)

    def _note_spec_gauge(self, name, ms):
        prev = self.stats.gauge(name)
        value = ms if prev is None else 0.8 * prev + 0.2 * ms
        self.stats.set_gauge(name, round(value, 3))

    def _ensure_writable(self, pool, row, last_write_pos):
        """Grows ``row``'s table to cover write positions up to
        ``last_write_pos`` (lazy allocation: one block at a time as
        decode advances) and COW-unshares the block the next write
        lands in if anyone else holds it — writes must only ever
        touch exclusively-owned blocks.  Returns False when the pool
        cannot supply the blocks (structurally rare: admission holds
        a worst-case reservation and ``alloc`` evicts cached
        prefixes first)."""
        bs = pool.block_size
        idx = row.pos // bs
        with self._cond:
            table = row.table
        if table is None:
            return False  # concurrently failed/retired elsewhere
        if idx < row.n_blocks and pool.refs_of(table[idx]) > 1:
            # The locked snapshot, NOT row.table — a stop() that
            # outlives the thread join can null row.table between
            # the check above and this read.
            fresh = pool.cow_copy(table[idx])
            if fresh is None:
                return False
            with self._cond:
                if row.table is None:
                    pool.release([fresh])
                    return False
                old, row.table[idx] = row.table[idx], fresh
            pool.release([old])
        needed = int(last_write_pos) // bs + 1
        if needed <= row.n_blocks:
            return True
        fresh = pool.alloc(needed - row.n_blocks)
        if fresh is None:
            return False
        with self._cond:
            if row.table is None:
                pool.release(fresh)
                return False
            row.table.extend(fresh)
            row.n_blocks = needed
        return True

    def _rewind_row_table(self, pool, row):
        """Truncates the table past the block the next write lands
        in — rejected speculative blocks go back to the pool at this
        very boundary (the pool is the scarce resource; a waiting
        request can take them before this row needs them again)."""
        keep = row.pos // pool.block_size + 1
        with self._cond:
            if row.table is None or keep >= row.n_blocks:
                return 0
            drop = row.table[keep:]
            del row.table[keep:]
            row.n_blocks = keep
        pool.release(drop)
        return len(drop)

    def _release_draft(self, row):
        """Releases a row's draft-pool mirror exactly once (the
        draft twin of :meth:`_release_row_blocks`)."""
        drow = row.draft_row
        if drow is None:
            return
        with self._cond:
            table, drow.table = drow.table, None
        row.draft_row = None
        if table is not None and self.draft_pool is not None:
            self.draft_pool.release(table)

    def _release_row_blocks(self, row):
        """Releases a row's table exactly once (claimed under the
        engine lock) — a row can reach both the retire and fail
        paths (e.g. a stop() that outwaits a stuck device call
        racing the step's own retirement), and a double release
        would corrupt the pool's refcounts."""
        with self._cond:
            table, row.table = row.table, None
        if table is not None:
            self.kv_pool.release(table)
            return True
        return False

    def _retire_row(self, row):
        """A row met its budget: free its blocks NOW (the pool is
        the scarce resource; the next waiting request can take them
        at this very boundary) and complete the request once its
        last row lands.  Claiming the table, leaving the batch, and
        the reservation/rows_done accounting are ONE locked step, so
        a concurrent _fail_req can never double-count the row."""
        req = row.req
        with self._cond:
            table, row.table = row.table, None
            if table is None:
                return  # already retired/failed elsewhere
            if row in self._rows:
                self._rows.remove(row)
            self._kv_committed -= req.kv_commit // req.rows
            req.rows_done += 1
        self.kv_pool.release(table)
        self._release_draft(row)
        req.row_results[row.row_idx] = row.gen
        if req.rows_done < req.rows:
            return
        gen = numpy.asarray(req.row_results, dtype=numpy.int32)
        req.result = numpy.concatenate([req.tokens, gen], axis=1)
        req.event.set()

    def _fail_req(self, req, error):
        """Error path: drop every row of the request from the decode
        batch, free blocks + reservation, wake the submitter."""
        tables = []
        with self._cond:
            mine = [r for r in self._rows if r.req is req]
            for row in mine:
                self._rows.remove(row)
                table, row.table = row.table, None
                if table is not None:
                    tables.append(table)
            self._kv_committed -= req.kv_commit * \
                (req.rows - req.rows_done) // req.rows
        for table in tables:
            self.kv_pool.release(table)
        for row in mine:
            self._release_draft(row)
        if req.error is None:
            req.error = error
        req.event.set()

    # -- supervised decode recovery ----------------------------------------

    #: Breaker-state gauge encoding for ``serving.breaker_state``.
    BREAKER_STATES = {"closed": 0, "rebuilding": 1, "tripped": 2}

    def _supervised_recover(self, rows, error):
        """A paged device call failed mid-decode.  The pool's device
        storage is in an undefined (half-written) state, so it is
        rebuilt anew — but live requests are NOT failed: each
        generate request holds its prompt and every emitted token, so
        after the rebuild surviving rows are re-adopted by replaying
        prompt+emitted through ``paged_extend`` and decode resumes
        TOKEN-IDENTICALLY (deadline- and replay-budget-aware).  The
        circuit breaker answers new submissions with 503 +
        ``Retry-After`` while rebuilding, and trips to permanent-fail
        past ``breaker_limit`` rebuilds per ``breaker_window``
        seconds — a device faulting that often is not recovering."""
        pool = self.kv_pool
        now = time.monotonic()
        with self._cond:
            all_rows = list(self._rows)
            for row in rows:
                if row not in all_rows:
                    all_rows.append(row)
            self._rows = []
            for row in all_rows:
                # Claim every table: the ids reference the pool
                # generation being discarded — releasing them into
                # the REBUILT pool would corrupt its accounting.
                row.table = None
            # The recovery window counts as LIVE work: _rows is
            # empty until re-adoption lands, and a concurrent
            # drain/quiesce poll reading 0 here would hard-stop and
            # kill the streams the supervisor is about to save.
            self._busy = True
            self._rebuilds.append(now)
            while self._rebuilds and \
                    self._rebuilds[0] < now - self.breaker_window:
                self._rebuilds.popleft()
            tripped = len(self._rebuilds) > self.breaker_limit
            self._breaker = "tripped" if tripped else "rebuilding"
        try:
            self._recover_locked_out(all_rows, error, pool, tripped)
        finally:
            with self._cond:
                self._busy = False
                self._cond.notify_all()

    def _recover_locked_out(self, all_rows, error, pool, tripped):
        """The body of :meth:`_supervised_recover` past the row
        claim, split out so the ``_busy`` window wraps it exactly."""
        if tripped:
            self.warning(
                "circuit breaker TRIPPED: %d KV pool rebuilds inside "
                "%.0f s — failing live paged work permanently",
                len(self._rebuilds), self.breaker_window)
            self.stats.incr("breaker.trips")
            for row in all_rows:
                self._release_draft(row)
            for req in {row.req for row in all_rows}:
                self._fail_req(req, error)
            with self._cond:
                waiting = list(self._paged_wait)
                self._paged_wait.clear()
                for req in waiting:
                    self._kv_committed -= req.kv_commit
            for req in waiting:
                req.error = ServiceUnavailable(
                    "circuit breaker tripped after repeated device "
                    "faults")
                req.event.set()
            self._update_gauges()
            return
        self.warning("device fault during paged decode (%s) — "
                     "rebuilding the KV pool, re-adopting %d live "
                     "row(s)", error, len(all_rows))
        self.stats.incr("kv.pool.resets")
        self.stats.incr("breaker.rebuilds")
        self.kv_pool = self.model.make_kv_pool(
            pool.n_blocks, pool.block_size, kv_dtype=pool.kv_dtype)
        by_req = {}
        for row in all_rows:
            by_req.setdefault(row.req, []).append(row)
        replayable = []
        for req, req_rows in by_req.items():
            req.replays += 1
            if req.deadline is not None and req.deadline.expired:
                self.stats.incr("cancelled.deadline")
                for row in req_rows:
                    self._release_draft(row)
                self._fail_req(req, DeadlineExceeded(
                    "deadline expired during KV pool rebuild"))
            elif req.replays > self.max_replays:
                self.stats.incr("readopt.exhausted")
                for row in req_rows:
                    self._release_draft(row)
                self._fail_req(req, error)
            else:
                replayable.extend(req_rows)
        self._readopt_rows(replayable)
        with self._cond:
            if self._breaker == "rebuilding":
                self._breaker = "closed"
            self._cond.notify_all()
        self._update_gauges()

    def _readopt_rows(self, rows):
        """Replays surviving rows into the REBUILT pool: each row's
        chunk is its prompt plus every emitted token but the last, so
        one ``paged_extend`` recomputes exactly the k/v the dead pool
        held; the freshly sampled token is discarded (``replay=True``
        — the request already holds it) and the next decode step
        samples with PRNG fold index ``len(gen)``, the same stream
        position the uninjected run would use.  A request that
        cannot be re-seated (pool too fragmented — structurally rare,
        reservations are still held) fails atomically."""
        if not rows:
            return 0
        pool = self.kv_pool
        ok = []
        failed = {}
        for row in rows:
            req = row.req
            if req in failed:
                continue
            tokens_row = numpy.asarray(req.tokens[row.row_idx],
                                       dtype=numpy.int32)
            emitted = list(row.gen or ())
            if emitted:
                chunk = numpy.concatenate(
                    [tokens_row[:req.length],
                     numpy.asarray(emitted[:-1], numpy.int32)])
            else:
                chunk = tokens_row[:req.length]
            total_blocks = pool.blocks_for(max(len(chunk), 1))
            fresh = pool.alloc(total_blocks)
            if fresh is None:
                failed[req] = ServiceUnavailable(
                    "KV pool exhausted during re-adoption",
                    retry_after=1.0)
                continue
            row.table = fresh
            row.n_blocks = total_blocks
            row.prior = 0
            row.chunk = chunk
            row.prefix_chain = None
            ok.append(row)
        if failed:
            for row in list(ok):
                if row.req in failed:
                    ok.remove(row)
                    self._release_row_blocks(row)
                    self._release_draft(row)
            for req, err in failed.items():
                self._fail_req(req, err)
        if not ok:
            return 0
        try:
            self._run_paged_extend(ok, replay=True)
        except Exception as e:
            # A second fault during recovery: the per-request replay
            # budget and the breaker bound the recursion.
            self.exception("re-adoption prefill failed")
            self._supervised_recover(ok, e)
            return 0
        self.stats.incr("readopt.rows", len(ok))
        retired = [r for r in ok if len(r.gen) >= r.req.max_new]
        live = [r for r in ok if len(r.gen) < r.req.max_new]
        if live:
            with self._cond:
                self._rows.extend(live)
        for row in retired:
            self._retire_row(row)
        return len(ok)

    def _recover_prefill_fault(self, rows, error):
        """Prefill hit a device fault: the adopting requests have no
        reliably-emitted tokens yet, so they go back to the FRONT of
        the wait queue (their block reservations stay held) and ride
        the normal adoption path once the pool is rebuilt; active
        decode rows are re-adopted by replay.  A request past its
        replay budget fails with the device error instead of
        requeueing forever."""
        reqs = []
        with self._cond:
            for row in rows:
                row.table = None  # dead pool generation
                if row.req not in reqs:
                    reqs.append(row.req)
        requeue = []
        for req in reqs:
            req.replays += 1
            if req.replays > self.max_replays:
                self.stats.incr("readopt.exhausted")
                self._fail_req(req, error)
            else:
                requeue.append(req)
        with self._cond:
            for req in reversed(requeue):
                self._paged_wait.appendleft(req)
        self._supervised_recover([], error)

    def _update_gauges(self):
        self.stats.set_gauge("breaker_state",
                             self.BREAKER_STATES[self._breaker])
        pool = self.kv_pool
        if pool is None:
            return
        occ = pool.occupancy()
        self.stats.set_gauge("kv_blocks_used", occ["blocks_used"])
        self.stats.set_gauge("kv_blocks_total", occ["blocks_total"])
        self.stats.set_gauge("kv_bytes_used", occ["bytes_used"])
        self.stats.set_gauge("kv_bytes_total", occ["bytes_total"])
        self.stats.set_gauge("decode_rows", len(self._rows))

    # -- warmup ------------------------------------------------------------

    #: The HTTP handler's default max_new_tokens — warmup must cover
    #: the decode bucket a no-field /api/generate request reaches.
    DEFAULT_MAX_NEW = 32

    def warmup(self, longest_prompt=None, max_new=None):
        """Walks the bucket grid once so the first real request finds
        its shapes seen (kernel library loaded, allocator warm; the
        ``warmup.compiles`` counter keeps the JAX package's name for
        the entry points warmed).  Dense classify models warm the
        batch-bucket dim; LM artifacts (``max_position`` known) warm
        the generate grid — the (batch × prompt × decode) dense
        buckets, or under paged decode the (batch × chunk × table)
        extend programs plus the (batch × table) step programs.
        Returns the number of entry points warmed."""
        manifest = getattr(self.model, "manifest", None)
        compiles = 0
        self._grow_compile_cache(longest_prompt, max_new)
        if manifest:
            features = int(numpy.prod(
                manifest["input"]["sample_shape"]))
            fwd = getattr(self.model, "forward_bucketed", None)
            for b, _, _ in self.policy.grid():
                x = numpy.zeros((1, features), numpy.float32)
                try:
                    if fwd is not None:
                        fwd(x, b)
                    else:
                        self.model.forward(numpy.zeros(
                            (b, features), numpy.float32))
                    compiles += 1
                except Exception as e:
                    self.warning("classify warmup (batch %d) "
                                 "failed: %s", b, e)
                    break
        limit = self._max_position
        if not limit:
            self.stats.incr("warmup.compiles", compiles)
            return compiles
        if max_new is None:
            max_new = self.DEFAULT_MAX_NEW
        longest = longest_prompt or max(1, limit - max_new)
        if self.paged:
            compiles += self._warmup_paged(longest, max_new)
        elif getattr(self.model, "generate_bucketed", None) \
                is not None:
            for b, s, m in self.policy.grid(longest, max_new):
                s = min(s, limit)
                prompts = numpy.zeros((b, s), numpy.int32)
                lengths = numpy.ones(b, numpy.int32)
                try:
                    self.model.generate_bucketed(
                        prompts, lengths, m,
                        numpy.zeros(b, numpy.float32),
                        numpy.zeros(b, numpy.int64))
                    compiles += 1
                except Exception as e:
                    self.warning("generate warmup (%d, %d, %d) "
                                 "failed: %s", b, s, m, e)
                    break
        self.stats.incr("warmup.compiles", compiles)
        if compiles:
            self.info("warmup precompiled %d bucket entry points",
                      compiles)
        return compiles

    def _paged_warm_keys(self, longest, max_new):
        """The paged warmup grid: extend keys (batch, chunk, table)
        for every (batch, prompt) bucket pair — tables are LAZY, so
        an adoption's table covers the prompt span only — and step
        keys for EVERY power-of-two table width up to the pool's
        full span: a runtime table bucket is always one of those,
        whatever mix of lengths and growth phases is in flight.
        (Prefix-hit extends — short chunk over a longer table — can
        still miss on first occurrence.)
        """
        pool = self._ensure_pool()
        limit = self._max_position
        T_full = next_pow2(pool.blocks_for(limit))
        steps = []
        T = 1
        while T <= T_full:
            steps.append(T)
            T *= 2
        extends = []
        seen = set()
        s_min = min(self.policy.prompt_bucket(1), limit)
        T_longest = next_pow2(pool.blocks_for(min(longest, limit)))
        for b in self.policy.batch_buckets():
            # Fresh-prefill diagonal: chunk bucket with its own
            # table span.
            for s in self.policy.prompt_buckets(min(longest, limit)):
                s = min(s, limit)
                T = next_pow2(pool.blocks_for(s))
                if (b, s, T) not in seen:
                    seen.add((b, s, T))
                    extends.append((b, s, T))
            # Prefix-refeed family: a fully/mostly cached prompt
            # extends a SHORT chunk over its full-prompt table —
            # adoption groups by (chunk, table) bucket, so these are
            # the other reachable keys.
            for T in steps:
                if T > T_longest:
                    break
                if (b, s_min, T) not in seen:
                    seen.add((b, s_min, T))
                    extends.append((b, s_min, T))
        return extends, steps

    def _warmup_paged(self, longest, max_new):
        """Warm the paged grid against the trash block — pad
        geometry, junk content, so warmup costs compiles, not pool
        blocks."""
        pool = self._ensure_pool()
        compiles = 0
        extends, steps = self._paged_warm_keys(longest, max_new)
        try:
            for b, s, T in extends:
                self.model.paged_extend(
                    pool, numpy.zeros((b, T), numpy.int32),
                    numpy.zeros((b, s), numpy.int32),
                    numpy.zeros(b, numpy.int32),
                    numpy.ones(b, numpy.int32),
                    numpy.zeros(b, numpy.float32),
                    numpy.zeros(b, numpy.uint32))
                compiles += 1
            for T in steps:
                self.model.paged_step(
                    pool,
                    numpy.zeros((self.max_batch, T), numpy.int32),
                    numpy.zeros(self.max_batch, numpy.int32),
                    numpy.zeros(self.max_batch, numpy.int32),
                    numpy.zeros(self.max_batch, numpy.int32),
                    numpy.zeros(self.max_batch, numpy.float32),
                    numpy.zeros(self.max_batch, numpy.uint32))
                compiles += 1
            compiles += self._warmup_spec(steps)
        except Exception as e:
            self.warning("paged warmup failed after %d compiles: %s",
                         compiles, e)
        return compiles

    def _warmup_spec(self, steps):
        """Warm the speculative programs beside the step grid: one
        ``paged_verify`` per step-table width (same pinned batch,
        K+1 columns), and under the draft-model drafter the draft
        pool's own step widths — all against trash tables, costing
        compiles, not blocks."""
        if self.spec_mode == "off":
            return 0
        pool = self.kv_pool
        compiles = 0
        B = self.max_batch
        for T in steps:
            self.model.paged_verify(
                pool, numpy.zeros((B, T), numpy.int32),
                numpy.zeros(B, numpy.int32),
                numpy.zeros((B, self.spec_max_k + 1), numpy.int32),
                numpy.zeros(B, numpy.int32),
                numpy.zeros(B, numpy.int32),
                numpy.zeros(B, numpy.float32),
                numpy.zeros(B, numpy.uint32))
            compiles += 1
        if self.spec_mode != "draft":
            return compiles
        dpool = self.draft_pool
        T_full = next_pow2(dpool.blocks_for(self._max_position))
        T = 1
        while T <= T_full:
            self.draft_model.paged_step(
                dpool, numpy.zeros((B, T), numpy.int32),
                numpy.zeros(B, numpy.int32),
                numpy.zeros(B, numpy.int32),
                numpy.zeros(B, numpy.int32),
                numpy.zeros(B, numpy.float32),
                numpy.zeros(B, numpy.uint32))
            compiles += 1
            T *= 2
        return compiles

    def _grow_compile_cache(self, longest_prompt, max_new):
        """A compile cache smaller than the warmup grid would evict
        its own earliest compiles while warming (and thrash forever
        under traffic spread across the grid) — grow it to hold the
        whole reachable key set plus slack."""
        cache = getattr(self.model, "compile_cache", None)
        if cache is None or not hasattr(cache, "capacity"):
            return
        needed = len(self.policy.grid())  # fwd shape sentinels
        limit = self._max_position
        if limit:
            m = self.DEFAULT_MAX_NEW if max_new is None else max_new
            longest = longest_prompt or max(1, limit - m)
            if self.paged:
                # the exact warm key sets + the copy program (and
                # the verify program per step width when
                # speculating).
                extends, steps = self._paged_warm_keys(longest, m)
                needed += len(extends) + len(steps) + 1
                if self.spec_mode != "off":
                    needed += len(steps)
            else:
                needed += len(self.policy.grid(longest, m))
        needed += 8  # non-bucketed generate() headroom
        if cache.capacity < needed:
            self.info("compile cache capacity %d -> %d (warmup grid)",
                      cache.capacity, needed)
            cache.capacity = needed
        if self.spec_mode == "draft":
            dcache = getattr(self.draft_model, "compile_cache", None)
            if dcache is not None and \
                    hasattr(dcache, "capacity") and \
                    dcache.capacity < needed:
                dcache.capacity = needed
