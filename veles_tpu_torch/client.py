"""Worker (slave) side of the distributed job protocol (the JAX
package's ``client``): a reconnecting client — handshake with the
workflow checksum, machine id, pid and computing power; the job loop
job_request → ``do_job`` → update, plain or pipelined
(``--async-slave``); bounded reconnects on a seeded backoff; the
``--slave-death-probability`` and chaos-plan faults; a planned
departure on SIGTERM (``--preempt-grace``); and periodic re-measurement
of its computing power.

On a trace session (the master traces and grants the ``trace``
capability the worker advertises) the worker turns its span collector
on, estimates the master's clock offset from the timestamps of the
master's replies (:class:`~veles_tpu_torch.observability.tracing
.ClockSync`), runs each job inside a ``worker.step`` span under the
master's ``server.dispatch`` context, and ships the job's spans back
with its update, shifted onto the master's clock.
"""

import collections
import os
import random
import threading
import time

from . import resilience
from .config import root, get as config_get
from .logger import Logger
from .network_common import (Channel, connect, machine_id,
                             normalize_secret)
from .observability import tracing
from .resilience import (HandshakeRejected, ProtocolError,
                         RetryPolicy, WorkerHang, WorkerKilled,
                         WorkerPreempted)

#: Wire capabilities this worker advertises in its handshake.  An old
#: master simply ignores the key.
WORKER_CAPS = {
    "tensor": True,        # tensor-framed messages
    "delta": True,         # delta weight sync (both directions)
    "block": True,         # multi-tick jobs (one block of ticks)
    "trace": True,         # span shipping + clock-sync timestamps
    "slots": True,         # ZeRO slot-shard sync (--net-zero)
    "codecs": ("none", "gzip"),
    "dtypes": ("fp32", "bf16", "int8"),
}


def init_parser(parser):
    """The worker's flags of the command line."""
    parser.add_argument(
        "--async-slave", action="store_true",
        help="pipeline worker jobs: request job N+1 before sending "
             "update N (higher utilization, staler gradients)")
    parser.add_argument(
        "--slave-death-probability", type=float, default=0.0,
        metavar="P", help="chaos testing: worker kills itself with "
                          "probability P per job")
    parser.add_argument(
        "--measure-power", action="store_true",
        help="benchmark this worker's computing power and report it "
             "to the coordinator (periodic re-measure included)")
    parser.add_argument(
        "--reconnect-attempts", type=int, default=None, metavar="N",
        help="consecutive failed reconnects before the worker gives "
             "up (default 20 ≈ 6-7 minutes of dialing, enough to "
             "survive a coordinator crash-resume restart)")
    parser.add_argument(
        "--reconnect-delay", type=float, default=None, metavar="SEC",
        help="base reconnect backoff in seconds (default 0.2; grows "
             "exponentially with seeded jitter, capped at 30s)")
    parser.add_argument(
        "--preempt-grace", type=float, default=None, metavar="SEC",
        help="planned-departure budget: on SIGTERM (spot preemption) "
             "the worker finishes its in-flight job, ships the "
             "update, sends the bye frame, and exits 0; past this "
             "many seconds the drain degrades to an abrupt drop and "
             "the master requeues the work (default 30)")


def install_sigterm_drain(client, grace=None):
    """SIGTERM → planned departure → exit 0 (the supervisor-facing
    preemption contract, mirroring the serving engine's
    ``serve.install_sigterm_drain``): the in-flight job finishes,
    the update ships, the ``bye`` frame goes out, and the worker
    process exits cleanly instead of dying mid-recv.  The drain runs
    on a helper thread — signal handlers must return quickly.
    ``grace`` overrides the client's ``--preempt-grace`` budget;
    past it the drain degrades to an abrupt drop (the master
    requeues, exactly as for a crash).  Returns the handler it
    replaced, for the caller to put back; a no-op returning None outside
    the main thread (tests drive clients from worker threads)."""
    import signal

    def on_term(_signum, _frame):
        threading.Thread(
            target=lambda: client.drain(
                client.preempt_grace if grace is None else grace),
            daemon=True, name="veles-sigterm-drain").start()

    try:
        return signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        return None  # not the main thread


def measure_computing_power(repeats=2, n=1024, device=None):
    """GEMM-throughput scalar used for load balancing: 1000 / the
    seconds of ``repeats`` ``n×n`` float32 products with
    ``torch.matmul`` on ``device`` (the worker's; the CPU when None)."""
    import torch
    from .memory import torch_device
    dev = torch_device(device)
    x = torch.ones((n, n), dtype=torch.float32, device=dev) / n
    y = torch.matmul(x, x)  # warm
    float(y[0, 0])
    t0 = time.time()
    for _ in range(repeats):
        y = torch.matmul(y, x)
    float(y[0, 0])
    return 1000.0 / max(time.time() - t0, 1e-6)


class Client(Logger):
    """Connects to a coordinator and executes jobs."""

    def __init__(self, address, workflow, **kwargs):
        super(Client, self).__init__()
        self.address = address
        self.workflow = workflow
        self.death_probability = kwargs.get("death_probability", 0.0)
        #: 20 consecutive failed attempts ≈ 6-7 minutes of dialing
        #: (exponential, capped at 30s): the crash-resume contract
        #: says workers outlive a coordinator restart (python + torch
        #: import + snapshot unpickle can take a minute), so the
        #: DEFAULT must cover that — the old default of 5 gave up
        #: after ~6 seconds.
        self.reconnect_attempts = kwargs.get("reconnect_attempts", 20)
        self.reconnect_delay = kwargs.get("reconnect_delay", 0.2)
        #: Reconnect schedule: exponential backoff + seeded jitter
        #: (replaces the old hand-rolled linear sleep loop).
        self.retry_policy = kwargs.get("retry_policy") or RetryPolicy(
            max_attempts=self.reconnect_attempts,
            base_delay=self.reconnect_delay)
        #: Fault injector (resilience.FaultInjector).  The legacy
        #: ``--slave-death-probability`` flag is folded in as a
        #: ``worker.kill%p`` rule — one chaos engine, one code path.
        self.injector = kwargs.get("injector")
        if self.death_probability:
            if self.injector is None:
                # Per-PROCESS seed: the legacy flag's random.random()
                # was independent per worker; a shared constant seed
                # would make the whole fleet draw identical kill
                # verdicts and die in lock-step.
                import uuid
                self.injector = resilience.FaultInjector(
                    seed=(uuid.getnode() * 1000003 + os.getpid())
                    & 0xFFFFFFFF)
            self.injector.add_rule(
                "worker.kill%%%g" % self.death_probability)
        #: True makes an injected worker.kill really exit the process
        #: (CLI workers under a supervisor); False (default) aborts
        #: the session and reconnects with a fresh id — process death
        #: + respawn collapsed into one object, which is what the
        #: in-process chaos tests need.
        self.death_exits = kwargs.get("death_exits", False)
        self.poll_delay = kwargs.get("poll_delay", 0.05)
        #: No-job poll schedule: jittered exponential backoff from
        #: ``poll_delay`` (replacing a fixed sleep — an idle fleet
        #: polling a paused master in lock-step is a self-inflicted
        #: thundering herd), reset by the next real job.  Own rng:
        #: idle-poll frequency is wall-clock-dependent, and drawing
        #: from the shared seeded resilience stream would shift its
        #: order and break chaos-replay determinism for everyone
        #: else.
        self.nojob_policy = kwargs.get("nojob_policy") or RetryPolicy(
            max_attempts=1 << 30, base_delay=self.poll_delay,
            factor=1.5, max_delay=2.0, rng=random.Random())
        self._nojob_streak = 0
        #: Legacy-protocol override (``--net-legacy``): the handshake
        #: advertises no capabilities, so the session runs
        #: pickle-compat regardless of the master's config.
        self.net_legacy = kwargs.get("net_legacy", False)
        self.power = kwargs.get("power") or 1.0
        self.measure_power = kwargs.get("measure_power", False)
        #: Shared-secret HMAC key for frame authentication.  Same
        #: precedence as the server: kwarg > VELES_NETWORK_SECRET env
        #: > workflow checksum (the checksum default blocks stray
        #: peers, not an attacker who has the workflow source).
        self._secret = normalize_secret(
            kwargs.get("secret") or
            os.environ.get("VELES_NETWORK_SECRET") or
            workflow.checksum)
        self.id = None
        self.jobs_done = 0
        self._stop = False
        #: Master-clock offset estimator: fed by the timestamps trace
        #: sessions carry on job-cycle replies; shipped spans are
        #: re-timestamped onto the master timeline with its best
        #: (minimum-RTT) estimate.
        self.clock = tracing.ClockSync()
        #: Pipelined mode (``--async-slave``): job N+1 is requested
        #: BEFORE job N's update is sent, so the network round trip
        #: overlaps local compute.
        self.async_mode = kwargs.get("async_mode", False)
        #: Periodic power re-measurement.
        self.power_interval = float(kwargs.get("power_interval", 60.0))
        self._power_measured = 0.0
        #: Planned-departure grace budget (``--preempt-grace``): how
        #: long a drain may take before it degrades to an abrupt
        #: drop (see :meth:`drain`).
        self.preempt_grace = kwargs.get("preempt_grace")
        if self.preempt_grace is None:
            self.preempt_grace = config_get(
                root.common.client.preempt_grace, 30.0)
        self._draining = False
        self._drain_done = threading.Event()
        #: The live channel (for the drain watchdog's degrade path:
        #: severing it makes the master see a dead peer and requeue).
        self._chan = None

    def stop(self):
        self._stop = True

    def drain(self, grace=None):
        """Begins a planned departure (SIGTERM, scale-down, the
        ``worker.preempt`` chaos fault): the in-flight job finishes,
        its update ships, the ``bye`` frame goes out, and
        :meth:`run` returns normally — the master records a clean
        retirement (``server.goodbye``), not a drop.  Past ``grace``
        seconds the drain degrades to today's crash handling: the
        channel is severed, the master requeues our in-flight work,
        and a CLI worker exits nonzero."""
        if self._draining:
            return
        self._draining = True
        resilience.stats.incr("client.drain")
        self.info("draining: finishing in-flight work, then leaving")
        if grace is not None and grace > 0:
            threading.Thread(target=self._drain_watchdog,
                             args=(grace,), daemon=True,
                             name="veles-drain-watchdog").start()

    def _drain_watchdog(self, grace):
        if self._drain_done.wait(grace):
            return
        self.warning("drain grace budget (%.1fs) exhausted — "
                     "degrading to an abrupt drop (the master "
                     "requeues our in-flight work)", grace)
        resilience.stats.incr("client.drain_expired")
        self._stop = True
        chan = self._chan
        if chan is not None:
            chan.close()
        if self.death_exits:
            os._exit(1)

    def _injector_(self):
        return resilience.effective(self.injector)

    def run(self):
        """Blocking job loop with bounded reconnects (connect →
        handshake → job cycle).  The
        reconnect schedule is the shared :class:`RetryPolicy`
        (exponential backoff + seeded jitter); the attempt counter
        resets on every successful handshake, so a long-lived worker
        survives any number of transient master outages."""
        try:
            self._run()
        finally:
            # Whatever the exit path — orderly bye, give-up, hard
            # stop — the drain is over; the grace watchdog must not
            # fire after it.
            self._drain_done.set()

    def _run(self):
        attempts = 0
        policy = self.retry_policy
        while not self._stop:
            chan = None
            try:
                self._injector_().check("net.connect")
                sock = connect(self.address, timeout=30.0)
                chan = Channel(sock, self._secret,
                               injector=self.injector)
                self._chan = chan
                if self._handshake(chan):
                    attempts = 0
                    cycle = (self._job_cycle_async if self.async_mode
                             else self._job_cycle)
                    if cycle(chan):
                        return  # orderly bye
            except HandshakeRejected as e:
                self.warning("%s — giving up (the coordinator is "
                             "alive; fix the mismatch and restart "
                             "this worker)", e)
                return
            except WorkerKilled:
                # Chaos.  The session dies abruptly — no bye — and
                # either the process really exits (CLI under a
                # supervisor) or the loop reconnects as a fresh worker,
                # modelling the respawn.
                self.warning("simulating slave death")
                resilience.stats.incr("client.death")
                if self.death_exits:
                    os._exit(1)
                self.id = None
            except WorkerHang as e:
                # Chaos: stall with the connection open — the
                # coordinator's adaptive-timeout watchdog must
                # blacklist us and requeue our job.
                self.warning("simulating worker hang")
                resilience.stats.incr("client.hang")
                self._sleep_interruptible(e.seconds)
            except ProtocolError as e:
                # Desynchronized delta session (missing/mismatched
                # base version): session-fatal, worker-recoverable —
                # reconnect with a fresh id; the master requeues our
                # in-flight work and rebases us with a full ship.
                self.warning("protocol desync: %s — reconnecting "
                             "with a fresh session", e)
                resilience.stats.incr("client.proto_desync")
                self.id = None
            except (OSError, ConnectionError) as e:
                # Connection-level OR job-local I/O failure: the
                # session is dead either way, but it must be VISIBLE —
                # a persistent local fault (dataset file deleted)
                # would otherwise loop through reconnects with zero
                # diagnostics.
                self.warning("worker session aborted: %r", e)
            finally:
                self._chan = None
                if chan is not None:
                    chan.close()
            if self._stop or self._draining:
                # A draining session does not reconnect: the planned
                # departure already happened (or its channel died
                # trying) — redialing would rejoin just to leave.
                return
            attempts += 1
            if attempts > policy.max_attempts:
                self.warning("giving up after %d reconnect attempts",
                             policy.max_attempts)
                return
            resilience.stats.incr("client.reconnect")
            self._sleep_interruptible(policy.delay(attempts - 1))

    def _sleep_interruptible(self, seconds):
        """Sleeps in small increments so :meth:`stop` stays
        responsive — backoff sleeps reach 30 s each, and a shutdown
        must not wait one out."""
        deadline = time.time() + seconds
        while not self._stop and not self._draining and \
                time.time() < deadline:
            time.sleep(0.05)

    def _say_goodbye(self, chan):
        """Explicit end-of-session frame on a clean LOCAL stop: the
        master deregisters this worker without the drop+requeue
        error path (``server.drop`` stays a pure error signal — a
        clean exit and a crash used to be indistinguishable).  Best
        effort: a dead channel simply degrades to the drop path."""
        try:
            chan.send({"cmd": "bye"})
        except Exception as e:
            self.debug("goodbye frame not delivered (%s) — the "
                       "master takes the drop path", e)

    def _nojob_backoff(self):
        """Jittered exponential no-job backoff on the shared
        :class:`RetryPolicy` (base ``poll_delay``, capped at 2 s),
        reset on the next real job — an idle fleet must not hammer a
        paused/draining master in lock-step."""
        self._sleep_interruptible(
            self.nojob_policy.delay(self._nojob_streak))
        self._nojob_streak += 1

    # -- phases ------------------------------------------------------------

    def _maybe_remeasure_power(self, chan):
        """Re-measures computing power every ``power_interval``
        seconds and reports it (the master's load balancing tracks
        thermal and contention drift)."""
        if not self.measure_power:
            return
        now = time.time()
        if now - self._power_measured < self.power_interval:
            return
        self._power_measured = now
        self.power = self._measure_power()
        chan.send({"cmd": "power", "power": self.power})

    def _run_job(self, data):
        result = {}

        def capture(update):
            result["update"] = update

        self.workflow.do_job(data, None, capture)
        self.jobs_done += 1
        return result.get("update")

    def _traced_job(self, msg, trace_on):
        """Runs one job; on a trace session, wraps it in a
        ``worker.step`` span parented to the master's dispatch span and
        returns ``(update, spans)`` with the spans captured on this
        thread re-timestamped onto the master clock.  ``spans=None``
        outside trace sessions."""
        tctx = msg.get("trace") if trace_on else None
        if not tctx or not tracing.enabled():
            return self._run_job(msg["data"]), None
        with tracing.capture() as captured:
            with tracing.attach(tctx.get("trace_id"),
                                tctx.get("parent")):
                with tracing.span("worker.step", worker=self.id,
                                  pid=os.getpid()):
                    update = self._run_job(msg["data"])
        return update, tracing.shift(captured, self.clock.offset)

    def _update_msg(self, update, spans):
        out = {"cmd": "update", "data": update}
        if spans is not None:
            out["spans"] = spans
            out["clock"] = self.clock.state()
        return out

    def _measure_power(self):
        launcher = getattr(self.workflow, "workflow", None)
        return measure_computing_power(
            device=getattr(launcher, "device", None))

    def _job_cycle_async(self, chan):
        """Pipelined cycle: the next job request is on the wire while
        the current job computes, so the worker never idles on master
        latency.  Replies arrive in request order (one TCP stream, a
        serial server handler), so each reply pairs with the oldest
        request in flight — its send time is the clock sample's."""
        trace_on = bool(chan.proto.get("trace"))
        sent_at = collections.deque()
        chan.send({"cmd": "job_request"})
        sent_at.append(time.time())
        while not self._stop:
            msg = chan.recv()
            if msg is None:
                return False
            recv_ts = time.time()
            cmd = msg.get("cmd")
            if cmd in ("job", "no_job", "bye") and sent_at:
                send_ts = sent_at.popleft()
                if trace_on and "ts" in msg:
                    self.clock.sample(send_ts, msg["ts"], recv_ts)
            if cmd == "bye":
                return True
            if cmd == "update_ack":
                continue
            if cmd == "no_job":
                if self._draining:
                    break  # the pipeline is empty: leave now
                self._nojob_backoff()
                chan.send({"cmd": "job_request"})
                sent_at.append(time.time())
                continue
            if cmd != "job":
                continue
            self._nojob_streak = 0
            inj = self._injector_()
            inj.tick("job")
            try:
                inj.check("worker.job")
            except WorkerPreempted:
                self.warning("preemption notice — draining after the "
                             "in-flight job")
                resilience.stats.incr("client.preempt")
                self.drain(self.preempt_grace)
            # Pipeline: request N+1 BEFORE computing N — unless we
            # are draining, in which case the pipeline empties out.
            if not self._draining:
                chan.send({"cmd": "job_request"})
                sent_at.append(time.time())
            update, spans = self._traced_job(msg, trace_on)
            chan.send(self._update_msg(update, spans))
            self._maybe_remeasure_power(chan)
            if self._draining and not sent_at:
                break  # last pipelined update shipped: leave
        self._say_goodbye(chan)
        return True

    def _handshake(self, chan):
        if self.measure_power:
            self.power = self._measure_power()
            self._power_measured = time.time()
        hello = {
            "cmd": "handshake",
            "checksum": self.workflow.checksum,
            "mid": machine_id(),
            "pid": os.getpid(),
            "power": self.power,
        }
        if not self.net_legacy:
            hello["proto"] = dict(WORKER_CAPS)
        chan.send(hello)
        reply = chan.recv()
        if reply is None:
            # With default keying (secret = workflow checksum) a
            # version mismatch fails HMAC verification before the
            # server can even read our checksum, so no error frame
            # can come back — diagnose it here instead.
            self.warning(
                "handshake got no authenticated reply — likely a "
                "workflow checksum/secret mismatch with the "
                "coordinator (our checksum: %s)",
                self.workflow.checksum)
            return False
        if reply.get("cmd") != "handshake_ack":
            # The server is alive and said no (checksum mismatch
            # error frame, ...) — a PERMANENT condition; retrying
            # the reconnect schedule against it wastes minutes.
            raise HandshakeRejected("handshake rejected: %r" % reply)
        self.id = reply["id"]
        # Session nonce: every later frame is MAC-bound to it (see
        # network_common.Channel).  A missing nonce means a peer that
        # cannot provide replay protection — hard-fail rather than
        # silently continuing on static keying.
        nonce = reply.get("nonce")
        if not nonce:
            raise HandshakeRejected(
                "handshake_ack carried no session nonce — refusing "
                "the session (peer cannot provide replay protection)")
        chan.rekey(nonce)
        # Negotiated wire protocol: an old master sends no "proto"
        # key — the session stays pickle-compat end to end.
        proto = reply.get("proto") or {}
        chan.set_proto(proto)
        if proto.get("trace") and not tracing.enabled():
            # The master is tracing and asked for our spans: the
            # negotiated trace dialect is the worker's opt-in.
            tracing.enable()
        note = getattr(self.workflow, "note_net_proto", None)
        if note is not None:
            note(proto)
        initial = reply.get("initial")
        if initial:
            self.workflow.apply_data_from_master(initial)
        self.info("joined as %s%s", self.id,
                  " (proto: delta=%s codec=%s ticks=%s)" % (
                      proto.get("delta"), proto.get("codec"),
                      proto.get("ticks")) if proto else
                  " (pickle-compat)")
        return True

    def _job_cycle(self, chan):
        """Returns True on orderly completion."""
        trace_on = bool(chan.proto.get("trace"))
        while not self._stop:
            if self._draining:
                break  # planned departure: bye instead of a request
            send_ts = time.time()
            chan.send({"cmd": "job_request"})
            msg = chan.recv()
            if msg is None:
                return False
            if trace_on and "ts" in msg:
                # Request/reply timestamp pair → one clock-offset
                # sample (the minimum-RTT sample wins; see ClockSync).
                self.clock.sample(send_ts, msg["ts"], time.time())
            cmd = msg.get("cmd")
            if cmd == "bye":
                return True
            if cmd == "no_job":
                self._nojob_backoff()
                continue
            if cmd != "job":
                continue
            self._nojob_streak = 0
            inj = self._injector_()
            inj.tick("job")
            try:
                inj.check("worker.job")
            except WorkerPreempted:
                # Planned preemption: NOT a crash.  This job still
                # runs, its update still ships; the bye goes out
                # right after the ack.
                self.warning("preemption notice — draining after the "
                             "in-flight job")
                resilience.stats.incr("client.preempt")
                self.drain(self.preempt_grace)
            update, spans = self._traced_job(msg, trace_on)
            chan.send(self._update_msg(update, spans))
            ack = chan.recv()
            if ack is None:
                return False
            if ack.get("cmd") == "bye":
                return True
            self._maybe_remeasure_power(chan)
        self._say_goodbye(chan)
        return True
