"""Coordinator (master) side of the distributed job protocol (the JAX
package's ``server``).

Elastic workers join and leave over plain TCP; minibatch indices and
weights go out in jobs, updates come back.  One acceptor thread, one
watchdog thread and one handler thread per worker, with a single lock
serializing workflow access.  The handshake verifies the workflow
checksum and negotiates the wire protocol (:func:`negotiate_protocol`);
a hung worker is blacklisted by an adaptive job timeout (mean + 3σ of
its job times, floored) and its in-flight work requeued; a dropped
worker's work is requeued through ``workflow.drop_slave``.

Aggregation: each job ships the trainables (or the change since that
worker's last sync); the worker runs its ticks and returns its change;
the master folds it into its current values (delayed/async SGD).

Span tracing of the job protocol: when this master traces
(``--trace-out``) and a worker's hello advertises ``trace``, the session
negotiates it; each job then opens a detached ``server.dispatch`` span,
carries its trace context and a clock-sync timestamp, and the worker's
update brings back its ``worker.step`` spans, which the master ingests
on one timeline beside its ``net.fold`` spans.
"""

import os
import socket
import statistics
import threading
import time

from . import resilience
from .config import root, get as config_get
from .distributable import SniffedLock
from .fleet import FleetScheduler
from .logger import Logger
from .network_common import (Channel, machine_id, normalize_secret,
                             parse_address)
from .resilience import MasterCrash


def negotiate_protocol(hello, cfg=None):
    """Computes the effective wire protocol for one worker from its
    handshake capabilities and this coordinator's ``root.common.net``
    configuration.

    Returns ``(proto, error)``: ``proto`` is the negotiated dict
    ({} = legacy pickle-compat), ``error`` a rejection string when the
    peer cannot be served at all (``--net-require`` against an
    old-format peer).  Every capability degrades gracefully by
    default — a new master serves an old worker in pickle-compat
    mode, and vice versa an old master simply ignores the ``proto``
    key in the hello."""
    if cfg is None:
        cfg = {
            "mode": config_get(root.common.net.mode, "delta"),
            "codec": config_get(root.common.net.codec, "gzip"),
            "codec_level": config_get(root.common.net.codec_level, 1),
            "codec_threshold": config_get(
                root.common.net.codec_threshold, 1 << 16),
            "dtype": config_get(root.common.net.dtype, "fp32"),
            "job_ticks": config_get(root.common.net.job_ticks, 1),
            "zero": config_get(root.common.net.zero, 0),
            "require": config_get(root.common.net.require, False),
            # None = derive from the live tracing state (--trace-out
            # flips it on); an explicit config value wins.
            "trace": config_get(root.common.observability.trace, None),
        }
    theirs = hello.get("proto") or {}
    if not theirs.get("tensor") or cfg.get("mode") == "legacy":
        if cfg.get("require") and cfg.get("mode") != "legacy":
            return None, (
                "this coordinator requires the tensor-framed delta "
                "wire protocol (--net-require) but the worker's "
                "handshake advertises no such capability — upgrade "
                "the worker to a tensor-framing build, or restart "
                "the coordinator without --net-require to serve it "
                "in pickle-compat mode")
        return {}, None  # legacy pickle-compat session
    codec = cfg.get("codec", "gzip")
    if codec not in (theirs.get("codecs") or ("none",)):
        codec = "none"
    dtype = cfg.get("dtype", "fp32")
    if dtype not in (theirs.get("dtypes") or ("fp32",)):
        dtype = "fp32"
    ticks = int(cfg.get("job_ticks") or 1)
    if not theirs.get("block"):
        ticks = 1
    proto = {
        "tensor": True,
        "delta": bool(theirs.get("delta")),
        "codec": codec,
        "codec_level": cfg.get("codec_level"),
        "codec_threshold": cfg.get("codec_threshold"),
        "dtype": dtype,
        "ticks": max(1, ticks),
    }
    # ZeRO slot-shard sync (--net-zero K):
    # optimizer slots join the delta data plane, sharded K ways —
    # each worker syncs only its 1/K flat slice.  Needs the delta
    # dialect AND the worker's "slots" capability; old peers never
    # see the key (protocol version bump by capability, not by
    # breaking the frame format).
    zero = int(cfg.get("zero") or 0)
    if zero > 0 and proto["delta"] and theirs.get("slots"):
        proto["zero"] = zero
    # Span tracing: when the master traces and the worker advertises
    # the capability, job frames carry clock-sync timestamps and trace
    # context, and updates carry the worker's spans.  Old peers never
    # see the fields.
    want_trace = cfg.get("trace")
    if want_trace is None:
        from .observability import tracing
        want_trace = tracing.enabled()
    if want_trace and theirs.get("trace"):
        proto["trace"] = True
    return proto, None


class SlaveDescription(object):
    """Per-worker bookkeeping."""

    def __init__(self, sid, mid, power, address):
        self.id = sid
        self.mid = mid
        self.power = power
        self.address = address
        self.state = "WAIT"
        self.jobs_done = 0
        self.job_times = []
        self.job_started = None
        self.joined = time.time()
        self.last_update = None
        self.blacklisted = False
        self.paused = False
        #: Slot-shard rank this session owns (--net-zero sessions
        #: only) — consulted when assigning ranks to later joiners.
        self.zero_rank = None
        #: Membership epoch at which this session was admitted
        #: (FleetScheduler.join) — joins and leaves are numbered
        #: events, so "which fleet did this worker belong to?" has a
        #: stable answer in logs and heartbeats.
        self.epoch = None
        #: Parole: this session belongs to a previously-blacklisted
        #: machine — it gets ONE job at a time until one completes
        #: clean (then the machine's blacklist entry is erased).
        self.probation = False

    @property
    def jobs_per_second(self):
        """Per-worker job throughput over WALL CLOCK (join to last
        applied update), not inverse busy-time — idle gaps (no_job
        backoff, a paused master) must drag the number down, or the
        comms row reads healthy exactly when the operator is
        diagnosing a starved worker."""
        if not self.jobs_done or self.last_update is None:
            return 0.0
        span = self.last_update - self.joined
        return self.jobs_done / span if span > 0 else 0.0


class Server(Logger):
    """Listens for workers and drives the job/update cycle over the
    master workflow."""

    def __init__(self, address, workflow, **kwargs):
        super(Server, self).__init__()
        self.workflow = workflow
        self.host, self.port = parse_address(address)
        self._sock = socket.socket(socket.AF_INET,
                                   socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR,
                              1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(16)
        # Serializes workflow access across handler threads; sniffs
        # and reports acquisitions stuck past DEADLOCK_TIME.
        self._lock = SniffedLock(name="master.workflow_lock")
        self._slaves = {}  # guarded-by: _lock
        #: Departed workers' final descriptors (jobs_done/jobs_per_
        #: second), kept for the exit throughput report — EVERY
        #: disconnect (graceful bye included) removes the live entry,
        #: so without this the report would always be empty.  Bounded
        #: (oldest evicted): every reconnect mints a fresh sid, so an
        #: elastic master under worker churn would otherwise leak one
        #: descriptor per departed session.
        self._retired_slaves = {}  # guarded-by: _lock
        self._max_retired = int(kwargs.get("max_retired", 64))
        self._slave_seq = 0  # guarded-by: _lock
        #: Round-robin shard-rank assignment for --net-zero sessions.
        self._zero_seq = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self.on_stopped = kwargs.get("on_stopped")
        #: Frames are HMAC-authenticated before unpickling.  Key
        #: precedence: explicit kwarg > VELES_NETWORK_SECRET env >
        #: workflow checksum.  The checksum default stops stray/
        #: accidental peers and version mismatches, but it is derived
        #: from the workflow source — anyone who has the source can
        #: compute it, so set a real secret on untrusted networks.
        self._secret = normalize_secret(
            kwargs.get("secret") or
            os.environ.get("VELES_NETWORK_SECRET") or
            workflow.checksum)
        #: jobs handed out but not yet answered, per slave id
        self._outstanding = {}  # guarded-by: _lock
        #: Fault injector (resilience.FaultInjector) consulted at the
        #: ``master.crash`` point; None falls back to the process-wide
        #: one (``--chaos`` plan).
        self.injector = kwargs.get("injector")
        self._crashed = False  # guarded-by: _chan_lock
        #: First master-side exception raised while serving a worker
        #: (None = clean).  Launcher.run re-raises it so the process
        #: exits NONZERO — a degraded coordinator must never write a
        #: results file and read as success.
        self.failure = None
        #: live worker channels — a simulated crash must sever them
        #: abruptly, exactly like a process death would.  Guarded by
        #: ``_chan_lock``: crash() must also catch a channel whose
        #: handler registered it concurrently.
        self._channels = set()  # guarded-by: _chan_lock
        self._chan_lock = threading.Lock()
        #: Respawn hook: ``respawn(desc)`` relaunches a dropped
        #: worker.
        self.respawn = kwargs.get("respawn")
        self.max_respawns = int(kwargs.get("max_respawns", 10))
        self._respawn_counts = {}  # guarded-by: _lock
        self._watchdog_interval = kwargs.get("watchdog_interval", 1.0)
        #: Floor for the adaptive timeout (2 minutes by default).
        #: With uniform job times σ≈0, and a bare mean+3σ would
        #: blacklist a healthy worker on any transient stall.
        self.job_timeout = float(kwargs.get("job_timeout", 120.0))
        #: Blacklist parole (``--blacklist-cooldown``): machines the
        #: watchdog blacklisted are re-admitted on probation after
        #: this many seconds — a straggler that recovered (GC pause,
        #: thermal throttle, network blip) rejoins the fleet instead
        #: of being ejected for good.
        self.blacklist_cooldown = float(kwargs.get(
            "blacklist_cooldown",
            config_get(root.common.server.blacklist_cooldown, 60.0)))
        #: machine id -> wall time of its latest blacklisting.
        self._blacklist = {}  # guarded-by: _lock
        #: Membership registry + shared placement policy: every join
        #: and leave bumps an epoch-numbered event here, surfaced as
        #: the ``membership.epoch`` gauge and the launcher-heartbeat
        #: "fleet" section.  Injectable for tests / shared fleets.
        self.fleet = kwargs.get("fleet") or FleetScheduler()
        #: Optional global in-flight-job ceiling.  ``max_inflight=1``
        #: serializes dispatch: every delta fold then lands on a
        #: fully-current base, making the weight trajectory
        #: bit-identical to a standalone run regardless of fleet size
        #: or membership churn — the property the elastic-soak parity
        #: gate asserts.  None (default) = unbounded, the normal
        #: delayed-SGD regime.
        self.max_inflight = kwargs.get("max_inflight")
        # Threads LAST, accept included: the socket is bound above,
        # so a worker hammering reconnects (the chaos restart loop)
        # can dial the instant the port exists — its handler must
        # never observe a half-constructed server.
        #: Every thread this server started (accept, watchdog, one
        #: handler per worker, respawns): :meth:`join` waits for them.
        self._threads = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="veles-server-accept")
        self._threads.append(self._accept_thread)
        self._accept_thread.start()
        self._watchdog_thread = threading.Thread(
            target=self._watchdog_loop, daemon=True,
            name="veles-server-watchdog")
        self._threads.append(self._watchdog_thread)
        self._watchdog_thread.start()
        self.info("coordinator listening on %s:%d", self.host,
                  self.port)

    # -- lifecycle ---------------------------------------------------------

    @property
    def is_running(self):
        return not self._stop.is_set()

    def stop(self):
        if self._stop.is_set():
            return
        # Close the listen socket BEFORE signaling waiters: a
        # supervisor that rebinds the same port the moment wait()
        # returns must never race our own still-bound fd.
        self._close_listener()
        self._stop.set()
        if self.on_stopped is not None:
            self.on_stopped()

    def _close_listener(self):
        """Shuts the listening socket down (which wakes the accept
        thread out of ``accept``; a bare close does not) and closes
        it."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def wait(self, timeout=None):
        """Blocks until training completes (decision.complete on the
        master workflow stops the server)."""
        self._stop.wait(timeout)

    def join(self, timeout=10.0):
        """After :meth:`stop`: waits up to ``timeout`` seconds for the
        server's threads to end (a handler ends when its worker says
        bye or hangs up), then closes the channels of the handlers
        still waiting on a worker and gives them a second to unwind;
        returns the threads still alive."""
        end = time.monotonic() + timeout
        for t in list(self._threads):
            t.join(max(0.0, end - time.monotonic()))
        if any(t.is_alive() for t in self._threads):
            with self._chan_lock:
                chans = list(self._channels)
            for chan in chans:
                chan.close()
            for t in list(self._threads):
                t.join(1.0)
        return [t for t in self._threads if t.is_alive()]

    def _injector_(self):
        return resilience.effective(self.injector)

    @property
    def crashed(self):
        return self._crashed

    def crash(self):
        """Simulated coordinator process death: every socket dies
        abruptly, nothing is requeued, no goodbye frames — the ONLY
        recovery path is a restarted master resuming the newest
        atomic snapshot (Launcher.resume_latest).  Driven by the
        ``master.crash`` injection point; also callable directly by
        chaos tests."""
        with self._chan_lock:
            if self._crashed:
                return
            self._crashed = True
            chans = list(self._channels)
        self.warning("injected coordinator crash — dying abruptly")
        resilience.stats.incr("master.crash")
        # Socket first, stop-event second — see stop(): wait()
        # returning is the restart supervisor's cue to rebind.
        self._close_listener()
        self._stop.set()
        for chan in chans:
            chan.close()

    # -- worker management: pause, resume, blacklist --------------------------

    @property
    def slaves(self):
        return dict(self._slaves)

    @property
    def all_slaves(self):
        """Live AND departed workers (live wins on id collision) —
        the exit throughput report runs after every worker has said
        bye, when :attr:`slaves` is already empty."""
        merged = dict(self._retired_slaves)
        merged.update(self._slaves)
        return merged

    def pause_slave(self, sid):
        if sid in self._slaves:
            self._slaves[sid].paused = True

    def resume_slave(self, sid):
        if sid in self._slaves:
            self._slaves[sid].paused = False

    def _blacklist_check(self, desc):
        """Adaptive job timeout: mean+3σ of this worker's history,
        floored at ``job_timeout``.  ``job_started`` is read once
        — a handler thread may null it concurrently."""
        started = desc.job_started
        times = list(desc.job_times)
        if started is None:
            return False
        if len(times) < 4:
            threshold = self.job_timeout
        else:
            mean = statistics.mean(times)
            sigma = statistics.pstdev(times)
            threshold = max(mean + 3 * sigma + 1.0, self.job_timeout)
        if time.time() - started > threshold:
            desc.blacklisted = True
            return True
        return False

    def _watchdog_loop(self):
        """Periodic sweep firing the adaptive timeout: a hung worker
        is blacklisted and its in-flight work requeued — the
        job-timeout dropper, periodic instead of waiting for the TCP
        connection to die.
        The whole sweep runs under the workflow lock so it cannot
        interleave with an update being applied for the same job."""
        while not self._stop.wait(self._watchdog_interval):
            with self._lock:
                for desc in list(self._slaves.values()):
                    if desc.blacklisted or desc.state != "WORK":
                        continue
                    if self._blacklist_check(desc):
                        self.warning(
                            "worker %s exceeded adaptive job timeout "
                            "— blacklisted, requeueing its work "
                            "(parole in %.0f s)",
                            desc.id, self.blacklist_cooldown)
                        resilience.stats.incr("server.blacklist")
                        if desc.mid:
                            self._blacklist[desc.mid] = time.time()
                        if self._outstanding.pop(desc.id, None):
                            resilience.stats.incr("server.requeue")
                        self.workflow.drop_slave(desc.id)

    # -- protocol ----------------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_slave,
                                 args=(conn, addr), daemon=True,
                                 name="veles-server-worker")
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
            t.start()

    def _recv_or_none(self, chan):
        """A frame that cannot be received OR deserialized reads as a
        dead peer (drop + requeue), never as a master-side failure:
        the bytes are peer-supplied, so a worker running skewed code
        (pickle naming a class this master lacks) must only cost
        itself, not the coordinator."""
        try:
            return chan.recv()
        except (ConnectionError, TimeoutError):
            return None
        except Exception as e:
            self.warning("dropping worker: undeserializable frame "
                         "(%s)", e)
            return None

    def _serve_slave(self, conn, addr):
        desc = None
        clean = False
        chan = Channel(conn, self._secret, injector=self.injector)
        with self._chan_lock:
            self._channels.add(chan)
            crashed = self._crashed
        if crashed:
            # Raced past crash(): a dead master serves nobody.
            chan.close()
            return
        try:
            hello = self._recv_or_none(chan)
            if not hello or hello.get("cmd") != "handshake":
                return
            # Checksum verification.
            theirs = hello.get("checksum")
            ours = self.workflow.checksum
            if theirs != ours:
                chan.send({"cmd": "error",
                           "error": "checksum mismatch",
                           "expected": ours})
                return
            proto, proto_error = negotiate_protocol(hello)
            if proto_error:
                chan.send({"cmd": "error", "error": proto_error})
                resilience.stats.incr("server.proto_reject")
                return
            # The admission seam: a ``fleet.join`` chaos rule kills
            # the joiner here — after checksum/protocol vetting,
            # before any registration — so tests can prove a join
            # that dies mid-handshake leaves no membership residue
            # (no epoch bump, no slave entry, no requeue).  The
            # raised fault is a ConnectionError: the dead-peer path
            # below handles it, and the worker redials.
            self._injector_().check("fleet.join")
            with self._lock:
                self._slave_seq += 1
                sid = "%s/%d" % (hello.get("mid", machine_id()),
                                 self._slave_seq)
                if proto.get("zero"):
                    # Slot-shard ownership: the lowest shard rank no
                    # LIVE session holds, so churn re-fills orphaned
                    # shards instead of blindly round-robining past
                    # them (a replacement for a dead rank-1 worker
                    # must own shard 1, not double up on 0).  With
                    # more workers than shards, overlap resolves
                    # last-writer-wins at the fold — degraded
                    # freshness, never corruption.
                    proto = dict(proto)
                    k = int(proto["zero"])
                    held = {s.zero_rank for s in
                            self._slaves.values()
                            if s.zero_rank is not None}
                    rank = FleetScheduler.lowest_free_rank(k, held)
                    proto["zero_rank"] = rank if rank is not None \
                        else self._zero_seq % k
                    self._zero_seq += 1
                desc = SlaveDescription(
                    sid, hello.get("mid"), hello.get("power", 1.0),
                    addr)
                desc.zero_rank = proto.get("zero_rank") \
                    if proto else None
                if desc.mid in self._blacklist:
                    # Parole: the machine was blacklisted — it may
                    # rejoin, but on probation (no jobs until the
                    # cooldown elapses, then one at a time until one
                    # completes clean).
                    desc.probation = True
                self._slaves[sid] = desc
                desc.epoch = self.fleet.join(sid, desc.mid,
                                             desc.power)
                note = getattr(self.workflow, "note_slave_protocol",
                               None)
                if note is not None:
                    note(sid, proto)
                initial = self.workflow.\
                    generate_initial_data_for_slave(sid)
            # Fresh session nonce: all post-handshake frames (both
            # directions) are MAC-bound to it + a sequence number, so
            # captured frames cannot be replayed into this or any
            # other session.  The ack itself still rides
            # the legacy framing (the peer switches formats only
            # after reading the negotiation result).
            nonce = os.urandom(16)
            chan.send({"cmd": "handshake_ack", "id": sid,
                       "nonce": nonce, "initial": initial,
                       "proto": proto})
            chan.rekey(nonce)
            chan.set_proto(proto)
            self.info("worker %s joined at membership epoch %d "
                      "(power %.1f%s)", sid, desc.epoch,
                      desc.power,
                      ", proto: delta=%s codec=%s ticks=%s" % (
                          proto.get("delta"), proto.get("codec"),
                          proto.get("ticks")) if proto else
                      ", pickle-compat")
            if desc.probation:
                self.info("worker %s joined on PROBATION (machine "
                          "%s was blacklisted)", sid, desc.mid)
            clean = bool(self._message_loop(chan, desc))
        except MasterCrash:
            self.crash()
        except (ConnectionError, TimeoutError):
            # Dead peer mid-protocol (broken pipe on a send, a
            # keepalive timeout, or an injected net fault): identical
            # to a recv()→None close — the finally below drops and
            # requeues.
            pass
        except Exception:
            # NOT a peer problem: a master-side failure raised while
            # applying this worker's traffic (exhausted snapshot-write
            # retries, loader I/O error, ...).  Swallowing it as a
            # dead peer would silently requeue forever; the contract
            # is a LOUD stop.  (During shutdown/crash the racing
            # EBADF from our own close is expected noise, not a
            # failure.)
            if not self._stop.is_set():
                import sys
                self.failure = sys.exc_info()[1]
                self.exception(
                    "master-side error while serving worker %s — "
                    "stopping coordinator", desc.id if desc else addr)
                self.stop()
        finally:
            with self._chan_lock:
                self._channels.discard(chan)
            # After an orderly end the peer may have a request in
            # flight: drain it, or the close resets the connection
            # under the bye.
            chan.close(drain=1.0 if clean else 0.0)
            # A crashed master does NOT requeue or respawn — it is
            # dead; cleanup is the restarted master's job.
            if desc is not None and not self._crashed:
                if not clean and self._stop.is_set() and \
                        self.failure is None:
                    with self._lock:
                        finished = self._finished_locked()
                else:
                    finished = False
                if finished:
                    # Orderly-completion race: ONE handler observes
                    # the finished run, sends its peer the bye and
                    # stops the coordinator; every OTHER live session
                    # (and this one, when its own bye send raced the
                    # teardown) then unwinds through a closed socket
                    # or the _stop flag.  Training completed and the
                    # master is healthy, so this is a retirement, not
                    # a drop — _drop still demotes it to drop+requeue
                    # if the worker holds in-flight work, keeping
                    # ``server.drop`` a pure error signal both ways.
                    clean = True
                self._drop(desc, clean=clean)

    def _message_loop(self, chan, desc):
        """Returns True on an orderly end of session (the worker's
        explicit goodbye, or this master's own "bye" after training
        completed) — the caller then retires the worker without the
        drop+requeue error path; False means the peer vanished (crash,
        timeout, blacklist disconnect), and ``server.drop`` stays a
        pure error signal.

        On a trace session replies carry clock-sync timestamps, jobs
        carry trace context, and updates bring the worker's spans home.
        Open dispatch spans are FIFO: a pipelined worker can hold more
        than one job in flight."""
        from .observability import tracing
        trace_on = bool(chan.proto.get("trace"))
        open_dispatches = []
        while not self._stop.is_set():
            msg = self._recv_or_none(chan)
            if msg is None:
                for sp in open_dispatches:
                    sp.set(dropped=True)
                    sp.finish()
                return False
            recv_wall = time.time()
            cmd = msg.get("cmd")
            if cmd == "job_request":
                if desc.blacklisted:
                    # A blacklisted worker is disconnected without a
                    # "bye" (which would read as an orderly
                    # completion); its job was requeued by the
                    # watchdog, and it reconnects with a fresh id.
                    return False
                if desc.paused or self._probation_hold(desc):
                    chan.send(self._stamp({"cmd": "no_job",
                                           "retry": True}, trace_on,
                                          recv_wall))
                    continue
                # The dispatch window opens before job generation and
                # closes when the worker's update has been folded, so on
                # one aligned timeline it encloses the worker.step span.
                # Detached: pipelined workers hold overlapping windows on
                # this thread, which stack nesting would chain into
                # parent and child.
                sp = tracing.begin("server.dispatch", detached=True,
                                   worker=desc.id) \
                    if trace_on and tracing.enabled() else None
                job = self._generate_job(desc)
                if job is None:
                    if sp is not None:
                        sp.cancel()
                    if self._maybe_finished():
                        chan.send({"cmd": "bye"})
                        return True
                    chan.send(self._stamp({"cmd": "no_job",
                                           "retry": True}, trace_on,
                                          recv_wall))
                else:
                    desc.state = "WORK"
                    desc.job_started = time.time()
                    if sp is None:
                        self._send_job(chan, job)
                    else:
                        open_dispatches.append(sp)
                        extra = self._stamp(
                            {"trace": {"trace_id": sp.trace_id,
                                       "parent": sp.id}},
                            True, recv_wall)
                        # net.serialize/net.send of this job nest under
                        # this dispatch window.
                        with tracing.attach(sp.trace_id, sp.id):
                            self._send_job(chan, job, extra)
            elif cmd == "update":
                if trace_on:
                    spans = msg.get("spans")
                    if spans:
                        tracing.ingest(spans,
                                       proc="worker:%s" % desc.id)
                # Replies arrive in dispatch order (one TCP stream, a
                # serial handler): this update answers the oldest open
                # window — fold under it, then close it.
                owner = open_dispatches.pop(0) if open_dispatches \
                    else None
                if owner is not None:
                    with tracing.attach(owner.trace_id, owner.id):
                        with tracing.span("net.fold", worker=desc.id):
                            self._apply_update(desc, msg["data"])
                    owner.finish()
                else:
                    with tracing.span("net.fold", worker=desc.id):
                        self._apply_update(desc, msg["data"])
                chan.send(self._stamp({"cmd": "update_ack"}, trace_on,
                                      recv_wall))
                if self._maybe_finished():
                    chan.send({"cmd": "bye"})
                    return True
            elif cmd == "power":
                # Periodic re-measurement from the worker keeps the
                # load balancing honest.
                desc.power = float(msg.get("power", desc.power))
            elif cmd == "bye":
                # The worker's explicit end-of-session frame: a clean
                # exit, not a crash.
                return True
        return False

    def _probation_hold(self, desc):
        """True when a paroled worker must keep polling no_job: its
        machine's blacklist cooldown has not elapsed yet, or its one
        probation job is still in flight (probation = ONE job at a
        time until one completes clean)."""
        if not desc.probation:
            return False
        listed = self._blacklist.get(desc.mid)
        if listed is not None and \
                time.time() - listed < self.blacklist_cooldown:
            return True
        return bool(self._outstanding.get(desc.id))

    # -- workflow bridging -------------------------------------------------

    @staticmethod
    def _stamp(msg, trace_on, recv_wall):
        """Adds the clock-sync timestamp to a reply (trace sessions
        only): the worker pairs it with its local send and receive
        times for the NTP-style offset estimate.  The stamp is the
        midpoint of request receipt and reply build — NTP's
        (t2+t3)/2 — so job generation does not bias the estimate."""
        if trace_on:
            msg["ts"] = (recv_wall + time.time()) / 2.0
        return msg

    def _send_job(self, chan, job, extra=None):
        """Serializes and sends one job — called with the workflow lock
        NOT held: serializing a params-sized job for a slow worker must
        never stall ``_apply_update`` from the others
        (``_generate_job`` holds the lock only for the bookkeeping and
        the host-side array snapshot).  ``extra`` carries the
        negotiated trace fields (context and timestamp) at the message
        level."""
        chan.send_parts(*self._serialize_job(chan, job, extra))

    def _serialize_job(self, chan, job, extra=None):
        """The expensive half (pickle/framing/compression), exposed
        as a seam so tests can pin that it runs outside the lock."""
        return chan.encode(dict({"cmd": "job", "data": job},
                                **(extra or {})))

    def _generate_job(self, desc):
        """Generates one job under the workflow lock
        (deferred generation).  The
        ``job`` chaos counter ticks per job actually GENERATED —
        never on no_job polls, whose count is wall-clock-dependent —
        so a plan like ``master.crash@job:7`` crashes the coordinator
        at the exact same ledger position every run.  The crash fires
        before the job is recorded as outstanding or dispatched; the
        consumed workflow state rolls back through the snapshot on
        resume."""
        inj = self._injector_()
        with self._lock:
            if self._finished_locked():
                return None
            if self.max_inflight is not None and \
                    sum(self._outstanding.values()) >= \
                    self.max_inflight:
                # Serialized dispatch (see __init__): hold this
                # worker on no_job until an outstanding fold lands.
                return None
            data = self.workflow.generate_data_for_slave(desc.id)
            if data is None:
                # Workflow has nothing to hand out right now (e.g. a
                # GA generation fully in flight elsewhere) — the
                # caller sends no_job; counting it as outstanding
                # would block _maybe_finished forever.
                return None
            inj.tick("job")
            inj.check("master.crash")
            self._outstanding[desc.id] = \
                self._outstanding.get(desc.id, 0) + 1
            return data

    def _apply_update(self, desc, data):
        """Returns False when the update was discarded.  The
        blacklist re-check happens UNDER the lock: the watchdog may
        have blacklisted this worker (and requeued its job) between
        the handler reading the frame and getting here — applying
        the late result then would double-count the batch."""
        inj = self._injector_()
        inj.tick("update")
        inj.check("master.crash")
        with self._lock:
            if desc.blacklisted:
                return False
            self.workflow.apply_data_from_slave(data, desc.id)
            desc.state = "WAIT"
            desc.jobs_done += 1
            desc.last_update = time.time()
            if desc.probation:
                # The probation job completed clean: parole granted —
                # the machine rejoins the fleet at full rate.
                desc.probation = False
                self._blacklist.pop(desc.mid, None)
                resilience.stats.incr("server.parole")
                self.info("worker %s completed its probation job — "
                          "parole granted", desc.id)
            if desc.job_started is not None:
                desc.job_times.append(time.time() - desc.job_started)
                desc.job_started = None
            n = self._outstanding.get(desc.id, 0)
            if n <= 1:
                self._outstanding.pop(desc.id, None)
            else:
                self._outstanding[desc.id] = n - 1
            return True

    def _finished_locked(self):
        stop = getattr(self.workflow, "should_stop_serving", None)
        if stop is not None:
            return bool(stop())
        return bool(self.workflow.stopped)

    def _maybe_finished(self):
        with self._lock:
            done = self._finished_locked() and not self._outstanding
        if done:
            self.info("all jobs done — stopping coordinator")
            self.stop()
        return done

    def _drop(self, desc, clean=False):
        """End of a worker session.  ``clean=True`` (an explicit
        goodbye frame, or this master's own bye) DEREGISTERS the
        worker — no requeue, no respawn, and ``server.drop`` stays a
        pure error signal (previously a clean exit and a crash were
        indistinguishable here).  Otherwise: connection lost →
        requeue in-flight work, then
        optionally respawn the worker."""
        with self._lock:
            if self._slaves.pop(desc.id, None) is not None:
                self._retired_slaves[desc.id] = desc
                while len(self._retired_slaves) > self._max_retired:
                    self._retired_slaves.pop(
                        next(iter(self._retired_slaves)))
            if self._outstanding.pop(desc.id, None):
                # A "goodbye" with work still in flight is NOT clean
                # — the job must be requeued like any other loss.
                resilience.stats.incr("server.requeue")
                clean = False
            if clean and desc.probation:
                # A probation session that drains and says bye with
                # nothing outstanding counts as a clean completion
                # for parole purposes — an orderly departure (spot
                # preemption, scale-down) must not keep the machine's
                # cooldown armed as if it had failed again.
                desc.probation = False
                if self._blacklist.pop(desc.mid, None) is not None:
                    resilience.stats.incr("server.parole")
                    self.info("worker %s said a clean goodbye during "
                              "probation — parole granted", desc.id)
            self.workflow.drop_slave(desc.id)
        self.fleet.leave(desc.id, clean=clean)
        if clean:
            resilience.stats.incr("server.goodbye")
            self.info("worker %s retired (clean goodbye) — "
                      "membership epoch %d", desc.id,
                      self.fleet.epoch)
            return
        resilience.stats.incr("server.drop")
        self.info("worker %s dropped", desc.id)
        self._maybe_respawn(desc)

    def _maybe_respawn(self, desc):
        """Relaunches a dropped worker with exponential backoff (the
        hook is a callable — local subprocess, SSH, k8s, whatever the
        deployment uses — so policy stays out of the protocol)."""
        if self.respawn is None or self._stop.is_set():
            return
        mid = desc.mid or "unknown"
        # Concurrent drops (one handler thread per worker) race this
        # counter — claim the respawn slot under the lock.
        with self._lock:
            count = self._respawn_counts.get(mid, 0)
            if count >= self.max_respawns:
                give_up = True
            else:
                give_up = False
                self._respawn_counts[mid] = count + 1
        if give_up:
            self.warning("worker machine %s exceeded %d respawns — "
                         "giving up on it", mid, self.max_respawns)
            return
        delay = min(2.0 ** count * 0.5, 30.0)

        def relaunch():
            if self._stop.wait(delay):
                return
            self.info("respawning worker for %s (attempt %d)", mid,
                      count + 1)
            resilience.stats.incr("server.respawn")
            try:
                self.respawn(desc)
            except Exception:
                self.exception("respawn hook failed for %s", mid)

        t = threading.Thread(target=relaunch, daemon=True,
                             name="veles-respawn")
        self._threads.append(t)
        t.start()
