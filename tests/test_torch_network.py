"""The port's data plane over real loopback sockets (the JAX package's
``tests/test_network.py``), the wire held byte for byte against the
JAX package's, and the shared hygiene of the port's network tests.

Every test here — and in ``test_torch_dataplane.py`` and
``test_torch_distributed_polish.py``, which import
:func:`kept_process_state` — leaves its worker process as it found it:
both packages' whole config trees are put back, the port's generators
and resilience state (its fault injector included) are reset around
it, the SIGTERM handler is restored, torch runs at most two intra-op
threads during it, and the test fails if a thread it started or a TCP
socket it put in the LISTEN state is still alive after it stopped its
servers and clients and a join with a timeout.  Servers bind port 0
only.
"""

import contextlib
import hashlib
import hmac
import os
import pickle
import signal
import socket
import struct
import threading
import time

import numpy
import pytest
import torch

import veles_tpu_torch.prng as tprng
from veles_tpu_torch import resilience as tresilience
from veles_tpu_torch.client import Client
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.network_common import (machine_id, parse_address,
                                            recv_message, send_message)
from veles_tpu_torch.server import Server
from veles_tpu_torch.units import TrivialUnit
from veles_tpu_torch.workflow import Workflow

#: Seconds a test's threads get to end after it returns.
JOIN_TIMEOUT = 15.0


# -- process hygiene -------------------------------------------------------


def _config_nodes(node):
    out = [(node, dict(node.__dict__))]
    for _, value in node.items():
        if isinstance(value, type(node)):
            out.extend(_config_nodes(value))
    return out


def listening_sockets():
    """Inodes of this process's TCP sockets in the LISTEN state."""
    mine = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            link = os.readlink("/proc/self/fd/" + fd)
        except OSError:
            continue
        if link.startswith("socket:["):
            mine.add(link[8:-1])
    out = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as fin:
                rows = fin.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            fields = row.split()
            if len(fields) > 9 and fields[3] == "0A" and \
                    fields[9] in mine:
                out.add(fields[9])
    return out


@contextlib.contextmanager
def kept_process_state():
    """Puts back both packages' whole config trees (with every JAX
    ``root`` node that JAX code touched), resets the port's generators
    and resilience state before and after, restores the SIGTERM
    handler and torch's intra-op thread count, and fails if a thread
    started or a socket put in LISTEN state during the block outlives it
    (after a join of :data:`JOIN_TIMEOUT` seconds)."""
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root as troot
    saved = _config_nodes(jroot) + _config_nodes(troot)
    sigterm = signal.getsignal(signal.SIGTERM)
    threads = set(threading.enumerate())
    listening = listening_sockets()
    # At most two intra-op threads: the suite runs files in parallel
    # workers, and the fleet's timing tests share the CPU.
    intra_op = torch.get_num_threads()
    torch.set_num_threads(min(intra_op, 2))
    tprng.reset()
    tresilience.reset()
    try:
        yield
    finally:
        torch.set_num_threads(intra_op)
        end = time.monotonic() + JOIN_TIMEOUT
        for t in threading.enumerate():
            if t not in threads:
                t.join(max(0.0, end - time.monotonic()))
        left = [t.name for t in threading.enumerate()
                if t not in threads and t.is_alive()]
        socks = sorted(listening_sockets() - listening)
        for node, state in saved:
            node.__dict__.clear()
            node.__dict__.update(state)
        signal.signal(signal.SIGTERM, sigterm)
        tprng.reset()
        tresilience.reset()
    if left or socks:
        pytest.fail("the test left threads %s and listening sockets %s"
                    % (left, socks))


@pytest.fixture(autouse=True)
def _process_state():
    with kept_process_state():
        yield


def joined(thread, timeout=30.0):
    thread.join(timeout)
    assert not thread.is_alive(), "%s did not end" % thread.name


def stopped(server):
    """Stops ``server`` and joins its threads."""
    server.stop()
    assert server.join(JOIN_TIMEOUT) == []


class JaxServer(object):
    """The JAX package's ``Server`` whose stop also wakes its accept
    thread (a bare close does not), so a test can join it."""

    @staticmethod
    def make(address, workflow, **kwargs):
        from veles_tpu.server import Server as JServer

        class _Server(JServer):
            def stop(self):
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                super(_Server, self).stop()

        return _Server(address, workflow, **kwargs)


# -- the instrumented workflow of the protocol tests -----------------------


class InstrumentedWorkflow(Workflow):
    """Counts the protocol's traffic: ``job_limit`` jobs, each echoed
    back by the worker."""

    job_limit = 3

    def __init__(self, launcher, **kwargs):
        super(InstrumentedWorkflow, self).__init__(launcher, **kwargs)
        self.body = TrivialUnit(self)
        self.body.link_from(self.start_point)
        self.end_point.link_from(self.body)
        self.generated = 0
        self.applied_from_slave = 0
        self.applied_from_master = 0
        self.jobs_run = 0
        self.dropped = []

    def generate_data_for_slave(self, slave=None):
        self.generated += 1
        return {"n": self.generated}

    def should_stop_serving(self):
        return self.generated >= self.job_limit

    def apply_data_from_slave(self, data, slave=None):
        self.applied_from_slave += 1

    def drop_slave(self, slave=None):
        self.dropped.append(slave)

    def apply_data_from_master(self, data):
        self.applied_from_master += 1

    def do_job(self, data, update, callback):
        self.apply_data_from_master(data)
        self.jobs_run += 1
        callback({"echo": data["n"]})


def handshook_channel(server, master):
    """Speaks the raw protocol up to a completed handshake."""
    from veles_tpu_torch.network_common import Channel, connect
    chan = Channel(connect("127.0.0.1:%d" % server.port),
                   master.checksum)
    chan.send({"cmd": "handshake", "checksum": master.checksum,
               "mid": machine_id(), "pid": 1, "power": 1.0})
    ack = chan.recv()
    assert ack["cmd"] == "handshake_ack"
    chan.rekey(ack["nonce"])
    return chan, ack


def run_client(client):
    t = threading.Thread(target=client.run, name="test-client")
    t.start()
    return t


# -- the wire against the JAX package's ------------------------------------


def _payload(seed):
    rng = numpy.random.RandomState(seed)
    return {
        "cmd": "job",
        "data": {"fc0": {"F": {"weights": rng.randn(40, 30).astype(
            numpy.float32), "bias": rng.randn(30).astype(numpy.float32)},
            "v": 3},
            "loader": {"indices": rng.permutation(96).astype(
                numpy.int32), "minibatch_class": 2, "epoch_number": 1},
            "nested": [rng.randn(8, 8), ("tiny", numpy.arange(3)),
                       {"u16": rng.randint(0, 60000, 700).astype(
                           numpy.uint16)}]},
    }


def _plain(skeleton):
    """A frame header's skeleton with each tensor placeholder as its
    index."""
    if type(skeleton).__name__ == "_TensorRef":
        return ("tensor", skeleton.i)
    if isinstance(skeleton, dict):
        return {k: _plain(v) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_plain(v) for v in skeleton)
    if isinstance(skeleton, numpy.ndarray):
        return ("array", skeleton.dtype.str, skeleton.tobytes())
    return skeleton


def test_codecs_and_frames_are_byte_equal_to_jax():
    """On the same seeded numpy inputs the port's codecs and frames are
    the JAX package's byte for byte: bf16 both ways, int8 (same seed),
    ``encode_delta``/``decode_delta`` on every ``DELTA_DTYPES`` rung,
    ``encode_message`` in the pickle format under both codecs (in the
    tensor format: its blobs, and its header's content), and a frame's
    HMAC under a nonce and a sequence number."""
    import veles_tpu.network_common as jnc
    import veles_tpu_torch.network_common as tnc
    rng = numpy.random.RandomState(17)
    x = (rng.randn(5000) * 1e-3).astype(numpy.float32)
    x[:3] = (numpy.nan, numpy.inf, -0.0)
    assert tnc.encode_bf16(x).tobytes() == jnc.encode_bf16(x).tobytes()
    h = tnc.encode_bf16(x)
    assert tnc.decode_bf16(h, x.shape).tobytes() == \
        jnc.decode_bf16(h, x.shape).tobytes()
    y = x[3:]
    for seed in (0, 5, 123456789):
        a, b = tnc.encode_int8(y, seed=seed), jnc.encode_int8(y, seed=seed)
        assert a["sc"] == b["sc"]
        assert a["i8"].tobytes() == b["i8"].tobytes()
        assert tnc.decode_int8(a).tobytes() == jnc.decode_int8(b).tobytes()
    assert tnc.encode_int8(x) is None and jnc.encode_int8(x) is None
    assert list(tnc.DELTA_DTYPES) == list(jnc.DELTA_DTYPES)
    for name in tnc.DELTA_DTYPES:
        a = tnc.encode_delta(y, name, seed=9)
        b = jnc.encode_delta(y, name, seed=9)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert sorted(a) == sorted(b)
        for k in a:
            assert numpy.asarray(a[k]).tobytes() == \
                numpy.asarray(b[k]).tobytes(), (name, k)
        assert tnc.decode_delta(a).tobytes() == \
            jnc.decode_delta(b).tobytes()
    # An unknown payload is refused by both.
    with pytest.raises(tresilience.ProtocolError):
        tnc.decode_delta({"zz": 1})
    obj = _payload(3)
    for codec in ("none", "gzip"):
        fa, pa = tnc.encode_message(obj, codec=tnc.WireCodec(codec, 1, 256))
        fb, pb = jnc.encode_message(obj, codec=jnc.WireCodec(codec, 1, 256))
        assert fa == fb
        assert b"".join(bytes(p) for p in pa) == \
            b"".join(bytes(p) for p in pb), codec
        # A tensor frame: the tensor blobs are byte-equal, and so is the
        # header's content; its pickle names the placeholder class by
        # its package's module, so the header bytes differ there.
        fa, pa = tnc.encode_message(
            obj, codec=tnc.WireCodec(codec, 1, 256), tensor=True)
        fb, pb = jnc.encode_message(
            obj, codec=jnc.WireCodec(codec, 1, 256), tensor=True)
        assert fa == fb and len(pa) == len(pb)
        assert [bytes(p) for p in pa[1:]] == [bytes(p) for p in pb[1:]]
        ha, hb = (pickle.loads(bytes(p[0])[4:]) for p in (pa, pb))
        assert ha[1] == hb[1]
        assert _plain(ha[0]) == _plain(hb[0])
    key, nonce = b"secret", os.urandom(16)
    flags, parts = tnc.encode_message(obj, tensor=True)
    body = b"".join(bytes(p) for p in parts)
    for seq in (None, 0, 7):
        assert tnc._mac_parts(key, flags, parts, nonce, seq) == \
            jnc._mac_parts(key, flags, parts, nonce, seq)
    want = hmac.new(key, nonce + struct.pack(">Q", 7) + bytes([flags]) +
                    body, hashlib.sha256).digest()
    assert tnc._mac_parts(key, flags, [body], nonce, 7) == want
    # A frame sent by the port reads back through the JAX package's
    # receive path (and the reverse), MAC-checked at the same sequence.
    for send, recv in ((tnc.send_message, jnc.recv_message),
                       (jnc.send_message, tnc.recv_message)):
        a, b = socket.socketpair()
        try:
            t = threading.Thread(target=send, args=(a, obj), kwargs=dict(
                secret=key, nonce=nonce, seq=3))
            t.start()
            got = recv(b, secret=key, nonce=nonce, seq=3)
            joined(t)
        finally:
            a.close()
            b.close()
        numpy.testing.assert_array_equal(
            got["data"]["fc0"]["F"]["weights"],
            obj["data"]["fc0"]["F"]["weights"])


# -- the JAX package's test_network.py, on the port ------------------------


def test_parse_address():
    assert parse_address("1.2.3.4:99") == ("1.2.3.4", 99)
    assert parse_address(":99") == ("0.0.0.0", 99)
    assert parse_address("host", 5050) == ("host", 5050)


def test_framing_roundtrip_with_compression():
    a, b = socket.socketpair()
    big = {"cmd": "job", "data": numpy.zeros(100000)}
    t = threading.Thread(target=send_message, args=(a, big))
    t.start()
    got = recv_message(b)
    joined(t)
    assert got["cmd"] == "job"
    assert got["data"].shape == (100000,)
    a.close()
    b.close()


def test_handshake_job_update_cycle():
    master = InstrumentedWorkflow(Launcher())
    slave = InstrumentedWorkflow(Launcher())
    server = Server("127.0.0.1:0", master)
    client = Client("127.0.0.1:%d" % server.port, slave)
    t = run_client(client)
    server.wait(timeout=20)
    joined(t)
    stopped(server)
    assert master.generated == 3
    assert master.applied_from_slave == 3
    assert slave.jobs_run == 3
    assert client.id is not None


def test_checksum_mismatch_rejected():
    class OtherWorkflow(InstrumentedWorkflow):
        @property
        def checksum(self):
            return "different"

    master = InstrumentedWorkflow(Launcher())
    slave = OtherWorkflow(Launcher())
    server = Server("127.0.0.1:0", master)
    client = Client("127.0.0.1:%d" % server.port, slave,
                    reconnect_attempts=0)
    client.run()
    stopped(server)
    assert client.id is None
    assert slave.jobs_run == 0


def test_drop_slave_on_disconnect():
    master = InstrumentedWorkflow(Launcher())
    master.job_limit = 1000000  # never finishes on its own
    server = Server("127.0.0.1:0", master)
    chan, ack = handshook_channel(server, master)
    chan.send({"cmd": "job_request"})
    assert chan.recv()["cmd"] == "job"
    chan.close()
    deadline = time.time() + 10
    while not master.dropped and time.time() < deadline:
        time.sleep(0.02)
    stopped(server)
    assert master.dropped == [ack["id"]]
    assert not server.slaves


def test_replayed_frame_rejected():
    """A frame captured in one session and replayed (same bytes) fails
    the MAC: the sequence number moved on."""
    master = InstrumentedWorkflow(Launcher())
    master.job_limit = 1000000
    server = Server("127.0.0.1:0", master)
    chan, _ = handshook_channel(server, master)
    from veles_tpu_torch import network_common as tnc
    flags, parts = chan.encode({"cmd": "job_request"})
    chan.send_parts(flags, parts)
    assert chan.recv()["cmd"] == "job"
    # Replay the same frame at the same sequence number.
    chan.send_seq -= 1
    chan.send_parts(flags, parts)
    assert chan.recv() is None  # the server hung up
    deadline = time.time() + 10
    while server.slaves and time.time() < deadline:
        time.sleep(0.02)
    assert not server.slaves
    chan.close()
    stopped(server)
    assert tnc.MAX_FRAME_SIZE == 1 << 30


def test_unauthenticated_frames_rejected():
    """A peer without the secret cannot get past the handshake: its
    frames fail the MAC and are never unpickled."""
    master = InstrumentedWorkflow(Launcher())
    server = Server("127.0.0.1:0", master)
    from veles_tpu_torch.network_common import connect
    sock = connect("127.0.0.1:%d" % server.port, timeout=5)
    send_message(sock, {"cmd": "handshake", "checksum": master.checksum,
                        "mid": "x", "pid": 1, "power": 1.0},
                 secret=b"wrong key")
    sock.settimeout(10)
    try:
        reply = recv_message(sock, secret=b"wrong key")
    except OSError:
        reply = None
    assert reply is None
    assert not server.slaves
    sock.close()
    stopped(server)


def test_launcher_master_slave_modes():
    """``Launcher(listen_address=...)`` is the master and
    ``Launcher(master_address=...)`` a worker; the master's ``run``
    waits for its server, the worker's runs the client's job loop and
    puts the SIGTERM handler back after it."""
    m_launcher = Launcher(listen_address="127.0.0.1:0")
    master = InstrumentedWorkflow(m_launcher)
    assert m_launcher.is_master and m_launcher.mode == "master"
    m_launcher.initialize(device="cpu")
    addr = "127.0.0.1:%d" % m_launcher.server.port
    s_launcher = Launcher(master_address=addr,
                          slave_kwargs={"reconnect_attempts": 1})
    slave = InstrumentedWorkflow(s_launcher)
    assert s_launcher.is_slave and s_launcher.mode == "slave"
    s_launcher.initialize(device="cpu")
    t = threading.Thread(target=s_launcher.run, name="test-worker")
    t.start()
    m_launcher.run()
    joined(t)
    assert master.generated == 3
    assert slave.jobs_run == 3
    assert m_launcher.server.join(1.0) == []


def test_launcher_refuses_what_is_not_ported():
    """Heartbeats (``status_address``), ported in A8b-i, no longer raise:
    the launcher keeps the address and starts nothing before
    ``initialize``; the fleet mode (``nodes``), ported, takes its nodes
    and worker argv and spawns nothing before ``initialize``."""
    beating = Launcher(status_address="127.0.0.1:1",
                       heartbeat_interval=0.5)
    assert beating.status_address == "127.0.0.1:1"
    assert beating.heartbeat_interval == 0.5
    assert beating._heartbeat_thread is None and beating.heartbeats == 0
    launcher = Launcher(listen_address="127.0.0.1:0", nodes=["local"],
                        worker_argv=["wf.py", "-m", "{master}"])
    assert launcher.nodes == ["local"] and launcher.is_master
    assert launcher.worker_processes == []
    assert launcher._worker_command("127.0.0.1:9")[-3:] == [
        "wf.py", "-m", "127.0.0.1:9"]


def test_tracing_hello_is_refused_naming_a8a():
    """A worker whose hello asks for span tracing (as the JAX package's
    and the port's workers do) is granted ``trace`` as JAX's
    ``negotiate_protocol`` grants it — when the master traces, by the
    live switch or the config — and over a socket the handshake's
    reply carries it."""
    from veles_tpu.server import negotiate_protocol as jnegotiate
    from veles_tpu_torch.network_common import Channel, connect
    from veles_tpu_torch.observability import tracing
    from veles_tpu_torch.server import negotiate_protocol
    from veles_tpu.observability import tracing as jtracing
    hellos = [{"proto": {"tensor": True, "delta": True, "trace": t}}
              for t in (True, False)]
    try:
        for live in (False, True):
            for mod in (tracing, jtracing):
                (mod.enable if live else mod.disable)()
            for hello in hellos:
                for want in (None, True, False):
                    cfg = {"mode": "delta", "trace": want}
                    assert negotiate_protocol(hello, cfg) == \
                        jnegotiate(hello, dict(cfg)), (live, hello, want)
        tracing.enable()
        master = InstrumentedWorkflow(Launcher())
        server = Server("127.0.0.1:0", master)
        chan = Channel(connect("127.0.0.1:%d" % server.port),
                       master.checksum)
        chan.send({"cmd": "handshake", "checksum": master.checksum,
                   "mid": machine_id(), "pid": 1, "power": 1.0,
                   "proto": {"tensor": True, "delta": True,
                             "trace": True}})
        reply = chan.recv()
        chan.close()
        stopped(server)
    finally:
        tracing.reset()
        jtracing.reset()
    assert reply["cmd"] == "handshake_ack"
    assert reply["proto"]["trace"] is True


# -- training over loopback ------------------------------------------------


def write_mnist_idx(directory, seed=11, n_train=480, n_valid=160):
    """Seeded class-structured 28x28 images and labels as the four
    MNIST IDX files under ``directory/mnist``: a smooth 4x4 prototype a
    class under noise."""
    rng = numpy.random.RandomState(seed)
    up = (numpy.arange(28) * 4) // 28
    protos = rng.rand(10, 4, 4)[:, up][:, :, up]
    d = os.path.join(directory, "mnist")
    os.makedirs(d, exist_ok=True)
    for prefix, n in (("train", n_train), ("t10k", n_valid)):
        labels = rng.randint(0, 10, n).astype(numpy.uint8)
        images = numpy.clip(128.0 + (protos[labels] - 0.5) * 200.0 +
                            rng.normal(0.0, 100.0, (n, 28, 28)), 0, 255)
        with open(os.path.join(d, prefix + "-images-idx3-ubyte"),
                  "wb") as fout:
            fout.write(struct.pack(">IIII", 0x803, n, 28, 28))
            fout.write(images.astype(numpy.uint8).tobytes())
        with open(os.path.join(d, prefix + "-labels-idx1-ubyte"),
                  "wb") as fout:
            fout.write(struct.pack(">II", 0x801, n))
            fout.write(labels.tobytes())


#: The tiny MLP of the loopback runs.
MLP = dict(layers=(32, 10), minibatch_size=32, max_epochs=2,
           learning_rate=0.05, gradient_moment=0.5)
#: Parameters vs the JAX package's: the tolerance of the port's other
#: f32 parity tests.
RTOL, ATOL = 2e-4, 2e-5


def _port_mlp(seed=5, **kw):
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    tprng.reset()
    tprng.get(0).seed(seed)
    launcher = Launcher()
    wf = MnistWorkflow(launcher, **dict(MLP, **kw))
    launcher.initialize(device="cpu")
    return wf


def _jax_mlp(seed=5, **kw):
    import veles_tpu.prng as jprng
    from veles_tpu.launcher import Launcher as JLauncher
    from veles_tpu.znicz.samples.mnist import MnistWorkflow
    jprng.reset()
    jprng.get(0).seed(seed)
    launcher = JLauncher()
    wf = MnistWorkflow(launcher, **dict(MLP, **kw))
    launcher.initialize()
    return wf


def trainables(wf):
    out = {}
    for u in wf.units:
        for attr, vec in (getattr(u, "trainables", None) or {}).items():
            vec.map_read()
            out["%s/%s" % (u.name, attr)] = numpy.array(vec.mem)
    return out


def _loopback(build, server_cls, client_cls, ticks):
    """One master and one worker of the same build over loopback, the
    worker in a thread; returns the master after the run."""
    worker = build()
    master = build()
    server = server_cls("127.0.0.1:0", master)
    client = client_cls("127.0.0.1:%d" % server.port, worker,
                        reconnect_attempts=1)
    t = threading.Thread(target=client.run, name="test-client")
    t.start()
    server.wait(timeout=120)
    joined(t, 60)
    server.stop()
    return master, client


@pytest.fixture
def mlp_data(tmp_path):
    """Synthetic MNIST files for both packages, f32 activations in
    both, ``ticks`` jobs of the data plane."""
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root as troot
    write_mnist_idx(str(tmp_path))
    for r in (jroot, troot):
        r.common.dirs.datasets = str(tmp_path)
        r.common.engine.precision_level = 1
        r.common.net.job_ticks = 2
        r.common.net.codec = "none"
    return jroot, troot


def test_loopback_training_matches_jax(mlp_data):
    """A JAX master with a JAX worker and a port master with a port
    worker, each pair over loopback with fp32 deltas and jobs of two
    ticks: after the same two epochs of jobs their weights agree within
    rtol 2e-4 / atol 2e-5, and their decisions counted alike."""
    from veles_tpu.client import Client as JClient
    jmaster, jclient = _loopback(_jax_mlp, JaxServer.make, JClient, 2)
    tmaster, tclient = _loopback(_port_mlp, Server, Client, 2)
    assert tclient.jobs_done == jclient.jobs_done > 0
    assert tmaster.decision.epoch_number == \
        jmaster.decision.epoch_number == MLP["max_epochs"]
    got, want = trainables(tmaster), trainables(jmaster)
    assert sorted(got) == sorted(want)
    for name in want:
        numpy.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                      atol=ATOL, err_msg=name)
    assert tmaster.decision.epoch_n_valid == jmaster.decision.epoch_n_valid


@pytest.mark.parametrize("ticks", [1, 2])
def test_loopback_training_equals_in_process_ticks(mlp_data, ticks):
    """The port's loopback run — one worker, fp32 deltas, jobs of
    ``ticks`` ticks — ends on the port's in-process ticks from the same
    seed bit for bit: the worker trains from the master's exact weights
    and the master folds each job's result exactly."""
    mlp_data[1].common.net.job_ticks = ticks
    master, client = _loopback(_port_mlp, Server, Client, ticks)
    ref = _port_mlp()
    ref.workflow.run()
    assert master.decision.epoch_number == ref.decision.epoch_number
    got, want = trainables(master), trainables(ref)
    for name in want:
        assert numpy.array_equal(got[name], want[name]), name
    assert master.decision.min_validation_err == \
        ref.decision.min_validation_err
    # A job's block never straddles a class: per epoch, each class's
    # minibatches in jobs of up to ``ticks``.
    mb = MLP["minibatch_size"]
    per_epoch = sum(-(-(-(-n // mb)) // ticks)
                    for n in ref.loader.class_lengths)
    assert client.jobs_done == per_epoch * MLP["max_epochs"]
