"""The port's data plane (the JAX package's ``tests/test_dataplane.py``):
the delta wire protocol, zero-copy tensor framing, protocol negotiation,
multi-tick jobs and the wire bytes per minibatch.

The equivalence tests drive the master/worker workflow contract
directly (no sockets) on a fixed round-robin schedule, so two runs see
the same update order; the wire gets its own socketpair and loopback
coverage.  Every test runs under ``kept_process_state``
(``test_torch_network.py``).
"""

import socket
import threading
import time

import numpy
import pytest

import veles_tpu_torch.prng as tprng
from veles_tpu_torch import resilience
from veles_tpu_torch.client import Client
from veles_tpu_torch.config import root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.network_common import (
    Channel, WireCodec, decode_bf16, encode_bf16, encode_message,
    parse_codec_spec, recv_message, send_message)
from veles_tpu_torch.resilience import ProtocolError
from veles_tpu_torch.server import Server, negotiate_protocol

from test_torch_network import (InstrumentedWorkflow, handshook_channel,
                                joined, kept_process_state, run_client,
                                stopped, trainables)

#: The protocol a real handshake negotiates with the default config,
#: for the in-process loops.
DELTA_PROTO = {"tensor": True, "delta": True, "codec": "none",
               "dtype": "fp32", "ticks": 1}
#: No dataset directory: MNIST takes scikit-learn's digits.
NO_DATASETS = "/nonexistent/veles-datasets"


@pytest.fixture(autouse=True)
def _process_state():
    with kept_process_state():
        root.common.dirs.datasets = NO_DATASETS
        yield


# -- tensor framing --------------------------------------------------------


def _framed_roundtrip(obj, proto):
    a, b = socket.socketpair()
    try:
        ca, cb = Channel(a, secret="s"), Channel(b, secret="s")
        ca.set_proto(proto)
        cb.set_proto(proto)
        t = threading.Thread(target=ca.send, args=(obj,))
        t.start()
        got = cb.recv()
        joined(t)
        return got
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("codec", ["none", "gzip"])
def test_tensor_framing_roundtrip(codec):
    """ndarrays leave the pickle and survive bit-exactly through the
    framed format, nested anywhere in the message, under both codecs."""
    obj = {
        "cmd": "job",
        "data": {
            "fc0": {"F": {"weights":
                          numpy.arange(3000, dtype=numpy.float32)
                          .reshape(30, 100),
                          "bias": numpy.ones(100, numpy.float32)},
                    "v": 3},
            "loader": {"indices": numpy.arange(64, dtype=numpy.int32)},
            "nested": [numpy.zeros((4, 4), numpy.float64),
                       ("tiny", numpy.arange(3)),  # stays in the pickle
                       {"u16": numpy.arange(500, dtype=numpy.uint16)}],
        },
    }
    got = _framed_roundtrip(
        obj, {"tensor": True, "codec": codec, "codec_threshold": 1024})
    assert got["cmd"] == "job"
    fc0 = got["data"]["fc0"]
    assert fc0["v"] == 3
    assert fc0["F"]["weights"].dtype == numpy.float32
    numpy.testing.assert_array_equal(
        fc0["F"]["weights"], obj["data"]["fc0"]["F"]["weights"])
    numpy.testing.assert_array_equal(got["data"]["loader"]["indices"],
                                     obj["data"]["loader"]["indices"])
    nested = got["data"]["nested"]
    assert nested[0].dtype == numpy.float64
    assert isinstance(nested[1], tuple) and nested[1][0] == "tiny"
    numpy.testing.assert_array_equal(nested[2]["u16"],
                                     obj["data"]["nested"][2]["u16"])
    assert resilience.stats.get("net.bytes_sent") > 0
    assert resilience.stats.get("net.bytes_recv") > 0


def test_tensor_framing_arrays_writable():
    arr = numpy.arange(2000, dtype=numpy.float32)
    got = _framed_roundtrip({"a": arr}, {"tensor": True, "codec": "none"})
    got["a"][0] = 42.0
    assert got["a"][0] == 42.0
    got = _framed_roundtrip({"a": arr}, {"tensor": True, "codec": "gzip",
                                         "codec_threshold": 16})
    got["a"][1] = 7.0
    assert got["a"][1] == 7.0


def test_tensor_frame_respects_message_cap():
    """A tensor frame whose decompressed payload exceeds the receiver's
    cap reads as a dead peer."""
    from veles_tpu_torch.network_common import send_parts
    a, b = socket.socketpair()
    try:
        flags, parts = encode_message(
            {"a": numpy.zeros(1 << 16, numpy.uint8)},
            codec=WireCodec("gzip", 1, 16), tensor=True)
        t = threading.Thread(target=send_parts, args=(a, flags, parts))
        t.start()
        got = recv_message(b, max_message=1024)
        joined(t)
        assert got is None
    finally:
        a.close()
        b.close()


def test_sender_bounds_raw_not_compressed_size(monkeypatch):
    import veles_tpu_torch.network_common as nc
    monkeypatch.setattr(nc, "MAX_MESSAGE_SIZE", 16 * 1024)
    big = numpy.zeros(1 << 15, numpy.uint8)  # 32 KiB raw, gzips tiny
    with pytest.raises(ValueError):
        encode_message({"a": big}, codec=WireCodec("gzip", 1, 16),
                       tensor=True)
    with pytest.raises(ValueError):
        encode_message({"a": big.tobytes()},
                       codec=WireCodec("gzip", 1, 16))


def test_legacy_frames_interoperate_with_new_recv():
    a, b = socket.socketpair()
    try:
        send_message(a, {"cmd": "x", "arr": numpy.arange(5000.0)})
        got = recv_message(b)
        assert got["cmd"] == "x"
        numpy.testing.assert_array_equal(got["arr"], numpy.arange(5000.0))
    finally:
        a.close()
        b.close()


def test_parse_codec_spec():
    assert parse_codec_spec("gzip") == ("gzip", None, None)
    assert parse_codec_spec("gzip:6") == ("gzip", 6, None)
    assert parse_codec_spec("gzip:6:4096") == ("gzip", 6, 4096)
    assert parse_codec_spec("none") == ("none", None, None)
    with pytest.raises(ValueError):
        parse_codec_spec("snappy")


def test_codec_threshold_and_level():
    payload = bytes(numpy.arange(8192, dtype=numpy.uint8).repeat(4))
    small = WireCodec("gzip", 1, threshold=1 << 20)
    assert small.pack(payload) == (False, payload)
    c1, p1 = WireCodec("gzip", 1, threshold=16).pack(payload)
    c9, p9 = WireCodec("gzip", 9, threshold=16).pack(payload)
    assert c1 and c9
    assert len(p9) <= len(p1) < len(payload)
    assert WireCodec("none").pack(payload) == (False, payload)


def test_bf16_roundtrip():
    exact = numpy.array([0.0, 1.0, -2.5, 0.15625, 2.0 ** 38],
                        numpy.float32)
    assert decode_bf16(encode_bf16(exact)).tolist() == exact.tolist()
    vals = numpy.random.RandomState(7).randn(4096).astype(
        numpy.float32) * 1e-3
    back = decode_bf16(encode_bf16(vals), vals.shape)
    err = numpy.abs(back - vals) / numpy.maximum(numpy.abs(vals), 1e-30)
    assert float(err.max()) < 2.0 ** -8
    weird = numpy.array([numpy.nan, numpy.inf, -numpy.inf],
                        numpy.float32)
    back = decode_bf16(encode_bf16(weird))
    assert numpy.isnan(back[0]) and numpy.isposinf(back[1]) \
        and numpy.isneginf(back[2])


# -- the deterministic master/worker loop ----------------------------------


def _mnist(seed, **kwargs):
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    kwargs.setdefault("max_epochs", 3)
    kwargs.setdefault("learning_rate", 0.1)
    kwargs.setdefault("gradient_moment", 0.5)
    tprng.reset()
    tprng.get(0).seed(seed)
    launcher = Launcher()
    wf = MnistWorkflow(launcher, **kwargs)
    launcher.initialize(device="cpu")
    return wf


def _drive(master, workers, proto, max_cycles=2000):
    """Round robin: serve every worker, then apply every reply, until
    the master's decision completes (``proto`` None: the protocols are
    noted already)."""
    if proto is not None:
        for sid, wf in workers.items():
            master.note_slave_protocol(sid, proto)
            wf.note_net_proto(proto)
    for _ in range(max_cycles):
        if master.should_stop_serving():
            return
        jobs = {}
        for sid in workers:
            if master.should_stop_serving():
                break
            job = master.generate_data_for_slave(sid)
            if job is not None:
                jobs[sid] = job
        if not jobs:
            return
        for sid, job in jobs.items():
            replies = []
            workers[sid].do_job(job, None, replies.append)
            master.apply_data_from_slave(replies[0], sid)
    raise AssertionError("the loop did not converge in %d cycles"
                         % max_cycles)


def test_delta_protocol_bit_identical_to_legacy():
    """Three epochs of master + 2 workers with the delta protocol end
    on the legacy full-weights path's trainables bit for bit (fp32,
    codec none, the same schedule)."""
    results = {}
    for name, proto in (("legacy", {}), ("delta", DELTA_PROTO)):
        master = _mnist(1234)
        workers = {"w1": _mnist(1234), "w2": _mnist(1234)}
        _drive(master, workers, proto)
        assert master.decision.epoch_number == 3
        results[name] = trainables(master)
    legacy, delta = results["legacy"], results["delta"]
    assert set(legacy) == set(delta) and legacy
    for key in legacy:
        assert legacy[key].dtype == delta[key].dtype
        assert numpy.array_equal(legacy[key], delta[key]), key


def test_delta_mode_collapses_shipped_fifo():
    """Delta mode keeps one synced base per worker, not a FIFO of full
    copies per in-flight job (legacy mode's)."""
    master = _mnist(5, max_epochs=5)
    master.note_slave_protocol("w1", DELTA_PROTO)
    for _ in range(4):
        master.generate_data_for_slave("w1")
    for unit in master.units:
        if not getattr(unit, "trainables", None):
            continue
        assert not unit._shipped_, unit.name
        assert set(unit._synced_) == {"w1"}
        assert isinstance(unit._synced_["w1"][1], dict)
        # No update landed: one weights version, one base.
        assert len(unit._bases_["w1"]) == 1
    legacy = _mnist(5, max_epochs=5)
    for _ in range(4):
        legacy.generate_data_for_slave("w1")
    lens = [len(u._shipped_.get("w1", [])) for u in legacy.units
            if getattr(u, "trainables", None)]
    assert lens and all(n == 4 for n in lens)


def test_delta_piece_shapes():
    """The first job ships full weights, later ones deltas; an unchanged
    interval collapses to None; a worker's fp32 update is an exact XOR
    against its base."""
    master = _mnist(9, max_epochs=5)
    worker = _mnist(9, max_epochs=5)
    master.note_slave_protocol("w1", DELTA_PROTO)
    worker.note_net_proto(DELTA_PROTO)
    job1 = master.generate_data_for_slave("w1")
    assert "F" in job1["fc0"] and "weights" in job1["fc0"]["F"]
    job2 = master.generate_data_for_slave("w1")
    assert "D" in job2["fc0"]
    assert all(v is None for v in job2["fc0"]["D"].values())
    for job in (job1, job2):
        replies = []
        worker.do_job(job, None, replies.append)
        assert "U" in replies[0]["fc0"]
        master.apply_data_from_slave(replies[0], "w1")
    for _ in range(20):
        job = master.generate_data_for_slave("w1")
        replies = []
        worker.do_job(job, None, replies.append)
        update = replies[0]["fc0"]["U"]["weights"]
        master.apply_data_from_slave(replies[0], "w1")
        if job["__job__"]["minibatch_class"] == 2:  # TRAIN
            break
    else:
        raise AssertionError("never reached a training job")
    assert sorted(update) == ["x"] and update["x"].dtype == numpy.uint32
    piece = master.generate_data_for_slave("w1")["fc0"]
    assert "D" in piece
    assert any(v is not None for v in piece["D"].values())


def test_delta_version_mismatch_raises_protocol_error():
    master = _mnist(11)
    worker = _mnist(11)
    master.note_slave_protocol("w1", DELTA_PROTO)
    worker.note_net_proto(DELTA_PROTO)
    worker.apply_data_from_master(master.generate_data_for_slave("w1"))
    job2 = master.generate_data_for_slave("w1")
    assert "D" in job2["fc0"]
    job2["fc0"]["bv"] = 999  # a stale base
    with pytest.raises(ProtocolError):
        worker.apply_data_from_master(job2)
    fresh = _mnist(11)
    fresh.note_net_proto(DELTA_PROTO)
    with pytest.raises(ProtocolError):
        fresh.apply_data_from_master(job2)


def test_bf16_delta_session_trains():
    proto = dict(DELTA_PROTO, dtype="bf16")
    master = _mnist(21, max_epochs=3)
    _drive(master, {"w1": _mnist(21, max_epochs=3)}, proto)
    assert master.decision.epoch_number == 3
    assert master.decision.min_validation_err < 0.3


# -- protocol negotiation --------------------------------------------------


def test_negotiate_protocol_matrix():
    cfg = {"mode": "delta", "codec": "gzip", "codec_level": 1,
           "codec_threshold": 64, "dtype": "bf16", "job_ticks": 4,
           "require": False}
    proto, err = negotiate_protocol({"cmd": "handshake"}, cfg)
    assert proto == {} and err is None
    hello = {"proto": {"tensor": True, "delta": True, "block": True,
                       "codecs": ("none", "gzip"),
                       "dtypes": ("fp32", "bf16")}}
    proto, err = negotiate_protocol(hello, cfg)
    assert err is None
    assert proto["tensor"] and proto["delta"]
    assert proto["codec"] == "gzip" and proto["dtype"] == "bf16"
    assert proto["ticks"] == 4
    hello2 = {"proto": {"tensor": True, "delta": True,
                        "codecs": ("none",), "dtypes": ("fp32",)}}
    proto, err = negotiate_protocol(hello2, cfg)
    assert proto["ticks"] == 1
    assert proto["codec"] == "none" and proto["dtype"] == "fp32"
    proto, err = negotiate_protocol(hello, dict(cfg, mode="legacy"))
    assert proto == {} and err is None
    proto, err = negotiate_protocol({}, dict(cfg, require=True))
    assert proto is None
    assert "net-require" in err and "pickle-compat" in err
    # The same matrix through the JAX package's negotiation.
    from veles_tpu.server import negotiate_protocol as jnegotiate
    for h, c in ((hello, cfg), (hello2, cfg), ({}, cfg),
                 (hello, dict(cfg, zero=2)),
                 ({"proto": dict(hello["proto"], slots=True)},
                  dict(cfg, zero=2))):
        assert negotiate_protocol(h, dict(c)) == \
            jnegotiate(h, dict(c, trace=False))


class _ProtoWorkflow(object):
    """A minimal master workflow for the raw-socket tests."""

    checksum = "proto-test"
    stopped = False

    def __init__(self):
        self.applied = []
        self.slave_protos = {}

    def generate_initial_data_for_slave(self, slave):
        return None

    def generate_data_for_slave(self, slave=None):
        return {"n": 1}

    def apply_data_from_slave(self, data, slave=None):
        self.applied.append((slave, data))

    def drop_slave(self, slave=None):
        pass

    def note_slave_protocol(self, slave, proto):
        self.slave_protos[slave] = proto

    def should_stop_serving(self):
        return False


def test_old_format_peer_gets_clean_rejection_with_require():
    root.common.net.require = True
    master = _ProtoWorkflow()
    server = Server("127.0.0.1:0", master)
    try:
        from veles_tpu_torch.network_common import connect, machine_id
        chan = Channel(connect("127.0.0.1:%d" % server.port),
                       master.checksum)
        chan.send({"cmd": "handshake", "checksum": master.checksum,
                   "mid": machine_id(), "pid": 1, "power": 1.0})
        reply = chan.recv()
        assert reply["cmd"] == "error"
        assert "upgrade the worker" in reply["error"]
        chan.close()
        client = Client("127.0.0.1:%d" % server.port, _ProtoWorkflow(),
                        net_legacy=True, reconnect_attempts=0)
        client.run()  # returns promptly: HandshakeRejected
        assert client.id is None
    finally:
        stopped(server)


def test_new_master_serves_old_worker_pickle_compat():
    master = InstrumentedWorkflow(Launcher())
    server = Server("127.0.0.1:0", master)
    slave = InstrumentedWorkflow(Launcher())
    t = run_client(Client("127.0.0.1:%d" % server.port, slave,
                          net_legacy=True))
    server.wait(timeout=20)
    joined(t)
    stopped(server)
    assert master.applied_from_slave == 3
    assert slave.jobs_run == 3
    assert all(p == {} for p in master._slave_proto_.values())


def test_capable_peer_negotiates_tensor_frames():
    master = InstrumentedWorkflow(Launcher())
    server = Server("127.0.0.1:0", master)
    slave = InstrumentedWorkflow(Launcher())
    t = run_client(Client("127.0.0.1:%d" % server.port, slave))
    server.wait(timeout=20)
    joined(t)
    stopped(server)
    assert slave.jobs_run == 3
    protos = list(master._slave_proto_.values())
    assert protos and protos[0].get("tensor") and protos[0].get("delta")


def test_job_serialization_does_not_block_updates():
    """Worker A's job serialization must not block worker B's update:
    only the bookkeeping half of job generation holds the lock."""
    master = InstrumentedWorkflow(Launcher())
    master.job_limit = 1000000
    server = Server("127.0.0.1:0", master)
    serializing = threading.Event()
    release = threading.Event()
    orig = Server._serialize_job

    def slow_serialize(self, chan, job, extra=None):
        serializing.set()
        assert release.wait(10), "test deadlock"
        return orig(self, chan, job, extra)

    try:
        chan_a, _ = handshook_channel(server, master)
        chan_b, _ = handshook_channel(server, master)
        chan_b.send({"cmd": "job_request"})
        assert chan_b.recv()["cmd"] == "job"
        server._serialize_job = slow_serialize.__get__(server)
        chan_a.send({"cmd": "job_request"})
        assert serializing.wait(10)
        t0 = time.time()
        chan_b.send({"cmd": "update", "data": {"echo": 1}})
        ack = chan_b.recv()
        assert ack["cmd"] == "update_ack"
        assert time.time() - t0 < 5.0
        assert master.applied_from_slave == 1
        release.set()
        assert chan_a.recv()["cmd"] == "job"
        chan_a.close()
        chan_b.close()
    finally:
        release.set()
        stopped(server)


def test_nojob_backoff_grows_and_resets():
    import random
    from veles_tpu_torch.resilience import RetryPolicy
    client = Client(
        "127.0.0.1:1", _ProtoWorkflow(), poll_delay=0.01,
        nojob_policy=RetryPolicy(max_attempts=1 << 30, base_delay=0.01,
                                 factor=1.5, max_delay=2.0,
                                 rng=random.Random(1234)))
    delays = []
    client._sleep_interruptible = delays.append
    for _ in range(8):
        client._nojob_backoff()
    assert client._nojob_streak == 8 and len(delays) == 8
    assert max(delays[4:]) > max(delays[:2])
    assert all(0.0 <= d <= 2.5 for d in delays)
    client._nojob_streak = 0
    client._nojob_backoff()
    assert delays[-1] <= delays[3] * 2
    assert 0.0 < client.nojob_policy.delay(10000) <= 2.6


# -- multi-tick jobs -------------------------------------------------------


def test_multi_tick_jobs_train_and_account():
    proto = dict(DELTA_PROTO, ticks=4)
    master = _mnist(31, max_epochs=3)
    _drive(master, {"w1": _mnist(31, max_epochs=3),
                    "w2": _mnist(31, max_epochs=3)}, proto)
    assert master.decision.epoch_number == 3
    assert bool(master.decision.complete)
    assert master.decision.min_validation_err < 0.25
    assert master.total_inflight_jobs() == 0
    assert not master.loader._pending_indices_


def test_multi_tick_block_stays_in_one_class():
    master = _mnist(33, max_epochs=5)
    master.note_slave_protocol("w1", dict(DELTA_PROTO, ticks=1000))
    seen = []
    for _ in range(6):
        blk = master.generate_data_for_slave("w1")["MnistLoader"]["block"]
        classes = numpy.unique(blk["classes"])
        assert len(classes) == 1
        seen.append(int(classes[0]))
        assert blk["indices"].ndim == 2
        assert blk["indices"].shape[0] == blk["mask"].shape[0]
        master.loader.apply_data_from_slave(None, "w1")
        master._inflight_by_slave_.clear()
        master._inflight_count_.clear()
    assert 1 in seen and 2 in seen


def test_multi_tick_drop_requeues_every_tick():
    master = _mnist(35, max_epochs=5)
    master.note_slave_protocol("w1", dict(DELTA_PROTO, ticks=4))
    job = master.generate_data_for_slave("w1")
    blk = job["MnistLoader"]["block"]
    served = blk["indices"].shape[0]
    assert served > 1 and not master.loader.failed_minibatches
    master.drop_slave("w1")
    assert len(master.loader.failed_minibatches) == served
    requeued = numpy.sort(numpy.concatenate(
        [idx for idx, _ in master.loader.failed_minibatches]))
    shipped = numpy.sort(numpy.concatenate([
        row[:int(m.sum())] for row, m in zip(blk["indices"],
                                             blk["mask"])]))
    numpy.testing.assert_array_equal(requeued, shipped)


def test_comms_counters_of_a_loopback_run():
    """The counters the JAX package's dashboard shows in its comms row
    (web_status is ROADMAP A8b): bytes, frames, serialization and send
    time, and each worker's jobs and jobs per second on the server."""
    master = InstrumentedWorkflow(Launcher())
    server = Server("127.0.0.1:0", master)
    t = run_client(Client("127.0.0.1:%d" % server.port,
                          InstrumentedWorkflow(Launcher())))
    server.wait(timeout=20)
    joined(t)
    stopped(server)
    snap = resilience.stats.snapshot()
    for name in ("net.bytes_sent", "net.bytes_recv", "net.frames_sent",
                 "net.frames_recv", "fleet.join", "server.goodbye"):
        assert snap.get(name, 0) > 0, name
    # Both ends count in this process; a request on its way when the
    # master said bye is sent and never read.
    assert 0 < snap["net.bytes_sent"] - snap["net.bytes_recv"] < 200 or \
        snap["net.bytes_sent"] == snap["net.bytes_recv"]
    (desc,) = server.all_slaves.values()
    assert desc.jobs_done == 3 and desc.jobs_per_second > 0
    # The membership ledger: one join, one drain, two epochs.
    snap = server.fleet.snapshot()
    assert (snap["epoch"], snap["joins"], snap["drains"], snap["size"]) \
        == (2, 1, 1, 0)
    assert snap["last_event"][1] == "drain"


# -- wire bytes per minibatch ----------------------------------------------


def _loopback_run(seed, epochs, legacy, job_ticks=1):
    """Master + 2 workers over real sockets; (wire bytes, jobs,
    epochs)."""
    old = root.common.net.job_ticks
    root.common.net.job_ticks = job_ticks
    try:
        kw = dict(max_epochs=epochs, gradient_moment=0.0,
                  learning_rate=0.03)
        master = _mnist(seed, **kw)
        server = Server("127.0.0.1:0", master)
        resilience.stats.reset()
        clients, threads = [], []
        for _ in range(2):
            client = Client("127.0.0.1:%d" % server.port,
                            _mnist(seed, **kw), net_legacy=legacy,
                            reconnect_attempts=0)
            clients.append(client)
            threads.append(run_client(client))
        server.wait(timeout=240)
        for t in threads:
            joined(t, 60)
        stopped(server)
        assert len(server.all_slaves) == 2
        assert sum(d.jobs_done for d in server.all_slaves.values()) == \
            sum(c.jobs_done for c in clients)
        assert master.decision.epoch_number >= epochs
        return (resilience.stats.snapshot().get("net.bytes_sent", 0),
                sum(c.jobs_done for c in clients),
                master.decision.epoch_number)
    finally:
        root.common.net.job_ticks = old


def test_bytes_per_job_micro_bench():
    """Deltas + tensor framing + 8-tick jobs cut the wire bytes per
    minibatch trained by at least 5x against the legacy full-weights
    path (2 epochs, 2 workers).  Bytes only: the time of a loopback run
    on a shared CPU is not a gate."""
    legacy_bytes, legacy_jobs, legacy_ep = _loopback_run(77, 2, True)
    delta_bytes, delta_jobs, delta_ep = _loopback_run(77, 2, False, 8)
    assert legacy_jobs > 0 and delta_jobs > 0
    ticks_per_epoch = legacy_jobs / float(legacy_ep)
    legacy_per_tick = legacy_bytes / (ticks_per_epoch * legacy_ep)
    delta_per_tick = delta_bytes / (ticks_per_epoch * delta_ep)
    ratio = legacy_per_tick / max(delta_per_tick, 1e-9)
    assert ratio >= 5.0, (legacy_bytes, legacy_ep, delta_bytes, delta_ep)


def test_pipelined_pending_tracking_keeps_every_job():
    master = _mnist(37, max_epochs=5)
    master.note_slave_protocol("w1", DELTA_PROTO)
    for _ in range(3):
        master.generate_data_for_slave("w1")
    assert len(master.loader._pending_indices_["w1"]) == 3
    master.drop_slave("w1")
    assert len(master.loader.failed_minibatches) == 3


def test_net_flags_set_the_jax_command_lines_keys():
    """The data plane's flags leave the same ``root.common.net`` keys in
    both packages' trees, and ``-l``/``-m`` and the worker's flags
    reach the launcher as the JAX command line passes them."""
    import veles_tpu.__main__ as jmain
    import veles_tpu_torch.__main__ as tmain
    from veles_tpu.config import root as jroot
    argv = ["--net-codec", "gzip:6:4096", "--net-dtype", "int8",
            "--job-ticks", "4", "--net-zero", "2", "--net-legacy",
            "--net-require"]
    got = {}
    for main_mod, r in ((jmain, jroot), (tmain, root)):
        r.common.__dict__.pop("net", None)
        m = main_mod.Main(["wf.py"] + argv)
        m.parse()
        m.apply_subsystem_flags()
        got[main_mod.__name__] = dict(r.common.net.__dict__)
    assert got["veles_tpu.__main__"] == got["veles_tpu_torch.__main__"]
    assert got["veles_tpu_torch.__main__"]["codec_level"] == 6
    worker = ["-m", "127.0.0.1:5", "--async-slave", "--reconnect-attempts",
              "3", "--reconnect-delay", "0.5", "--preempt-grace", "2",
              "--slave-death-probability", "0.25", "--measure-power",
              "--chaos", "net.drop@job:3,seed:1"]
    kws = []
    for main_mod in (jmain, tmain):
        m = main_mod.Main(["wf.py"] + worker)
        m.parse()
        kws.append(m._launcher_kwargs())
    assert kws[0] == kws[1]
    assert kws[1]["slave_kwargs"]["death_exits"] is True
    m = tmain.Main(["wf.py", "-l", "127.0.0.1:0"])
    m.parse()
    assert m._launcher_kwargs() == {"listen_address": "127.0.0.1:0"}
    with pytest.raises(Exception, match="job-ticks"):
        m = tmain.Main(["wf.py", "--job-ticks", "0"])
        m.parse()
        m.apply_subsystem_flags()


# -- ZeRO over the wire (``--net-zero``) -----------------------------------


def _drive_protos(master, workers, protos):
    for sid, wf in workers.items():
        master.note_slave_protocol(sid, protos[sid])
        wf.note_net_proto(protos[sid])
    _drive(master, workers, None)


def _slot_state(wf):
    from veles_tpu_torch.znicz.nn_units import GradientDescentBase
    out = {}
    for unit in wf.units:
        if isinstance(unit, GradientDescentBase):
            for attr, vec in unit.tstate.items():
                vec.map_read()
                out["%s/%s" % (unit.name, attr)] = numpy.array(vec.mem)
    return out


def test_slot_sync_master_mirrors_trainer_bit_identical():
    """``--net-zero 1`` with one worker: the master's optimizer slots
    equal the trainer's bit for bit (the XOR reconstruction is
    exact)."""
    proto = dict(DELTA_PROTO, zero=1, zero_rank=0)
    master = _mnist(1234, optimizer="adam")
    worker = _mnist(1234, optimizer="adam")
    _drive_protos(master, {"w1": worker}, {"w1": proto})
    assert master.decision.epoch_number == 3
    ms, ws = _slot_state(master), _slot_state(worker)
    assert set(ms) == set(ws) and ms
    for key in ms:
        numpy.testing.assert_array_equal(ms[key], ws[key], err_msg=key)
    assert any(numpy.any(a != 0) for a in ms.values())


def test_slot_sync_shards_split_across_workers():
    """``--net-zero 2`` with two workers: each owns half of every slot
    tensor, and the master's state is the union, each half its
    owner's."""
    protos = {"w0": dict(DELTA_PROTO, zero=2, zero_rank=0),
              "w1": dict(DELTA_PROTO, zero=2, zero_rank=1)}
    master = _mnist(77, optimizer="adam")
    workers = {"w0": _mnist(77, optimizer="adam"),
               "w1": _mnist(77, optimizer="adam")}
    _drive_protos(master, workers, protos)
    ms = _slot_state(master)
    states = {sid: _slot_state(wf) for sid, wf in workers.items()}
    assert ms
    for key, marr in ms.items():
        flat = marr.reshape(-1)
        n = flat.size
        numpy.testing.assert_array_equal(
            flat[:n // 2], states["w0"][key].reshape(-1)[:n // 2])
        numpy.testing.assert_array_equal(
            flat[n // 2:], states["w1"][key].reshape(-1)[n // 2:])
    # Without the negotiated key no slot piece ships.
    plain = _mnist(5, optimizer="adam", max_epochs=2)
    plain.note_slave_protocol("w1", dict(DELTA_PROTO))
    job = plain.generate_data_for_slave("w1")
    assert not any(u.name in job for u in plain.units
                   if u.name.startswith("gd_"))


def test_adopt_synced_and_shipped_values_from_a_leader():
    """Exploit as a delta: a lineage's units adopt the leader's synced
    base at a worker (its next job ships an all-unchanged delta) and the
    values the leader shipped there."""
    proto = dict(DELTA_PROTO, zero=1, zero_rank=0)
    leader = _mnist(3, optimizer="adam")
    follower = _mnist(4, optimizer="adam")
    for wf in (leader, follower):
        wf.note_slave_protocol("w1", proto)
    leader.generate_data_for_slave("w1")
    pairs = [(f, l) for f, l in zip(follower.units, leader.units)
             if hasattr(f, "adopt_synced_from")]
    assert pairs
    for f, l in pairs:
        assert f.adopt_shipped_values(l, "w1") in (True, None)
        assert f.adopt_synced_from(l, "w1") in (True, None)
    job = follower.generate_data_for_slave("w1")
    pieces = [job[u.name] for u, _ in pairs if u.name in job]
    assert pieces and all("D" in p for p in pieces)
    assert all(v is None for p in pieces for v in p["D"].values())
    lt, ft = trainables(leader), trainables(follower)
    for key in lt:
        assert numpy.array_equal(lt[key], ft[key]), key
    # An unknown worker has nothing to adopt.
    assert all(f.adopt_synced_from(l, "w9") in (False, None)
               for f, l in pairs)
