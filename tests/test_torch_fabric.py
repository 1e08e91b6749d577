"""The port's serving fabric (``veles_tpu_torch.serving.fabric``) and KV
export/adoption against the JAX package's, on the CPU.

* KV planes: ``export_kv_blocks`` / ``import_kv_blocks`` on f32, bf16,
  int8 and fp8 pools of the same artifact, from the same seeded blocks:
  the stored codes and scales bit-equal to JAX's, the exports equal
  (exact on f32);
* the wire: ``pack_kv_payload`` frames equal to JAX's (the tensor
  blobs byte for byte; the header by content, since it pickles its
  placeholder class by module), malformed payloads rejected;
* routing: ``route_key`` and ``pick_replica`` equal JAX's for 200
  seeded prompts under the same replica names, the key byte-equal to
  the first entry of ``KVBlockPool.prefix_chain``, and a drain remaps
  only the drained replica's keys;
* tenants: ``parse_tenant_spec`` equals JAX's on accepted and rejected
  specs; over HTTP a tenant over its quota gets 429 with
  ``Retry-After``, an unknown one 403;
* serving: two replicas and disaggregated prefill answer
  token-identical to one port engine and to the JAX package's router
  over the same artifact (greedy), with adopted blocks and a decode
  replica's prefix hit on a prompt it never prefilled; a drain drops
  nothing; a fabric of more than one engine refuses a hot reload.

Every engine and router a test starts is stopped in ``finally``.
"""

import concurrent.futures
import json
import pickle
import struct
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu.export import ExportedModel as JModel
from veles_tpu.fleet import FleetScheduler as JFleet
from veles_tpu.serving import ReplicaRouter as JRouter
from veles_tpu.serving import ServingEngine as JEngine
from veles_tpu.serving import PrefillWorker as JPrefill
from veles_tpu.serving.fabric import pack_kv_payload as jpack
from veles_tpu.serving.fabric import parse_tenant_spec as jparse

from veles_tpu_torch import export as X
from veles_tpu_torch.fleet import FleetScheduler
from veles_tpu_torch.observability import metrics as tmetrics
from veles_tpu_torch.restful import ModelServer
from veles_tpu_torch.serving import (ModelRegistry, PrefillWorker,
                                     RateLimited, ReplicaRouter,
                                     ServiceUnavailable, ServingEngine,
                                     TenantUnknown, live_fabric_summary,
                                     parse_tenant_spec)
from veles_tpu_torch.serving.fabric import (KV_WIRE_FMT, pack_kv_payload,
                                            unpack_kv_payload)

from test_torch_network import kept_process_state

torch.set_num_threads(2)

#: Engine geometry of the serving tests: 4-token blocks, so a 14-token
#: prompt spans three full blocks and disaggregation ships them.
ENGINE = dict(max_batch=4, kv_blocks=64, kv_block_size=4)
PROMPT_LENGTHS = (3, 6, 9, 14, 21, 12)
MAX_NEW = 6


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fabric") / "lm.veles.tgz")
    return X.random_lm_artifact(path, vocab=48, embed=32, n_heads=2,
                                n_blocks=2, hidden=64, max_position=96,
                                seed=19)


@pytest.fixture(scope="module")
def prompts():
    rng = numpy.random.RandomState(23)
    out = [rng.randint(0, 48, n).astype(numpy.int32)
           for n in PROMPT_LENGTHS]
    out.append(out[3].copy())  # a repeat: the prefix cache in the loop
    return out


@pytest.fixture(autouse=True)
def _process_state():
    """Sockets and threads: none outlives a test
    (``kept_process_state``); the fabric and tenant series, which live
    in the process registry, are dropped after it."""
    with kept_process_state():
        yield
    for prefix in ("fabric.", "tenant.", "membership.", "fleet."):
        tmetrics.registry.remove_prefix(prefix)


# -- KV planes ---------------------------------------------------------------


def _codes(t):
    """A stored plane as comparable numpy bits."""
    if isinstance(t, torch.Tensor):
        if t.dtype in (torch.int8, torch.float8_e4m3fn):
            return t.view(torch.uint8).numpy()
        return t.float().numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    arr = numpy.asarray(t)
    if arr.dtype.itemsize == 1:
        return arr.view(numpy.uint8)
    return arr.astype(numpy.float32)


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8", "fp8"])
def test_kv_planes_match_jax(artifact, kv_dtype):
    """Seeded f32 blocks imported at the same ids into a port pool and
    a JAX pool of the same artifact: every layer's stored k/v (and, on
    int8/fp8, the re-quantized codes with their fresh per-(block, head)
    scales) bit-equal; the exports of those ids equal too, and on f32
    equal to what was imported (exact)."""
    tmodel = X.ExportedModel(artifact, device="cpu")
    jmodel = JModel(artifact)
    tpool = tmodel.make_kv_pool(12, 4, kv_dtype=kv_dtype)
    jpool = jmodel.make_kv_pool(12, 4, kv_dtype=kv_dtype)
    L, H, D = tmodel._paged_geometry()
    ids = [3, 1, 7]
    rng = numpy.random.RandomState(5)
    blocks = (rng.standard_normal((L, 2, len(ids), 4, H, D)) *
              rng.uniform(0.1, 4.0, (1, 1, len(ids), 1, H, 1))
              ).astype(numpy.float32)
    tmodel.import_kv_blocks(tpool, ids, blocks)
    jmodel.import_kv_blocks(jpool, ids, blocks)
    for got, want in zip(tpool.storage, jpool.storage):
        for t, j in zip(got, want):
            assert numpy.array_equal(_codes(t), _codes(j)), kv_dtype
    texp = tmodel.export_kv_blocks(tpool, ids)
    jexp = numpy.asarray(jmodel.export_kv_blocks(jpool, ids))
    assert texp.dtype == numpy.float32
    assert texp.shape == (L, 2, len(ids), 4, H, D)
    assert numpy.array_equal(texp, jexp)
    if kv_dtype == "f32":
        assert numpy.array_equal(texp, blocks)
    with pytest.raises(Exception, match="does not match"):
        tmodel.import_kv_blocks(tpool, ids[:2], blocks)


def test_pool_export_adopt_refcount_correct():
    """The port's pool export pins the blocks for the caller; adoption
    leaves each block held by its prefix entries only, is idempotent,
    and a drop returns every block."""
    src = X.KVBlockPool(10, 4)
    tokens = numpy.arange(12, dtype=numpy.int32)
    ids = src.alloc(3)
    src.register_prefix(tokens, ids)
    src.release(ids)
    n, got = src.export_prefix_blocks(tokens)
    assert n == 3 and got == ids
    assert src.refs_of(got[0]) == 4
    src.release(got)
    dst = X.KVBlockPool(10, 4)
    writes = []
    out = dst.adopt_prefix_blocks(tokens, 3, write_fn=writes.append)
    assert writes == [out]
    assert [dst.refs_of(b) for b in out] == [3, 2, 1]
    assert dst.adopt_prefix_blocks(tokens, 3) == out
    assert len(writes) == 1
    assert dst.drop_prefixes() == 3
    assert dst.free_count() == dst.usable


# -- the wire ----------------------------------------------------------------


def _frame(payload):
    """(header object, tensor blobs) of a tensor-framed buffer."""
    (hlen,) = struct.unpack(">I", payload[:4])
    skeleton, specs = pickle.loads(payload[4:4 + hlen])
    off, blobs = 4 + hlen, []
    for _, _, nbytes, _ in specs:
        blobs.append(payload[off:off + nbytes])
        off += nbytes
    assert off == len(payload)
    def plain(v):
        if type(v).__name__ == "_TensorRef":
            return ("tensor", v.i)
        if isinstance(v, numpy.ndarray):
            return ("array", v.dtype.str, v.shape, v.tobytes())
        return v
    return {k: plain(v) for k, v in skeleton.items()}, specs, blobs


def test_kv_wire_frames_match_jax():
    """The same payload packed by both packages: the same schema, the
    same tensor table and the same tensor bytes; a round trip gives
    the arrays back; malformed buffers read as None."""
    rng = numpy.random.RandomState(9)
    blocks = rng.standard_normal((2, 2, 3, 4, 2, 8)).astype(numpy.float32)
    tokens = numpy.arange(13, dtype=numpy.int64)
    got = pack_kv_payload(tokens, 3, blocks, 4, 7)
    want = jpack(tokens, 3, blocks, 4, 7)
    assert _frame(got) == _frame(want)
    obj = unpack_kv_payload(got)
    assert obj["fmt"] == KV_WIRE_FMT and obj["weight_version"] == 7
    assert numpy.array_equal(obj["tokens"], tokens[:12])
    assert numpy.array_equal(obj["blocks"], blocks)
    for bad in (b"", b"garbage bytes", got[:40],
                pack_kv_payload(tokens, 2, blocks, 4, 7)):
        assert unpack_kv_payload(bad) is None


# -- routing -----------------------------------------------------------------


class _StubEngine(object):
    """An engine as the router's placement sees it."""

    kv_pool = None

    def queue_depth_now(self):
        return 0

    def stop(self, drain=True, timeout=None):
        pass


def _routers(names):
    trouter, jrouter = ReplicaRouter(fleet=FleetScheduler()), \
        JRouter(fleet=JFleet())
    for name in names:
        trouter.add_replica(name, _StubEngine())
        jrouter.add_replica(name, _StubEngine())
    return trouter, jrouter


def test_route_key_and_pick_replica_match_jax():
    """200 seeded prompts of 1..60 tokens under replicas r0..r2: the
    same routing digest and the same replica in both packages; the
    digest is the first entry of a 16-token-block pool's prefix chain
    for a prompt of a full block or more."""
    trouter, jrouter = _routers(["r0", "r1", "r2"])
    rng = numpy.random.RandomState(31)
    pool = X.KVBlockPool(4, 16)
    seen = set()
    for i in range(200):
        prompt = rng.randint(0, 50000, rng.randint(1, 61)).astype(
            numpy.int32)
        key = ReplicaRouter.route_key(prompt)
        assert key == JRouter.route_key(prompt)
        if len(prompt) >= 16:
            assert key == pool.prefix_chain(prompt)[0]
        name = trouter.pick_replica(prompt).name
        assert name == jrouter.pick_replica(prompt).name
        seen.add(name)
    assert seen == {"r0", "r1", "r2"}


def test_drain_remaps_only_the_drained_replicas_keys():
    """Draining r1 moves only r1's keys (to the survivors, as JAX's
    router moves them); every other key keeps its replica."""
    trouter, jrouter = _routers(["r0", "r1", "r2"])
    rng = numpy.random.RandomState(37)
    prompts = [rng.randint(0, 1000, 20).astype(numpy.int32)
               for _ in range(120)]
    before = [trouter.pick_replica(p).name for p in prompts]
    trouter.drain_replica("r1")
    jrouter.drain_replica("r1")
    after = [trouter.pick_replica(p).name for p in prompts]
    assert after == [jrouter.pick_replica(p).name for p in prompts]
    moved = [(b, a) for b, a in zip(before, after) if b != a]
    assert moved and all(b == "r1" for b, _ in moved)
    assert "r1" not in after
    assert trouter.fleet.epoch == 4  # three joins and a drain
    assert trouter.replica_names() == ["r0", "r2"]


def test_router_without_replicas_is_unavailable():
    router = ReplicaRouter(fleet=FleetScheduler())
    with pytest.raises(ServiceUnavailable):
        router.submit_generate(numpy.arange(4), 2)
    with pytest.raises(ServiceUnavailable):
        router.submit_classify(numpy.zeros((1, 4)))


# -- tenants -----------------------------------------------------------------


ACCEPTED_SPECS = ["a=5", "a=5:10", "a=5:10@m.tgz", "a=0.5@m.tgz",
                  " b =2", "c=1:1@", "d=1e-3:2", "e=7@x=y.tgz"]
REJECTED_SPECS = ["no-rate", "=5", "a=", "a=x", "a=1:y", " =1"]


@pytest.mark.parametrize("spec", ACCEPTED_SPECS + REJECTED_SPECS)
def test_parse_tenant_spec_matches_jax(spec):
    try:
        want = jparse(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_tenant_spec(spec)
        assert spec in REJECTED_SPECS
        return
    assert spec in ACCEPTED_SPECS
    assert parse_tenant_spec(spec) == want


def test_tenant_quota_isolation_and_403():
    clock = [0.0]
    registry = ModelRegistry(clock=lambda: clock[0])
    registry.register("flooder", rate=1.0, burst=2.0)
    registry.register("sibling", rate=1.0, burst=2.0,
                      artifact="sib.veles.tgz")
    with pytest.raises(TenantUnknown) as e:
        registry.admit("mallory")
    assert e.value.status == 403
    registry.admit("flooder")
    registry.admit("flooder")
    with pytest.raises(RateLimited) as e:
        registry.admit("flooder")
    assert e.value.status == 429 and e.value.retry_after > 0
    registry.admit("sibling")
    assert registry.artifact_for("sibling") == "sib.veles.tgz"
    snap = registry.snapshot()
    assert snap["tenants"]["flooder"] == {
        "rate": 1.0, "admitted": 2, "rejected": 1, "artifact": None}
    clock[0] = 10.0
    registry.admit("flooder")


# -- serving -----------------------------------------------------------------


def _port_fabric(model, prefill=True, **kw):
    kw = dict(ENGINE, **kw)
    pre = PrefillWorker(ServingEngine(model, **kw).start()) \
        if prefill else None
    router = ReplicaRouter(fleet=FleetScheduler(), prefill=pre)
    for i in range(2):
        router.add_replica("r%d" % i, ServingEngine(model, **kw).start())
    return router


def test_fabric_and_disagg_token_identical_to_one_engine_and_jax(
        artifact, prompts):
    """Two replicas with disaggregated prefill answer every prompt (a
    repeat included) token-identical to one port engine and to the JAX
    package's router (two replicas, its prefill worker) over the same
    artifact, greedy; blocks were adopted, and a decode replica hit
    its prefix cache on a prompt it never prefilled."""
    model = X.ExportedModel(artifact, device="cpu")
    single = ServingEngine(model, **ENGINE).start()
    router = _port_fabric(model)
    jmodel = JModel(artifact)
    jrouter = JRouter(fleet=JFleet(),
                      prefill=JPrefill(JEngine(jmodel, **ENGINE).start()))
    for i in range(2):
        jrouter.add_replica("r%d" % i, JEngine(jmodel, **ENGINE).start())
    try:
        for prompt in prompts:
            got = router.submit_generate(prompt, MAX_NEW)
            assert numpy.array_equal(
                got, single.submit_generate(prompt, MAX_NEW))
            assert numpy.array_equal(
                got, numpy.asarray(jrouter.submit_generate(prompt,
                                                           MAX_NEW)))
        snap = router.occupancy()
        assert snap["routed"] == len(prompts)
        assert snap["adopted_blocks"] >= 1
        decode_hits = sum(e["prefix_hits"]
                          for e in snap["per_replica"].values())
        assert decode_hits >= 1
        pre = router.prefill.engine.stats
        assert pre.get("kv.prefill_exported") >= 1
        adopts = sum(h.engine.stats.get("kv.adopt")
                     for h in router._replicas.values())
        assert adopts >= 1
        summary = live_fabric_summary()
        assert summary["replicas"] >= 2 and summary["routed"] >= 1
        gauges = tmetrics.render_prometheus([tmetrics.registry])
        assert "veles_fabric_replicas 2" in gauges
    finally:
        router.stop(drain=False)
        jrouter.stop(drain=False)
        single.stop()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_disagg_adopts_onto_scaled_planes(artifact, prompts, kv_dtype):
    """On the bf16 and int8 planes the decode replicas adopt the f32
    wire's blocks (cast, or re-quantized with fresh scales) and answer
    with in-vocabulary tokens of the asked length; bf16 answers equal
    one bf16 engine's (a cast of the same f32 values is the same
    bits)."""
    model = X.ExportedModel(artifact, device="cpu")
    router = _port_fabric(model, kv_dtype=kv_dtype)
    single = ServingEngine(model, kv_dtype=kv_dtype, **ENGINE).start()
    try:
        for prompt in prompts:
            got = router.submit_generate(prompt, MAX_NEW)
            assert got.shape == (1, len(prompt) + MAX_NEW)
            assert numpy.array_equal(got[0, :len(prompt)], prompt)
            assert ((got >= 0) & (got < 48)).all()
            if kv_dtype == "bf16":
                assert numpy.array_equal(
                    got, single.submit_generate(prompt, MAX_NEW))
        assert router.occupancy()["adopted_blocks"] >= 1
    finally:
        router.stop(drain=False)
        single.stop()


def test_engine_adoption_refuses_stale_weights_and_partial_chains(
        artifact):
    """A payload computed under another weight version is refused
    (``kv.adopt_stale``); an export of a prompt the pool holds no
    complete chain of gives None; after one prefill it exports the
    whole chain."""
    model = X.ExportedModel(artifact, device="cpu")
    engine = ServingEngine(model, **ENGINE).start()
    try:
        prompt = numpy.arange(1, 15, dtype=numpy.int32)
        assert engine.export_kv_prefix(prompt) is None
        engine.submit_generate(prompt[None], 1)
        n, blocks, bs, version = engine.export_kv_prefix(prompt)
        assert (n, bs, version) == (3, 4, engine.weight_version)
        payload = unpack_kv_payload(pack_kv_payload(
            prompt, n, blocks, bs, version + 1))
        assert engine.adopt_kv_prefix(prompt, payload) == 0
        assert engine.stats.get("kv.adopt_stale") == 1
    finally:
        engine.stop()


def test_drain_drops_nothing(artifact, prompts):
    """Concurrent requests, then the fabric stopped with drain as soon
    as the first has become a decode row: every request ends either in
    its full answer, equal to one engine's, or in a 503
    (``ServiceUnavailable``: it was still queued, or reached a replica
    that had stopped) — never another error — and the replicas leave
    the fleet as drains."""
    import time
    model = X.ExportedModel(artifact, device="cpu")
    router = _port_fabric(model, prefill=False)
    single = ServingEngine(model, **ENGINE).start()
    engines = [h.engine for h in router._replicas.values()]
    try:
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
            futs = [ex.submit(router.submit_generate, p, MAX_NEW)
                    for p in prompts]
            deadline = time.monotonic() + 60
            while not any(e._rows for e in engines) and \
                    time.monotonic() < deadline:
                time.sleep(0.001)
            router.stop(drain=True, timeout=60)
            done = 0
            for p, fut in zip(prompts, futs):
                try:
                    out = fut.result(timeout=60)
                except ServiceUnavailable:
                    continue
                assert numpy.array_equal(out, single.submit_generate(
                    p, MAX_NEW))
                done += 1
        assert done >= 1
        assert router.replica_names() == []
        assert router.fleet.snapshot()["drains"] == 2
    finally:
        router.stop(drain=False)
        single.stop()


def _post(port, path, payload, headers=None):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), e.headers


def _get(port, path):
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=60) as resp:
        body = resp.read()
    return body if path == "/metrics" else json.loads(body)


def test_tenants_over_http(artifact, prompts):
    """A 2-replica fabric with disaggregated prefill behind the HTTP
    server: tenant ``a`` gets exactly its burst of 200s, then 429 with
    ``Retry-After``, while ``b`` keeps getting 200 — its answers equal
    the single engine's; an unknown or anonymous tenant gets 403;
    ``/stats`` carries the fabric section and ``/metrics`` the
    ``fabric.*`` and ``tenant.*`` series."""
    model = X.ExportedModel(artifact, device="cpu")
    single = ServingEngine(model, **ENGINE).start()
    server = ModelServer(model, host="127.0.0.1", port=0, device="cpu",
                         fabric_replicas=2, fabric_disagg=True,
                         tenant=["a=0.001:2", "b=100"], **ENGINE)
    server.start()
    try:
        body = {"tokens": [prompts[3].tolist()], "max_new_tokens": 3}
        codes = []
        for _ in range(4):
            status, _, headers = _post(server.port, "/api/generate",
                                       body, {"X-Tenant": "a"})
            codes.append(status)
            if status == 429:
                assert int(headers["Retry-After"]) >= 1
        assert codes == [200, 200, 429, 429]
        for p in prompts:
            status, reply, _ = _post(
                server.port, "/api/generate",
                {"tokens": [p.tolist()], "max_new_tokens": MAX_NEW},
                {"X-Tenant": "b"})
            assert status == 200
            assert reply["tokens"] == single.submit_generate(
                p, MAX_NEW).tolist()
        assert _post(server.port, "/api/generate", body,
                     {"X-Tenant": "mallory"})[0] == 403
        assert _post(server.port, "/api/generate", body)[0] == 403
        assert _post(server.port, "/api/generate",
                     dict(body, tenant="b"))[0] == 200
        stats = _get(server.port, "/stats")
        fabric = stats["fabric"]
        assert fabric["replicas"] == 2 and fabric["adopted_blocks"] >= 1
        tenants = fabric["registry"]["tenants"]
        assert tenants["a"]["rejected"] == 2
        assert tenants["b"]["rejected"] == 0
        text = _get(server.port, "/metrics").decode()
        assert "veles_fabric_replicas" in text
        assert 'veles_tenant_rejected_total{tenant="a"} 2' in text
    finally:
        server.stop(drain=True)
        single.stop()


def test_fabric_refuses_a_reload_that_reaches_one_engine(
        artifact, prompts, tmp_path):
    """A hot reload swaps replica r0's weights alone, so a fabric of two
    replicas with disaggregated prefill refuses it, naming A8b:
    ``reload_watch`` at construction, ``reload_artifact`` and
    ``reload_draft_artifact``, and ``/admin/reload`` with 501.  After
    the refused reloads every answer still equals a fresh single
    engine's and every engine stays at weight version 1.  A tenants-only
    fabric (one engine, no prefill worker) still reloads, and then
    answers as a fresh engine over the new artifact."""
    from veles_tpu_torch.error import Bug
    other = X.random_lm_artifact(
        str(tmp_path / "other.veles.tgz"), vocab=48, embed=32, n_heads=2,
        n_blocks=2, hidden=64, max_position=96, seed=20)
    model = X.ExportedModel(artifact, device="cpu")
    with pytest.raises(Bug, match="A8b"):
        ModelServer(model, host="127.0.0.1", port=0, device="cpu",
                    fabric_replicas=2, fabric_disagg=True,
                    reload_watch=other, **ENGINE)
    single = ServingEngine(model, **ENGINE).start()
    server = ModelServer(model, host="127.0.0.1", port=0, device="cpu",
                         token="s3cret", fabric_replicas=2,
                         fabric_disagg=True, **ENGINE)
    server.start()
    try:
        for reload in (server.reload_artifact,
                       server.reload_draft_artifact):
            with pytest.raises(Bug, match="A8b"):
                reload(other)
        status, reply, _ = _post(server.port, "/admin/reload",
                                 {"artifact": other},
                                 {"X-Status-Token": "s3cret"})
        assert status == 501 and "A8b" in reply["error"]
        for p in prompts:
            assert numpy.array_equal(
                server.fabric.submit_generate(p, MAX_NEW),
                single.submit_generate(p, MAX_NEW))
        engines = server._fabric_engines + [server.fabric.prefill.engine]
        assert [e.weight_version for e in engines] == [1, 1, 1]
    finally:
        server.stop(drain=False)
        single.stop()
    fresh = ServingEngine(X.ExportedModel(other, device="cpu"),
                          **ENGINE).start()
    server = ModelServer(X.ExportedModel(artifact, device="cpu"),
                         host="127.0.0.1", port=0, device="cpu",
                         tenant="b=100", **ENGINE)
    server.start()
    try:
        assert server.reload_artifact(other) == 2
        for p in prompts:
            assert numpy.array_equal(
                server.fabric.submit_generate(p, MAX_NEW, tenant="b"),
                fresh.submit_generate(p, MAX_NEW))
    finally:
        server.stop(drain=False)
        fresh.stop()


def test_serve_cli_builds_the_fabric(artifact, monkeypatch):
    """``serve --fabric-replicas 2 --fabric-disagg --tenant ...`` builds
    the fabric the flags name."""
    import signal
    from veles_tpu_torch import serve
    built = []
    sigterm = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(ModelServer, "serve",
                        lambda self: built.append(self))
    assert serve.main([artifact, "--device", "cpu", "--port", "0",
                       "--kv-block-size", "4", "--fabric-replicas", "2",
                       "--fabric-disagg", "--tenant", "a=1:2",
                       "--tenant", "b=5"]) == 0
    server, = built
    try:
        assert server.fabric.replica_names() == ["r0", "r1"]
        assert server.fabric.prefill is not None
        assert server.fabric.registry.tenants() == ["a", "b"]
    finally:
        # Never served: close the listener and the (unstarted) fabric.
        server._httpd.server_close()
        server.fabric.stop(drain=False)
        signal.signal(signal.SIGTERM, sigterm)
