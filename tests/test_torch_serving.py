"""The port's serving engine and HTTP server (``veles_tpu_torch.serving``,
``veles_tpu_torch.restful``) against the JAX package's ``generate``.

One artifact (2 blocks, E=64, H=2, vocab 64, positional table 128,
numpy seed 77) is loaded by both packages; the port serves it on the
CPU through the paged continuous-batching engine (block size 8) and
over loopback HTTP.  Greedy answers must be token-identical to the JAX
package's ``ExportedModel.generate``.
"""

import concurrent.futures
import json
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu.export import ExportedModel as JaxModel
from veles_tpu_torch import export as X
from veles_tpu_torch.restful import ModelServer
from veles_tpu_torch.serving import ServingEngine

# Tier-1 runs test files in parallel workers: keep torch's CPU ops to
# two threads so these files do not starve the timing-sensitive ones.
torch.set_num_threads(2)

PROMPT_LENGTHS = (3, 9, 16, 21, 40)
MAX_NEW = 6


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torchserve") / "lm.veles.tgz")
    return X.random_lm_artifact(path, vocab=64, embed=64, n_heads=2,
                                n_blocks=2, hidden=128, max_position=128,
                                seed=77)


@pytest.fixture(scope="module")
def prompts():
    rng = numpy.random.RandomState(11)
    return [rng.randint(0, 64, n).tolist() for n in PROMPT_LENGTHS]


@pytest.fixture(scope="module")
def jax_answers(artifact, prompts):
    model = JaxModel(artifact)
    return [model.generate(numpy.asarray([p]), MAX_NEW)[0].tolist()
            for p in prompts]


@pytest.fixture
def server(artifact):
    srv = ModelServer(artifact, host="127.0.0.1", port=0, max_batch=4,
                      kv_blocks=64, kv_block_size=8, device="cpu",
                      token="s3cret")
    srv.start()
    yield srv
    srv.stop(drain=True)


def _call(port, path, payload=None, token="s3cret"):
    url = "http://127.0.0.1:%d%s" % (port, path)
    if payload is None:
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     "X-Status-Token": token})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
            status = resp.status
    except urllib.error.HTTPError as e:
        body, status = e.read(), e.code
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body.decode()


def test_http_generate_matches_jax(server, prompts, jax_answers):
    """Concurrent /api/generate requests of mixed lengths ride the
    paged engine and answer token-identically to the JAX package's
    generate; a repeated prompt hits the prefix cache (with a
    copy-on-write of its last block: 16 tokens = 2 full blocks) and
    answers the same."""
    port = server.port
    status, health = _call(port, "/health")
    assert status == 200 and health["status"] == "ok"
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
        futs = [ex.submit(_call, port, "/api/generate",
                          {"tokens": [p], "max_new_tokens": MAX_NEW})
                for p in prompts]
        results = [f.result() for f in futs]
    for (status, body), want in zip(results, jax_answers):
        assert status == 200, body
        assert body["tokens"][0] == want
    before = _call(port, "/stats")[1]["kv_pool"]
    status, body = _call(port, "/api/generate",
                         {"tokens": [prompts[2]],
                          "max_new_tokens": MAX_NEW})
    assert status == 200 and body["tokens"][0] == jax_answers[2]
    status, stats = _call(port, "/stats")
    assert status == 200
    pool = stats["kv_pool"]
    assert pool["prefix_hits"] > before["prefix_hits"]
    assert pool["cow_copies"] > before["cow_copies"]
    assert pool["storage_dtype"] == "f32"
    assert stats["counters"]["batches.decode"] >= MAX_NEW - 1
    assert stats["compile_cache"]["misses"] >= 1


def test_http_surface(server):
    """Token gate, malformed requests, Prometheus text and unknown
    paths answer as the JAX package's server does."""
    port = server.port
    status, _ = _call(port, "/api/generate",
                      {"tokens": [[1, 2]], "max_new_tokens": 2},
                      token="wrong")
    assert status == 403
    status, body = _call(port, "/api/generate",
                         {"tokens": [[1, 2]], "max_new_tokens": 0})
    assert status == 400 and "max_new_tokens" in body["error"]
    status, body = _call(port, "/api/generate",
                         {"tokens": [list(range(125))],
                          "max_new_tokens": 8})
    assert status == 400 and "positional table" in body["error"]
    # /api takes samples of the manifest's input shape: here the
    # whole positional table of tokens, answered with their logits.
    status, body = _call(port, "/api", {"input": [[1, 2, 3] * 40 +
                                                  [4] * 8]})
    assert status == 200 and numpy.asarray(body["output"]).shape == (
        1, 128 * 64)
    status, text = _call(port, "/metrics")
    assert status == 200 and "# TYPE" in text
    assert _call(port, "/nope")[0] == 404


def test_whole_request_path_matches_jax(artifact, prompts, jax_answers):
    """paged=False serves through generate_bucketed (the whole-request
    path): the same tokens."""
    engine = ServingEngine(X.ExportedModel(artifact, device="cpu"),
                           max_batch=4, paged=False).start()
    try:
        for p, want in zip(prompts[:3], jax_answers[:3]):
            got = engine.submit_generate(numpy.asarray([p]), MAX_NEW)
            assert got[0].tolist() == want
    finally:
        engine.stop(drain=True)
    assert engine.kv_pool is None


def test_sampled_paged_matches_sampled_generate(artifact, prompts):
    """Inside the port, a sampled request served through the paged
    engine draws the same tokens as generate() with the same seed: one
    (seed, gen_idx) stream per row in both."""
    model = X.ExportedModel(artifact, device="cpu")
    engine = ServingEngine(model, max_batch=4, kv_blocks=64,
                           kv_block_size=8).start()
    try:
        got = engine.submit_generate(numpy.asarray([prompts[3]]), 8,
                                     temperature=1.5, seed=123)
    finally:
        engine.stop(drain=True)
    want = model.generate(numpy.asarray([prompts[3]]), 8,
                          temperature=1.5, seed=123)
    numpy.testing.assert_array_equal(got, want)
    assert not numpy.array_equal(
        want, model.generate(numpy.asarray([prompts[3]]), 8))


def test_device_fault_recovery_is_token_identical(artifact, prompts,
                                                 jax_answers):
    """A device fault injected at the third paged device call: the
    engine rebuilds the KV pool, replays the live row's prompt and
    emitted tokens, and the answer stays token-identical."""
    from veles_tpu_torch.resilience import FaultInjector
    injector = FaultInjector(
        "serve.device_fault@serve.device_fault:3")
    engine = ServingEngine(X.ExportedModel(artifact, device="cpu"),
                           max_batch=4, kv_blocks=64, kv_block_size=8,
                           injector=injector).start()
    try:
        got = engine.submit_generate(numpy.asarray([prompts[4]]),
                                     MAX_NEW)
    finally:
        engine.stop(drain=True)
    assert got[0].tolist() == jax_answers[4]
    assert injector.fired == [("serve.device_fault",
                               "serve.device_fault", 3)]
    assert engine.stats.get("kv.pool.resets") == 1
    assert engine.stats.get("readopt.rows") == 1


def test_not_ported_options_refuse(artifact, capsys):
    """What the port once refused now works: KV export/adopt between
    engines (an unprefilled prompt exports nothing, a payload of another
    weight version is refused as stale) and the serving fabric's flags
    (replicas, disaggregated prefill, tenants), which build the server's
    fabric."""
    import signal
    from veles_tpu_torch import serve
    from veles_tpu_torch.serving.fabric import (pack_kv_payload,
                                                unpack_kv_payload)
    model = X.ExportedModel(artifact, device="cpu")
    engine = ServingEngine(model, kv_block_size=8)
    assert engine.export_kv_prefix(list(range(1, 20))) is None
    tokens = numpy.arange(1, 17, dtype=numpy.int32)
    L, H, D = model._paged_geometry()
    payload = unpack_kv_payload(pack_kv_payload(
        tokens, 2, numpy.zeros((L, 2, 2, 8, H, D), numpy.float32), 8,
        engine.weight_version + 1))
    assert engine.adopt_kv_prefix(tokens, payload) == 0
    assert engine.stats.get("kv.adopt_stale") == 1
    built = []
    sigterm = signal.getsignal(signal.SIGTERM)
    serve_ = ModelServer.serve
    ModelServer.serve = lambda self: built.append(
        (self, len(self.fabric), self.fabric.prefill is not None,
         self.fabric.registry and self.fabric.registry.tenants()))
    try:
        for flags in (["--fabric-replicas", "2"], ["--fabric-disagg"],
                      ["--tenant", "a=1"]):
            assert serve.main([artifact, "--device", "cpu", "--port",
                               "0"] + flags) == 0
    finally:
        ModelServer.serve = serve_
        signal.signal(signal.SIGTERM, sigterm)
        for server, _, _, _ in built:
            server._httpd.server_close()
            server.fabric.stop(drain=False)
    assert [b[1:] for b in built] == [(2, False, None), (1, True, None),
                                      (1, False, ["a"])]
    assert "not yet ported" not in capsys.readouterr().err
