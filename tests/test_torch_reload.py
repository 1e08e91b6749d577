"""Hot weight reload in the port (``veles_tpu_torch.serving.reload``,
``ExportedModel.swap_weights``, ``ServingEngine.reload``,
``POST /admin/reload``) on the CPU.

Two artifacts of one geometry (2 blocks, E=16, 2 heads, vocab 32,
positions 64, seeds 1 and 2) and one of another (E=24): a reload must
answer exactly as a model freshly loaded from the new artifact (greedy
tokens equal), bump the weight version, re-quantize under the int8
weight mode, refuse a corrupt artifact while the old weights keep
serving, and keep ``/admin/reload`` behind the token.  The artifact
verification helpers must agree with the JAX package's on the same
files.
"""

import json
import os
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu.serving import reload as JR
from veles_tpu_torch import export as X
from veles_tpu_torch.config import root
from veles_tpu_torch.error import Bug
from veles_tpu_torch.resilience import FaultInjector
from veles_tpu_torch.restful import ModelServer
from veles_tpu_torch.serving import ServingEngine
from veles_tpu_torch.serving import reload as R

# Tier-1 runs test files in parallel workers: keep torch's CPU ops to
# two threads so these files do not starve the timing-sensitive ones.
torch.set_num_threads(2)

PROMPT = numpy.array([[3, 9, 1, 4, 1, 5, 9]], numpy.int32)
MAX_NEW = 6


def _lm(path, seed, embed=16):
    return X.random_lm_artifact(path, vocab=32, embed=embed, n_heads=2,
                                n_blocks=2, hidden=32, max_position=64,
                                seed=seed)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("treload")
    return {"v1": _lm(str(d / "v1.veles.tgz"), 1),
            "v2": _lm(str(d / "v2.veles.tgz"), 2),
            "wide": _lm(str(d / "wide.veles.tgz"), 3, embed=24)}


@pytest.fixture(autouse=True)
def _f32_weight_mode():
    root.common.serving.weight_dtype = "f32"
    yield
    root.common.serving.weight_dtype = "f32"


def _fresh(path):
    return X.ExportedModel(path, device="cpu").generate(PROMPT, MAX_NEW)


def _engine(path, **kw):
    return ServingEngine(X.ExportedModel(path, device="cpu"), max_batch=2,
                         kv_blocks=32, kv_block_size=4, **kw).start()


def test_swap_weights_geometry_gate(artifacts):
    model = X.ExportedModel(artifacts["v1"], device="cpu")
    v2 = X.ExportedModel(artifacts["v2"], device="cpu")
    wide = X.ExportedModel(artifacts["wide"], device="cpu")
    assert model.same_geometry(v2) and not model.same_geometry(wide)
    with pytest.raises(Bug, match="geometry mismatch"):
        model.swap_weights(wide.weights)
    assert model.weight_version == 1
    assert model.swap_weights(v2.weights) == 2
    numpy.testing.assert_array_equal(model.generate(PROMPT, MAX_NEW),
                                     _fresh(artifacts["v2"]))


def test_reload_in_place(artifacts):
    """A same-geometry reload swaps the weights in place at a step
    boundary: the pool survives, the prefix cache is flushed, the
    version bumps, and answers equal a fresh model's on the new
    artifact."""
    engine = _engine(artifacts["v1"])
    try:
        before = engine.submit_generate(PROMPT, MAX_NEW)
        numpy.testing.assert_array_equal(before, _fresh(artifacts["v1"]))
        pool = engine.kv_pool
        assert engine.reload(artifacts["v2"]) == 2
        assert engine.kv_pool is pool
        assert pool.occupancy()["prefix_entries"] == 0
        after = engine.submit_generate(PROMPT, MAX_NEW)
        numpy.testing.assert_array_equal(after, _fresh(artifacts["v2"]))
        assert not numpy.array_equal(after, before)
        assert engine.stats.get("reload.inplace") == 1
        assert engine.stats.gauge("weight_version") == 2
    finally:
        engine.stop()


def test_reload_drain_and_swap(artifacts):
    """A reload to another geometry drains and swaps the whole model and
    its pool; answers equal a fresh model's on the new artifact."""
    engine = _engine(artifacts["v1"], kv_dtype="int8")
    try:
        engine.submit_generate(PROMPT, MAX_NEW)
        old_pool = engine.kv_pool
        assert engine.reload(artifacts["wide"]) == 2
        assert engine.kv_pool is not old_pool
        assert engine.kv_pool.kv_dtype == "int8"
        assert engine.model.geometry_of()[1]["emb__weights"] == (32, 24)
        got = engine.submit_generate(PROMPT, MAX_NEW)
        ref = _engine(artifacts["wide"], kv_dtype="int8")
        try:
            numpy.testing.assert_array_equal(
                got, ref.submit_generate(PROMPT, MAX_NEW))
        finally:
            ref.stop()
        assert engine.stats.get("reload.swap") == 1
    finally:
        engine.stop()


def test_reload_requantizes_int8_weights(artifacts):
    """Under the int8 weight mode a swap drops the quantized decode
    parameters and the next decode call re-quantizes the new weights:
    the codes change and equal a fresh quantization of the new f32
    weights; answers equal a fresh int8-mode model's."""
    root.common.serving.weight_dtype = "int8"
    engine = _engine(artifacts["v1"])
    try:
        engine.submit_generate(PROMPT, MAX_NEW)
        before = engine.model._lm_params()["blocks"][0]["w1"].clone()
        engine.reload(artifacts["v2"])
        got = engine.submit_generate(PROMPT, MAX_NEW)
        params = engine.model._lm_params()
        after = params["blocks"][0]["w1"]
        assert after.dtype == torch.int8
        assert not torch.equal(after, before)
        fresh = X.ExportedModel(artifacts["v2"], device="cpu")
        numpy.testing.assert_array_equal(
            after.numpy(), fresh._lm_params()["blocks"][0]["w1"].numpy())
        numpy.testing.assert_array_equal(
            got, fresh.generate(PROMPT, MAX_NEW))
    finally:
        engine.stop()


def test_corrupt_artifact_rejected(artifacts, tmp_path):
    """A manifest mismatch, a missing manifest where one is required, an
    unreadable file and the serve.reload_corrupt chaos fault all give
    ArtifactRejected; the old weights keep serving."""
    path = str(tmp_path / "v2.veles.tgz")
    with open(artifacts["v2"], "rb") as fin, open(path, "wb") as fout:
        fout.write(fin.read())
    with pytest.raises(R.ArtifactRejected, match="no sidecar manifest"):
        R.read_verified(path, require_manifest=True)
    manifest = R.write_manifest(path)
    assert R.read_manifest(path) == manifest
    assert R.read_verified(path, require_manifest=True).read(2) == \
        b"\x1f\x8b"
    with pytest.raises(R.ArtifactRejected, match="does not match"):
        R.read_verified(path, injector=FaultInjector(
            "serve.reload_corrupt@1"))
    with pytest.raises(R.ArtifactRejected, match="cannot read"):
        R.read_verified(str(tmp_path / "missing.veles.tgz"))
    with open(path, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    server = ModelServer(artifacts["v1"], port=0, token="t", max_batch=2,
                         kv_blocks=32, kv_block_size=4, device="cpu")
    engine = server.engine.start()
    try:
        with pytest.raises(R.ArtifactRejected, match="does not match"):
            server.reload_artifact(path)
        assert engine.weight_version == 1
        numpy.testing.assert_array_equal(
            engine.submit_generate(PROMPT, MAX_NEW),
            _fresh(artifacts["v1"]))
    finally:
        engine.stop()


def test_verification_helpers_match_jax(artifacts, tmp_path):
    """read_verified, resolve_artifact and the manifest format agree
    with the JAX package's on the same files: artifact paths, a
    ``_current.lnk`` pointer to a snapshot with an artifact sibling, a
    pointer to a missing file."""
    blob = str(tmp_path / "snap_1.pickle")
    with open(blob, "wb") as fout:
        fout.write(b"snapshot")
    art = blob + ".veles.tgz"
    with open(artifacts["v2"], "rb") as fin, open(art, "wb") as fout:
        fout.write(fin.read())
    R.write_manifest(art)
    lnk = str(tmp_path / "snap_current.lnk")
    with open(lnk, "w") as fout:
        fout.write(blob)
    dangling = str(tmp_path / "gone_current.lnk")
    with open(dangling, "w") as fout:
        fout.write(str(tmp_path / "gone.pickle"))
    for target in (art, lnk, blob, dangling, str(tmp_path / "none")):
        assert R.resolve_artifact(target) == JR.resolve_artifact(target)
    assert R.resolve_artifact(lnk) == art
    assert R.read_verified(art, require_manifest=True).read() == \
        JR.read_verified(art, require_manifest=True).read()
    assert R.read_manifest(art) == json.load(open(art + ".manifest.json"))


def _post(port, payload, token=None):
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["X-Status-Token"] = token
    req = urllib.request.Request(
        "http://127.0.0.1:%d/admin/reload" % port,
        data=json.dumps(payload).encode(), headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_admin_reload_authentication(artifacts, tmp_path):
    """POST /admin/reload: 403 on a server without a token, 403 with a
    wrong token, 409 for a rejected artifact, 200 and the new version
    with the token."""
    open_srv = ModelServer(artifacts["v1"], host="127.0.0.1", port=0,
                           max_batch=2, kv_blocks=32, kv_block_size=4,
                           device="cpu")
    open_srv.start()
    try:
        status, body = _post(open_srv.port, {"artifact": artifacts["v2"]})
        assert status == 403 and "token" in body["error"]
    finally:
        open_srv.stop(drain=True)
    srv = ModelServer(artifacts["v1"], host="127.0.0.1", port=0,
                      max_batch=2, kv_blocks=32, kv_block_size=4,
                      device="cpu", token="s3cret")
    srv.start()
    try:
        assert _post(srv.port, {"artifact": artifacts["v2"]},
                     token="wrong")[0] == 403
        bad = str(tmp_path / "bad.veles.tgz")
        with open(bad, "wb") as fout:
            fout.write(b"not an artifact")
        with open(bad + ".manifest.json", "w") as fout:
            json.dump({"sha256": "0" * 64, "size": 1}, fout)
        status, body = _post(srv.port, {"artifact": bad}, token="s3cret")
        assert status == 409
        status, body = _post(srv.port, {}, token="s3cret")
        assert status == 409 and "no --reload-watch" in body["error"]
        status, body = _post(srv.port, {"artifact": artifacts["v2"]},
                             token="s3cret")
        assert status == 200 and body["weight_version"] == 2
        numpy.testing.assert_array_equal(
            srv.engine.submit_generate(PROMPT, MAX_NEW),
            _fresh(artifacts["v2"]))
        assert srv.stats_payload()["weight_version"] == 2
    finally:
        srv.stop(drain=True)


def test_watcher_reloads_on_pointer_move(artifacts, tmp_path):
    """--reload-watch on a ``_current.lnk`` pointer: moving it to a
    snapshot whose manifested artifact sibling exists hot-swaps it
    (check_once, as the poll loop calls it); a generation without a
    manifest is rejected once and remembered; the served answers follow
    the deployed generation."""
    def snapshot(name, source, manifest=True):
        blob = str(tmp_path / name)
        with open(blob, "wb") as fout:
            fout.write(name.encode())
        with open(source, "rb") as fin, \
                open(blob + R.ARTIFACT_SUFFIX, "wb") as fout:
            fout.write(fin.read())
        if manifest:
            R.write_manifest(blob + R.ARTIFACT_SUFFIX)
        return blob

    lnk = str(tmp_path / "m_current.lnk")
    with open(lnk, "w") as fout:
        fout.write(snapshot("m_1.pickle", artifacts["v1"]))
    srv = ModelServer(artifacts["v1"], host="127.0.0.1", port=0,
                      max_batch=2, kv_blocks=32, kv_block_size=4,
                      device="cpu", token="t", reload_watch=lnk,
                      reload_poll=3600.0)
    srv.start()
    try:
        watcher = srv.watcher
        assert watcher is not None and not watcher.check_once()
        with open(lnk, "w") as fout:
            fout.write(snapshot("m_2.pickle", artifacts["v2"],
                                manifest=False))
        assert watcher.check_once()          # rejected, remembered
        assert srv.engine.weight_version == 1
        assert not watcher.check_once()
        with open(lnk, "w") as fout:
            fout.write(os.path.basename(snapshot("m_3.pickle",
                                                 artifacts["v2"])))
        assert watcher.check_once()
        assert srv.engine.weight_version == 2
        numpy.testing.assert_array_equal(
            srv.engine.submit_generate(PROMPT, MAX_NEW),
            _fresh(artifacts["v2"]))
        assert srv.reload_artifact() == 3    # the watched target again
    finally:
        srv.stop(drain=True)
    assert srv.watcher is None
