"""The port's artifact side and LM programs (``veles_tpu_torch.export``)
against the JAX package's (``veles_tpu.export``), on one artifact.

The artifact is the JAX package's token-identity fixture
(``tests/test_ring_flash.py``): 2 pre-LN blocks, E=64, H=2, vocab 64,
positional table 128, random weights at std 0.5 from numpy seed 77.
A second artifact of the same geometry, written by the port with its
serving init (std 1/√fan_in), has logits of order 1: the logit
comparisons and a second run of every token comparison use it.  Both
packages load each; the port runs on the CPU, where its decode
wrapper takes the plain version.  Tolerances: logits rtol = atol =
1e-5 (float32, different matmul orders); greedy tokens exactly
equal.  Sampled tokens are compared only inside the port: the JAX
package samples from threefry keys, whose bits torch does not
reproduce.
"""

import io
import tarfile

import numpy
import pytest
import torch

from veles_tpu.config import root as jax_root
from veles_tpu.export import ExportedModel as JaxModel
from veles_tpu.export import KVBlockPool as JaxPool
from veles_tpu.json_encoders import dumps_json
from veles_tpu_torch import export as X
from veles_tpu_torch.error import Bug, DeviceNotFoundError

# Tier-1 runs test files in parallel workers: keep torch's CPU ops to
# two threads so these files do not starve the timing-sensitive ones.
torch.set_num_threads(2)

FWD_RTOL = FWD_ATOL = 1e-5


def _lm_weights(V=64, E=64, H=2, P=128, HID=128, BLOCKS=2, seed=77):
    rng = numpy.random.RandomState(seed)

    def g(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(numpy.float32)

    weights = {"emb__weights": g(V, E), "emb__pos": g(P, E)}
    units = [{"name": "emb", "type": "embedding",
              "config": {"vocab_size": V, "embed_dim": E},
              "params": {"weights": "emb__weights", "pos": "emb__pos"}}]
    for b in range(BLOCKS):
        name = "blk%d" % b
        params = {}
        for pname, shape in [
                ("ln1_g", (E,)), ("ln1_b", (E,)),
                ("wq", (E, E)), ("bq", (E,)), ("wk", (E, E)),
                ("bk", (E,)), ("wv", (E, E)), ("bv", (E,)),
                ("wo", (E, E)), ("bo", (E,)),
                ("ln2_g", (E,)), ("ln2_b", (E,)),
                ("w1", (E, HID)), ("b1", (HID,)),
                ("w2", (HID, E)), ("b2", (E,))]:
            key = "%s__%s" % (name, pname)
            weights[key] = numpy.ones(shape, numpy.float32) \
                if pname.endswith("_g") else g(*shape)
            params[pname] = key
        units.append({"name": name, "type": "transformer_block",
                      "config": {"n_heads": H, "causal": 1},
                      "params": params})
    weights["head__weights"] = g(E, V)
    units.append({"name": "head", "type": "lm_head",
                  "config": {"output_sample_shape": [V]},
                  "params": {"weights": "head__weights"}})
    manifest = {"format": "veles-tpu-model", "version": 1,
                "workflow": "RingFlashGate", "checksum": "t",
                "created": "1970-01-01T00:00:00Z",
                "input": {"sample_shape": [8], "dtype": "int32"},
                "output": {"sample_shape": [V]},
                "units": units}
    return manifest, weights


@pytest.fixture(scope="module")
def lm_artifact(tmp_path_factory):
    """Written the way the JAX package's tests write it (manifest +
    npz, no model.bin)."""
    manifest, weights = _lm_weights()
    npz = io.BytesIO()
    numpy.savez(npz, **weights)
    path = str(tmp_path_factory.mktemp("torchlm") / "lm.veles.tgz")
    with tarfile.open(path, "w:gz") as tar:
        for name, blob in (("manifest.json",
                            dumps_json(manifest).encode()),
                           ("weights.npz", npz.getvalue())):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return path


@pytest.fixture
def decode_knob():
    yield jax_root.common.engine
    jax_root.common.engine.decode_kernel = "off"


@pytest.fixture(scope="module")
def port_model(lm_artifact):
    return X.ExportedModel(lm_artifact, device="cpu")


PROMPT = numpy.random.RandomState(5).randint(0, 60, (2, 12)).astype(
    numpy.int32)


def test_lm_params_from_numpy_reproduces_jax_params(lm_artifact):
    jm = JaxModel(lm_artifact)
    want = jm._lm_params()
    got = X.lm_params_from_numpy(jm.units, jm.weights, "cpu")
    assert set(got) == set(want)
    assert got["head_b"] is None and want["head_b"] is None
    for key in ("emb_w", "emb_pos", "head_w"):
        assert got[key].dtype == torch.float32
        numpy.testing.assert_array_equal(got[key].numpy(),
                                         numpy.asarray(want[key]))
    assert len(got["blocks"]) == len(want["blocks"]) == 2
    for g, w in zip(got["blocks"], want["blocks"]):
        assert set(g) == set(w)
        for name in w:
            numpy.testing.assert_array_equal(g[name].numpy(),
                                             numpy.asarray(w[name]))


@pytest.fixture(scope="module")
def fan_in_artifact(tmp_path_factory):
    """The same geometry written by the port's writer with its
    serving init (std 1/√fan_in): logits of order 1, where a 1e-5
    tolerance is meaningful (at std 0.5 the logits reach ~500 and the
    JAX package's own jax and numpy forwards differ by ~1e-3)."""
    path = str(tmp_path_factory.mktemp("torchlm") / "fan.veles.tgz")
    return X.random_lm_artifact(path, vocab=64, embed=64, n_heads=2,
                                n_blocks=2, hidden=128, max_position=128,
                                seed=77)


def test_forward_logits_match_jax(fan_in_artifact):
    x = numpy.random.RandomState(3).randint(0, 64, (3, 20))
    want = JaxModel(fan_in_artifact).forward(x)
    got = X.ExportedModel(fan_in_artifact, device="cpu").forward(x)
    assert got.shape == want.shape == (3, 20, 64)
    numpy.testing.assert_allclose(got, want, rtol=FWD_RTOL,
                                  atol=FWD_ATOL)


ARTIFACTS = ["lm_artifact", "fan_in_artifact"]


@pytest.mark.parametrize("mode", ["off", "interpret"])
@pytest.mark.parametrize("which", ARTIFACTS)
def test_greedy_generate_matches_jax(decode_knob, request, which, mode):
    """Greedy generate is token-identical to the JAX package's, with
    its decode kernel off (dense) and on (Pallas, interpret mode), on
    both artifacts: the std-0.5 one's near one-hot softmax and the
    fan-in one's order-1 logits, where an attention or mask error
    moves the argmax."""
    path = request.getfixturevalue(which)
    decode_knob.decode_kernel = mode
    want = JaxModel(path).generate(PROMPT, 6)
    got = X.ExportedModel(path, device="cpu").generate(PROMPT, 6)
    numpy.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_generate_logits_match_jax(decode_knob, fan_in_artifact, mode):
    """The exact-length generate program's per-step logits agree with
    the JAX package's (kernel off and Pallas interpret) within rtol =
    atol = 1e-5, and its tokens are identical."""
    decode_knob.decode_kernel = mode
    want_tok, want = JaxModel(fan_in_artifact).generate(
        PROMPT, 6, return_logits=True)
    got_tok, got = X.ExportedModel(fan_in_artifact, device="cpu") \
        .generate(PROMPT, 6, return_logits=True)
    numpy.testing.assert_array_equal(got_tok, want_tok)
    assert got.shape == want.shape == (2, 6, 64)
    numpy.testing.assert_allclose(got, want, rtol=FWD_RTOL,
                                  atol=FWD_ATOL)


def test_return_logits_match_forward(fan_in_artifact):
    """The exact-length path's per-step logits are the full forward's
    last-position logits (rtol = atol = 1e-5)."""
    model = X.ExportedModel(fan_in_artifact, device="cpu")
    full, logits = model.generate(PROMPT, 4, return_logits=True)
    numpy.testing.assert_array_equal(full, model.generate(PROMPT, 4))
    fwd = model.forward(full[:, :-1])
    numpy.testing.assert_allclose(logits, fwd[:, PROMPT.shape[1] - 1:],
                                  rtol=FWD_RTOL, atol=FWD_ATOL)


def _paged_run(model, temps):
    """The paged sequence of the JAX package's decode-kernel gate: one
    12-token extend over 3-block tables (block size 8), then two steps.
    Row 0's table here starts at block 1, not at the TRASH block 0 as
    in that gate: the chunk's pad columns write to block 0, and a pad
    write landing on a real slot is scatter-order-undefined."""
    pool = model.make_kv_pool(16, block_size=8)
    tables = numpy.array([[1, 2, 6, 15], [3, 4, 5, 15]], numpy.int32)
    toks = numpy.zeros((2, 16), numpy.int32)
    toks[:, :12] = PROMPT
    seeds = numpy.arange(2).astype(numpy.uint32)
    outs = [model.paged_extend(
        pool, tables, toks, numpy.zeros(2, numpy.int32),
        numpy.full(2, 12, numpy.int32), numpy.full(2, temps, numpy.float32),
        seeds)]
    pos = numpy.full(2, 12, numpy.int32)
    for j in range(2):
        outs.append(model.paged_step(
            pool, tables, pos, outs[-1], numpy.full(2, j + 1, numpy.int32),
            numpy.full(2, temps, numpy.float32), seeds))
        pos = pos + 1
    return numpy.stack(outs)


@pytest.mark.parametrize("mode", ["off", "interpret"])
@pytest.mark.parametrize("which", ARTIFACTS)
def test_paged_extend_step_match_jax(decode_knob, request, which, mode):
    """paged_extend + paged_step greedy tokens == the JAX package's on
    the same tables and positions, on both artifacts (the JAX paged
    programs return tokens only, so tokens are what is compared)."""
    path = request.getfixturevalue(which)
    decode_knob.decode_kernel = mode
    want = _paged_run(JaxModel(path), 0.0)
    got = _paged_run(X.ExportedModel(path, device="cpu"), 0.0)
    numpy.testing.assert_array_equal(got, want)


def test_paged_sampling_matches_bucketed_inside_the_port(port_model):
    """The port's per-row (seed, gen_idx) stream is shared by the
    paged and the whole-request programs: sampled decode agrees.  (The
    fixture's logits span hundreds, so a temperature of 100 is what
    makes the draw differ from greedy.)"""
    paged = _paged_run(port_model, 100.0)
    whole = port_model.generate_bucketed(
        numpy.pad(PROMPT, ((0, 0), (0, 4))), numpy.full(2, 12), 3,
        temperatures=100.0, seeds=numpy.arange(2))
    numpy.testing.assert_array_equal(paged.T, whole)
    greedy = port_model.generate_bucketed(
        numpy.pad(PROMPT, ((0, 0), (0, 4))), numpy.full(2, 12), 3)
    assert not numpy.array_equal(whole, greedy)


def test_port_artifact_loads_in_jax(tmp_path, port_model):
    """write_artifact packs manifest.json + weights.npz + model.bin as
    the JAX package does: JAX's loader reads it, weights bit-equal,
    and both packages' forward agree."""
    path = X.random_lm_artifact(str(tmp_path / "r.veles.tgz"), vocab=32,
                                embed=32, n_heads=2, n_blocks=1,
                                hidden=64, max_position=64, seed=9)
    with tarfile.open(path) as tar:
        assert tar.getnames() == ["manifest.json", "weights.npz",
                                  "model.bin"]
    jm = JaxModel(path)
    pm = X.ExportedModel(path, device="cpu")
    assert jm.manifest == pm.manifest
    assert set(jm.weights) == set(pm.weights)
    for key, arr in jm.weights.items():
        numpy.testing.assert_array_equal(arr, pm.weights[key])
    w = pm.weights["blk0__wq"]
    assert abs(float(w.std()) - 32 ** -0.5) < 0.02
    assert (pm.weights["blk0__ln1_g"] == 1.0).all()
    x = numpy.random.RandomState(1).randint(0, 32, (2, 9))
    numpy.testing.assert_allclose(pm.forward(x), jm.forward(x),
                                  rtol=FWD_RTOL, atol=FWD_ATOL)


def test_refusals(tmp_path, port_model):
    pool = port_model.make_kv_pool(8, kv_dtype="int8")
    with pytest.raises(Bug, match="not yet ported"):
        port_model.export_kv_blocks(pool, [1])
    with pytest.raises(Bug, match="not yet ported"):
        port_model.import_kv_blocks(pool, [1], None)
    with pytest.raises(Bug, match="unknown KV storage dtype"):
        port_model.make_kv_pool(8, kv_dtype="f16")
    manifest, weights = _lm_weights(BLOCKS=1)
    manifest["units"].insert(1, {"name": "fc", "type": "all2all",
                                 "config": {}, "params": {}})
    path = X.write_artifact(str(tmp_path / "fc.tgz"), manifest, weights)
    with pytest.raises(Bug, match="'all2all'.*not yet ported"):
        X.ExportedModel(path, device="cpu")
    moe, moe_weights = _lm_weights(BLOCKS=1)
    moe["units"][1]["type"] = "moe_transformer_block"
    moe_path = X.write_artifact(str(tmp_path / "moe.tgz"), moe, moe_weights)
    with pytest.raises(Bug, match="moe_transformer_block.*not yet ported"):
        X.ExportedModel(moe_path, device="cpu")
    with pytest.raises(DeviceNotFoundError, match="unknown device"):
        X.ExportedModel(path, device="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(DeviceNotFoundError, match="no CUDA card"):
            X.ExportedModel(path)


def _pool_script(pool):
    """One alloc/retain/release/prefix/COW sequence; returns every
    observable of the pool along the way."""
    seen = []
    toks = numpy.arange(20, dtype=numpy.int32)
    a = pool.alloc(3)
    seen.append(("alloc", a, pool.occupancy()))
    pool.register_prefix(toks[:12], a)
    k, shared = pool.lookup_prefix(toks[:16])
    seen.append(("lookup", k, shared, [pool.refs_of(b) for b in a]))
    fresh = pool.cow_copy(shared[-1])
    seen.append(("cow", fresh, pool.occupancy()))
    pool.retain([0, fresh])
    pool.release([fresh, fresh])
    pool.release(a)
    seen.append(("release", [pool.refs_of(b) for b in range(8)],
                 pool.occupancy()))
    pool.release(shared)
    b = pool.alloc(5)
    seen.append(("evict", b, pool.occupancy()))
    pool.release(b)
    adopted = pool.adopt_prefix_blocks(toks, 2)
    seen.append(("adopt", adopted, pool.lookup_prefix(toks[:8]),
                 pool.occupancy()))
    seen.append(("drop", pool.drop_prefixes(), pool.alloc(99),
                 pool.occupancy()))
    return seen


def test_kv_block_pool_matches_jax():
    """The copied host-side pool gives identical ids, refcounts and
    occupancy to the JAX package's for the same sequence."""
    got = _pool_script(X.KVBlockPool(8, 4, prefix_capacity=3))
    want = _pool_script(JaxPool(8, 4, prefix_capacity=3))
    assert got == want
