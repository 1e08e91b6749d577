"""The port's quantized memory planes (``veles_tpu_torch.export`` KV
planes and weight-only int8, ``veles_tpu_torch.ops.decode_attention``
B5) against the JAX package's (``veles_tpu.export``,
``pallas_decode_attention`` in interpret mode).

The artifact is the JAX package's quality-gate fixture
(``tests/test_quant.py``: vocab 13, embed 8, 2 heads, positions 32,
MLP 16, weights at 0.35 sigma from numpy seed 7); both packages load it
and the port runs on the CPU, where every wrapper takes its plain
version.  Tolerances, each with its reason:

* quantizers: bit for bit — the same float32 division, clip and
  round-half-to-even in both packages;
* pool contents after the same paged run: int8 codes within one code,
  fp8 codes within one e4m3 step, bf16 values within one bf16 ulp, and
  scales within rtol 1e-5 — k and v are float32 products summed in a
  different order by XLA and torch, so a value on a rounding edge may
  land one code apart;
* greedy tokens: equal;
* B5's plain version against the Pallas quantized kernel: rtol = atol
  = 1e-6, the JAX package's own gate for that kernel;
* int8-weight logits against the JAX package's: rtol = atol = 1e-5
  (float32, different matmul orders).

The CUDA kernel runs only on the card: its test carries the ``cuda``
marker and skips here.
"""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import export as JX
from veles_tpu.config import root as jax_root
from veles_tpu.ops import pallas_attention as PA
from veles_tpu_torch import export as X
from veles_tpu_torch.config import root
from veles_tpu_torch.error import Bug
from veles_tpu_torch.ops import decode_attention as DA
from veles_tpu_torch.serving import ServingEngine, live_serving_summary

from tests.test_quant import _quant_lm_artifact

# Tier-1 runs test files in parallel workers: keep torch's CPU ops to
# two threads so these files do not starve the timing-sensitive ones.
torch.set_num_threads(2)

QUANT_DTYPES = ("int8", "fp8")
POOL_RTOL = 1e-5
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
B5_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return _quant_lm_artifact(
        str(tmp_path_factory.mktemp("tquant") / "q.veles.tgz"))


@pytest.fixture(scope="module")
def models(artifact):
    return X.ExportedModel(artifact, device="cpu"), JX.ExportedModel(artifact)


@pytest.fixture(autouse=True)
def _f32_weight_mode():
    """Both packages start and end in the default weight mode."""
    root.common.serving.weight_dtype = "f32"
    jax_root.common.serving.weight_dtype = "f32"
    yield
    root.common.serving.weight_dtype = "f32"
    jax_root.common.serving.weight_dtype = "f32"


def _weight_mode(mode):
    root.common.serving.weight_dtype = mode
    jax_root.common.serving.weight_dtype = mode


def _codes(storage_tensor):
    """A pool tensor of either package as a float32 numpy array."""
    if isinstance(storage_tensor, torch.Tensor):
        return storage_tensor.float().numpy()
    return numpy.asarray(storage_tensor).astype(numpy.float32)


# -- the quantizer ---------------------------------------------------------

def _fp8_values():
    """Every finite float8_e4m3fn value (254 of the 256 codes; 0x7f and
    0xff are NaN)."""
    bits = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    vals = bits.view(torch.float8_e4m3fn).float()
    return vals[torch.isfinite(vals)]


def _quantizer_inputs(kv_dtype):
    """(values, broadcast scales): random values at random scales, exact
    halfway points, values past the clip, and rows of zero scale."""
    rng = numpy.random.RandomState(3)
    vals = rng.standard_normal((6, 40)).astype(numpy.float32) * 3.0
    scale = numpy.abs(rng.standard_normal((6, 1))).astype(
        numpy.float32) * 0.02 + 0.001
    scale[1] = 0.0
    if kv_dtype == "int8":
        ties = numpy.arange(-130, 130, dtype=numpy.float32) + 0.5
        tie_vals = ties[None, :]
        tie_scale = numpy.ones((1, 1), numpy.float32)
    else:
        grid = numpy.unique(_fp8_values().numpy())
        mids = (grid[:-1] + grid[1:]) / 2.0     # exactly representable
        tie_vals = numpy.concatenate([grid, mids, [449.0, -500.0, 1e6,
                                                   -1e6, 464.0]])[None, :]
        tie_scale = numpy.ones((1, 1), numpy.float32)
    vals = [vals, tie_vals.astype(numpy.float32)]
    scales = [numpy.broadcast_to(scale, vals[0].shape),
              numpy.broadcast_to(tie_scale, vals[1].shape)]
    return [(numpy.ascontiguousarray(v), numpy.ascontiguousarray(s))
            for v, s in zip(vals, scales)]


@pytest.mark.parametrize("kv_dtype", QUANT_DTYPES)
def test_kv_quantize_matches_jax_bit_for_bit(kv_dtype):
    """_kv_quantize equals the JAX package's bit for bit: int8 rounds
    half to even, fp8 clips to ±448 and rounds to nearest even (every
    e4m3 value maps to itself, every midpoint to its even neighbour),
    and a zero scale gives a zero code."""
    for vals, scale in _quantizer_inputs(kv_dtype):
        got = X._kv_quantize(torch.from_numpy(vals),
                             torch.from_numpy(scale), kv_dtype)
        want = numpy.asarray(JX._kv_quantize(jnp.asarray(vals),
                                             jnp.asarray(scale), kv_dtype))
        assert got.dtype == X._KV_TORCH[kv_dtype]
        numpy.testing.assert_array_equal(
            got.view(torch.uint8).numpy(), want.view(numpy.uint8))
    if kv_dtype == "fp8":
        grid = _fp8_values()
        same = X._kv_quantize(grid, torch.ones_like(grid), "fp8").float()
        numpy.testing.assert_array_equal(same.numpy(), grid.numpy())


def test_kv_dtype_registry(models):
    assert X.check_kv_dtype(None) == "f32"
    assert all(X.kv_dtype_supported(d) for d in X.KV_DTYPES)
    with pytest.raises(Bug, match="unknown KV storage dtype"):
        X.check_kv_dtype("int4")
    root.common.serving.kv_dtype = "int8"
    try:
        assert models[0].make_kv_pool(4, 4).kv_dtype == "int8"
    finally:
        root.common.serving.kv_dtype = "f32"


# -- the pool --------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", X.KV_DTYPES)
def test_pool_block_bytes_match_jax(models, kv_dtype):
    """block_bytes (codes plus the per-(block, head) f32 scales) and the
    storage layout equal the JAX package's on every plane."""
    pm, jm = models
    mine = pm.make_kv_pool(16, 4, kv_dtype=kv_dtype)
    theirs = jm.make_kv_pool(16, 4, kv_dtype=kv_dtype)
    assert mine.block_bytes == theirs.block_bytes > 0
    assert mine.occupancy() == theirs.occupancy()
    assert len(mine.storage) == len(theirs.storage)
    for group_m, group_j in zip(mine.storage, theirs.storage):
        assert [tuple(t.shape) for t in group_m] == \
            [tuple(t.shape) for t in group_j]
    f32 = pm.make_kv_pool(16, 4).block_bytes
    if kv_dtype in QUANT_DTYPES:
        assert f32 // 4 < mine.block_bytes <= f32 // 2


def _pool_journal(model, kv_dtype):
    """JAX's storage-blindness sequence: alloc/retain/release/prefix/COW
    and occupancy."""
    pool = model.make_kv_pool(24, 4, kv_dtype=kv_dtype)
    log = []
    a = pool.alloc(3)
    b = pool.alloc(2)
    log.append(("alloc", tuple(a), tuple(b)))
    pool.retain(a[:1])
    log.append(("refs", pool.refs_of(a[0])))
    pool.release(a[:1])
    toks = numpy.arange(8, dtype=numpy.int32)
    pool.register_prefix(toks, a[:2])
    n, hit = pool.lookup_prefix(toks)
    log.append(("prefix", n, tuple(hit)))
    pool.release(hit)
    c = pool.cow_copy(a[1])
    log.append(("cow", c, pool.refs_of(a[1]), pool.refs_of(c)))
    log.append(("occ", pool.occupancy()))
    return log


@pytest.mark.parametrize("kv_dtype", X.KV_DTYPES)
def test_pool_accounting_matches_jax(models, kv_dtype):
    """The pool-accounting script gives the JAX package's ids, refcounts,
    prefix hits, COW counts and bytes on every plane."""
    pm, jm = models
    assert _pool_journal(pm, kv_dtype) == _pool_journal(jm, kv_dtype)


def _extend(model, pool, ids, tokens):
    return model.paged_extend(
        pool, numpy.array([list(ids)], numpy.int32),
        numpy.array([tokens], numpy.int32), numpy.zeros(1, numpy.int32),
        numpy.full(1, len(tokens), numpy.int32),
        numpy.zeros(1, numpy.float32), numpy.zeros(1, numpy.uint32))


@pytest.mark.parametrize("kv_dtype", X.KV_DTYPES[1:])
def test_cow_copy_preserves_quantized_bits(models, kv_dtype):
    """A COW copy lands byte-identical codes and scales — shared-prefix
    decode cannot drift between the sharer and the copier."""
    pm, _ = models
    pool = pm.make_kv_pool(12, 4, kv_dtype=kv_dtype)
    ids = pool.alloc(2)
    _extend(pm, pool, ids, [3, 1, 4, 1, 5, 9])
    dst = pool.cow_copy(ids[0])
    for group in pool.storage:
        for t in group:
            assert torch.equal(t[dst].view(torch.uint8)
                               if t.element_size() == 1 else t[dst],
                               t[ids[0]].view(torch.uint8)
                               if t.element_size() == 1 else t[ids[0]])
    assert pool.occupancy()["cow_copies"] == 1


@pytest.mark.parametrize("kv_dtype", QUANT_DTYPES)
def test_reused_block_quantizes_as_fresh(models, kv_dtype):
    """A block that returns to the pool and is handed out again starts
    from a zero scale: a prompt extended into reused blocks, whose last
    owner left scales a thousand times larger, stores the bits it
    stores in a fresh pool (the JAX package keeps the old scale, so
    there the new owner's codes would depend on the block's history)."""
    pm, _ = models
    tokens = [3, 1, 4, 1, 5, 9]
    fresh = pm.make_kv_pool(8, 4, kv_dtype=kv_dtype)
    ids = fresh.alloc(2)
    want = _extend(pm, fresh, ids, tokens)
    used = pm.make_kv_pool(8, 4, kv_dtype=kv_dtype)
    first = used.alloc(2)
    _extend(pm, used, first, [2, 7, 1, 8, 2, 8])
    for t in used.storage[2] + used.storage[3]:
        t[first] *= 1000.0
    used.release(first)
    again = used.alloc(2)
    assert sorted(again) == sorted(first)
    numpy.testing.assert_array_equal(_extend(pm, used, again, tokens), want)
    for mine, theirs in zip(used.storage, fresh.storage):
        for t, w in zip(mine, theirs):
            assert torch.equal(t[again].view(torch.uint8)
                               if t.element_size() == 1 else t[again],
                               w[ids].view(torch.uint8)
                               if w.element_size() == 1 else w[ids])


# -- paged decode on the planes against the JAX package --------------------

PROMPTS = [[3, 1, 4, 1, 5, 9, 2], [7, 3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
           [2, 7]]


def _paged_run(model, kv_dtype, steps=8):
    """Three rows of different lengths: one extend (block size 4, tables
    of 5 blocks from block 1), then ``steps`` decode steps.  Returns the
    tokens and the pool."""
    pool = model.make_kv_pool(20, 4, kv_dtype=kv_dtype)
    B = len(PROMPTS)
    tables = (1 + numpy.arange(B * 5, dtype=numpy.int32)).reshape(B, 5)
    lengths = numpy.array([len(p) for p in PROMPTS], numpy.int32)
    tokens = numpy.zeros((B, 16), numpy.int32)
    for i, p in enumerate(PROMPTS):
        tokens[i, :len(p)] = p
    zeros = numpy.zeros(B, numpy.float32)
    seeds = numpy.zeros(B, numpy.uint32)
    tok = model.paged_extend(pool, tables, tokens, numpy.zeros(B, numpy.int32),
                             lengths, zeros, seeds)
    out = [tok]
    for j in range(1, steps):
        tok = model.paged_step(pool, tables, lengths + j - 1, tok,
                               numpy.full(B, j, numpy.int32), zeros, seeds)
        out.append(tok)
    return numpy.stack(out, axis=1), pool


@pytest.mark.parametrize("kv_dtype", X.KV_DTYPES[1:])
def test_paged_planes_match_jax(models, kv_dtype):
    """paged_extend + paged_step on the bf16, int8 and fp8 planes: greedy
    tokens identical to the JAX package's on the same tables; the pool
    contents within one code (one bf16 ulp) and the scales within rtol
    1e-5."""
    pm, jm = models
    got, pool_m = _paged_run(pm, kv_dtype)
    want, pool_j = _paged_run(jm, kv_dtype)
    numpy.testing.assert_array_equal(got, want)
    ks_m, vs_m, sks_m, svs_m = X._kv_unpack(pool_m.storage)
    ks_j, vs_j, sks_j, svs_j = JX._kv_unpack(pool_j.storage)
    for a, b in zip(list(ks_m) + list(vs_m), list(ks_j) + list(vs_j)):
        a, b = _codes(a)[1:], _codes(b)[1:]    # block 0 is junk (trash)
        if kv_dtype == "int8":
            assert numpy.abs(a - b).max() <= 1.0
        else:   # one step of e4m3 (3 mantissa bits) or of bf16 (7)
            step = 2.0 ** -3 if kv_dtype == "fp8" else 2.0 ** -7
            assert (numpy.abs(a - b) <=
                    step * numpy.maximum(numpy.abs(a), numpy.abs(b)) +
                    1e-30).all()
    if sks_m is not None:
        for a, b in zip(list(sks_m) + list(svs_m), list(sks_j) + list(svs_j)):
            numpy.testing.assert_allclose(_codes(a)[1:], _codes(b)[1:],
                                          rtol=POOL_RTOL, atol=0)


def _greedy_paged(model, pool, prompt, max_new):
    """The JAX package's single-row greedy helper (extend + steps)."""
    per = -(-(len(prompt) + max_new) // pool.block_size)
    ids = pool.alloc(per)
    tables = numpy.zeros((1, per), numpy.int32)
    tables[0, :len(ids)] = ids
    t0 = model.paged_extend(
        pool, tables, numpy.array([prompt], numpy.int32),
        numpy.zeros(1, numpy.int32), numpy.full(1, len(prompt), numpy.int32),
        numpy.zeros(1, numpy.float32), numpy.zeros(1, numpy.uint32))
    out = [int(t0[0])]
    pos, cur = len(prompt), int(t0[0])
    for _ in range(max_new - 1):
        tn = model.paged_step(
            pool, tables, numpy.full(1, pos, numpy.int32),
            numpy.array([cur], numpy.int32), numpy.zeros(1, numpy.int32),
            numpy.zeros(1, numpy.float32), numpy.zeros(1, numpy.uint32))
        cur = int(tn[0])
        out.append(cur)
        pos += 1
    pool.release(ids)
    return out


@pytest.mark.parametrize("kv_dtype", X.KV_DTYPES[1:])
def test_kv_greedy_parity_bounded_divergence(models, kv_dtype):
    """The JAX package's KV quality gate, run on the port: greedy decode
    from a quantized (or bf16) pool tracks the f32 pool — any divergence
    at step 8 of 12 or later, and at least 94 % of the tokens matched."""
    pm, _ = models
    rng = numpy.random.RandomState(3)
    prompts = [rng.randint(0, 13, int(rng.randint(3, 10))).tolist()
               for _ in range(6)]
    max_new = 12
    matched = 0
    for prompt in prompts:
        outs = {dt: _greedy_paged(pm, pm.make_kv_pool(24, 4, kv_dtype=dt),
                                  prompt, max_new)
                for dt in ("f32", kv_dtype)}
        div = next((i for i, (a, b) in enumerate(zip(outs["f32"],
                                                     outs[kv_dtype]))
                    if a != b), max_new)
        assert div >= 8, (prompt, outs)
        matched += div
    assert matched >= int(0.94 * max_new * len(prompts))


# -- weight-only int8 ------------------------------------------------------

def test_quantize_weight_matches_jax_bit_for_bit(models):
    """_quantize_weight's codes and scales equal the JAX package's bit
    for bit for every decode matmul weight and the head (both built from
    the same float32 weights)."""
    pm, jm = models
    _weight_mode("int8")
    mine, theirs = pm._lm_params(), jm._lm_params()
    pairs = [(mine, theirs, "head_w")] + [
        (bm, bj, name) for bm, bj in zip(mine["blocks"], theirs["blocks"])
        for name in X.ExportedModel._WQ_NAMES if name in bm]
    assert len(pairs) == 7
    for m, j, name in pairs:
        assert m[name].dtype == torch.int8
        numpy.testing.assert_array_equal(m[name].numpy(),
                                         numpy.asarray(j[name]))
        numpy.testing.assert_array_equal(m[name + "__s"].numpy(),
                                         numpy.asarray(j[name + "__s"]))
    zero = {"w": torch.zeros((3, 2))}
    X.ExportedModel._quantize_weight(zero, "w")
    assert not zero["w"].any() and not zero["w__s"].any()


def test_int8_weight_logits_match_jax(models):
    """The int8-weight decode program's per-step logits agree with the
    JAX package's within rtol = atol = 1e-5, tokens equal."""
    pm, jm = models
    _weight_mode("int8")
    prompt = numpy.array([[7, 3, 1, 4, 1, 5]], numpy.int32)
    got_tok, got = pm.generate(prompt, 5, return_logits=True)
    want_tok, want = jm.generate(prompt, 5, return_logits=True)
    numpy.testing.assert_array_equal(got_tok, want_tok)
    numpy.testing.assert_allclose(got, want, **LOGIT_TOL)
    _weight_mode("f32")
    f32 = pm.generate(prompt, 5, return_logits=True)[1]
    assert not numpy.array_equal(f32, got)


def test_weight_int8_perplexity_delta_gate(models):
    """The JAX package's weight-only gate, run on the port: the
    teacher-forced mean NLL under the int8 decode program stays within
    0.05 nats of the f32 program's."""
    pm, _ = models
    rng = numpy.random.RandomState(11)
    seq = rng.randint(0, 13, 24).astype(numpy.int32)
    wins = numpy.stack([seq[i:i + 12] for i in range(8)])
    nxt = seq[12:20]
    nll = {}
    for mode in ("f32", "int8"):
        root.common.serving.weight_dtype = mode
        _, logits = pm.generate(wins, 1, return_logits=True)
        z = logits[:, 0, :].astype(numpy.float64)
        lse = z.max(-1) + numpy.log(
            numpy.exp(z - z.max(-1, keepdims=True)).sum(-1))
        nll[mode] = float(-(z[numpy.arange(8), nxt] - lse).mean())
    assert abs(nll["int8"] - nll["f32"]) < 0.05, nll


def test_weight_mode_requantizes_on_flip(models):
    """_lm_params caches per mode: flipping the config rebuilds the
    decode parameters (int8 codes + __s scales appear and disappear);
    forward stays the float32 oracle in either mode."""
    pm, _ = models
    x = numpy.array([[1, 2, 3, 4]])
    f32_forward = pm.forward(x)
    root.common.serving.weight_dtype = "int8"
    params = pm._lm_params()
    blk = params["blocks"][0]
    assert blk["wq"].dtype == torch.int8
    assert tuple(blk["wq__s"].shape) == (blk["wq"].shape[1],)
    assert params["head_w"].dtype == torch.int8
    numpy.testing.assert_array_equal(pm.forward(x), f32_forward)
    root.common.serving.weight_dtype = "f32"
    params = pm._lm_params()
    assert params["blocks"][0]["wq"].dtype == torch.float32
    assert "wq__s" not in params["blocks"][0]
    root.common.serving.weight_dtype = "f16"
    with pytest.raises(Bug, match="unknown decode weight dtype"):
        pm._lm_params()


def test_quant_modes_ride_compile_keys(models):
    """Storage dtype and weight mode both ride the paged entry points'
    keys, at the JAX package's positions (6 and 7)."""
    pm, _ = models
    prompt = [3, 1, 4, 1]
    for dt in ("f32", "int8"):
        _greedy_paged(pm, pm.make_kv_pool(12, 4, kv_dtype=dt), prompt, 2)
    root.common.serving.weight_dtype = "int8"
    _greedy_paged(pm, pm.make_kv_pool(12, 4, kv_dtype="f32"), prompt, 2)
    keys = [k for k in list(pm.compile_cache._entries)
            if k and k[0] == "pext" and k[4] == 12]
    modes = {(k[6], k[7]) for k in keys}
    assert {("f32", "f32"), ("int8", "f32"), ("f32", "int8")} <= modes


# -- B5's plain version ----------------------------------------------------

def _quant_operands(B, Sq, H, D, L, kv_dtype, seed):
    """q, codes and (B, L, H) scales made as the JAX package's test makes
    them (per position and head, amax / qmax), a ragged mask with one
    fully masked row."""
    rng = numpy.random.RandomState(seed)
    qmax = X._KV_QMAX[kv_dtype]
    q = rng.standard_normal((B, Sq, H, D)).astype(numpy.float32)
    codes, scales = [], []
    for _ in range(2):
        f = rng.standard_normal((B, L, H, D)).astype(numpy.float32)
        s = (numpy.abs(f).max(-1) / qmax).astype(numpy.float32)
        c = X._kv_quantize(torch.from_numpy(f),
                           torch.from_numpy(s[..., None]), kv_dtype)
        codes.append(c)
        scales.append(s)
    lens = rng.randint(1, L + 1, B)
    mask = numpy.arange(L)[None, None, :] < numpy.maximum(
        lens[:, None] - (Sq - 1 - numpy.arange(Sq))[None, :], 1)[:, :, None]
    mask[0, Sq - 1] = False
    return q, codes, scales, mask


@pytest.mark.parametrize("kv_dtype", QUANT_DTYPES)
@pytest.mark.parametrize("sq", [1, 5, 16])
def test_quant_reference_matches_pallas_interpret(kv_dtype, sq):
    """decode_attention_quant_reference == the JAX package's quantized
    Pallas decode kernel (interpret mode, f32 operands, k_scale and
    v_scale) within rtol = atol = 1e-6; the wrapper on CPU tensors takes
    it; swapped k and v scales are caught."""
    B, H, D, L = 2, 2, 16, 128
    q, (kc, vc), (ks, vs), mask = _quant_operands(B, sq, H, D, L, kv_dtype,
                                                  sq * 7)
    jcode = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kv_dtype]
    want = numpy.asarray(PA.pallas_decode_attention(
        jnp.asarray(q), jnp.asarray(kc.float().numpy()).astype(jcode),
        jnp.asarray(vc.float().numpy()).astype(jcode), jnp.asarray(mask),
        operand_dtype=jnp.float32, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    args = (torch.from_numpy(q), kc, vc, torch.from_numpy(mask),
            torch.from_numpy(ks), torch.from_numpy(vs))
    got = DA.decode_attention_quant_reference(*args)
    numpy.testing.assert_allclose(got.numpy(), want, **B5_TOL)
    assert not got[0, sq - 1].any()
    via = DA.decode_attention(*args[:4], k_scale=args[4], v_scale=args[5])
    assert torch.equal(via, got)
    assert torch.equal(DA.decode_attention_reference(
        *args[:4], k_scale=args[4], v_scale=args[5]), got)
    swapped = DA.decode_attention_quant_reference(*args[:4], args[5],
                                                  args[4])
    assert not numpy.allclose(swapped.numpy(), want, **B5_TOL)


def test_quant_wrapper_contract():
    q = torch.zeros((1, 1, 2, 8))
    codes = torch.zeros((1, 4, 2, 8), dtype=torch.int8)
    mask = torch.ones((1, 1, 4), dtype=torch.bool)
    scale = torch.ones((1, 4, 2))
    with pytest.raises(ValueError, match="go together"):
        DA.decode_attention(q, codes, codes, mask, k_scale=scale)
    with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
        DA.decode_attention(q, codes.float(), codes.float(), mask,
                            k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="k_scale must be"):
        DA.decode_attention(q, codes, codes, mask, k_scale=scale[:, :2],
                            v_scale=scale)
    with pytest.raises(ValueError, match="float32"):
        DA.decode_attention(q, codes, codes, mask, k_scale=scale.double(),
                            v_scale=scale)
    assert DA.decode_attention(q, codes, codes, mask, k_scale=scale,
                               v_scale=scale).shape == q.shape


@pytest.fixture
def cuda_card():
    """Skips unless torch sees a CUDA card (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", QUANT_DTYPES)
@pytest.mark.parametrize("sq,L", [(1, 1024), (5, 1000), (16, 1024)])
def test_b5_matches_reference_on_card(cuda_card, kv_dtype, sq, L):
    """B5 against its plain version at the serving widths (B=8, H=16,
    D=128): float32 arithmetic on the same dequantized values, rtol =
    atol = 1e-5; it counts its own launches, not B4's."""
    q, (kc, vc), (ks, vs), mask = _quant_operands(8, sq, 16, 128, L,
                                                  kv_dtype, sq + L)
    args = [torch.from_numpy(q), kc, vc, torch.from_numpy(mask),
            torch.from_numpy(ks), torch.from_numpy(vs)]
    args = [a.to(cuda_card) for a in args]
    b4, b5 = DA.decode_attention.launches, DA.decode_attention.quant_launches
    out = DA.decode_attention(*args[:4], k_scale=args[4], v_scale=args[5])
    torch.cuda.synchronize()
    assert (DA.decode_attention.launches,
            DA.decode_attention.quant_launches) == (b4, b5 + 1)
    torch.testing.assert_close(
        out, DA.decode_attention_quant_reference(*args), rtol=1e-5,
        atol=1e-5)


# -- the engine ------------------------------------------------------------

def test_engine_kv_dtype_counter_and_byte_gauges(models):
    """ServingEngine(kv_dtype=...) builds the plane's pool, answers as
    the f32 engine does on this artifact, and reports the quant.kv
    counter, the byte gauges and the live summary's bytes."""
    pm, _ = models
    prompt = numpy.array([[7, 3, 1, 4, 1]], numpy.int32)
    ref = None
    for dt in X.KV_DTYPES:
        engine = ServingEngine(pm, max_batch=2, kv_blocks=32,
                               kv_block_size=4, kv_dtype=dt).start()
        try:
            out = engine.submit_generate(prompt, 6)
            ref = out if ref is None else ref
            numpy.testing.assert_array_equal(out, ref)
            assert engine.kv_pool.kv_dtype == dt
            assert engine.stats.get("quant.kv.%s" % dt) == 1
            engine._update_gauges()
            occ = engine.kv_pool.occupancy()
            assert engine.stats.gauge("kv_bytes_total") == \
                occ["bytes_total"] > 0
            assert engine.stats.gauge("kv_bytes_used") == occ["bytes_used"]
            summary = live_serving_summary()
            assert summary["kv_dtype"] == dt
            assert summary["kv_bytes_total"] == occ["bytes_total"]
        finally:
            engine.stop()
