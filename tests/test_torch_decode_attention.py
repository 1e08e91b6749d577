"""The port's flash-decode attention (``veles_tpu_torch.ops
.decode_attention``) against the JAX package's Pallas decode kernel.

The same numpy inputs go through ``pallas_decode_attention`` (f32
operands, interpret mode — how the JAX package's own tests run the
kernel on the CPU), the port's plain version, the port's wrapper on CPU
tensors, and the dense masked softmax.  Tolerance: rtol = atol = 2e-5,
the JAX package's own decode-kernel gate; only the order of the float32
sums differs.  A row's result must not depend on the rows, batches or
masked keys launched beside it, bit for bit: pinned here on the plain
versions (f32, int8, fp8).  The CUDA kernels run only on the card: their
tests (the same invariances, the scalar copy path — f32 at D = 70,
codes at D = 72 —, ragged widths, B5 == B4 on the dequantized table)
carry the ``cuda`` marker and skip here.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops import pallas_attention as PA
from veles_tpu_torch.ops import decode_attention as DA

# Tier-1 runs test files in parallel workers: keep torch's CPU ops to
# two threads so these files do not starve the timing-sensitive ones.
torch.set_num_threads(2)

RTOL = ATOL = 2e-5


def _inputs(B, sq, H, D, L, seed):
    rng = numpy.random.RandomState(seed)
    q = rng.standard_normal((B, sq, H, D)).astype(numpy.float32)
    k = rng.standard_normal((B, L, H, D)).astype(numpy.float32)
    v = rng.standard_normal((B, L, H, D)).astype(numpy.float32)
    lens = numpy.array([7, 23, 40])[:B]
    # Ragged per-row prefixes: row r of batch b sees keys
    # < lens[b] - (sq - 1 - r), at least one; the last query row of
    # batch 0 sees nothing at all.
    limit = numpy.maximum(
        lens[:, None] - (sq - 1 - numpy.arange(sq))[None, :], 1)
    mask = numpy.arange(L)[None, None, :] < limit[:, :, None]
    mask[0, sq - 1] = False
    return q, k, v, mask


def _dense(q, k, v, mask):
    D = q.shape[-1]
    scores = numpy.einsum("bqhd,bkhd->bqhk", q, k) / numpy.sqrt(D)
    scores = numpy.where(mask[:, :, None, :], scores, -1e30)
    scores -= scores.max(axis=-1, keepdims=True)
    w = numpy.exp(scores)
    w /= w.sum(axis=-1, keepdims=True)
    return numpy.einsum("bqhk,bkhd->bqhd", w, v)


@pytest.mark.parametrize("sq", [1, 4, 16])
def test_reference_matches_pallas_decode_kernel(sq):
    """decode_attention_reference == the Pallas decode kernel (split
    over key blocks + lse merge) under ragged masks and a fully masked
    row (out = 0 in both), and == the dense formula on every row that
    sees a key; the wrapper on CPU tensors takes the plain version and
    launches nothing."""
    q, k, v, mask = _inputs(3, sq, 2, 4, 40, seed=31 + sq)
    want = numpy.asarray(PA.pallas_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask), block_k=8, operand_dtype=jnp.float32,
        interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v, mask)]
    launches = DA.decode_attention.launches
    ref = DA.decode_attention_reference(*args).numpy()
    got = DA.decode_attention(*args).numpy()
    assert DA.decode_attention.launches == launches
    numpy.testing.assert_allclose(ref, want, rtol=RTOL, atol=ATOL)
    numpy.testing.assert_array_equal(got, ref)
    assert not want[0, sq - 1].any() and not ref[0, sq - 1].any()
    seen = mask.any(axis=-1)
    numpy.testing.assert_allclose(ref[seen], _dense(q, k, v, mask)[seen],
                                  rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("q_shape,k_shape,ok", [
    ((8, 1, 16, 128), (8, 1024, 16, 128), True),
    ((8, 16, 16, 128), (8, 40, 16, 128), True),
    ((8, 17, 16, 128), (8, 1024, 16, 128), False),
    ((8, 1, 16, 256), (8, 1024, 16, 256), False),
    ((8, 1, 16, 128), (4, 1024, 16, 128), False),
    ((8, 1, 16, 128), (8, 0, 16, 128), False),
])
def test_supports_decode_contract(q_shape, k_shape, ok):
    """The port's own contract: any table length (ragged tails are
    masked), at most DECODE_MAX_Q query rows, head dim up to
    MAX_HEAD_DIM — not the TPU kernel's 128-aligned lengths."""
    assert DA.supports_decode(q_shape, k_shape) is ok


def test_wrapper_rejects_out_of_contract():
    q = torch.zeros((1, 17, 1, 4))
    k = torch.zeros((1, 8, 1, 4))
    mask = torch.ones((1, 17, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="decode-kernel contract"):
        DA.decode_attention(q, k, k, mask)
    with pytest.raises(ValueError, match="key_mask must be bool"):
        DA.decode_attention(q[:, :1], k, k, torch.ones((1, 1, 8)))
    with pytest.raises(ValueError, match="float32"):
        DA.decode_attention(q[:, :1].double(), k, k, mask[:, :1])


@pytest.fixture
def cuda_card():
    """Skips unless torch sees a CUDA card (decided here, at run time,
    never while the module is collected)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sq,L", [(1, 1024), (16, 40), (16, 16)])
def test_kernel_matches_reference_on_card(cuda_card, sq, L):
    """The CUDA kernel against its plain version at the serving
    widths (B=8, H=16, D=128), ragged masks and a fully masked row:
    f32 on both sides, rtol = atol = 1e-5."""
    rng = numpy.random.RandomState(sq * 1000 + L)
    B, H, D = 8, 16, 128
    q = rng.standard_normal((B, sq, H, D)).astype(numpy.float32)
    k = rng.standard_normal((B, L, H, D)).astype(numpy.float32)
    v = rng.standard_normal((B, L, H, D)).astype(numpy.float32)
    lens = rng.randint(1, L + 1, B)
    mask = numpy.arange(L)[None, None, :] < lens[:, None, None]
    mask = numpy.repeat(mask, sq, axis=1)
    mask[0, sq - 1] = False
    args = [torch.from_numpy(a).to(cuda_card) for a in (q, k, v, mask)]
    before = DA.decode_attention.launches
    out = DA.decode_attention(*args)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 1
    torch.testing.assert_close(
        out, DA.decode_attention_reference(*args), rtol=1e-5, atol=1e-5)
    assert not out[0, sq - 1].any()


# -- a row is computed alone ------------------------------------------------
#
# A row's result may depend only on its q row, its mask row and the keys
# it attends, bit for bit: not on the rows launched beside it (a one-row
# decode step against the same row of a verify chunk), not on the batch
# (the engine pads batches to buckets) and not on keys past its mask
# (table widths round up to power-of-two buckets).  The plain version
# holds it by its elementwise products; the kernels by design.

PLANES = ("f32", "int8", "fp8")


def _plane_inputs(plane, B, sq, H, D, L, seed, device="cpu"):
    """q, k, v (codes for int8/fp8), a ragged key mask and, for the
    scaled planes, the (B, L, H) scales as ``decode_attention`` keyword
    arguments; made with numpy from ``seed``."""
    rng = numpy.random.RandomState(seed)
    q = rng.standard_normal((B, sq, H, D)).astype(numpy.float32)
    k = rng.standard_normal((B, L, H, D)).astype(numpy.float32)
    v = rng.standard_normal((B, L, H, D)).astype(numpy.float32)
    lens = rng.randint(1, L + 1, B)
    limit = numpy.maximum(
        lens[:, None] - (sq - 1 - numpy.arange(sq))[None, :], 1)
    mask = numpy.arange(L)[None, None, :] < limit[:, :, None]
    args = [torch.from_numpy(a).to(device) for a in (q, k, v, mask)]
    if plane == "f32":
        return args, {}
    qmax = 127.0 if plane == "int8" else 448.0
    scales = []
    for i in (1, 2):
        x = args[i]
        s = x.abs().amax(-1) / qmax
        c = (x / s[..., None]).clamp(-qmax, qmax)
        args[i] = torch.round(c).to(torch.int8) if plane == "int8" else \
            c.to(torch.float8_e4m3fn)
        scales.append(s.contiguous())
    return args, dict(k_scale=scales[0], v_scale=scales[1])


def _attend(args, kw, rows=slice(None), batch=slice(None), keys=None):
    """decode_attention on the given rows, batches and first ``keys``
    keys (all by default), every operand made contiguous."""
    q, k, v, mask = args
    keys = slice(None) if keys is None else slice(0, keys)
    pick = {n: t[batch][:, keys].contiguous() for n, t in kw.items()}
    return DA.decode_attention(
        q[batch][:, rows].contiguous(), k[batch][:, keys].contiguous(),
        v[batch][:, keys].contiguous(),
        mask[batch][:, rows][:, :, keys].contiguous(), **pick)


def _rows_alone_equal(args, kw, sq):
    """Every row of one ``sq``-row call equals the row called alone."""
    wide = _attend(args, kw)
    for r in range(sq):
        torch.testing.assert_close(_attend(args, kw, rows=slice(r, r + 1)),
                                   wide[:, r:r + 1], rtol=0, atol=0)


def _masked_keys_add_nothing(args, kw, L):
    """Rows over the first ``L`` keys equal the rows over all of them
    with the keys past ``L`` masked."""
    args[3][:, :, L:] = False
    torch.testing.assert_close(_attend(args, kw, keys=L), _attend(args, kw),
                               rtol=0, atol=0)


def _batches_alone_equal(args, kw):
    """Each batch called alone equals its rows of the whole call."""
    wide = _attend(args, kw)
    for b in range(args[0].shape[0]):
        torch.testing.assert_close(_attend(args, kw, batch=slice(b, b + 1)),
                                   wide[b:b + 1], rtol=0, atol=0)


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("sq", [5, 16])
def test_reference_rows_do_not_depend_on_sq(plane, sq):
    args, kw = _plane_inputs(plane, 3, sq, 2, 16, 64, seed=70 + sq)
    _rows_alone_equal(args, kw, sq)


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("wide", [128, 256, 512])
def test_reference_rows_do_not_depend_on_masked_keys(plane, wide):
    args, kw = _plane_inputs(plane, 3, 16, 2, 16, wide, seed=wide)
    _masked_keys_add_nothing(args, kw, 64 if wide < 512 else 256)


@pytest.mark.parametrize("plane", PLANES)
def test_reference_rows_do_not_depend_on_the_batch(plane):
    args, kw = _plane_inputs(plane, 8, 16, 2, 16, 64, seed=81)
    _batches_alone_equal(args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", PLANES)
def test_kernel_rows_do_not_depend_on_sq_l_or_b(cuda_card, plane):
    """The kernels at the serving widths (B=8, H=16, D=128): each row of
    a 16-row launch equals the row launched alone, rows over 256, 512
    or 1000 keys equal the rows over twice as many with the rest masked
    (256 against 512 crosses from one split to two), and
    each batch launched alone equals its rows of the B=8 launch — bit
    for bit."""
    args, kw = _plane_inputs(plane, 8, 16, 16, 128, 1024, seed=90,
                             device=cuda_card)
    _rows_alone_equal(args, kw, 16)
    _batches_alone_equal(args, kw)
    for L in (256, 512, 1000):
        args, kw = _plane_inputs(plane, 8, 16, 16, 128, 2 * L, seed=L,
                                 device=cuda_card)
        _masked_keys_add_nothing(args, kw, L)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("D,L", [(70, 40), (70, 1000), (72, 40),
                                 (72, 1000), (128, 40), (128, 1000)])
def test_kernel_narrow_heads_and_ragged_widths(cuda_card, plane, D, L):
    """Head dims under 128 and ragged table widths, one and 16 rows,
    against the plain version (rtol = atol = 1e-5): a row not a
    multiple of 16 bytes takes the scalar copy path — f32 at D = 70
    (280 bytes; at D = 72, 288 bytes, it is the 16-byte path), codes at
    D = 70 and 72; B5 on the codes equals B4 on the dequantized table
    bit for bit."""
    for sq in (1, 16):
        args, kw = _plane_inputs(plane, 8, sq, 16, D, L, seed=D + L + sq,
                                 device=cuda_card)
        out = DA.decode_attention(*args, **kw)
        torch.testing.assert_close(
            out, DA.decode_attention_reference(*args, **kw), rtol=1e-5,
            atol=1e-5)
        if kw:
            q, k, v, mask = args
            b4 = DA.decode_attention(
                q, DA.dequantize(k, kw["k_scale"]),
                DA.dequantize(v, kw["v_scale"]), mask)
            torch.testing.assert_close(out, b4, rtol=0, atol=0)
