"""The port's flash attention (``veles_tpu_torch.ops.flash_attention``)
and attention ops (``veles_tpu_torch.ops.attention``) against the JAX
package.

The same numpy inputs go through ``veles_tpu.ops.pallas_attention.
flash_chunk`` (interpret mode — how the JAX package's own tests run the
Pallas kernels on the CPU) and through the port's plain versions and
its ``flash_chunk`` (whose autograd Function runs the dq and dk/dv
wrappers, which take the plain versions on CPU tensors): out, lse and,
through ``jax.vjp`` / ``torch.autograd.grad`` with a non-zero lse
cotangent, dq, dk and dv.

Tolerances: float32 operands, rtol = atol = 1e-5 — both sides compute
the same float32 math and only the order of the sums differs (the
observed gap is ~1e-6).  bfloat16 operands: rtol = atol = 2e-2 — the
probabilities and score gradients are rounded to bfloat16 before
their products on both sides, and a sum-order difference can flip
that rounding by one bfloat16 ulp (2^-8 relative).

The CUDA kernels run only on the card: their tests carry the ``cuda``
marker and skip here.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops import attention as JA
from veles_tpu.ops import pallas_attention as PA
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import attention as TA
from veles_tpu_torch.ops import flash_attention as FA

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

#: (B, Sq, Sk, H, D, flash_chunk kwargs): causal and not, offsets,
#: a kv_len bound, rows that see no key at all, ragged lengths.
CASES = {
    "causal": (2, 8, 8, 2, 4, dict(causal=True)),
    "noncausal_kvlen": (2, 8, 16, 2, 4, dict(kv_len=5)),
    "causal_qoffset": (1, 8, 16, 2, 4,
                       dict(causal=True, q_offset=8, k_offset=0)),
    "masked_rows": (2, 8, 8, 3, 4,
                    dict(causal=True, q_offset=0, k_offset=4)),
    "causal_kvlen_ragged": (2, 12, 7, 2, 8,
                            dict(causal=True, kv_len=6)),
}


def _inputs(B, Sq, Sk, H, D, seed):
    rng = numpy.random.RandomState(seed)
    shapes = [(B, Sq, H, D), (B, Sk, H, D), (B, Sk, H, D),
              (B, Sq, H, D), (B, Sq, H)]
    return [rng.standard_normal(s).astype(numpy.float32)
            for s in shapes]


def _jax_chunk(q, k, v, do, dlse, od, kw):
    def f(q_, k_, v_):
        return PA.flash_chunk(q_, k_, v_, interpret=True,
                              operand_dtype=od, **kw)
    (out, lse), vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    return [numpy.asarray(a, dtype=numpy.float32)
            for a in (out, lse) + tuple(grads)]


def _torch_chunk(fn, q, k, v, do, dlse, od, kw):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = fn(tq, tk, tv, operand_dtype=od, **kw)
    grads = torch.autograd.grad(
        (out, lse), (tq, tk, tv), (torch.tensor(do), torch.tensor(dlse)))
    return [t.detach().float().numpy() for t in (out, lse) + grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_match_flash_chunk(case):
    """flash_attention_reference (autograd) and the port's flash_chunk
    (explicit dq/dk/dv formulas) both equal the Pallas kernels in
    interpret mode: out, lse, dq, dk, dv, float32 operands."""
    B, Sq, Sk, H, D, kw = CASES[case]
    assert PA.supports_ring((B, Sq, H, D), (B, Sk, H, D),
                            interpret=True)
    assert FA.supports((B, Sq, H, D), (B, Sk, H, D), kw.get("kv_len"))
    q, k, v, do, dlse = _inputs(B, Sq, Sk, H, D, seed=len(case))
    want = _jax_chunk(q, k, v, do, dlse, jnp.float32, kw)
    for fn in (FA.flash_attention_reference, FA.flash_chunk):
        got = _torch_chunk(fn, q, k, v, do, dlse, torch.float32, kw)
        for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got,
                              want):
            numpy.testing.assert_allclose(
                a, b, err_msg="%s %s %s" % (case, fn.__name__, name),
                **F32_TOL)


def test_fully_masked_rows_keep_finite_lse():
    """A row that sees no key: out 0, lse ≈ -1e30 (finite), zero
    gradients — in both packages."""
    B, Sq, Sk, H, D, kw = CASES["masked_rows"]
    q, k, v, do, dlse = _inputs(B, Sq, Sk, H, D, seed=3)
    got = _torch_chunk(FA.flash_chunk, q, k, v, do, dlse,
                       torch.float32, kw)
    out, lse, dq = got[0], got[1], got[2]
    hidden = slice(0, kw["k_offset"])  # rows before the first key
    assert numpy.all(out[:, hidden] == 0.0)
    assert numpy.all(numpy.isfinite(lse)) and \
        numpy.all(lse[:, hidden] < -1e29)
    assert numpy.all(dq[:, hidden] == 0.0)


@pytest.mark.parametrize("case", ["causal", "noncausal_kvlen"])
def test_bf16_operands_match_flash_chunk(case):
    """bfloat16 matmul operands (the TPU kernel's default contract)."""
    B, Sq, Sk, H, D, kw = CASES[case]
    q, k, v, do, dlse = _inputs(B, Sq, Sk, H, D, seed=11)
    want = _jax_chunk(q, k, v, do, dlse, jnp.bfloat16, kw)
    got = _torch_chunk(FA.flash_chunk, q, k, v, do, dlse,
                       torch.bfloat16, kw)
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        numpy.testing.assert_allclose(a, b, err_msg=name, **BF16_TOL)


def test_merge_partials_and_resume_match_jax():
    """merge_partials equals the JAX package's, including a void
    partial (lse -1e30, weight 0); flash_resume over two key chunks
    equals one chunk over all keys."""
    rng = numpy.random.RandomState(5)
    o1, o2 = (rng.standard_normal((2, 4, 2, 4)).astype(numpy.float32)
              for _ in range(2))
    l1 = rng.standard_normal((2, 4, 2)).astype(numpy.float32)
    l2 = rng.standard_normal((2, 4, 2)).astype(numpy.float32)
    l2[0, 0, 0] = -1e30
    jo, jl = PA.merge_partials(*map(jnp.asarray, (o1, l1, o2, l2)))
    to, tl = FA.merge_partials(*map(torch.tensor, (o1, l1, o2, l2)))
    numpy.testing.assert_allclose(to.numpy(), numpy.asarray(jo),
                                  **F32_TOL)
    numpy.testing.assert_allclose(tl.numpy(), numpy.asarray(jl),
                                  **F32_TOL)
    q, k, v, _, _ = _inputs(1, 8, 16, 2, 4, seed=9)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    kw = dict(causal=True, q_offset=8, operand_dtype=torch.float32)
    carry = FA.flash_resume(None, tq, tk[:, :8], tv[:, :8], **kw)
    carry = FA.flash_resume(carry, tq, tk[:, 8:], tv[:, 8:],
                            k_offset=8, **kw)
    whole = FA.flash_chunk(tq, tk, tv, **kw)
    numpy.testing.assert_allclose(carry[0].numpy(), whole[0].numpy(),
                                  **F32_TOL)
    numpy.testing.assert_allclose(carry[1].numpy(), whole[1].numpy(),
                                  **F32_TOL)


@pytest.fixture
def attention_knobs():
    """Restores the port's attention knobs after a test."""
    engine = root.common.engine
    saved = {k: engine.get(k) for k in ("attention_kernel",
                                        "attention_dtype")}
    yield engine
    for key, value in saved.items():
        if value is None:
            engine.__dict__.pop(key, None)
        else:
            setattr(engine, key, value)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 24),
                                           (True, 20)])
def test_attention_ops_match_jax(attention_knobs, precision, causal,
                                 kv_len):
    """The port's attention and blockwise_attention (the plain path
    every CPU tensor takes, whatever the kernel mode) equal the JAX
    package's jnp formulations: causal masking, the kv_len padding
    bound, f32 and bf16 intermediates.  bf16 intermediates round the
    scores, probabilities and accumulator on both sides; a sum-order
    difference can move one rounding by an ulp, hence BF16_TOL."""
    attention_knobs.attention_kernel = "auto"
    rng = numpy.random.RandomState(21)
    q, k, v = (rng.standard_normal((2, 32, 2, 8)).astype(numpy.float32)
               for _ in range(3))
    tol = F32_TOL if precision == "f32" else BF16_TOL
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    launches = FA.flash_forward.launches
    want = JA.blockwise_attention(jq, jk, jv, block_size=8,
                                  causal=causal, kv_len=kv_len,
                                  precision=precision, kernel="xla")
    got = TA.blockwise_attention(tq, tk, tv, block_size=8, causal=causal,
                                 kv_len=kv_len, precision=precision)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  **tol)
    if kv_len is None:
        want = JA.attention(jq, jk, jv, causal=causal,
                            precision=precision, kernel="xla")
        got = TA.attention(tq, tk, tv, causal=causal,
                           precision=precision)
        numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                      **tol)
    assert FA.flash_forward.launches == launches


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Unsupported dtypes, head dims and operand types raise before any
    device branch; sequence-parallel attention is refused."""
    q = torch.zeros((1, 4, 1, 8), dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FA.flash_forward(q, q, q)
    wide = torch.zeros((1, 4, 1, 2 * FA.MAX_HEAD_DIM))
    with pytest.raises(ValueError, match="contract"):
        FA.flash_forward(wide, wide, wide)
    x = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="operand dtype"):
        FA.flash_forward(x, x, x, operand_dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="A6"):
        TA.ring_attention(x, x, x, "seq")


class _CardTensor(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what the dispatch sees of
    a tensor on the card, without one."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_dispatch_on_the_card_never_takes_the_plain_path(
        attention_knobs, monkeypatch, mode):
    """Under "auto"/"pallas" a CUDA tensor goes to the kernel wrapper or
    raises: a head dim outside the contract raises ValueError, and a
    supported one reaches the forward kernel's wrapper (stubbed here to
    raise) instead of the plain formulation."""
    attention_knobs.attention_kernel = mode
    wide = torch.zeros((1, 8, 1, 2 * FA.MAX_HEAD_DIM)).as_subclass(
        _CardTensor)
    for fn in (TA.attention, TA.blockwise_attention):
        with pytest.raises(ValueError, match="contract"):
            fn(wide, wide, wide, causal=True)
    reached = []

    def forward(q, *args):
        reached.append(q.device.type)
        raise RuntimeError("stub kernel")

    monkeypatch.setattr(FA, "flash_forward", forward)
    x = torch.zeros((1, 8, 1, 8)).as_subclass(_CardTensor)
    for fn in (TA.attention, TA.blockwise_attention):
        with pytest.raises(RuntimeError, match="stub kernel"):
            fn(x, x, x, causal=True)
    assert reached == ["cuda", "cuda"]
    cpu = torch.zeros((1, 8, 1, 8))
    assert TA.attention(cpu, cpu, cpu, causal=True).shape == cpu.shape
    assert reached == ["cuda", "cuda"]


#: (storage, operand dtype) -> the C entry points of the forward, dq
#: and dk/dv launches: the tensor cores for every pair whose q, k, v and
#: dO are bf16-exact, the FP32 units for f32/f32.
ENTRY_POINTS = {
    (torch.float32, torch.float32): (
        "veles_flash_fwd", "veles_flash_dq", "veles_flash_dkv"),
    (torch.bfloat16, torch.float32): (
        "veles_flash_fwd_tc", "veles_flash_dq_tc", "veles_flash_dkv_tc"),
    (torch.bfloat16, torch.bfloat16): (
        "veles_flash_fwd_tc", "veles_flash_dq_tc", "veles_flash_dkv_tc"),
    (torch.float32, torch.bfloat16): (
        "veles_flash_fwd_tc", "veles_flash_dq_tc", "veles_flash_dkv_tc"),
}


@pytest.mark.parametrize("storage,od", sorted(ENTRY_POINTS, key=str))
def test_each_dtype_pair_reaches_its_kernel(monkeypatch, storage, od):
    """On CUDA tensors each storage/operand pair reaches its C entry
    point (``_launch`` stubbed to record it) and counts the launch on
    its route; none reaches a plain version."""
    reached = []

    def launch(fn, name, *args):
        reached.append(fn)

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(FA, "_launch", launch)
    for name in ("flash_attention_reference", "flash_attention_dq_reference",
                 "flash_attention_dkv_reference"):
        monkeypatch.setattr(FA, name, plain)
    x = torch.zeros((1, 8, 2, 16), dtype=storage).as_subclass(_CardTensor)
    rows = torch.zeros((1, 8, 2)).as_subclass(_CardTensor)
    before = {w: dict(getattr(FA, w).route_launches)
              for w in ("flash_forward", "flash_dq", "flash_dkv")}
    FA.flash_forward(x, x, x, causal=True, operand_dtype=od)
    FA.flash_dq(x, x, x, x, rows, rows, causal=True, operand_dtype=od)
    FA.flash_dkv(x, x, x, x, rows, rows, causal=True, operand_dtype=od)
    assert tuple(reached) == ENTRY_POINTS[(storage, od)]
    for wrapper, fn in zip(("flash_forward", "flash_dq", "flash_dkv"),
                           reached):
        way = "tensor_core" if fn.endswith("_tc") else "fp32"
        assert FA.route(wrapper, storage, od) == way
        counts = getattr(FA, wrapper).route_launches
        assert counts[way] == before[wrapper][way] + 1
        assert sum(counts.values()) == sum(before[wrapper].values()) + 1


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels run only "
                    "there (chip_smoke.py checks them on the H100)")
    return torch.device("cuda")


#: Kernel against plain version on the card.  The lse is float32 in
#: every pair and only its sum order differs: F32_TOL.  float32
#: storage and operands: F32_TOL for every output.  Otherwise the
#: outputs' last rounding (bfloat16 storage) or the rounding of p and
#: ds (bfloat16 operands) can flip by one bfloat16 ulp, at most 2^-7 of
#: the value: rtol 2^-7, and an atol of 1e-2 of the output's RMS for
#: values near zero.  With bfloat16 operands the forward rounds each p
#: at its key tile's running maximum and the plain version at the
#: row's, each by at most 2^-8 of itself: out differs by at most
#: 2^-7·(Σ p·|v|) / l, the plain forward of |v| — its atol.
CARD_RTOL, CARD_ATOL_RMS = 2.0 ** -7, 1e-2


def _split_inputs(kind, B=2, S=256, H=2, D=64, seed=5):
    """Inputs on which a product with an f32 operand nearly cancels
    (non-causal): "split_v" — tiny scores, v and dO of magnitude 1
    alternating in sign over keys and rows (out and dv cancel);
    "split_q" — q alternating in sign over rows, v = dO = 1, an lse
    cotangent of 1 (ds = p·scale, and dk = Σ ds·q cancels); "split_k" —
    the same with k alternating in sign over keys and tiny q (dq = Σ
    ds·k cancels).  Rounding p or ds to one bf16 term shows there far
    above the bf16 tolerance."""
    rng = numpy.random.RandomState(seed)
    sign = numpy.where(numpy.arange(S) % 2, -1.0, 1.0)[None, :, None,
                                                        None]
    sign = numpy.broadcast_to(sign, (B, S, H, D)).astype(numpy.float32)
    k = rng.standard_normal((B, S, H, D)).astype(numpy.float32)
    if kind == "split_v":
        q = 0.01 * rng.standard_normal((B, S, H, D)).astype(numpy.float32)
        v = do = sign
        dlse = rng.standard_normal((B, S, H)).astype(numpy.float32)
        return [numpy.ascontiguousarray(a) for a in (q, k, v, do, dlse)]
    if kind == "split_q":
        q = sign * 0.001 * rng.standard_normal((B, 1, H, D)).astype(
            numpy.float32)
    else:
        q = 0.001 * rng.standard_normal((B, S, H, D)).astype(numpy.float32)
        k = sign * k[:, :1]
    v = do = numpy.ones((B, S, H, D), numpy.float32)
    dlse = numpy.ones((B, S, H), numpy.float32)
    return [numpy.ascontiguousarray(a) for a in (q, k, v, do, dlse)]


#: Split-sensitive cases: the outputs a one-term rounding of p or ds
#: moves out of the bf16/f32 tolerance.
SPLIT_FAULTED = {"split_v": ("out", "dv"), "split_q": ("dk",),
                 "split_k": ("dq",)}


def test_plain_versions_match_flash_chunk_on_split_k_inputs():
    """On the dq-sensitive inputs ("split_k", small: B=1, S=32, H=2,
    D=16), where dq = Σ ds·k nearly cancels, the port's plain versions
    (autograd through the forward, and flash_chunk's explicit dq/dk/dv
    formulas) equal the Pallas kernels in interpret mode — float32
    operands, F32_TOL — and dq stays far above the atol, so the check
    is not met by the atol alone."""
    q, k, v, do, dlse = _split_inputs("split_k", B=1, S=32, H=2, D=16,
                                      seed=7)
    want = _jax_chunk(q, k, v, do, dlse, jnp.float32, {})
    for fn in (FA.flash_attention_reference, FA.flash_chunk):
        got = _torch_chunk(fn, q, k, v, do, dlse, torch.float32, {})
        for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got,
                              want):
            numpy.testing.assert_allclose(
                a, b, err_msg="%s %s" % (fn.__name__, name), **F32_TOL)
    assert numpy.abs(want[2]).max() > 100 * F32_TOL["atol"]


@pytest.mark.cuda
@pytest.mark.parametrize("storage,od", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("case", sorted(CASES) + [
    "ragged_1000", "d72"] + sorted(SPLIT_FAULTED))
def test_kernels_match_plain_versions_on_card(cuda_card, storage, od,
                                              case):
    """B1/B2/B3 against their plain versions on the card, with a
    non-zero lse cotangent; on the split-sensitive cases with bf16
    storage and f32 operands, the plain versions with bf16 operands (a
    kernel that rounds p and ds to one bf16 term) must fail the same
    check."""
    if case == "ragged_1000":
        B, Sq, Sk, H, D, kw = 1, 1000, 1000, 2, 128, dict(causal=True)
    elif case == "d72":
        B, Sq, Sk, H, D, kw = 2, 200, 200, 3, 72, dict(causal=True)
    elif case in SPLIT_FAULTED:
        kw = {}
    else:
        B, Sq, Sk, H, D, kw = CASES[case]
    arrays = _split_inputs(case) if case in SPLIT_FAULTED else \
        _inputs(B, Sq, Sk, H, D, seed=4)
    q, k, v, do = (torch.tensor(a, device=cuda_card).to(storage)
                   for a in arrays[:4])
    dlse = torch.tensor(arrays[4], device=cuda_card)
    launches = (FA.flash_forward.launches, FA.flash_dq.launches,
                FA.flash_dkv.launches)
    out, lse = FA.flash_forward(q, k, v, operand_dtype=od, **kw)
    delta = (do.float() * out.float()).sum(-1) - dlse
    dq = FA.flash_dq(q, k, v, do, lse, delta, operand_dtype=od, **kw)
    dk, dv = FA.flash_dkv(q, k, v, do, lse, delta, operand_dtype=od,
                          **kw)
    torch.cuda.synchronize()
    assert (FA.flash_forward.launches, FA.flash_dq.launches,
            FA.flash_dkv.launches) == tuple(n + 1 for n in launches)
    ro, rl = FA.flash_attention_reference(q, k, v, operand_dtype=od, **kw)
    rdq = FA.flash_attention_dq_reference(q, k, v, do, lse, delta,
                                          operand_dtype=od, **kw)
    rdk, rdv = FA.flash_attention_dkv_reference(
        q, k, v, do, lse, delta, operand_dtype=od, **kw)
    exact = storage == od == torch.float32
    faults = {}
    if case in SPLIT_FAULTED and (storage, od) == (torch.bfloat16,
                                                   torch.float32):
        bf16 = torch.bfloat16
        faults["out"] = FA.flash_attention_reference(
            q, k, v, operand_dtype=bf16, **kw)[0]
        faults["dq"] = FA.flash_attention_dq_reference(
            q, k, v, do, lse, delta, operand_dtype=bf16, **kw)
        faults["dk"], faults["dv"] = FA.flash_attention_dkv_reference(
            q, k, v, do, lse, delta, operand_dtype=bf16, **kw)
    for name, a, b in (("out", out, ro), ("lse", lse, rl), ("dq", dq, rdq),
                       ("dk", dk, rdk), ("dv", dv, rdv)):
        a, b = a.float(), b.float()
        if exact or name == "lse":
            rtol, atol = F32_TOL["rtol"], F32_TOL["atol"]
        elif name == "out" and od == torch.bfloat16:
            abs_v_out = FA.flash_attention_reference(
                q, k, v.abs(), operand_dtype=od, **kw)[0].float()
            rtol, atol = F32_TOL["rtol"], \
                2.0 ** -7 * abs_v_out + F32_TOL["atol"]
        else:
            rtol = CARD_RTOL
            atol = CARD_ATOL_RMS * b.square().mean().sqrt().item()
        assert ((a - b).abs() <= atol + rtol * b.abs()).all(), (
            name, (a - b).abs().max().item())
        if name in faults and name in SPLIT_FAULTED[case]:
            fault = faults[name].float()
            assert not ((fault - b).abs() <= atol + rtol * b.abs()).all(), (
                "one bf16 term passes the check", name)
