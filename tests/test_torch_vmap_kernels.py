"""The kernels' autograd Functions under ``torch.func`` transforms: the
LRN (``ops.lrn._LRN`` with its backward ``_LRNGrad``, B6/B7) and flash
attention (``ops.flash_attention._FlashLSE`` with ``_FlashGrad``,
B1–B3) are built in the ``setup_context`` form with ``vmap`` rules, so
that the population step can run ``vmap(grad(...))`` through them.

On the CPU each Function's forward runs the kernel's plain version,
which is what the tests hold: ``vmap(grad(loss))`` over P members equals
a loop of ``grad(loss)`` over the members (exactly: the fold computes
the same rows in the same order), and the rules fold the members into
ONE call of each wrapper on a (P·N, ...) batch — the wrappers are
wrapped to record the shapes they see.  A layout with no batch axis to
fold into raises.  On the card (``cuda``-marked, skipped here) the same
comparison runs through the kernels, with one launch of B6 and B7 (B1,
B2, B3) per vmapped call."""

import numpy
import pytest
import torch
from torch.func import grad, vmap

from veles_tpu_torch.ops import flash_attention as FA
from veles_tpu_torch.ops import lrn as L

#: AlexNet's constants, and constants where the window dominates.
LRN_CONSTANTS = {"alexnet": (5, 1e-4, 0.75, 2.0),
                 "strong": (4, 4.0, 0.75, 1.0)}


def _lrn_loss(w, x, consts):
    return (L._LRN.apply(x * w, *consts) ** 2).sum()


def _flash_loss(wq, wk, q, k, v, causal):
    out, lse = FA.flash_chunk(q * wq, k * wk, v, causal=causal,
                              operand_dtype=torch.float32)
    return (out.float() ** 2).sum() + (lse * 0.5).sum()


def _inputs(seed, *shapes):
    rng = numpy.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(numpy.float32))
            for s in shapes]


@pytest.fixture(autouse=True)
def _two_threads():
    """At most two intra-op threads during a test, put back after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def recorded(monkeypatch):
    """Wraps the LRN and flash wrappers to record the first dimension
    of the tensor each call gets."""
    seen = {}

    def wrap(module, name):
        real = getattr(module, name)

        def rec(*args, **kwargs):
            seen.setdefault(name, []).append(tuple(args[0].shape))
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, rec)

    for name in ("lrn_forward", "lrn_backward"):
        wrap(L, name)
    for name in ("flash_forward", "flash_dq", "flash_dkv"):
        wrap(FA, name)
    return seen


@pytest.mark.parametrize("consts", sorted(LRN_CONSTANTS))
def test_lrn_vmap_grad_equals_member_loop(recorded, consts):
    """vmap(grad) of a loss through ``_LRN`` over P = 3 members equals
    the member loop exactly (float32), and each wrapper ran once for the
    vmapped call, on the members folded into the batch (3·2 rows)."""
    c = LRN_CONSTANTS[consts]
    w, x = _inputs(1, (3, 16), (2, 5, 7, 16))
    got = vmap(grad(_lrn_loss), in_dims=(0, None, None))(w, x, c)
    assert recorded["lrn_forward"] == [(6, 5, 7, 16)]
    assert recorded["lrn_backward"] == [(6, 5, 7, 16)]
    want = torch.stack([grad(_lrn_loss)(w[i], x, c) for i in range(3)])
    assert torch.equal(got, want)
    # The loop itself matches autograd through the banded reference.
    leaf = w[1].clone().requires_grad_(True)
    (L.lrn_reference(x * leaf, *c) ** 2).sum().backward()
    numpy.testing.assert_allclose(want[1].numpy(), leaf.grad.numpy(),
                                  rtol=1e-5, atol=1e-6)


def test_lrn_vmap_of_batched_cotangents_and_mapped_inner_axis(recorded):
    """The member axis mapped at another axis than the first (in_dims
    2) and an input that is mapped while the weights are not: still one
    call per wrapper, results equal the member loop."""
    c = LRN_CONSTANTS["strong"]
    w, x = _inputs(2, (16,), (2, 5, 3, 16))

    def loss(x, w):
        return _lrn_loss(w, x, c)
    got = vmap(grad(loss), in_dims=(2, None))(x, w)
    assert recorded["lrn_forward"] == [(6, 5, 16)]
    assert recorded["lrn_backward"] == [(6, 5, 16)]
    want = torch.stack([grad(loss)(x[:, :, i], w) for i in range(3)])
    assert torch.equal(got.movedim(0, 2), want.movedim(0, 2))


def test_lrn_vmap_rule_refuses_a_layout_without_a_batch_axis():
    """A member tensor of one axis (channels only) has no batch axis to
    fold the members into: the rule raises, never falls back."""
    w, = _inputs(3, (3, 16))
    with pytest.raises(ValueError, match="cannot fold"):
        vmap(lambda v: L._LRN.apply(v, 5, 1e-4, 0.75, 2.0))(w)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_vmap_grad_equals_member_loop(recorded, causal):
    """vmap(grad) through ``_FlashLSE`` (out and lse both in the loss, so
    the lse cotangent reaches the backward) over P = 3 members equals the
    member loop exactly; B1, B2 and B3's wrappers each ran once, on the
    members folded into the batch (3·2)."""
    wq, wk, q, k, v = _inputs(4, (3, 8), (3, 8), (2, 6, 2, 8),
                              (2, 6, 2, 8), (2, 6, 2, 8))
    g = vmap(grad(_flash_loss, argnums=(0, 1)),
             in_dims=(0, 0, None, None, None, None))
    got_q, got_k = g(wq, wk, q, k, v, causal)
    for name in ("flash_forward", "flash_dq", "flash_dkv"):
        assert recorded[name] == [(6, 6, 2, 8)], name
    want = [grad(_flash_loss, argnums=(0, 1))(wq[i], wk[i], q, k, v,
                                              causal) for i in range(3)]
    assert torch.equal(got_q, torch.stack([w[0] for w in want]))
    assert torch.equal(got_k, torch.stack([w[1] for w in want]))


def test_flash_vmap_rule_refuses_a_layout_without_a_batch_axis():
    q, = _inputs(5, (3, 8))
    with pytest.raises(ValueError, match="cannot fold"):
        vmap(lambda t: FA._FlashLSE.apply(t, t, t, False, 0, 0, None,
                                          torch.float32))(q)


def test_sequential_autograd_is_unchanged():
    """Outside the transforms the Functions run as before: autograd
    through ``_LRN`` equals autograd through the banded reference on the
    CPU bit for bit, and ``flash_chunk``'s gradients equal the explicit
    dq/dkv reference formulas."""
    c = LRN_CONSTANTS["alexnet"]
    x, dy = _inputs(6, (2, 5, 7, 16), (2, 5, 7, 16))
    a = x.clone().requires_grad_(True)
    L._LRN.apply(a, *c).backward(dy)
    assert torch.equal(a.grad, L.lrn_backward_reference(x, dy, *c))
    q, k, v, do = _inputs(7, *[(2, 6, 2, 8)] * 4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = FA.flash_chunk(*leaves, causal=True,
                              operand_dtype=torch.float32)
    out.backward(do)
    delta = (do * out.detach()).sum(-1)
    dq = FA.flash_attention_dq_reference(q, k, v, do, lse.detach(), delta,
                                         causal=True)
    dk, dv = FA.flash_attention_dkv_reference(q, k, v, do, lse.detach(),
                                              delta, causal=True)
    for got, want in zip([t.grad for t in leaves], (dq, dk, dv)):
        assert torch.equal(got, want)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there "
                    "(chip_smoke.py's phase_population runs them under "
                    "vmap on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lrn_kernels_under_vmap_on_the_card(cuda_card, dtype):
    """On the card vmap(grad) through ``_LRN`` launches B6 once and B7
    once for P = 4 members, on the register route, and equals the member
    loop within float32 reduction noise (the fold computes the same
    rows; the sums over members' batches may run in another order)."""
    c = LRN_CONSTANTS["alexnet"]
    w, x = [t.to(cuda_card) for t in _inputs(8, (4, 96), (3, 9, 5, 96))]
    x = x.to(dtype)

    def loss(w, x):
        return (L._LRN.apply((x * w).to(dtype), *c).float() ** 2).sum()
    L.reset_launches()
    got = vmap(grad(loss), in_dims=(0, None))(w, x)
    assert L.lrn_forward.launches_by_route == {"register": 1, "wide": 0}
    assert L.lrn_backward.launches_by_route == {"register": 1, "wide": 0}
    want = torch.stack([grad(loss)(w[i], x) for i in range(4)])
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_flash_kernels_under_vmap_on_the_card(cuda_card):
    """On the card vmap(grad) through ``_FlashLSE`` launches B1, B2 and
    B3 once each for P = 2 members on the tensor cores (bf16 storage),
    and equals the member loop within float32 reduction noise."""
    wq, wk, q, k, v = [t.to(cuda_card) for t in _inputs(
        9, (2, 64), (2, 64), (2, 128, 4, 64), (2, 128, 4, 64),
        (2, 128, 4, 64))]

    def loss(wq, wk, q, k, v):
        out, lse = FA.flash_chunk((q * wq).bfloat16(), (k * wk).bfloat16(),
                                  v.bfloat16(), causal=True)
        return (out.float() ** 2).sum() + lse.sum()
    FA.reset_launches()
    g = vmap(grad(loss, argnums=(0, 1)), in_dims=(0, 0, None, None, None))
    got = g(wq, wk, q, k, v)
    for wrapper in (FA.flash_forward, FA.flash_dq, FA.flash_dkv):
        assert wrapper.route_launches == {"tensor_core": 1, "fp32": 0}
    want = [grad(loss, argnums=(0, 1))(wq[i], wk[i], q, k, v)
            for i in range(2)]
    for i in range(2):
        ref = torch.stack([w[i] for w in want])
        torch.testing.assert_close(got[i], ref, rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()))
