"""The port's LRN (``veles_tpu_torch.ops.lrn``) against the JAX
package's (``veles_tpu.ops.pallas_lrn``) on the CPU.

At AlexNet's constants (k = 2, α = 1e-4, n = 5) the window term is
~1e-4 of the denominator, so a wrong window, a missing second backward
term or a swapped transpose passes any check there: every comparison
here also runs at constants where the window dominates (k = 1, α = n,
β = 0.75, n ∈ {3, 4, 5}, 4 being the asymmetric even window).

The kernels take one of two routes (``lrn_route``: "register" while the
window's halo fits one 16-byte vector a side on 16-byte aligned data,
"wide" otherwise): the route choice and the wrappers' route plumbing
are tested here on the CPU, and the register route's bit-equality with
the wide route on the card (``cuda``-marked).

Tolerances, by comparison:

* port plain vs ``lrn_reference`` (the formulation the JAX AlexNet tick
  runs): float32 forward rtol 1e-5 / atol 1e-6 (the window sums run in
  another order: ~1 ulp observed); float32 dx within 1e-5 of the sum of
  the magnitudes of every term of dx (``lrn_backward_formula``'s scale;
  dx is a difference that may cancel); bfloat16 one bfloat16 ulp of the
  output forward (rtol 2^-7) and 2^-7 of (scale + |dx|) backward — the
  same autograd structure rounds at the same places (observed: exact);
* port plain vs ``lrn_pallas(interpret=True)``: rtol 2^-6 forward and
  2^-6 of (scale + |dx|) backward, in both dtypes.  The TPU kernel
  rounds float32 x to bfloat16 before the square and t to bfloat16 in
  the backward (MXU operand roundings the port does not copy): a 2^-7
  relative error in the squares, plus the square's own rounding, moves
  y by at most β·(2^-7 + 2^-8) < 2^-6 of itself;
* the backward kernel's float32 formula (``lrn_backward_formula``,
  what ``csrc/lrn.cu`` computes) vs autograd through the plain
  version: float32 1e-5 of the scale; bfloat16 (the formula rounded
  once, as the kernel rounds) 2^-7 of (scale + |dx|) — autograd rounds
  the first term, the square's gradient and x times it to bfloat16
  (2^-8 each) before their sum rounds once more.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops import pallas_lrn as PL

from veles_tpu_torch.config import root as troot
from veles_tpu_torch.ops import lrn as L
from veles_tpu_torch.ops import nvcc

torch.set_num_threads(2)

ALEXNET = (5, 1e-4, 0.75, 2.0)
CONSTANTS = {"alexnet": ALEXNET, "strong_n3": (3, 3.0, 0.75, 1.0),
             "strong_n4": (4, 4.0, 0.75, 1.0),
             "strong_n5": (5, 5.0, 0.75, 1.0)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(c, seed):
    rng = numpy.random.RandomState(seed)
    x = rng.randn(2, 4, 5, c).astype(numpy.float32)
    dy = rng.randn(2, 4, 5, c).astype(numpy.float32)
    return x, dy


def _pair(x, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return numpy.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_within(got, want, tol, what):
    share = (numpy.abs(got - want) / tol).max()
    assert share <= 1.0, "%s: %.3g of the tolerance" % (what, share)


def test_band_matrix_matches_jax_and_even_window_is_asymmetric():
    for c, n in ((7, 3), (7, 4), (9, 5), (6, 6), (1, 5)):
        numpy.testing.assert_array_equal(
            L.band_matrix(c, n).numpy(), numpy.asarray(PL.band_matrix(c, n)))
    # Channel 2's window for n = 4: inputs 0..3 (n//2 below, n-1-n//2
    # above), as tests/test_pallas_lrn.py pins for the JAX package.
    numpy.testing.assert_array_equal(L.band_matrix(6, 4)[:, 2].numpy(),
                                     [1, 1, 1, 1, 0, 0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", [7, 24, 96, 264])
@pytest.mark.parametrize("consts", sorted(CONSTANTS))
def test_plain_matches_jax(consts, c, dtype):
    """Forward and gradient of the plain version against the JAX
    package's ``lrn_reference`` (jax.vjp vs torch.autograd) and against
    the Pallas kernel in interpret mode, at channel counts the card's
    route gate runs (rows that end inside a warp's tile, on its edge and
    inside a 16-byte bfloat16 vector)."""
    n, alpha, beta, k = CONSTANTS[consts]
    x, dy = _inputs(c, seed=c + n)
    xt, xj = _pair(x, dtype)
    dyt, dyj = _pair(dy, dtype)
    y = _f32(L.lrn_reference(xt, n, alpha, beta, k))
    dx = _f32(L.lrn_backward_reference(xt, dyt, n, alpha, beta, k))
    _, scale = L.lrn_backward_formula(xt, dyt, n, alpha, beta, k)
    scale = scale.numpy()
    ref_y, vjp = jax.vjp(lambda v: PL.lrn_reference(v, n, alpha, beta, k),
                         xj)
    ref_dx = _f32(vjp(dyj)[0])
    pal_y, pvjp = jax.vjp(
        lambda v: PL.lrn_pallas(v, n, alpha, beta, k, True), xj)
    pal_dx = _f32(pvjp(dyj)[0])
    if dtype == "f32":
        numpy.testing.assert_allclose(y, _f32(ref_y), rtol=1e-5, atol=1e-6)
        _assert_within(dx, ref_dx, 1e-5 * scale, "dx vs lrn_reference")
    else:
        _assert_within(y, _f32(ref_y), 2.0 ** -7 * numpy.abs(_f32(ref_y)) +
                       1e-30, "y vs lrn_reference")
        _assert_within(dx, ref_dx, 2.0 ** -7 * (scale + numpy.abs(ref_dx)),
                       "dx vs lrn_reference")
    _assert_within(y, _f32(pal_y), 2.0 ** -6 * numpy.abs(_f32(pal_y)) +
                   1e-6, "y vs lrn_pallas")
    _assert_within(dx, pal_dx, 2.0 ** -6 * (scale + numpy.abs(pal_dx)),
                   "dx vs lrn_pallas")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("consts", sorted(CONSTANTS))
def test_backward_formula_matches_autograd(consts, dtype):
    """The float32 formula the backward kernel computes — first term,
    second term through the TRANSPOSED window — equals autograd through
    the plain forward; dropping the second term or not transposing the
    even window is flagged at the strong constants."""
    n, alpha, beta, k = CONSTANTS[consts]
    x, dy = _inputs(96, seed=n)
    tdt = DTYPES[dtype][0]
    xt, dyt = torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt)
    want = _f32(L.lrn_backward_reference(xt, dyt, n, alpha, beta, k))
    dx, scale = L.lrn_backward_formula(xt, dyt, n, alpha, beta, k)
    scale = scale.numpy()
    if dtype == "f32":
        tol = 1e-5 * scale
    else:
        tol = 2.0 ** -7 * (scale + numpy.abs(want))
    _assert_within(_f32(dx.to(tdt)), want, tol, "formula")
    if consts == "alexnet":
        return
    band = L.band_matrix(96, n)
    d = k + (alpha / n) * ((xt * xt).float() @ band)
    first = dyt.float() / d ** beta
    assert (numpy.abs(_f32(first) - want) / tol).max() > 10.0
    if n % 2 == 0:
        t = dyt.float() * xt.float() / (d ** beta * d)
        wrong = first - 2 * beta * (alpha / n) * xt.float() * (t @ band)
        assert (numpy.abs(_f32(wrong) - want) / tol).max() > 10.0


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_library_call_has_the_same_window(n):
    """``F.local_response_norm`` (the library yardstick chip_smoke.py
    times) pads the channel axis by (n//2, (n-1)//2): the same window as
    ``band_matrix``, even n included — checked, not assumed (float32,
    rtol 1e-5)."""
    x, _ = _inputs(11, seed=n)
    xt = torch.from_numpy(x)
    lib = torch.nn.functional.local_response_norm(
        xt.permute(0, 3, 1, 2), n, float(n), 0.75, 1.0).permute(0, 2, 3, 1)
    numpy.testing.assert_allclose(
        lib.numpy(), L.lrn_reference(xt, n, float(n), 0.75, 1.0).numpy(),
        rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers and the dispatch are the plain versions,
    launch nothing, and ``lrn`` is differentiable."""
    x, dy = _inputs(96, seed=3)
    xt = torch.from_numpy(x).requires_grad_(True)
    dyt = torch.from_numpy(dy)
    launches = (L.lrn_forward.launches, L.lrn_backward.launches)
    y = L.lrn(xt, *CONSTANTS["strong_n4"])
    assert torch.equal(y, L.lrn_reference(xt, *CONSTANTS["strong_n4"]))
    assert torch.equal(L.lrn_forward(xt, *CONSTANTS["strong_n4"]), y)
    grad, = torch.autograd.grad(y, xt, dyt)
    assert torch.equal(
        L.lrn_backward(xt.detach(), dyt, *CONSTANTS["strong_n4"]), grad)
    assert (L.lrn_forward.launches, L.lrn_backward.launches) == launches


def test_refusals():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        L.lrn(torch.zeros((2, 8), dtype=torch.float16), *ALEXNET)
    with pytest.raises(ValueError, match="contract"):
        L.lrn(torch.zeros((1, L.MAX_CHANNELS + 1)), *ALEXNET)
    with pytest.raises(ValueError, match="differ"):
        L.lrn_backward(torch.zeros((2, 8)), torch.zeros((2, 9)), *ALEXNET)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_route_register_while_the_halo_fits_a_vector(dtype):
    """The register route takes every window whose halo (n // 2 below,
    n - 1 - n // 2 above, clipped to C - 1) fits one 16-byte vector a
    side — n <= 17 in bfloat16, n <= 9 in float32 — on 16-byte aligned
    data; a wider window takes the wide route, unless the row is too
    short to need it."""
    tdt = DTYPES[dtype][0]
    widest = 17 if dtype == "bf16" else 9
    ptrs = [0, 16, 4096]
    for c in (1, 7, 96, 264, L.MAX_CHANNELS):
        for n in range(1, widest + 1):
            assert L.lrn_route(c, n, tdt, ptrs) == "register", (c, n)
    for n in (widest + 1, widest + 2, 64):
        assert L.lrn_route(96, n, tdt, ptrs) == "wide", n
    # n // 2 and n - 1 - n // 2 clip to C - 1: a row of 2 has a halo of 1.
    assert L.lrn_route(2, 64, tdt, ptrs) == "register"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_route_wide_off_16_bytes(dtype):
    """An address that is not a multiple of 16 bytes — one element (2 or
    4 bytes) or 8 bytes off — takes the wide route, whichever tensor it
    is."""
    tdt = DTYPES[dtype][0]
    size = 4 if dtype == "f32" else 2
    for off in (size, 8, 16 - size):
        for at in range(3):
            ptrs = [4096, 4096, 4096]
            ptrs[at] += off
            assert L.lrn_route(96, 5, tdt, ptrs) == "wide", (off, at)


def test_route_refuses_outside_the_contract():
    for dtype, c, n in ((torch.float16, 96, 5), (torch.float32, 0, 5),
                        (torch.float32, L.MAX_CHANNELS + 1, 5),
                        (torch.bfloat16, 96, 0)):
        with pytest.raises(ValueError):
            L.lrn_route(c, n, dtype, [0])


class _CardTensor(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what the dispatch sees of
    a tensor on the card, without one."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.fixture
def lrn_knob():
    saved = troot.common.engine.get("pallas_lrn")
    yield troot.common.engine
    if saved is None:
        troot.common.engine.__dict__.pop("pallas_lrn", None)
    else:
        troot.common.engine.pallas_lrn = saved


def _unit_on(x, lrn_knob_value, engine):
    from veles_tpu_torch.znicz.lrn import LRNormalizerForward
    if lrn_knob_value is None:
        engine.__dict__.pop("pallas_lrn", None)
    else:
        engine.pallas_lrn = lrn_knob_value
    unit = LRNormalizerForward(None, **dict(zip("n alpha beta k".split(),
                                                ALEXNET)))
    unit.input = object()
    out = {}
    unit.tforward(lambda v: x, lambda v, val: out.setdefault("y", val),
                  {}, None)
    return out["y"]


@pytest.mark.parametrize("knob", [None, True])
def test_card_tensor_without_a_kernel_library_raises(lrn_knob, monkeypatch,
                                                     knob):
    """Unset or True, the LRN unit sends a CUDA tensor to the kernels: with
    no kernel library to build (nvcc missing) it raises, and the plain
    version is never reached."""
    def no_nvcc(*sources):
        raise RuntimeError("nvcc not found (stub)")

    def plain(*args):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(L, "_lib", [None])
    monkeypatch.setattr(nvcc, "build", no_nvcc)
    monkeypatch.setattr(L, "lrn_reference", plain)
    x = torch.zeros((2, 3, 3, 8)).as_subclass(_CardTensor)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _unit_on(x, knob, lrn_knob)


def test_card_tensor_launches_on_its_route(monkeypatch):
    """On a CUDA tensor each wrapper launches its kernel once, with the
    route code :func:`lrn_route` picks, counted in ``launches`` and
    ``launches_by_route``: aligned data the register route, data one
    element off 16 bytes the wide route; ``route="wide"`` forces the wide
    route, and a forced register route outside its contract, or an
    unknown route, raises before any launch."""
    calls = []
    monkeypatch.setattr(L, "_launch",
                        lambda fn, name, route, *args: calls.append(
                            (fn, route)))
    L.reset_launches()
    shape = (2, 3, 5, 96)
    x = torch.zeros(shape).as_subclass(_CardTensor)
    L.lrn_forward(x, *ALEXNET)
    L.lrn_backward(x, x, *ALEXNET)
    L.lrn_forward(x, *ALEXNET, route="wide")
    off = torch.zeros(2 * 3 * 5 * 96 + 1)[1:].view(shape).as_subclass(
        _CardTensor)
    L.lrn_backward(off, off, *ALEXNET)
    with pytest.raises(ValueError, match="register route refused"):
        L.lrn_forward(off, *ALEXNET, route="register")
    with pytest.raises(ValueError, match="none of"):
        L.lrn_forward(x, *ALEXNET, route="shared")
    assert calls == [("veles_lrn_fwd", 1), ("veles_lrn_bwd", 1),
                     ("veles_lrn_fwd", 0), ("veles_lrn_bwd", 0)]
    assert L.lrn_forward.launches_by_route == {"register": 1, "wide": 1}
    assert L.lrn_backward.launches_by_route == {"register": 1, "wide": 1}
    assert (L.lrn_forward.launches, L.lrn_backward.launches) == (2, 2)
    L.reset_launches()


def test_knob_false_takes_the_plain_version_on_the_card(lrn_knob,
                                                        monkeypatch):
    """``pallas_lrn = False`` takes the plain banded version whatever the
    device; on the CPU the unit equals the plain version either way."""
    seen = []
    monkeypatch.setattr(L, "lrn_forward", lambda *a: seen.append("kernel"))
    monkeypatch.setattr(L, "lrn_reference",
                        lambda x, *a: seen.append(x.device.type) or x)
    x = torch.zeros((2, 3, 3, 8)).as_subclass(_CardTensor)
    assert _unit_on(x, False, lrn_knob) is x
    assert seen == ["cuda"]
    monkeypatch.undo()
    x, _ = _inputs(16, seed=9)
    xt = torch.from_numpy(x)
    want = L.lrn_reference(xt, *ALEXNET)
    for knob in (None, True, False):
        assert torch.equal(_unit_on(xt, knob, lrn_knob), want)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the LRN kernels run only there "
                    "(chip_smoke.py checks them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("consts", sorted(CONSTANTS))
def test_kernels_match_plain_on_the_card(cuda_card, consts, dtype):
    """B6 and B7 against their plain versions on the card, over a ragged
    row count (3·37·41) and C = 96: float32 forward rtol 1e-5, backward
    1e-5 of the terms' magnitude; bfloat16 one ulp forward (2^-7) and
    2^-7 of (terms' magnitude + |dx|) backward."""
    n, alpha, beta, k = CONSTANTS[consts]
    tdt = DTYPES[dtype][0]
    gen = torch.Generator(device=cuda_card).manual_seed(n)
    x = torch.randn((3, 37, 41, 96), generator=gen, device=cuda_card).to(tdt)
    dy = torch.randn(x.shape, generator=gen, device=cuda_card).to(tdt)
    launches = (L.lrn_forward.launches, L.lrn_backward.launches)
    y = L.lrn_forward(x, n, alpha, beta, k).float()
    dx = L.lrn_backward(x, dy, n, alpha, beta, k).float()
    assert (L.lrn_forward.launches, L.lrn_backward.launches) == (
        launches[0] + 1, launches[1] + 1)
    want_y = L.lrn_reference(x, n, alpha, beta, k).float()
    want_dx = L.lrn_backward_reference(x, dy, n, alpha, beta, k).float()
    _, scale = L.lrn_backward_formula(x, dy, n, alpha, beta, k)
    rtol = 1e-5 if dtype == "f32" else 2.0 ** -7
    assert ((y - want_y).abs() <= rtol * want_y.abs()).all()
    tol = 1e-5 * scale if dtype == "f32" else \
        2.0 ** -7 * (scale + want_dx.abs())
    assert ((dx - want_dx).abs() <= tol).all()


#: Channel counts of the register route's bit-equality gate: rows shorter
#: than a vector, rows ending inside a vector (7, 100, 264, 1000 in
#: bfloat16), inside a warp's tile and on its edge, and the limit.
GATE_C = (1, 2, 7, 24, 96, 100, 256, 264, 1000, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, "widest"])
def test_register_route_equals_wide_route_on_the_card(cuda_card, dtype, n):
    """The register route's y and dx equal the wide route's bit for bit
    at every channel count of GATE_C over a ragged row count, at the
    strong constants (n = 4 the even window; "widest" 17 in bfloat16, 9
    in float32)."""
    tdt = DTYPES[dtype][0]
    n = (17 if dtype == "bf16" else 9) if n == "widest" else n
    gen = torch.Generator(device=cuda_card).manual_seed(n)
    for c in GATE_C:
        rows = 37 * 41 if c < 1000 else 123
        x = torch.randn((rows, c), generator=gen, device=cuda_card).to(tdt)
        dy = torch.randn(x.shape, generator=gen, device=cuda_card).to(tdt)
        consts = (n, float(n), 0.75, 1.0)
        assert L.lrn_route(c, n, tdt, [x.data_ptr(), dy.data_ptr()]) == \
            "register"
        before = (L.lrn_forward.launches_by_route["register"],
                  L.lrn_backward.launches_by_route["register"])
        y = L.lrn_forward(x, *consts)
        dx = L.lrn_backward(x, dy, *consts)
        assert (L.lrn_forward.launches_by_route["register"],
                L.lrn_backward.launches_by_route["register"]) == (
                    before[0] + 1, before[1] + 1)
        assert torch.equal(y, L.lrn_forward(x, *consts, route="wide")), c
        assert torch.equal(
            dx, L.lrn_backward(x, dy, *consts, route="wide")), c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_unaligned_storage_takes_the_wide_route_on_the_card(cuda_card,
                                                            dtype):
    """x and dy one element into their storage launch the wide route
    (``launches_by_route``), agree with the plain version within the
    card's tolerances, and a forced register route raises."""
    tdt = DTYPES[dtype][0]
    gen = torch.Generator(device=cuda_card).manual_seed(11)
    shape = (3, 37, 41, 96)
    numel = 3 * 37 * 41 * 96
    x, dy = (torch.randn(numel + 1, generator=gen, device=cuda_card).to(
        tdt)[1:].view(shape) for _ in range(2))
    consts = CONSTANTS["strong_n5"]
    before = (L.lrn_forward.launches_by_route["wide"],
              L.lrn_backward.launches_by_route["wide"])
    y = L.lrn_forward(x, *consts).float()
    dx = L.lrn_backward(x, dy, *consts).float()
    assert (L.lrn_forward.launches_by_route["wide"],
            L.lrn_backward.launches_by_route["wide"]) == (
                before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="register route refused"):
        L.lrn_forward(x, *consts, route="register")
    want_y = L.lrn_reference(x, *consts).float()
    want_dx = L.lrn_backward_reference(x, dy, *consts).float()
    _, scale = L.lrn_backward_formula(x, dy, *consts)
    rtol = 1e-5 if dtype == "f32" else 2.0 ** -7
    assert ((y - want_y).abs() <= rtol * want_y.abs()).all()
    tol = 1e-5 * scale if dtype == "f32" else \
        2.0 ** -7 * (scale + want_dx.abs())
    assert ((dx - want_dx).abs() <= tol).all()
