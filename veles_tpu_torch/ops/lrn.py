"""Cross-channel local response normalization: forward (B6) and
backward (B7).

The port of the TPU kernels ``_fwd_kernel`` and ``_bwd_kernel`` of
``veles_tpu/ops/pallas_lrn.py`` and of their ``lrn_pallas`` custom VJP::

    y = x · (k + α/n · Σ_{j∈window} x_j²)^(−β)

over the last (channel) axis.  What lives here:

* :func:`band_matrix` — the 0/1 window membership (asymmetric for
  even ``n``);
* the plain PyTorch versions: :func:`lrn_reference`, the banded
  formulation the JAX package's AlexNet tick runs (differentiable by
  autograd), :func:`lrn_backward_reference` (autograd through it) and
  :func:`lrn_backward_formula` (the explicit float32 dx formula the
  backward kernel computes, with the scale of its rounding error);
* the wrappers :func:`lrn_forward` and :func:`lrn_backward` — the
  plain version for CPU tensors, a hand-written CUDA kernel
  (``csrc/lrn.cu``) for CUDA tensors — each with a ``launches`` count,
  one more per kernel launch, and ``launches_by_route``, the same count
  by route;
* :func:`lrn_route`, the kernels' two routes: "register" (16-byte
  vectors, the window's halo from the neighbouring lanes by warp
  shuffles) for every call whose halo fits one vector on each side
  (``n // 2`` and ``n - 1 - n // 2``, clipped to ``C - 1``, at most 8
  in bfloat16 and 4 in float32: n <= 17 and n <= 9) with 16-byte
  aligned data, "wide" (tiles of whole rows through shared memory) for
  every other call; the two agree bit for bit;
* :func:`lrn`, the dispatch: a CPU tensor takes :func:`lrn_reference`;
  a CUDA tensor goes through a ``torch.autograd.Function`` whose
  forward launches B6 and whose backward launches B7.

There is no availability probe: on a CUDA tensor a missing ``nvcc``, a
build or launch error, an unsupported dtype or a channel count outside
the contract raises.  The only way to the plain version on the card is
the LRN unit's ``root.common.engine.pallas_lrn = False``.

Contract: float32 or bfloat16, any leading shape, 1 <= C <=
``MAX_CHANNELS`` channels on the last axis, ``n >= 1``.
"""

import ctypes
import os
import threading

import torch

from . import nvcc

#: Largest channel count the kernels take (one row must fit a tile).
MAX_CHANNELS = 4096
_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Elements in a 16-byte vector: the register route's unit and the
#: widest halo it takes on each side.
VECTOR = {torch.float32: 4, torch.bfloat16: 8}
#: Kernel routes (:func:`lrn_route`) and their codes in ``csrc/lrn.cu``.
ROUTES = ("register", "wide")
_ROUTE_CODES = {"wide": 0, "register": 1}

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "lrn.cu")


def band_matrix(c, n, dtype=torch.float32, device=None):
    """0/1 window membership B[i, j] = 1 iff input channel i falls in
    output channel j's window [j − n//2, j + n − 1 − n//2]."""
    half = n // 2
    i = torch.arange(c, device=device)
    d = i[:, None] - i[None, :]
    return ((d >= -half) & (d <= n - 1 - half)).to(dtype)


# -- plain versions ---------------------------------------------------------


def lrn_reference(x, n, alpha, beta, k):
    """The banded formulation (``pallas_lrn.lrn_reference``): the square
    in x's dtype, the window sum and the rest in float32, one rounding
    to x's dtype at the end.  Differentiable by autograd."""
    band = band_matrix(x.shape[-1], n, torch.float32, x.device)
    sq = x * x
    ssum = torch.matmul(sq.float(), band)
    denom = (k + (alpha / n) * ssum) ** beta
    return (x.float() / denom).to(x.dtype)


def lrn_backward_reference(x, dy, n, alpha, beta, k):
    """dx by autograd through :func:`lrn_reference` — the plain version
    of the backward kernel, with autograd's roundings: in bfloat16 the
    gradients of the square and of the float32 upcast round to
    bfloat16, as the JAX package's autodiff of the same formulation
    does."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        y = lrn_reference(leaf, n, alpha, beta, k)
        return torch.autograd.grad(y, leaf, dy)[0]


def lrn_backward_formula(x, dy, n, alpha, beta, k):
    """(dx, scale): the backward kernel's float32 formula, unrounded —
    ``dx = dy·d^(−β) − (2αβ/n)·x·[t·Bᵀ]`` with ``t = dy·x·d^(−β−1)`` —
    and the sum of the magnitudes of every term it adds,
    ``|dy·d^(−β)| + (2αβ/n)·|x|·[|t|·Bᵀ]``, the scale of the rounding
    error of any order of summing them (for tolerances, and for
    checking the formula against autograd)."""
    band = band_matrix(x.shape[-1], n, torch.float32, x.device)
    xf, g = x.float(), dy.float()
    d = k + (alpha / n) * torch.matmul((x * x).float(), band)
    pw = d ** beta
    first = g / pw
    t = g * xf / (pw * d)
    coef = 2.0 * beta * (alpha / n)
    dx = first - coef * xf * torch.matmul(t, band.t())
    scale = first.abs() + coef * xf.abs() * torch.matmul(t.abs(), band.t())
    return dx, scale


# -- the kernels --------------------------------------------------------------


def _check_contract(c, n, dtype, shape):
    if dtype not in _CODES:
        raise ValueError("lrn takes float32 or bfloat16, got %s" % dtype)
    if not 1 <= c <= MAX_CHANNELS or int(n) < 1:
        raise ValueError("lrn contract: 1 <= C <= %d channels on the last "
                         "axis and n >= 1, got shape %s, n=%r" %
                         (MAX_CHANNELS, shape, n))


def lrn_route(c, n, dtype, data_ptrs):
    """The route of a CUDA launch over ``c`` channels with window ``n``
    on tensors of ``dtype`` at the addresses ``data_ptrs``: "register"
    when the window's halo — ``n // 2`` channels below and ``n - 1 - n //
    2`` above, each clipped to ``c - 1`` — fits one 16-byte vector on each
    side (``VECTOR[dtype]`` elements) and every address is a multiple of
    16 bytes; "wide" otherwise.  Raises outside the contract."""
    _check_contract(c, n, dtype, (c,))
    n = int(n)
    lo, hi = min(n // 2, c - 1), min(n - 1 - n // 2, c - 1)
    if max(lo, hi) <= VECTOR[dtype] and all(p % 16 == 0 for p in data_ptrs):
        return "register"
    return "wide"


def _check(x, n, *rest):
    _check_contract(x.shape[-1] if x.dim() else 0, n, x.dtype,
                    tuple(x.shape))
    for t in rest:
        if t.shape != x.shape or t.dtype != x.dtype or \
                t.device != x.device:
            raise ValueError("lrn operands differ: %s %s %s vs %s %s %s" %
                             (t.dtype, tuple(t.shape), t.device, x.dtype,
                              tuple(x.shape), x.device))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("lrn runs on cpu or cuda tensors, not %s" %
                         x.device)


def _launch(fn, name, *args):
    """Calls the C entry point ``fn`` with ``args`` (tensors as their
    addresses) on the current stream of the first tensor's device."""
    lib = _library()
    device = next(a for a in args if isinstance(a, torch.Tensor)).device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*[
            a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args] + [stream])
    if err:
        raise RuntimeError("%s kernel launch failed: %s (CUDA error %d)" %
                           (name, lib.veles_lrn_error_string(err).decode(),
                            err))


def _geometry(x, n, alpha, beta, k):
    c = x.shape[-1]
    return (x.numel() // c, c, int(n), float(k), float(alpha) / int(n),
            float(beta))


def _chosen(route, x, n, tensors):
    """The route of a launch: :func:`lrn_route`'s, or ``route`` where the
    caller forces one ("wide" always fits; "register" raises outside its
    contract)."""
    fits = lrn_route(x.shape[-1], n, x.dtype,
                     [t.data_ptr() for t in tensors])
    if route is None:
        return fits
    if route not in ROUTES:
        raise ValueError("lrn route %r is none of %s" % (route, ROUTES))
    if route == "register" and fits != "register":
        raise ValueError(
            "lrn register route refused: it takes a window halo of at "
            "most %d channels a side and 16-byte aligned data, got n=%r "
            "over C=%d at addresses %s" % (
                VECTOR[x.dtype], n, x.shape[-1],
                [t.data_ptr() % 16 for t in tensors]))
    return route


def _count(wrapper, way):
    wrapper.launches += 1
    wrapper.launches_by_route[way] += 1


def lrn_forward(x, n, alpha, beta, k, route=None):
    """y.  CPU tensors take :func:`lrn_reference`; CUDA tensors launch
    the forward kernel on the route :func:`lrn_route` picks (``route``
    forces one, for the A/B of the two), adding one to
    ``lrn_forward.launches`` and to its ``launches_by_route``, on the
    current stream, or raise."""
    _check(x, n)
    if x.device.type == "cpu":
        return lrn_reference(x, n, alpha, beta, k)
    x = x.contiguous()
    y = torch.empty_like(x)
    way = _chosen(route, x, n, (x, y))
    _launch("veles_lrn_fwd", "lrn forward", _ROUTE_CODES[way],
            _CODES[x.dtype], x, y, *_geometry(x, n, alpha, beta, k))
    _count(lrn_forward, way)
    return y


def lrn_backward(x, dy, n, alpha, beta, k, route=None):
    """dx from the forward's input and the output cotangent.  CPU
    tensors take :func:`lrn_backward_reference`; CUDA tensors launch the
    backward kernel on its route as :func:`lrn_forward` does
    (``lrn_backward.launches``, ``.launches_by_route``) or raise."""
    _check(x, n, dy)
    if x.device.type == "cpu":
        return lrn_backward_reference(x, dy, n, alpha, beta, k)
    x, dy = x.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    way = _chosen(route, x, n, (x, dy, dx))
    _launch("veles_lrn_bwd", "lrn backward", _ROUTE_CODES[way],
            _CODES[x.dtype], x, dy, dx, *_geometry(x, n, alpha, beta, k))
    _count(lrn_backward, way)
    return dx


def reset_launches():
    """Zeroes both wrappers' launch counts."""
    for wrapper in (lrn_forward, lrn_backward):
        wrapper.launches = 0
        wrapper.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launches()


class _LRN(torch.autograd.Function):
    """``lrn_pallas``'s custom VJP: the forward kernel saves x, the
    backward kernel recomputes the denominator from it."""

    @staticmethod
    def forward(ctx, x, n, alpha, beta, k):
        ctx.save_for_backward(x)
        ctx.args = (n, alpha, beta, k)
        return lrn_forward(x, n, alpha, beta, k)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        return (lrn_backward(x, dy.to(x.dtype), *ctx.args), None, None,
                None, None)


def lrn(x, n, alpha, beta, k):
    """LRN over the last axis, differentiable: CPU tensors take
    :func:`lrn_reference`; CUDA tensors launch the forward kernel, and
    the backward kernel under autograd, or raise."""
    _check(x, n)
    if x.device.type == "cpu":
        return lrn_reference(x, n, alpha, beta, k)
    return _LRN.apply(x, int(n), float(alpha), float(beta), float(k))


# -- build and load -----------------------------------------------------------

_lib = [None]
_lib_lock = threading.Lock()


def build():
    """Compiles ``csrc/lrn.cu`` (see :mod:`.nvcc`) unless its library
    exists; returns the library's path."""
    return nvcc.build(SOURCE)[0]


def _library():
    """The loaded kernel library, built on first use."""
    if _lib[0] is None:
        with _lib_lock:
            if _lib[0] is None:
                lib = ctypes.CDLL(build())
                vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                geometry = [ctypes.c_longlong, ci, ci, cf, cf, cf, vp]
                lib.veles_lrn_fwd.argtypes = [ci, ci, vp, vp] + geometry
                lib.veles_lrn_bwd.argtypes = [ci, ci, vp, vp, vp] + \
                    geometry
                for fn in ("veles_lrn_fwd", "veles_lrn_bwd",
                           "veles_lrn_max_c"):
                    getattr(lib, fn).restype = ci
                lib.veles_lrn_error_string.argtypes = [ci]
                lib.veles_lrn_error_string.restype = ctypes.c_char_p
                if lib.veles_lrn_max_c() != MAX_CHANNELS:
                    raise RuntimeError(
                        "kernel library channel limit %d disagrees with "
                        "the wrapper's %d" % (lib.veles_lrn_max_c(),
                                              MAX_CHANNELS))
                _lib[0] = lib
    return _lib[0]
