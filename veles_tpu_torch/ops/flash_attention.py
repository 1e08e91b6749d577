"""Flash attention with its backward: forward (B1), dq (B2), dk/dv (B3).

The port of the TPU kernels ``_fwd_kernel``, ``_dq_kernel`` and
``_dkv_kernel`` (``veles_tpu/ops/pallas_attention.py``) and of their
``_flash_lse`` custom VJP.  What lives here:

* :func:`supports` — the port's own geometry contract;
* the plain PyTorch versions of the three kernels:
  :func:`flash_attention_reference` (``(out, lse)``, differentiable by
  autograd), :func:`flash_attention_dq_reference` and
  :func:`flash_attention_dkv_reference` (the explicit backward
  formulas of ``_dq_kernel`` and ``_dkv_kernel``);
* the wrappers :func:`flash_forward`, :func:`flash_dq` and
  :func:`flash_dkv` — the plain version for CPU tensors, a hand-written
  CUDA kernel for CUDA tensors — each with a ``launches`` count, one
  more per kernel launch, and ``route_launches``, the same count by
  route (:func:`route`);
* :func:`flash_chunk` (``(out, lse)`` through a
  ``torch.autograd.Function`` whose backward runs the dq and dk/dv
  wrappers and accepts the lse cotangent), :func:`flash_attention`
  (``out`` only — the JAX package's ``pallas_attention``),
  :func:`merge_partials` and :func:`flash_resume`.

The kernels are CUDA C++ for ``sm_90a``, built at first use by
:mod:`.nvcc`, on two routes:

* ``"tensor_core"`` (``csrc/flash_attention_tc.cu``): the three kernels
  of every pair whose q, k, v and dO are bf16-exact — bf16 storage
  with f32 or bf16 operands, f32 storage with bf16 operands — run
  their products as ``wgmma`` on the bf16 tensor cores (an f32 operand
  p or ds as three bf16 terms);
* ``"fp32"`` (``csrc/flash_attention.cu``): f32 storage with f32
  operands (the parity mode: an f32 × f32 product is not exact in bf16
  pieces), on the FP32 units.
  On a CUDA tensor a missing ``nvcc``, a build or launch
error, an unsupported dtype or a shape outside the contract raises:
no path carries on without the kernel.

Contract (:func:`supports`): q ``(B, Sq, H, D)``, k/v ``(B, Sk, H, D)``
with matching B/H/D, any ``Sq, Sk >= 1`` (the ragged tail is masked in
the kernel; the TPU kernel's ``S % 128`` and ``S <= 2048`` bounds do
not apply), ``D <= MAX_HEAD_DIM``, storage float32 or bfloat16 and
matmul operands (``operand_dtype``) float32 or bfloat16 with float32
accumulation.  ``causal`` masks on global positions ``q_offset + row
>= k_offset + col``; ``kv_len`` bounds the local key columns.
"""

import ctypes
import os
import threading

import torch

from . import nvcc

#: Largest head dim the kernels take.
MAX_HEAD_DIM = 128
#: The masked-score fill and the l floor of the TPU kernel.
NEG_INF = -1e30
L_FLOOR = 1e-30
#: Storage / operand dtype codes of the kernel library.
_CODES = {torch.float32: 0, torch.bfloat16: 1}

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "flash_attention.cu")
TC_SOURCE = os.path.join(os.path.dirname(SOURCE), "flash_attention_tc.cu")
#: Kernel routes (:func:`route`).
ROUTES = ("tensor_core", "fp32")


def supports(q_shape, k_shape, kv_len=None):
    """Whether ``(q_shape, k_shape, kv_len)`` lies inside the kernels'
    contract (see the module docstring)."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    B, Sq, H, D = q_shape
    Bk, Sk, Hk, Dk = k_shape
    if (B, H, D) != (Bk, Hk, Dk) or B < 1 or H < 1 or B * H > 65535:
        return False
    if kv_len is not None and not isinstance(kv_len, int):
        return False
    return Sq >= 1 and Sk >= 1 and 1 <= D <= MAX_HEAD_DIM


# -- plain versions ---------------------------------------------------------


def _mask(Sq, Sk, causal, q_offset, k_offset, kv_len, device):
    """(Sq, Sk) bool attend-mask, or None when nothing masks
    (``_mask_tile``)."""
    mask = None
    if causal:
        rows = q_offset + torch.arange(Sq, device=device)[:, None]
        cols = k_offset + torch.arange(Sk, device=device)[None, :]
        mask = rows >= cols
    if kv_len is not None:
        kvm = (torch.arange(Sk, device=device) < kv_len)[None, :]
        mask = kvm.expand(Sq, Sk) if mask is None else mask & kvm
    return mask


def _operands(od, *tensors):
    """Each tensor rounded to the operand dtype, as float32."""
    return [t.to(od).float() for t in tensors]


def flash_attention_reference(q, k, v, causal=False, q_offset=0,
                              k_offset=0, kv_len=None,
                              operand_dtype=torch.float32):
    """The plain forward: ``(out, lse)`` — out in q's dtype, lse
    (B, Sq, H) float32 — computed densely with the kernel's numerics
    (operands rounded to ``operand_dtype``, float32 sums, masked scores
    at ``NEG_INF``, probabilities re-masked to 0, l floored at 1e-30).
    Differentiable by autograd; the row maximum is held constant, which
    leaves both outputs' gradients exact (each is invariant to it)."""
    qf, kf, vf = _operands(operand_dtype, q, k, v)
    Sq, Sk = q.shape[1], k.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = _mask(Sq, Sk, causal, q_offset, k_offset, kv_len, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(L_FLOOR)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(operand_dtype).float(), vf)
    out = pv / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0].permute(0, 2, 1)
    return out.to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, causal, q_offset, k_offset, kv_len,
          od):
    """The backward's recomputed probabilities and score gradients,
    (B, H, Sq, Sk) float32: p = exp(s − lse) re-masked,
    ds = p·(dp − delta)·scale."""
    qf, kf, vf, dof = _operands(od, q, k, v, do)
    Sq, Sk = q.shape[1], k.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = _mask(Sq, Sk, causal, q_offset, k_offset, kv_len, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse.permute(0, 2, 1)[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 1)[..., None]) * scale
    return p, ds, qf, kf, dof


def flash_attention_dq_reference(q, k, v, do, lse, delta, causal=False,
                                 q_offset=0, k_offset=0, kv_len=None,
                                 operand_dtype=torch.float32):
    """The plain dq: Σ_j ds·k (``_dq_kernel``), in q's dtype."""
    _, ds, _, kf, _ = _p_ds(q, k, v, do, lse, delta, causal, q_offset,
                            k_offset, kv_len, operand_dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(operand_dtype).float(), kf)
    return dq.to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta, causal=False,
                                  q_offset=0, k_offset=0, kv_len=None,
                                  operand_dtype=torch.float32):
    """The plain (dk, dv): Σ_i dsᵀ·q and Σ_i pᵀ·dO (``_dkv_kernel``),
    in k's dtype."""
    p, ds, qf, _, dof = _p_ds(q, k, v, do, lse, delta, causal, q_offset,
                              k_offset, kv_len, operand_dtype)
    od = operand_dtype
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(od).float(), qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(od).float(), dof)
    return dk.to(k.dtype), dv.to(k.dtype)


# -- wrappers: plain version on CPU, kernel on CUDA -------------------------


def _check(q, k, v, kv_len, od, *rest):
    if not supports(tuple(q.shape), tuple(k.shape), kv_len):
        raise ValueError(
            "geometry q %s × k %s (kv_len=%r) is outside the flash-"
            "attention contract (matching B/H/D, D <= %d)" %
            (tuple(q.shape), tuple(k.shape), kv_len, MAX_HEAD_DIM))
    if v.shape != k.shape:
        raise ValueError("v %s does not match k %s" %
                         (tuple(v.shape), tuple(k.shape)))
    if q.dtype not in _CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError("flash attention stores float32 or bfloat16 "
                         "q/k/v of one dtype, got %s/%s/%s" %
                         (q.dtype, k.dtype, v.dtype))
    if od not in _CODES:
        raise ValueError("operand dtype must be float32 or bfloat16, "
                         "got %s" % od)
    devices = {t.device for t in (q, k, v) + rest}
    if len(devices) != 1:
        raise ValueError("operands on several devices: %s" %
                         sorted(map(str, devices)))
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError("flash attention runs on cpu or cuda tensors, "
                         "not %s" % q.device)


def _geometry(q, k, causal, q_offset, k_offset, kv_len):
    B, Sq, H, D = q.shape
    return (B, H, Sq, k.shape[1], D, 1.0 / (D ** 0.5), int(bool(causal)),
            int(q_offset), int(k_offset), -1 if kv_len is None
            else int(kv_len))


def route(kernel, storage, operand_dtype):
    """The route a CUDA launch of ``kernel`` ("flash_forward",
    "flash_dq" or "flash_dkv") takes for a storage/operand dtype pair:
    "fp32" for float32/float32, "tensor_core" otherwise."""
    if storage == operand_dtype == torch.float32:
        return "fp32"
    return "tensor_core"


#: C entry point of each (kernel, route).
_ENTRY = {("flash_forward", "fp32"): "veles_flash_fwd",
          ("flash_forward", "tensor_core"): "veles_flash_fwd_tc",
          ("flash_dq", "fp32"): "veles_flash_dq",
          ("flash_dq", "tensor_core"): "veles_flash_dq_tc",
          ("flash_dkv", "fp32"): "veles_flash_dkv",
          ("flash_dkv", "tensor_core"): "veles_flash_dkv_tc"}


def _entry(kernel, storage, od):
    """(C entry point, route) of one launch."""
    way = route(kernel, storage, od)
    return _ENTRY[(kernel, way)], way


def _count(wrapper, way):
    wrapper.launches += 1
    wrapper.route_launches[way] += 1


def _launch(fn, name, *args):
    lib = _library(fn.endswith("_tc"))
    device = args[2].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*[
            a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args] + [stream])
    if err:
        raise RuntimeError("%s kernel launch failed: %s (CUDA error %d)"
                           % (name, lib.error_string(err).decode(), err))


def flash_forward(q, k, v, causal=False, q_offset=0, k_offset=0,
                  kv_len=None, operand_dtype=torch.float32):
    """Forward: ``(out, lse)``.  CPU tensors take
    :func:`flash_attention_reference`; CUDA tensors launch the kernel of
    their :func:`route` (adding one to ``flash_forward.launches`` and to
    its ``route_launches``) on the current stream, or raise."""
    _check(q, k, v, kv_len, operand_dtype)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, q_offset,
                                         k_offset, kv_len, operand_dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, Sq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = q.new_empty((B, Sq, H), dtype=torch.float32)
    fn, way = _entry("flash_forward", q.dtype, operand_dtype)
    _launch(fn, "flash attention forward",
            _CODES[q.dtype], _CODES[operand_dtype], q, k, v, out, lse,
            *_geometry(q, k, causal, q_offset, k_offset, kv_len))
    _count(flash_forward, way)
    return out, lse


def _backward_inputs(q, k, v, do, lse, delta):
    B, Sq, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("dO must match q: %s %s vs %s %s" % (
            do.dtype, tuple(do.shape), q.dtype, tuple(q.shape)))
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, Sq, H) or t.dtype != torch.float32:
            raise ValueError("%s must be float32 %s, got %s %s" % (
                name, (B, Sq, H), t.dtype, tuple(t.shape)))
    return [t.contiguous() for t in (q, k, v, do, lse, delta)]


def flash_dq(q, k, v, do, lse, delta, causal=False, q_offset=0,
             k_offset=0, kv_len=None, operand_dtype=torch.float32):
    """dq from the saved lse and ``delta = Σ dO·O − g_lse``.  CPU
    tensors take :func:`flash_attention_dq_reference`; CUDA tensors
    launch the kernel (``flash_dq.launches``) or raise."""
    _check(q, k, v, kv_len, operand_dtype, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dq_reference(
            q, k, v, do, lse, delta, causal, q_offset, k_offset, kv_len,
            operand_dtype)
    q, k, v, do, lse, delta = _backward_inputs(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    fn, way = _entry("flash_dq", q.dtype, operand_dtype)
    _launch(fn, "flash attention dq", _CODES[q.dtype],
            _CODES[operand_dtype], q, k, v, do, lse, delta, dq,
            *_geometry(q, k, causal, q_offset, k_offset, kv_len))
    _count(flash_dq, way)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal=False, q_offset=0,
              k_offset=0, kv_len=None, operand_dtype=torch.float32):
    """(dk, dv) from the saved lse and delta.  CPU tensors take
    :func:`flash_attention_dkv_reference`; CUDA tensors launch the
    kernel (``flash_dkv.launches``) or raise."""
    _check(q, k, v, kv_len, operand_dtype, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(
            q, k, v, do, lse, delta, causal, q_offset, k_offset, kv_len,
            operand_dtype)
    q, k, v, do, lse, delta = _backward_inputs(q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn, way = _entry("flash_dkv", q.dtype, operand_dtype)
    _launch(fn, "flash attention dk/dv", _CODES[q.dtype],
            _CODES[operand_dtype], q, k, v, do, lse, delta, dk, dv,
            *_geometry(q, k, causal, q_offset, k_offset, kv_len))
    _count(flash_dkv, way)
    return dk, dv


def reset_launches():
    """Sets every wrapper's launch counts to 0."""
    for wrapper in (flash_forward, flash_dq, flash_dkv):
        wrapper.launches = 0
        wrapper.route_launches = dict.fromkeys(ROUTES, 0)


reset_launches()


# -- differentiable entry points --------------------------------------------


class _FlashLSE(torch.autograd.Function):
    """``_flash_lse``: (out, lse) forward; the backward recomputes the
    probabilities from the saved lse and folds the lse cotangent into
    the delta row (``delta = Σ dO·O − g_lse``), so autodiff through a
    chunk + :func:`merge_partials` composition is exact."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset, kv_len, od):
        out, lse = flash_forward(q, k, v, causal, q_offset, k_offset,
                                 kv_len, od)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, k_offset, kv_len, od)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        # The small elementwise pass the JAX package leaves to XLA.
        delta = (dout.float() * out.float()).sum(dim=-1) - dlse.float()
        dout = dout.to(q.dtype)
        dq = flash_dq(q, k, v, dout, lse, delta, *ctx.args)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_chunk(q, k, v, causal=False, q_offset=0, k_offset=0,
                kv_len=None, operand_dtype=None):
    """One flash partial of local queries (B, Sq, H, D) against a k/v
    chunk (B, Sk, H, D) at global offsets: ``(out, lse)`` with lse
    (B, Sq, H) float32.  Differentiable, including through lse.
    ``operand_dtype`` defaults to bfloat16, as the JAX package's."""
    od = operand_dtype or torch.bfloat16
    if kv_len is not None:
        kv_len = int(kv_len)
    return _FlashLSE.apply(q, k, v, bool(causal), int(q_offset),
                           int(k_offset), kv_len, od)


def flash_attention(q, k, v, causal=False, kv_len=None,
                    operand_dtype=None):
    """Flash attention over (B, S, H, D) (``pallas_attention``):
    returns ``out``, differentiable.  A geometry outside the contract
    raises ValueError."""
    return flash_chunk(q, k, v, causal=causal, kv_len=kv_len,
                       operand_dtype=operand_dtype)[0]


def merge_partials(o1, lse1, o2, lse2):
    """Folds two flash partials by lse:
    ``lse = logaddexp(lse₁, lse₂)``,
    ``out = exp(lse₁ − lse)·o₁ + exp(lse₂ − lse)·o₂``; every exponent
    is ≤ 0 and a void partial (lse ≈ −1e30) weighs 0."""
    lse1 = lse1.float()
    lse2 = lse2.float()
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse)[..., None]
    w2 = torch.exp(lse2 - lse)[..., None]
    out = (o1.float() * w1 + o2.float() * w2).to(o1.dtype)
    return out, lse


def flash_resume(carry, q, k, v, **kwargs):
    """Folds one more k/v chunk into a running ``(out, lse)`` carry
    (None starts one); the carried partial is held float32.  kwargs are
    :func:`flash_chunk`'s."""
    o_i, lse_i = flash_chunk(q, k, v, **kwargs)
    if carry is None:
        return o_i.float(), lse_i
    return merge_partials(carry[0], carry[1], o_i, lse_i)


# -- build and load -----------------------------------------------------------

_libs = {}
_lib_lock = threading.Lock()


def build():
    """Compiles ``csrc/flash_attention.cu`` and
    ``csrc/flash_attention_tc.cu`` (see :mod:`.nvcc`, one process each)
    unless their libraries exist; returns the libraries' paths."""
    return nvcc.build(SOURCE, TC_SOURCE)


def _library(tc=False):
    """The loaded kernel library of one route (``tc``: the tensor-core
    source), built on first use; its error-string function is bound as
    ``error_string``."""
    if tc not in _libs:
        with _lib_lock:
            if tc not in _libs:
                source = TC_SOURCE if tc else SOURCE
                lib = ctypes.CDLL(nvcc.build(source)[0])
                vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                geometry = [ci, ci, ci, ci, ci, cf, ci, ci, ci, ci, vp]
                suffix = "_tc" if tc else ""
                entries = {"veles_flash_fwd": 5, "veles_flash_dq": 7,
                           "veles_flash_dkv": 8}
                for fn, pointers in entries.items():
                    f = getattr(lib, fn + suffix)
                    f.argtypes = [ci, ci] + [vp] * pointers + geometry
                    f.restype = ci
                max_d = getattr(lib, "veles_flash%s_max_d" % suffix)
                max_d.restype = ci
                lib.error_string = getattr(
                    lib, "veles_flash%s_error_string" % suffix)
                lib.error_string.argtypes = [ci]
                lib.error_string.restype = ctypes.c_char_p
                if max_d() != MAX_HEAD_DIM:
                    raise RuntimeError(
                        "kernel library %s: head-dim limit %d disagrees "
                        "with the wrapper's %d" % (
                            os.path.basename(source), max_d(),
                            MAX_HEAD_DIM))
                _libs[tc] = lib
    return _libs[tc]
