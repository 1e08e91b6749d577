"""Flash-decode attention: a small query chunk against a long key table.

The port of two TPU kernels of ``veles_tpu/ops/pallas_attention.py``,
both launched by ``pallas_decode_attention``: ``_decode_kernel`` (B4,
float32 keys and values) and ``_decode_kernel_quant`` (B5, keys and
values stored as int8 or float8_e4m3fn codes with a float32 scale per
position and head, dequantized inside the kernel as ``code · scale``).
Five things live here:

* :func:`supports_decode` — the port's own geometry contract;
* :func:`decode_attention_reference` — the plain PyTorch version, and
  :func:`decode_attention_quant_reference`, B5's: dequantize to float32,
  then the same;
* :func:`decode_attention` — the wrapper: the plain versions for CPU
  tensors, the hand-written CUDA kernels (``csrc/decode_attention.cu``)
  for CUDA tensors; given ``k_scale``/``v_scale`` it is B5;
* ``decode_attention.launches`` and ``decode_attention.quant_launches``
  — plain integers, one more for every launch of B4 and of B5, so a run
  can show that it went through each kernel.

The kernel is CUDA C++ for ``sm_90a``, built at first use with
``nvcc`` into a shared library with a plain C interface (loaded with
``ctypes``) under ``build/`` beside this file.  The build, a launch
error or a shape outside the contract raises: there is no path that
carries on without the kernel on a CUDA tensor.  One template computes
B4 and B5: a block per (batch·head, split of ``KEYS_PER_SPLIT`` keys)
streams the split's k and v tiles through a ``cp.async`` ring and
computes the scores key-parallel (four lanes per key), the split's
softmax and p·V; past one split a second launch merges the splits in
split order (the source's header note has the design).  Each query row
is computed alone, so a row's result does not depend on Sq, on B, or on
keys past its mask, bit for bit.

Contract (:func:`supports_decode`): q ``(B, Sq, H, D)`` with
``1 <= Sq <= DECODE_MAX_Q``, k/v ``(B, L, H, D)`` with any ``L >= 1``
(a ragged tail is masked in the kernel, unlike the TPU kernel's
``L % 128 == 0``), ``D <= MAX_HEAD_DIM``, float32 throughout, and
``key_mask`` ``(B, Sq, L)`` bool, True = attend.  A row whose mask is
all False gets out = 0, as in the TPU kernel.  B5 takes k/v as int8 or
float8_e4m3fn codes of the same shape and ``k_scale``/``v_scale``
``(B, L, H)`` float32, one scale per position and head (the pool's
per-(block, head) scales broadcast over each block's positions, as the
JAX package passes them).
"""

import ctypes
import os
import threading

import torch

from . import nvcc

#: Past this many query rows a chunk is a prefill, served by the dense
#: path (the JAX package's ``DECODE_MAX_Q``).
DECODE_MAX_Q = 16
#: Largest head dim the kernel takes (a 4-element chunk per lane).
MAX_HEAD_DIM = 128
#: Keys each block of the kernel covers: splits start at fixed
#: multiples of it from key 0, whatever the table's length.
KEYS_PER_SPLIT = 256
#: The masked-score fill of the TPU kernel and the dense path.
NEG_INF = -1e30
#: Code types of B5, by the kernel's ``code_kind`` argument.
CODE_KINDS = {torch.int8: 0, torch.float8_e4m3fn: 1}

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "decode_attention.cu")


def supports_decode(q_shape, k_shape):
    """Whether ``(q_shape, k_shape)`` lies inside the kernel's
    contract (see the module docstring)."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    B, Sq, H, D = q_shape
    Bk, L, Hk, Dk = k_shape
    if (B, H, D) != (Bk, Hk, Dk) or B < 1 or H < 1:
        return False
    return 1 <= Sq <= DECODE_MAX_Q and L >= 1 and 1 <= D <= MAX_HEAD_DIM


def decode_attention_reference(q, k, v, key_mask, k_scale=None,
                               v_scale=None):
    """The plain version: the dense masked softmax, written as the
    JAX package's paged block writes it (``export.py``
    ``_paged_block``) — scores scaled by 1/√D, masked slots at
    ``NEG_INF``, softmax, weighted sum.  A row whose mask is all False
    returns 0, the kernel's contract (the dense formula alone would
    average every value there; serving never builds such a row).
    Given scales, k/v are codes: :func:`decode_attention_quant_reference`
    (so one ``attend`` serves every KV plane).

    A chunk of at most ``DECODE_MAX_Q`` query rows — what the kernels
    take — goes through elementwise products and sums, which compute
    each row the same way, bit for bit, whatever the chunk's row count
    or the table's width, as the kernels compute each row alone (a BLAS
    product takes another path for one row and rounds apart, so a
    one-row decode step and the same row of a verify chunk would
    differ).  Longer prefill chunks use BLAS products."""
    if k_scale is not None:
        return decode_attention_quant_reference(q, k, v, key_mask,
                                                k_scale, v_scale)
    D = q.shape[-1]
    if q.shape[1] <= DECODE_MAX_Q:
        scores = (q[:, :, None] * k[:, None]).sum(-1) / (D ** 0.5)
        scores = scores.masked_fill(~key_mask[..., None], NEG_INF)
        w = torch.softmax(scores, dim=2)          # (B, Sq, L, H)
        out = (w[..., None] * v[:, None]).sum(2)
    else:
        scores = torch.einsum("bqhd,bkhd->bqhk", q, k) / (D ** 0.5)
        scores = scores.masked_fill(~key_mask[:, :, None, :], NEG_INF)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bqhk,bkhd->bqhd", w, v)
    return out.masked_fill(~key_mask.any(-1)[:, :, None, None], 0.0)


def dequantize(codes, scale):
    """float32 ``codes · scale`` of ``(B, L, H, D)`` codes under their
    ``(B, L, H)`` scales — the value B5 forms in registers."""
    return codes.to(torch.float32) * scale[..., None]


def decode_attention_quant_reference(q, k_codes, v_codes, key_mask,
                                     k_scale, v_scale):
    """B5's plain version: dequantize k and v to float32, then
    :func:`decode_attention_reference` — exactly what pre-dequantized
    operands produce."""
    return decode_attention_reference(
        q, dequantize(k_codes, k_scale), dequantize(v_codes, v_scale),
        key_mask)


def _check(q, k, v, key_mask, k_scale=None, v_scale=None):
    if not supports_decode(tuple(q.shape), tuple(k.shape)):
        raise ValueError(
            "geometry q %s × k %s is outside the decode-kernel "
            "contract (Sq <= %d, D <= %d, matching B/H/D)" %
            (tuple(q.shape), tuple(k.shape), DECODE_MAX_Q,
             MAX_HEAD_DIM))
    if v.shape != k.shape:
        raise ValueError("v %s does not match k %s" %
                         (tuple(v.shape), tuple(k.shape)))
    B, Sq, _, _ = q.shape
    if tuple(key_mask.shape) != (B, Sq, k.shape[1]) or \
            key_mask.dtype != torch.bool:
        raise ValueError("key_mask must be bool %s, got %s %s" %
                         ((B, Sq, k.shape[1]), key_mask.dtype,
                          tuple(key_mask.shape)))
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    if k_scale is None:
        floats = (("q", q), ("k", k), ("v", v))
    else:
        floats = (("q", q), ("k_scale", k_scale), ("v_scale", v_scale))
        if k.dtype not in CODE_KINDS or v.dtype != k.dtype:
            raise ValueError("quantized k/v must both be int8 or "
                             "float8_e4m3fn, got %s, %s" %
                             (k.dtype, v.dtype))
        want = tuple(k.shape[:3])
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != want:
                raise ValueError("%s must be %s, got %s" %
                                 (name, want, tuple(t.shape)))
    for name, t in floats:
        if t.dtype != torch.float32:
            raise ValueError("%s must be float32, got %s" %
                             (name, t.dtype))
    operands = (q, k, v, key_mask) if k_scale is None else \
        (q, k, v, key_mask, k_scale, v_scale)
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError("operands on several devices: %s" %
                         sorted(map(str, devices)))


def _launch(fn, *args):
    """Calls the C entry point ``fn`` with ``args`` (tensors as their
    addresses) on the current stream of the first tensor's device, or
    raises."""
    lib = _library()
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*[
            a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args] + [stream])
    if err:
        raise RuntimeError(
            "decode_attention kernel launch failed: %s (CUDA error "
            "%d)" % (lib.veles_cuda_error_string(err).decode(), err))


def decode_attention(q, k, v, key_mask, k_scale=None, v_scale=None):
    """Flash-decode: returns ``(B, Sq, H, D)`` float32.  CPU tensors
    take the plain version; CUDA tensors launch B4 (adding one to
    ``decode_attention.launches``) or, given ``k_scale``/``v_scale``,
    B5 (adding one to ``decode_attention.quant_launches``) on the
    calling thread's current stream, or raise.  Past one split of
    ``KEYS_PER_SPLIT`` keys a second launch merges the splits; their
    partials come from the caching allocator."""
    _check(q, k, v, key_mask, k_scale, v_scale)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, key_mask, k_scale,
                                          v_scale)
    if q.device.type != "cuda":
        raise ValueError("decode_attention runs on cpu or cuda "
                         "tensors, not %s" % q.device)
    B, Sq, H, D = q.shape
    L = k.shape[1]
    nsplit = -(-L // KEYS_PER_SPLIT)
    q = q.contiguous()
    k = k.contiguous()
    v = v.contiguous()
    mask = key_mask.contiguous()
    o_part = torch.empty((B, H, nsplit, Sq, D), dtype=torch.float32,
                         device=q.device)
    lse_part = torch.empty((B, H, nsplit, Sq), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((B, Sq, H, D), dtype=torch.float32,
                      device=q.device)
    scale = 1.0 / (D ** 0.5)
    if k_scale is None:
        _launch("veles_decode_attention", q, k, v, mask, o_part,
                lse_part, out, B, Sq, L, H, D, scale)
    else:
        _launch("veles_decode_attention_quant", q, k, v,
                k_scale.contiguous(), v_scale.contiguous(), mask, o_part,
                lse_part, out, B, Sq, L, H, D, scale, CODE_KINDS[k.dtype])
    if k_scale is None:
        decode_attention.launches += 1
    else:
        decode_attention.quant_launches += 1
    return out


decode_attention.launches = 0
decode_attention.quant_launches = 0


# -- build and load -------------------------------------------------------

_lib = [None]
_lib_lock = threading.Lock()


def build():
    """Compiles ``csrc/decode_attention.cu`` (see :mod:`.nvcc`) unless
    its library exists; returns the library's path."""
    return nvcc.build(SOURCE)[0]


def _library():
    """The loaded kernel library, built on first use."""
    if _lib[0] is None:
        with _lib_lock:
            if _lib[0] is None:
                lib = ctypes.CDLL(build())
                vp, ci = ctypes.c_void_p, ctypes.c_int
                lib.veles_decode_attention.argtypes = [
                    vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                    ctypes.c_float, vp]
                lib.veles_decode_attention.restype = ci
                lib.veles_decode_attention_quant.argtypes = [
                    vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                    ci, ctypes.c_float, ci, vp]
                lib.veles_decode_attention_quant.restype = ci
                lib.veles_cuda_error_string.argtypes = [ci]
                lib.veles_cuda_error_string.restype = ctypes.c_char_p
                for fn in ("veles_decode_max_sq", "veles_decode_max_d",
                           "veles_decode_keys_per_split"):
                    getattr(lib, fn).restype = ci
                limits = (lib.veles_decode_max_sq(),
                          lib.veles_decode_max_d(),
                          lib.veles_decode_keys_per_split())
                if limits != (DECODE_MAX_Q, MAX_HEAD_DIM,
                              KEYS_PER_SPLIT):
                    raise RuntimeError(
                        "kernel library limits %s disagree with the "
                        "wrapper's %s" % (limits, (
                            DECODE_MAX_Q, MAX_HEAD_DIM,
                            KEYS_PER_SPLIT)))
                _lib[0] = lib
    return _lib[0]
