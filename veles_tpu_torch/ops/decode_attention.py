"""Flash-decode attention: a small query chunk against a long key table.

The port of the TPU kernel ``_decode_kernel``
(``veles_tpu/ops/pallas_attention.py``, launched by
``pallas_decode_attention``).  Four things live here:

* :func:`supports_decode` — the port's own geometry contract;
* :func:`decode_attention_reference` — the plain PyTorch version;
* :func:`decode_attention` — the wrapper: the plain version for CPU
  tensors, the hand-written CUDA kernel
  (``csrc/decode_attention.cu``) for CUDA tensors;
* ``decode_attention.launches`` — a plain integer, one more for every
  kernel launch, so a run can show that it went through the kernel.

The kernel is CUDA C++ for ``sm_90a``, built at first use with
``nvcc`` into a shared library with a plain C interface (loaded with
``ctypes``) under ``build/`` beside this file.  The build, a launch
error or a shape outside the contract raises: there is no path that
carries on without the kernel on a CUDA tensor.

Contract (:func:`supports_decode`): q ``(B, Sq, H, D)`` with
``1 <= Sq <= DECODE_MAX_Q``, k/v ``(B, L, H, D)`` with any ``L >= 1``
(a ragged tail is masked in the kernel, unlike the TPU kernel's
``L % 128 == 0``), ``D <= MAX_HEAD_DIM``, float32 throughout, and
``key_mask`` ``(B, Sq, L)`` bool, True = attend.  A row whose mask is
all False gets out = 0, as in the TPU kernel.
"""

import ctypes
import os
import threading

import torch

from . import nvcc

#: Past this many query rows a chunk is a prefill, served by the dense
#: path (the JAX package's ``DECODE_MAX_Q``).
DECODE_MAX_Q = 16
#: Largest head dim the kernel takes (one thread per element).
MAX_HEAD_DIM = 128
#: Keys each block of the kernel's first pass covers.
KEYS_PER_SPLIT = 64
#: The masked-score fill of the TPU kernel and the dense path.
NEG_INF = -1e30

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


def decode_attention_reference(q, k, v, key_mask):
    """The plain version: the dense masked softmax, written as the
    JAX package's paged block writes it (``export.py``
    ``_paged_block``) — scores scaled by 1/√D, masked slots at
    ``NEG_INF``, softmax, weighted sum.  A row whose mask is all False
    returns 0, the kernel's contract (the dense formula alone would
    average every value there; serving never builds such a row)."""
    D = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bqhk", q, k) / (D ** 0.5)
    scores = scores.masked_fill(~key_mask[:, :, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqhk,bkhd->bqhd", w, v)
    return out.masked_fill(~key_mask.any(-1)[:, :, None, None], 0.0)


def _check(q, k, v, key_mask):
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise ValueError("%s must be float32, got %s" %
                             (name, t.dtype))
    devices = {t.device for t in (q, k, v, key_mask)}
    if len(devices) != 1:
        raise ValueError("operands on several devices: %s" %
                         sorted(map(str, devices)))


def decode_attention(q, k, v, key_mask):
    """Flash-decode: returns ``(B, Sq, H, D)`` float32.  CPU tensors
    take :func:`decode_attention_reference`; CUDA tensors launch the
    kernel (adding one to ``decode_attention.launches``) on the
    calling thread's current stream, or raise."""
    _check(q, k, v, key_mask)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, key_mask)
    if q.device.type != "cuda":
        raise ValueError("decode_attention runs on cpu or cuda "
                         "tensors, not %s" % q.device)
    lib = _library()
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.veles_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            o_part.data_ptr(), lse_part.data_ptr(), out.data_ptr(),
            B, Sq, L, H, D, 1.0 / (D ** 0.5), stream)
    if err:
        raise RuntimeError(
            "decode_attention kernel launch failed: %s (CUDA error "
            "%d)" % (lib.veles_cuda_error_string(err).decode(), err))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


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
