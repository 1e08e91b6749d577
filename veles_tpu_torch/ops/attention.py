"""Attention ops (the JAX package's ``ops.attention``, single device).

* :func:`attention` — full attention over (B, S, H, D), the reference
  formulation;
* :func:`blockwise_attention` — the same with a streaming softmax over
  key blocks and the ``kv_len`` padding bound;
* the dispatch: under ``root.common.engine.attention_kernel`` "auto"
  (the default) or "pallas", CUDA tensors run the hand-written CUDA
  kernels (B1 forward, B2/B3 backward) with the matmul operand dtype
  of ``attention_dtype``, and a geometry outside their contract
  (``flash_attention.supports``) raises; "xla", and every CPU tensor,
  take the plain formulation below.

Both plain formulations share one streaming-softmax block update: the
running max and normalizer are always float32; the score/probability
tensors and the output accumulator are in the ``attention_dtype``
("f32" default, or "bf16"); every product multiplies its (rounded)
operands in float32, as the JAX package's
``preferred_element_type=float32`` does.

Sequence parallelism over a mesh's seq axis (``torch.distributed``):

* :func:`ring_attention` — the k/v shards go round the ring by
  point-to-point while each step folds the held chunk into the local
  queries through :func:`ring_step`, the flash chunk contract (B1–B3 at
  global offsets on the card), or the plain streaming update under
  ``sp_ring_kernel`` "xla";
* :func:`ulysses_attention` — two ``all_to_all``s around a local
  attention over a subset of heads;
* :func:`sequence_parallel_attention` — either, from inside a step.
"""

import torch

from ..config import root, get as config_get

NEG_INF = -1e30

#: Valid sequence-parallel strategies.
SP_MODES = ("ring", "ulysses")

#: Valid attention-kernel dispatch modes.
KERNEL_MODES = ("xla", "pallas", "auto")
DEFAULT_KERNEL_MODE = "auto"
#: Default ring-kernel mode of sequence-parallel attention.
DEFAULT_RING_KERNEL_MODE = "auto"


def init_parser(parser):
    """The attention flags of the command line (handed to
    ``root.common.engine`` by ``__main__``).  The JAX package's
    ``--attn-decode-kernel`` has no counterpart: a CUDA tensor takes the
    decode kernels or raises, so the command line refuses it."""
    parser.add_argument(
        "--attn-fused-qkv", default=None, choices=("on", "off"),
        help="compute q/k/v with one (E, 3E) projection per transformer "
             "block instead of three (E, E) ones")
    parser.add_argument(
        "--attn-dtype", default=None, choices=("f32", "bf16"),
        help="dtype of the score/probability tensors and the output "
             "accumulator of the training attention")
    parser.add_argument(
        "--attn-kernel", default=None, choices=KERNEL_MODES,
        help="training attention: 'auto' and 'pallas' take the flash "
             "kernels on CUDA tensors (or raise), 'xla' the plain "
             "attention on any device")
    parser.add_argument(
        "--sp-ring-kernel", default=None, choices=KERNEL_MODES,
        help="sequence-parallel ring: 'pallas'/'auto' (default) run each "
             "ring step through the flash kernels on the held k/v shard "
             "at global causal offsets, merging partials by lse; 'xla' "
             "the plain streaming update")


def attention_compute_dtype(precision=None):
    """The score/accumulator dtype: the explicit ``precision`` wins,
    else ``root.common.engine.attention_dtype`` ("f32" default).
    Unknown strings raise."""
    if precision is None:
        precision = config_get(root.common.engine.attention_dtype, "f32")
    if isinstance(precision, torch.dtype):
        return precision
    if precision == "bf16":
        return torch.bfloat16
    if precision == "f32":
        return torch.float32
    raise ValueError("unknown attention dtype %r — valid: 'f32', "
                     "'bf16' (or a torch dtype)" % (precision,))


def _kernel_mode():
    mode = str(config_get(root.common.engine.attention_kernel,
                          DEFAULT_KERNEL_MODE))
    if mode not in KERNEL_MODES:
        raise ValueError("unknown attention kernel mode %r — valid: "
                         "%s" % (mode, list(KERNEL_MODES)))
    return mode


def _try_kernel(q, k, v, causal, kv_len=None, mode=None,
                precision=None):
    """Runs the flash kernels for CUDA tensors unless the mode is
    "xla"; returns None (→ the plain formulation) for "xla" and for CPU
    tensors.  On the card the kernel launches or raises — a geometry
    outside the kernels' contract included."""
    if (mode or _kernel_mode()) == "xla" or q.device.type != "cuda":
        return None
    from . import flash_attention as FA
    return FA.flash_attention(
        q, k, v, causal=causal, kv_len=kv_len,
        operand_dtype=attention_compute_dtype(precision))


def _block_update(acc, m, l, q, k, v, scale, mask=None):
    """One streaming-softmax update: folds the (q·kᵀ) scores of a
    key/value block into the running (acc, m, l).  q (B, Sq, H, D);
    k/v (B, Sk, H, D); acc (B, Sq, H, D) in the compute dtype; m/l
    (B, Sq, H) float32; ``mask`` (Sq, Sk) True = attend."""
    dt = acc.dtype
    scores = (torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) *
              scale).to(dt)
    if mask is not None:
        scores = scores.masked_fill(~mask[None, :, None, :], NEG_INF)
    block_max = scores.amax(dim=-1).float()
    new_m = torch.maximum(m, block_max)
    correction = torch.exp(m - new_m)
    p = torch.exp(scores - new_m[..., None].to(dt))
    if mask is not None:
        # Guards the fully masked row, where new_m itself is NEG_INF.
        p = p.masked_fill(~mask[None, :, None, :], 0.0)
    new_l = l * correction + p.sum(dim=-1, dtype=torch.float32)
    pv = torch.einsum("bqhk,bkhd->bqhd", p.float(), v.to(dt).float())
    new_acc = (acc.float() * correction[..., None] + pv).to(dt)
    return new_acc, new_m, new_l


def _finish(acc, l, dtype):
    return (acc.float() / l.clamp_min(1e-30)[..., None]).to(dtype)


def _causal_mask(sq, sk, q_offset, k_offset, device):
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = k_offset + torch.arange(sk, device=device)[None, :]
    return qpos >= kpos


def _init(q, dt):
    B, S, H, D = q.shape
    return (torch.zeros((B, S, H, D), dtype=dt, device=q.device),
            torch.full((B, S, H), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((B, S, H), dtype=torch.float32, device=q.device))


def attention(q, k, v, causal=False, precision=None, kernel=None):
    """Full attention over (B, S, H, D).  ``precision``: None → the
    ``attention_dtype`` knob; "f32"/"bf16" forces.  ``kernel``: None →
    the ``attention_kernel`` knob; "xla" forces the plain
    formulation."""
    out = _try_kernel(q, k, v, causal, mode=kernel, precision=precision)
    if out is not None:
        return out
    dt = attention_compute_dtype(precision)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    mask = _causal_mask(q.shape[1], k.shape[1], 0, 0, q.device) \
        if causal else None
    acc, m, l = _block_update(*_init(q, dt), q, k, v, scale, mask)
    return _finish(acc, l, q.dtype)


def blockwise_attention(q, k, v, block_size=128, causal=False,
                        kv_len=None, precision=None, kernel=None):
    """Flash-style attention: a loop over key/value blocks with the
    streaming accumulator.  ``kv_len`` masks keys at positions >=
    kv_len (the padding contract).  ``precision``/``kernel`` as in
    :func:`attention`."""
    out = _try_kernel(q, k, v, causal, kv_len=kv_len, mode=kernel,
                      precision=precision)
    if out is not None:
        return out
    dt = attention_compute_dtype(precision)
    B, S, H, D = q.shape
    if S % block_size:
        raise ValueError("sequence %d not divisible by block %d" %
                         (S, block_size))
    scale = 1.0 / (D ** 0.5)
    acc, m, l = _init(q, dt)
    for k_off in range(0, S, block_size):
        cols = slice(k_off, k_off + block_size)
        mask = _causal_mask(S, block_size, 0, k_off, q.device) \
            if causal else None
        if kv_len is not None:
            kvalid = (k_off + torch.arange(block_size, device=q.device)
                      < kv_len)[None, :].expand(S, block_size)
            mask = kvalid if mask is None else mask & kvalid
        acc, m, l = _block_update(acc, m, l, q, k[:, cols], v[:, cols],
                                  scale, mask)
    return _finish(acc, l, q.dtype)


def _ring_kernel_mode():
    mode = str(config_get(root.common.engine.sp_ring_kernel,
                          DEFAULT_RING_KERNEL_MODE))
    if mode not in KERNEL_MODES:
        raise ValueError("unknown ring kernel mode %r — valid: %s" %
                         (mode, list(KERNEL_MODES)))
    return mode


def ring_step(carry, q, k, v, causal, q_offset, k_offset, operand_dtype):
    """The ring-flash step body: folds the held k/v chunk (B, Sk, H, D)
    of the sequence positions from ``k_offset`` into the local queries'
    running ``(out, lse)`` carry (None starts one), through the chunk
    contract of :mod:`.flash_attention` — B1 forward at the global
    offsets, B2/B3 in the backward, the lse cotangent of the merge
    included.  The carry is held float32."""
    from . import flash_attention as FA
    return FA.flash_resume(carry, q, k, v, causal=causal,
                           q_offset=q_offset, k_offset=k_offset,
                           operand_dtype=operand_dtype)


def ring_attention(q, k, v, group, causal=False, kernel=None,
                   precision=None):
    """Sequence-parallel attention over the ranks of ``group``: each
    holds its (B, S/N, H, D) shard; N ring steps hand the k/v shard to
    the next rank (``collectives.shift``, point-to-point) while folding
    the arriving chunk — the one from rank ``rank − step`` — into the
    local queries at global offsets ``rank·S/N`` and ``src·S/N``.

    ``kernel``: None → the ``sp_ring_kernel`` knob ("auto" default);
    "pallas"/"auto" run every step through :func:`ring_step` (the flash
    kernels on CUDA tensors, which launch or raise; their plain chunk on
    CPU tensors), "xla" the plain streaming-softmax update.  The
    backward is autograd's: each step's chunk recomputes from its lse,
    the shifts run reversed."""
    from ..parallel import collectives as C
    mode = kernel if kernel is not None else _ring_kernel_mode()
    if mode not in KERNEL_MODES:
        raise ValueError("unknown ring kernel mode %r — valid: %s" %
                         (mode, list(KERNEL_MODES)))
    n, rank = C.group_size(group), C.group_rank(group)
    B, Sq, H, D = q.shape
    dt = attention_compute_dtype(precision)
    kr, vr = k, v
    if mode != "xla":
        carry = None
        for step in range(n):
            src = (rank - step) % n
            carry = ring_step(carry, q, kr, vr, causal, rank * Sq,
                              src * Sq, dt)
            if step != n - 1:
                kr, vr = C.shift(kr, group), C.shift(vr, group)
        return carry[0].to(q.dtype)
    scale = 1.0 / (D ** 0.5)
    acc, m, l = _init(q, dt)
    for step in range(n):
        src = (rank - step) % n
        mask = _causal_mask(Sq, kr.shape[1], rank * Sq, src * Sq,
                            q.device) if causal else None
        acc, m, l = _block_update(acc, m, l, q, kr, vr, scale, mask)
        if step != n - 1:
            kr, vr = C.shift(kr, group), C.shift(vr, group)
    return _finish(acc, l, q.dtype)


def ulysses_attention(q, k, v, group, causal=False):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses) over
    ``group``: one ``all_to_all`` re-shards (B, S/N, H, D) to
    (B, S, H/N, D) — the whole sequence, a subset of heads — the local
    attention runs (:func:`_gathered_attention`), and the reverse
    ``all_to_all`` restores the sequence shards.  Needs H % N == 0."""
    from ..parallel import collectives as C
    n = C.group_size(group)
    H = q.shape[2]
    if H % n:
        raise ValueError("ulysses needs heads (%d) divisible by the "
                         "sequence-axis size (%d)" % (H, n))

    def to_heads(x):
        return C.all_to_all(x, 2, 1, group)

    out = _gathered_attention(to_heads(q), to_heads(k), to_heads(v),
                              causal)
    return C.all_to_all(out, 1, 2, group)


#: Above this gathered length the local attention streams blockwise.
ULYSSES_DENSE_MAX = 1024


def _gathered_attention(q, k, v, causal):
    """Local attention over the Ulysses-gathered activations: dense up
    to ``ULYSSES_DENSE_MAX``, else blockwise at the largest dividing
    block size, padding to a block multiple (``kv_len`` masks the
    padded keys) when none divides."""
    S = q.shape[1]
    if S <= ULYSSES_DENSE_MAX:
        return attention(q, k, v, causal=causal)
    for bs in (512, 384, 256, 128, 64):
        if S % bs == 0:
            return blockwise_attention(q, k, v, block_size=bs,
                                       causal=causal)
    bs = 512
    pad = (-S) % bs
    padded = [torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
              for x in (q, k, v)]
    out = blockwise_attention(*padded, block_size=bs, causal=causal,
                              kv_len=S)
    return out[:, :S]


def sequence_parallel_attention(q, k, v, mesh, seq_axis, causal=False,
                                mode="ring", kernel=None):
    """Sequence-parallel attention inside a step under ``mesh``: q, k, v
    are this rank's (B, S, H, D) — its batch and head shards, the whole
    sequence, which every rank of the seq axis computes alike — so the
    rank takes its S/N slice, runs ``mode`` ("ring" →
    :func:`ring_attention`, "ulysses" → :func:`ulysses_attention`) over
    the seq axis's group, and all-gathers the outputs back along the
    sequence.  ``kernel`` reaches the ring only."""
    from ..parallel import collectives as C
    modes = {"ring": ring_attention, "ulysses": ulysses_attention}
    if mode not in modes:
        raise ValueError("unknown sequence-parallel mode %r — valid: %s"
                         % (mode, sorted(modes)))
    group = mesh.group(seq_axis)
    n = mesh.shape[seq_axis]
    S = q.shape[1]
    if S % n:
        raise ValueError("sequence %d does not divide over %d ranks of "
                         "axis %r" % (S, n, seq_axis))
    r = mesh.axis_index(seq_axis)
    shard = [x.narrow(1, r * (S // n), S // n) for x in (q, k, v)]
    kw = {"kernel": kernel} if mode == "ring" else {}
    out = modes[mode](*shard, group, causal=causal, **kw)
    return C.all_gather(out, 1, group)
