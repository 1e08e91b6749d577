#!/usr/bin/env python3
"""Chip smoke check of the PyTorch/CUDA port (``veles_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's two paths once each, at the full width of the LM
bench geometry (embed 2048, 16 heads of dim 128, MLP 8192, 12 blocks,
vocab 16384, positional table / sequence 1024, random weights from a
numpy seed) — training the TinyLM workflow through the fused tick, and
serving an exported LM — in phases; any failure exits non-zero:

1. device — the card's name, count, and ``nvidia-smi`` name and power
   limit; no CUDA fails;
2. build — ``nvcc`` builds every kernel of both paths from the sources
   in the checkout, one process per source, all at once
   (``veles_tpu_torch/ops/csrc/decode_attention.cu`` — B4 — and
   ``flash_attention.cu`` — B1 forward, B2 dq, B3 dk/dv);
3. kernel check — each kernel's wrapper against its plain PyTorch
   version on the card, at the shapes its path gives it and at ragged
   and masked edge cases, within the stated tolerances;
4. kernel timing — kernel, plain version, one PyTorch library call
   computing the same function where there is one, and the least time
   the card could take;
5. training — builds the 12-block TinyLM (bench.py's --lm geometry,
   batch 8, per-block remat, bf16 activation stream, f32 attention
   operands, momentum SGD) on the card, runs one epoch of one
   validation and three train ticks through ``Launcher.run`` with the
   flash kernels, then each tick again from the same state through the
   plain attention (``attention_kernel="xla"``), and holds every
   tick's loss and the parameters after every train tick to the plain
   ticks, and each kernel's launch count to what the ticks imply; a
   planted error (dq, then dk, halved) must fail the parameter gate;
6. serving — writes the artifact, loads it on the card, starts the
   server with ``--warmup``, serves mixed concurrent ``/api/generate``
   requests over loopback HTTP through the paged engine, then a
   repeated prompt (prefix cache + copy-on-write);
7. serving checks — every answer token-identical to the port's
   ``generate(..., attend=decode_attention_reference)`` on the card,
   and the kernel's launch count equal to what the run implies;
8. exit — drains the server, prints the training and serving numbers
   and the kernels as JSON lines, the card's name and power limit, and
   ``{"ok": true, "device": {...}}`` last.
"""

import concurrent.futures
import gc
import json
import os
import shutil
import subprocess
import sys
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))

#: The LM bench geometry (bench.py's LM_* constants).
VOCAB, EMBED, HEADS, BLOCKS, HIDDEN, POSITIONS = (16384, 2048, 16, 12,
                                                  8192, 1024)
SEED = 20261017
MAX_BATCH, KV_BLOCK = 8, 16
#: First wave: concurrent prompts of mixed lengths; the second wave
#: repeats one (a multiple of the block size, so the whole prompt hits
#: the prefix cache and its last block is copied on write).
PROMPT_LENGTHS = (5, 12, 40, 200, 700, 48, 130)
REPEAT_INDEX = 5
MAX_NEW = 32
#: Kernel against plain version: float32 on both sides, only the order
#: of the sums differs.
RTOL, ATOL = 1e-5, 1e-5
#: H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, float32
#: outside the tensor cores, bfloat16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


def fail(msg):
    print("chip_smoke FAILED: %s" % msg, file=sys.stderr)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        fail("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def decode_inputs(B, Sq, H, D, L, gen, fully_masked_row=True):
    """Random q/k/v and a ragged causal-style key mask (each row sees a
    different prefix), with one fully masked query row."""
    import torch
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda")
    k = torch.randn((B, L, H, D), generator=gen, device="cuda")
    v = torch.randn((B, L, H, D), generator=gen, device="cuda")
    lens = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
    cols = torch.arange(L, device="cuda")
    rows = torch.arange(Sq, device="cuda")
    # Row r of batch b sees keys < lens[b] - (Sq - 1 - r), at least 1.
    limit = torch.clamp(lens[:, None] - (Sq - 1 - rows)[None, :], min=1)
    mask = cols[None, None, :] < limit[:, :, None]
    if fully_masked_row:
        mask[0, Sq - 1] = False
    return q, k, v, mask.contiguous()


def phase_build():
    """Phase 2: one nvcc per kernel source, all started together; the
    ptxas register, shared-memory and spill lines of each kernel."""
    from veles_tpu_torch.ops import nvcc
    from veles_tpu_torch.ops import decode_attention as DA
    from veles_tpu_torch.ops import flash_attention as FA
    t0 = time.monotonic()
    nvcc.build(DA.SOURCE, FA.SOURCE)
    print("build: %d sources for sm_90a in %.2f s" %
          (2, time.monotonic() - t0))
    for source in (DA.SOURCE, FA.SOURCE):
        info = nvcc.build_info[source]
        print("  %s: %.2f s (%s)" % (os.path.basename(source),
                                     info["seconds"],
                                     os.path.basename(info["path"])))
        for line in info["log"].splitlines():
            if "Compiling entry" in line:
                print("  ptxas:", line.split("'")[1][:100])
            elif "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())


def phase_kernels():
    """Phases 3-4 for the serving kernel (B4): check at every table
    width the engine reaches, time at the decode step's shape."""
    import torch
    from veles_tpu_torch.ops import decode_attention as DA
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, D = MAX_BATCH, HEADS, EMBED // HEADS
    widths = [KV_BLOCK * t for t in (1, 2, 4, 8, 16, 32, 64)] + [40]
    max_err = 0.0
    for Sq in (1, 16):
        for L in widths:
            q, k, v, mask = decode_inputs(B, Sq, H, D, L, gen)
            out = DA.decode_attention(q, k, v, mask)
            torch.cuda.synchronize()
            ref = DA.decode_attention_reference(q, k, v, mask)
            if not torch.isfinite(out).all():
                fail("kernel output not finite at Sq=%d L=%d" % (Sq, L))
            if out[0, Sq - 1].abs().max().item() != 0.0:
                fail("fully masked row not zero at Sq=%d L=%d" % (Sq, L))
            err = (out - ref).abs().max().item()
            max_err = max(max_err, err)
            if not torch.allclose(out, ref, rtol=RTOL, atol=ATOL):
                fail("decode_attention disagrees with its plain version "
                     "at Sq=%d L=%d: max abs err %.3g" % (Sq, L, err))
    print("kernel check: decode_attention == decode_attention_reference "
          "at B=%d H=%d D=%d Sq in (1, 16), L in %s, ragged masks and a "
          "fully masked row: max abs err %.3g (rtol %g, atol %g)" %
          (B, H, D, widths, max_err, RTOL, ATOL))
    timings = {}
    for Sq, L in ((1, POSITIONS), (16, POSITIONS), (1, 256)):
        q, k, v, mask = decode_inputs(B, Sq, H, D, L, gen,
                                      fully_masked_row=False)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        amask = mask[:, None]
        kernel_ms = cuda_ms(lambda: DA.decode_attention(q, k, v, mask))
        plain_ms = cuda_ms(
            lambda: DA.decode_attention_reference(q, k, v, mask))
        library_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=amask))
        n_bytes = 4 * (2 * B * Sq * H * D + 2 * B * L * H * D) + \
            B * Sq * L
        flops = 4 * B * H * Sq * L * D
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOP_PER_S * 1e3
        timings[(Sq, L)] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        print("kernel timing B=%d Sq=%d H=%d D=%d L=%d: kernel %.4f ms, "
              "plain %.4f ms, sdpa %.4f ms, bound %.4f ms (%s)" %
              ((B, Sq, H, D, L) + tuple(
                  timings[(Sq, L)][k] for k in (
                      "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_by"))))
    return max_err, timings


#: Flash kernels (B1-B3) against their plain versions.  The lse is
#: float32 in every pair and only its sum order differs: rtol = atol =
#: 1e-5.  float32 storage and operands: the same for every output.
#: Otherwise the outputs' last rounding (bfloat16 storage) or the
#: rounding of p and ds (bfloat16 operands) can flip by one bfloat16
#: ulp, at most 2^-7 of the value: rtol 2^-7, and an atol of 1e-2 of
#: the output's RMS for values near zero.  One exception: with bfloat16
#: operands the forward rounds each p at its key tile's running maximum
#: and the plain version at the row's, so every p may round apart, each
#: by at most 2^-8 of itself on either side; out = Σ p·v / l then
#: differs by at most 2^-7·(Σ p·|v|) / l, which the plain forward of
#: |v| gives: that bound (plus 1e-5) is its atol.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL, BF16_ATOL_RMS = 2.0 ** -7, 1e-2
BF16_TOL_TEXT = ("rtol 2^-7, atol 1e-2 x RMS (lse: rtol = atol = 1e-5; "
                 "out with bf16 operands: atol 2^-7 x plain(|v|))")
#: (name, B, Sq, Sk, H, D, flash kwargs); "slice" is the training shape.
FLASH_CASES = (
    ("causal", 2, 256, 256, 4, 128, dict(causal=True)),
    ("noncausal", 2, 200, 300, 4, 64, dict()),
    ("kv_len", 2, 130, 70, 3, 128, dict(kv_len=50)),
    ("offsets", 2, 64, 200, 2, 128,
     dict(causal=True, q_offset=100, k_offset=0)),
    ("masked_rows", 2, 64, 64, 2, 128,
     dict(causal=True, q_offset=0, k_offset=32)),
    ("ragged_1000", 1, 1000, 1000, 2, 128, dict(causal=True)),
    ("slice", 8, POSITIONS, POSITIONS, HEADS, EMBED // HEADS,
     dict(causal=True)),
)
#: (label, storage dtype, operand dtype); the training path runs bf16
#: storage (the bf16 activation stream) with f32 operands
#: (attention_dtype "f32").
FLASH_DTYPES = (("f32/f32", "float32", "float32"),
                ("bf16/f32", "bfloat16", "float32"),
                ("f32/bf16", "float32", "bfloat16"))
MAIN_DTYPES = "bf16/f32"


def flash_tolerance(label, output, want, abs_v_out):
    """(rtol, atol) of one output against its plain version; the atol
    of the forward's out with bf16 operands is a tensor.
    ``abs_v_out``: the plain forward of |v| (float32)."""
    if label == "f32/f32" or output == "lse":
        return F32_TOL["rtol"], F32_TOL["atol"]
    if output == "out" and label.endswith("/bf16"):
        return F32_TOL["rtol"], 2.0 ** -7 * abs_v_out + F32_TOL["atol"]
    return BF16_RTOL, BF16_ATOL_RMS * want.square().mean().sqrt().item()


def flash_inputs(B, Sq, Sk, H, D, dtype, gen):
    import torch
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda")
    k = torch.randn((B, Sk, H, D), generator=gen, device="cuda")
    v = torch.randn((B, Sk, H, D), generator=gen, device="cuda")
    do = torch.randn((B, Sq, H, D), generator=gen, device="cuda")
    dlse = torch.randn((B, Sq, H), generator=gen, device="cuda")
    return [t.to(dtype) for t in (q, k, v, do)] + [dlse]


def phase_flash_kernels():
    """Phases 3-4 for the training kernels (B1 forward, B2 dq, B3
    dk/dv): each against its plain version over the cases and dtype
    pairs above, with a non-zero lse cotangent; then timed at the
    training shape beside the plain versions and SDPA."""
    import torch
    from veles_tpu_torch.ops import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {}   # (dtype label, output) -> (max abs err, share of tol)
    slice_err = {}
    for label, storage, od in FLASH_DTYPES:
        storage, od = getattr(torch, storage), getattr(torch, od)
        for name, B, Sq, Sk, H, D, kw in FLASH_CASES:
            q, k, v, do, dlse = flash_inputs(B, Sq, Sk, H, D, storage,
                                             gen)
            out, lse = FA.flash_forward(q, k, v, operand_dtype=od, **kw)
            delta = (do.float() * out.float()).sum(-1) - dlse
            dq = FA.flash_dq(q, k, v, do, lse, delta, operand_dtype=od,
                             **kw)
            dk, dv = FA.flash_dkv(q, k, v, do, lse, delta,
                                  operand_dtype=od, **kw)
            torch.cuda.synchronize()
            ro, rl = FA.flash_attention_reference(q, k, v,
                                                  operand_dtype=od, **kw)
            rdq = FA.flash_attention_dq_reference(
                q, k, v, do, lse, delta, operand_dtype=od, **kw)
            rdk, rdv = FA.flash_attention_dkv_reference(
                q, k, v, do, lse, delta, operand_dtype=od, **kw)
            abs_v_out = FA.flash_attention_reference(
                q, k, v.abs(), operand_dtype=od, **kw)[0].float()
            outputs = (("flash_forward", "out", out, ro),
                       ("flash_forward", "lse", lse, rl),
                       ("flash_dq", "dq", dq, rdq),
                       ("flash_dkv", "dk", dk, rdk),
                       ("flash_dkv", "dv", dv, rdv))
            for kernel, output, got, want in outputs:
                got, want = got.float(), want.float()
                if not torch.isfinite(got).all():
                    fail("%s output %s not finite (%s, %s)" %
                         (kernel, output, name, label))
                rtol, atol = flash_tolerance(label, output, want,
                                             abs_v_out)
                diff = (got - want).abs()
                err = diff.max().item()
                share = (diff / (atol + rtol * want.abs())).max().item()
                if isinstance(atol, torch.Tensor):
                    atol = atol.max().item()   # for the message
                was = worst.get((label, output), (0.0, 0.0))
                worst[(label, output)] = (max(was[0], err),
                                          max(was[1], share))
                if name == "slice" and label == MAIN_DTYPES:
                    slice_err[kernel] = max(slice_err.get(kernel, 0.0),
                                            err)
                if not share <= 1.0:
                    fail("%s output %s disagrees with its plain version "
                         "(%s, %s): max abs err %.3g, %.3g of the "
                         "tolerance (rtol %g, atol %.3g)" % (
                             kernel, output, name, label, err, share,
                             rtol, atol))
            if name == "masked_rows":
                hidden = slice(0, kw["k_offset"])
                if out[:, hidden].abs().max().item() != 0.0 or \
                        not (lse[:, hidden] < -1e29).all():
                    fail("fully masked rows: out must be 0 and lse "
                         "finite near -1e30 (%s)" % label)
            del q, k, v, do, dlse, out, lse, dq, dk, dv, ro, rl, rdq
            del rdk, rdv, delta, abs_v_out
    print("kernel check: flash_forward/flash_dq/flash_dkv == plain "
          "versions over %s, storage/operands %s, non-zero lse "
          "cotangent; tolerance f32/f32 rtol = atol = 1e-5, otherwise "
          "%s:" % ([c[0] for c in FLASH_CASES],
                   [d[0] for d in FLASH_DTYPES], BF16_TOL_TEXT))
    for (label, output), (err, share) in sorted(worst.items()):
        print("  %s %-4s max abs err %.3g, largest share of the "
              "tolerance %.3g" % (label, output, err, share))
    return slice_err, flash_timings()


def flash_timings():
    """B1-B3 at the training shape (causal, bf16 storage, f32
    operands): kernel, plain version, SDPA, and the bound — the larger
    of the bytes each must move (3.35 TB/s) and the multiply-adds of
    the causal half: products of two bf16 values (q·kᵀ and dO·vᵀ, whose
    operands are the bf16 inputs) at the bf16 tensor-core rate
    (989 TFLOP/s) plus products with an f32 operand (p and ds) at the
    float32 rate outside the tensor cores (67 TFLOP/s)."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.ops import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    B, S, H, D = TRAIN_BATCH, POSITIONS, HEADS, EMBED // HEADS
    f32 = torch.float32
    q, k, v, do, _ = flash_inputs(B, S, S, H, D, torch.bfloat16, gen)
    out, lse = FA.flash_forward(q, k, v, causal=True, operand_dtype=f32)
    delta = (do.float() * out.float()).sum(-1)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        torch.autograd.grad(o, leaves, dot)

    pairs = int(FA._mask(S, S, True, 0, 0, None, "cpu").sum()) * B * H
    elem = B * S * H * D
    per_kernel = {
        # (FLOPs per attended pair on two bf16 operands, FLOPs per
        # pair with an f32 operand, bytes moved)
        "flash_forward": (2 * D, 2 * D, 2 * 4 * elem + 4 * B * S * H),
        "flash_dq": (4 * D, 2 * D, 2 * 5 * elem + 2 * 4 * B * S * H),
        "flash_dkv": (4 * D, 4 * D, 2 * 6 * elem + 2 * 4 * B * S * H),
    }
    runs = {
        "flash_forward": (
            lambda: FA.flash_forward(q, k, v, causal=True,
                                     operand_dtype=f32),
            lambda: FA.flash_attention_reference(q, k, v, causal=True,
                                                 operand_dtype=f32),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True)),
        "flash_dq": (
            lambda: FA.flash_dq(q, k, v, do, lse, delta, causal=True,
                                operand_dtype=f32),
            lambda: FA.flash_attention_dq_reference(
                q, k, v, do, lse, delta, causal=True, operand_dtype=f32),
            None),
        "flash_dkv": (
            lambda: FA.flash_dkv(q, k, v, do, lse, delta, causal=True,
                                 operand_dtype=f32),
            lambda: FA.flash_attention_dkv_reference(
                q, k, v, do, lse, delta, causal=True, operand_dtype=f32),
            None),
    }
    sdpa_fb_ms = cuda_ms(sdpa_fwd_bwd, iters=20, warmup=3)
    timings = {}
    for kernel, (fn, plain, library) in runs.items():
        bf16_per_pair, f32_per_pair, n_bytes = per_kernel[kernel]
        ops_ms = (bf16_per_pair * pairs / BF16_FLOP_PER_S +
                  f32_per_pair * pairs / F32_FLOP_PER_S) * 1e3
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        timings[kernel] = dict(
            kernel_ms=cuda_ms(fn, iters=20, warmup=3),
            plain_ms=cuda_ms(plain, iters=5, warmup=1),
            library_ms=cuda_ms(library, iters=20, warmup=3)
            if library is not None else None,
            sdpa_fwd_bwd_ms=sdpa_fb_ms,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            gflop_bf16=bf16_per_pair * pairs / 1e9,
            gflop_f32=f32_per_pair * pairs / 1e9, gbytes=n_bytes / 1e9)
        t = timings[kernel]
        print("kernel timing %s B=%d S=%d H=%d D=%d causal bf16/f32: "
              "kernel %.4f ms, plain %.4f ms, sdpa %s ms (fwd+bwd "
              "%.4f ms), bound %.4f ms (%s; %.1f GFLOP on two bf16 "
              "operands + %.1f GFLOP with an f32 operand, %.3f GB)" % (
                  kernel, B, S, H, D, t["kernel_ms"], t["plain_ms"],
                  "%.4f" % t["library_ms"] if t["library_ms"] is not None
                  else "n/a", sdpa_fb_ms, t["bound_ms"], t["bound_by"],
                  t["gflop_bf16"], t["gflop_f32"], t["gbytes"]))
    return timings


#: Training phase: one validation tick, then this many train ticks,
#: at bench.py's LM batch.
TRAIN_BATCH, TRAIN_TICKS = 8, 3
#: Each tick of the kernel run is held to a plain-attention tick run
#: from the SAME state (parameters, optimizer slots, accumulators) on
#: the same minibatch: the loss within rtol 1e-3, and after every train
#: tick each parameter tensor's gap (norm) within 0.1 of the norm of
#: that tick's change plus a floor of 1e-7 per sqrt(element).  Both runs
#: carry the bf16 activation stream; they differ only in the
#: attention's sum order, which can move a bf16 rounding of the
#: attention output by one ulp (2^-8), and the flips reach every
#: gradient.  Measured on an H100 at this geometry, the gap is at most
#: 4.7 % of the change for wq and wk (their gradients are the smallest,
#: change RMS ~6e-7 per tick) and under 2 % for every other tensor but
#: the k biases: the softmax is invariant to bk, whose gradient is zero
#: but for rounding — a gap of up to 3.1e-8 RMS, which the floor
#: covers.  Ticks start from the same state because at the bench's
#: learning rate the loss climbs over the first ticks, and a free
#: trajectory amplifies such flips from tick to tick.
TRAIN_LOSS_RTOL, TRAIN_CHANGE_TOL, TRAIN_FLOOR = 1e-3, 0.1, 1e-7
#: Planted faults show that the parameter gate sees a wrong dq or dk at
#: this width: the first train tick again with the kernels, once with
#: every dq and once with every dk halved, against the kernel run's
#: tick; every block's wq (for dq) and wk (for dk) must then fail the
#: gate.  (A 10 % error moves them by 11 % of their change, too close
#: to the 4.7 % noise for a gate with margin on both sides.)
PLANTED_SCALE = 0.5


def phase_training(smi):
    """Phase 5: the fused training tick at the full bench width, with
    the kernels (through ``Launcher.run``), then each tick again from
    the same state with the plain attention, then the first train tick
    with the planted dq and dk faults."""
    import math
    import numpy
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.ops import flash_attention as FA
    from veles_tpu_torch.znicz.samples.tinylm import (FirstTokenLoader,
                                                      TinyLMWorkflow)
    n_valid, n_train = TRAIN_BATCH, TRAIN_BATCH * TRAIN_TICKS

    class SyntheticCorpus(FirstTokenLoader):
        """bench.py's LM corpus: random tokens, next-token labels."""

        def load_data(self):
            rng = numpy.random.RandomState(0)
            self.original_data.mem = rng.randint(
                0, VOCAB, (n_valid + n_train, POSITIONS)).astype(
                numpy.int32)
            self.original_labels.mem = numpy.roll(
                self.original_data.mem, -1, axis=1)
            self.class_lengths = [0, n_valid, n_train]

    engine = root.common.engine
    engine.remat = True
    engine.precision_level = 0
    engine.attention_dtype = "f32"
    engine.attention_kernel = "auto"
    prng.reset()
    prng.get(0).seed(42)
    t0 = time.monotonic()
    launcher = Launcher()
    wf = TinyLMWorkflow(
        launcher, vocab_size=VOCAB, seq_len=POSITIONS, embed_dim=EMBED,
        n_heads=HEADS, n_blocks=BLOCKS, minibatch_size=TRAIN_BATCH,
        ticks_per_dispatch=1, max_epochs=1, loader_cls=SyntheticCorpus,
        loader_config={"validate_labels": False})
    launcher.initialize(device="cuda")
    compiler = wf.compiler
    compiler._ensure_compiled()
    n_params = sum(v.size for v in compiler._param_vecs.values())
    torch.cuda.synchronize()
    print("training: TinyLM %d blocks, embed %d, vocab %d, seq %d, "
          "batch %d, %.1fM parameters; host init + upload %.1f s" % (
              BLOCKS, EMBED, VOCAB, POSITIONS, TRAIN_BATCH,
              n_params / 1e6, time.monotonic() - t0))

    def state():
        """Host copies of every parameter and state tensor."""
        out = {n: v.devmem.to("cpu") for n, v in
               compiler._param_vecs.items()}
        out.update({n: v.devmem.to("cpu") for n, v in
                    compiler._state_vecs.items()})
        return out

    ticks = []   # (training, loss, seconds, state before, batch)
    execute = compiler.execute

    def timed_execute(training=True):
        before = state()
        batch = [v.mem.copy() for v in compiler.batch_vectors]
        torch.cuda.synchronize()
        start = time.monotonic()
        metrics = execute(training=training)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ticks.append((training, loss, time.monotonic() - start, before,
                      batch))
        return metrics

    compiler.execute = timed_execute
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.flash_forward.launches = FA.flash_dq.launches = \
        FA.flash_dkv.launches = 0
    launcher.run()
    torch.cuda.synchronize()
    launches = {"flash_forward": FA.flash_forward.launches,
                "flash_dq": FA.flash_dq.launches,
                "flash_dkv": FA.flash_dkv.launches}
    peak = torch.cuda.max_memory_allocated()
    compiler.execute = execute
    results = wf.gather_results()
    # The kernel run's state after each tick.
    afters = [t[3] for t in ticks[1:]] + [state()]

    classes = [t[0] for t in ticks]
    if classes != [False] + [True] * TRAIN_TICKS:
        fail("training ran ticks %s, expected one validation tick then "
             "%d train ticks" % (classes, TRAIN_TICKS))
    expected = {"flash_forward": BLOCKS * (1 + 2 * TRAIN_TICKS),
                "flash_dq": BLOCKS * TRAIN_TICKS,
                "flash_dkv": BLOCKS * TRAIN_TICKS}
    print("training: kernel launches %s (expected %s: per train tick %d "
          "forward = blocks + remat recomputes, %d dq, %d dk/dv; per "
          "validation tick %d forward)" % (
              launches, expected, 2 * BLOCKS, BLOCKS, BLOCKS, BLOCKS))
    if launches != expected:
        fail("flash kernels launched %s times, the ticks imply %s" %
             (launches, expected))

    device = next(iter(compiler._param_vecs.values())).devmem.device

    def restore(snapshot, batch):
        for n, v in list(compiler._param_vecs.items()) + \
                list(compiler._state_vecs.items()):
            v.devmem = snapshot[n].to(device)
        for vec, arr in zip(compiler.batch_vectors, batch):
            vec.mem = arr

    def compare(after, before):
        """name -> (gap, change, bound, elements): the parameters on
        the card against the kernel run's ``after``, and their change
        since ``before``."""
        rows = {}
        for name, vec in compiler._param_vecs.items():
            now = vec.devmem
            gap = (after[name].to(device) - now).norm().item()
            change = (now - before[name].to(device)).norm().item()
            rows[name] = (gap, change, TRAIN_CHANGE_TOL * change +
                          TRAIN_FLOOR * math.sqrt(now.numel()),
                          now.numel())
        return rows

    # Each tick again, from the same state, on the plain path.
    engine.attention_kernel = "xla"
    plain_losses, tick_rows = [], []
    for (training, _, _, before, batch), after in zip(ticks, afters):
        restore(before, batch)
        plain_losses.append(float(execute(training=training)["loss"]))
        if training:
            tick_rows.append(compare(after, before))
    # The first train tick again with the kernels and a planted fault:
    # the dq (dk) kernel's output, argument 8 of its launch, scaled.
    engine.attention_kernel = "auto"
    first = classes.index(True)
    launch = FA._launch
    planted = {}
    for fault, symbol in (("dq", "veles_flash_dq"),
                          ("dk", "veles_flash_dkv")):
        def planted_launch(fn, name, *args):
            launch(fn, name, *args)
            if fn == symbol:
                args[8].mul_(PLANTED_SCALE)

        restore(ticks[first][3], ticks[first][4])
        FA._launch = planted_launch
        try:
            execute(training=True)
        finally:
            FA._launch = launch
        planted[fault] = compare(afters[first], ticks[first][3])
    torch.cuda.synchronize()

    # Readings first, then the gates.
    losses = [t[1] for t in ticks]
    print("training: losses with the kernels %s, plain attention from "
          "the same state %s, ln(vocab) %.4f" % (
              ["%.5f" % x for x in losses],
              ["%.5f" % x for x in plain_losses], math.log(VOCAB)))

    def family(name):
        return name.split("/")[-1] if name.startswith("block") else name

    def rms(norm, n):
        return norm / math.sqrt(n)

    fam = {}   # family -> [min change RMS, max gap RMS, max gap/change]
    for rows in tick_rows:
        for name, (gap, change, _, n) in rows.items():
            f = fam.setdefault(family(name), [math.inf, 0.0, 0.0])
            f[0] = min(f[0], rms(change, n))
            f[1] = max(f[1], rms(gap, n))
            f[2] = max(f[2], gap / max(change, 1e-30))
    print("training readings per parameter family over the %d train "
          "ticks (kernel vs plain from the same state): min change RMS "
          "/ max gap RMS / max gap over change" % len(tick_rows))
    for name, (c, g, r) in sorted(fam.items()):
        print("  %-8s %.3g / %.3g / %.3g" % (name, c, g, r))
    planted_rows = {}
    for fault, rows in planted.items():
        target = {"dq": "wq", "dk": "wk"}[fault]
        hit = [(name, row) for name, row in rows.items()
               if family(name) == target]
        planted_rows[fault] = {
            "target": target, "tensors": len(hit),
            "min_gap_over_bound": min(r[0] / r[2] for _, r in hit),
            "min_gap_over_change": min(r[0] / max(r[1], 1e-30)
                                       for _, r in hit),
            "min_gap_rms": min(rms(r[0], r[3]) for _, r in hit),
            "flagged_tensors": sum(r[0] > r[2] for r in rows.values()),
        }
        print("training: planted fault, every %s x %g on the first train "
              "tick: %s" % (fault, PLANTED_SCALE, planted_rows[fault]))

    for i, (lk, lp) in enumerate(zip(losses, plain_losses)):
        if not (math.isfinite(lk) and math.isfinite(lp)):
            fail("tick %d loss not finite: kernel %r, plain %r" %
                 (i, lk, lp))
        if abs(lk - lp) > TRAIN_LOSS_RTOL * abs(lp):
            fail("tick %d loss: kernel %.6f vs plain %.6f (rtol %g)" %
                 (i, lk, lp, TRAIN_LOSS_RTOL))
    if losses[0] < math.log(VOCAB) - 0.1:
        fail("first-tick loss %.4f below ln(vocab) = %.4f: a random "
             "model cannot beat chance on random next tokens" %
             (losses[0], math.log(VOCAB)))
    worst, worst_name, floored = 0.0, None, set()
    for i, rows in enumerate(tick_rows):
        for name, (gap, change, bound, n) in rows.items():
            if TRAIN_FLOOR * math.sqrt(n) > TRAIN_CHANGE_TOL * change:
                floored.add(name)   # the floor is the larger term
            if gap / bound > worst:
                worst, worst_name = gap / bound, "%s (train tick %d)" % (
                    name, i + 1)
            if not gap <= bound:
                fail("parameter %s after train tick %d: kernel vs plain "
                     "gap %.3g > %.3g (the tick's change %.3g)" % (
                         name, i + 1, gap, bound, change))
    for fault, row in planted_rows.items():
        if row["tensors"] != BLOCKS or not row["min_gap_over_bound"] > 1:
            fail("the parameter gate does not see every %s x %g: %s" %
                 (fault, PLANTED_SCALE, row))
    print("training check: %d ticks, every loss within rtol %g of the "
          "plain-attention tick from the same state; after every train "
          "tick every parameter within %g of that tick's change + %g/"
          "sqrt(element) (largest share of the bound %.3g, %s; %d "
          "tensors where the floor is the larger term: %s); planted "
          "dq and dk faults fail the gate in every block's wq and wk" % (
              len(ticks), TRAIN_LOSS_RTOL, TRAIN_CHANGE_TOL, TRAIN_FLOOR,
              worst, worst_name, len(floored), sorted(floored)))
    train_s = [t[2] for t in ticks if t[0]]
    numbers = {
        "losses": losses,
        "plain_losses": plain_losses,
        "ln_vocab": math.log(VOCAB),
        "train_tick_s": train_s,
        "train_tick_p50_s": float(numpy.median(train_s)),
        "validation_tick_s": ticks[0][2],
        "tokens_per_s": TRAIN_BATCH * POSITIONS * len(train_s) /
        sum(train_s),
        "peak_bytes": peak,
        "worst_param_gap_over_bound": worst,
        "worst_param": worst_name,
        "params_floored": sorted(floored),
        "param_families": fam,
        "planted": planted_rows,
        "decision": results,
    }
    print("training readings on %s (smoke, not a benchmark): train "
          "ticks %s s (p50 %.3f s), validation tick %.3f s, %.0f "
          "tokens/s over the train ticks, peak device memory %.2f GB" % (
              smi, ["%.3f" % x for x in train_s],
              numbers["train_tick_p50_s"], numbers["validation_tick_s"],
              numbers["tokens_per_s"], peak / 1e9))
    del ticks, afters
    return launches, numbers


def post(url, body, timeout=600):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def phase_serving(workdir, smi):
    """Phases 5-6: returns (launches, numbers)."""
    import numpy
    import torch
    from veles_tpu_torch import export as X
    from veles_tpu_torch.ops import decode_attention as DA
    from veles_tpu_torch.restful import ModelServer
    path = os.path.join(workdir, "lm.veles.tgz")
    t0 = time.monotonic()
    X.random_lm_artifact(path, VOCAB, EMBED, HEADS, BLOCKS, HIDDEN,
                         POSITIONS, seed=SEED, compresslevel=1)
    print("artifact write: %.1f s (%.2f GB, gzip level 1)" %
          (time.monotonic() - t0, os.path.getsize(path) / 1e9))
    t0 = time.monotonic()
    model = X.ExportedModel(path, device="cuda")
    model._lm_params()
    torch.cuda.synchronize()
    print("artifact load to cuda: %.1f s" % (time.monotonic() - t0))
    os.remove(path)

    # Count the device calls whose attention the kernel serves: every
    # paged step, and every extend whose chunk has <= DECODE_MAX_Q rows.
    calls = {"step": 0, "short_extend": 0}
    paged_step, paged_extend = model.paged_step, model.paged_extend

    def counted_step(*args):
        calls["step"] += 1
        return paged_step(*args)

    def counted_extend(pool, tables, tokens, *args):
        if tokens.shape[1] <= DA.DECODE_MAX_Q:
            calls["short_extend"] += 1
        return paged_extend(pool, tables, tokens, *args)

    model.paged_step, model.paged_extend = counted_step, counted_extend
    rng = numpy.random.RandomState(SEED % (1 << 31))
    prompts = [rng.randint(0, VOCAB, n).tolist() for n in PROMPT_LENGTHS]
    # --warmup, as a latency-minded deployment runs: the bucket grid
    # once through (first-call costs: kernel loading, cuBLAS set-up,
    # allocator growth), before the counts are zeroed.
    server = ModelServer(model, host="127.0.0.1", port=0,
                         max_batch=MAX_BATCH, kv_block_size=KV_BLOCK,
                         deadline=600.0, warmup=True)
    t0 = time.monotonic()
    server.start()
    torch.cuda.synchronize()
    print("server warmup: %.1f s" % (time.monotonic() - t0))
    base = "http://127.0.0.1:%d" % server.port
    try:
        if get(base + "/health")["status"] != "ok":
            fail("/health not ok")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        DA.decode_attention.launches = 0
        calls.update(step=0, short_extend=0)
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
            futs = [ex.submit(post, base + "/api/generate",
                              {"tokens": [p], "max_new_tokens": MAX_NEW})
                    for p in prompts]
            answers = [f.result()["generated"][0] for f in futs]
        wave_s = time.monotonic() - t0
        answers.append(post(base + "/api/generate", {
            "tokens": [prompts[REPEAT_INDEX]],
            "max_new_tokens": MAX_NEW})["generated"][0])
        launches = DA.decode_attention.launches
        peak = torch.cuda.max_memory_allocated()
        stats = get(base + "/stats")
    finally:
        server.stop(drain=True)
    model.paged_step, model.paged_extend = paged_step, paged_extend
    expected = BLOCKS * (calls["step"] + calls["short_extend"])
    print("serving: %d paged steps, %d short extends, kernel launches "
          "%d (expected %d = %d layers x calls)" % (
              calls["step"], calls["short_extend"], launches, expected,
              BLOCKS))
    if launches != expected or launches == 0:
        fail("decode kernel launched %d times, the run implies %d" %
             (launches, expected))
    pool = stats["kv_pool"]
    if pool["prefix_hits"] < 1 or pool["cow_copies"] < 1:
        fail("repeated prompt did not hit the prefix cache with a "
             "copy-on-write: %s" % pool)
    all_prompts = prompts + [prompts[REPEAT_INDEX]]
    for i, (prompt, got) in enumerate(zip(all_prompts, answers)):
        full, logits = model.generate(
            numpy.asarray([prompt]), MAX_NEW,
            attend=DA.decode_attention_reference, return_logits=True)
        if not numpy.isfinite(logits).all():
            fail("oracle logits not finite for request %d" % i)
        want = full[0, len(prompt):].tolist()
        if got != want:
            j = next(j for j in range(MAX_NEW) if got[j] != want[j])
            top2 = numpy.sort(logits[0, j])[-2:]
            fail("request %d (prompt %d tokens) diverges from the plain-"
                 "attention oracle at generated position %d: served %d, "
                 "oracle %d, oracle top-2 logit margin %.3g" % (
                     i, len(prompt), j, got[j], want[j],
                     top2[1] - top2[0]))
    print("serving check: %d answers token-identical to generate(attend="
          "decode_attention_reference) on the card" % len(answers))
    n_tokens = MAX_NEW * len(prompts)
    ttft = stats["latency"].get("ttft.generate", {})
    numbers = {
        "wave_tok_per_s": n_tokens / wave_s,
        "wave_seconds": wave_s,
        # One wave of a few requests: the window's p50 is the median
        # and its p99 the largest TTFT, with no percentile meaning.
        "ttft_median_ms": ttft.get("p50_ms"),
        "ttft_largest_ms": ttft.get("p99_ms"),
        "itl_p50_ms": stats["latency"].get("itl.decode", {})
        .get("p50_ms"),
        "peak_bytes": peak,
    }
    print("smoke-wave readings on %s (one wave, not a benchmark): %d "
          "concurrent requests, %d tokens in %.3f s = %.1f tok/s over "
          "the wave; TTFT median %s ms, largest %s ms; decode step p50 "
          "%s ms; peak device memory %.2f GB" % (
              smi, len(prompts), n_tokens, wave_s,
              numbers["wave_tok_per_s"], numbers["ttft_median_ms"],
              numbers["ttft_largest_ms"], numbers["itl_p50_ms"],
              peak / 1e9))
    return launches, numbers


def main():
    if not os.path.isdir(os.path.join(HERE, "veles_tpu_torch")):
        fail("veles_tpu_torch/ not found beside chip_smoke.py — run it "
             "from the root of a checkout")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card (torch %s)" % torch.__version__)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    print("device: %s x%d (torch %s, CUDA %s); nvidia-smi: %s" % (
        kind, count, torch.__version__, torch.version.cuda, smi))
    from veles_tpu_torch.backends import resolve_device
    resolve_device("cuda")  # TF32 off, as every port entry point sets
    phase_build()
    max_err, timings = phase_kernels()
    flash_err, flash_times = phase_flash_kernels()
    flash_launches, training = phase_training(smi)
    gc.collect()
    torch.cuda.empty_cache()
    workdir = os.path.join(HERE, ".chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        launches, numbers = phase_serving(workdir, smi)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    step = timings[(1, POSITIONS)]
    kernels = {"kernels": [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "veles_tpu_torch/ops/csrc/decode_attention.cu",
        "replaces": "veles_tpu/ops/pallas_attention.py:616",
        "shape": "B=%d Sq=1 H=%d D=%d L=%d f32" % (
            MAX_BATCH, HEADS, EMBED // HEADS, POSITIONS),
        "launches": launches,
        "max_abs_err": max_err,
        "max_err": max_err,
        "tol": {"rtol": RTOL, "atol": ATOL},
        "ms": step["kernel_ms"],
        "kernel_ms": step["kernel_ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"],
        "library_ms": step["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
    }]}
    replaces = {"flash_forward": 211, "flash_dq": 258, "flash_dkv": 293}
    for name, line in replaces.items():
        t = flash_times[name]
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "veles_tpu/ops/pallas_attention.py:%d" % line,
            "shape": "B=%d S=%d H=%d D=%d causal, bf16 storage, f32 "
                     "operands" % (TRAIN_BATCH, POSITIONS, HEADS,
                                   EMBED // HEADS),
            "launches": flash_launches[name],
            "max_abs_err": flash_err[name],
            "tol": BF16_TOL_TEXT,
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention"
                       " (forward)" if t["library_ms"] is not None
                       else None,
            "sdpa_fwd_bwd_ms": t["sdpa_fwd_bwd_ms"],
        })
    print(json.dumps({"training": training}))
    print(json.dumps({"serving": numbers}))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
