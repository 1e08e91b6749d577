#!/usr/bin/env python3
"""Chip smoke check of the PyTorch/CUDA port (``veles_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's four paths once each, at full width — training
the TinyLM workflow through the fused tick and serving an exported LM,
both at the LM bench geometry (embed 2048, 16 heads of dim 128, MLP
8192, 12 blocks, vocab 16384, positional table / sequence 1024),
training the full-width ungrouped AlexNet through ``StandardWorkflow``
(227 px, 1000 classes, batch 512), and serving the same LM from int8
KV planes with int8 weights, speculative decoding and a hot reload —
with random weights from a seed, in phases; any failure exits
non-zero:

1. device — the card's name, count, and ``nvidia-smi`` name and power
   limit; no CUDA fails;
2. build — ``nvcc`` builds every kernel of the four paths from the
   sources in the checkout, one process per source, all at once
   (``veles_tpu_torch/ops/csrc/decode_attention.cu`` — B4, B5 —,
   ``flash_attention.cu`` — B1-B3 of the f32/f32 pair on the FP32
   units —, ``flash_attention_tc.cu`` — B1 forward, B2 dq and B3 dk/dv
   on the tensor cores — and
   ``lrn.cu`` — B6 LRN forward, B7 LRN backward);
3. kernel check — each kernel's wrapper against its plain PyTorch
   version on the card, at the shapes its path gives it and at ragged,
   masked and (LRN) strong-constant edge cases (B4 also at D = 70 and
   72, B5 at D = 72),
   within the stated tolerances; planted LRN and B5 faults must be
   flagged; B5 on codes must equal B4 on the dequantized table, and a
   B4/B5 row must not depend on Sq, on B or on masked keys past its
   table, bit for bit; B6/B7 run each case on both routes (register and
   wide), which must agree bit for bit, and an input at a storage
   offset must take the wide route;
4. kernel timing — kernel, plain version, one PyTorch library call
   computing the same function where there is one, and the least time
   the card could take (B4/B5 and both LRN routes: device time of a CUDA
   graph of launches rotating among input copies of more than twice the
   L2; B4/B5 also the host's time per call; a reading above its bound
   fails);
5. training — builds the 12-block TinyLM (bench.py's --lm geometry,
   batch 8, per-block remat, bf16 activation stream, f32 attention
   operands, momentum SGD) on the card, runs one epoch of one
   validation and three train ticks through ``Launcher.run`` with the
   flash kernels, then each tick again from the same state through the
   plain attention (``attention_kernel="xla"``), and holds every
   tick's loss and the parameters after every train tick to the plain
   ticks, and each kernel's launch count to what the ticks imply; a
   planted error (dq, then dk, halved) must fail the parameter gate;
6. AlexNet — ``AlexNetWorkflow`` (ImagenetLoader's synthetic set cut
   to 1536 train + 512 validation images, mean-disp normalizer,
   bfloat16 stream, momentum SGD with decay) runs one validation and
   three train ticks through ``Launcher.run`` with the LRN kernels, then
   each tick again from the same state (dropout masks included) with
   the plain LRN (``pallas_lrn = False``); losses, parameters and the
   LRN launch counts are held as in phase 5, every LRN launch must take
   the register route, a planted B7 fault must fail the gate, and one
   warm tick is profiled;
7. serving — writes the artifact, loads it on the card, starts the
   server with ``--warmup``, serves mixed concurrent ``/api/generate``
   requests over loopback HTTP through the paged engine, then a
   repeated prompt (prefix cache + copy-on-write), whose first logits
   must equal its first serving's bit for bit;
8. serving checks — every answer token-identical to the port's
   ``generate(..., attend=decode_attention_reference)`` on the card,
   and the kernel's launch count equal to what the run implies; the
   same wave with ``--spec`` (verify chunks through B4) answers the
   same tokens;
9. quantized serving — a second artifact (another seed) is written;
   the first is served with ``--kv-dtype int8 --weight-dtype int8
   --spec --warmup`` (and once without ``--spec``) to the mixed wave
   plus prompts that repeat themselves; every device call of the run is
   replayed with the plain quant attention on the same planes and must
   answer as served; the ``--spec`` answers must equal those without;
   B5 launches once per block for every step, every verify column and
   every short extend row; then ``POST /admin/reload`` swaps in the
   second artifact: version 2, the int8 weights re-quantized, the calls
   after it replayed the same way, and two more prompt sets answer the
   same with and without ``--spec``; one fp8 pass goes through the
   model API alone, and a verify on the int8 and fp8 planes must answer
   and store what plain steps do, bit for bit; on every plane served (f32,
   int8, and fp8 through the model API) a whole-prompt prefix-cache hit
   must compute its first logits, token and last-position k/v as the
   prompt's first serving did, bit for bit;
10. exit — drains the servers, prints the training, AlexNet and serving
   numbers and the kernels as JSON lines, the command's time, the
   card's name and power limit, and ``{"ok": true, "device": {...}}``
   last.
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
    from veles_tpu_torch.ops import lrn as L
    sources = (DA.SOURCE, FA.SOURCE, FA.TC_SOURCE, L.SOURCE)
    t0 = time.monotonic()
    nvcc.build(*sources)
    print("build: %d sources for sm_90a in %.2f s" %
          (len(sources), time.monotonic() - t0))
    for source in sources:
        info = nvcc.build_info[source]
        print("  %s: %.2f s (%s)" % (os.path.basename(source),
                                     info["seconds"],
                                     os.path.basename(info["path"])))
        log = info["log"].splitlines()
        for line in log:
            if "Compiling entry" in line:
                print("  ptxas:", line.split("'")[1][:100])
            elif "Used" in line or "spill" in line or "C7520" in line:
                print("  ptxas:", line.strip())
        # C7519: a warpgroup.arrive the compiler added before a wgmma
        # that reads registers (information, not a serialization).
        print("  ptxas: %d C7519 and %d C7520 (wgmma serialized) "
              "notes" % (sum("C7519" in x for x in log),
                         sum("C7520" in x for x in log)))


#: The H100's L2 cache: a table that fits in it is read from the L2, not
#: from device memory, by every launch after the first on the same inputs.
L2_BYTES = 50e6
#: The decode kernels' main-path geometry: the serving batch, the LM's
#: heads and head dim.
DECODE_B, DECODE_H, DECODE_D = MAX_BATCH, HEADS, EMBED // HEADS


def cold_ms(fn, args, n_bytes, iters=60, warmup=3):
    """Device time of one ``fn(*args)``, L2-proof: CUDA events around the
    replay of a CUDA graph of ``iters`` launches that rotate among copies
    of ``args`` (each tensor cloned) holding more than twice the L2
    together (``n_bytes`` each), so no launch finds its inputs in the L2
    where the launches before it left them.  The graph keeps the host's
    cost per call (the wrapper's checks, allocations and launch, tens of
    microseconds) out of the reading: back-to-back calls from Python
    would time the host wherever it is slower than the kernel."""
    import torch
    n_sets = max(2, int(2 * L2_BYTES // n_bytes) + 1)
    sets = [args] + [tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args) for _ in range(n_sets - 1)]
    rounds = -(-iters // n_sets)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(warmup):
            fn(*sets[i % n_sets])
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(rounds):
            for one in sets:
                fn(*one)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph, sets
    return start.elapsed_time(end) / (rounds * n_sets)


def host_us(fn, args, calls=200):
    """The host's time per ``fn(*args)`` call in microseconds, launches
    queued without waiting for the card (what a caller pays per call
    on its own thread)."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def decode_timing(plane, Sq, L, gen, plain=True, library=True):
    """B4 (``plane`` "f32") or B5 ("int8", "fp8") at B=8, H=16, D=128,
    ``Sq`` query rows over an ``L``-key table, timed by :func:`cold_ms`
    beside (B5) B4 on the same keys as f32, the plain version and one
    PyTorch call (SDPA; for B5 dequantize + SDPA: no one call computes
    it); and the bound: the bytes the call must move (q, k/v — B5: the
    codes and the per-position scales, the layout it is given —, the
    mask, the output) at 3.35 TB/s against its float32 operations
    (4·Sq·D per key and head; B5 plus the 2·D dequantizing multiplies)
    at 67 TFLOP/s.  ``share`` is bound / time: above 1 the timer or the
    bound is wrong."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.ops import decode_attention as DA
    B, H, D = DECODE_B, DECODE_H, DECODE_D
    if plane == "f32":
        args = decode_inputs(B, Sq, H, D, L, gen, fully_masked_row=False)
        n_bytes = 4 * (2 * B * Sq * H * D + 2 * B * L * H * D) + B * Sq * L
        ops = 4 * B * H * Sq * L * D
    else:
        dtype_name, qmax = {c[0]: c[1:] for c in QUANT_CODES}[plane]
        args = quant_inputs(B, Sq, H, D, L, getattr(torch, dtype_name),
                            qmax, gen)
        args[3][0, Sq - 1] = True   # no empty row when timing
        n_bytes = (2 * B * L * H * D + 2 * 4 * B * L * H +
                   2 * 4 * B * Sq * H * D + B * Sq * L)
        ops = 4 * B * H * Sq * L * D + 2 * B * L * H * D
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    row = dict(kernel_ms=cold_ms(DA.decode_attention, args, n_bytes),
               host_us=host_us(DA.decode_attention, args),
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               mbytes=n_bytes / 1e6)
    row["share"] = row["bound_ms"] / row["kernel_ms"]

    def sdpa(q, k, v, mask, k_scale=None, v_scale=None):
        if k_scale is not None:
            k, v = DA.dequantize(k, k_scale), DA.dequantize(v, v_scale)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None])

    if plane != "f32":
        q, kc, vc, mask, ks, vs = args
        row["b4_f32_ms"] = cold_ms(
            DA.decode_attention, (q, DA.dequantize(kc, ks),
                                  DA.dequantize(vc, vs), mask),
            4 * (2 * B * Sq * H * D + 2 * B * L * H * D) + B * Sq * L)
    if plain:
        row["plain_ms"] = cold_ms(DA.decode_attention_reference, args,
                                  n_bytes, iters=10, warmup=1)
    if library:
        row["library_ms"] = cold_ms(sdpa, args, n_bytes)
    del args
    return row


def timing_line(name, plane, Sq, L, row):
    """One kernel-timing line; fails on a share of the bound over 1."""
    print("kernel timing %s %s B=%d Sq=%d H=%d D=%d L=%d (L2-proof, "
          "graph replay): kernel %.4f ms (%.1f%% of its bound; the host "
          "%.1f us per call)%s%s%s, bound %.4f ms (%s; %.2f MB)" % (
              name, plane, DECODE_B, Sq, DECODE_H, DECODE_D, L,
              row["kernel_ms"], 100 * row["share"], row["host_us"],
              ", B4 on the same keys as f32 %.4f ms" % row["b4_f32_ms"]
              if "b4_f32_ms" in row else "",
              ", plain %.4f ms" % row["plain_ms"] if "plain_ms" in row
              else "",
              ", %s %.4f ms" % ("sdpa" if plane == "f32" else
                                "dequantize + sdpa", row["library_ms"])
              if "library_ms" in row else "",
              row["bound_ms"], row["bound_by"], row["mbytes"]))
    if not row["share"] <= 1.0:
        fail("%s %s Sq=%d L=%d reads %.1f%% of its bound: the timer or "
             "the bound is wrong" % (name, plane, Sq, L,
                                     100 * row["share"]))


def phase_kernels():
    """Phases 3-4 for the serving kernel (B4): check at every table
    width the engine reaches, a ragged one, at D = 72 (f32 rows of 288
    bytes: the 16-byte copy path at a head dim under 128) and at D = 70
    (rows of 280 bytes: the scalar copy path); time at the decode step's
    and the 16-row chunk's shapes and over a 256-key table."""
    import torch
    from veles_tpu_torch.ops import decode_attention as DA
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, H = DECODE_B, DECODE_H
    widths = [KV_BLOCK * t for t in (1, 2, 4, 8, 16, 32, 64)] + [40, 1000]
    cases = [(DECODE_D, Sq, L) for Sq in (1, 16) for L in widths] + \
        [(D, Sq, L) for D in (72, 70) for Sq in (1, 16) for L in (40, 1000)]
    max_err = 0.0
    for D, Sq, L in cases:
        q, k, v, mask = decode_inputs(B, Sq, H, D, L, gen)
        out = DA.decode_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = DA.decode_attention_reference(q, k, v, mask)
        if not torch.isfinite(out).all():
            fail("kernel output not finite at D=%d Sq=%d L=%d" %
                 (D, Sq, L))
        if out[0, Sq - 1].abs().max().item() != 0.0:
            fail("fully masked row not zero at D=%d Sq=%d L=%d" %
                 (D, Sq, L))
        err = (out - ref).abs().max().item()
        max_err = max(max_err, err)
        if not torch.allclose(out, ref, rtol=RTOL, atol=ATOL):
            fail("decode_attention disagrees with its plain version at "
                 "D=%d Sq=%d L=%d: max abs err %.3g" % (D, Sq, L, err))
    print("kernel check: decode_attention == decode_attention_reference "
          "at B=%d H=%d, D=%d with Sq in (1, 16), L in %s, and D in (72, "
          "70: the scalar copy path) with L in (40, 1000); ragged masks "
          "and a fully masked row: max abs "
          "err %.3g (rtol %g, atol %g)" %
          (B, H, DECODE_D, widths, max_err, RTOL, ATOL))
    timings = {}
    for Sq, L in ((1, POSITIONS), (16, POSITIONS), (1, 256)):
        timings[(Sq, L)] = row = decode_timing("f32", Sq, L, gen)
        timing_line("B4", "f32", Sq, L, row)
    return max_err, timings


#: B5 (the quantized flash-decode kernel) against its plain version,
#: dequantize-then-B4's reference: float32 arithmetic on both sides on
#: exactly the same dequantized values (code · scale), only the order of
#: the sums differs — B4's tolerance.  Shapes: the decode step (Sq = 1)
#: and the short chunks an extend of at most 16 tokens sends through B5
#: (5: the wave's shortest prompt; 16: the widest), over the full table
#: and a ragged one.
QUANT_SQ, QUANT_L = (1, 5, 16), (POSITIONS, 1000)
QUANT_CODES = (("int8", "int8", 127.0), ("fp8", "float8_e4m3fn", 448.0))


def quant_inputs(B, Sq, H, D, L, code_dtype, qmax, gen):
    """q, codes and (B, L, H) scales as the pool hands them to B5:
    normal float32 keys and values quantized per (block of KV_BLOCK
    positions, head) at scale amax / qmax, so every block and head holds
    a code at ±qmax, and the scale broadcast over the block's positions;
    block 1 of every row then gets scale 0 over its nonzero codes.  The
    key mask is ragged with one fully masked query row."""
    import torch
    q, k, v, mask = decode_inputs(B, Sq, H, D, L, gen)
    n_blocks = -(-L // KV_BLOCK)

    def quantize(x):
        pad = torch.zeros((B, n_blocks * KV_BLOCK - L, H, D),
                          device="cuda")
        blocks = torch.cat([x, pad], 1).view(B, n_blocks, KV_BLOCK, H, D)
        scale = blocks.abs().amax(dim=(2, 4)) / qmax   # (B, n_blocks, H)
        c = (blocks / scale[:, :, None, :, None]).clamp(-qmax, qmax)
        if code_dtype == torch.int8:
            c = torch.round(c)
        c = c.reshape(B, -1, H, D)[:, :L].to(code_dtype)
        if n_blocks > 1:
            scale[:, 1] = 0.0
        return c, scale.repeat_interleave(KV_BLOCK, dim=1)[:, :L]

    (kc, ks), (vc, vs) = quantize(k), quantize(v)
    return q, kc, vc, mask, ks, vs


def share_of_tol(got, want):
    """The largest |got − want| / (atol + rtol·|want|) (B4's tolerance):
    at most 1 passes."""
    return ((got - want).abs() / (ATOL + RTOL * want.abs())).max().item()


def phase_quant_kernels():
    """Phases 3-4 for B5: int8 and fp8 codes against
    decode_attention_quant_reference at B=8, H=16, D=128, Sq in
    QUANT_SQ, L in QUANT_L, and at D=72 (code rows of 72 bytes: the
    scalar copy path) with Sq
    in (1, 16), L in (40, 1000); planted faults (k's and v's scales
    swapped, codes read with no scale, fp8 read as e5m2) must be
    flagged; B5 on the codes must equal B4 on the dequantized table, bit
    for bit; a row's result must not depend on Sq, L past its mask or B
    (:func:`row_invariance`); then timed at the decode step's and the
    verify chunk's shapes (:func:`decode_timing`)."""
    import torch
    from veles_tpu_torch.ops import decode_attention as DA
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    B, H = DECODE_B, DECODE_H
    cases = [(DECODE_D, Sq, L) for Sq in QUANT_SQ for L in QUANT_L] + \
        [(72, Sq, L) for Sq in (1, 16) for L in (40, 1000)]
    worst, faults, b4_equal = {}, {}, {}
    for label, dtype_name, qmax in QUANT_CODES:
        code_dtype = getattr(torch, dtype_name)
        for D, Sq, L in cases:
            q, kc, vc, mask, ks, vs = quant_inputs(
                B, Sq, H, D, L, code_dtype, qmax, gen)
            out = DA.decode_attention(q, kc, vc, mask, k_scale=ks,
                                      v_scale=vs)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail("B5 output not finite (%s, D=%d, Sq=%d, L=%d)" %
                     (label, D, Sq, L))
            if out[0, Sq - 1].abs().max().item() != 0.0:
                fail("B5: fully masked row not zero (%s, D=%d, Sq=%d, "
                     "L=%d)" % (label, D, Sq, L))
            ref = DA.decode_attention_quant_reference(q, kc, vc, mask,
                                                      ks, vs)
            share = share_of_tol(out, ref)
            err = (out - ref).abs().max().item()
            was = worst.get(label, (0.0, 0.0))
            worst[label] = (max(was[0], err), max(was[1], share))
            if not share <= 1.0:
                fail("B5 (%s) disagrees with its plain version at "
                     "D=%d Sq=%d L=%d: max abs err %.3g, %.3g of the "
                     "tolerance" % (label, D, Sq, L, err, share))
            # B4 on the dequantized table: the same arithmetic.
            b4 = DA.decode_attention(q, DA.dequantize(kc, ks),
                                     DA.dequantize(vc, vs), mask)
            b4_equal[(label, D, Sq, L)] = bool(torch.equal(out, b4))
            planted = {
                "scales_swapped": DA.decode_attention_quant_reference(
                    q, kc, vc, mask, vs, ks),
                "no_scale": DA.decode_attention_quant_reference(
                    q, kc, vc, mask, torch.ones_like(ks),
                    torch.ones_like(vs)),
            }
            if label == "fp8":
                planted["read_as_e5m2"] = \
                    DA.decode_attention_quant_reference(
                        q, kc.view(torch.float8_e5m2),
                        vc.view(torch.float8_e5m2), mask, ks, vs)
            for name, bad in planted.items():
                key = "%s %s" % (label, name)
                faults[key] = min(faults.get(key, float("inf")),
                                  share_of_tol(out, bad))
            del q, kc, vc, mask, ks, vs, out, ref, b4, planted
    print("kernel check: decode_attention (B5) == "
          "decode_attention_quant_reference at B=%d H=%d, D=%d with Sq in "
          "%s, L in %s, and D=72 with Sq in (1, 16), L in (40, 1000); "
          "int8 and fp8 codes with ±qmax, a zero-scale block, ragged masks "
          "and a fully masked row (rtol %g, atol %g): %s" % (
              B, H, DECODE_D, QUANT_SQ, QUANT_L, RTOL, ATOL, ", ".join(
                  "%s max abs err %.3g (share %.3g)" % (k, v[0], v[1])
                  for k, v in sorted(worst.items()))))
    print("  B5 on codes == B4 on the dequantized table, bit for bit: "
          "%d of %d shapes" % (sum(b4_equal.values()), len(b4_equal)))
    print("planted B5 faults (smallest share of the tolerance over the "
          "shapes; > 1 = flagged): %s" % ", ".join(
              "%s %.3g" % kv for kv in sorted(faults.items())))
    for name, share in faults.items():
        if not share > 1.0:
            fail("planted fault %s passes the B5 check (share %.3g)" %
                 (name, share))
    for key, same in sorted(b4_equal.items()):
        if not same:
            fail("B5 on the codes differs from B4 on the dequantized "
                 "table (%s, D=%d, Sq=%d, L=%d)" % key)
    rows = row_invariance(gen)
    timings = {}
    for label, _, _ in QUANT_CODES:
        for Sq in (1, 16):
            timings[(label, Sq)] = row = decode_timing(label, Sq, POSITIONS,
                                                       gen)
            timing_line("B5", label, Sq, POSITIONS, row)
    return worst, faults, b4_equal, rows, timings


#: Table widths of the L-invariance gate, each against twice itself.
INVARIANCE_L = (256, 512, 1000)


def row_invariance(gen):
    """A row's result must depend only on its q row, its mask row and the
    keys it attends, bit for bit, for B4 (f32) and B5 (int8, fp8) at
    B=8, H=16, D=128:

    * Sq — every row of an Sq=16 launch (L=POSITIONS) equals the row
      launched alone (Sq=1): the f32 verify chunk against plain steps;
    * L — every row of an Sq=16 launch over L keys equals the same row
      over 2L keys whose last L (random keys) are masked, L in (256,
      512, 1000): table widths round up to power-of-two buckets, and
      256 against 512 crosses from one split (written directly) to two
      (merged);
    * B — the rows of each batch launched alone (B=1) equal the same
      rows of the B=8 launch: the engine pads batches.

    Returns the counts of equal rows per plane."""
    import torch
    from veles_tpu_torch.ops import decode_attention as DA
    B, H, D, Sq = DECODE_B, DECODE_H, DECODE_D, 16

    def inputs(label, L):
        if label == "f32":
            q, k, v, mask = decode_inputs(B, Sq, H, D, L, gen,
                                          fully_masked_row=False)
            return q, k, v, mask, None, None
        dtype_name, qmax = {c[0]: c[1:] for c in QUANT_CODES}[label]
        return quant_inputs(B, Sq, H, D, L, getattr(torch, dtype_name),
                            qmax, gen)

    def attend(q, k, v, mask, ks, vs):
        return DA.decode_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), mask.contiguous(),
                                   k_scale=None if ks is None else
                                   ks.contiguous(),
                                   v_scale=None if vs is None else
                                   vs.contiguous())

    counts = {}
    for label in ("f32",) + tuple(c[0] for c in QUANT_CODES):
        q, k, v, mask, ks, vs = inputs(label, POSITIONS)
        wide = attend(q, k, v, mask, ks, vs)
        sq_same = sum(bool(torch.equal(attend(
            q[:, r:r + 1], k, v, mask[:, r:r + 1], ks, vs)[:, 0],
            wide[:, r])) for r in range(Sq))
        b_same = sum(bool(torch.equal(attend(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], mask[b:b + 1],
            None if ks is None else ks[b:b + 1],
            None if vs is None else vs[b:b + 1]), wide[b:b + 1]))
            for b in range(B))
        l_same = 0
        for L in INVARIANCE_L:
            q, k, v, mask, ks, vs = inputs(label, 2 * L)
            mask[:, :, L:] = False
            long = attend(q, k, v, mask, ks, vs)
            short = attend(q, k[:, :L], v[:, :L], mask[:, :, :L],
                           None if ks is None else ks[:, :L],
                           None if vs is None else vs[:, :L])
            l_same += sum(bool(torch.equal(short[:, r], long[:, r]))
                          for r in range(Sq))
        torch.cuda.synchronize()
        counts[label] = {"sq": sq_same, "l": l_same, "b": b_same}
        name = "B4" if label == "f32" else "B5 " + label
        l_rows = len(INVARIANCE_L) * Sq
        if (sq_same, l_same, b_same) != (Sq, l_rows, B):
            fail("%s: rows not invariant bit for bit — Sq %d/%d, L %d/%d, "
                 "B %d/%d" % (name, sq_same, Sq, l_same, l_rows, b_same, B))
    print("kernel check: rows bit-identical however they are launched, at "
          "B=%d H=%d D=%d — Sq (each row of a 16-row launch alone), L (a "
          "row at L vs 2L with the extra keys masked, L in %s), B "
          "(each batch alone vs B=8): %s" % (B, H, D, INVARIANCE_L, ", ".join(
              "%s Sq %d/16 L %d/%d B %d/8" % (
                  "B4" if k == "f32" else "B5 " + k, c["sq"], c["l"],
                  len(INVARIANCE_L) * 16, c["b"])
              for k, c in counts.items())))
    return counts


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
    ("d72", 2, 200, 200, 3, 72, dict(causal=True)),
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
    return slice_err, phase_flash_split(), flash_timings()


#: Split-sensitive inputs (B, S, H, D, non-causal): the products with
#: an f32 operand nearly cancel, so the rounding of p or ds to one bf16
#: term (2^-9 of each) shows far above the bf16/f32 tolerance, while
#: the three-term split keeps f32 precision.  "cancel_v": tiny scores
#: (q ~ 0.01), v and dO of constant magnitude alternating in sign over
#: keys and query rows: out = Σ p·v / l and dv = Σ p·dO cancel.
#: "cancel_q": q = ±q0 alternating over rows (q0 ~ 0.001), v = dO = 1
#: and an lse cotangent of 1, so ds = p·scale and dk = Σ ds·q cancels.
#: "cancel_k": k = ±k0 alternating over keys, tiny q (~ 0.001), v = dO =
#: 1 and an lse cotangent of 1, so dq = Σ ds·k cancels.
SPLIT_SHAPE = (2, 256, 2, 64)
#: The kernel that computes each output.
SPLIT_KERNEL = {"out": "flash_forward", "lse": "flash_forward",
                "dq": "flash_dq", "dk": "flash_dkv", "dv": "flash_dkv"}
#: The outputs a one-term rounding of p or ds moves out of tolerance.
SPLIT_FAULTED = {"cancel_v": ("out", "dv"), "cancel_q": ("dk",),
                 "cancel_k": ("dq",)}


def split_inputs(kind, gen):
    import torch
    B, S, H, D = SPLIT_SHAPE
    sign = (1.0 - 2.0 * (torch.arange(S, device="cuda") % 2))[
        None, :, None, None].expand(B, S, H, D)
    k = torch.randn((B, S, H, D), generator=gen, device="cuda")
    if kind == "cancel_v":
        q = 0.01 * torch.randn((B, S, H, D), generator=gen, device="cuda")
        v = do = sign
        dlse = torch.randn((B, S, H), generator=gen, device="cuda")
    else:
        if kind == "cancel_q":
            q = sign * 0.001 * torch.randn((B, 1, H, D), generator=gen,
                                           device="cuda")
        else:
            q = 0.001 * torch.randn((B, S, H, D), generator=gen,
                                    device="cuda")
            k = sign * k[:, :1]
        v = do = torch.ones((B, S, H, D), device="cuda")
        dlse = torch.ones((B, S, H), device="cuda")
    return [t.to(torch.bfloat16).contiguous() for t in (q, k, v, do)] + \
        [dlse]


def phase_flash_split():
    """The three-term split against a planted one-term fault, on the
    split-sensitive inputs: the kernels (bf16 storage, f32 operands)
    must pass the bf16/f32 check of every output, and the plain
    versions with bf16 operands — exactly what a kernel that rounds p
    and ds to one bf16 term returns — must fail it for out and dv
    ("cancel_v"), dk ("cancel_q") and dq ("cancel_k").  Returns
    {(kind, output): (kernel's share of the tolerance, the fault's)}."""
    import torch
    from veles_tpu_torch.ops import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    f32, bf16 = torch.float32, torch.bfloat16
    shares = {}
    for kind in SPLIT_FAULTED:
        q, k, v, do, dlse = split_inputs(kind, gen)
        out, lse = FA.flash_forward(q, k, v, operand_dtype=f32)
        delta = (do.float() * out.float()).sum(-1) - dlse
        dq = FA.flash_dq(q, k, v, do, lse, delta, operand_dtype=f32)
        dk, dv = FA.flash_dkv(q, k, v, do, lse, delta, operand_dtype=f32)
        torch.cuda.synchronize()
        want, faults = {}, {}
        want["out"], want["lse"] = FA.flash_attention_reference(
            q, k, v, operand_dtype=f32)
        want["dq"] = FA.flash_attention_dq_reference(
            q, k, v, do, lse, delta, operand_dtype=f32)
        want["dk"], want["dv"] = FA.flash_attention_dkv_reference(
            q, k, v, do, lse, delta, operand_dtype=f32)
        faults["out"], faults["lse"] = FA.flash_attention_reference(
            q, k, v, operand_dtype=bf16)
        faults["dq"] = FA.flash_attention_dq_reference(
            q, k, v, do, lse, delta, operand_dtype=bf16)
        faults["dk"], faults["dv"] = FA.flash_attention_dkv_reference(
            q, k, v, do, lse, delta, operand_dtype=bf16)
        got = dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)
        abs_v_out = FA.flash_attention_reference(
            q, k, v.abs(), operand_dtype=f32)[0].float()
        for output in ("out", "lse", "dq", "dk", "dv"):
            w = want[output].float()
            rtol, atol = flash_tolerance(MAIN_DTYPES, output, w, abs_v_out)

            def share(x):
                return ((x.float() - w).abs() /
                        (atol + rtol * w.abs())).max().item()

            shares[(kind, output)] = (share(got[output]),
                                      share(faults[output]))
    print("split check (%s, B=%d S=%d H=%d D=%d non-causal, bf16 storage, "
          "f32 operands): largest share of the bf16/f32 tolerance, kernel "
          "/ plain version with one bf16 term (the planted fault):" % (
              "cancel_v: v and dO alternate in sign; cancel_q: q alternates"
              " in sign; cancel_k: k alternates in sign", *SPLIT_SHAPE))
    for (kind, output), (kern, fault) in sorted(shares.items()):
        print("  %s %-4s kernel %.3g, fault %.3g" % (kind, output, kern,
                                                     fault))
    for (kind, output), (kern, fault) in shares.items():
        if not kern <= 1.0:
            fail("flash %s on the split-sensitive inputs (%s) disagrees "
                 "with its plain version: %.3g of the tolerance" % (
                     output, kind, kern))
    for kind, faulted in SPLIT_FAULTED.items():
        for output in faulted:
            if not shares[(kind, output)][1] > 1.0:
                fail("the bf16/f32 check does not see p or ds rounded to "
                     "one bf16 term: %s (%s) at %.3g of the tolerance" % (
                         output, kind, shares[(kind, output)][1]))
    return shares


def flash_timings():
    """B1-B3 at the training shape (causal, bf16 storage, f32
    operands): kernel, plain version, SDPA, and the bound — the larger
    of the bytes each must move (3.35 TB/s) and the products of the
    causal half on the bf16 tensor cores (989 TFLOP/s): a product of two
    bf16 values (q·kᵀ and dO·vᵀ, whose operands are the bf16 inputs)
    once, a product with an f32 operand (p or ds) as three bf16 products
    (the f32 value split into hi, mid and lo bf16 terms, each product
    exact in f32) — the least work that keeps the f32 operand's
    precision on the tensor cores.  Then B1 with bf16 operands beside
    SDPA's forward, which rounds p to bf16 as well: the like-for-like
    library comparison, checked against its plain version first."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.ops import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    B, S, H, D = TRAIN_BATCH, POSITIONS, HEADS, EMBED // HEADS
    f32, bf16 = torch.float32, torch.bfloat16
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

    def bound(bf16_flop, f32_flop, n_bytes):
        ops_ms = (bf16_flop + 3 * f32_flop) / BF16_FLOP_PER_S * 1e3
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        return (max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes")

    sdpa_fb_ms = cuda_ms(sdpa_fwd_bwd, iters=20, warmup=3)
    timings = {}
    for kernel, (fn, plain, library) in runs.items():
        bf16_per_pair, f32_per_pair, n_bytes = per_kernel[kernel]
        bound_ms, bound_by = bound(bf16_per_pair * pairs,
                                   f32_per_pair * pairs, n_bytes)
        timings[kernel] = dict(
            kernel_ms=cuda_ms(fn, iters=20, warmup=3),
            plain_ms=cuda_ms(plain, iters=5, warmup=1),
            library_ms=cuda_ms(library, iters=20, warmup=3)
            if library is not None else None,
            sdpa_fwd_bwd_ms=sdpa_fb_ms, bound_ms=bound_ms,
            bound_by=bound_by,
            gflop_bf16=bf16_per_pair * pairs / 1e9,
            gflop_f32=f32_per_pair * pairs / 1e9, gbytes=n_bytes / 1e9)
        t = timings[kernel]
        t["share_of_bound"] = t["bound_ms"] / t["kernel_ms"]
        print("kernel timing %s B=%d S=%d H=%d D=%d causal bf16/f32: "
              "kernel %.4f ms (%.1f%% of its bound), plain %.4f ms, sdpa "
              "%s ms (fwd+bwd %.4f ms), bound %.4f ms (%s; %.1f GFLOP on "
              "two bf16 operands + %.1f GFLOP with an f32 operand, each "
              "counted as three bf16 tensor-core products; %.3f GB)" % (
                  kernel, B, S, H, D, t["kernel_ms"],
                  100 * t["share_of_bound"], t["plain_ms"],
                  "%.4f" % t["library_ms"] if t["library_ms"] is not None
                  else "n/a", sdpa_fb_ms, t["bound_ms"], t["bound_by"],
                  t["gflop_bf16"], t["gflop_f32"], t["gbytes"]))

    # B2 on the FP32 units (flash_attention.cu, the f32/f32 route) on
    # the same values in f32 storage: with f32 operands the function the
    # tensor-core kernel computes.
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    t = timings["flash_dq"]
    t["fp32_units_ms"] = cuda_ms(lambda: FA.flash_dq(
        qf, kf, vf, dof, lse, delta, causal=True, operand_dtype=f32),
        iters=5, warmup=1)
    del qf, kf, vf, dof
    fwd_bwd = sum(timings[n]["kernel_ms"] for n in timings)
    print("kernel timing flash_dq on the FP32 units (f32 storage of the "
          "same values, f32/f32): %.4f ms against %.4f ms on the tensor "
          "cores (%.1fx); B1 + B2 + B3 %.4f ms beside SDPA's forward + "
          "backward %.4f ms" % (t["fp32_units_ms"], t["kernel_ms"],
                                 t["fp32_units_ms"] / t["kernel_ms"],
                                 fwd_bwd, sdpa_fb_ms))
    for name in timings:
        timings[name]["b1_b2_b3_ms"] = fwd_bwd

    # B1 with bf16 operands: SDPA's function (p rounded to bf16).
    got, got_lse = FA.flash_forward(q, k, v, causal=True,
                                    operand_dtype=bf16)
    torch.cuda.synchronize()
    want, want_lse = FA.flash_attention_reference(q, k, v, causal=True,
                                                  operand_dtype=bf16)
    abs_v_out = FA.flash_attention_reference(
        q, k, v.abs(), causal=True, operand_dtype=bf16)[0].float()
    for output, a, b in (("out", got, want), ("lse", got_lse, want_lse)):
        a, b = a.float(), b.float()
        rtol, atol = flash_tolerance("bf16/bf16", output, b, abs_v_out)
        share = ((a - b).abs() / (atol + rtol * b.abs())).max().item()
        if not share <= 1.0:
            fail("flash_forward bf16/bf16 %s at the training shape "
                 "disagrees with its plain version: %.3g of the "
                 "tolerance" % (output, share))
    del got, got_lse, want, want_lse, abs_v_out
    bound_ms, bound_by = bound(2 * 2 * D * pairs, 0,
                               2 * 4 * elem + 4 * B * S * H)
    t = dict(
        kernel_ms=cuda_ms(lambda: FA.flash_forward(
            q, k, v, causal=True, operand_dtype=bf16), iters=20, warmup=3),
        plain_ms=cuda_ms(lambda: FA.flash_attention_reference(
            q, k, v, causal=True, operand_dtype=bf16), iters=5, warmup=1),
        library_ms=cuda_ms(runs["flash_forward"][2], iters=20, warmup=3),
        bound_ms=bound_ms, bound_by=bound_by)
    t["share_of_bound"] = t["bound_ms"] / t["kernel_ms"]
    timings["flash_forward"]["bf16_operands"] = t
    print("kernel timing flash_forward B=%d S=%d H=%d D=%d causal "
          "bf16/bf16 (SDPA's function): kernel %.4f ms (%.1f%% of its "
          "bound), plain %.4f ms, sdpa %.4f ms, bound %.4f ms (%s)" % (
              B, S, H, D, t["kernel_ms"], 100 * t["share_of_bound"],
              t["plain_ms"], t["library_ms"], t["bound_ms"],
              t["bound_by"]))
    return timings


#: LRN kernels (B6 forward, B7 backward) against their plain versions.
#: float32: the forward within rtol 1e-5 (the window sums run in another
#: order, a few float32 ulps); the backward within 1e-5 of the sum of the
#: magnitudes of every term of dx (``lrn_backward_formula``'s scale: dx
#: is a difference of two terms that may cancel, so its own magnitude is
#: no error scale).  bfloat16: the forward within one bfloat16 ulp of the
#: output (2^-7 of |y|: the square rounds to bfloat16 identically on both
#: sides, and a float32 denominator one ulp apart can move the output's
#: one rounding by one ulp); the backward within 2^-7 of (that scale +
#: |dx|): the plain version is autograd through ``lrn_reference``, which
#: rounds the first term, the square's gradient and x times it to
#: bfloat16 (2^-8 each) before their sum rounds once more, while the
#: kernel rounds dx once.
LRN_F32_RTOL, LRN_BF16_RTOL = 1e-5, 2.0 ** -7
#: AlexNet's constants (k, n, alpha, beta) and the two LRN inputs of the
#: main path at batch 512 (NHWC, bfloat16 at precision_level 0).
ALEXNET_LRN = dict(n=5, alpha=1e-4, beta=0.75, k=2.0)
ALEXNET_BATCH = 512
LRN_SHAPES = (("lrn1", (ALEXNET_BATCH, 55, 55, 96)),
              ("lrn2", (ALEXNET_BATCH, 27, 27, 256)))
#: At AlexNet's constants the window term is ~1e-4 of the denominator, so
#: a wrong window passes any check there; these constants make it
#: dominate: k = 1, alpha = n (coef 1), beta = 0.75, n in {3, 4, 5} (4:
#: the asymmetric even window), C in {7, 24, 96, 100, 256, 264} (rows
#: that end inside a warp, on a warp's edge and — bf16 at 7, 100 and
#: 264 — inside a 16-byte vector), over a ragged P of 3·37·41 = 4551
#: rows (no multiple of any tile); the widest windows the register route
#: takes (n = 9 in f32, 17 in bf16; f32 at 17 takes the wide route); P =
#: 1, C = 1 and C = 2 (windows wider than the row), C = 1000 and the C =
#: 4096 limit.  Then the inputs that keep the register route's in-range
#: sequences from some vectors: k = 1e-35 with every fourth row zero (d =
#: k there, under 2^-100), and beta = 0.5 (powf); and x, dy at a storage
#: offset of one element (2 or 4 bytes off 16: the wide route).  Each
#: case: (name, shape, constants, storage offset in elements, zero rows).
def _strong(n, k=1.0, beta=0.75):
    return dict(n=n, alpha=float(n), beta=beta, k=k)


LRN_STRONG = [("strong_n%d_c%d" % (n, c), (3, 37, 41, c), _strong(n), 0,
               False)
              for n in (3, 4, 5) for c in (7, 24, 96, 100, 256, 264)] + [
    ("strong_n%d_c%d" % (n, c), (3, 37, 41, c), _strong(n), 0, False)
    for n in (9, 17) for c in (96, 100)] + [
    ("strong_p1", (1, 1, 1, 96), _strong(5), 0, False),
    ("strong_c1", (2, 3, 5, 1), _strong(5), 0, False),
    ("strong_c2", (2, 3, 5, 2), _strong(5), 0, False),
    ("strong_c1000", (3, 37, 41, 1000), _strong(5), 0, False),
    ("strong_c4096", (2, 3, 3, 4096), _strong(5), 0, False),
    ("strong_tiny_k", (3, 37, 41, 96), _strong(5, k=1e-35), 0, True),
    ("strong_beta_half", (3, 37, 41, 100), _strong(4, beta=0.5), 0, False),
    ("strong_offset", (3, 37, 41, 96), _strong(5), 1, False)]


def lrn_tolerance(dtype, want, scale=None):
    """The tolerance tensor of one LRN output (see LRN_F32_RTOL)."""
    import torch
    if scale is None:   # forward
        rtol = LRN_F32_RTOL if dtype == torch.float32 else LRN_BF16_RTOL
        return rtol * want.abs()
    if dtype == torch.float32:
        return LRN_F32_RTOL * scale
    return LRN_BF16_RTOL * (scale + want.abs())


def lrn_faults(x, dy, n, alpha, beta, k):
    """Planted faults of the kind the strong constants exist to catch,
    as float32 outputs: the forward with its band shifted by one
    channel, and the backward with its second term dropped and (even n)
    with the window of its second term not transposed."""
    import torch
    from veles_tpu_torch.ops import lrn as L
    c = x.shape[-1]
    band = L.band_matrix(c, n, torch.float32, x.device)
    sq = (x * x).float()
    shifted = band.roll(1, dims=1)
    y_shift = x.float() / (k + (alpha / n) * (sq @ shifted)) ** beta
    d = k + (alpha / n) * (sq @ band)
    pw = d ** beta
    g, xf = dy.float(), x.float()
    first = g / pw
    t = g * xf / (pw * d)
    untransposed = first - 2.0 * beta * (alpha / n) * xf * (t @ band)
    faults = {"forward_band_shifted": y_shift,
              "backward_second_term_dropped": first}
    if n % 2 == 0:   # an odd window's band is symmetric: Bᵀ = B
        faults["backward_window_not_transposed"] = untransposed
    return faults


def lrn_shares(x, dy, n, alpha, beta, k, y, dx):
    """(forward share, backward share, max abs errs, fault shares) of
    the kernel outputs y, dx against the plain versions: the largest
    |got − want| / tolerance; a fault's share is the same reading
    against the faulty output."""
    import torch
    from veles_tpu_torch.ops import lrn as L
    want_y = L.lrn_reference(x, n, alpha, beta, k).float()
    want_dx = L.lrn_backward_reference(x, dy, n, alpha, beta, k).float()
    _, scale = L.lrn_backward_formula(x, dy, n, alpha, beta, k)
    tol_y = lrn_tolerance(x.dtype, want_y)
    tol_dx = lrn_tolerance(x.dtype, want_dx, scale)
    yf, dxf = y.float(), dx.float()

    def share(got, want, tol):
        return ((got - want).abs() / tol).nan_to_num(
            nan=0.0, posinf=float("inf")).max().item()

    faults = {}
    for name, bad in lrn_faults(x, dy, n, alpha, beta, k).items():
        if name.startswith("forward"):
            faults[name] = share(yf, bad, tol_y)
        else:
            faults[name] = share(dxf, bad, tol_dx)
    if not (torch.isfinite(yf).all() and torch.isfinite(dxf).all()):
        fail("lrn kernel output not finite")
    return (share(yf, want_y, tol_y), share(dxf, want_dx, tol_dx),
            ((yf - want_y).abs().max().item(),
             (dxf - want_dx).abs().max().item()), faults)


def bits(t):
    """A float32 or bfloat16 tensor's bits as integers (NaNs compare)."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def lrn_case_inputs(shape, dtype, offset, zero_rows, gen):
    """x and dy of one LRN case, ``offset`` elements into their storage,
    every fourth row of x zero when ``zero_rows``."""
    import torch
    numel = 1
    for dim in shape:
        numel *= dim
    out = []
    for _ in range(2):
        buf = torch.randn(numel + offset, generator=gen,
                          device="cuda").to(dtype)
        out.append(buf[offset:].view(shape))
    if zero_rows:
        out[0].view(-1, shape[-1])[::4] = 0
    return out


def phase_lrn_kernels():
    """Phases 3-4 for the AlexNet kernels (B6 forward, B7 backward):
    each against its plain version at both main-path shapes in bfloat16
    and float32, at the strong constants, even n, a ragged P, P = 1, the
    channel limit and the cases of LRN_STRONG, on the route the wrapper
    picks and on the wide route; where the register route runs, its y
    and dx must equal the wide route's bit for bit; at a storage offset
    the wrapper must take the wide route and refuse a forced register
    route; the planted faults must be flagged at the strong constants.
    Then timed at the main-path shapes."""
    import torch
    from veles_tpu_torch.ops import lrn as L
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows, worst, main_err = [], {}, {}
    fault_rows, unequal = [], []
    equal = 0
    cases = [(name, shape, ALEXNET_LRN, 0, False)
             for name, shape in LRN_SHAPES] + LRN_STRONG
    for name, shape, kw, offset, zero_rows in cases:
        for dtype in (torch.bfloat16, torch.float32):
            label = "bf16" if dtype == torch.bfloat16 else "f32"
            x, dy = lrn_case_inputs(shape, dtype, offset, zero_rows, gen)
            route = L.lrn_route(shape[-1], kw["n"], dtype,
                                [x.data_ptr(), dy.data_ptr()])
            if offset and route != "wide":
                fail("lrn at a storage offset of %d elements takes the %s "
                     "route" % (offset, route))
            if offset:
                try:
                    L.lrn_forward(x, route="register", **kw)
                except ValueError:
                    pass
                else:
                    fail("a forced register route at a storage offset "
                         "was not refused")
            outs = {}
            for way in ("wide", None):
                before = (dict(L.lrn_forward.launches_by_route),
                          dict(L.lrn_backward.launches_by_route))
                outs[way or route] = (L.lrn_forward(x, route=way, **kw),
                                      L.lrn_backward(x, dy, route=way, **kw))
                want = way or route
                for wrapper, was in zip((L.lrn_forward, L.lrn_backward),
                                        before):
                    if wrapper.launches_by_route[want] != was[want] + 1:
                        fail("lrn %s launched %s, not the %s route" % (
                            name, wrapper.launches_by_route, want))
            torch.cuda.synchronize()
            if route == "register":
                same = all(torch.equal(bits(a), bits(b)) for a, b in
                           zip(outs["register"], outs["wide"]))
                equal += same
                if not same:
                    unequal.append("%s %s" % (name, label))
            for way, (y, dx) in outs.items():
                fwd, bwd, errs, faults = lrn_shares(x, dy, y=y, dx=dx, **kw)
                rows.append((name, label, way, fwd, bwd, errs))
                for key, val in (("forward", fwd), ("backward", bwd)):
                    was = worst.get((label, key), (0.0, None))
                    if val > was[0]:
                        worst[(label, key)] = (val, "%s (%s)" % (name, way))
                if way != route:
                    continue
                if name.startswith("lrn") and dtype == torch.bfloat16:
                    main_err["lrn_forward"] = max(
                        main_err.get("lrn_forward", 0.0), errs[0])
                    main_err["lrn_backward"] = max(
                        main_err.get("lrn_backward", 0.0), errs[1])
                if name == "lrn1" or name.startswith("strong_n5_c96") or \
                        name.startswith("strong_n4_c96"):
                    fault_rows.append((name, label, faults))
            del x, dy, outs
    n_register = equal + len(unequal)
    print("kernel check: lrn_forward/lrn_backward on both routes == "
          "lrn_reference / autograd through it; tolerance f32 fwd rtol %g,"
          " bwd %g x the terms' magnitude; bf16 fwd 2^-7 x |y| (one ulp), "
          "bwd 2^-7 x (terms' magnitude + |dx|); largest share of the "
          "tolerance:" % (LRN_F32_RTOL, LRN_F32_RTOL))
    for (label, key), (val, name) in sorted(worst.items()):
        print("  %s %-8s %.3g (%s)" % (label, key, val, name))
    for name, label, way, fwd, bwd, errs in rows:
        if name.startswith("lrn"):
            print("  %s %s %s: fwd share %.3g (max abs err %.3g), bwd share "
                  "%.3g (max abs err %.3g)" % (name, label, way, fwd,
                                                errs[0], bwd, errs[1]))
    print("kernel check: register == wide, y and dx bit for bit: %d/%d "
          "cases" % (equal, n_register))
    print("planted faults (share of the same tolerance; > 1 = flagged):")
    for name, label, faults in fault_rows:
        print("  %s %s: %s" % (name, label, ", ".join(
            "%s %.3g" % kv for kv in sorted(faults.items()))))
    for name, label, way, fwd, bwd, errs in rows:
        if not (fwd <= 1.0 and bwd <= 1.0):
            fail("lrn kernels disagree with their plain versions (%s, %s, "
                 "%s route): forward %.3g, backward %.3g of the tolerance" %
                 (name, label, way, fwd, bwd))
    if unequal:
        fail("the lrn register route differs from the wide route: %s" %
             unequal)
    for name, label, faults in fault_rows:
        if name.startswith("strong") and not min(faults.values()) > 1.0:
            fail("a planted LRN fault passes the check at the strong "
                 "constants (%s, %s): %s" % (name, label, faults))
    return (main_err, worst, fault_rows, "%d/%d" % (equal, n_register),
            lrn_timings())


def lrn_timings():
    """B6 and B7 at the two main-path shapes (bfloat16) on both routes
    by :func:`cold_ms` (the device time of a CUDA graph of launches
    rotating among input copies of more than twice the L2); the plain
    version (the backward's is autograd through lrn_reference, its
    forward included) and F.local_response_norm forward and
    forward+backward by back-to-back calls (:func:`cuda_ms`); and the
    bound: bytes moved (x read and y written; x and dy read and dx
    written) at 3.35 TB/s against the float32 operations ((n + 5) per
    element forward, (2n + 12) backward) at 67 TFLOP/s.  A share of the
    bound over 1 fails."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.ops import lrn as L
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    kw = ALEXNET_LRN
    out = {}
    for name, shape in LRN_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        leaf = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
        dyc = dy.permute(0, 3, 1, 2)

        def library_fwd():
            return F.local_response_norm(
                x.permute(0, 3, 1, 2), kw["n"], kw["alpha"], kw["beta"],
                kw["k"])

        def library_fwd_bwd():
            y = F.local_response_norm(leaf, kw["n"], kw["alpha"],
                                      kw["beta"], kw["k"])
            torch.autograd.grad(y, leaf, dyc)

        def forward(a, route=None):
            return L.lrn_forward(a, route=route, **kw)

        def backward(a, g, route=None):
            return L.lrn_backward(a, g, route=route, **kw)

        elem, size = x.numel(), x.element_size()
        t = {
            "lrn_forward": dict(
                kernel_ms=cold_ms(forward, (x,), 2 * size * elem),
                wide_ms=cold_ms(forward, (x, "wide"), 2 * size * elem),
                plain_ms=cuda_ms(lambda: L.lrn_reference(x, **kw),
                                 iters=10, warmup=2),
                library_ms=cuda_ms(library_fwd, iters=10, warmup=2),
                bytes=2 * size * elem, ops=(kw["n"] + 5) * elem),
            "lrn_backward": dict(
                kernel_ms=cold_ms(backward, (x, dy), 3 * size * elem),
                wide_ms=cold_ms(backward, (x, dy, "wide"),
                                3 * size * elem),
                plain_ms=cuda_ms(
                    lambda: L.lrn_backward_reference(x, dy, **kw),
                    iters=10, warmup=2),
                library_ms=cuda_ms(library_fwd_bwd, iters=10, warmup=2),
                bytes=3 * size * elem, ops=(2 * kw["n"] + 12) * elem),
        }
        for kernel, row in t.items():
            bytes_ms = row["bytes"] / HBM_BYTES_PER_S * 1e3
            ops_ms = row["ops"] / F32_FLOP_PER_S * 1e3
            row["bound_ms"] = max(bytes_ms, ops_ms)
            row["bound_by"] = "bytes" if bytes_ms >= ops_ms else \
                "operations"
            row["share"] = row["bound_ms"] / row["kernel_ms"]
            row["wide_share"] = row["bound_ms"] / row["wide_ms"]
            print("kernel timing %s %s %s bf16 (L2-proof, graph replay): "
                  "register route %.4f ms (%.1f%% of its bound), wide "
                  "route %.4f ms (%.1f%%); back-to-back: plain %.4f ms, "
                  "F.local_response_norm %s %.4f ms; bound %.4f ms (%s; "
                  "%.1f MB, %.2f GFLOP)" % (
                      kernel, name, shape, row["kernel_ms"],
                      100 * row["share"], row["wide_ms"],
                      100 * row["wide_share"], row["plain_ms"],
                      "forward" if kernel == "lrn_forward" else
                      "forward+backward", row["library_ms"],
                      row["bound_ms"], row["bound_by"], row["bytes"] / 1e6,
                      row["ops"] / 1e9))
            if max(row["share"], row["wide_share"]) > 1.0:
                fail("%s %s reads over its bound: %.4f / %.4f ms against "
                     "%.4f" % (kernel, name, row["kernel_ms"],
                               row["wide_ms"], row["bound_ms"]))
            out[(kernel, name)] = row
        del x, dy, leaf, dyc
    return out


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
    FA.reset_launches()
    launcher.run()
    torch.cuda.synchronize()
    launches = {"flash_forward": FA.flash_forward.launches,
                "flash_dq": FA.flash_dq.launches,
                "flash_dkv": FA.flash_dkv.launches}
    routes = {name: dict(getattr(FA, name).route_launches)
              for name in launches}
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
    # bf16 storage with f32 operands: B1, B2 and B3 on the tensor cores.
    want_routes = {name: {way: n if way == FA.route(name, torch.bfloat16,
                                                      torch.float32)
                          else 0 for way in FA.ROUTES}
                   for name, n in expected.items()}
    print("training: launches by route %s" % routes)
    if routes != want_routes:
        fail("flash kernels took the routes %s; the main path implies %s"
             % (routes, want_routes))

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
    for fault, kernel in (("dq", "flash_dq"), ("dk", "flash_dkv")):
        symbol = FA._entry(kernel, torch.bfloat16, torch.float32)[0]
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
    numbers["flash_routes"] = routes
    del ticks, afters
    return launches, numbers


#: AlexNet phase: bench.py's batch, one epoch of one validation tick
#: and ALEXNET_TICKS train ticks (the dataset's count is the only cut).
ALEXNET_TICKS = 3
#: Each AlexNet tick is held to a tick run from the SAME state (the
#: parameters, momentum slots, accumulators and the step generator's
#: state, so dropout draws the same masks) with the plain banded LRN
#: (``pallas_lrn = False``): the loss within rtol 1e-4, and after every
#: train tick each parameter tensor's gap (norm) within 0.01 of the norm
#: of that tick's change plus 1e-9 per sqrt(element) (for a change of
#: zero).  The two runs differ only in the LRN outputs' bfloat16
#: roundings, where the kernels' float32 values land a few ulps from the
#: plain versions' (one bfloat16 ulp at rare elements), which reach conv1
#: and conv2 and, through them, every later gradient.  Calibration, on an
#: H100 at this geometry: kernel vs plain read at most 6.8e-5 of the
#: change (conv1's weights), a tick of the kernel run repeated from the
#: same state reads 0 (the card's run-to-run noise), and a planted fault
#: — the first train tick again with every dx of the backward kernel
#: halved — reads 0.57 of the change in conv1's weights and 0.11 in
#: conv2's, whose change at initialization is mostly weight decay
#: (AlexNet's std-0.01 weights pass little gradient that deep).  The
#: gate requires that fault to fail it in both.
ALEXNET_LOSS_RTOL, ALEXNET_CHANGE_TOL, ALEXNET_FLOOR = 1e-4, 0.01, 1e-9
ALEXNET_PLANTED_SCALE = 0.5


def kernel_family(name):
    """A device kernel's family, by its name."""
    low = name.lower()
    if "lrn_" in low:
        return "lrn (B6/B7)"
    if "flash_decode" in low or "merge_pass" in low:
        return "decode attention (B4/B5)"
    if "conv" in low or "fprop" in low or "dgrad" in low or \
            "wgrad" in low or "implicit" in low:
        return "convolution"
    if "gemm" in low or "cutlass" in low:
        return "matmul"
    if "pool" in low:
        return "pooling"
    return "elementwise and other"


def profile_tick(run, label="alexnet profile of one warm train tick"):
    """One tick under ``torch.profiler`` (CPU and CUDA activities): the
    device time of its kernels (the trace's CUDA events only) by family
    and the ten largest, and the device's idle share of the tick's wall
    time (with the profiler's own overhead on the host side).  "not
    measured" when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - start) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue   # host ops also carry their kernels' device time
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    device_ms = sum(kernels.values())
    if not device_ms:
        print("%s: not measured (the trace holds no device time)" % label)
        return {"device_ms": "not measured"}
    families = {}
    for name, ms in kernels.items():
        fam = kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
           "families_ms": families,
           "top_kernels_ms": [[n[:90], ms] for n, ms in top]}
    print("%s (torch.profiler): wall %.2f ms, kernels %.2f ms, device "
          "idle %.1f %%; by family %s" % (
              label, wall_ms, device_ms, 100 * out["idle_share"],
              {k: round(v, 3) for k, v in sorted(families.items())}))
    for name, ms in top:
        print("  %8.3f ms  %s" % (ms, name[:110]))
    return out


def phase_alexnet(smi):
    """The AlexNet phase: the full-width ungrouped AlexNet through
    ``StandardWorkflow`` (``AlexNetWorkflow``, ``ImagenetLoader``'s
    synthetic 227 px / 1000-class set, ``MeanDispNormalizer``) at batch
    512, bfloat16 stream, one validation and ALEXNET_TICKS train ticks
    through ``Launcher.run`` with the LRN kernels; then each tick again
    from the same state with the plain LRN, the first train tick again
    with the kernels (noise) and with a planted B7 fault."""
    import math
    import numpy
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.ops import lrn as L
    from veles_tpu_torch.znicz.samples.imagenet import AlexNetWorkflow
    engine = root.common.engine
    engine.precision_level = 0
    engine.pallas_lrn = True
    prng.reset()
    prng.get(0).seed(42)
    t0 = time.monotonic()
    launcher = Launcher()
    wf = AlexNetWorkflow(
        launcher, minibatch_size=ALEXNET_BATCH, max_epochs=1,
        loader_config={"sim_train": ALEXNET_BATCH * ALEXNET_TICKS,
                       "sim_valid": ALEXNET_BATCH, "sim_image_size": 227,
                       "sim_classes": 1000, "validate_labels": False})
    launcher.initialize(device="cuda")
    compiler = wf.compiler
    compiler._ensure_compiled()
    n_params = sum(v.size for v in compiler._param_vecs.values())
    gen = compiler._generator()
    torch.cuda.synchronize()
    print("alexnet: %d layers, %.2fM parameters, batch %d, 227 px, 1000 "
          "classes, %d train + %d validation images; host init + upload "
          "%.1f s" % (len(wf.forwards), n_params / 1e6, ALEXNET_BATCH,
                      ALEXNET_BATCH * ALEXNET_TICKS, ALEXNET_BATCH,
                      time.monotonic() - t0))

    def state():
        out = {n: v.devmem.to("cpu") for n, v in
               compiler._param_vecs.items()}
        out.update({n: v.devmem.to("cpu") for n, v in
                    compiler._state_vecs.items()})
        return out

    ticks = []   # (training, loss, seconds, state, batch, generator)
    execute = compiler.execute

    def timed_execute(training=True):
        before = state()
        batch = [v.mem.copy() for v in compiler.batch_vectors]
        rng_state = gen.get_state()
        torch.cuda.synchronize()
        start = time.monotonic()
        metrics = execute(training=training)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ticks.append((training, loss, time.monotonic() - start, before,
                      batch, rng_state))
        return metrics

    compiler.execute = timed_execute
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L.reset_launches()
    launcher.run()
    torch.cuda.synchronize()
    launches = {"lrn_forward": L.lrn_forward.launches,
                "lrn_backward": L.lrn_backward.launches}
    by_route = {"lrn_forward": dict(L.lrn_forward.launches_by_route),
                "lrn_backward": dict(L.lrn_backward.launches_by_route)}
    peak = torch.cuda.max_memory_allocated()
    compiler.execute = execute
    results = wf.gather_results()
    afters = [t[3] for t in ticks[1:]] + [state()]
    classes = [t[0] for t in ticks]
    if classes != [False] + [True] * ALEXNET_TICKS:
        fail("alexnet ran ticks %s, expected one validation tick then %d "
             "train ticks" % (classes, ALEXNET_TICKS))
    expected = {"lrn_forward": 2 * len(ticks),
                "lrn_backward": 2 * ALEXNET_TICKS}
    print("alexnet: LRN kernel launches %s (expected %s: 2 forward + 2 "
          "backward per train tick, 2 forward per validation tick)" %
          (launches, expected))
    if launches != expected:
        fail("LRN kernels launched %s times, the ticks imply %s" %
             (launches, expected))
    print("alexnet: LRN launches by route %s" % by_route)
    if any(routes["wide"] for routes in by_route.values()):
        fail("an AlexNet LRN launch took the wide route: %s" % by_route)
    device = next(iter(compiler._param_vecs.values())).devmem.device

    def restore(tick):
        _, _, _, snapshot, batch, rng_state = tick
        for n, v in list(compiler._param_vecs.items()) + \
                list(compiler._state_vecs.items()):
            v.devmem = snapshot[n].to(device)
        for vec, arr in zip(compiler.batch_vectors, batch):
            vec.mem = arr
        gen.set_state(rng_state)

    def compare(after, before):
        rows = {}
        for name, vec in compiler._param_vecs.items():
            now = vec.devmem
            gap = (after[name].to(device) - now).norm().item()
            change = (now - before[name].to(device)).norm().item()
            rows[name] = (gap, change, ALEXNET_CHANGE_TOL * change +
                          ALEXNET_FLOOR * math.sqrt(now.numel()),
                          now.numel())
        return rows

    def timed(training):
        torch.cuda.synchronize()
        start = time.monotonic()
        loss = float(execute(training=training)["loss"])
        torch.cuda.synchronize()
        return loss, time.monotonic() - start

    # Each tick again, from the same state, with the plain LRN.
    engine.pallas_lrn = False
    plain_losses, plain_s, tick_rows = [], [], []
    for tick, after in zip(ticks, afters):
        restore(tick)
        loss, seconds = timed(tick[0])
        plain_losses.append(loss)
        plain_s.append(seconds)
        if tick[0]:
            tick_rows.append(compare(after, tick[3]))
    engine.pallas_lrn = True
    restore(ticks[0])
    _, warm_validation_s = timed(False)
    first = classes.index(True)
    restore(ticks[first])
    timed(True)
    noise = compare(afters[first], ticks[first][3])
    restore(ticks[first])
    profile = profile_tick(lambda: execute(training=True))
    launch = L._launch

    def planted_launch(fn, name, *args):
        launch(fn, name, *args)
        if fn == "veles_lrn_bwd":   # (route, dtype, x, dy, dx, ...)
            args[4].mul_(ALEXNET_PLANTED_SCALE)

    restore(ticks[first])
    L._launch = planted_launch
    try:
        timed(True)
    finally:
        L._launch = launch
    planted = compare(afters[first], ticks[first][3])
    torch.cuda.synchronize()

    losses = [t[1] for t in ticks]
    print("alexnet: losses with the LRN kernels %s, plain LRN from the "
          "same state %s, ln(1000) %.4f" % (
              ["%.6f" % x for x in losses],
              ["%.6f" % x for x in plain_losses], math.log(1000)))

    def family(name):
        return name.split("/")[0] + "/" + name.split("/")[-1]

    fam = {}   # name -> [min change RMS, max gap RMS, max gap/change]
    for rows in tick_rows:
        for name, (gap, change, _, n) in rows.items():
            f = fam.setdefault(family(name), [math.inf, 0.0, 0.0])
            f[0] = min(f[0], change / math.sqrt(n))
            f[1] = max(f[1], gap / math.sqrt(n))
            f[2] = max(f[2], gap / max(change, 1e-30))
    print("alexnet readings per parameter over the %d train ticks (kernel "
          "vs plain LRN from the same state): min change RMS / max gap "
          "RMS / max gap over change; then the kernel tick repeated "
          "(noise) and the planted fault (every dx x %g), gap over "
          "change on the first train tick" % (len(tick_rows),
                                              ALEXNET_PLANTED_SCALE))
    for name, (c, g, r) in sorted(fam.items()):
        print("  %-22s %.3g / %.3g / %.3g; noise %.3g; planted %.3g" % (
            name, c, g, r, noise[name][0] / max(noise[name][1], 1e-30),
            planted[name][0] / max(planted[name][1], 1e-30)))
    for i, (lk, lp) in enumerate(zip(losses, plain_losses)):
        if not (math.isfinite(lk) and math.isfinite(lp)):
            fail("alexnet tick %d loss not finite: kernel %r, plain %r" %
                 (i, lk, lp))
        if abs(lk - lp) > ALEXNET_LOSS_RTOL * abs(lp):
            fail("alexnet tick %d loss: kernel %.6f vs plain %.6f (rtol "
                 "%g)" % (i, lk, lp, ALEXNET_LOSS_RTOL))
    if abs(losses[0] - math.log(1000)) > 0.5:
        fail("first-tick loss %.4f far from ln(1000) = %.4f for a "
             "randomly initialized 1000-class model" %
             (losses[0], math.log(1000)))
    worst, worst_name = 0.0, None
    for i, rows in enumerate(tick_rows):
        for name, (gap, change, bound, n) in rows.items():
            if gap / bound > worst:
                worst, worst_name = gap / bound, "%s (train tick %d)" % (
                    name, i + 1)
            if not gap <= bound:
                fail("alexnet parameter %s after train tick %d: kernel vs "
                     "plain LRN gap %.3g > %.3g (the tick's change %.3g)" %
                     (name, i + 1, gap, bound, change))
    targets = ["%s/weights" % wf.forwards[i].name for i in (0, 3)]
    planted_share = {n: planted[n][0] / planted[n][2] for n in targets}
    flagged = sorted(n for n, r in planted.items() if r[0] > r[2])
    print("alexnet: planted fault flags %d tensors: %s" % (len(flagged),
                                                           flagged))
    if len(targets) != 2 or not min(planted_share.values()) > 1.0:
        fail("the alexnet parameter gate does not see every dx x %g of "
             "the LRN backward kernel in conv1/conv2's weights: %s" %
             (ALEXNET_PLANTED_SCALE, planted_share))
    train_s = [t[2] for t in ticks if t[0]]
    plain_train_s = [s for s, t in zip(plain_s, ticks) if t[0]]
    p50 = float(numpy.median(train_s))
    numbers = {
        "losses": losses,
        "plain_losses": plain_losses,
        "train_tick_s": train_s,
        "train_tick_p50_s": p50,
        "images_per_s_at_p50": ALEXNET_BATCH / p50,
        "validation_tick_cold_s": ticks[0][2],
        "validation_tick_warm_s": warm_validation_s,
        "profile": profile,
        "plain_lrn_train_tick_s": plain_train_s,
        "plain_lrn_train_tick_p50_s": float(numpy.median(plain_train_s)),
        "plain_lrn_validation_tick_s": plain_s[0],
        "peak_bytes": peak,
        "worst_param_gap_over_bound": worst,
        "worst_param": worst_name,
        "param_gap_over_change": {k: v[2] for k, v in fam.items()},
        "planted_gap_over_bound": planted_share,
        "planted_flagged": flagged,
        "decision": results,
    }
    print("alexnet check: %d ticks, every loss within rtol %g of the "
          "plain-LRN tick from the same state; after every train tick "
          "every parameter within %g of that tick's change + %g/sqrt("
          "element) (largest share of the bound %.3g, %s); the planted "
          "B7 fault fails the gate in conv1's and conv2's weights (%.3g, "
          "%.3g of the bound)" % (
              len(ticks), ALEXNET_LOSS_RTOL, ALEXNET_CHANGE_TOL,
              ALEXNET_FLOOR, worst, worst_name,
              *[planted_share[n] for n in targets]))
    print("alexnet readings on %s (smoke, not a benchmark): train ticks "
          "%s s (p50 %.4f s = %.1f images/s), validation tick %.4f s "
          "(the first tick, cold; warm %.4f s); plain LRN: train ticks %s "
          "s, validation tick %.4f s; peak device memory %.2f GB" % (
              smi, ["%.4f" % x for x in train_s], p50, ALEXNET_BATCH / p50,
              ticks[0][2], warm_validation_s,
              ["%.4f" % x for x in plain_train_s], plain_s[0],
              peak / 1e9))
    del ticks, afters
    return launches, by_route, numbers


def post(url, body, timeout=600, token=None):
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["X-Status-Token"] = token
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def short_extend_chunks(tables, clens):
    """The chunks of a ``paged_extend`` call that attend through a
    decode kernel: each real row (a table that is not all TRASH) runs
    alone, in the chunks of ``extend_chunks`` (a row of more than
    DECODE_MAX_Q tokens ends with its last position alone), each chunk
    of at most DECODE_MAX_Q tokens through the kernel."""
    import numpy
    from veles_tpu_torch import export as X
    from veles_tpu_torch.ops import decode_attention as DA
    tables, clens = numpy.asarray(tables), numpy.asarray(clens)
    return sum(n <= DA.DECODE_MAX_Q
               for c in clens[(tables[:, 0] != 0) & (clens > 0)]
               for n in X.extend_chunks(int(c)))


class FirstLogits(object):
    """Records, while installed on ``model``, the logits every extend
    chunk that samples drew its first token from, with the position
    after the chunk and the chunk's last token — the call a prompt's
    first serving ends with and the one a whole-prompt prefix-cache hit
    makes are both such a chunk, at the prompt's length and last
    token."""

    def __init__(self, model):
        self.model, self.seen = model, []
        extend = model._extend

        def call(pool, tables, tokens, prior, chunk_lens, *args, **kw):
            got = extend(pool, tables, tokens, prior, chunk_lens, *args,
                         **kw)
            if got is not None:
                n = int(chunk_lens[0])
                self.seen.append((int(prior[0]) + n, int(tokens[0, n - 1]),
                                  got[1].clone()))
            return got
        model._extend = call

    def restore(self):
        del self.model._extend

    def gate(self, name, prompt):
        """The prompt's first serving (a miss) and its whole-prompt hit:
        the same logits bit for bit."""
        import torch
        got = [logits for end, tok, logits in self.seen
               if end == len(prompt) and tok == prompt[-1]]
        if len(got) != 2:
            fail("%s: the repeated %d-token prompt sampled its first token "
                 "%d times, expected 2 (its first serving and its prefix "
                 "hit)" % (name, len(prompt), len(got)))
        if not torch.equal(got[0], got[1]):
            fail("%s: the whole-prompt prefix hit's first logits differ "
                 "from the first serving's (max abs difference %.3g)" % (
                     name, (got[0] - got[1]).abs().max().item()))
        print("%s prefix check: the repeated %d-token prompt's hit sampled "
              "its first token from the first serving's logits, bit for "
              "bit" % (name, len(prompt)))


def prefix_hit_exact(model, kv_dtype, prompt):
    """A prompt's first serving and its whole-prompt prefix-cache hit
    through the model API, as the engine makes them, on one pool of
    ``kv_dtype``: the whole prompt from position 0, then a copy-on-write
    of its last block and the last token re-fed at position len − 1.
    The hit's first logits and token must equal the first serving's,
    and the block it rewrote the cached one in every plane tensor,
    bit for bit."""
    import numpy
    import torch
    n = len(prompt)
    pool = model.make_kv_pool(n // KV_BLOCK + 2, KV_BLOCK,
                              kv_dtype=kv_dtype)
    ids = pool.alloc(n // KV_BLOCK)
    zeros = numpy.zeros(1, numpy.float32)
    seeds = numpy.zeros(1, numpy.uint32)
    firsts = FirstLogits(model)
    try:
        miss = model.paged_extend(
            pool, numpy.asarray([ids], numpy.int32),
            numpy.asarray([prompt], numpy.int32), numpy.zeros(1, numpy.int32),
            numpy.full(1, n, numpy.int32), zeros, seeds)
        cached = [t[ids[-1]].clone() for group in pool.storage
                  for t in group]
        copy = pool.cow_copy(ids[-1])
        hit = model.paged_extend(
            pool, numpy.asarray([list(ids[:-1]) + [copy]], numpy.int32),
            numpy.asarray([prompt[-1:]], numpy.int32),
            numpy.full(1, n - 1, numpy.int32), numpy.ones(1, numpy.int32),
            zeros, seeds)
        torch.cuda.synchronize()
    finally:
        firsts.restore()
    firsts.gate("%s model API" % kv_dtype, prompt)
    rewritten = [t[copy] for group in pool.storage for t in group]
    if miss[0] != hit[0] or not all(
            torch.equal(a, b) for a, b in zip(cached, rewritten)):
        fail("%s: the prefix hit's first token (%d against %d) or the "
             "block it rewrote differs from the first serving's" % (
                 kv_dtype, hit[0], miss[0]))
    print("%s model API prefix check: first token and the rewritten "
          "block's codes and scales equal the first serving's" % kv_dtype)


def phase_serving(workdir, smi):
    """Phases 7-8 on the f32 plane: returns (launches, numbers, and the
    model, prompts and answers the later phases reuse)."""
    import numpy
    import torch
    from veles_tpu_torch import export as X
    from veles_tpu_torch.ops import decode_attention as DA
    from veles_tpu_torch.restful import ModelServer
    path = os.path.join(workdir, "lm.veles.tgz")
    t0 = time.monotonic()
    X.random_lm_artifact(path, VOCAB, EMBED, HEADS, BLOCKS, HIDDEN,
                         POSITIONS, seed=SEED, compresslevel=0)
    print("artifact write: %.1f s (%.2f GB, gzip level 0)" %
          (time.monotonic() - t0, os.path.getsize(path) / 1e9))
    t0 = time.monotonic()
    model = X.ExportedModel(path, device="cuda")
    model._lm_params()
    torch.cuda.synchronize()
    print("artifact load to cuda: %.1f s" % (time.monotonic() - t0))
    os.remove(path)

    # Count the device calls whose attention the kernel serves: every
    # paged step, and every extend chunk (an extend runs each real row
    # alone, in the chunks of extend_chunks) of at most DECODE_MAX_Q
    # tokens.
    calls = {"step": 0, "short_extend": 0}
    paged_step, paged_extend = model.paged_step, model.paged_extend

    def counted_step(*args):
        calls["step"] += 1
        return paged_step(*args)

    def counted_extend(pool, tables, tokens, *args):
        calls["short_extend"] += short_extend_chunks(tables, args[1])
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
    firsts = FirstLogits(model)
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
        firsts.restore()
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
    firsts.gate("f32 serving", prompts[REPEAT_INDEX])
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
    served = dict(model=model, prompts=all_prompts, answers=answers)
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
    return launches, numbers, served


#: The quantized serving path: --kv-dtype int8 --weight-dtype int8 --spec
#: at --spec-max-k 4 (verifies of up to 5 columns).  Beside the mixed wave,
#: two prompts that repeat a short pattern, where the n-gram drafter
#: finds its matches.
SPEC_K = 4
REPEATING = ((8, 8), (5, 30))   # (pattern length, repeats)
TOKEN = "chip-smoke"


class CallLog(object):
    """Wraps a model's paged entry points and a pool's block copy: counts
    the times a call's attention went through a decode kernel (see
    :meth:`programs`; one launch per block each) and, while recording,
    keeps every call's inputs and output in order, with the pool's
    contents at the start, so the run can be replayed call for call."""

    KINDS = ("paged_extend", "paged_step", "paged_verify")

    def __init__(self, model):
        self.model = model
        self.originals = {k: getattr(model, k) for k in self.KINDS}
        self.records, self.snapshot, self.recording = [], None, False
        self.calls = {}
        for kind in self.KINDS:
            setattr(model, kind, self._wrap(kind))

    def _wrap(self, kind):
        import numpy
        from veles_tpu_torch.ops import decode_attention as DA
        fn = self.originals[kind]

        def call(pool, *args, **kw):
            out = fn(pool, *args, **kw)
            n = self.programs(kind, pool, args, out)
            if n:
                self.calls[kind] = self.calls.get(kind, 0) + n
            if self.recording:
                self.records.append((kind, [numpy.array(a) for a in args],
                                     numpy.array(out)))
            return out
        return call

    @staticmethod
    def programs(kind, pool, args, out):
        """How many times a call ran its attention through a decode
        kernel (one launch per block each).  A step, and on the f32
        plane a verify, once; an extend runs each real row alone, once
        per chunk of at most DECODE_MAX_Q tokens
        (``short_extend_chunks``);
        on the int8/fp8 planes a verify runs the step program once per
        column reached: 1 + the most drafts a row accepted."""
        import numpy
        from veles_tpu_torch.serving.speculation import accept_lengths
        scaled = pool.kv_dtype in ("int8", "fp8")
        if kind == "paged_extend":
            return short_extend_chunks(args[0], args[3])
        if kind == "paged_verify" and scaled:
            toks = numpy.asarray(args[2])
            return 1 + int(accept_lengths(toks[:, 1:], args[3],
                                          out).max())
        return 1

    def watch(self, pool):
        """Records the pool's block copies (copy-on-write) and, on a
        scaled plane, the zeroing of freshly allocated blocks."""
        fn, reset_fn = pool._copy_fn, pool._reset_fn

        def copy(storage, src, dst):
            if self.recording:
                self.records.append(("copy", (src, dst), None))
            return fn(storage, src, dst)

        def reset(storage, ids):
            if self.recording:
                self.records.append(("reset", list(ids), None))
            return reset_fn(storage, ids)
        pool._copy_fn = copy
        if reset_fn is not None:
            pool._reset_fn = reset

    def start(self, pool):
        import torch
        torch.cuda.synchronize()
        self.snapshot = [[t.clone() for t in group]
                         for group in pool.storage]
        self.records, self.calls, self.recording = [], {}, True

    def stop(self):
        self.recording = False
        return self.records, self.snapshot

    def kernel_calls(self):
        return sum(self.calls.values())

    def restore(self):
        for kind, fn in self.originals.items():
            setattr(self.model, kind, fn)

    def replay(self, records, snapshot, pool_args):
        """Every recorded call again, in order, on a pool that starts
        from the snapshot, with the kernels — which rebuilds the served
        run's planes call by call — and, before each call, the same call
        on a copy of the pool as it stands with the plain attention
        (dequantize + the dense softmax): B5 against its plain version
        on the same int8 planes, at every call of the main path.
        Returns (calls compared, mismatches of the plain version,
        mismatches of the kernel replay, mismatches of an independent
        plain replay), each mismatch (call, kind, row) where the output
        of a real row (columns up to its draft count, for a verify)
        differs from the served one.  The independent replay runs the
        plain attention alone from the snapshot, so its planes drift
        from the served ones as quantization amplifies the ulp-level
        differences of the sums: a reading, not a gate."""
        import copy
        from veles_tpu_torch.ops import decode_attention as DA
        pools = [self.model.make_kv_pool(*pool_args) for _ in range(2)]
        for pool in pools:
            for group, saved in zip(pool.storage, snapshot):
                for t, s in zip(group, saved):
                    t.copy_(s)
        main, alone = pools
        bad = {"plain": [], "kernel": [], "alone": []}
        compared = 0
        for i, (kind, args, want) in enumerate(records):
            if kind == "copy":
                for pool in pools:
                    self.model._kv_copy_block(pool.storage, *args)
                continue
            if kind == "reset":
                for pool in pools:
                    self.model._kv_reset_blocks(pool.storage, args)
                continue
            compared += 1
            fn = self.originals[kind]
            scratch = copy.copy(main)
            scratch.storage = tuple([t.clone() for t in group]
                                    for group in main.storage)
            ref = DA.decode_attention_reference
            outs = {"plain": fn(scratch, *args, attend=ref),
                    "kernel": fn(main, *args),
                    "alone": fn(alone, *args, attend=ref)}
            del scratch
            for name, got in outs.items():
                if not self.same(kind, args, got, want):
                    bad[name].append((i, kind))
        return compared, bad["plain"], bad["kernel"], bad["alone"]

    @staticmethod
    def same(kind, args, got, want):
        """Whether every real row (a table that is not all trash) of a
        call's output equals the served one, over the columns up to its
        draft count for a verify."""
        import numpy
        for r in numpy.flatnonzero(args[0][:, 0] != 0):
            n = int(args[3][r]) + 1 if kind == "paged_verify" else None
            if not numpy.array_equal(got[r, :n] if n else got[r],
                                     want[r, :n] if n else want[r]):
                return False
        return True


def gate_replay(name, replayed):
    """The replay's gate: every call of the run, with the plain
    attention on the same planes, answers as served; the kernel replay
    rebuilt those planes bit for bit."""
    compared, plain, kernel, alone = replayed
    print("%s check: %d device calls replayed; with attend = the plain "
          "quant reference on the same planes %d differ, the kernel "
          "replay %d, an independent plain replay %d %s" % (
              name, compared, len(plain), len(kernel), len(alone),
              alone[:6]))
    if plain or kernel or not compared:
        fail("%s: the served tokens differ from the plain-quant attention "
             "on the same planes at %s, from the kernel replay at %s" % (
                 name, plain[:10], kernel[:10]))


def gate_spec_vs_plain(spec, plain):
    """The --spec answers against the same server's without --spec on
    the int8 planes, token for token.  On a scaled plane what a block
    stores depends on how its positions were grouped into writes and on
    the exact floats written, so the port makes each row's run a
    function of the row alone there: a verify runs the plain step
    program column by column and writes only accepted positions, and an
    extend runs each row alone (``ExportedModel.paged_verify``,
    ``paged_extend``)."""
    for i, (a, b) in enumerate(zip(spec, plain)):
        if a != b:
            fail("int8 --spec answer %d differs from the answer without "
                 "--spec at generated position %d" % (
                     i, divergence(a, b)[0]))
    print("int8 --spec serving check: %d answers token-identical to the "
          "same server's without --spec" % len(spec))


def replay_readings(replayed):
    compared, plain, kernel, alone = replayed
    return {"calls": compared, "plain_same_planes_mismatches": len(plain),
            "kernel_replay_mismatches": len(kernel),
            "independent_plain_mismatches": len(alone)}


def profile_decode_steps(model):
    """One warm decode step of the 8-row batch over 1024-position tables
    (blocks 1..64 of a fresh pool per row), profiled on the f32 plane
    with f32 weights and on the int8 plane with int8 weights."""
    import numpy
    from veles_tpu_torch.config import root
    mode = root.common.serving.weight_dtype
    per = POSITIONS // KV_BLOCK
    tables = (1 + numpy.arange(MAX_BATCH * per, dtype=numpy.int32)
              ).reshape(MAX_BATCH, per)
    pos = numpy.full(MAX_BATCH, POSITIONS - 1, numpy.int32)
    zeros = numpy.zeros(MAX_BATCH, numpy.int32)
    out = {}
    for kv_dtype, weights in (("f32", "f32"), ("int8", "int8")):
        root.common.serving.weight_dtype = weights
        pool = model.make_kv_pool(MAX_BATCH * per + 1, KV_BLOCK,
                                  kv_dtype=kv_dtype)

        def step():
            model.paged_step(pool, tables, pos, zeros, zeros,
                             numpy.zeros(MAX_BATCH, numpy.float32),
                             numpy.zeros(MAX_BATCH, numpy.uint32))

        step()
        out["%s/%s" % (kv_dtype, weights)] = profile_tick(
            step, "decode step B=%d L=%d, %s KV plane, %s weights" % (
                MAX_BATCH, POSITIONS, kv_dtype, weights))
        del pool
    root.common.serving.weight_dtype = mode
    return out


def quant_prompts(prompts):
    import numpy
    rng = numpy.random.RandomState(SEED % (1 << 31) + 1)
    return list(prompts[:len(PROMPT_LENGTHS)]) + [
        numpy.tile(rng.randint(0, VOCAB, n), reps).tolist()
        for n, reps in REPEATING]


def serve_wave(model, prompts, repeat, log=None, **server_kw):
    """A server on ``model`` with ``--warmup`` and ``server_kw``; the
    decode-kernel counts and ``log``'s counts and records zeroed just
    before ``prompts`` go out as one concurrent wave of /api/generate
    requests and ``repeat`` one by one after it, and read just after;
    each prompt of ``repeat`` (one of ``prompts``, whole blocks long)
    must sample its first token from its first serving's logits, bit
    for bit.  Returns (answers, numbers) with the server still running
    in numbers["server"]."""
    import torch
    from veles_tpu_torch.ops import decode_attention as DA
    from veles_tpu_torch.restful import ModelServer
    server = ModelServer(model, host="127.0.0.1", port=0,
                         max_batch=MAX_BATCH, kv_block_size=KV_BLOCK,
                         deadline=600.0, warmup=True, token=TOKEN,
                         **server_kw)
    t0 = time.monotonic()
    server.start()
    torch.cuda.synchronize()
    warmup_s = time.monotonic() - t0
    base = "http://127.0.0.1:%d" % server.port
    if log is not None:
        log.watch(server.engine.kv_pool)
        log.start(server.engine.kv_pool)
    torch.cuda.reset_peak_memory_stats()
    DA.decode_attention.launches = DA.decode_attention.quant_launches = 0
    firsts = FirstLogits(model)
    try:
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
            futs = [ex.submit(post, base + "/api/generate",
                              {"tokens": [p], "max_new_tokens": MAX_NEW},
                              token=TOKEN) for p in prompts]
            answers = [f.result()["generated"][0] for f in futs]
        wave_s = time.monotonic() - t0
        for p in repeat:
            answers.append(post(base + "/api/generate", {
                "tokens": [p], "max_new_tokens": MAX_NEW},
                token=TOKEN)["generated"][0])
        torch.cuda.synchronize()
    finally:
        firsts.restore()
    name = "%s%s serving" % (server.engine.kv_pool.kv_dtype,
                             " --spec" if server_kw.get("spec") else "")
    for p in repeat:
        firsts.gate(name, p)
    numbers = dict(
        server=server, base=base, warmup_s=warmup_s, wave_s=wave_s,
        b4=DA.decode_attention.launches, b5=DA.decode_attention.quant_launches,
        peak=torch.cuda.max_memory_allocated(), stats=get(base + "/stats"))
    if log is not None:
        numbers["calls"] = dict(log.calls)
        numbers["records"], numbers["snapshot"] = log.stop()
    return answers, numbers


def divergence(got, want):
    """(first position where two answers differ or their length, share
    of equal positions)."""
    first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 len(want))
    return first, sum(a == b for a, b in zip(got, want)) / len(want)


def check_launches(name, numbers, log, b4, b5):
    """The decode kernels launched what the run implies: one launch per
    block for each call ``log`` counted, on the kernel the pool's plane
    calls for (``b4``/``b5``: whether that kernel serves this run)."""
    implied = BLOCKS * log.kernel_calls()
    want = (implied if b4 else 0, implied if b5 else 0)
    got = (numbers["b4"], numbers["b5"])
    print("%s: device calls through a decode kernel %s, launches B4 %d, "
          "B5 %d (implied %s = %d layers x calls)" % (
              name, dict(log.calls), got[0], got[1], want, BLOCKS))
    if got != want or implied == 0:
        fail("%s: decode kernels launched B4 %d, B5 %d times; the run "
             "implies %s" % (name, got[0], got[1], want))


def phase_f32_spec(served, log):
    """The f32 plane with --spec: verify chunks of K+1 rows through B4.
    Greedy answers equal the f32 server's without --spec, token for
    token: every verify column is the argmax over what a plain step
    would compute."""
    answers, numbers = serve_wave(
        served["model"], served["prompts"][:-1], served["prompts"][-1:],
        log=log, spec=True, spec_max_k=SPEC_K)
    numbers["server"].stop(drain=True)
    check_launches("f32 --spec serving", numbers, log, True, False)
    for i, (got, want) in enumerate(zip(answers, served["answers"])):
        if got != want:
            fail("f32 --spec answer %d differs from the f32 answer without "
                 "--spec at generated position %d" % (
                     i, divergence(got, want)[0]))
    c = numbers["stats"]["counters"]
    print("f32 --spec serving check: %d answers token-identical to the f32 "
          "answers without --spec (%d verify rounds, %d of %d drafts "
          "accepted)" % (len(answers), c.get("spec.rounds", 0),
                         c.get("spec.accepted", 0), c.get("spec.drafted",
                                                         0)))
    return {"verify_rounds": c.get("spec.rounds", 0),
            "accepted": c.get("spec.accepted", 0),
            "drafted": c.get("spec.drafted", 0)}


def phase_quant_serving(served, reload_path, smi):
    """The quantized serving path at full width: the f32-weight artifact
    served with --kv-dtype int8 --weight-dtype int8 --spec; every
    device call of the run replayed on the plain attention (dequantize
    + dense softmax) from the same pool contents; B5's launch count; a
    second server without --spec for readings; then POST /admin/reload
    to an artifact of the same geometry from another seed, whose wave is
    replayed the same way with the new weights."""
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import decode_attention as DA
    from veles_tpu_torch.serving.reload import write_manifest
    model = served["model"]
    prompts = quant_prompts(served["prompts"])
    repeat = [prompts[REPEAT_INDEX]]
    log = CallLog(model)
    out = {}
    try:
        out["f32_spec"] = phase_f32_spec(served, log)
        root.common.serving.weight_dtype = "int8"
        plain, plain_numbers = serve_wave(model, prompts, repeat,
                                          kv_dtype="int8")
        plain_numbers["server"].stop(drain=True)
        answers, numbers = serve_wave(model, prompts, repeat, log=log,
                                      kv_dtype="int8", spec=True,
                                      spec_max_k=SPEC_K)
        server, base = numbers["server"], numbers["base"]
        pool = server.engine.kv_pool
        pool_args = (pool.n_blocks, pool.block_size, pool.kv_dtype)
        try:
            check_launches("int8 --spec serving", numbers, log, False, True)
            replayed = log.replay(numbers["records"], numbers["snapshot"],
                                  pool_args)
            gate_replay("int8 --spec serving", replayed)
            gate_spec_vs_plain(answers, plain)
            nll = nll_delta(served)   # the weights that served the answers
            codes_before = model._lm_params()["blocks"][0]["wq"].clone()
            write_manifest(reload_path)
            t0 = time.monotonic()
            reply = post(base + "/admin/reload", {"artifact": reload_path},
                         token=TOKEN)
            reload_s = time.monotonic() - t0
            log.start(pool)
            DA.decode_attention.launches = 0
            DA.decode_attention.quant_launches = 0
            after = [post(base + "/api/generate", {
                "tokens": [p], "max_new_tokens": MAX_NEW},
                token=TOKEN)["generated"][0] for p in prompts[:3]]
            torch.cuda.synchronize()
            after_numbers = dict(b4=DA.decode_attention.launches,
                                 b5=DA.decode_attention.quant_launches)
            records, snapshot = log.stop()
            stats_after = get(base + "/stats")
            check_launches("int8 --spec serving after the reload",
                           after_numbers, log, False, True)
            params = model._lm_params()
            codes_after = params["blocks"][0]["wq"]
            requantized = model._device_weights()["blocks"][0]["wq"]
            want_codes = torch.clamp(torch.round(
                requantized / torch.where(params["blocks"][0]["wq__s"] > 0,
                                          params["blocks"][0]["wq__s"], 1.0)),
                -127, 127).to(torch.int8)
            r_replayed = log.replay(records, snapshot, pool_args)
        finally:
            server.stop(drain=True)
    finally:
        log.restore()
    version = (reply.get("weight_version"), stats_after["weight_version"])
    print("reload: POST /admin/reload %.1f s -> %s; weight_version %s; "
          "int8 codes of block 0's wq rebuilt from the new weights: %s, "
          "differ from before: %s" % (
              reload_s, reply.get("status"), version,
              bool(torch.equal(codes_after, want_codes)),
              not torch.equal(codes_after, codes_before)))
    if version != (2, 2):
        fail("weight_version after the reload is %s, not 2" % (version,))
    gate_replay("int8 --spec serving after the reload, new weights",
                r_replayed)
    if codes_after.dtype != torch.int8 or \
            not torch.equal(codes_after, want_codes) or \
            torch.equal(codes_after, codes_before):
        fail("the int8 decode parameters were not rebuilt from the new "
             "weights")
    out.update(reload_s=reload_s, replay=replay_readings(replayed),
               reload_replay=replay_readings(r_replayed))
    out.update(quant_readings(served, prompts, answers, numbers, plain,
                              nll, smi))
    out["spec_vs_plain_more_sets"] = spec_divergence_readings(model)
    out["step_profiles"] = profile_decode_steps(model)
    return numbers["b5"], out


#: Further prompt sets (numpy seeds) for the int8 --spec check.
MORE_SPEC_SETS = (1, 2)


def spec_divergence_readings(model):
    """The int8 --spec answers against the same server's without --spec
    on further prompt sets (built as the gated wave is, from other
    seeds; the reloaded weights), token for token, as the gated wave:
    returns the first divergence of each answer."""
    import numpy
    out = {}
    for seed in MORE_SPEC_SETS:
        rng = numpy.random.RandomState(SEED % (1 << 31) + 100 * seed)
        prompts = quant_prompts([rng.randint(0, VOCAB, n).tolist()
                                 for n in PROMPT_LENGTHS])
        repeat = [prompts[REPEAT_INDEX]]
        answers = {}
        for spec in (False, True):
            answers[spec], numbers = serve_wave(
                model, prompts, repeat, kv_dtype="int8", spec=spec,
                spec_max_k=SPEC_K)
            numbers["server"].stop(drain=True)
        out[seed] = [divergence(a, b)[0]
                     for a, b in zip(answers[True], answers[False])]
    parted = sum(d < MAX_NEW for firsts in out.values() for d in firsts)
    total = sum(len(firsts) for firsts in out.values())
    print("int8 --spec vs without --spec on %d more prompt sets (the "
          "reloaded weights): first divergence per answer %s; %d of %d "
          "answers part" % (len(out), out, parted, total))
    if parted:
        fail("int8 --spec answers differ from the same server's without "
             "--spec on further prompt sets: %s" % out)
    return {"first_divergence": out, "parted": parted, "answers": total}


def quant_readings(served, prompts, answers, numbers, plain, nll, smi):
    """Readings of the quantized run, no gate: the wave's tok/s, TTFT and
    decode step; peak memory and the pool's block bytes against f32;
    speculation's acceptance; how the answers track the same server
    without --spec and the f32 answers; the teacher-forced NLL delta of
    the int8 weights against f32."""
    stats = numbers["stats"]
    c, g, lat = stats["counters"], stats["gauges"], stats["latency"]
    pool = stats["kv_pool"]
    L, H, D = served["model"]._paged_geometry()
    f32_block = 2 * L * KV_BLOCK * H * D * 4
    spec_vs_plain = [divergence(a, b) for a, b in zip(answers, plain)]
    # The f32 answers: the wave's prompts and the repeated one.
    n = len(PROMPT_LENGTHS)
    pairs = list(zip(plain[:n], served["answers"][:n])) + \
        [(plain[-1], served["answers"][-1])]
    vs_f32 = [divergence(a, b) for a, b in pairs]
    r = {
        "wave_tok_per_s": MAX_NEW * len(prompts) / numbers["wave_s"],
        "wave_seconds": numbers["wave_s"],
        "warmup_s": numbers["warmup_s"],
        "ttft_median_ms": lat.get("ttft.generate", {}).get("p50_ms"),
        "ttft_largest_ms": lat.get("ttft.generate", {}).get("p99_ms"),
        "itl_p50_ms": lat.get("itl.decode", {}).get("p50_ms"),
        "peak_bytes": numbers["peak"],
        "block_bytes": pool["block_bytes"],
        "f32_block_bytes": f32_block,
        "kv_bytes_total": pool["bytes_total"],
        "spec_rounds": c.get("spec.rounds", 0),
        "spec_drafted": c.get("spec.drafted", 0),
        "spec_accepted": c.get("spec.accepted", 0),
        "spec_accept_rate_ewma": g.get("spec.accept_rate"),
        "spec_tokens_per_step_ewma": g.get("spec.tokens_per_step"),
        "decode_steps": c.get("batches.decode", 0),
        "verify_batches": c.get("batches.verify", 0),
        "spec_vs_plain_first_divergence": [d for d, _ in spec_vs_plain],
        "spec_vs_plain_match_share": sum(m for _, m in spec_vs_plain) /
        len(spec_vs_plain),
        "int8_vs_f32_first_divergence": [d for d, _ in vs_f32],
        "int8_vs_f32_match_share": sum(m for _, m in vs_f32) / len(vs_f32),
        "nll": nll,
    }
    print("int8 --spec serving readings on %s (one wave, not a benchmark): "
          "%d concurrent requests, %d tokens in %.3f s = %.1f tok/s; TTFT "
          "median %s ms, largest %s ms; decode step p50 %s ms; peak device "
          "memory %.2f GB; pool block %d bytes (f32: %d, %.3fx); %d verify "
          "rounds, %d of %d drafts accepted (EWMA accept %s, tokens per "
          "verify %s)" % (
              smi, len(prompts), MAX_NEW * len(prompts), r["wave_seconds"],
              r["wave_tok_per_s"], r["ttft_median_ms"], r["ttft_largest_ms"],
              r["itl_p50_ms"], r["peak_bytes"] / 1e9, r["block_bytes"],
              f32_block, r["block_bytes"] / f32_block, r["spec_rounds"],
              r["spec_accepted"], r["spec_drafted"],
              r["spec_accept_rate_ewma"], r["spec_tokens_per_step_ewma"]))
    print("int8 readings: --spec vs the same server without --spec, first "
          "divergence per answer %s (match share %.4f); int8/int8 without "
          "--spec vs the f32 answers %s (match share %.4f); weight int8 "
          "teacher-forced NLL %s" % (
              r["spec_vs_plain_first_divergence"],
              r["spec_vs_plain_match_share"],
              r["int8_vs_f32_first_divergence"],
              r["int8_vs_f32_match_share"], r["nll"]))
    return r


def nll_delta(served):
    """Teacher-forced mean NLL of each f32 answer's tokens (the model's
    own greedy text), every position predicted from its true prefix in
    one padded batch per answer, under the f32 and the int8 decode
    weights; the int8 delta in nats."""
    import numpy
    from veles_tpu_torch.config import root
    model = served["model"]
    mode = root.common.serving.weight_dtype
    nll = {}
    for weights in ("f32", "int8"):
        root.common.serving.weight_dtype = weights
        total, count = 0.0, 0
        for prompt, answer in zip(served["prompts"], served["answers"]):
            text = numpy.asarray(prompt + answer, numpy.int32)
            lengths = len(prompt) + numpy.arange(len(answer))
            width = 1 << int(lengths.max() - 1).bit_length()
            rows = numpy.zeros((len(answer), width), numpy.int32)
            for i, n in enumerate(lengths):
                rows[i, :n] = text[:n]
            _, logits = model.generate_bucketed(rows, lengths, 1,
                                                return_logits=True)
            z = logits[:, 0].astype(numpy.float64)
            lse = z.max(-1) + numpy.log(numpy.exp(
                z - z.max(-1, keepdims=True)).sum(-1))
            total -= (z[numpy.arange(len(answer)), answer] - lse).sum()
            count += len(answer)
        nll[weights] = total / count
    root.common.serving.weight_dtype = mode
    return {"f32": nll["f32"], "int8": nll["int8"],
            "delta": nll["int8"] - nll["f32"]}


def phase_fp8(served):
    """One fp8 pass through the model API, no HTTP: a batch of four
    prompts extended into a float8_e4m3fn pool and stepped to MAX_NEW
    tokens with the kernels (int8 weights), every call replayed with the
    plain quant reference on the same planes; B5 launched once per block
    for each step."""
    import numpy
    import torch
    from veles_tpu_torch.ops import decode_attention as DA
    model = served["model"]
    prompts = [served["prompts"][i] for i in (0, 2, 3, 4)]
    lengths = numpy.array([len(p) for p in prompts], numpy.int32)
    B = len(prompts)
    per = -(-(int(lengths.max()) + MAX_NEW) // KV_BLOCK)
    tables = (1 + numpy.arange(B * per, dtype=numpy.int32)).reshape(B, per)
    width = 1 << int(lengths.max() - 1).bit_length()
    tokens = numpy.zeros((B, width), numpy.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    zeros = numpy.zeros(B, numpy.float32)
    seeds = numpy.zeros(B, numpy.uint32)
    log = CallLog(model)
    try:
        pool = model.make_kv_pool(B * per + 1, KV_BLOCK, kv_dtype="fp8")
        log.start(pool)
        DA.decode_attention.launches = DA.decode_attention.quant_launches = 0
        tok = model.paged_extend(pool, tables, tokens,
                                 numpy.zeros(B, numpy.int32), lengths,
                                 zeros, seeds)
        out = [tok]
        for j in range(1, MAX_NEW):
            tok = model.paged_step(pool, tables, lengths + j - 1, tok,
                                   numpy.full(B, j, numpy.int32), zeros,
                                   seeds)
            out.append(tok)
        torch.cuda.synchronize()
        numbers = dict(b4=DA.decode_attention.launches,
                       b5=DA.decode_attention.quant_launches)
        records, snapshot = log.stop()
        replayed = log.replay(records, snapshot,
                              (pool.n_blocks, KV_BLOCK, "fp8"))
        check_launches("fp8 pass (model API, %d prompts of %s tokens, %d "
                       "tokens each)" % (B, lengths.tolist(), MAX_NEW),
                       numbers, log, False, True)
    finally:
        log.restore()
    gate_replay("fp8 pass", replayed)
    prefix_hit_exact(model, "fp8", served["prompts"][REPEAT_INDEX])
    return {"launches_b5": numbers["b5"], "tokens": B * MAX_NEW,
            "replay": replay_readings(replayed)}


def row_count_reading(model):
    """Whether a row's result depends on how many rows share the call —
    8 rows (a decode step at max_batch) alone against the same 8 among
    40 (a verify chunk of 5 columns), at rows 5-12 of the 40, so that
    their ``DECODE_ROWS``-row product holds other rows there and zero
    padding alone — for each product of block 0 and the head under both
    weight modes, and for the layer norm.  Every one runs on ``DECODE_ROWS``-row chunks, so each must
    be bit for bit: a difference fails.  Returns {name: largest
    difference}."""
    import torch
    from veles_tpu_torch import export as X
    from veles_tpu_torch.config import root
    mode = root.common.serving.weight_dtype
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for weights in ("f32", "int8"):
        root.common.serving.weight_dtype = weights
        params = model._lm_params()
        block = params["blocks"][0]
        for name, p in [(n, block) for n in ("wq", "w1", "w2")] + \
                [("head_w", params)]:
            h = torch.randn(40, p[name].shape[0], device="cuda",
                            generator=gen)
            alone = X._mm(h[5:13], p, name)
            among = X._mm(h, p, name)[5:13]
            out["%s %s" % (weights, name)] = float(
                (alone - among).abs().max())
    root.common.serving.weight_dtype = mode
    g = torch.ones(EMBED, device="cuda")
    x = torch.randn(40, EMBED, device="cuda", generator=gen)
    out["layer norm"] = float((X._ln(x[5:13], g, g * 0) -
                               X._ln(x, g, g * 0)[5:13]).abs().max())
    print("row-count check: largest difference of 8 rows alone against "
          "the same rows at 5-12 among 40 (0 = bit for bit): %s" % out)
    if any(out.values()):
        fail("a decode-program product or layer norm depends on the "
             "call's row count: %s" % out)
    return out


def phase_verify_exact(served):
    """On the int8 and fp8 planes a verify answers and stores exactly
    what plain steps do (model API, no HTTP, int8 weights).  Four
    prompts are extended, then SPEC_K + 1 plain steps run (the pool
    copied after each); from the extended pool one verify follows whose
    drafts are the steps' own tokens, except that row 1's second draft
    is wrong and row 3 has none.  Gates: every column a row reached
    equals the step's token, and each row's blocks hold bit for bit
    what the plain steps left after 1 + its accepted drafts."""
    import numpy
    import torch
    from veles_tpu_torch.serving.speculation import accept_lengths
    model = served["model"]
    prompts = [served["prompts"][i] for i in (1, 2, 3, 5)]
    lengths = numpy.array([len(p) for p in prompts], numpy.int32)
    B = len(prompts)
    per = -(-(int(lengths.max()) + SPEC_K + 1) // KV_BLOCK)
    tables = (1 + numpy.arange(B * per, dtype=numpy.int32)).reshape(B, per)
    tokens = numpy.zeros((B, int(lengths.max())), numpy.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    zeros = numpy.zeros(B, numpy.float32)
    seeds = numpy.zeros(B, numpy.uint32)
    out = {}
    for kv_dtype in ("int8", "fp8"):
        pool = model.make_kv_pool(B * per + 1, KV_BLOCK, kv_dtype=kv_dtype)
        tok = model.paged_extend(pool, tables, tokens,
                                 numpy.zeros(B, numpy.int32), lengths,
                                 zeros, seeds)
        start = [[t.clone() for t in group] for group in pool.storage]
        steps, after = [tok], []
        for j in range(SPEC_K + 1):
            steps.append(model.paged_step(
                pool, tables, lengths + j, steps[-1],
                numpy.full(B, j + 1, numpy.int32), zeros, seeds))
            after.append([[t.clone() for t in group]
                          for group in pool.storage])
        for group, saved in zip(pool.storage, start):
            for t, s in zip(group, saved):
                t.copy_(s)
        steps = numpy.stack(steps, axis=1)   # (B, SPEC_K + 2)
        toks = steps[:, :SPEC_K + 1].copy()
        toks[1, 2] = (toks[1, 2] + 1) % VOCAB
        dlens = numpy.array([SPEC_K, SPEC_K, SPEC_K, 0])
        got = model.paged_verify(pool, tables, lengths, toks, dlens,
                                 numpy.ones(B, numpy.int32), zeros, seeds)
        acc = accept_lengths(toks[:, 1:], dlens, got)
        torch.cuda.synchronize()
        for r in range(B):
            a = int(acc[r])
            if not numpy.array_equal(got[r, :a + 1], steps[r, 1:a + 2]):
                fail("%s verify row %d answers %s, plain steps %s" % (
                    kv_dtype, r, got[r].tolist(), steps[r].tolist()))
            blocks = torch.as_tensor(tables[r], dtype=torch.long,
                                     device=pool.storage[0][0].device)
            for group, saved in zip(pool.storage, after[a]):
                for t, s in zip(group, saved):
                    if not torch.equal(t[blocks], s[blocks]):
                        fail("%s verify row %d (%d drafts accepted) left "
                             "other planes than %d plain steps" % (
                                 kv_dtype, r, a, a + 1))
        out[kv_dtype] = acc.tolist()
        del pool, start, after
    print("verify on the scaled planes: tokens and every row's blocks "
          "bit-equal to plain steps (accepted drafts per row %s)" % out)
    return out


def main():
    started = time.monotonic()
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
    from veles_tpu_torch.ops import flash_attention as FA
    resolve_device("cuda")  # TF32 off, as every port entry point sets
    phase_build()
    max_err, timings = phase_kernels()
    quant_worst, quant_faults, quant_b4_equal, inv_rows, quant_times = \
        phase_quant_kernels()
    flash_err, split_shares, flash_times = phase_flash_kernels()
    lrn_err, lrn_worst, lrn_faults_read, lrn_equal, lrn_times = \
        phase_lrn_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    flash_launches, training = phase_training(smi)
    gc.collect()
    torch.cuda.empty_cache()
    lrn_launches, lrn_routes, alexnet = phase_alexnet(smi)
    gc.collect()
    torch.cuda.empty_cache()
    workdir = os.path.join(HERE, ".chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        launches, numbers, served = phase_serving(workdir, smi)
        reload_path = os.path.join(workdir, "lm-reload.veles.tgz")
        t0 = time.monotonic()
        from veles_tpu_torch import export as X
        X.random_lm_artifact(reload_path, VOCAB, EMBED, HEADS, BLOCKS,
                             HIDDEN, POSITIONS, seed=SEED + 1,
                             compresslevel=0)
        print("reload artifact write: %.1f s (seed %d)" % (
            time.monotonic() - t0, SEED + 1))
        quant_launches, quant = phase_quant_serving(served, reload_path,
                                                    smi)
        quant["fp8"] = phase_fp8(served)
        quant["verify_exact_accepted"] = phase_verify_exact(served)
        quant["row_count_reading"] = row_count_reading(served["model"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    step, step16 = timings[(1, POSITIONS)], timings[(16, POSITIONS)]
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
        "timer": "CUDA events around a CUDA graph of launches rotating "
                 "among input copies of more than twice the L2",
        "ms": step["kernel_ms"],
        "kernel_ms": step["kernel_ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"],
        "share_of_bound": step["share"],
        "library_ms": step["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "verify_sq16": {k: step16[k] for k in (
            "kernel_ms", "plain_ms", "library_ms", "bound_ms", "share")},
        "l256": {k: timings[(1, 256)][k] for k in (
            "kernel_ms", "plain_ms", "library_ms", "bound_ms", "share")},
        "row_invariance": inv_rows["f32"],
    }]}
    q8, q8v = quant_times[("int8", 1)], quant_times[("int8", 16)]
    kernels["kernels"].append({
        "name": "decode_attention_quant",
        "route": "cuda",
        "source": "veles_tpu_torch/ops/csrc/decode_attention.cu",
        "replaces": "veles_tpu/ops/pallas_attention.py:639",
        "shape": "B=%d Sq=1 H=%d D=%d L=%d int8 codes, (B, L, H) f32 "
                 "scales" % (MAX_BATCH, HEADS, EMBED // HEADS, POSITIONS),
        "launches": quant_launches,
        "max_abs_err": max(v[0] for v in quant_worst.values()),
        "max_err_by_code": {k: v[0] for k, v in quant_worst.items()},
        "tol": {"rtol": RTOL, "atol": ATOL},
        "timer": "as decode_attention's",
        "ms": q8["kernel_ms"],
        "plain_ms": q8["plain_ms"],
        "bound_ms": q8["bound_ms"],
        "bound_by": q8["bound_by"],
        "share_of_bound": q8["share"],
        "library_ms": q8["library_ms"],
        "library": "dequantize + torch.nn.functional."
                   "scaled_dot_product_attention",
        "b4_same_keys_f32_ms": q8["b4_f32_ms"],
        "verify_sq16": {k: q8v[k] for k in ("kernel_ms", "b4_f32_ms",
                                            "plain_ms", "library_ms",
                                            "bound_ms", "share")},
        "fp8": {"%s" % sq: {k: quant_times[("fp8", sq)][k] for k in (
            "kernel_ms", "b4_f32_ms", "plain_ms", "library_ms",
            "bound_ms", "share")} for sq in (1, 16)},
        "planted_faults": quant_faults,
        "b5_equals_b4_on_dequantized": "%d/%d" % (
            sum(quant_b4_equal.values()), len(quant_b4_equal)),
        "row_invariance": {k: inv_rows[k] for k in ("int8", "fp8")},
    })
    replaces = {"flash_forward": 211, "flash_dq": 258, "flash_dkv": 293}
    for name, line in replaces.items():
        t = flash_times[name]
        way = FA.route(name, torch.bfloat16, torch.float32)
        entry = {
            "name": name,
            "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/%s" % (
                "flash_attention_tc.cu" if way == "tensor_core"
                else "flash_attention.cu"),
            "replaces": "veles_tpu/ops/pallas_attention.py:%d" % line,
            "shape": "B=%d S=%d H=%d D=%d causal, bf16 storage, f32 "
                     "operands" % (TRAIN_BATCH, POSITIONS, HEADS,
                                   EMBED // HEADS),
            "units": way,
            "launches": flash_launches[name],
            "launches_by_route": training["flash_routes"][name],
            "max_abs_err": flash_err[name],
            "tol": BF16_TOL_TEXT,
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "share_of_bound": t["share_of_bound"],
            "library_ms": t["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention"
                       " (forward)" if t["library_ms"] is not None
                       else None,
            "sdpa_fwd_bwd_ms": t["sdpa_fwd_bwd_ms"],
        }
        if name == "flash_forward":
            entry["bf16_operands"] = t["bf16_operands"]
        if name == "flash_dq":
            entry["fp32_units_ms"] = t["fp32_units_ms"]
        entry["b1_b2_b3_ms"] = t["b1_b2_b3_ms"]
        entry["split_check"] = {
            "%s %s" % k: {"kernel_share": v[0], "fault_share": v[1]}
            for k, v in split_shares.items() if SPLIT_KERNEL[k[1]] == name}
        kernels["kernels"].append(entry)
    for name, line in (("lrn_forward", 81), ("lrn_backward", 87)):
        rows = [lrn_times[(name, shape)] for shape, _ in LRN_SHAPES]
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/lrn.cu",
            "replaces": "veles_tpu/ops/pallas_lrn.py:%d" % line,
            "shape": "one call each at %s, bf16, AlexNet constants; the "
                     "times are the two calls' sum (one train tick)" %
                     " and ".join("%s %s" % (n, sh) for n, sh in
                                  LRN_SHAPES),
            "launches": lrn_launches[name],
            "launches_by_route": lrn_routes[name],
            "max_abs_err": lrn_err[name],
            "tol": "f32 fwd rtol %g, bwd %g x the terms' magnitude; bf16 "
                   "fwd 2^-7 x |y|, bwd 2^-7 x (terms' magnitude + |dx|)"
                   % (LRN_F32_RTOL, LRN_F32_RTOL),
            "largest_share_of_tol": {
                "%s %s" % k: v[0] for k, v in lrn_worst.items()},
            "planted_faults": {"%s %s" % (n, lab): f for n, lab, f in
                               lrn_faults_read},
            "register_equals_wide": lrn_equal,
            "timer": "kernels: CUDA events around a CUDA graph of launches "
                     "rotating among input copies of more than twice the "
                     "L2; plain and library: back-to-back calls",
            "ms": sum(r["kernel_ms"] for r in rows),
            "per_shape_ms": [r["kernel_ms"] for r in rows],
            "wide_route_ms": sum(r["wide_ms"] for r in rows),
            "wide_route_per_shape_ms": [r["wide_ms"] for r in rows],
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": rows[0]["bound_by"],
            "share_of_bound": sum(r["bound_ms"] for r in rows) /
            sum(r["kernel_ms"] for r in rows),
            "per_shape_share_of_bound": [r["share"] for r in rows],
            # No one PyTorch call computes the backward alone: its
            # yardstick is the library's forward+backward, kept apart.
            "library_ms": sum(r["library_ms"] for r in rows)
            if name == "lrn_forward" else None,
            "library": "torch.nn.functional.local_response_norm"
            if name == "lrn_forward" else None,
            "library_fwd_bwd_ms": None if name == "lrn_forward" else
            sum(r["library_ms"] for r in rows),
        })
    print(json.dumps({"training": training}))
    print(json.dumps({"alexnet": alexnet}))
    print(json.dumps({"serving": numbers}))
    print(json.dumps({"quant_serving": quant}))
    print(json.dumps(kernels))
    print("chip_smoke: command time %.1f s" % (time.monotonic() - started))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
