#!/usr/bin/env python3
"""Chip smoke check of the PyTorch/CUDA port (``veles_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

(``python3 chip_smoke.py --ranks 4`` on a machine with four cards runs
only the build and the parallel styles as four NCCL ranks, each style's
ticks held to the unsplit tick on card 0, then reads each rank's
parameter bytes — a placed parameter held at its shard's size — and
peak memory: ``phase_ranks``.)

It drives the port's paths once each, at full width — training
the TinyLM workflow through the fused tick and serving an exported LM,
both at the LM bench geometry (embed 2048, 16 heads of dim 128, MLP
8192, vocab 16384, positional table / sequence 1024; BLOCKS of the
bench's 12 blocks),
training the full-width ungrouped AlexNet through ``StandardWorkflow``
(227 px, 1000 classes, batch 512) from device memory and streamed from
disk, checkpointing and resuming it, training a TinyLM and serving it
from inside its workflow, pretraining a Kohonen map and an RBM, and
serving the same LM from int8 KV planes with int8 weights, speculative
decoding and a hot reload — with random weights from a seed, in phases;
any failure exits non-zero.  Each phase prints its seconds as it ends
(``timed``), and a process of its own (``chip_smoke.py --prewrite
WORKDIR``, no CUDA) writes the files only the host makes — the streamed
dataset and both LM artifacts — while the card runs the first phases:

1. device — the card's name, count, and ``nvidia-smi`` name and power
   limit; no CUDA fails, nor a CUDA device on which the port left
   ``torch.backends.cudnn.deterministic`` off;
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
5. training — builds the BLOCKS-block TinyLM (bench.py's --lm geometry,
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
6b. snapshots — MNIST FC through the command line on seeded synthetic
   IDX files: a run resumed from ``-s <pointer>`` must equal a straight
   run bit for bit (TF32 off), its pickle must load in a process that
   has not touched CUDA, ``--guardian-policy rollback`` with a planted
   ``step.nan`` must roll back once and converge, the same in two runs,
   and the ``--snapshot-artifact`` artifact is served (``/api`` labels
   == the local argmax, ``/api/generate`` 400); then phase 6's AlexNet
   is snapshotted (codec ""), resumed into a fresh launcher whose train
   tick must pass phase 6's gate against the live one's, and exported:
   the artifact's forward on the card (its two ``norm`` units launch
   B6 on the register route) must match ``forward_numpy`` at rtol 1e-3,
   and a planted B6 fault must fail that gate; the port's
   ``NativeModel`` (``native/veles_infer.cc``, built with g++ into the
   port's build directory) runs the same artifact on the host and must
   match the card's forward at ``tests/test_native.py``'s conv
   tolerances (rtol 1e-3, atol 1e-5) and in the centered logits at
   rtol 1e-2, and the same artifact with its norm units' k planted
   must fail that gate;
6c. streamed — writes the AlexNet dataset to disk (``.npy``: 227 px
   uint8, 1000 classes, 512 validation + 4096 train images, seeded
   ``fill_synthetic``), then trains one epoch at batch 512 (one
   validation and eight train ticks, bfloat16, the LRN kernels) with the
   resident ``ImagenetLoader`` and with ``StreamedImagenetLoader`` from
   memmaps, prefetch on and off: every parameter and optimizer slot, the
   decision's numbers and the LRN launches (B6 18, B7 16, all on the
   register route) must equal the resident run's bit for bit, and a
   planted one-row index shift in ``fill_rows`` must fail that gate;
   the same run through ``python -m veles_tpu_torch <workflow.py>
   <config.py>`` with the numpy.random guard live must reach the same
   validation error and epochs; a snapshot taken mid-epoch with a block
   staged must resume into a fresh launcher that serves the requeued
   block again and whose train tick equals the live one's bit for bit
   (the f32 tick too: twice live and twice resumed under the cuDNN
   setting the port made, all bit-equal; its time with and without
   cuDNN's deterministic algorithms is read in turns); CIFAR's gate
   (``CifarWorkflow``, seed 4242, 5 epochs: validation error < 0.25) and
   the same run with stochastic pooling (finite weights); readings: warm
   train tick p50 resident / streamed / prefetch off, the host's fill
   and the copy per block, the idle share of a profiled streamed tick,
   the dataset write and the mean/disp analysis cold and cached;
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
10a. the serving fabric (``phase_fabric``) over phase 7's model — two
   decode replicas and a prefill worker (``fabric_replicas=2,
   fabric_disagg=True``), tenants ``a`` (a burst of 2) and ``b``:
   phase 7's prompts over loopback HTTP as ``b`` answer token-identical
   to phase 7's gated answers, with KV blocks shipped as f32 over the
   wire, adopted and hit by a decode replica, and B4 launched as the
   calls of the three engines imply; ``a`` draws 2 200s then 429 with
   ``Retry-After`` while ``b`` draws 200, an unknown tenant 403; every
   adopted block bit-equal to the prefill worker's export of the same
   prompt, and planted wire faults (one value of one adopted block
   flipped in sign; one block's k/v scaled by 1000) that must fail that
   gate and the token gate; ``stop(drain=True)`` drops nothing; then an
   int8 wave
   with disaggregated prefill, B5 on the re-quantized adopted blocks,
   every device call of each engine replayed with the plain quant
   attention on the same planes;
7r. in-workflow serving — ``--serve-max-batch 8 --serve-warmup
   --serve-kv-block-size 16 --serve-deadline 60`` through the port's
   command-line parser into ``root.common.serving``; the TinyLM at the
   bench width, cut to INWF_BLOCKS blocks, trains one validation and
   INWF_TICKS train ticks through ``Launcher.run`` (B1-B3, their
   launches held to what the ticks imply) with a ``RESTfulAPI`` unit
   linked after its decision, which exports the workflow (gzip level 9)
   and starts the server on the card; phase 7's prompts and the
   repeated one go out as one concurrent wave: every answer
   token-identical to ``generate(..., attend=decode_attention_
   reference)`` over ``ExportedModel(artifact, device="cuda")``, B4's
   launches as the run implies, and a planted B4 fault (one head of one
   launch's output) must fail the token gate; readings: the export's
   bytes and seconds, the last tick to ``/health``, the wave and its
   TTFT;
7p. pretraining — the Kohonen sample through ``python -m
   veles_tpu_torch ... root.kohonen.max_epochs=12 --random-seed 5`` on
   the card (quantization error < 0.1, a finite 8x8 U-matrix) and
   ``MnistRBMWorkflow`` on the seeded synthetic IDX files (its
   validation reconstruction error falls every epoch of 3);
7g. population — the GA's population step (``PopulationEvaluator``,
   ``torch.func.vmap`` of the train tick over the members): the
   full-width AlexNet, P = 4 members tuning learning_rate and
   gradient_moment over two epochs of one validation and two train
   ticks (B6 twice a vmapped tick and B7 twice a vmapped train tick, on
   the members folded into the batch, register route); each member
   against itself run alone through the sequential tick with its genes
   as hypers; a second generation bit-equal; readings: the vmapped tick
   p50 against P sequential ticks', the peak memory.  Then the
   bench-width TinyLM cut to 2 blocks, P = 2 (B1-B3 as often per vmapped
   tick as per sequential tick, on the fold); then MNIST FC through the
   command line with ``--optimize 4:2``, ``--population 4:2`` and
   ``--ensemble-train 2:0.8`` with ``--ensemble-test``, their result
   files checked;
8p. parallelism — a one-rank NCCL world joined through the port's
   launcher with ``--jax-coordinator/--jax-num-processes/
   --jax-process-id``; (a) the MoE TinyLM at the bench width (2 blocks,
   top-2 of 8 experts, dp×ep): one validation and two train ticks with
   B1-B3, each again from the same state with the plain attention
   (losses within phase 5's rtol), B1-B3 launches as the ticks imply;
   (b) the pipelined TinyLM (2 stacked blocks, 1F1B over 4
   microbatches, dp×pp): its ticks held to the sequential stack's from
   the same state (losses, parameters within phase 5's bound), B1-B3
   launches as the schedule implies, then exported — unstacked into
   transformer blocks — and served to a wave through the paged engine,
   token-identical to the export of the same weights as a sequential
   TinyLM, B4 launches as the wave implies; (c) the ring's chunk loop at
   N = 2 and 4 virtual ranks (``ops.attention.ring_step`` at offsets
   rank·S/N and src·S/N, the training shape): B1 at every offset pair
   the loop implies, N² launches of each kernel, the out and gradients
   held to the plain chunks, the whole-sequence B1-B3 and the plain
   attention (``RING_DTYPES``); (d) MNIST through the command line with
   the ``--jax-*`` flags in the world;
   9n (``phase_net``). the data plane — a master
   ``Launcher(listen_address="127.0.0.1:0")`` holding the full-width
   AlexNet (batch 128) and one worker process on the same card
   (``Launcher(master_address=...)``): one validation job and NET_JOBS
   train jobs of ``--job-ticks 2`` with fp32 deltas, the master's
   parameters after them equal to the in-process run of the same ticks
   bit for bit, the worker's B6/B7 launches 2 + 2 a train tick; one
   train job with bf16 deltas within the codec's rounding bound; the
   fp32 session traced — the master traces, the worker is granted
   ``trace`` and opens a ``torch.profiler`` capture window of 2
   dispatches: both process tracks in the Chrome trace, every
   ``worker.step`` strictly inside its ``server.dispatch`` (a planted
   shift must fail), the worker's ``perf`` summary with step_ms > 0 and
   MFU in (0, 1], ``lrn_fwd_reg``/``lrn_bwd_reg`` in the capture; the
   train tick's p50 with attribution on and off; the
   wire bytes per minibatch; the AlexNet train tick with and without
   ``torch.use_deterministic_algorithms``;
   9f (``phase_fleet``). the fleet — (a) a master
   ``Launcher(listen_address="127.0.0.1:0", nodes=["local", "local"],
   worker_argv=[the MNIST sample, ...])`` spawns two worker processes
   of the command line on the card, one is SIGKILLed with a job in hand
   after five jobs: one drop, one requeue, one respawn on the
   least-loaded node that joins and trains, no minibatch lost, the
   membership epochs printed; (b) PBT over two full-width
   AlexNet members (batch 128, a tuned learning rate) by a
   ``PopulationEngine`` coordinator and one worker process of the
   command line (``--population 2 --pbt -m``): the members equal the
   in-process loopback bit for bit, every exploit job is 50x smaller
   than a full ship, the worker's B6/B7 launches 2 + 2 a train tick;
   10s (``phase_services``). the operator services — the full-width
   AlexNet (batch 128, a confusion matrix kept on the card by its
   evaluator, an ``AccumulatingPlotter``, a ``MatrixPlotter`` and a
   ``Histogram`` linked after the decision, one firing an epoch) trains
   SERVICES_EPOCHS epochs of one validation and two train ticks through
   ``python -m veles_tpu_torch <workflow.py> -a cuda --status-address
   ... --workflow-graph ... --dump-config`` with
   ``root.common.graphics.enabled``, beside a ``WebStatusServer`` and a
   subscriber socket on the graphics stream: two heartbeats during the
   run and the last as it ends,
   the dashboard's ``/api/status`` with the epoch, the metrics and a
   perf row with the tick's device ms and MFU, the DOT graph naming
   every unit, the config dump, one payload per plotter per epoch
   decoded by the port's restricted unpickler (each confusion matrix
   summing to the samples the evaluator counted in its epoch), B6/B7
   launched as the ticks imply on the register route; then a master
   (MNIST FC) and a loopback worker on the card, whose worker a
   ``pause`` queued through ``/service`` pauses by a heartbeat, and a
   ``resume`` resumes;
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
10. exit — drains the servers, prints the training, AlexNet, snapshot,
   streamed, serving, in-workflow serving, pretraining, population,
   parallel, data-plane, fleet and services numbers and the kernels
   (B1-B4's launches from phase 7r too, B1-B3's and B6/B7's from phase
   7g, B6/B7's from the workers of phases 9n and 9f and the command line
   of 10s) as JSON lines, the command's time, the card's name and power
   limit, and ``{"ok": true, "device": {...}}`` last.
"""

import concurrent.futures
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))

#: The LM bench geometry (bench.py's LM_* constants), its depth cut
#: from the bench's 12 blocks to BLOCKS: the trained and the served LM
#: keep every width, and the run keeps to its time limit.
VOCAB, EMBED, HEADS, BLOCKS, HIDDEN, POSITIONS = (16384, 2048, 16, 4,
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


#: What the host alone writes for later phases, in the order they read
#: it: the streamed AlexNet's dataset (phase 6c), the served LM's
#: artifact (phase 7) and the artifact its hot reload loads (phase 8).
PREWRITES = ("dataset", "lm", "reload")


def prewrite_paths(workdir):
    return {"dataset": os.path.join(workdir, "datasets", "imagenet"),
            "lm": os.path.join(workdir, "lm.veles.tgz"),
            "reload": os.path.join(workdir, "lm-reload.veles.tgz")}


def prewrite(workdir):
    """``chip_smoke.py --prewrite WORKDIR``: writes PREWRITES on the
    host (no CUDA), each under its final name once whole, and after
    each a line "NAME SECONDS" in WORKDIR/prewrite.log."""
    sys.path.insert(0, HERE)
    from veles_tpu_torch import export as X
    from veles_tpu_torch.znicz.samples.imagenet import StreamedImagenetLoader
    paths = prewrite_paths(workdir)
    for name in PREWRITES:
        t0 = time.monotonic()
        if name == "dataset":
            # RandomState(0) through fill_synthetic; each file is
            # written under a temporary name and renamed.
            StreamedImagenetLoader(
                None, cache_dir=paths[name], sim_train=STREAM_TRAIN,
                sim_valid=STREAM_VALID, sim_image_size=STREAM_IMAGE,
                sim_classes=1000)._write_synthetic()
        else:
            part = paths[name] + ".part"
            X.random_lm_artifact(part, VOCAB, EMBED, HEADS, BLOCKS, HIDDEN,
                                 POSITIONS, seed=SEED + (name == "reload"),
                                 compresslevel=0)
            os.replace(part, paths[name])
        with open(os.path.join(workdir, "prewrite.log"), "a") as fout:
            fout.write("%s %.3f\n" % (name, time.monotonic() - t0))
    return 0


class Prewriter(object):
    """Runs :func:`prewrite` in a process of its own while the card
    runs the first phases; :meth:`wait` blocks until one of its files
    is whole and returns (its path, the seconds its writing took, the
    seconds this process waited for it)."""

    def __init__(self, workdir):
        self.workdir = workdir
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--prewrite",
             workdir], stdout=sys.stderr.fileno(), env=env)

    def done(self):
        try:
            with open(os.path.join(self.workdir, "prewrite.log")) as fin:
                rows = [line.split() for line in fin if line.strip()]
        except FileNotFoundError:
            return {}
        return {name: float(sec) for name, sec in rows}

    def wait(self, name, deadline=900.0):
        t0 = time.monotonic()
        while name not in self.done():
            if self.proc.poll() is not None and name not in self.done():
                fail("the prewrite process exited %s before writing %s"
                     % (self.proc.returncode, name))
            if time.monotonic() - t0 > deadline:
                fail("the prewrite process did not write %s within %.0f s"
                     % (name, deadline))
            time.sleep(0.2)
        return (prewrite_paths(self.workdir)[name], self.done()[name],
                time.monotonic() - t0)

    def stop(self):
        if self.proc.poll() is None and len(self.done()) == len(PREWRITES):
            try:
                self.proc.wait(30)   # its interpreter's exit
            except subprocess.TimeoutExpired:
                pass
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


#: Set by main: the process writing PREWRITES.
PREWRITER = [None]


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


def synthetic_corpus(n_valid, n_train):
    """bench.py's LM corpus as a loader class: random tokens, next-token
    labels, ``n_valid`` validation and ``n_train`` train sequences."""
    import numpy
    from veles_tpu_torch.znicz.samples.tinylm import FirstTokenLoader

    class SyntheticCorpus(FirstTokenLoader):
        def load_data(self):
            rng = numpy.random.RandomState(0)
            self.original_data.mem = rng.randint(
                0, VOCAB, (n_valid + n_train, POSITIONS)).astype(
                numpy.int32)
            self.original_labels.mem = numpy.roll(
                self.original_data.mem, -1, axis=1)
            self.class_lengths = [0, n_valid, n_train]
    return SyntheticCorpus


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
    from veles_tpu_torch.znicz.samples.tinylm import TinyLMWorkflow
    SyntheticCorpus = synthetic_corpus(TRAIN_BATCH,
                                       TRAIN_BATCH * TRAIN_TICKS)

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


def alexnet_compare(compiler, after, before):
    """Per parameter of ``compiler``'s live state against ``after`` (a
    reference tick's result from the state ``before``): (gap, the
    tick's change, the bound ALEXNET_CHANGE_TOL x change + ALEXNET_FLOOR
    x sqrt(elements), elements)."""
    import math
    rows = {}
    for name, vec in compiler._param_vecs.items():
        now = vec.devmem
        gap = (after[name].to(now.device) - now).norm().item()
        change = (now - before[name].to(now.device)).norm().item()
        rows[name] = (gap, change, ALEXNET_CHANGE_TOL * change +
                      ALEXNET_FLOOR * math.sqrt(now.numel()),
                      now.numel())
    return rows


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
        return alexnet_compare(compiler, after, before)

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
    return launches, by_route, numbers, wf


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


#: MNIST FC on the card: the sample's (100, 10) tanh/softmax stack over
#: seeded synthetic 784-feature data written as IDX files (the card's
#: Python has no scikit-learn for the sample's digits fallback), read by
#: the sample's own IDX path; epochs of the straight run and of the run
#: that snapshots before the resume.
MNIST_TRAIN, MNIST_VALID, MNIST_EPOCHS, MNIST_K = 3000, 600, 3, 2
#: The planted poisoned tick of the rollback runs: the 50th tick, in
#: epoch 1 (36 ticks an epoch), so epoch 0 left a finite generation.
MNIST_CHAOS = "step.nan@50,seed:42"
#: The artifact forward of the full-width AlexNet against forward_numpy:
#: the JAX artifact gate's rtol (tests/test_export.py); its atol 1e-4 is
#: sized for 10-class outputs near 0.1 and would pass anything among
#: AlexNet's 1000 probabilities near 1e-3, so the gate is relative.  A
#: barely trained AlexNet's probabilities are all within 1e-3 of
#: uniform, so a fault anywhere moves them by less than that rtol (a
#: planted B6 fault: 0.52 of it).  A second gate holds the centered
#: log-probabilities — the logits up to a constant a row — to
#: ARTIFACT_LOGIT_RTOL of the row's largest, where the fault shows: on
#: an H100 the correct forward reads 0.43 of 1e-3 of it and the planted
#: fault 712, so 1e-2 leaves both sides a margin of ten and more.
ARTIFACT_RTOL, ARTIFACT_ATOL, ARTIFACT_BATCH = 1e-3, 1e-7, 64
ARTIFACT_LOGIT_RTOL = 1e-2


def artifact_shares(got, want):
    """(largest share of the probability tolerance, largest share of the
    centered-logit tolerance) of ``got`` against ``want``."""
    import numpy
    prob = float(numpy.max(numpy.abs(got - want) / (
        ARTIFACT_ATOL + ARTIFACT_RTOL * numpy.abs(want))))

    def centered(p):
        lp = numpy.log(numpy.asarray(p, dtype=numpy.float64))
        return lp - lp.mean(axis=-1, keepdims=True)

    zg, zw = centered(got), centered(want)
    scale = ARTIFACT_LOGIT_RTOL * numpy.abs(zw).max(axis=-1, keepdims=True)
    return prob, float(numpy.max(numpy.abs(zg - zw) / scale))


#: The native runtime against the card's artifact forward: the first
#: NATIVE_BATCH images (one host thread runs the whole AlexNet per
#: image), at tests/test_native.py's conv tolerances in the
#: probabilities and at ARTIFACT_LOGIT_RTOL in the centered logits
#: (phase 6b's second gate: the probabilities alone cannot see a fault
#: in a barely trained AlexNet).  The planted native fault: both norm
#: units' k raised so that their output is about ALEXNET_PLANTED_SCALE
#: of the right one (k * scale ** (-1 / beta)), as the planted B6 fault
#: scales the card's.
NATIVE_BATCH, NATIVE_RTOL, NATIVE_ATOL = 2, 1e-3, 1e-5


def native_shares(out, want):
    """(largest share of the native probability tolerance, largest
    share of the centered-logit tolerance) of ``out`` against
    ``want``."""
    import numpy
    prob = float(numpy.max(numpy.abs(out - want) / (
        NATIVE_ATOL + NATIVE_RTOL * numpy.abs(want))))
    return prob, artifact_shares(out, want)[1]


def native_check(path, x, got, model, workdir):
    """The port's ``NativeModel`` (``native/veles_infer.cc``, built with
    g++ into the port's build directory) on the artifact at ``path``
    (loaded on the card as ``model``) over ``x[:NATIVE_BATCH]``, held to
    ``got`` (the card's forward of ``x``) by :func:`native_shares`; then
    the same artifact with its norm units' k planted (written into
    ``workdir``) must fail that gate.  Returns the numbers; a failed
    build, a disagreement or an unseen plant fails."""
    import copy
    import numpy
    from veles_tpu_torch.export import write_artifact
    from veles_tpu_torch.native import NativeModel, build_native
    t0 = time.monotonic()
    lib = build_native()
    build_s = time.monotonic() - t0

    def run(artifact):
        nat = NativeModel(artifact)
        try:
            t0 = time.monotonic()
            out = nat.forward(x[:NATIVE_BATCH])
            return out, time.monotonic() - t0, nat.unit_types
        finally:
            nat.close()

    out, forward_s, types = run(path)
    want = numpy.asarray(got[:NATIVE_BATCH]).reshape(out.shape)
    share, logit_share = native_shares(out, want)
    units = [u["type"] for u in model.units]
    manifest = copy.deepcopy(model.manifest)
    norms = [u for u in manifest["units"] if u["type"] == "norm"]
    for unit in norms:
        conf = unit["config"]
        conf["k"] = float(conf["k"]) * ALEXNET_PLANTED_SCALE ** (
            -1.0 / float(conf["beta"]))
    planted_path = os.path.join(workdir, "alexnet_planted_norm.veles.tgz")
    write_artifact(planted_path, manifest, model.weights, compresslevel=0)
    try:
        planted = run(planted_path)[0]
    finally:
        os.remove(planted_path)
    planted_share, planted_logit_share = native_shares(
        planted, want.reshape(planted.shape))
    numbers = {"build_s": build_s, "forward_s": forward_s,
               "batch": NATIVE_BATCH,
               "max_abs_err": float(numpy.abs(out - want).max()),
               "largest_share_of_tol": share,
               "largest_share_of_logit_tol": logit_share,
               "planted_norms": len(norms),
               "planted_share_of_tol": planted_share,
               "planted_share_of_logit_tol": planted_logit_share,
               "library": os.path.relpath(lib, HERE)}
    if types != units or max(share, logit_share) > 1.0:
        fail("the native runtime disagrees with the card's artifact "
             "forward: %s (units %s vs %s)" % (numbers, types, units))
    if len(norms) != 2 or not max(planted_share,
                                  planted_logit_share) > 1.0:
        fail("the native gate does not see %d planted norm units (k "
             "raised for an output x %g): %s" % (
                 len(norms), ALEXNET_PLANTED_SCALE, numbers))
    return numbers


def write_mnist_idx(directory, seed=SEED, n_train=MNIST_TRAIN,
                    n_valid=MNIST_VALID):
    """Seeded class-structured 28x28 uint8 images and labels (``n_train``
    + ``n_valid``) as the four MNIST IDX files (raw, uncompressed) under
    ``directory/mnist``: a
    smooth 4x4 prototype a class under heavy noise (about 5 % validation
    error after a few epochs, so the metrics compared are not all
    zero)."""
    import numpy
    import struct
    rng = numpy.random.RandomState(seed)
    up = (numpy.arange(28) * 4) // 28
    protos = rng.rand(10, 4, 4)[:, up][:, :, up]
    d = os.path.join(directory, "mnist")
    os.makedirs(d, exist_ok=True)
    for prefix, n in (("train", n_train), ("t10k", n_valid)):
        labels = rng.randint(0, 10, n).astype(numpy.uint8)
        images = numpy.clip(128.0 + (protos[labels] - 0.5) * 200.0 +
                            rng.normal(0.0, 300.0, (n, 28, 28)), 0, 255)
        with open(os.path.join(d, prefix + "-images-idx3-ubyte"),
                  "wb") as fout:
            fout.write(struct.pack(">IIII", 0x803, n, 28, 28))
            fout.write(images.astype(numpy.uint8).tobytes())
        with open(os.path.join(d, prefix + "-labels-idx1-ubyte"),
                  "wb") as fout:
            fout.write(struct.pack(">II", 0x801, n))
            fout.write(labels.tobytes())


def workflow_state(wf):
    """unit/attr -> host array of every trainable and step state (the
    optimizer slots, the evaluator's accumulators)."""
    import numpy
    out = {}
    for unit in wf.units:
        for which in ("trainables", "tstate"):
            vecs = getattr(unit, which, None)
            if not isinstance(vecs, dict):
                continue
            for attr, vec in vecs.items():
                vec.map_read()
                out["%s/%s" % (unit.name, attr)] = numpy.array(vec.mem)
    return out


def decision_numbers(wf):
    d = wf.decision
    return dict(d.get_metric_values(), epoch_n_err=list(d.epoch_n_err),
                epoch_loss=list(d.epoch_loss),
                epoch_grad_norm=list(d.epoch_grad_norm))


def run_cli(argv, generator=None):
    """``python -m veles_tpu_torch argv`` in this process (the card by
    default); ``generator`` (generator 0, pickled at a snapshot) takes
    the place of the seeding, as a resume puts it back.  Returns the
    Main."""
    import pickle
    from veles_tpu_torch import prng
    from veles_tpu_torch.__main__ import Main
    main = Main(argv)
    if generator is not None:
        main.seed_random = lambda: prng._generators.__setitem__(
            0, pickle.loads(generator))
    if main.run() != Main.EXIT_SUCCESS:
        fail("the command line failed: %s" % " ".join(argv))
    return main


def clean_cli_config():
    """Drops what the command line's snapshot, guardian and dataset
    flags left in the configuration tree, and the chaos plan."""
    from veles_tpu_torch import resilience
    from veles_tpu_torch.config import root
    for key in ("dirs", "snapshotter", "guardian", "snapshot_disabled"):
        root.common.__dict__.pop(key, None)
    resilience.reset()


def phase_snapshots(workdir, smi, alexnet_wf):
    """Checkpoint, resume, rollback and deploy on the card.  MNIST FC
    through the command line: a straight run; a run with
    ``--snapshot-dir --snapshot-artifact`` resumed by ``-s <pointer>``
    (generator 0 put back to its state at the snapshot), bit-equal to
    the straight run; a workflow pickled on the card loaded in a process
    that has not touched CUDA; two ``--guardian-policy rollback`` runs
    with a planted ``step.nan`` (one rollback each, finite weights,
    converged, the same events); the exported artifact served over HTTP
    (labels == the local forward's argmax, /api/generate 400).  Then the
    full-width AlexNet of phase_alexnet: one ``SnapshotterToFile``
    generation (codec ""), resumed into a fresh launcher, whose next
    train tick equals the live workflow's by phase_alexnet's compare;
    ``export_workflow`` → ``ExportedModel(device="cuda")``, whose
    forward matches ``forward_numpy`` at ARTIFACT_RTOL with B6 launched
    twice on the register route, and fails it with a planted B6
    fault.  Returns (B6 and B7 launches of the main path — the live
    train tick, its repeat, the resumed tick and one artifact forward —,
    numbers)."""
    import pickle
    import numpy
    import torch
    import urllib.error
    from veles_tpu_torch import prng, resilience
    from veles_tpu_torch.config import root
    from veles_tpu_torch.export import ExportedModel, export_workflow
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.ops import lrn as L
    from veles_tpu_torch.restful import ModelServer
    from veles_tpu_torch.snapshotter import (SnapshotterToFile,
                                             iter_generations)
    numbers = {}
    started = time.monotonic()
    engine = root.common.engine
    alexnet_level = engine.precision_level   # the MNIST runs set 1
    mnist_py = os.path.join(HERE, "veles_tpu_torch", "znicz", "samples",
                            "mnist.py")
    datasets = os.path.join(workdir, "datasets")
    write_mnist_idx(datasets)
    saved = {}
    export = SnapshotterToFile.export

    def recording_export(self):
        export(self)
        saved[self.destination] = pickle.dumps(prng.get(0))

    SnapshotterToFile.export = recording_export
    common = [mnist_py, "-r", "5", "--snapshot-compression", "",
              "root.common.dirs.datasets=%r" % datasets,
              "root.common.engine.precision_level=1",
              "root.common.snapshotter.time_interval=0",
              "root.common.snapshotter.interval=5"]
    try:
        t0 = time.monotonic()
        straight = run_cli(common + [
            "--snapshot-dir", os.path.join(workdir, "straight"),
            "root.mnist.max_epochs=%d" % MNIST_EPOCHS]).workflow
        clean_cli_config()
        snaps = os.path.join(workdir, "mnist")
        part = run_cli(common + [
            "--snapshot-dir", snaps, "--snapshot-artifact",
            "root.mnist.max_epochs=%d" % MNIST_K]).workflow
        clean_cli_config()
        link = os.path.join(snaps, "mnist_current.lnk")
        blob = SnapshotterToFile.resolve(link)
        resumed = run_cli(common + [
            "-s", link, "--max-epochs", str(MNIST_EPOCHS)],
            generator=saved[blob]).workflow
        clean_cli_config()
        mnist_s = time.monotonic() - t0
    finally:
        SnapshotterToFile.export = export
    want, got = workflow_state(straight), workflow_state(resumed)
    differ = sorted(k for k in want if want[k].tobytes() !=
                    got.get(k, numpy.zeros(0)).tobytes())
    if sorted(want) != sorted(got) or differ or \
            decision_numbers(straight) != decision_numbers(resumed):
        fail("mnist resume on the card differs from the straight run: "
             "%s; decision %s vs %s" % (differ, decision_numbers(resumed),
                                         decision_numbers(straight)))
    if resumed.decision.epoch_number != MNIST_EPOCHS or \
            part.decision.epoch_number != MNIST_K:
        fail("mnist epochs: part %d, resumed %d" % (
            part.decision.epoch_number, resumed.decision.epoch_number))
    generations = iter_generations(snaps, "mnist")
    print("snapshots: mnist %d + %d epochs (snapshot %s, one of %d "
          "generations kept) == %d straight, bit for bit in %d tensors "
          "(trainables, optimizer slots, accumulators) and the decision "
          "(%s), TF32 off; the three command lines %.1f s on %s" % (
              MNIST_K, MNIST_EPOCHS - MNIST_K, os.path.basename(blob),
              len(generations), MNIST_EPOCHS, len(want),
              decision_numbers(straight), mnist_s, smi))
    numbers["mnist_resume"] = {"tensors_bit_equal": len(want),
                               "decision": decision_numbers(straight),
                               "seconds": mnist_s}
    # A workflow pickled on the card loads where CUDA was never touched.
    probe = ("import sys; sys.path.insert(0, %r); import torch; "
             "from veles_tpu_torch.snapshotter import SnapshotterToFile; "
             "wf = SnapshotterToFile.import_(%r); "
             "print(type(wf).__name__, torch.cuda.is_initialized())" %
             (HERE, blob))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300)
    if out.returncode or out.stdout.split() != ["MnistWorkflow", "False"]:
        fail("the card's snapshot did not load without CUDA: %s %s" %
             (out.stdout, out.stderr[-2000:]))
    print("snapshots: the card's mnist snapshot loads in a process that "
          "has not touched CUDA (%s)" % out.stdout.strip())

    # Rollback: a planted NaN tick, twice from one seed.
    runs = []
    for i in range(2):
        resilience.install(MNIST_CHAOS)
        wf = run_cli(common + [
            "--snapshot-dir", os.path.join(workdir, "rollback%d" % i),
            "--guardian-policy", "rollback",
            "root.mnist.max_epochs=4"]).workflow
        fired = list(resilience.get_injector().fired)
        clean_cli_config()
        finite = all(bool(numpy.isfinite(a).all()) for a in
                     workflow_state(wf).values())
        runs.append(dict(
            rollbacks=wf.guardian.rollbacks, finite=finite,
            min_validation_err=wf.decision.min_validation_err,
            events=[(e["epoch"], e["class"], e["kind"], e["action"])
                    for e in wf.guardian.events], fired=fired))
    for run in runs:
        if run["rollbacks"] != 1 or not run["finite"] or \
                not run["min_validation_err"] < 0.15:
            fail("mnist rollback on the card: %s" % run)
    if runs[0] != runs[1]:
        fail("two rollback runs from one seed differ: %s vs %s" %
             tuple(runs))
    print("snapshots: rollback under %s: rollbacks 1, weights finite, "
          "min validation error %.4f, events %s — the same in two runs" % (
              MNIST_CHAOS, runs[0]["min_validation_err"], runs[0]["events"]))
    numbers["mnist_rollback"] = runs[0]

    # Deploy: the artifact beside the snapshot, served on the card.
    artifact = blob + ".veles.tgz"
    server = ModelServer(artifact, host="127.0.0.1", port=0, max_batch=8,
                         warmup=True, device="cuda")
    server.start()
    try:
        base = "http://127.0.0.1:%d" % server.port
        x = numpy.random.RandomState(3).rand(24, 784).astype(
            numpy.float32)
        answer = post(base + "/api", {"input": x.tolist()})
        local = server.model.forward(x)
        if answer["labels"] != numpy.argmax(local, -1).tolist():
            fail("/api labels %s != the local forward's argmax" %
                 answer["labels"])
        try:
            post(base + "/api/generate", {"tokens": [[1, 2]],
                                          "max_new_tokens": 2})
            fail("/api/generate on a classifier did not answer 400")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                fail("/api/generate on a classifier answered %d" % e.code)
        stats = get(base + "/stats")
    finally:
        server.stop(drain=True)
    print("snapshots: served %s on the card: /api labels of 24 samples == "
          "the local forward's argmax; /api/generate 400; warm-up "
          "entry points %s" % (os.path.basename(artifact),
                               stats["counters"].get("warmup.compiles")))
    del straight, part, resumed, wf, server
    gc.collect()

    # The full-width AlexNet of phase_alexnet: snapshot and resume, in
    # phase_alexnet's configuration.
    engine.precision_level = alexnet_level
    wf = alexnet_wf
    compiler = wf.compiler
    L.reset_launches()
    snap = SnapshotterToFile(wf, directory=os.path.join(workdir, "alexnet"),
                             prefix="imagenet", compression="",
                             time_interval=0.0)
    snap.initialize()
    snap.suffix = "resume"
    torch.cuda.synchronize()
    t0 = time.monotonic()
    snap.export()
    write_s = time.monotonic() - t0
    blob_mb = os.path.getsize(snap.destination) / 1e6
    before = {n: v.devmem.to("cpu") for n, v in
              list(compiler._param_vecs.items()) +
              list(compiler._state_vecs.items())}
    batch = [v.mem.copy() for v in compiler.batch_vectors]
    gen = compiler._generator()
    rng_state = gen.get_state()
    compiler.execute(training=True)
    torch.cuda.synchronize()
    after = {n: v.devmem.to("cpu") for n, v in compiler._param_vecs.items()}
    # The live tick again from the same state: its own repeatability.
    live_state = {n: v.devmem for n, v in
                  list(compiler._param_vecs.items()) +
                  list(compiler._state_vecs.items())}
    for n, v in list(compiler._param_vecs.items()) + \
            list(compiler._state_vecs.items()):
        v.devmem = before[n].to(live_state[n].device)
    for vec, arr in zip(compiler.batch_vectors, batch):
        vec.mem = arr
    gen.set_state(rng_state)
    compiler.execute(training=True)
    torch.cuda.synchronize()
    live_repeat_equal = all(torch.equal(
        compiler._param_vecs[n].devmem.cpu(), after[n]) for n in after)
    for n, v in list(compiler._param_vecs.items()) + \
            list(compiler._state_vecs.items()):
        v.devmem = live_state[n]
    del live_state
    t0 = time.monotonic()
    wf2 = SnapshotterToFile.import_(snap.destination)
    import_s = time.monotonic() - t0
    t0 = time.monotonic()
    launcher = Launcher()
    launcher.add_ref(wf2)
    launcher.initialize(device="cuda", snapshot=True)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    compiler2 = wf2.compiler
    compiler2._ensure_compiled()
    if sorted(compiler2._param_vecs) != sorted(compiler._param_vecs):
        fail("the resumed alexnet has other parameters")
    start = {n: v.devmem.to("cpu") for n, v in
             list(compiler2._param_vecs.items()) +
             list(compiler2._state_vecs.items())}
    restored_equal = all(torch.equal(start[n], before[n]) for n in before)
    for vec, arr in zip(compiler2.batch_vectors, batch):
        vec.mem = arr
    compiler2._generator().set_state(rng_state)
    compiler2.execute(training=True)
    torch.cuda.synchronize()
    rows = alexnet_compare(compiler2, after, before)
    worst = max(r[0] / r[2] for r in rows.values())
    differ = sorted(n for n in after if not torch.equal(
        compiler2._param_vecs[n].devmem.cpu(), after[n]))
    bit_equal = not differ
    if not restored_equal or not worst <= 1.0:
        fail("the resumed alexnet's train tick differs from the live "
             "one's: state restored %s, largest gap %.3g of the bound" %
             (restored_equal, worst))
    print("snapshots: alexnet generation on %s: %.1f MB (codec \"\"), "
          "write %.2f s, import_ %.2f s, resume initialize %.2f s; the "
          "resumed train tick == the live one's (largest gap %.3g of "
          "phase_alexnet's bound; bit-equal %s; differing: %s; the live "
          "tick repeated from the same state bit-equal %s)" % (
              smi, blob_mb, write_s, import_s, init_s, worst, bit_equal,
              differ, live_repeat_equal))
    numbers["alexnet_snapshot"] = {
        "blob_mb": blob_mb, "write_s": write_s, "import_s": import_s,
        "resume_initialize_s": init_s, "tick_gap_over_bound": worst,
        "tick_bit_equal": bit_equal, "tick_differing": differ,
        "live_tick_repeat_bit_equal": live_repeat_equal}
    del wf2, launcher, compiler2, before, after, start
    gc.collect()
    torch.cuda.empty_cache()

    # The artifact: export, load on the card, forward with B6.
    path = os.path.join(workdir, "alexnet.veles.tgz")
    t0 = time.monotonic()
    export_workflow(wf, path, compresslevel=0)
    art_write_s = time.monotonic() - t0
    art_mb = os.path.getsize(path) / 1e6
    model = ExportedModel(path, device="cuda")
    loader = wf.loader
    loader.original_data.map_read()
    x = numpy.array(loader.original_data.mem[:ARTIFACT_BATCH],
                    dtype=numpy.float32)
    fwd_before = L.lrn_forward.launches
    got = model.forward(x)
    torch.cuda.synchronize()
    per_forward = L.lrn_forward.launches - fwd_before
    routes = dict(L.lrn_forward.launches_by_route)
    launches = {"lrn_forward": L.lrn_forward.launches,
                "lrn_backward": L.lrn_backward.launches}
    t0 = time.monotonic()
    want = model.forward_numpy(x)
    numpy_s = time.monotonic() - t0
    share, logit_share = artifact_shares(got, want)
    if per_forward != 2 or routes["wide"]:
        fail("the artifact forward launched B6 %d times (routes %s); "
             "its two norm units imply 2 on the register route" %
             (per_forward, routes))
    if launches != {"lrn_forward": 8, "lrn_backward": 6}:
        fail("LRN launches around the alexnet snapshot %s; the live tick, "
             "its repeat, the resumed tick and the artifact forward imply "
             "8 forward, 6 backward" % launches)
    if not (share <= 1.0 and logit_share <= 1.0):
        fail("the alexnet artifact forward differs from forward_numpy: "
             "%.3g of rtol %g in the probabilities, %.3g in the centered "
             "logits" % (share, ARTIFACT_RTOL, logit_share))
    native = native_check(path, x, got, model, workdir)
    print("snapshots: the native runtime on the host (%s, built in %.1f "
          "s) == the card's artifact forward on %d images within rtol %g, "
          "atol %g: max abs err %.3g, largest share of the tolerance "
          "%.3g, of the centered logits' rtol %g %.3g; %.1f s; its %d norm "
          "units planted (output x %g) %.3g / %.3g of them, caught" % (
              native["library"], native["build_s"], NATIVE_BATCH,
              NATIVE_RTOL, NATIVE_ATOL, native["max_abs_err"],
              native["largest_share_of_tol"], ARTIFACT_LOGIT_RTOL,
              native["largest_share_of_logit_tol"], native["forward_s"],
              native["planted_norms"], ALEXNET_PLANTED_SCALE,
              native["planted_share_of_tol"],
              native["planted_share_of_logit_tol"]))
    launch = L._launch

    def planted_launch(fn, name, *args):
        launch(fn, name, *args)
        if fn == "veles_lrn_fwd":   # (route, dtype, x, y, ...)
            args[3].mul_(ALEXNET_PLANTED_SCALE)

    L._launch = planted_launch
    try:
        planted = model.forward(x)
    finally:
        L._launch = launch
    planted_share, planted_logit_share = artifact_shares(planted, want)
    if not max(planted_share, planted_logit_share) > 1.0:
        fail("the artifact gate does not see a planted B6 fault (every y "
             "x %g): %.3g of the probability tolerance, %.3g of the "
             "centered-logit one" % (ALEXNET_PLANTED_SCALE, planted_share,
                                     planted_logit_share))
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        model.forward(x)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    p50 = float(numpy.median(times[2:])) * 1e3
    print("snapshots: alexnet artifact on %s: %.1f MB (gzip level 0), "
          "write %.2f s; forward of %d images on the card == "
          "forward_numpy (%.1f s) within rtol %g, atol %g (largest share "
          "of the tolerance %.3g; of the centered logits' rtol %g %.3g); "
          "B6 %d launches a forward on the register route; the planted "
          "B6 fault (y x %g) %.3g / %.3g of them, caught; forward p50 "
          "%.2f ms at batch %d" % (
              smi, art_mb, art_write_s, ARTIFACT_BATCH, numpy_s,
              ARTIFACT_RTOL, ARTIFACT_ATOL, share, ARTIFACT_LOGIT_RTOL,
              logit_share,
              per_forward, ALEXNET_PLANTED_SCALE, planted_share,
              planted_logit_share, p50, ARTIFACT_BATCH))
    numbers["alexnet_artifact"] = {
        "mb": art_mb, "write_s": art_write_s, "forward_p50_ms": p50,
        "batch": ARTIFACT_BATCH, "largest_share_of_tol": share,
        "largest_share_of_logit_tol": logit_share,
        "planted_share_of_tol": planted_share,
        "planted_share_of_logit_tol": planted_logit_share,
        "b6_launches_per_forward": per_forward, "smi": smi,
        "native": native}
    numbers["launches"] = launches
    numbers["phase_s"] = time.monotonic() - started
    print("snapshots: the phase took %.1f s" % numbers["phase_s"])
    del model, wf, snap
    return launches, numbers


#: Phase 6c, the streamed AlexNet: the dataset on disk (227 px uint8,
#: 1000 classes, STREAM_VALID validation + STREAM_TRAIN train images,
#: ~0.71 GB), one epoch at ALEXNET_BATCH — one validation and
#: STREAM_TRAIN / ALEXNET_BATCH train ticks.  The streamed run must equal
#: the resident run on the same files bit for bit: the minibatches are
#: the same bytes, and the step differs only in where the gather runs.
STREAM_VALID, STREAM_TRAIN = ALEXNET_BATCH, ALEXNET_BATCH * 8
STREAM_IMAGE, STREAM_SEED = 227, 4243
#: The snapshot gate's live ticks before the generation: the validation
#: tick and two train ticks, with the third train block staged.
STREAM_SNAPSHOT_TICKS = 3
#: The CIFAR gate of the JAX package (tests/test_cifar.py): seed, epochs
#: and the validation error to beat on the synthetic fallback.
CIFAR_SEED, CIFAR_EPOCHS, CIFAR_MAX_ERR = 4242, 5, 0.25

STREAM_WORKFLOW = '''"""The full-width AlexNet streamed from disk."""
import numpy

from veles_tpu_torch.config import root
from veles_tpu_torch.znicz.samples.imagenet import (AlexNetWorkflow,
                                                     StreamedImagenetLoader)


def run(load, main):
    if type(numpy.random).__name__ != "_PoisonedRandom":
        raise RuntimeError("the numpy.random guard is not live")
    load(AlexNetWorkflow, loader_cls=StreamedImagenetLoader,
         minibatch_size=root.stream6c.minibatch_size,
         max_epochs=root.stream6c.max_epochs)
    main()
'''

STREAM_CONFIG = '''root.common.dirs.datasets = %r
root.stream6c.minibatch_size = %d
root.stream6c.max_epochs = 1
'''


def stream_gate(ref, got):
    """Names of the tensors and decision numbers of ``got`` that are not
    bit-equal to ``ref``'s (each a (workflow_state, decision_numbers,
    launches) triple)."""
    import numpy
    differ = sorted(n for n in ref[0] if n not in got[0] or not
                    numpy.array_equal(ref[0][n], got[0][n]))
    differ += ["decision.%s" % k for k in ref[1]
               if repr(ref[1][k]) != repr(got[1][k])]
    if ref[2] != got[2]:
        differ.append("launches %s vs %s" % (ref[2], got[2]))
    return differ


def phase_streamed(workdir, smi):
    """Phase 6c: the full-width AlexNet trains from a dataset on disk
    through ``StreamedImagenetLoader`` and the command line with a
    config file, against the resident loader on the same files; a
    streamed snapshot resumes bit-equal; CIFAR's gate on the card.
    Returns (B6 and B7 launches of the streamed run, numbers)."""
    import numpy
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.ops import lrn as L
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    from veles_tpu_torch.znicz.samples.cifar import (CifarWorkflow,
                                                     cifar_layers)
    from veles_tpu_torch.znicz.samples.imagenet import (
        AlexNetWorkflow, ImagenetLoader, StreamedImagenetLoader)
    started = time.monotonic()
    numbers = {}
    engine = root.common.engine
    engine.precision_level = 0
    engine.pallas_lrn = True
    datasets = os.path.join(workdir, "datasets")
    imagenet_dir = os.path.join(datasets, "imagenet")
    root.common.dirs.datasets = datasets

    # The dataset, written from RandomState(0) through fill_synthetic
    # by the prewrite process (the writer below finds its files whole).
    _, write_s, waited_s = PREWRITER[0].wait("dataset")
    writer = StreamedImagenetLoader(
        None, cache_dir=imagenet_dir, sim_train=STREAM_TRAIN,
        sim_valid=STREAM_VALID, sim_image_size=STREAM_IMAGE,
        sim_classes=1000)
    paths = writer._write_synthetic()
    disk_bytes = sum(os.path.getsize(p) for p in paths)
    t0 = time.monotonic()
    writer._cached_mean_disp(paths[2], numpy.load(paths[2], mmap_mode="r"))
    analysis_cold_s = time.monotonic() - t0
    t0 = time.monotonic()
    writer._cached_mean_disp(paths[2], numpy.load(paths[2], mmap_mode="r"))
    analysis_cached_s = time.monotonic() - t0
    print("streamed: dataset %s: %.1f MB on disk written in %.1f s by "
          "the prewrite process (waited %.1f s); mean/disp analysis %.2f "
          "s cold, %.3f s cached" % (
              imagenet_dir, disk_bytes / 1e6, write_s, waited_s,
              analysis_cold_s, analysis_cached_s))
    numbers["dataset"] = {"bytes": disk_bytes, "write_s": write_s,
                          "waited_s": waited_s,
                          "analysis_cold_s": analysis_cold_s,
                          "analysis_cached_s": analysis_cached_s}
    del writer

    def tick_timer(compiler, name):
        """Wraps ``compiler.<name>``: a CUDA event on the step's stream
        at the start of every tick and the host's time to enqueue the
        tick; nothing synchronizes.  Returns (events, classes,
        dispatch seconds, restore)."""
        events, classes, dispatch = [], [], []
        original = getattr(compiler, name)

        def timed(*args, **kwargs):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            training = kwargs.get("training", args[-1] if args else True)
            classes.append(bool(training))
            t = time.monotonic()
            out = original(*args, **kwargs)
            dispatch.append(time.monotonic() - t)
            return out

        setattr(compiler, name, timed)
        return events, classes, dispatch, \
            lambda: setattr(compiler, name, original)

    def warm_train_ms(events, classes, end):
        """Train tick intervals (tick start to the next tick's start; the
        last to ``end``), the first train tick (cold) left out."""
        marks = events + [end]
        out = [marks[i].elapsed_time(marks[i + 1])
               for i in range(len(events)) if classes[i]]
        return out[1:]

    def train(loader_cls, label, prefetch=True):
        prng.reset()
        prng.get(0).seed(STREAM_SEED)
        launcher = Launcher()
        loader_config = {} if loader_cls is ImagenetLoader else \
            {"prefetch": prefetch}
        wf = AlexNetWorkflow(launcher, minibatch_size=ALEXNET_BATCH,
                             max_epochs=1, loader_cls=loader_cls,
                             loader_config=loader_config)
        t0 = time.monotonic()
        launcher.initialize(device="cuda")
        init_s = time.monotonic() - t0
        compiler = wf.compiler
        compiler._ensure_compiled()
        produce = []
        undo = []
        if loader_cls is not ImagenetLoader:
            loader = wf.loader
            loader._copy_stream_ = torch.cuda.Stream(
                torch.device("cuda", 0))
            fill, upload = loader._fill_block, loader._upload

            def timed_fill(*a):
                t = time.monotonic()
                out = fill(*a)
                produce.append({"fill_s": time.monotonic() - t})
                return out

            def timed_upload(host):
                start = torch.cuda.Event(enable_timing=True)
                start.record(loader._copy_stream_)
                t = time.monotonic()
                blocks, ready = upload(host)
                produce[-1]["upload_host_s"] = time.monotonic() - t
                end = torch.cuda.Event(enable_timing=True)
                end.record(loader._copy_stream_)
                produce[-1]["events"] = (start, end)
                return blocks, ready

            loader._fill_block, loader._upload = timed_fill, timed_upload
            undo.append(lambda: (delattr(loader, "_fill_block"),
                                 delattr(loader, "_upload")))
        name = "execute" if loader_cls is ImagenetLoader else \
            "execute_block"
        events, classes, dispatch, untime = tick_timer(compiler, name)
        torch.cuda.synchronize()
        L.reset_launches()
        t0 = time.monotonic()
        launcher.run()
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        run_s = time.monotonic() - t0
        launches = {"lrn_forward": L.lrn_forward.launches,
                    "lrn_backward": L.lrn_backward.launches}
        routes = {"lrn_forward": dict(L.lrn_forward.launches_by_route),
                  "lrn_backward": dict(L.lrn_backward.launches_by_route)}
        untime()
        for fn in undo:
            fn()
        warm = warm_train_ms(events, classes, end)
        for p in produce:
            if "events" in p:
                start, ready = p.pop("events")
                p["upload_device_ms"] = start.elapsed_time(ready)
        result = (workflow_state(wf), decision_numbers(wf), launches)
        row = {"init_s": init_s, "run_s": run_s, "ticks": len(events),
               "classes": classes, "warm_train_tick_ms": warm,
               "warm_train_tick_p50_ms": float(numpy.median(warm)),
               "dispatch_ms": [1e3 * s for s in dispatch],
               "launches": launches, "launches_by_route": routes,
               "produce": produce}
        print("streamed: %s: initialize %.1f s, run %.1f s, %d ticks, warm "
              "train ticks p50 %.2f ms %s, the host's enqueue of each "
              "tick ms %s; LRN launches %s %s" % (
                  label, init_s, run_s, len(events),
                  row["warm_train_tick_p50_ms"],
                  ["%.2f" % x for x in warm],
                  ["%.1f" % x for x in row["dispatch_ms"]], launches,
                  routes))
        if produce:
            fills = [p["fill_s"] * 1e3 for p in produce]
            ups = [p["upload_device_ms"] for p in produce]
            print("streamed: %s: _produce_block host fill ms %s (p50 "
                  "%.2f), upload host enqueue ms p50 %.3f, upload on the "
                  "copy stream ms %s (p50 %.2f)" % (
                      label, ["%.1f" % x for x in fills],
                      float(numpy.median(fills)), 1e3 * float(numpy.median(
                          [p["upload_host_s"] for p in produce])),
                      ["%.2f" % x for x in ups], float(numpy.median(ups))))
        del wf, launcher, compiler
        gc.collect()
        torch.cuda.empty_cache()
        return result, row

    ticks = 1 + STREAM_TRAIN // ALEXNET_BATCH
    expect = {"lrn_forward": 2 * ticks, "lrn_backward": 2 * (ticks - 1)}
    resident, numbers["resident"] = train(ImagenetLoader, "resident")
    streamed, numbers["streamed"] = train(StreamedImagenetLoader,
                                          "streamed, prefetch on")
    sync, numbers["streamed_no_prefetch"] = train(
        StreamedImagenetLoader, "streamed, prefetch off", prefetch=False)
    for label, row in (("resident", numbers["resident"]),
                       ("streamed", numbers["streamed"]),
                       ("streamed, prefetch off",
                        numbers["streamed_no_prefetch"])):
        if row["classes"] != [False] + [True] * (ticks - 1):
            fail("streamed phase: the %s run ran ticks %s, expected one "
                 "validation tick then %d train ticks" % (
                     label, row["classes"], ticks - 1))
        if row["launches"] != expect:
            fail("streamed phase: the %s run launched the LRN kernels %s "
                 "times, the ticks imply %s" % (label, row["launches"],
                                                expect))
        if any(r["wide"] for r in row["launches_by_route"].values()):
            fail("streamed phase: a %s LRN launch took the wide route: %s"
                 % (label, row["launches_by_route"]))
    for label, got in (("streamed", streamed), ("prefetch off", sync)):
        differ = stream_gate(resident, got)
        if differ:
            fail("streamed phase: the %s run differs from the resident run "
                 "on the same files: %s" % (label, differ[:8]))
    print("streamed check: the streamed run (prefetch on and off) equals "
          "the resident run bit for bit in %d tensors, the decision %s and "
          "the LRN launches %s" % (len(resident[0]), resident[1],
                                   resident[2]))

    # The planted fault: one row of the first train block one index off.
    class Shifted(StreamedImagenetLoader):
        hide_from_registry = True
        planted = []
        lock = threading.Lock()

        def fill_rows(self, indices, out_data, out_labels):
            indices = numpy.array(indices)
            with self.lock:   # the pool fills a block's rows at once
                if not self.planted and indices[0] >= STREAM_VALID:
                    last = self.total_samples - 1
                    indices[0] += 1 if indices[0] < last else -1
                    self.planted.append(int(indices[0]))
            super(Shifted, self).fill_rows(indices, out_data, out_labels)

    planted, _ = train(Shifted, "planted row shift")
    planted_differ = stream_gate(resident, planted)
    print("streamed: the planted row shift differs in %d of %d tensors "
          "(%s...)" % (len(planted_differ), len(resident[0]),
                       planted_differ[:4]))
    if not Shifted.planted or not planted_differ:
        fail("the streamed gate does not see one row shifted by one index")
    del planted

    # The command line: a workflow module and a config file.
    wf_py = os.path.join(workdir, "alexnet_stream.py")
    cfg_py = os.path.join(workdir, "stream_config.py")
    result_json = os.path.join(workdir, "stream_result.json")
    with open(wf_py, "w") as fout:
        fout.write(STREAM_WORKFLOW)
    with open(cfg_py, "w") as fout:
        fout.write(STREAM_CONFIG % (datasets, ALEXNET_BATCH))
    prng.reset()
    t0 = time.monotonic()
    run_cli([wf_py, cfg_py, "--device", "cuda", "--random-seed",
             str(STREAM_SEED), "--result-file", result_json])
    cli_s = time.monotonic() - t0
    with open(result_json) as fin:
        cli = json.load(fin)["results"]
    mine = streamed[1]
    print("streamed: the command line (%s %s) %.1f s: min_validation_err "
          "%r, epochs %r; in-process %r, %r" % (
              os.path.basename(wf_py), os.path.basename(cfg_py), cli_s,
              cli["min_validation_err"], cli["epochs"],
              mine["min_validation_err"], mine["epochs"]))
    if cli["min_validation_err"] != mine["min_validation_err"] or \
            cli["epochs"] != mine["epochs"]:
        fail("the command line's streamed run differs from the in-process "
             "one: %s vs %s" % (cli, mine))
    numbers["cli_s"] = cli_s
    root.__dict__.pop("stream6c", None)
    root.common.dirs.datasets = datasets
    del streamed, sync, resident
    gc.collect()

    # Snapshot mid-epoch with a block staged, and resume.
    prng.reset()
    prng.get(0).seed(STREAM_SEED)
    launcher = Launcher()
    wf = AlexNetWorkflow(launcher, minibatch_size=ALEXNET_BATCH,
                         max_epochs=1, loader_cls=StreamedImagenetLoader)
    launcher.initialize(device="cuda")
    compiler = wf.compiler
    loader = wf.loader
    for i in range(STREAM_SNAPSHOT_TICKS):
        if i == STREAM_SNAPSHOT_TICKS - 1:
            numbers["profile"] = profile_tick(
                loader.run, "streamed: profile of one warm train tick "
                "(loader.run: dispatch, then fill and upload the next "
                "block)")
        else:
            loader.run()
    staged = loader._staged_
    if staged is None:
        fail("no block staged before the streamed snapshot")
    staged_idx = [idx.copy() for idx, _ in staged["in_flight"]]
    gen = compiler._generator()
    rng_state = gen.get_state()
    snap = SnapshotterToFile(wf, directory=os.path.join(workdir,
                                                        "stream_snap"),
                             prefix="imagenet", compression="",
                             time_interval=0.0)
    snap.initialize()
    snap.suffix = "staged"
    t0 = time.monotonic()
    snap.export()
    export_s = time.monotonic() - t0
    blob_mb = os.path.getsize(snap.destination) / 1e6
    vecs = list(compiler._param_vecs.items()) + \
        list(compiler._state_vecs.items())
    before = {n: v.devmem.clone() for n, v in vecs}
    blocks = loader._take(staged)
    loader._staged_ = None

    def restore(compiler_, state):
        # At precision_level 1 the step also carries the evaluator's
        # Kahan carry, which no parameter reads.
        for n, v in list(compiler_._param_vecs.items()) + \
                list(compiler_._state_vecs.items()):
            if n in state:
                v.devmem = state[n].clone()

    port_deterministic = torch.backends.cudnn.deterministic

    def tick(compiler_, gen_, blocks_, state, level, timed=None):
        """One train tick from ``state`` (generator 0 at the snapshot's
        state) at ``level``, under the cuDNN setting the port made
        (``backends.CUDADevice``); ``timed`` appends its seconds.
        Returns the parameters after it."""
        restore(compiler_, state)
        gen_.set_state(rng_state)
        engine.precision_level = level
        try:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            compiler_.execute_block(blocks_, True)
            torch.cuda.synchronize()
            if timed is not None:
                timed.append(time.monotonic() - t0)
        finally:
            engine.precision_level = 0
        return {n: v.devmem.clone() for n, v in
                compiler_._param_vecs.items()}

    def equal(a, b):
        return sorted(n for n in a if not torch.equal(a[n], b[n]))

    def f32_ticks(compiler_, gen_, blocks_, state):
        """The f32 tick twice, as the port runs it."""
        return [tick(compiler_, gen_, blocks_, state, 1),
                tick(compiler_, gen_, blocks_, state, 1)]

    def f32_cost(compiler_, gen_, blocks_, state, reps=5):
        """The f32 tick's seconds with cuDNN's deterministic algorithms
        (the port's setting) and with its defaults (the flag off for the
        reading only, then put back), in turns: (with, without)."""
        with_, without = [], []
        for _ in range(reps):
            tick(compiler_, gen_, blocks_, state, 1, with_)
            torch.backends.cudnn.deterministic = False
            try:
                tick(compiler_, gen_, blocks_, state, 1, without)
            finally:
                torch.backends.cudnn.deterministic = port_deterministic
        return with_, without

    def conv1_wgrad_probe(compiler_, loader_, blocks_):
        """conv1's float32 weight gradient on this block's normalized
        images and a seeded cotangent, four times with cuDNN's default
        algorithms (the flag off for the probe only) and twice as the
        port runs it: (distinct default results, distinct results as
        the port runs it, the default's largest |gap|, the
        weight-gradient kernels' names)."""
        from torch.profiler import ProfilerActivity, profile
        from veles_tpu_torch.znicz.conv import conv2d_nhwc
        conv1 = next(u for u in compiler_.forward_units
                     if type(u).__name__ == "ConvStrictRelu")
        x = ((blocks_[str(id(loader_.minibatch_data))][0].float() -
              loader_.mean.devmem) * loader_.rdisp.devmem)
        w = conv1.weights.devmem.float()
        cot = torch.randn(
            (x.shape[0],) + conv1.output_spatial(*x.shape[1:3]) +
            (w.shape[-1],), device=x.device,
            generator=torch.Generator(device=x.device).manual_seed(1))
        outs = {False: [], True: []}
        names = set()
        for deterministic, times in ((False, 4),
                                     (port_deterministic, 2)):
            torch.backends.cudnn.deterministic = deterministic
            try:
                for _ in range(times):
                    leaf = w.clone().requires_grad_(True)
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        y = conv2d_nhwc(x, leaf, conv1.sliding,
                                        conv1.padding)
                        g = torch.autograd.grad(y, leaf, cot)[0]
                        torch.cuda.synchronize()
                    names.update(ev.key.split("(")[0][:60] for ev in
                                 prof.key_averages() if "wgrad" in
                                 ev.key.lower())
                    outs[deterministic].append(g)
            finally:
                torch.backends.cudnn.deterministic = port_deterministic

        def distinct(gs):
            return len({gr.cpu().numpy().tobytes() for gr in gs})

        gap = max(float((gr - outs[False][0]).abs().max())
                  for gr in outs[False])
        return (distinct(outs[False]), distinct(outs[True]), gap,
                sorted(names))

    L.reset_launches()
    live = tick(compiler, gen, blocks, before, 0)
    live_f32 = f32_ticks(compiler, gen, blocks, before)
    f32_with, f32_without = f32_cost(compiler, gen, blocks, before)
    probe = conv1_wgrad_probe(compiler, loader, blocks)
    snapshot_launches = {"lrn_forward": L.lrn_forward.launches,
                         "lrn_backward": L.lrn_backward.launches}
    del wf, launcher, compiler, loader, blocks, staged
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    wf2 = SnapshotterToFile.import_(snap.destination)
    import_s = time.monotonic() - t0
    launcher2 = Launcher()
    launcher2.add_ref(wf2)
    t0 = time.monotonic()
    launcher2.initialize(device="cuda", snapshot=True)
    resume_init_s = time.monotonic() - t0
    compiler2, loader2 = wf2.compiler, wf2.loader
    compiler2._ensure_compiled()
    start = {n: v.devmem.clone() for n, v in
             list(compiler2._param_vecs.items()) +
             list(compiler2._state_vecs.items())}
    restored = equal(before, start) if sorted(start) == sorted(before) \
        else ["the parameter set"]
    requeued = [idx.copy() for idx, _ in loader2.failed_minibatches]
    gen2 = compiler2._generator()
    entry = loader2._produce_block(1)
    served = [idx.copy() for idx, _ in entry["in_flight"]]
    blocks2 = loader2._take(entry)
    L.reset_launches()
    resumed = tick(compiler2, gen2, blocks2, start, 0)
    resumed_f32 = f32_ticks(compiler2, gen2, blocks2, start)
    for k, v in snapshot_launches.items():
        snapshot_launches[k] = v + {"lrn_forward": L.lrn_forward.launches,
                                    "lrn_backward":
                                        L.lrn_backward.launches}[k]
    same_block = len(served) == len(staged_idx) and all(
        numpy.array_equal(a, b) for a, b in zip(served, staged_idx))
    requeued_ok = len(requeued) == len(staged_idx) and all(
        numpy.array_equal(a, b) for a, b in zip(requeued, staged_idx))
    bf16_differ = equal(live, resumed)
    f32 = {"cudnn_deterministic_as_the_port_set_it": port_deterministic,
           "live_repeat_differs": equal(live_f32[0], live_f32[1]),
           "resumed_differs": equal(live_f32[0], resumed_f32[0]),
           "resumed_repeat_differs": equal(resumed_f32[0], resumed_f32[1]),
           "tick_ms_deterministic": [x * 1e3 for x in f32_with],
           "tick_ms_default_algorithms": [x * 1e3 for x in f32_without],
           "tick_p50_ms_deterministic": float(
               numpy.median(f32_with)) * 1e3,
           "tick_p50_ms_default_algorithms": float(
               numpy.median(f32_without)) * 1e3,
           "conv1_wgrad_default_distinct_of_4": probe[0],
           "conv1_wgrad_deterministic_distinct_of_2": probe[1],
           "conv1_wgrad_default_max_gap": probe[2],
           "wgrad_kernels": probe[3]}
    print("streamed: snapshot with a block staged on %s: %.1f MB, export "
          "%.2f s, import_ %.2f s, resume initialize %.2f s; state restored "
          "bit-equal %s; the staged block requeued %s and served again %s; "
          "the resumed bf16 train tick differs from the live one in %s" % (
              smi, blob_mb, export_s, import_s, resume_init_s,
              not restored, requeued_ok, same_block, bf16_differ))
    print("streamed: f32 ticks from the snapshot's state as the port runs "
          "them (cudnn.deterministic %s, set by backends.CUDADevice): "
          "live vs live differ in %s, live vs resumed %s, resumed vs "
          "resumed %s; conv1's f32 weight gradient on fixed inputs: %d "
          "distinct of 4 with cuDNN's default algorithms (largest |gap| "
          "%.3g), %d of 2 as the port runs it; kernels %s" % (
              port_deterministic, f32["live_repeat_differs"],
              f32["resumed_differs"], f32["resumed_repeat_differs"],
              probe[0], probe[2], probe[1], probe[3]))
    print("streamed: the cost of cuDNN's deterministic algorithms on %s: "
          "f32 AlexNet train tick (batch %d) p50 %.2f ms with them, %.2f "
          "ms with the defaults (%d ticks each, in turns)" % (
              smi, ALEXNET_BATCH, f32["tick_p50_ms_deterministic"],
              f32["tick_p50_ms_default_algorithms"], len(f32_with)))
    if restored or not requeued_ok or not same_block or bf16_differ:
        fail("the streamed snapshot does not resume bit-equal: restored "
             "differs %s, requeued %s, served again %s, tick differs %s" %
             (restored, requeued_ok, same_block, bf16_differ))
    if not port_deterministic:
        fail("the port left torch.backends.cudnn.deterministic off")
    if f32["live_repeat_differs"] or f32["resumed_differs"] or \
            f32["resumed_repeat_differs"] or probe[1] != 1:
        fail("f32 ticks from one state are not bit-equal as the port runs "
             "them: live vs live %s, live vs resumed %s, resumed vs "
             "resumed %s (the probe's results %d)" % (
                 f32["live_repeat_differs"], f32["resumed_differs"],
                 f32["resumed_repeat_differs"], probe[1]))
    numbers["snapshot"] = {
        "blob_mb": blob_mb, "export_s": export_s, "import_s": import_s,
        "resume_initialize_s": resume_init_s, "requeued": requeued_ok,
        "served_again": same_block, "bf16_tick_bit_equal": True,
        "f32": f32, "launches": snapshot_launches}
    del wf2, launcher2, compiler2, loader2, blocks2, before, start
    gc.collect()
    torch.cuda.empty_cache()

    # CIFAR: the JAX package's gate, then stochastic pooling.
    def cifar(pool):
        layers = cifar_layers(0.02, 0.9, 0.0)
        for cfg in layers:
            if "weights_stddev" in cfg.get("->", {}):
                cfg["->"]["weights_stddev"] = 0.05
        if pool != "max_pooling":
            # Stochastic pooling takes non-overlapping windows only;
            # 2x2 stride 2 keeps the 3x3 stride-2 pool's 16x16 output.
            layers[1] = {"type": pool, "->": {"kx": 2, "ky": 2,
                                              "sliding": (2, 2)}}
        prng.reset()
        prng.get(0).seed(CIFAR_SEED)
        launcher = Launcher()
        wf = CifarWorkflow(launcher, max_epochs=CIFAR_EPOCHS,
                           minibatch_size=100, layers=layers)
        t0 = time.monotonic()
        launcher.initialize(device="cuda")
        launcher.run()
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        state = workflow_state(wf)
        finite = all(numpy.isfinite(v).all() for v in state.values())
        res = wf.gather_results()
        print("streamed: cifar (%s) on %s: min_validation_err %.4f after "
              "%d epochs, %.1f s, finite weights %s" % (
                  pool, smi, res["min_validation_err"], res["epochs"],
                  seconds, finite))
        return {"min_validation_err": res["min_validation_err"],
                "epochs": res["epochs"], "seconds": seconds,
                "finite": finite}

    numbers["cifar"] = cifar("max_pooling")
    if not (numbers["cifar"]["min_validation_err"] < CIFAR_MAX_ERR and
            numbers["cifar"]["epochs"] == CIFAR_EPOCHS and
            numbers["cifar"]["finite"]):
        fail("CIFAR misses the gate: %s (min_validation_err < %g after %d "
             "epochs)" % (numbers["cifar"], CIFAR_MAX_ERR, CIFAR_EPOCHS))
    numbers["cifar_stochastic"] = cifar("stochastic_pooling")
    if not numbers["cifar_stochastic"]["finite"] or \
            numbers["cifar_stochastic"]["epochs"] != CIFAR_EPOCHS:
        fail("CIFAR with stochastic pooling: %s" %
             numbers["cifar_stochastic"])
    clean_cli_config()
    numbers["phase_s"] = time.monotonic() - started
    res, st = numbers["resident"], numbers["streamed"]
    print("streamed readings on %s (smoke, not a benchmark): warm train "
          "tick p50 resident %.2f ms, streamed %.2f ms (prefetch on), %.2f "
          "ms (off); the phase %.1f s" % (
              smi, res["warm_train_tick_p50_ms"],
              st["warm_train_tick_p50_ms"],
              numbers["streamed_no_prefetch"]["warm_train_tick_p50_ms"],
              numbers["phase_s"]))
    return numbers["streamed"]["launches"], numbers


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
    path, write_s, waited_s = PREWRITER[0].wait("lm")
    print("artifact write: %.1f s by the prewrite process (waited %.1f "
          "s; %.2f GB, gzip level 0, seed %d)" % (
              write_s, waited_s, os.path.getsize(path) / 1e9, SEED))
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
    mismatches = token_mismatches(model, all_prompts, answers)
    if mismatches:
        fail("answers diverge from the plain-attention oracle (request, "
             "prompt tokens, generated position, served, oracle, the "
             "oracle's top-2 logit margin there): %s" % mismatches)
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


#: Phase 7r: the TinyLM at the bench width (embed 2048, 16 heads of
#: 128, MLP 8192, vocab 16384, 1024 positions), trained for one
#: validation and INWF_TICKS train ticks and served from the same
#: process by the RESTfulAPI unit.  Its depth is cut to INWF_BLOCKS of
#: the bench's 12: the unit exports at gzip level 9, as the JAX
#: package's does, and a 12-block artifact holds its ~2.6 GB of float32
#: weights twice (weights.npz and model.bin), which one host thread
#: compresses at a few tens of MB/s — minutes the run's time limit does
#: not have (two blocks took 73.5–80.8 s; one block leaves room for
#: phase 8p).  The width is the bench's.
INWF_BLOCKS, INWF_TICKS = 1, 2
#: ``export_workflow``'s default, which the unit writes with.
INWF_GZIP_LEVEL = 9
#: The flags a user serving from inside the workflow gives.
INWF_FLAGS = ("--serve-max-batch", "8", "--serve-warmup",
              "--serve-kv-block-size", "16", "--serve-deadline", "60")
INWF_SERVING = {"max_batch": 8, "warmup": True, "kv_block_size": 16,
                "deadline": 60.0}
#: The planted B4 fault: one head of the first launch's output shifted
#: by this much.
INWF_PLANTED = 100.0


def token_mismatches(model, prompts, answers):
    """The answers that differ from ``model.generate(...,
    attend=decode_attention_reference)`` (the plain attention, on the
    card): a list of (request, prompt length, first differing position,
    served token, oracle token, the oracle's top-2 logit margin there)."""
    import numpy
    from veles_tpu_torch.ops import decode_attention as DA
    out = []
    for i, (prompt, got) in enumerate(zip(prompts, answers)):
        full, logits = model.generate(
            numpy.asarray([prompt]), MAX_NEW,
            attend=DA.decode_attention_reference, return_logits=True)
        if not numpy.isfinite(logits).all():
            fail("oracle logits not finite for request %d" % i)
        want = full[0, len(prompt):].tolist()
        if got != want:
            j = next(j for j in range(MAX_NEW) if got[j] != want[j])
            top2 = numpy.sort(logits[0, j])[-2:]
            out.append((i, len(prompt), j, got[j], want[j],
                        float(top2[1] - top2[0])))
    return out


def phase_inworkflow(workdir, smi):
    """Phase 7r: a user's path — train the TinyLM, then serve it from
    inside its workflow.  The ``--serve-*`` flags go through the port's
    command-line parser into ``root.common.serving``; a ``RESTfulAPI``
    unit linked after the decision (gated until training completes)
    exports the workflow and starts the server on the card within
    ``Launcher.run``; the training ticks launch B1-B3, every decode step
    and short extend chunk of the server B4.  Returns (the flash
    kernels' launches, B4's launches, numbers)."""
    import numpy
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.config import root
    from veles_tpu_torch.export import ExportedModel
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.ops import decode_attention as DA
    from veles_tpu_torch.ops import flash_attention as FA
    from veles_tpu_torch.restful import RESTfulAPI
    from veles_tpu_torch.znicz.samples.tinylm import TinyLMWorkflow
    started = time.monotonic()
    main = Main(["inworkflow.py", "-v", "warning"] + list(INWF_FLAGS))
    main.parse()
    main.apply_subsystem_flags()
    serving = {k: root.common.serving.get(k) for k in INWF_SERVING}
    if serving != INWF_SERVING:
        fail("%s left root.common.serving %s, expected %s" % (
            " ".join(INWF_FLAGS), serving, INWF_SERVING))
    engine = root.common.engine
    engine.remat = True
    engine.precision_level = 0
    engine.attention_dtype = "f32"
    engine.attention_kernel = "auto"
    prng.reset()
    prng.get(0).seed(43)
    launcher = Launcher()
    wf = TinyLMWorkflow(
        launcher, vocab_size=VOCAB, seq_len=POSITIONS, embed_dim=EMBED,
        n_heads=HEADS, n_blocks=INWF_BLOCKS, minibatch_size=TRAIN_BATCH,
        ticks_per_dispatch=1, max_epochs=1,
        loader_cls=synthetic_corpus(TRAIN_BATCH, TRAIN_BATCH * INWF_TICKS),
        loader_config={"validate_labels": False})
    path = os.path.join(workdir, "inworkflow.veles.tgz")
    api = RESTfulAPI(wf, host="127.0.0.1", port=0, artifact_path=path)
    api.link_from(wf.decision)
    api.gate_block = ~wf.decision.complete
    launcher.initialize(device="cuda")
    compiler = wf.compiler
    execute = compiler.execute
    ticks = []   # (training, loss, end of the tick)

    def timed_execute(training=True):
        metrics = execute(training=training)
        loss = float(metrics["loss"])
        ticks.append((training, loss, time.monotonic()))
        return metrics

    compiler.execute = timed_execute
    torch.cuda.synchronize()
    FA.reset_launches()
    launcher.run()
    flash = {"flash_forward": FA.flash_forward.launches,
             "flash_dq": FA.flash_dq.launches,
             "flash_dkv": FA.flash_dkv.launches}
    base = "http://127.0.0.1:%d" % api.port
    if api.server is None or get(base + "/health")["status"] != "ok":
        fail("the RESTfulAPI unit did not start its server")
    health_s = time.monotonic() - ticks[-1][2]
    compiler.execute = execute
    classes = [t[0] for t in ticks]
    expected = {"flash_forward": INWF_BLOCKS * (1 + 2 * INWF_TICKS),
                "flash_dq": INWF_BLOCKS * INWF_TICKS,
                "flash_dkv": INWF_BLOCKS * INWF_TICKS}
    print("in-workflow: TinyLM %d blocks at the bench width, ticks %s, "
          "losses %s; flash launches %s (expected %s); the unit served "
          "on %s: export %.1f s (%.2f GB, gzip level %d), server start "
          "%.1f s (load + warmup); the last tick to /health %.1f s" % (
              INWF_BLOCKS, classes, ["%.4f" % t[1] for t in ticks], flash,
              expected, api.device, api.export_seconds,
              os.path.getsize(path) / 1e9, INWF_GZIP_LEVEL,
              api.start_seconds, health_s))
    if classes != [False] + [True] * INWF_TICKS or flash != expected:
        fail("in-workflow training ran ticks %s and launched %s; the "
             "epoch implies %s" % (classes, flash, expected))
    if api.device != "cuda" or not all(
            numpy.isfinite(t[1]) for t in ticks):
        fail("in-workflow: served on %s, losses %s" % (
            api.device, [t[1] for t in ticks]))
    export_bytes = os.path.getsize(path)

    rng = numpy.random.RandomState(SEED % (1 << 31))
    prompts = [rng.randint(0, VOCAB, n).tolist() for n in PROMPT_LENGTHS]
    prompts.append(prompts[REPEAT_INDEX])

    def wave(batch):
        with concurrent.futures.ThreadPoolExecutor(len(batch)) as ex:
            futs = [ex.submit(post, base + "/api/generate",
                              {"tokens": [p], "max_new_tokens": MAX_NEW})
                    for p in batch]
            return [f.result()["generated"][0] for f in futs]

    log = CallLog(api.server.model)
    try:
        torch.cuda.synchronize()
        DA.decode_attention.launches = DA.decode_attention.quant_launches = 0
        log.calls = {}
        t0 = time.monotonic()
        answers = wave(prompts)
        wave_s = time.monotonic() - t0
        torch.cuda.synchronize()
        kernel = {"b4": DA.decode_attention.launches,
                  "b5": DA.decode_attention.quant_launches}
        calls = dict(log.calls)
        check_launches("in-workflow serving", kernel, log, True, False,
                       blocks=INWF_BLOCKS)
        stats = get(base + "/stats")
        # The planted fault: the first B4 launch of one more request
        # (a 5-token prompt: shorter than a block, so no prefix hit — its
        # prefill runs through the kernel) has one head's output spoiled.
        launch, spoiled = DA._launch, []

        def planted_launch(fn, *args):
            launch(fn, *args)
            if fn == "veles_decode_attention" and not spoiled:
                args[6][:, :, 0].add_(INWF_PLANTED)   # out (B, Sq, H, D)
                spoiled.append(fn)

        DA._launch = planted_launch
        try:
            planted = wave(prompts[:1])
        finally:
            DA._launch = launch
    finally:
        log.restore()
    api.stop()
    t0 = time.monotonic()
    oracle = ExportedModel(path, device="cuda")
    load_s = time.monotonic() - t0
    os.remove(path)
    mismatches = token_mismatches(oracle, prompts, answers)
    planted_mismatches = token_mismatches(oracle, prompts[:1], planted)
    print("in-workflow serving: %d answers against generate(attend="
          "decode_attention_reference) over ExportedModel(artifact, "
          "device='cuda') (loaded in %.1f s): %d differ %s; the planted B4 "
          "fault (head 0 of launch 1 + %g, %d launch spoiled): %d of 1 "
          "differ %s" % (len(answers), load_s, len(mismatches), mismatches,
                         INWF_PLANTED, len(spoiled),
                         len(planted_mismatches), planted_mismatches))
    if mismatches:
        fail("in-workflow serving: answers differ from the plain-attention "
             "oracle: %s" % mismatches)
    if len(spoiled) != 1 or not planted_mismatches:
        fail("in-workflow serving: the token gate does not see a planted "
             "B4 fault (%d launches spoiled)" % len(spoiled))
    ttft = stats["latency"].get("ttft.generate", {})
    numbers = {
        "blocks": INWF_BLOCKS, "flags": list(INWF_FLAGS),
        "losses": [t[1] for t in ticks],
        "flash_launches": flash, "b4_launches": kernel["b4"],
        "decode_calls": calls,
        "export_bytes": export_bytes, "export_s": api.export_seconds,
        "gzip_level": INWF_GZIP_LEVEL,
        "server_start_s": api.start_seconds,
        "last_tick_to_health_s": health_s,
        "wave_seconds": wave_s,
        "wave_tok_per_s": MAX_NEW * len(prompts) / wave_s,
        "ttft_p50_ms": ttft.get("p50_ms"),
        "ttft_largest_ms": ttft.get("p99_ms"),
        "planted_mismatches": len(planted_mismatches),
        "phase_s": time.monotonic() - started,
    }
    print("in-workflow readings on %s (smoke, not a benchmark): export "
          "%.2f GB at gzip level %d in %.1f s; the last tick to /health "
          "%.1f s; a wave of %d concurrent requests in %.3f s (%.1f tok/s), "
          "TTFT p50 %s ms; the phase %.1f s" % (
              smi, export_bytes / 1e9, INWF_GZIP_LEVEL,
              api.export_seconds, health_s, len(prompts), wave_s,
              numbers["wave_tok_per_s"], numbers["ttft_p50_ms"],
              numbers["phase_s"]))
    root.common.__dict__.pop("serving", None)
    del oracle, api, wf, launcher, compiler
    return flash, kernel["b4"], numbers


#: Phase 7p: the Kohonen sample through the command line (the JAX
#: gate's 12 epochs and seed) and MNIST RBM pretraining on the seeded
#: synthetic IDX files, RBM_EPOCHS epochs.
RBM_EPOCHS = 3


def phase_pretraining(workdir, smi):
    """Phase 7p: ``python -m veles_tpu_torch
    veles_tpu_torch/znicz/samples/kohonen.py root.kohonen.max_epochs=12
    --random-seed 5`` on the card must organize its map (quantization
    error < 0.1, a finite 8x8 U-matrix); ``MnistRBMWorkflow`` on
    ``write_mnist_idx``'s files must lower its validation reconstruction
    error every epoch.  Returns numbers."""
    import numpy
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.loader.base import VALID
    from veles_tpu_torch.znicz.samples.mnist_rbm import MnistRBMWorkflow
    prng.reset()
    t0 = time.monotonic()
    main = run_cli([os.path.join(HERE, "veles_tpu_torch", "znicz",
                                 "samples", "kohonen.py"),
                    "root.kohonen.max_epochs=12", "--random-seed", "5",
                    "-v", "warning"])
    som_s = time.monotonic() - t0
    som = main.workflow
    qe, umatrix = som.quantization_error(), som.umatrix()
    on_card = som.som.weights.devmem.device.type
    root.__dict__.pop("kohonen", None)
    print("pretraining: kohonen through the command line on %s: %d "
          "epochs in %.1f s, quantization error %.4f, U-matrix %s (range "
          "%.3g-%.3g)" % (on_card, som.decision.epoch_number, som_s, qe,
                          umatrix.shape, umatrix.min(), umatrix.max()))
    if not (som.decision.epoch_number == 12 and qe < 0.1 and
            umatrix.shape == (8, 8) and numpy.isfinite(umatrix).all() and
            on_card == "cuda"):
        fail("the Kohonen sample misses its gate: %d epochs on %s, "
             "quantization error %.4f, U-matrix %s" % (
                 som.decision.epoch_number, on_card, qe, umatrix))

    datasets = os.path.join(workdir, "datasets")
    write_mnist_idx(datasets)
    root.common.dirs.datasets = datasets
    prng.reset()
    prng.get(0).seed(9)
    launcher = Launcher()
    wf = MnistRBMWorkflow(launcher, max_epochs=RBM_EPOCHS)
    history = []
    on_last = wf.decision.on_last_minibatch

    def record(cls):
        on_last(cls)
        if cls == VALID:
            history.append(wf.decision.epoch_loss[VALID] / 784.0)

    wf.decision.on_last_minibatch = record
    t0 = time.monotonic()
    launcher.initialize(device="cuda")
    launcher.run()
    rbm_s = time.monotonic() - t0
    clean_cli_config()
    print("pretraining: MNIST RBM (%d hidden, CD-%d) on %s: validation "
          "reconstruction error per pixel by epoch %s, %.1f s" % (
              wf.rbm.n_hidden, wf.rbm.cd_k,
              wf.rbm.weights.devmem.device.type,
              ["%.5f" % x for x in history], rbm_s))
    if len(history) != RBM_EPOCHS or not all(
            b < a for a, b in zip(history, history[1:])) or \
            not numpy.isfinite(history).all():
        fail("MNIST RBM's reconstruction error does not fall every "
             "epoch: %s" % history)
    return {"kohonen": {"epochs": som.decision.epoch_number,
                        "quantization_error": qe, "seconds": som_s,
                        "umatrix_range": [float(umatrix.min()),
                                          float(umatrix.max())]},
            "mnist_rbm": {"validation_error_per_pixel": history,
                          "seconds": rbm_s}}


#: Phase 7g (population): P members of the full-width AlexNet with
#: tuned (learning_rate, gradient_moment) — one vmapped population step
#: per tick — over POP_EPOCHS epochs of one validation and POP_TRAIN
#: train ticks at ALEXNET_BATCH (POP_BATCH_CUT when P times that does
#: not fit), and P members of the bench-width TinyLM cut to INWF_BLOCKS
#: blocks with a tuned learning_rate over one epoch of one validation
#: and POP_LM_TICKS train ticks.
POP_GENES = ((0.01, 0.9), (0.02, 0.5), (0.005, 0.95), (0.015, 0.0))
POP_EPOCHS, POP_TRAIN, POP_BATCH_CUT = 2, 2, 256
POP_LM_GENES = ((0.01,), (0.03,))
POP_LM_TICKS = 2
#: A vmapped member is held to the same member run alone through the
#: sequential tick with its genes as hypers (``execute_block(...,
#: hypers=...)``), from the same state over the same blocks: each
#: parameter tensor's gap (norm) within a tolerance of the norm of its
#: change over the run plus the floor per sqrt(element).  The vmapped
#: convolutions run with the members' weights stacked (a grouped
#: convolution where the input is per member too), the vmapped matrix
#: products as batched ones, and the sums over a member's batch (a
#: bias's gradient) over a tensor with a member axis: cuDNN and cuBLAS
#: pick other algorithms and orders than for one member, and on the
#: bfloat16 stream (activations, conv operands, their gradients) the
#: float32 sums round at other elements.  Calibration on an H100 at this
#: geometry (P = 4, batch 512, 4 train ticks): at most 0.098 of the
#: change (conv2's bias; the conv biases' gradients sum the most
#: bfloat16 values), less for every weight tensor; a member against its
#: neighbour's genes at least 0.29 of the change on its most-moved
#: tensor.  So the bfloat16 gate is POP_CHANGE_TOL = 0.2, and a member
#: against its neighbour's genes must fail it (``population_gate``'s
#: planted fault).  The same generation in float32 (``precision_level``
#: 1) is held to POP_F32_TOL: there only the float32 sums' order
#: differs (0.0024 of the change on the same card).  TinyLM: phase 5's
#: TRAIN_CHANGE_TOL.  The fitness (1 − the validation error of the last
#: validation pass) within POP_FITNESS_TOL: a count of errors, which
#: such roundings move only at near ties.
POP_FITNESS_TOL = 0.01
POP_CHANGE_TOL, POP_F32_TOL = 0.2, 0.01
#: Timing: warm vmapped train ticks and runs of P sequential member
#: ticks, each timed alone by CUDA events.
POP_TIMED = 5


class LaunchLog(object):
    """Records every launch of the LRN (and flash) kernels while it is
    installed: the C entry point and its arguments' geometry (the LRN's
    route code and row count, the flash kernels' batch)."""

    def __init__(self):
        from veles_tpu_torch.ops import flash_attention as FA
        from veles_tpu_torch.ops import lrn as L
        self.calls = []
        self.modules = (L, FA)
        self.originals = [m._launch for m in self.modules]
        lrn_launch, flash_launch = self.originals

        def lrn(fn, name, route, dtype, *args):
            # args: the tensors, then rows, channels, n, k, alpha/n, beta
            self.calls.append((fn, route, args[-6]))
            return lrn_launch(fn, name, route, dtype, *args)

        def flash(fn, name, *args):
            self.calls.append((fn, None, args[2].shape[0]))
            return flash_launch(fn, name, *args)
        L._launch, FA._launch = lrn, flash

    def remove(self):
        for module, original in zip(self.modules, self.originals):
            module._launch = original

    def of(self, prefix):
        return [c for c in self.calls if c[0].startswith(prefix)]


def population_module(name, build):
    """A workflow module (``run(load, main)``) whose ``load`` builds
    ``build()``'s (class, kwargs)."""
    import types
    module = types.ModuleType(name)

    def run(load, main):
        cls, kwargs = build()
        load(cls, **kwargs)
        main()
    module.run = run
    module.__file__ = os.path.join(HERE, name + ".py")
    return module


def restore_start(compiler, start):
    """Puts every parameter and state back to ``start``; a state the
    step has gained since (the float32 stream's Kahan carry) to
    zeros."""
    import torch
    compiler._ensure_compiled()
    for n, v in list(compiler._param_vecs.items()) + \
            list(compiler._state_vecs.items()):
        v.devmem = start[n].clone() if n in start else \
            torch.zeros_like(v.devmem)


def member_alone(evaluator, genes, epochs, start):
    """One member run alone through the sequential tick: the workflow's
    parameters and states put back to ``start`` (the evaluator's tiling
    source), the generators and the loader's walk replayed as
    ``PopulationEvaluator.evaluate`` replays them, every block through
    ``execute_block(..., hypers=genes)``; returns (fitness, host copies
    of the parameters)."""
    import numpy
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.base import TRAIN, VALID
    wf = evaluator.workflow
    loader, compiler = wf.loader, wf.compiler
    restore_start(compiler, start)
    hypers = dict(zip(evaluator.names, (float(g) for g in genes)))
    prng.get(0).seed(evaluator.seed)
    if getattr(loader, "prng_key", 0) != 0:
        prng.get(loader.prng_key).seed(evaluator.seed)
    loader.shuffled_indices.map_write()
    loader.shuffled_indices.mem[...] = evaluator._loader_indices
    loader.global_offset = evaluator._loader_offset
    loader.epoch_number = evaluator._loader_epoch
    acc_keys = [n for n in compiler._state_vecs
                if n.endswith("/epoch_acc") or n.endswith("/epoch_acc_c")]
    K = max(int(getattr(wf, "ticks_per_dispatch", 1) or 1), 8)
    min_err = {VALID: numpy.inf, TRAIN: numpy.inf}
    seen = set()
    first = loader.epoch_number
    while loader.epoch_number - first < epochs:
        blocks = loader.serve_block(K)
        cls = int(loader.minibatch_class)
        compiler.execute_block(blocks, cls == TRAIN, hypers=hypers)
        if loader.last_minibatch and cls in min_err:
            for name in acc_keys:
                acc = compiler._state_vecs[name].devmem
                if name.endswith("/epoch_acc"):
                    row = acc[cls].cpu().numpy()
                    min_err[cls] = min(min_err[cls],
                                       row[0] / max(row[1], 1.0))
                    seen.add(cls)
                acc[cls] = 0.0
    cls = VALID if VALID in seen else TRAIN
    params = {n: v.devmem.to("cpu") for n, v in
              compiler._param_vecs.items()}
    return float(1.0 - min_err[cls]), params


def population_gate(label, members, alone, start, tol, floor):
    """Per member and parameter tensor: the vmapped member's gap (norm)
    to the member run alone, against tol x the norm of its change over
    the run plus floor x sqrt(elements); fails when a gap passes its
    bound.  A planted fault shows the gate sees a member trained with
    other genes: member i against the run alone of member i + 1 must
    fail it.  Returns (the largest share of the bound, the planted
    fault's smallest largest-share over the members, the tensor of the
    largest share)."""
    import math
    P = len(alone)

    def shares(got_i, want):
        out = {}
        for name, ref in want.items():
            got = members[name][got_i].to("cpu").float()
            gap = (got - ref.float()).norm().item()
            change = (ref.float() - start[name].to("cpu").float()
                      ).norm().item()
            out[name] = gap / (tol * change + floor * math.sqrt(
                ref.numel()))
        return out
    worst, where = 0.0, None
    for i in range(P):
        for name, share in shares(i, alone[i]).items():
            if share > worst:
                worst, where = share, "member %d %s" % (i, name)
    planted = min(max(shares(i, alone[(i + 1) % P]).values())
                  for i in range(P))
    print("%s: vmapped members vs alone: largest share of the bound "
          "%.4f (%s; bound %g x change + %g x sqrt(n)); a member against "
          "its neighbour's genes: at least %.1f" % (
              label, worst, where, tol, floor, planted))
    if worst > 1.0:
        fail("%s: %s vmapped vs alone at %.3f of the bound" % (
            label, where, worst))
    if planted <= 1.0:
        fail("%s: a member against another member's genes reads only "
             "%.3f of the bound: the gate cannot see a wrong member" % (
                 label, planted))
    return worst, planted, where


def event_ms(fn):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def population_timing(evaluator, genes, block):
    """Warm tick times: a vmapped train tick of P members, and P member
    ticks run one after another through the sequential tick (each with
    its genes), on the same one-tick train block; POP_TIMED of each, in
    turns.  Returns (vmapped p50, sequential-P p50) in ms."""
    import numpy
    import torch
    compiler = evaluator.workflow.compiler
    pop_params, pop_states = evaluator.last_population
    consts = {str(id(v)): v.devmem for v in compiler.const_vectors}
    hvals = torch.tensor(genes, dtype=torch.float32,
                         device=compiler._device())
    gen = compiler._generator()
    box = [pop_params, pop_states]

    def vmapped():
        box[0], box[1] = compiler._pop_block(box[0], box[1], block,
                                             consts, gen, True, hvals)

    def sequential():
        for g in genes:
            compiler.execute_block(block, True, hypers=dict(
                zip(evaluator.names, (float(x) for x in g))))
    vmapped()
    sequential()
    v_ms, s_ms = [], []
    for _ in range(POP_TIMED):
        v_ms.append(event_ms(vmapped))
        s_ms.append(event_ms(sequential))
    return float(numpy.median(v_ms)), float(numpy.median(s_ms))


def phase_population(workdir, smi):
    """Phase 7g: the GA's population step on the card.

    AlexNet: ``PopulationEvaluator`` over the full-width AlexNet (phase
    6's synthetic 227 px / 1000-class set) with P = len(POP_GENES)
    members tuning learning_rate and gradient_moment — one
    ``torch.func.vmap`` of the train tick over the members per tick, the
    LRN kernels on the members folded into their batch.  Gates: B6 and
    B7 launch twice per vmapped train tick (B6 twice per validation
    tick), every launch on the register route over P·N rows; each
    member's parameters and fitness match the member run alone
    (``member_alone``); a second generation with the same genes reads
    bit-equal fitnesses and parameters.  Readings: the vmapped tick p50
    against P sequential ticks' p50, the peak device memory.

    TinyLM at the bench width cut to INWF_BLOCKS blocks, P =
    len(POP_LM_GENES) with a tuned learning_rate, no remat (the
    population step keeps its activations): B1-B3 launch per vmapped
    tick as many times as the sequential tick does, on the members folded
    into the batch; members match their runs alone.

    The command line on the card, MNIST FC on ``write_mnist_idx``'s
    files: ``--optimize 4:2``, ``--population 4:2`` and
    ``--ensemble-train 2:0.8`` then ``--ensemble-test``, each result
    file's keys and values checked as the JAX package's tests check
    them.  Returns (launches of B1, B2, B3, B6 and B7, numbers)."""
    import json as _json
    import numpy
    import torch
    from veles_tpu_torch import prng, resilience
    from veles_tpu_torch.config import Tune, override_scope, root
    from veles_tpu_torch.genetics import collect_tunes
    from veles_tpu_torch.genetics.vmap_eval import PopulationEvaluator
    from veles_tpu_torch.ops import flash_attention as FA
    from veles_tpu_torch.ops import lrn as L
    from veles_tpu_torch.znicz.samples.imagenet import AlexNetWorkflow
    from veles_tpu_torch.znicz.samples.tinylm import TinyLMWorkflow
    started = time.monotonic()
    engine = root.common.engine
    saved_engine = dict(engine.__dict__)
    numbers, launches = {}, {}
    P = len(POP_GENES)

    # -- AlexNet -------------------------------------------------------
    engine.precision_level = 0
    engine.pallas_lrn = True
    batch = [ALEXNET_BATCH]

    def alexnet():
        n = batch[0]
        return AlexNetWorkflow, dict(
            minibatch_size=n, max_epochs=POP_EPOCHS,
            loader_config={"sim_train": n * POP_TRAIN, "sim_valid": n,
                           "sim_image_size": 227, "sim_classes": 1000,
                           "validate_labels": False})
    tuned = {"population_smoke.learning_rate": Tune(0.01, 0.001, 0.05),
             "population_smoke.gradient_moment": Tune(0.9, 0.0, 0.99)}
    module = population_module("alexnet_population", alexnet)
    log = LaunchLog()
    try:
        with override_scope(root, tuned):
            tunes = [(p, t) for p, t in collect_tunes(root)
                     if p in tuned]
            t0 = time.monotonic()
            evaluator = PopulationEvaluator(module, tunes, seed=SEED)
            build_s = time.monotonic() - t0
            genes = [[dict(zip(("learning_rate", "gradient_moment"),
                               g))[n] for n in evaluator.names]
                     for g in POP_GENES]
            compiler = evaluator.workflow.compiler
            start = {n: v.devmem.clone() for n, v in
                     list(compiler._param_vecs.items()) +
                     list(compiler._state_vecs.items())}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            L.reset_launches()
            t0 = time.monotonic()
            try:
                fitness = evaluator.evaluate(genes)
            except torch.cuda.OutOfMemoryError:
                print("population: P=%d x batch %d does not fit; the "
                      "batch is cut to %d" % (P, batch[0], POP_BATCH_CUT))
                del evaluator, compiler, start
                gc.collect()
                torch.cuda.empty_cache()
                batch[0] = POP_BATCH_CUT
                evaluator = PopulationEvaluator(module, tunes, seed=SEED)
                compiler = evaluator.workflow.compiler
                start = {n: v.devmem.clone() for n, v in
                         list(compiler._param_vecs.items()) +
                         list(compiler._state_vecs.items())}
                torch.cuda.reset_peak_memory_stats()
                L.reset_launches()
                log.calls = []
                t0 = time.monotonic()
                fitness = evaluator.evaluate(genes)
            torch.cuda.synchronize()
            gen_s = time.monotonic() - t0
            peak = torch.cuda.max_memory_allocated()
            n = batch[0]
            train_ticks = POP_EPOCHS * POP_TRAIN
            ticks = POP_EPOCHS * (POP_TRAIN + 1)
            launches["lrn_forward"] = L.lrn_forward.launches
            launches["lrn_backward"] = L.lrn_backward.launches
            routes = {"lrn_forward": dict(L.lrn_forward.launches_by_route),
                      "lrn_backward": dict(L.lrn_backward.launches_by_route)}
            rows = sorted({c[2] for c in log.of("veles_lrn")})
            want_rows = [P * n * 27 * 27, P * n * 55 * 55]
            codes = {c[1] for c in log.of("veles_lrn")}
            print("population: AlexNet P=%d x batch %d, genes %s: "
                  "generation of %d ticks (%d train) in %.1f s, fitness %s;"
                  " B6 %d, B7 %d launches (expected %d, %d), routes %s, "
                  "rows %s (expected %s); build %.1f s; peak %.2f GB" % (
                      P, n, genes, ticks, train_ticks, gen_s,
                      fitness.tolist(), launches["lrn_forward"],
                      launches["lrn_backward"], 2 * ticks,
                      2 * train_ticks, routes, rows, want_rows, build_s,
                      peak / 1e9))
            if (launches["lrn_forward"], launches["lrn_backward"]) != \
                    (2 * ticks, 2 * train_ticks):
                fail("population: B6/B7 launched %d/%d times; %d vmapped "
                     "ticks (%d train) imply %d/%d" % (
                         launches["lrn_forward"],
                         launches["lrn_backward"], ticks, train_ticks,
                         2 * ticks, 2 * train_ticks))
            if rows != want_rows or codes != {
                    L._ROUTE_CODES["register"]} or \
                    routes["lrn_forward"]["wide"] or \
                    routes["lrn_backward"]["wide"]:
                fail("population: LRN launches over rows %s on routes "
                     "%s; the fold of P=%d members implies rows %s on "
                     "the register route" % (rows, routes, P, want_rows))
            first = {k: v.clone() for k, v in
                     evaluator.last_population[0].items()}
            again = evaluator.evaluate(genes)
            if not numpy.array_equal(fitness, again) or not all(
                    torch.equal(first[k], v) for k, v in
                    evaluator.last_population[0].items()):
                fail("population: a second generation with the same "
                     "genes read fitness %s (first %s) or other weights"
                     % (again.tolist(), fitness.tolist()))
            del first
            members = evaluator.last_population[0]
            alone, alone_fit = [], []
            for g in genes:
                f, params = member_alone(evaluator, g, POP_EPOCHS, start)
                alone.append(params)
                alone_fit.append(f)
            worst, planted, where = population_gate(
                "population: AlexNet", members, alone, start,
                POP_CHANGE_TOL, ALEXNET_FLOOR)
            fit_gap = float(numpy.abs(numpy.array(alone_fit) -
                                      fitness).max())
            print("population: AlexNet fitness alone %s, largest gap "
                  "%.5f" % (alone_fit, fit_gap))
            if fit_gap > POP_FITNESS_TOL:
                fail("population: vmapped fitness %s vs alone %s" % (
                    fitness.tolist(), alone_fit))
            # The same generation with the float32 stream (the stream's
            # dtype is read at every tick), from the same start.
            del members, alone
            engine.precision_level = 1
            restore_start(compiler, start)
            f32_fit = evaluator.evaluate(genes)
            alone = [member_alone(evaluator, g, POP_EPOCHS, start)[1]
                     for g in genes]
            f32_worst, f32_planted, f32_where = population_gate(
                "population: AlexNet float32", evaluator.last_population[0],
                alone, start, POP_F32_TOL, ALEXNET_FLOOR)
            engine.precision_level = 0
            del alone
            block = {}
            loader = evaluator.workflow.loader
            while int(loader.minibatch_class) != 2 or not block:
                block = loader.serve_block(1)
            v_ms, s_ms = population_timing(evaluator, genes, block)
            print("population: AlexNet warm train tick p50: vmapped P=%d "
                  "%.2f ms, %d sequential member ticks %.2f ms (%.2fx); "
                  "peak %.2f GB; %s" % (P, v_ms, P, s_ms, s_ms / v_ms,
                                        peak / 1e9, smi))
            numbers["alexnet"] = {
                "members": P, "batch": n, "genes": genes,
                "batch_cut": n != ALEXNET_BATCH,
                "epochs": POP_EPOCHS, "ticks": ticks,
                "train_ticks": train_ticks, "generation_s": gen_s,
                "fitness": fitness.tolist(), "alone_fitness": alone_fit,
                "vmapped_vs_alone_share_of_bound": worst,
                "largest_share_at": where,
                "other_genes_share_of_bound": planted,
                "float32": {"fitness": f32_fit.tolist(),
                            "tol": POP_F32_TOL,
                            "share_of_bound": f32_worst,
                            "largest_share_at": f32_where,
                            "other_genes_share_of_bound": f32_planted},
                "fitness_gap": fit_gap, "repeat_bit_equal": True,
                "lrn_launches": dict(launches), "lrn_routes": routes,
                "lrn_rows": rows, "vmapped_tick_p50_ms": v_ms,
                "sequential_p_ticks_p50_ms": s_ms,
                "peak_bytes": peak, "card": smi}
            del evaluator, compiler, start
            gc.collect()
            torch.cuda.empty_cache()

        # -- TinyLM at the bench width, INWF_BLOCKS blocks ------------
        engine.remat = False
        engine.precision_level = 0
        engine.attention_dtype = "f32"
        engine.attention_kernel = "auto"
        corpus = synthetic_corpus(TRAIN_BATCH, TRAIN_BATCH * POP_LM_TICKS)

        def tinylm():
            return TinyLMWorkflow, dict(
                vocab_size=VOCAB, seq_len=POSITIONS, embed_dim=EMBED,
                n_heads=HEADS, n_blocks=INWF_BLOCKS,
                minibatch_size=TRAIN_BATCH, max_epochs=1,
                loader_cls=corpus,
                loader_config={"validate_labels": False})
        lm_tuned = {"population_smoke.learning_rate":
                    Tune(0.01, 0.001, 0.05)}
        with override_scope(root, lm_tuned):
            tunes = [(p, t) for p, t in collect_tunes(root)
                     if p in lm_tuned]
            t0 = time.monotonic()
            evaluator = PopulationEvaluator(
                population_module("tinylm_population", tinylm), tunes,
                seed=SEED)
            compiler = evaluator.workflow.compiler
            start = {n: v.devmem.clone() for n, v in
                     list(compiler._param_vecs.items()) +
                     list(compiler._state_vecs.items())}
            FA.reset_launches()
            log.calls = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            lm_fit = evaluator.evaluate(POP_LM_GENES, epochs=1)
            torch.cuda.synchronize()
            lm_s = time.monotonic() - t0
            lm_peak = torch.cuda.max_memory_allocated()
            vm = {k: getattr(FA, k).launches for k in
                  ("flash_forward", "flash_dq", "flash_dkv")}
            batches = sorted({c[2] for c in log.of("veles_flash")})
            FA.reset_launches()
            alone = []
            for g in POP_LM_GENES:
                alone.append(member_alone(evaluator, g, 1, start)[1])
            seq = {k: getattr(FA, k).launches for k in vm}
            lm_ticks = 1 + POP_LM_TICKS
            want = {"flash_forward": INWF_BLOCKS * lm_ticks,
                    "flash_dq": INWF_BLOCKS * POP_LM_TICKS,
                    "flash_dkv": INWF_BLOCKS * POP_LM_TICKS}
            per_member = {k: v // len(POP_LM_GENES) for k, v in seq.items()}
            print("population: TinyLM %d blocks P=%d, genes %s: %.1f s "
                  "with the build, fitness %s; B1/B2/B3 vmapped %s, "
                  "sequential per member %s (expected %s), batches %s; "
                  "peak %.2f GB" % (
                      INWF_BLOCKS, len(POP_LM_GENES), POP_LM_GENES, lm_s,
                      lm_fit.tolist(), vm, per_member, want, batches,
                      lm_peak / 1e9))
            if vm != want or per_member != want or \
                    batches != [len(POP_LM_GENES) * TRAIN_BATCH]:
                fail("population: flash launches vmapped %s, sequential "
                     "per member %s, over batches %s; the ticks imply %s "
                     "each, over batch %d" % (
                         vm, per_member, batches, want,
                         len(POP_LM_GENES) * TRAIN_BATCH))
            lm_worst, lm_planted, lm_where = population_gate(
                "population: TinyLM", evaluator.last_population[0], alone,
                start, TRAIN_CHANGE_TOL, TRAIN_FLOOR)
            launches.update(vm)
            numbers["tinylm"] = {
                "blocks": INWF_BLOCKS, "members": len(POP_LM_GENES),
                "genes": [list(g) for g in POP_LM_GENES],
                "seconds": lm_s, "fitness": lm_fit.tolist(),
                "flash_launches": vm, "flash_batches": batches,
                "vmapped_vs_alone_share_of_bound": lm_worst,
                "largest_share_at": lm_where,
                "other_genes_share_of_bound": lm_planted,
                "peak_bytes": lm_peak}
            del evaluator, compiler, start, alone
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        log.remove()
        engine.__dict__.clear()
        engine.__dict__.update(saved_engine)

    # -- the command line: MNIST FC ------------------------------------
    datasets = os.path.join(workdir, "datasets")
    write_mnist_idx(datasets)
    mnist_py = os.path.join(HERE, "veles_tpu_torch", "znicz", "samples",
                            "mnist.py")
    common = [mnist_py, "root.common.dirs.datasets=%r" % datasets,
              "--random-seed", "42", "-v", "warning"]
    cli, counters = {}, {}

    def run_json(argv, name):
        path = os.path.join(workdir, name)
        prng.reset()
        resilience.reset()
        t0 = time.monotonic()
        run_cli(common + argv + ["--result-file", path])
        counters[name] = resilience.stats.snapshot()
        clean_cli_config()
        root.__dict__.pop("mnist", None)
        with open(path) as fin:
            data = _json.load(fin)
        cli[name] = time.monotonic() - t0
        return data

    tune = "root.mnist.learning_rate=Tune(0.0005, 0.0001, 0.5)"
    ga = run_json(["root.mnist.max_epochs=2", tune, "--optimize", "4:2"],
                  "ga.json")
    if not (ga["mode"] == "genetics" and ga["generations"] == 2 and
            len(ga["history"]) == 2 and
            ga["best_fitness"] > ga["history"][0] - 1e-9 and
            ga["best_fitness"] > 0.5 and
            "root.mnist.learning_rate" in ga["best_config"]):
        fail("--optimize 4:2 wrote %s" % ga)
    pop = run_json(["root.mnist.max_epochs=2", tune, "--population",
                    "4:2"], "population.json")
    vmap_jobs = counters["population.json"].get(
        "population.vmap_generations")
    if not (vmap_jobs == 2 and
            pop["mode"] == "population" and pop["scheduling"] == "ga" and
            pop["size"] == 4 and pop["best_member"] == "ga" and
            pop["best_fitness"] > 0.5 and
            set(pop["best_overrides"]) == {"mnist.learning_rate"}):
        fail("--population 4:2 wrote %s after %s vmapped generations" %
             (pop, vmap_jobs))
    snaps = os.path.join(workdir, "ensemble")
    # Uncompressed snapshots: gzip's level 9 on the synthetic MNIST
    # workflow took seconds a snapshot on the card's host, enough that
    # every epoch outlasted the snapshotter's one-second throttle and
    # snapshotted again (16 s to 391 s for the run).
    ens = run_json(["root.mnist.max_epochs=4", "root.mnist.learning_rate="
                    "0.03", "--snapshot-dir", snaps,
                    "--snapshot-compression", "", "--ensemble-train",
                    "2:0.8"], "ensemble.json")
    if not (ens["mode"] == "ensemble-train" and ens["size"] == 2 and
            len(ens["instances"]) == 2 and
            len({i["seed"] for i in ens["instances"]}) == 2 and
            all(os.path.isfile(i["snapshot"]) and i["fitness"] > 0.7 and
                i["train_ratio"] == 0.8 for i in ens["instances"])):
        fail("--ensemble-train 2:0.8 wrote %s" % ens)
    test = run_json(["--ensemble-test", os.path.join(workdir,
                                                     "ensemble.json")],
                    "ensemble_test.json")
    errs = [i["validation_err"] for i in test["instances"]]
    if not (test["mode"] == "ensemble-test" and test["size"] == 2 and
            test["ensemble_validation_err"] <= max(errs) + 1e-9 and
            test["ensemble_validation_err"] < 0.12):
        fail("--ensemble-test wrote %s" % test)
    print("population: the command line on the card — --optimize 4:2 "
          "best %.4f %s (history %s); --population 4:2 best %.4f %s; "
          "--ensemble-train 2:0.8 fitnesses %s, --ensemble-test errors "
          "%s, joint %.4f; seconds %s" % (
              ga["best_fitness"], ga["best_config"], ga["history"],
              pop["best_fitness"], pop["best_overrides"],
              ens["fitnesses"], errs, test["ensemble_validation_err"],
              {k: round(v, 1) for k, v in cli.items()}))
    numbers["command_line"] = {
        "optimize": {k: ga[k] for k in ("best_fitness", "best_config",
                                        "history")},
        "population": {k: pop[k] for k in ("best_fitness",
                                           "best_overrides")},
        "population_vmap_generations": vmap_jobs,
        "ensemble_fitnesses": ens["fitnesses"],
        "ensemble_errors": errs,
        "ensemble_joint_error": test["ensemble_validation_err"],
        "seconds": cli}
    numbers["seconds"] = time.monotonic() - started
    print("population: phase %.1f s" % numbers["seconds"])
    return launches, numbers


#: The quantized serving path: --kv-dtype int8 --weight-dtype int8 --spec
#: at --spec-max-k 4 (verifies of up to 5 columns).  Beside the mixed wave,
#: two prompts that repeat a short pattern, where the n-gram drafter
#: finds its matches.
#: Phase 8p: the parallel styles on a one-rank NCCL world at the bench
#: width (embed 2048, 16 heads of 128, MLP 8192, vocab 16384, 1024
#: positions, batch 8), cut to PAR_BLOCKS of the bench's 12 blocks as
#: phase 7r is.  The MoE TinyLM routes top-PAR_TOPK of PAR_EXPERTS
#: experts (bench.py's --moe-topk geometry); the pipelined TinyLM runs
#: 1F1B over PAR_MICRO microbatches.
PAR_BLOCKS, PAR_TICKS = 2, 2
PAR_EXPERTS, PAR_TOPK, PAR_MICRO = 8, 2, 4
#: The ring's virtual rank counts, at the training shape.
RING_NS = (2, 4)


def par_tinylm(launcher, seed, **kwargs):
    """The bench-width TinyLM of phase 8p (``kwargs`` pick the MoE or
    the pipelined stack) on ``launcher``, seeded."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.samples.tinylm import TinyLMWorkflow
    prng.reset()
    prng.get(0).seed(seed)
    return TinyLMWorkflow(
        launcher, vocab_size=VOCAB, seq_len=POSITIONS, embed_dim=EMBED,
        n_heads=HEADS, n_blocks=PAR_BLOCKS, minibatch_size=TRAIN_BATCH,
        ticks_per_dispatch=1, max_epochs=1,
        loader_cls=synthetic_corpus(TRAIN_BATCH, TRAIN_BATCH * PAR_TICKS),
        loader_config={"validate_labels": False}, **kwargs)


class TickRecorder(object):
    """Wraps a compiler's ``execute``: each tick's class, loss, seconds,
    the state before it (device clones, the partitioned slots gathered
    first) and its minibatch; :meth:`replay` runs a recorded tick again
    from its state."""

    def __init__(self, compiler):
        self.compiler = compiler
        self.execute = compiler.execute
        self.ticks = []
        compiler.execute = self._run

    def state(self):
        c = self.compiler
        c._ensure_compiled()
        c.gather_state()
        return {n: v.devmem.clone() for n, v in
                list(c._param_vecs.items()) + list(c._state_vecs.items())}

    def _run(self, training=True):
        import torch
        before = self.state()
        batch = [v.mem.copy() for v in self.compiler.batch_vectors]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        metrics = self.execute(training=training)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        self.ticks.append((training, loss, time.monotonic() - t0, before,
                           batch))
        return metrics

    def restore(self, state, batch):
        c = self.compiler
        c._held = {}
        for n, v in list(c._param_vecs.items()) + \
                list(c._state_vecs.items()):
            v.devmem = state[n].clone()
        for vec, arr in zip(c.batch_vectors, batch):
            vec.mem = arr

    def replay(self):
        """Every recorded tick again from its state: (losses, the
        parameters after each train tick)."""
        losses, afters = [], []
        for training, _, _, before, batch in self.ticks:
            self.restore(before, batch)
            losses.append(float(self.execute(training=training)["loss"]))
            if training:
                afters.append({n: v.devmem.clone() for n, v in
                               self.compiler._param_vecs.items()})
        return losses, afters

    def close(self):
        self.compiler.execute = self.execute


def flash_counts():
    from veles_tpu_torch.ops import flash_attention as FA
    return {"flash_forward": FA.flash_forward.launches,
            "flash_dq": FA.flash_dq.launches,
            "flash_dkv": FA.flash_dkv.launches}


def param_gaps(afters, others, befores):
    """name -> max over the train ticks of gap / (TRAIN_CHANGE_TOL ·
    change + TRAIN_FLOOR · sqrt(n)): above 1 fails phase 5's gate."""
    import math
    worst = {}
    for after, other, before in zip(afters, others, befores):
        for name, now in other.items():
            gap = (after[name] - now).norm().item()
            change = (now - before[name]).norm().item()
            bound = TRAIN_CHANGE_TOL * change + \
                TRAIN_FLOOR * math.sqrt(now.numel())
            worst[name] = max(worst.get(name, 0.0), gap / bound)
    return worst


#: The ring check's dtype pairs (storage/operands).  On the FP32 units
#: (f32/f32) the ring's out and gradients are held to the same loop
#: through the kernels' plain versions, to the whole-sequence B1-B3 and
#: to the plain attention at float32 tolerance.  With bf16 operands a
#: chunk's backward rounds its cotangent exp(lse_i - lse)·dO to bf16, and
#: two chains whose forwards (lse) differ in the last f32 bits round some
#: of those elements to neighbouring bf16 values: the kernels' gradients
#: read 1.6-2.2x of the bf16 tolerance against the plain chunks and the
#: whole sequence alike, but 0.54-0.83x against the plain backward on the
#: kernels' own forward ("kernel_fwd"), which rounds the same cotangents
#: (NVIDIA H100 80GB HBM3).  So that pair's out is gated against the
#: plain chunks and the whole sequence, and its out and gradients against
#: kernel_fwd.  The training pair (bf16 storage, N = 4) also rounds each
#: chunk's gradient to bf16 before autograd sums the chunks: it reads
#: those shares.  Every pair gates the ring's relative L2 error against
#: the float32 plain attention at RING_L2_LIMIT times the plain chunks'
#: (read 1.000-1.001 with bf16 operands or storage; both chains 2.4x
#: the whole sequence's, which rounds once, in the training pair) plus
#: RING_L2_FLOOR, and a control with the merge's lse cotangent dropped
#: must fail both gates.  Every pair's launches and offsets are gated.
RING_L2_LIMIT, RING_L2_FLOOR = 1.1, 1e-6
RING_DTYPES = ("f32/f32", "f32/bf16")


def plain_chunk(forward=None):
    """The chunk contract (``flash_chunk``: ``(out, lse)``, the lse
    cotangent folded into delta) through the kernels' plain backward —
    the plain version of one ring step.  ``forward``: the chunk's
    ``(out, lse)`` (default the plain forward; ``flash_forward`` gives
    the kernel's own)."""
    import torch
    from veles_tpu_torch.ops import flash_attention as FA
    forward = forward or FA.flash_attention_reference

    class PlainChunk(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, q_off, k_off, od):
            out, lse = forward(q, k, v, causal, q_off, k_off, None, od)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = (causal, q_off, k_off, None, od)
            return out, lse

        @staticmethod
        def backward(ctx, dout, dlse):
            q, k, v, out, lse = ctx.saved_tensors
            delta = (dout.float() * out.float()).sum(dim=-1) - dlse.float()
            dout = dout.to(q.dtype)
            dq = FA.flash_attention_dq_reference(q, k, v, dout, lse, delta,
                                                 *ctx.args)
            dk, dv = FA.flash_attention_dkv_reference(q, k, v, dout, lse,
                                                      delta, *ctx.args)
            return dq, dk, dv, None, None, None, None

    def step(carry, q, k, v, causal, q_off, k_off, od):
        o, lse = PlainChunk.apply(q, k, v, causal, q_off, k_off, od)
        if carry is None:
            return o.float(), lse
        return FA.merge_partials(carry[0], carry[1], o, lse)
    return step


def no_lse_cotangent_step(carry, q, k, v, causal, q_off, k_off, od):
    """``ring_step`` with the merge's lse cotangent dropped: the ring
    check's control, a fault its gate must see."""
    from veles_tpu_torch.ops import flash_attention as FA
    o, lse = FA.flash_chunk(q, k, v, causal=causal, q_offset=q_off,
                            k_offset=k_off, operand_dtype=od)
    if carry is None:
        return o.float(), lse.detach()
    return FA.merge_partials(carry[0], carry[1], o, lse.detach())


def ring_check(N, label, gen, smi):
    """The ring's chunk loop at N virtual ranks in one process: rank r
    holds the r-th S/N shard of q, k, v (the training shape, causal,
    the ``label`` dtype pair) and at step s folds the k/v shard of rank
    (r − s) mod N through ``ops.attention.ring_step`` at offsets r·S/N
    and src·S/N.  The merged out and the q/k/v gradients are compared
    with the same loop through the plain chunk, through the plain
    backward on the kernels' forward, the whole-sequence B1-B3 and the
    plain attention (see ``RING_DTYPES`` for which are gated), and each
    chain's relative L2 error against the float32 plain attention is
    read and gated against the plain chunks'.  Returns the numbers (the
    offsets the launches ran at included)."""
    import torch
    from veles_tpu_torch.ops import attention as A
    from veles_tpu_torch.ops import flash_attention as FA
    B, S, H, D = TRAIN_BATCH, POSITIONS, HEADS, EMBED // HEADS
    storage, od = (getattr(torch, {"f32": "float32", "bf16": "bfloat16"}[x])
                   for x in label.split("/"))
    q, k, v, do, _ = flash_inputs(B, S, S, H, D, storage, gen)
    Sn = S // N
    offsets = []
    launch = FA._launch

    def recording_launch(fn, name, *args):
        launch(fn, name, *args)
        offsets.append((name, int(args[-3]), int(args[-2])))

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q, k, v)]
        out = fn(*leaves)
        (out.float() * do.float()).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    def ring(step_fn):
        def run(qq, kk, vv):
            outs = []
            for r in range(N):
                carry = None
                for step in range(N):
                    src = (r - step) % N
                    carry = step_fn(
                        carry, qq[:, r * Sn:(r + 1) * Sn],
                        kk[:, src * Sn:(src + 1) * Sn],
                        vv[:, src * Sn:(src + 1) * Sn], True, r * Sn,
                        src * Sn, od)
                outs.append(carry[0].to(qq.dtype))
            return torch.cat(outs, dim=1)
        return run

    FA.reset_launches()
    FA._launch = recording_launch
    try:
        t0 = time.monotonic()
        got = grads(ring(A.ring_step))
        torch.cuda.synchronize()
        ring_s = time.monotonic() - t0
    finally:
        FA._launch = launch
    launches = flash_counts()
    routes = {n: dict(getattr(FA, n).route_launches) for n in launches}
    chains = {
        "plain_chunks": grads(ring(plain_chunk())),
        "kernel_fwd": grads(ring(plain_chunk(FA.flash_forward))),
        "whole_b1_b3": grads(lambda a, b, c: FA.flash_attention(
            a, b, c, causal=True, operand_dtype=od)),
        "plain": grads(lambda a, b, c: A.attention(
            a, b, c, causal=True, precision="f32", kernel="xla"))}
    control = grads(ring(no_lse_cotangent_step))
    abs_v_out = FA.flash_attention_reference(
        q, k, v.abs(), causal=True, operand_dtype=od)[0].float()
    names = ("out", "dq", "dk", "dv")

    def share(g, w, name):
        rtol, atol = flash_tolerance(label, name, w.float(), abs_v_out)
        err = (g.float() - w.float()).abs()
        return (err / (atol + rtol * w.float().abs())).max().item()

    shares = {"%s %s" % (which, name): share(g, w, name)
              for which, want in chains.items()
              for name, g, w in zip(names, got, want)}
    control_shares = {name: share(g, w, name) for name, g, w in zip(
        names, control, chains["kernel_fwd"])}
    rel_l2 = {which: {name: ((g.float() - w.float()).norm() /
                             w.float().norm()).item()
                      for name, g, w in zip(names, grad_set,
                                            chains["plain"])}
              for which, grad_set in (("ring", got),
                                      ("plain_chunks",
                                       chains["plain_chunks"]),
                                      ("whole_b1_b3",
                                       chains["whole_b1_b3"]),
                                      ("control", control))}
    gated = [k for k in shares if label == "f32/f32" or
             label == "f32/bf16" and (k.startswith("kernel_fwd ") or
                                      k.endswith(" out") and
                                      not k.startswith("plain "))]

    def l2_over(which):
        return [n for n in names if rel_l2[which][n] > RING_L2_LIMIT *
                rel_l2["plain_chunks"][n] + RING_L2_FLOOR]
    fwd = sorted({(qo, ko) for n, qo, ko in offsets
                  if n == "flash attention forward"})
    nonzero = [o for o in fwd if o != (0, 0)]
    want_fwd = sorted({(r * Sn, ((r - s) % N) * Sn)
                       for r in range(N) for s in range(N)})
    tol_text = "rtol = atol = 1e-5" if label == "f32/f32" else \
        BF16_TOL_TEXT
    numbers = {"N": N, "dtypes": label, "launches": launches,
               "routes": routes, "forward_offsets": fwd,
               "largest_share_of_tol": shares, "gated": gated,
               "control_no_lse_cotangent": control_shares,
               "rel_l2_vs_f32_plain": rel_l2,
               "rel_l2_limit": [RING_L2_LIMIT, RING_L2_FLOOR],
               "tol": tol_text, "ring_s": ring_s}
    print("8p ring N=%d at B=%d S=%d H=%d D=%d %s causal on %s: launches "
          "%s by route %s; B1 ran at %d (q_offset, k_offset) pairs, %d "
          "nonzero; largest error / tolerance (%s) %s, gated: %s; the "
          "control with the lse cotangent dropped against kernel_fwd %s; "
          "relative L2 error against the f32 plain attention %s (the "
          "ring's gated at %g x the plain chunks' + %g); the loop with its backward %.3f s" % (
              N, B, S, H, D, label, smi, launches, routes, len(fwd),
              len(nonzero), tol_text, {k: round(v, 4) for k, v in
                                       shares.items()}, gated,
              {k: round(v, 4) for k, v in control_shares.items()},
              {w: {k: float("%.4g" % v) for k, v in r.items()}
               for w, r in rel_l2.items()}, RING_L2_LIMIT, RING_L2_FLOOR,
              ring_s))
    implied = {"flash_forward": N * N, "flash_dq": N * N,
               "flash_dkv": N * N}
    if launches != implied or fwd != want_fwd or not nonzero:
        fail("8p ring N=%d: launches %s at offsets %s; the loop implies "
             "%s at %s" % (N, launches, fwd, implied, want_fwd))
    if any(shares[k] > 1.0 for k in gated) or l2_over("ring"):
        fail("8p ring N=%d %s disagrees: %s; relative L2 %s" % (
            N, label, shares, rel_l2))
    gated_control = [n for n in names if "kernel_fwd " + n in gated]
    if not l2_over("control") or gated_control and max(
            control_shares[n] for n in gated_control) <= 1.0:
        fail("8p ring N=%d %s: the gates do not see a dropped lse "
             "cotangent (%s; relative L2 %s)" % (
                 N, label, control_shares, rel_l2["control"]))
    return numbers


def phase_parallel(workdir, smi):
    """Phase 8p: A6a on the card — a one-rank NCCL world joined through
    the port's launcher with the ``--jax-*`` flags, then (a) the MoE
    TinyLM under dp×ep, (b) the pipelined TinyLM under dp×pp (1F1B)
    held to its sequential stack, exported, unstacked and served on B4
    token-identical to the sequential model's export, (c) the ring's
    chunk loop at N = 2 and 4 virtual ranks, (d) MNIST through the
    command line in the world.  Returns (B1-B3 launches of the (a)/(b)
    main paths, B4 launches of the served wave, numbers)."""
    import socket
    import numpy
    import torch
    import torch.distributed as dist
    import veles_tpu_torch.parallel as par
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.config import root
    from veles_tpu_torch.export import ExportedModel, export_workflow
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.ops import decode_attention as DA
    from veles_tpu_torch.ops import flash_attention as FA
    started = time.monotonic()
    engine = root.common.engine
    engine.remat = True
    engine.precision_level = 0
    engine.attention_dtype = "f32"
    engine.attention_kernel = "auto"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    flags = ["--jax-coordinator", "127.0.0.1:%d" % port,
             "--jax-num-processes", "1", "--jax-process-id", "0"]
    main = Main(["wf.py"] + flags)
    main.parse()
    kw = main._launcher_kwargs()
    numbers = {"flags": flags}
    main_path = dict.fromkeys(("flash_forward", "flash_dq", "flash_dkv"),
                              0)
    try:
        # (a) the MoE TinyLM, ep over the world.
        t0 = time.monotonic()
        launcher = Launcher(**kw)
        wf = par_tinylm(launcher, 44, n_experts=PAR_EXPERTS,
                        top_k=PAR_TOPK, expert_axis="expert")
        launcher.initialize(device="cuda")
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail("8p: the launcher joined a %s world of %d" % (
                dist.get_backend(), dist.get_world_size()))
        par.apply_dp_ep_sharding(wf, par.make_mesh(
            None, {"data": 1, "expert": 1}))
        blk = wf.forwards[1]
        if blk.params["w1"].placement != ("expert", None, None):
            fail("8p: the experts are placed %s" %
                 (blk.params["w1"].placement,))
        init_s = time.monotonic() - t0
        rec = TickRecorder(wf.compiler)
        torch.cuda.synchronize()
        FA.reset_launches()
        launcher.run()
        torch.cuda.synchronize()
        moe_launches = flash_counts()
        classes = [t[0] for t in rec.ticks]
        losses = [t[1] for t in rec.ticks]
        expected = {"flash_forward": PAR_BLOCKS * (1 + 2 * PAR_TICKS),
                    "flash_dq": PAR_BLOCKS * PAR_TICKS,
                    "flash_dkv": PAR_BLOCKS * PAR_TICKS}
        engine.attention_kernel = "xla"
        plain, _ = rec.replay()
        engine.attention_kernel = "auto"
        rec.close()
        # The decision folds (and clears) the router rows at each
        # class's epoch end.
        loads = wf.decision.epoch_moe[1:]
        print("8p (a) MoE TinyLM %d blocks, top-%d of %d experts, dp×ep "
              "%s on %s: init %.1f s; ticks %s %s s; losses %s, plain "
              "attention from the same state %s; B1-B3 launches %s "
              "(expected %s); router health per class %s" % (
                  PAR_BLOCKS, PAR_TOPK, PAR_EXPERTS, wf.mesh.shape, smi,
                  init_s, classes, ["%.3f" % t[2] for t in rec.ticks],
                  ["%.5f" % x for x in losses],
                  ["%.5f" % x for x in plain], moe_launches, expected,
                  loads))
        if classes != [False] + [True] * PAR_TICKS or \
                moe_launches != expected:
            fail("8p (a): ticks %s launched %s; the epoch implies %s" % (
                classes, moe_launches, expected))
        if not all(numpy.isfinite(losses)) or any(
                abs(a - b) > TRAIN_LOSS_RTOL * abs(b)
                for a, b in zip(losses, plain)):
            fail("8p (a): losses %s against the plain attention's %s "
                 "(rtol %g)" % (losses, plain, TRAIN_LOSS_RTOL))
        for name in main_path:
            main_path[name] += moe_launches[name]
        numbers["moe"] = {"losses": losses, "plain_losses": plain,
                          "launches": moe_launches,
                          "tick_s": [t[2] for t in rec.ticks],
                          "init_s": init_s}
        del wf, launcher, rec, blk
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the pipelined TinyLM, 1F1B over the stage axis.
        t0 = time.monotonic()
        launcher = Launcher(**kw)
        wf = par_tinylm(launcher, 45, pipelined=True, stage_axis="stage",
                        n_microbatches=PAR_MICRO, schedule="1f1b")
        launcher.initialize(device="cuda")
        par.apply_dp_pp_sharding(wf, par.make_mesh(
            None, {"data": 1, "stage": 1}))
        stack = wf.forwards[1]
        if stack.params["wq"].placement[0] != "stage":
            fail("8p: the stack is placed %s" %
                 (stack.params["wq"].placement,))
        rec = TickRecorder(wf.compiler)
        torch.cuda.synchronize()
        FA.reset_launches()
        launcher.run()
        torch.cuda.synchronize()
        pp_launches = flash_counts()
        classes = [t[0] for t in rec.ticks]
        losses = [t[1] for t in rec.ticks]
        afters = [t[3] for t in rec.ticks[2:]] + [rec.state()]
        befores = [t[3] for t in rec.ticks[1:]]
        # Every active schedule step runs the 2 local blocks on one
        # microbatch: forward once, and again in the backward.
        per = PAR_BLOCKS * PAR_MICRO
        expected = {"flash_forward": per * (1 + 2 * PAR_TICKS),
                    "flash_dq": per * PAR_TICKS,
                    "flash_dkv": per * PAR_TICKS}
        stack.stage_axis = None
        seq_losses, seq_afters = rec.replay()
        stack.stage_axis = "stage"
        rec.close()
        gaps = param_gaps([{n: a[n] for n in wf.compiler._param_vecs}
                           for a in afters], seq_afters, befores)
        print("8p (b) pipelined TinyLM, %d stacked blocks, 1F1B over %d "
              "microbatches, dp×pp %s: ticks %s %s s; losses %s, the "
              "sequential stack from the same state %s; B1-B3 launches %s "
              "(expected %s); the largest parameter gap / phase 5's bound "
              "%.3f (%s)" % (
                  PAR_BLOCKS, PAR_MICRO, wf.mesh.shape, classes,
                  ["%.3f" % t[2] for t in rec.ticks],
                  ["%.5f" % x for x in losses],
                  ["%.5f" % x for x in seq_losses], pp_launches, expected,
                  max(gaps.values()), max(gaps, key=gaps.get)))
        if classes != [False] + [True] * PAR_TICKS or \
                pp_launches != expected:
            fail("8p (b): ticks %s launched %s; the schedule implies %s"
                 % (classes, pp_launches, expected))
        if not all(numpy.isfinite(losses)) or any(
                abs(a - b) > TRAIN_LOSS_RTOL * abs(b)
                for a, b in zip(losses, seq_losses)) or \
                max(gaps.values()) > 1.0:
            fail("8p (b): the pipelined ticks leave the sequential stack's"
                 ": losses %s vs %s, gaps %s" % (losses, seq_losses, gaps))
        for name in main_path:
            main_path[name] += pp_launches[name]
        # The export unstacks the stack; the same weights as a sequential
        # TinyLM export the same blocks.
        pp_path = os.path.join(workdir, "pipelined.veles.tgz")
        seq_path = os.path.join(workdir, "sequential.veles.tgz")
        t1 = time.monotonic()
        export_workflow(wf, pp_path, compresslevel=0)
        export_s = time.monotonic() - t1
        seq_wf = par_tinylm(Launcher(), 46)
        seq_wf.workflow.initialize(device="cpu")
        src = {u.name: u for u in wf.forwards}
        for u in seq_wf.forwards:
            if u.name.startswith("block"):
                i = int(u.name[len("block"):])
                for n, vec in u.trainables.items():
                    stack.params[n].map_read()
                    vec.mem = stack.params[n].mem[i].copy()
            else:
                for n, vec in u.trainables.items():
                    src[u.name].trainables[n].map_read()
                    vec.mem = src[u.name].trainables[n].mem.copy()
        export_workflow(seq_wf, seq_path, compresslevel=0)
        del seq_wf
        pp_model = ExportedModel(pp_path, device="cuda")
        seq_model = ExportedModel(seq_path, device="cuda")
        kinds = [e["type"] for e in pp_model.units]
        if kinds != ["embedding"] + ["transformer_block"] * PAR_BLOCKS + \
                ["lm_head"] or not pp_model.is_lm:
            fail("8p (b): the pipelined export holds %s" % kinds)
        rng = numpy.random.RandomState(SEED % (1 << 31) + 8)
        prompts = [rng.randint(0, VOCAB, n).tolist()
                   for n in PROMPT_LENGTHS]
        answers, b4 = {}, {}
        for label, model in (("pipelined", pp_model),
                             ("sequential", seq_model)):
            log = CallLog(model)
            try:
                got, served = serve_wave(model, prompts, [], log=log)
            finally:
                log.restore()
            served["server"].stop()
            check_launches("8p (b) %s export" % label, served, log, True,
                           False, blocks=PAR_BLOCKS)
            answers[label], b4[label] = got, served["b4"]
        same = sum(a == b for a, b in zip(answers["pipelined"],
                                          answers["sequential"]))
        print("8p (b) export %.1f s (gzip level 0): units %s; a wave of %d "
              "prompts through the paged engine: %d/%d answers token-"
              "identical to the sequential model's export; B4 launches "
              "%s" % (export_s, kinds, len(prompts), same, len(prompts),
                      b4))
        if same != len(prompts):
            fail("8p (b): the unstacked export answers differently from "
                 "the sequential one")
        numbers["pipelined"] = {
            "losses": losses, "sequential_losses": seq_losses,
            "launches": pp_launches, "largest_gap_share": max(
                gaps.values()), "tick_s": [t[2] for t in rec.ticks],
            "export_s": export_s, "b4_launches": b4,
            "answers_identical": same}
        del wf, launcher, rec, stack, pp_model, seq_model
        os.remove(pp_path)
        os.remove(seq_path)
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the ring's chunk loop at N virtual ranks.
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        numbers["ring"] = [ring_check(n, label, gen, smi)
                           for label in RING_DTYPES for n in RING_NS]
        numbers["ring"].append(ring_check(RING_NS[-1], MAIN_DTYPES, gen,
                                          smi))

        # (d) MNIST through the command line in the world.
        datasets = os.path.join(workdir, "datasets")
        write_mnist_idx(datasets)
        result = os.path.join(workdir, "mnist-world.json")
        t1 = time.monotonic()
        cli = run_cli([os.path.join(HERE, "veles_tpu_torch", "znicz",
                                    "samples", "mnist.py"),
                       "-v", "warning", "--random-seed", "5",
                       "--result-file", result,
                       "root.common.dirs.datasets=%r" % datasets,
                       "root.mnist.max_epochs=2"] + flags)
        cli_s = time.monotonic() - t1
        with open(result) as fin:
            res = json.load(fin)
        mesh = cli.workflow.mesh
        print("8p (d) MNIST through the command line with %s: mode %s, "
              "mesh %s, %.1f s; results %s" % (
                  " ".join(flags), res["mode"], mesh.shape if mesh else
                  None, cli_s, res["results"]))
        if res["mode"] != "distributed" or mesh is None or \
                res["results"].get("epochs") != 2 or not numpy.isfinite(
                    res["results"].get("min_validation_err", numpy.nan)):
            fail("8p (d): the command line's distributed run gave %s" %
                 res)
        numbers["mnist_cli"] = {"seconds": cli_s,
                                "results": res["results"]}
        clean_cli_config()
        del cli
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    numbers["phase_s"] = time.monotonic() - started
    print("8p readings on %s: the phase %.1f s" % (smi,
                                                   numbers["phase_s"]))
    return main_path, numbers["pipelined"]["b4_launches"]["pipelined"], \
        numbers


#: Phase 9n, the data plane: the full-width AlexNet at NET_BATCH a
#: minibatch, one validation minibatch, then NET_JOBS train jobs of
#: NET_TICKS ticks each (fp32 deltas), then one train job with bf16
#: deltas.
NET_BATCH, NET_JOBS, NET_TICKS = 128, 2, 2
#: Ticks timed for the deterministic-algorithms reading, each way.
NET_DET_TICKS = 6
#: The traced fp32 session: the worker's capture window (dispatches),
#: and the in-process ticks of each attribution on/off p50 reading.
NET_XPROF_STEPS, NET_ATTR_TICKS = 2, 7


def net_alexnet(launcher, n_train):
    """The phase's AlexNet, seeded alike in every process."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.samples.imagenet import AlexNetWorkflow
    prng.reset()
    prng.get(0).seed(42)
    return AlexNetWorkflow(
        launcher, minibatch_size=NET_BATCH, max_epochs=1,
        loader_config={"sim_train": n_train, "sim_valid": NET_BATCH,
                       "sim_image_size": 227, "sim_classes": 1000,
                       "validate_labels": False})


def net_config(dtype):
    from veles_tpu_torch.config import root
    engine, net = root.common.engine, root.common.net
    engine.precision_level = 0
    engine.pallas_lrn = True
    net.job_ticks = NET_TICKS
    net.dtype = dtype
    net.codec = "none"


def net_worker(sessions, out):
    """The worker process of phase 9n: for each (train images, wire
    dtype) it takes from ``sessions`` (until None) it builds the phase's
    AlexNet on the card — while the master builds its own — then takes
    the master's address, joins it with ``Launcher(master_address=...)``
    and runs its client; writes each session's B6/B7 launches and jobs
    to ``out``."""
    sys.path.insert(0, HERE)
    import torch
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.ops import lrn as L
    torch.set_num_threads(4)
    from veles_tpu_torch.observability import attribution
    report = []
    while True:
        item = sessions.get(timeout=300)
        if item is None:
            break
        n_train, dtype, xprof = item
        net_config(dtype)
        attribution.reset()
        if xprof:
            attribution.configure_xprof(xprof, NET_XPROF_STEPS)
        launcher = Launcher(master_address="127.0.0.1:0",
                            slave_kwargs={"reconnect_attempts": 3})
        wf = net_alexnet(launcher, n_train)
        launcher.initialize(device="cuda")
        # The master's port is known once it listens.
        launcher.client.address = sessions.get(timeout=300)
        L.reset_launches()
        t0 = time.monotonic()
        launcher.run()
        torch.cuda.synchronize()
        report.append({"lrn_forward": L.lrn_forward.launches,
                       "lrn_backward": L.lrn_backward.launches,
                       "jobs": launcher.client.jobs_done,
                       "seconds": time.monotonic() - t0,
                       "perf": attribution.perf_summary(wait=True),
                       "peak_flops": attribution.peak_flops(
                           torch.device("cuda")),
                       "xprof": attribution.xprof_trace()})
        del wf, launcher
    with open(out, "w") as fout:
        json.dump(report, fout)


def net_params(wf):
    import numpy
    out = {}
    for u in wf.units:
        for a, v in (getattr(u, "trainables", None) or {}).items():
            v.map_read()
            out["%s/%s" % (u.name, a)] = numpy.array(v.mem)
    return out


def net_session(sessions, n_train, dtype, train_jobs=None, xprof=None):
    """One master session of phase 9n in this process: the master's
    AlexNet on the card behind ``Launcher(listen_address=...)``, the
    worker process told its address; with ``train_jobs`` the master's
    decision completes once that many train jobs are folded.  With
    ``xprof`` (a directory) the session is traced: the master traces
    (the worker's hello asks for ``trace`` and is granted it) and the
    worker opens a capture window of NET_XPROF_STEPS dispatches into
    the directory.  Returns (master parameters after the run, wire
    bytes both ways, seconds, the spans the master collected)."""
    from veles_tpu_torch import resilience
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.observability import tracing
    sessions.put((n_train, dtype, xprof))
    net_config(dtype)
    tracing.reset()
    if xprof:
        tracing.enable()
    launcher = Launcher(listen_address="127.0.0.1:0")
    wf = net_alexnet(launcher, n_train)
    launcher.initialize(device="cuda")
    if train_jobs is not None:
        apply = wf.apply_data_from_slave
        folded = []

        def apply_and_count(data, slave=None):
            train = (data or {}).get("__job__", {}).get(
                "minibatch_class") == TRAIN
            apply(data, slave)
            folded.append(train)
            if sum(folded) >= train_jobs:
                wf.decision.complete <<= True

        wf.apply_data_from_slave = apply_and_count
    resilience.stats.reset()
    t0 = time.monotonic()
    sessions.put("127.0.0.1:%d" % launcher.server.port)
    launcher.run()
    seconds = time.monotonic() - t0
    spans = tracing.spans()
    tracing.reset()
    snap = resilience.stats.snapshot()
    wire = snap.get("net.bytes_sent", 0) + snap.get("net.bytes_recv", 0)
    if not wf.decision.complete:
        fail("9n: the %s session ended before its decision completed"
             % dtype)
    params = net_params(wf)
    del wf, launcher
    return params, wire, seconds, spans


def net_reference(n_train):
    """The in-process run of the same ticks from the same seed: the
    parameters after every tick, then the deterministic-algorithms
    reading (NET_DET_TICKS train ticks timed with
    ``torch.use_deterministic_algorithms`` off, then on with
    ``warn_only``)."""
    import warnings
    import torch
    from veles_tpu_torch.launcher import Launcher
    net_config("fp32")
    launcher = Launcher()
    wf = net_alexnet(launcher, n_train)
    launcher.initialize(device="cuda")
    compiler = wf.compiler
    execute = compiler.execute
    after = []

    def recorded(training=True):
        metrics = execute(training=training)
        after.append((training, net_params(wf)))
        return metrics

    compiler.execute = recorded
    launcher.run()
    compiler.execute = execute

    def timed():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(NET_DET_TICKS):
            execute(training=True)
        torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3 / NET_DET_TICKS

    timed()  # warm
    det = {"off_ms": timed()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det["on_ms"] = timed()
        finally:
            torch.use_deterministic_algorithms(False)
    det["warnings"] = sorted({str(w.message).split(".")[0][:160]
                              for w in caught})
    det["attribution_p50_ms"] = attribution_p50(execute)
    del wf, launcher
    return after, det


def attribution_p50(execute):
    """The train tick's p50 (host clock around a synchronized tick,
    NET_ATTR_TICKS ticks a reading) with attribution off, on, on, off,
    in turns."""
    import torch
    from veles_tpu_torch.config import root
    out = {"off": [], "on": []}
    try:
        for flag in (False, True, True, False):
            root.common.observability.attribution = flag
            times = []
            for _ in range(NET_ATTR_TICKS):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                execute(training=True)
                torch.cuda.synchronize()
                times.append((time.monotonic() - t0) * 1e3)
            out["on" if flag else "off"].append(
                sorted(times)[len(times) // 2])
    finally:
        del root.common.observability.__dict__["attribution"]
    return out


def trace_nesting(spans):
    """The worker.step spans (ingested on a worker track) that do not
    lie strictly inside the master's server.dispatch span they name as
    parent, with the same trace id: a list of their ids."""
    own = {s["id"]: s for s in spans if not s.get("proc")}
    bad = []
    for step in spans:
        if step["name"] != "worker.step" or not step.get("proc"):
            continue
        d = own.get(step["parent"])
        if d is None or d["name"] != "server.dispatch" or \
                d["trace_id"] != step["trace_id"] or \
                not d["ts"] < step["ts"] or \
                not step["ts"] + step["dur"] < d["ts"] + d["dur"]:
            bad.append(step["id"])
    return bad


def net_traced(spans, report, workdir, smi):
    """Phase 9n's traced-session gates: the Chrome trace holds the
    master's and the worker's tracks; every worker.step (after the
    worker's clock sync) lies strictly inside its server.dispatch with
    the same trace id — a planted shift of one step past its window
    must fail that gate; the worker's perf summary has step_ms > 0 and
    mfu in (0, 1]; its capture window's profiler trace names
    lrn_fwd_reg and lrn_bwd_reg."""
    from veles_tpu_torch.observability import tracing
    path = os.path.join(workdir, "trace.json")
    events = tracing.export_chrome_trace(path, spans)["traceEvents"]
    tracks = sorted(e["args"]["name"] for e in events if e["ph"] == "M")
    steps = [s for s in spans if s["name"] == "worker.step"]
    bad = trace_nesting(spans)
    planted = [dict(s) for s in spans]
    victim = next(s for s in planted if s["name"] == "worker.step")
    victim["ts"] += max(s["dur"] for s in spans
                        if s["name"] == "server.dispatch")
    caught = trace_nesting(planted)
    perf = report.get("perf") or {}
    with open(report["xprof"]) as fin:
        profile = fin.read()
    kernels = {k: profile.count(k) for k in ("lrn_fwd_reg", "lrn_bwd_reg")}
    peak = report.get("peak_flops")
    print("9n traced: tracks %s; %d worker.step spans, %d outside their "
          "server.dispatch (a planted shift: %d caught); worker perf %s "
          "(step_ms: the dispatch's stream span, host waits included; "
          "mfu over that span, a lower bound) against %s TFLOP/s dense "
          "bf16 (%s); the capture window's "
          "trace names %s" % (
              tracks, len(steps), len(bad), len(caught), perf,
              peak / 1e12 if peak else None, smi, kernels))
    if not any(t.startswith("master/") for t in tracks) or \
            not any(t.startswith("worker:") for t in tracks):
        fail("9n: the trace lacks the master's or the worker's track: %s"
             % tracks)
    if not steps or bad:
        fail("9n: worker.step spans outside their dispatch: %s of %d" %
             (bad, len(steps)))
    if not caught:
        fail("9n: the planted span shift passed the nesting gate")
    if not perf.get("step_ms", 0) > 0 or \
            not 0 < perf.get("mfu", 0) <= 1:
        fail("9n: the worker's perf summary %s" % perf)
    if not all(kernels.values()):
        fail("9n: the capture window's trace names %s" % kernels)
    return {"tracks": tracks, "worker_steps": len(steps),
            "planted_caught": len(caught), "perf": perf,
            "peak_tflops": peak / 1e12 if peak else None,
            "xprof_kernel_events": kernels}


def phase_net(workdir, smi):
    """Phase 9n, the data plane on the card: a master
    ``Launcher(listen_address="127.0.0.1:0")`` holding the full-width
    AlexNet, one worker process on the same card
    (``Launcher(master_address=...)``, spawned), NET_JOBS train jobs of
    ``--job-ticks`` NET_TICKS with fp32 deltas (codec none).  Gates: the
    master's parameters after the jobs equal an in-process run of the
    same ticks from the same seed bit for bit; the worker launched B6
    twice and B7 twice per train tick (B6 twice per validation tick).
    Then one train job with bf16 deltas, held to the in-process
    parameters after that job's ticks within the bf16 codec's rounding:
    |got - want| <= 2^-8 |want - start| + 2^-22 max(|want|, |start|)
    per element.  Prints the wire bytes per minibatch of both, and the
    deterministic-algorithms reading."""
    import numpy
    import torch
    import torch.multiprocessing as mp
    started = time.monotonic()
    n_train = NET_BATCH * NET_TICKS * NET_JOBS
    ctx = mp.get_context("spawn")
    sessions = ctx.Queue()
    out = os.path.join(workdir, "net_worker.json")
    worker = ctx.Process(target=net_worker, args=(sessions, out))
    worker.start()
    try:
        got, wire32, s32, spans = net_session(
            sessions, n_train, "fp32",
            xprof=os.path.join(workdir, "xprof"))
        got16, wire16, s16, _ = net_session(sessions, n_train, "bf16",
                                            train_jobs=1)
        sessions.put(None)
        worker.join(300)
    finally:
        if worker.is_alive():
            worker.kill()
            worker.join()
    if worker.exitcode:
        fail("9n: the worker process exited %s" % worker.exitcode)
    with open(out) as fin:
        report = json.load(fin)
    traced = net_traced(spans, report[0], workdir, smi)
    after, det = net_reference(n_train)
    torch.cuda.empty_cache()
    want = after[-1][1]
    equal = {n: bool(numpy.array_equal(got[n], want[n])) for n in want}
    print("9n fp32: %d jobs of %d ticks; master parameters == in-process "
          "ticks bit for bit: %d/%d tensors" % (
              report[0]["jobs"], NET_TICKS, sum(equal.values()),
              len(equal)))
    if not all(equal.values()):
        worst = {n: float(numpy.abs(got[n] - want[n]).max())
                 for n, ok in equal.items() if not ok}
        fail("9n: the master's parameters after the fp32 jobs differ from "
             "the in-process ticks: %s" % worst)
    classes = [t for t, _ in after]
    train = sum(classes)
    valid = len(classes) - train
    expect = {"lrn_forward": 2 * (train + valid), "lrn_backward": 2 * train}
    launches = {k: report[0][k] for k in expect}
    print("9n: worker LRN launches %s for %d train + %d validation ticks "
          "(expected %s)" % (launches, train, valid, expect))
    if launches != expect:
        fail("9n: the worker launched the LRN kernels %s times, the ticks "
             "imply %s" % (launches, expect))
    # The bf16 session: one validation job, then one train job, whose
    # in-process counterpart is after[NET_TICKS] (its last tick).
    start, want16 = after[0][1], after[NET_TICKS][1]
    share = 0.0
    for n in want16:
        a, b = want16[n], start[n]
        bound = 2.0 ** -8 * numpy.abs(a - b) + 2.0 ** -22 * numpy.maximum(
            numpy.abs(a), numpy.abs(b))
        gap = numpy.abs(got16[n] - a)
        share = max(share, float((gap / numpy.maximum(bound, 1e-30)).max()))
    print("9n bf16: one train job, largest error / bf16 rounding bound "
          "%.4f" % share)
    if share > 1.0:
        fail("9n: the bf16 job leaves its rounding bound (%.4f)" % share)
    if {k: report[1][k] for k in expect} != {
            "lrn_forward": 2 * (NET_TICKS + 1),
            "lrn_backward": 2 * NET_TICKS}:
        fail("9n: the bf16 worker's LRN launches %s" % report[1])
    per32 = wire32 / float(len(classes))
    per16 = wire16 / float(NET_TICKS + 1)
    print("9n on %s: wire bytes per minibatch fp32 %.0f (%d B, %.1f s), "
          "bf16 %.0f (%d B, %.1f s); deterministic algorithms off %.2f ms "
          "/ on %.2f ms a train tick (%d warnings: %s); the train tick's "
          "p50 with attribution off %s ms, on %s ms (in turns off, on, "
          "on, off); phase %.1f s" % (
              smi, per32, wire32, s32, per16, wire16, s16, det["off_ms"],
              det["on_ms"], len(det["warnings"]), det["warnings"],
              det["attribution_p50_ms"]["off"],
              det["attribution_p50_ms"]["on"],
              time.monotonic() - started))
    numbers = {"jobs": report[0]["jobs"], "job_ticks": NET_TICKS,
               "batch": NET_BATCH, "fp32_equal_tensors": len(equal),
               "bf16_share_of_bound": share,
               "wire_bytes_per_minibatch": {"fp32": per32, "bf16": per16},
               "wire_bytes": {"fp32": wire32, "bf16": wire16},
               "session_s": {"fp32": s32, "bf16": s16},
               "worker": report, "deterministic_algorithms": det,
               "traced": traced, "phase_s": time.monotonic() - started}
    total = {k: report[0][k] + report[1][k] for k in expect}
    return total, numbers


#: Phase 9f (a): the MNIST fleet — two worker processes spawned by the
#: launcher, FLEET_MNIST_EPOCHS epochs over FLEET_MNIST_TRAIN +
#: FLEET_MNIST_VALID images (half of phase 6b's set since PR 20: 18 jobs
#: an epoch), one worker SIGKILLed with a job in hand once the server
#: generated FLEET_KILL_AFTER jobs.
FLEET_MNIST_EPOCHS, FLEET_KILL_AFTER = 2, 5
FLEET_MNIST_TRAIN, FLEET_MNIST_VALID = 1500, 300
#: Phase 9f (b): PBT over the full-width AlexNet, FLEET_P members at
#: NET_BATCH a minibatch, FLEET_EPOCHS epochs of one validation job and
#: one train job of FLEET_TICKS ticks each, the learning rate tuned;
#: FLEET_SEED is a seed at which an exploit fires.
FLEET_P, FLEET_TICKS, FLEET_EPOCHS, FLEET_SEED = 2, 2, 2, 42
FLEET_LR = "Tune(0.01, 0.001, 0.05)"
#: Seconds each part of phase 9f may take before it is stopped.
FLEET_DEADLINE = 300


def process_ports(pid):
    """The local TCP ports of process ``pid``'s sockets (read from
    ``/proc``): which of the server's sessions is a given worker."""
    inodes = set()
    for fd in os.listdir("/proc/%d/fd" % pid):
        try:
            link = os.readlink("/proc/%d/fd/%s" % (pid, fd))
        except OSError:
            continue
        if link.startswith("socket:["):
            inodes.add(link[8:-1])
    ports = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        with open(table) as fin:
            for row in fin.read().splitlines()[1:]:
                fields = row.split()
                if len(fields) > 9 and fields[9] in inodes:
                    ports.add(int(fields[1].rsplit(":", 1)[1], 16))
    return ports


def fleet_mnist(workdir, smi, device="cuda"):
    """Phase 9f (a): ``Launcher(listen_address="127.0.0.1:0",
    nodes=["local", "local"], worker_argv=[the MNIST sample, ...])``
    holds MNIST on the card and spawns two worker processes of the
    command line on the same card.  Once the server generated
    FLEET_KILL_AFTER jobs, the first worker process is SIGKILLed just
    after it was handed a job, and the master hands out no more work
    until the respawned worker joined.  Gates: exactly one
    ``server.drop``, one requeue and one ``server.respawn``; the
    respawned worker joins and trains; the run completes with no
    minibatch lost (nothing requeued or in flight at the end); the
    killed process exits by SIGKILL and every other with 0.  Prints
    the membership epochs in order."""
    import signal
    from veles_tpu_torch import prng, resilience
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    datasets = os.path.join(workdir, "fleet")
    write_mnist_idx(datasets, n_train=FLEET_MNIST_TRAIN,
                    n_valid=FLEET_MNIST_VALID)
    argv = [os.path.join(HERE, "veles_tpu_torch", "znicz", "samples",
                         "mnist.py"),
            "root.common.dirs.datasets=%r" % datasets,
            "root.mnist.max_epochs=%d" % FLEET_MNIST_EPOCHS,
            "--device", device, "--random-seed", str(SEED),
            "-v", "warning", "--reconnect-attempts", "5"]
    root.common.dirs.datasets = datasets
    # The data plane's defaults (one-tick jobs, fp32 deltas), whatever
    # phase 9n left; put back at the end.
    net = root.common.net
    saved_net = dict(net.__dict__)
    for key in ("job_ticks", "dtype", "codec", "zero"):
        net.__dict__.pop(key, None)
    resilience.reset()
    launcher = Launcher(listen_address="127.0.0.1:0",
                        nodes=["local", "local"], worker_argv=argv)
    prng.reset()
    prng.get(0).seed(SEED)
    wf = MnistWorkflow(launcher, max_epochs=FLEET_MNIST_EPOCHS)
    generate = wf.generate_data_for_slave
    state = {"jobs": 0, "killed": None}

    def generate_and_kill(slave=None):
        # Called under the server's lock.
        server = launcher.server
        if state["killed"] is not None and server.fleet.joins < 3:
            return None  # the work waits for the respawned worker
        job = generate(slave)
        if job is None:
            return job
        state["jobs"] += 1
        if state["killed"] is None and \
                state["jobs"] >= FLEET_KILL_AFTER:
            proc = launcher.worker_processes[0][1]
            desc = server._slaves.get(slave)
            if desc is not None and \
                    desc.address[1] in process_ports(proc.pid):
                proc.send_signal(signal.SIGKILL)
                state["killed"] = slave
        return job

    wf.generate_data_for_slave = generate_and_kill
    launcher.initialize(device=device)
    timer = threading.Timer(FLEET_DEADLINE, launcher.stop)
    timer.start()
    t0 = time.monotonic()
    try:
        launcher.run()
    finally:
        timer.cancel()
        codes = launcher.reap_workers(timeout=30.0)
    seconds = time.monotonic() - t0
    stats = resilience.stats.snapshot()
    events = list(launcher.server.fleet.events)
    sessions = launcher.server.all_slaves
    respawned = [sid for _e, kind, sid in events if kind == "join"][2:]
    numbers = {"seconds": seconds, "jobs": state["jobs"],
               "killed_session": state["killed"],
               "exit_codes": codes,
               "drops": stats.get("server.drop", 0),
               "respawns": stats.get("server.respawn", 0),
               "requeues": stats.get("server.requeue", 0),
               "membership_epochs": [list(e) for e in events],
               "respawned_jobs": [sessions[sid].jobs_done
                                  for sid in respawned if sid in sessions],
               "epochs_trained": int(wf.decision.epoch_number),
               "failed_minibatches": len(wf.loader.failed_minibatches),
               "inflight": wf.total_inflight_jobs()}
    print("9f (a) on %s: membership epochs in order %s" % (
        smi, numbers["membership_epochs"]))
    print("9f (a) on %s: %d jobs generated, %d drop(s), %d requeue(s), "
          "%d respawn(s), the respawned worker's jobs %s, worker exit "
          "codes %s, %d epochs, %d minibatches left to retrain, %.1f s" % (
              smi, state["jobs"], numbers["drops"], numbers["requeues"],
              numbers["respawns"], numbers["respawned_jobs"], codes,
              numbers["epochs_trained"], numbers["failed_minibatches"],
              seconds))
    root.common.__dict__.pop("dirs", None)
    net.__dict__.clear()
    net.__dict__.update(saved_net)
    if not wf.decision.complete or \
            numbers["epochs_trained"] != FLEET_MNIST_EPOCHS:
        fail("9f (a): the fleet's run did not complete (%s)" % numbers)
    kinds = sorted(kind for _e, kind, _sid in events)
    if numbers["drops"] != 1 or numbers["respawns"] != 1 or \
            numbers["requeues"] != 1 or \
            kinds != ["drain", "drain", "drop", "join", "join", "join"] \
            or not numbers["respawned_jobs"] or \
            not numbers["respawned_jobs"][0] or len(codes) != 3 or \
            codes[0] != -signal.SIGKILL or any(codes[1:]):
        fail("9f (a): expected one drop, requeue and respawn, a respawned "
             "worker that trains, and the killed worker's SIGKILL: %s"
             % numbers)
    if numbers["failed_minibatches"] or numbers["inflight"]:
        fail("9f (a): minibatches were lost: %s" % numbers)
    del wf, launcher
    return numbers


def fleet_pbt_argv(batch=NET_BATCH, size=227):
    """The configuration of phase 9f (b), as ``root.x=y`` sources."""
    n_train = batch * FLEET_TICKS
    return ["root.imagenet.minibatch_size=%d" % batch,
            "root.imagenet.max_epochs=%d" % FLEET_EPOCHS,
            "root.imagenet.n_classes=1000",
            "root.imagenet.sim_image_size=%d" % size,
            "root.imagenet.sim_classes=10",
            "root.imagenet.sim_train=%d" % n_train,
            "root.imagenet.sim_valid=%d" % batch,
            "root.imagenet.validate_labels=False",
            "root.imagenet.learning_rate=%s" % FLEET_LR,
            "root.common.engine.precision_level=0",
            "root.common.engine.pallas_lrn=True",
            "root.common.net.job_ticks=%d" % FLEET_TICKS,
            "root.common.net.codec='none'",
            "root.common.net.dtype='fp32'"]


def fleet_pbt_worker(address, config, device, out):
    """The worker process of phase 9f (b): ``python -m veles_tpu_torch``'s
    ``Main`` with the ``config`` sources and ``--population --pbt -m
    address`` on ``device``; writes its exit code and its B6/B7 launches
    to ``out``."""
    sys.path.insert(0, HERE)
    import torch
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.ops import lrn as L
    torch.set_num_threads(4)
    L.reset_launches()
    rc = Main([os.path.join(HERE, "veles_tpu_torch", "znicz", "samples",
                            "imagenet.py")] + config +
              ["--population", str(FLEET_P), "--pbt", "-m", address,
               "--device", device, "--random-seed", str(FLEET_SEED),
               "-v", "warning"]).run()
    if device == "cuda":
        torch.cuda.synchronize()
    with open(out, "w") as fout:
        json.dump({"rc": rc, "lrn_forward": L.lrn_forward.launches,
                   "lrn_backward": L.lrn_backward.launches}, fout)


def fleet_engine(listen, config, device):
    """A PBT ``PopulationEngine`` of phase 9f (b) in this process on
    ``device``: the coordinator (``listen``) or the in-process loopback
    (None)."""
    from types import SimpleNamespace
    from veles_tpu_torch.__main__ import (apply_config_sources,
                                          import_workflow_module)
    from veles_tpu_torch.population import PopulationEngine
    apply_config_sources(config)
    module = import_workflow_module(os.path.join(
        HERE, "veles_tpu_torch", "znicz", "samples", "imagenet.py"))
    args = SimpleNamespace(listen_address=listen, master_address=None,
                           result_file=None, random_seed=str(FLEET_SEED),
                           pbt=True, device=device)
    return PopulationEngine(SimpleNamespace(module=module, args=args),
                            FLEET_P, pbt_interval=1)


def fleet_states(master):
    return {m.member_id: workflow_state(m.wf) for m in master.members}


def fleet_pbt(workdir, smi, device="cuda", config=None):
    """Phase 9f (b): a PBT ``PopulationEngine`` coordinator
    (``-l 127.0.0.1:0``, ``--pbt --pbt-interval 1``, a ``Tune`` on the
    learning rate) with FLEET_P full-width AlexNet members, and one
    worker process of the command line (``--population --pbt -m``) on
    the same card.  Every job's wire bytes are measured through the
    tensor-frame encoder.  Gates: each member's weights and slots equal
    the same run through the in-process loopback (``_run_standalone``)
    bit for bit; an exploit fired, and every exploit job is under a
    fiftieth of a full ship; the worker's B6/B7 launches are twice its
    train and validation ticks (B7 twice its train ticks).  Returns the
    worker's launches and the readings."""
    import numpy
    import torch
    import torch.multiprocessing as mp
    from veles_tpu_torch import resilience
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.network_common import encode_message
    from veles_tpu_torch.population import master as PM
    resilience.reset()
    saved = [(node, dict(node.__dict__)) for node in (
        root.imagenet, root.common.net, root.common.population,
        root.common.engine)]
    config = fleet_pbt_argv() if config is None else config
    engine = fleet_engine("127.0.0.1:0", config, device)
    original = PM.PopulationMaster.generate_data_for_slave
    jobs = []

    def measured(self, slave=None):
        job = original(self, slave)
        if job is not None:
            _flags, parts = encode_message({"cmd": "job", "data": job},
                                           codec=None, tensor=True)
            meta = job["data"].get("__job__") or {}
            jobs.append({"member": job["m"], "exploit": "exploit" in job,
                         "bytes": sum(len(p) for p in parts),
                         "class": meta.get("minibatch_class"),
                         "ticks": self._members[job["m"]].outstanding[2]})
        return job

    PM.PopulationMaster.generate_data_for_slave = measured
    errors = []

    def coordinate():
        try:
            engine.run()
        except BaseException as e:  # reported below
            errors.append(repr(e))

    t0 = time.monotonic()
    coordinator = threading.Thread(target=coordinate, name="9f-pbt")
    coordinator.start()
    out = os.path.join(workdir, "fleet_worker.json")
    worker = None
    try:
        while engine.server is None and coordinator.is_alive() and \
                time.monotonic() - t0 < FLEET_DEADLINE:
            time.sleep(0.05)
        if engine.server is None:
            fail("9f (b): the coordinator never listened: %s" % errors)
        ctx = mp.get_context("spawn")
        worker = ctx.Process(target=fleet_pbt_worker, args=(
            "127.0.0.1:%d" % engine.server.port, config, device, out))
        worker.start()
        while coordinator.is_alive() and \
                time.monotonic() - t0 < FLEET_DEADLINE:
            coordinator.join(1.0)
            if not worker.is_alive() and coordinator.is_alive():
                coordinator.join(30.0)
                break
        if coordinator.is_alive():
            engine.server.stop()
            coordinator.join(60.0)
            fail("9f (b): the PBT run did not end (worker exit %s)"
                 % worker.exitcode)
        worker.join(120)
    finally:
        PM.PopulationMaster.generate_data_for_slave = original
        if worker is not None and worker.is_alive():
            worker.kill()
            worker.join()
    session_s = time.monotonic() - t0
    if errors or worker.exitcode:
        fail("9f (b): coordinator errors %s, worker exit %s" % (
            errors, worker.exitcode))
    with open(out) as fin:
        report = json.load(fin)
    master = engine.master
    exploits = master.exploits
    summary = master.population_summary()
    got = fleet_states(master)
    del engine, master
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.monotonic()
    ref = fleet_engine(None, config, device)
    ref._run_standalone()
    standalone_s = time.monotonic() - t1
    want = fleet_states(ref.master)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    for node, state in saved:
        node.__dict__.clear()
        node.__dict__.update(state)
    equal = {m: sum(bool(numpy.array_equal(got[m][k], want[m][k]))
                    for k in want[m]) for m in want}
    sizes = {k: len(v) for k, v in want.items()}
    full = max(j["bytes"] for j in jobs if not j["exploit"])
    exploit_bytes = [j["bytes"] for j in jobs if j["exploit"]]
    train = sum(j["ticks"] for j in jobs if j["class"] == TRAIN)
    valid = sum(j["ticks"] for j in jobs if j["class"] != TRAIN)
    expect = {"lrn_forward": 2 * (train + valid), "lrn_backward": 2 * train}
    launches = {k: report[k] for k in expect}
    print("9f (b) on %s: %d PBT members, %d jobs (%d train + %d "
          "validation ticks), %d exploit(s); members == the in-process "
          "loopback bit for bit: %s of %s tensors" % (
              smi, FLEET_P, len(jobs), train, valid, exploits, equal,
              sizes))
    print("9f (b) on %s: wire bytes of a full ship %d, of each exploit "
          "job %s (%s x smaller); worker B6/B7 launches %s (expected %s); "
          "session %.1f s, loopback reference %.1f s" % (
              smi, full, exploit_bytes,
              ["%.0f" % (full / float(b)) for b in exploit_bytes],
              launches, expect, session_s, standalone_s))
    if equal != sizes:
        fail("9f (b): the fleet's members differ from the in-process "
             "loopback: %s of %s tensors equal" % (equal, sizes))
    if not exploit_bytes or exploits != len(exploit_bytes):
        fail("9f (b): no exploit fired at seed %d (%d exploits, %d "
             "exploit jobs)" % (FLEET_SEED, exploits, len(exploit_bytes)))
    if any(b * 50 >= full for b in exploit_bytes):
        fail("9f (b): an exploit job is not 50x smaller than a full ship "
             "(%s vs %d)" % (exploit_bytes, full))
    if launches != expect:
        fail("9f (b): the worker launched the LRN kernels %s times, its "
             "ticks imply %s" % (launches, expect))
    numbers = {"members": FLEET_P, "jobs": jobs, "exploits": exploits,
               "summary": summary, "full_ship_bytes": full,
               "exploit_job_bytes": exploit_bytes,
               "train_ticks": train, "validation_ticks": valid,
               "worker_launches": launches, "session_s": session_s,
               "loopback_reference_s": standalone_s}
    return launches, numbers


def phase_fleet(workdir, smi):
    """Phase 9f: (a) :func:`fleet_mnist`, (b) :func:`fleet_pbt`; prints
    the phase's seconds beside the card's name and power limit."""
    started = time.monotonic()
    mnist = fleet_mnist(workdir, smi)
    gc.collect()
    launches, pbt = fleet_pbt(workdir, smi)
    numbers = {"fleet": mnist, "pbt": pbt,
               "phase_s": time.monotonic() - started}
    print("9f on %s: the phase %.1f s" % (smi, numbers["phase_s"]))
    return launches, numbers


#: Phase 10s: the AlexNet at NET_BATCH, SERVICES_EPOCHS epochs of one
#: validation tick and SERVICES_TRAIN_TICKS train ticks (10 synthetic
#: classes of 1000), heartbeats every SERVICES_INTERVAL seconds.  The
#: ticks take 19-43 ms on the card: warm runs of 2 and 4 epochs left
#: room for one and two beats before the last, so 16 epochs (about 1-2
#: s of ticks) keep the gate's two beats during the run clear of the
#: host's speed.
SERVICES_EPOCHS, SERVICES_TRAIN_TICKS, SERVICES_INTERVAL = 16, 2, 0.2
#: The plotters of the phase's workflow file, by name.
SERVICES_PLOTS = {"validation error": "AccumulatingPlotter",
                  "confusion": "MatrixPlotter",
                  "conv1 weights": "Histogram"}

SERVICES_WORKFLOW = '''"""The full-width AlexNet with the operator services' plotters: a
confusion matrix kept on the card by the evaluator, and an
AccumulatingPlotter, a MatrixPlotter and a Histogram after the decision,
each firing at an epoch's end."""
import numpy
import torch

from veles_tpu_torch.config import root, get as config_get
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plotting_units import (AccumulatingPlotter, Histogram,
                                            MatrixPlotter)
from veles_tpu_torch.units import Unit
from veles_tpu_torch.znicz.evaluator import EvaluatorSoftmax
from veles_tpu_torch.znicz.samples.imagenet import (AlexNetWorkflow,
                                                     LOADER_KEYS)


class ConfusionEvaluator(EvaluatorSoftmax):
    """The softmax evaluator that also adds each valid sample into a
    (label, prediction) matrix on the device."""

    def __init__(self, workflow, **kwargs):
        super(ConfusionEvaluator, self).__init__(workflow, **kwargs)
        self.confusion = Vector()

    @property
    def tstate(self):
        state = dict(super(ConfusionEvaluator, self).tstate)
        state["confusion"] = self.confusion
        return state

    def tforward(self, read, write, params, ctx, state=None):
        updates = super(ConfusionEvaluator, self).tforward(
            read, write, params, ctx, state)
        if state is not None:
            labels = read(self.labels).long()
            pred = torch.argmax(read(self.input), dim=-1)
            updates = dict(updates or {})
            updates["confusion"] = state["confusion"].index_put(
                (labels, pred), read(self.mask).float(), accumulate=True)
        return updates


class EpochEnd(Unit):
    """Opens ``gate`` (a gate_skip) at an epoch's last minibatch only."""

    def __init__(self, workflow, gate, **kwargs):
        super(EpochEnd, self).__init__(workflow, **kwargs)
        self.gate = gate

    def run(self):
        self.gate <<= not self.workflow.loader.epoch_ended


class ConfusionReset(Unit):
    """After the matrix plotter: books the samples the evaluator counted
    in the epoch, and zeroes the matrix for the next."""

    def run(self):
        wf = self.workflow
        wf.counted.append(float(sum(wf.decision.epoch_n_valid[1:])))
        wf.evaluator.confusion.map_write()
        wf.evaluator.confusion.mem[...] = 0.0


class ServicesWorkflow(AlexNetWorkflow):
    def __init__(self, workflow, n_classes=1000, **kwargs):
        super(ServicesWorkflow, self).__init__(
            workflow, n_classes=n_classes, **kwargs)
        self.evaluator.confusion.mem = numpy.zeros(
            (n_classes, n_classes), numpy.float32)
        self.counted = []
        gate = Bool(True)
        end = EpochEnd(self, gate, name="epoch_end")
        end.link_from(self.decision)
        curve = AccumulatingPlotter(self, name="validation error",
                                    input=self.decision,
                                    input_field="min_validation_err")
        matrix = MatrixPlotter(self, name="confusion",
                               input=self.evaluator.confusion)
        hist = Histogram(self, name="conv1 weights",
                         input=self.forwards[0].weights)
        reset = ConfusionReset(self, name="confusion_reset")
        for unit in (curve, matrix, hist):
            unit.link_from(end)
            unit.gate_skip = gate
        reset.link_from(matrix)
        reset.gate_skip = gate

    def link_evaluator(self):
        last = self.forwards[-1]
        ev = ConfusionEvaluator(self)
        ev.input = last.logits if hasattr(last, "logits") else last.output
        ev.labels = self.loader.minibatch_labels
        ev.link_from(last)
        ev.mask = self.loader.minibatch_mask
        ev.minibatch_class_vec = self.loader.minibatch_class_vec
        return ev


def run(load, main):
    cfg = root.imagenet
    load(ServicesWorkflow,
         minibatch_size=config_get(cfg.minibatch_size, 128),
         max_epochs=config_get(cfg.max_epochs, 2),
         n_classes=config_get(cfg.n_classes, 1000),
         fail_iterations=config_get(cfg.fail_iterations, 10),
         loader_config={key: cfg.get(key) for key in LOADER_KEYS
                        if cfg.get(key) is not None})
    main()
'''


def services_argv(wf_py, status, graph, batch=NET_BATCH, size=227):
    """The command line of phase 10s."""
    return [wf_py,
            "root.imagenet.minibatch_size=%d" % batch,
            "root.imagenet.max_epochs=%d" % SERVICES_EPOCHS,
            # No early stop: every epoch runs, whatever the error does.
            "root.imagenet.fail_iterations=%d" % SERVICES_EPOCHS,
            "root.imagenet.n_classes=1000",
            "root.imagenet.sim_image_size=%d" % size,
            "root.imagenet.sim_classes=10",
            "root.imagenet.sim_train=%d" % (batch * SERVICES_TRAIN_TICKS),
            "root.imagenet.sim_valid=%d" % batch,
            "root.imagenet.validate_labels=False",
            "root.common.engine.precision_level=0",
            "root.common.engine.pallas_lrn=True",
            "root.common.graphics.enabled=True",
            "root.common.web.interval=%g" % SERVICES_INTERVAL,
            "-a", "cuda", "--status-address", status,
            "--workflow-graph", graph, "--dump-config",
            "--random-seed", str(SEED), "-v", "warning"]


def subscribe(port):
    """A subscriber socket on the graphics stream and its thread, which
    decodes every payload with the port's restricted unpickler into the
    returned list until the server closes."""
    from veles_tpu_torch.graphics_client import safe_loads
    from veles_tpu_torch.network_common import connect, recv_message
    sock = connect("127.0.0.1:%d" % port, timeout=30.0)
    got = []

    def loop():
        while True:
            try:
                payload = recv_message(sock, loads=safe_loads)
            except OSError:
                return
            if payload is None:
                return
            got.append(payload)

    thread = threading.Thread(target=loop, name="smoke-subscriber",
                              daemon=True)
    thread.start()
    return sock, thread, got


def poll(predicate, timeout, what):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        value = predicate()
        if value:
            return value
        time.sleep(0.02)
    fail("10s: timed out after %.0f s waiting for %s" % (timeout, what))


def services_pause(status, workdir, smi, device="cuda"):
    """Phase 10s's second part: a master ``Launcher(listen_address=...,
    status_address=...)`` holding MNIST FC on ``device`` and a worker of
    the same build on a loopback thread; the master folds no job until
    the pause and the resume went through.  A ``pause`` of the worker
    queued through the dashboard's ``/service`` must come back on a
    heartbeat and pause it (``Server.pause_slave``), a ``resume`` resume
    it; the run then completes.  Returns the numbers."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.client import Client
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    datasets = os.path.join(workdir, "services_mnist")
    write_mnist_idx(datasets)
    root.common.dirs.datasets = datasets
    net = root.common.net
    saved_net = dict(net.__dict__)
    for key in ("job_ticks", "dtype", "codec", "zero"):
        net.__dict__.pop(key, None)
    launcher = Launcher(listen_address="127.0.0.1:0",
                        status_address="127.0.0.1:%d" % status.port,
                        heartbeat_interval=SERVICES_INTERVAL)
    prng.reset()
    prng.get(0).seed(SEED)
    MnistWorkflow(launcher, max_epochs=1)
    launcher.initialize(device=device)
    worker_launcher = Launcher()
    prng.reset()
    prng.get(0).seed(SEED)
    worker = MnistWorkflow(worker_launcher, max_epochs=1)
    worker_launcher.initialize(device=device)
    server = launcher.server
    hold = threading.Event()
    apply = launcher.workflow.apply_data_from_slave

    def held_apply(data, slave=None):
        hold.wait(FLEET_DEADLINE)
        apply(data, slave)

    launcher.workflow.apply_data_from_slave = held_apply
    client = Client("127.0.0.1:%d" % server.port, worker,
                    reconnect_attempts=3)
    threads = [threading.Thread(target=launcher.run, name="smoke-master"),
               threading.Thread(target=client.run, name="smoke-worker")]
    for t in threads:
        t.start()
    t0 = time.monotonic()
    try:
        def listed():
            for mid, info in status.status().items():
                if info.get("mode") == "master" and info.get("slaves"):
                    return mid, next(iter(info["slaves"]))
        mid, sid = poll(listed, 60.0, "the worker in a heartbeat")
        post("http://127.0.0.1:%d/service" % status.port,
             {"master": mid, "command": "pause", "slave": sid})
        poll(lambda: server.slaves[sid].paused, 60.0, "the pause")
        paused_s = time.monotonic() - t0
        post("http://127.0.0.1:%d/service" % status.port,
             {"master": mid, "command": "resume", "slave": sid})
        poll(lambda: not server.slaves[sid].paused, 60.0, "the resume")
    finally:
        hold.set()
        for t in threads:
            t.join(FLEET_DEADLINE)
    numbers = {"commands": list(launcher.commands),
               "epochs": int(launcher.workflow.decision.epoch_number),
               "jobs": client.jobs_done, "pause_s": paused_s,
               "seconds": time.monotonic() - t0,
               "heartbeats": launcher.heartbeats}
    net.__dict__.clear()
    net.__dict__.update(saved_net)
    if any(t.is_alive() for t in threads) or numbers["epochs"] != 1 or \
            [(c["command"], c["slave"], c["done"])
             for c in numbers["commands"]] != [
                ("pause", sid, "paused"), ("resume", sid, "resumed")]:
        fail("10s: the dashboard's pause and resume of worker %s: %s"
             % (sid, numbers))
    print("10s on %s: a pause of worker %s queued through /service came "
          "back on a heartbeat and paused it (%.1f s after the start), "
          "a resume resumed it; the master's run then trained its epoch "
          "(%d jobs, %d heartbeats, %.1f s)" % (
              smi, sid, paused_s, numbers["jobs"], numbers["heartbeats"],
              numbers["seconds"]))
    return numbers


def phase_services(workdir, smi, device="cuda"):
    """Phase 10s (see the module's docstring); ``device`` "cpu" is a
    rehearsal on the host (its perf and LRN gates are the card's).
    Returns (B6/B7 launches of the command line's run, numbers)."""
    import contextlib
    import io
    import numpy
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.graphics_server import GraphicsServer
    from veles_tpu_torch.ops import lrn as L
    from veles_tpu_torch.web_status import WebStatusServer
    started = time.monotonic()
    wf_py = os.path.join(workdir, "alexnet_services.py")
    graph = os.path.join(workdir, "services.dot")
    with open(wf_py, "w") as fout:
        fout.write(SERVICES_WORKFLOW)
    status = WebStatusServer(host="127.0.0.1", port=0).start()
    root.common.graphics.host = "127.0.0.1"
    graphics = GraphicsServer.launch()
    sock, subscriber, payloads = subscribe(graphics.port)
    try:
        poll(lambda: graphics.subscriber_count == 1, 30.0,
             "the subscriber")
        argv = services_argv(wf_py, "127.0.0.1:%d" % status.port, graph)
        if device != "cuda":
            argv += ["-a", device]
        dumped = io.StringIO()
        L.reset_launches()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(dumped):
            main = run_cli(argv)
        if device == "cuda":
            torch.cuda.synchronize()
        cli_s = time.monotonic() - t0
        launches = {"lrn_forward": L.lrn_forward.launches,
                    "lrn_backward": L.lrn_backward.launches}
        routes = {name: dict(getattr(L, name).launches_by_route)
                  for name in launches}
    finally:
        graphics.stop()
        subscriber.join(30.0)
        sock.close()
    wf, launcher = main.workflow, main.launcher
    board = status.status()
    infos = [i for i in board.values()
             if i.get("workflow") == type(wf).__name__]
    info = infos[0] if len(infos) == 1 else {}
    perf = info.get("perf") or {}
    dot = info.get("graph") or ""
    with open(graph) as fin:
        graph_file = fin.read()
    missing = [u.name for u in wf.units
               if 'label="%s"' % u.name not in dot]
    by_name = {}
    for p in payloads:
        by_name.setdefault(p["name"], []).append(p)
    sums = [float(numpy.asarray(p["data"]["matrix"]).sum())
            for p in by_name.get("confusion", [])]
    ticks = SERVICES_EPOCHS * (1 + SERVICES_TRAIN_TICKS)
    want = {"lrn_forward": 2 * ticks,
            "lrn_backward": 2 * SERVICES_EPOCHS * SERVICES_TRAIN_TICKS}
    numbers = {
        "cli_s": cli_s, "heartbeats": launcher.heartbeats,
        "status": {k: info.get(k) for k in ("workflow", "mode", "epoch",
                                            "running", "metrics")},
        "perf": perf, "graph_units": len(wf.units),
        "graph_missing": missing, "graph_file_equal": graph_file == dot,
        "config_dump_chars": len(dumped.getvalue()),
        "payloads": {name: len(v) for name, v in by_name.items()},
        "confusion_sums": sums, "counted": list(wf.counted),
        "launches": launches, "routes": routes}
    print("10s on %s: the command line (-a cuda, --status-address, "
          "--workflow-graph, --dump-config, graphics on) %.1f s: %d "
          "heartbeats; the dashboard's %s at epoch %s, metrics %s, perf "
          "step_ms %s, MFU %s; the DOT graph names %d of %d units (the "
          "file equal: %s); payloads %s; confusion sums %s against the "
          "evaluator's counts %s; B6 %d, B7 %d launches (routes %s)" % (
              smi, cli_s, launcher.heartbeats, info.get("workflow"),
              info.get("epoch"), info.get("metrics"), perf.get("step_ms"),
              perf.get("mfu"), len(wf.units) - len(missing), len(wf.units),
              graph_file == dot, numbers["payloads"], sums, wf.counted,
              launches["lrn_forward"], launches["lrn_backward"], routes))
    # Two beats during the run, and the last as it ends.
    if launcher.heartbeats < 3 or len(infos) != 1 or \
            info.get("epoch") != SERVICES_EPOCHS or \
            not {"validation_err", "train_err"} <= set(
                info.get("metrics") or {}):
        fail("10s: the dashboard did not show the run's epoch and metrics "
             "over two heartbeats and the last: %s" % numbers)
    if device == "cuda" and not (
            (perf.get("step_ms") or 0) > 0 and 0 < (perf.get("mfu") or 0)
            <= 1):
        fail("10s: the perf row lacks the tick's device ms or MFU: %s"
             % perf)
    if missing or graph_file != dot or not dot.startswith("digraph"):
        fail("10s: the DOT graph misses units %s (the file equal to the "
             "heartbeat's: %s)" % (missing, graph_file == dot))
    if "'imagenet'" not in dumped.getvalue() or \
            "'graphics'" not in dumped.getvalue():
        fail("10s: --dump-config printed no config tree")
    if numbers["payloads"] != {n: SERVICES_EPOCHS for n in SERVICES_PLOTS} \
            or any(p["cls_name"] != SERVICES_PLOTS[p["name"]]
                   for p in payloads):
        fail("10s: expected one payload per plotter per epoch: %s"
             % numbers["payloads"])
    if sums != wf.counted or len(sums) != SERVICES_EPOCHS or \
            sums[-1] != sum(wf.decision.epoch_n_valid[1:]):
        fail("10s: the confusion matrices' sums %s are not the samples "
             "the evaluator counted %s" % (sums, wf.counted))
    if device == "cuda" and (launches != want or any(
            r.get("wide") for r in routes.values())):
        fail("10s: B6/B7 launches %s (routes %s); the ticks imply %s on "
             "the register route" % (launches, routes, want))
    del main, wf, launcher
    gc.collect()
    # The command line's dashboard address and graphics switch go: the
    # second part's worker launcher, in this process, must not beat too.
    root.common.__dict__.pop("graphics", None)
    root.common.__dict__.pop("web", None)
    root.__dict__.pop("imagenet", None)
    clean_cli_config()
    numbers["pause"] = services_pause(status, workdir, smi, device)
    status.stop()
    root.common.__dict__.pop("dirs", None)
    numbers["phase_s"] = time.monotonic() - started
    print("10s on %s: the phase %.1f s" % (smi, numbers["phase_s"]))
    return launches, numbers


#: ``--ranks 4``: the parallel styles on four cards, one rank each in an
#: NCCL world (mesh axes, applier, TinyLM kwargs, ZeRO level).  The
#: tests' geometry (vocab 16, 32 positions, embed 32, 4 heads, 2 blocks,
#: batch 16) at float32: only the ranks' agreement with the unsplit tick
#: is read, not their speed.
RANK_CASES = {
    "dp": ({"data": 4}, "apply_dp_sharding", {}, 0),
    "dp_tp": ({"data": 2, "model": 2}, "apply_dp_tp_sharding", {}, 0),
    "dp_tp_sp_ring": ({"data": 1, "model": 2, "seq": 2},
                      "apply_dp_tp_sp_sharding", {"seq_axis": "seq"}, 0),
    "dp_sp_ulysses": ({"data": 2, "seq": 2}, "apply_dp_sp_sharding",
                      {"seq_axis": "seq", "sp_mode": "ulysses"}, 0),
    "dp_ep_top2": ({"data": 2, "expert": 2}, "apply_dp_ep_sharding",
                   {"n_experts": 4, "top_k": 2, "expert_axis": "expert"},
                   0),
    "dp_ep_tp": ({"data": 1, "expert": 2, "model": 2},
                 "apply_dp_ep_tp_sharding",
                 {"n_experts": 4, "expert_axis": "expert"}, 0),
    "dp_pp_1f1b": ({"data": 2, "stage": 2}, "apply_dp_pp_sharding",
                   {"pipelined": True, "stage_axis": "stage",
                    "n_microbatches": 2, "schedule": "1f1b"}, 0),
    "dp_pp_tp": ({"data": 1, "stage": 2, "model": 2},
                 "apply_dp_pp_tp_sharding",
                 {"pipelined": True, "stage_axis": "stage",
                  "n_microbatches": 2, "schedule": "1f1b"}, 0),
    "zero1_dp_tp": ({"data": 2, "model": 2}, "apply_dp_tp_sharding", {},
                    1),
    "zero2_dp": ({"data": 4}, "apply_dp_sharding", {}, 2),
}
RANK_GEOMETRY = dict(vocab_size=16, seq_len=32, embed_dim=32, n_heads=4,
                     n_blocks=2, minibatch_size=16,
                     loader_config={"n_train": 64, "n_valid": 16})
RANK_TICKS = 3
#: The unsplit tick's tolerance (the CPU gates' float32 one).
RANK_RTOL, RANK_ATOL, RANK_LOSS_RTOL = 2e-4, 2e-5, 1e-5
#: Kwargs that act only under a mesh (the unsplit reference drops them).
MESH_ONLY = ("seq_axis", "sp_mode", "expert_axis", "stage_axis",
             "schedule")


def rank_lm(launcher, **kwargs):
    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.samples.tinylm import TinyLMWorkflow
    prng.reset()
    prng.get(0).seed(99)
    return TinyLMWorkflow(launcher, **dict(RANK_GEOMETRY, **kwargs))


def rank_ticks(wf):
    """(losses, host parameters after each tick, tick seconds)."""
    import numpy
    import torch
    losses, params, secs = [], [], []
    for _ in range(RANK_TICKS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        wf.loader.run()
        losses.append(float(wf.step_metrics["loss"]))
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        out = {}
        for u in wf.units:
            for a, v in getattr(u, "trainables", {}).items():
                v.map_read()
                out["%s/%s" % (u.name, a)] = numpy.array(v.mem)
        params.append(out)
    return losses, params, secs


def rank_memory(wf):
    """After one more tick (no host read, so every placed tensor stays
    held as this rank's shard): this rank's parameter bytes, the bytes
    of the full parameters, the placed parameters whose held tensor is
    not their shard's size, and the peak of ``max_memory_allocated``."""
    import torch
    wf.loader.run()
    torch.cuda.synchronize()
    compiler = wf.compiler
    mesh = wf.mesh
    mine = full = 0
    wrong = []
    for name, vec in compiler._param_vecs.items():
        full += vec.nbytes
        held = compiler._held.get(name)
        if held is None:
            mine += vec.devmem.numel() * vec.devmem.element_size()
            if any(vec.placement or ()):
                wrong.append((name, "not held"))
            continue
        mine += held.numel() * held.element_size()
        shard = tuple(d // mesh.shape[a] if a else d
                      for d, a in zip(vec.shape, vec.placement))
        if tuple(held.shape) != shard or vec._devmem_ is not None:
            wrong.append((name, tuple(held.shape), shard))
    return {"param_bytes": mine, "full_param_bytes": full,
            "wrong_shards": wrong,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def rank_worker(rank, n, store, out):
    """One rank of ``--ranks``: joins the NCCL world through the port's
    launcher and trains every case of RANK_CASES, then reads its memory
    (:func:`rank_memory`); rank 0 writes the results and every rank's
    memory."""
    import pickle
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    import veles_tpu_torch.parallel as par
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    engine = root.common.engine
    engine.precision_level = 1
    engine.attention_dtype = "f32"
    engine.attention_kernel = "auto"
    import torch
    results = {}
    memory = {}
    try:
        for case, (axes, applier, lm, zero) in sorted(RANK_CASES.items()):
            launcher = Launcher(mode="distributed",
                                coordinator_address="file://" + store,
                                num_processes=n, process_id=rank)
            wf = rank_lm(launcher, **lm)
            launcher.initialize(device="cuda")
            getattr(par, applier)(wf, par.make_mesh(None, axes))
            if zero:
                par.apply_zero_sharding(wf, level=zero)
            torch.cuda.reset_peak_memory_stats()
            results[case] = rank_ticks(wf) + (dist.get_backend(),)
            memory[case] = rank_memory(wf)
            del wf, launcher
        gathered = [None] * n
        dist.all_gather_object(gathered, memory)
        lost = rank_lost(rank, n, store)
    except BaseException:
        if dist.is_initialized():
            dist.destroy_process_group()
        raise
    if rank == 0:
        with open(out, "wb") as fout:
            pickle.dump((results, gathered, lost), fout)
    # The world lost a member: its communicators are left to the
    # process's end, never destroyed (a wait on the dead rank).
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


#: The lost-rank case of ``--ranks``: the tests' TinyLM at batch 12
#: (split over every rank and over the survivors) under dp.
LOST_BATCH = 12


def rank_lost(rank, n, store):
    """``--ranks``'s lost rank: the TinyLM under dp over all n ranks
    ticks RANK_TICKS times, then the last rank exits (``os._exit``) and
    the survivors rebuild the mesh over themselves — no word from the
    dead rank, the in-flight minibatch requeued — and tick
    RANK_TICKS more.  Returns (losses, parameters, tick seconds) after
    the rebuild, its seconds and the new mesh; the dead rank never
    returns."""
    import veles_tpu_torch.parallel as par
    from veles_tpu_torch.launcher import Launcher
    launcher = Launcher(mode="distributed",
                        coordinator_address="file://" + store,
                        num_processes=n, process_id=rank)
    wf = rank_lm(launcher, minibatch_size=LOST_BATCH)
    launcher.initialize(device="cuda")
    par.apply_dp_sharding(wf, par.make_mesh(None, {"data": n}))
    rank_ticks(wf)
    if rank == n - 1:
        os._exit(0)
    t0 = time.monotonic()
    par.rebuild_mesh(wf, list(range(n - 1)))
    rebuild_s = time.monotonic() - t0
    requeued = len(wf.loader.failed_minibatches)
    return {"after": rank_ticks(wf), "rebuild_s": rebuild_s,
            "requeued": requeued, "mesh": dict(wf.mesh.shape)}


def phase_ranks(n, workdir, smi):
    """``--ranks n``: RANK_CASES on n cards (one rank each, NCCL), each
    case's ticks held to the same TinyLM's unsplit ticks on card 0."""
    import pickle
    import numpy
    import torch
    import torch.multiprocessing as mp
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    if torch.cuda.device_count() < n:
        fail("--ranks %d needs %d cards, found %d" % (
            n, n, torch.cuda.device_count()))
    store = os.path.join(workdir, "ranks.store")
    out = os.path.join(workdir, "ranks.pkl")
    t0 = time.monotonic()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_worker, args=(r, n, store, out))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        fail("--ranks %d: the ranks exited %s" % (n, codes))
    ranks_s = time.monotonic() - t0
    with open(out, "rb") as fin:
        got, memory, lost = pickle.load(fin)
    engine = root.common.engine
    engine.precision_level = 1
    engine.attention_dtype = "f32"
    engine.attention_kernel = "auto"
    refs, worst = {}, {}
    for case, (axes, applier, lm, zero) in sorted(RANK_CASES.items()):
        plain = {k: v for k, v in lm.items() if k not in MESH_ONLY}
        key = tuple(sorted(plain.items()))
        if key not in refs:
            launcher = Launcher()
            wf = rank_lm(launcher, **plain)
            launcher.initialize(device="cuda")
            refs[key] = rank_ticks(wf)
            del wf, launcher
        losses, params, secs, backend = got[case]
        want_losses, want_params, _ = refs[key]
        share = 0.0
        for g, w in zip(params, want_params):
            for name, arr in w.items():
                bound = RANK_ATOL + RANK_RTOL * numpy.abs(arr)
                share = max(share, float((numpy.abs(g[name] - arr) /
                                          bound).max()))
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, want_losses))
        worst[case] = {"share_of_tol": share, "loss_rel": loss_gap,
                       "tick_s": secs, "backend": backend, "mesh": axes,
                       "param_bytes_by_rank": [
                           m[case]["param_bytes"] for m in memory],
                       "full_param_bytes": memory[0][case][
                           "full_param_bytes"],
                       "peak_bytes_by_rank": [
                           m[case]["peak_bytes"] for m in memory],
                       "wrong_shards": [m[case]["wrong_shards"]
                                        for m in memory
                                        if m[case]["wrong_shards"]]}
        print("ranks %s %s on %d cards (%s): losses %s vs unsplit %s; "
              "largest parameter error / tolerance (rtol %g, atol %g) "
              "%.4f; ticks %s s" % (
                  case, axes, n, backend, ["%.6f" % x for x in losses],
                  ["%.6f" % x for x in want_losses], RANK_RTOL, RANK_ATOL,
                  share, ["%.4f" % x for x in secs]))
        print("ranks %s: parameter bytes by rank %s of %d whole (placed "
              "parameters held as shards between ticks); peak "
              "max_memory_allocated by rank %s" % (
                  case, worst[case]["param_bytes_by_rank"],
                  worst[case]["full_param_bytes"],
                  worst[case]["peak_bytes_by_rank"]))
    # The lost rank: the unsplit TinyLM's same ticks, its in-flight
    # minibatch requeued after the third as the rebuild requeues it.
    launcher = Launcher()
    wf = rank_lm(launcher, minibatch_size=LOST_BATCH)
    launcher.initialize(device="cuda")
    rank_ticks(wf)
    wf.loader.failed_minibatches.extend(wf.loader._in_flight_)
    wf.loader._in_flight_ = []
    want_losses, want_params, _ = rank_ticks(wf)
    del wf, launcher
    losses, params, secs = lost["after"]
    share = 0.0
    for g, w in zip(params, want_params):
        for name, arr in w.items():
            bound = RANK_ATOL + RANK_RTOL * numpy.abs(arr)
            share = max(share, float((numpy.abs(g[name] - arr) /
                                      bound).max()))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       want_losses))
    worst["lost_rank_dp"] = {
        "share_of_tol": share, "loss_rel": loss_gap, "tick_s": secs,
        "backend": "nccl", "mesh": lost["mesh"], "wrong_shards": [],
        "rebuild_s": lost["rebuild_s"], "requeued": lost["requeued"]}
    print("ranks lost_rank_dp: rank %d of %d exited; the survivors re-formed "
          "as %s in %.3f s (%d minibatch requeued) and ticked: losses %s vs "
          "unsplit %s; largest parameter error / tolerance %.4f" % (
              n - 1, n, lost["mesh"], lost["rebuild_s"], lost["requeued"],
              ["%.6f" % x for x in losses], ["%.6f" % x for x in want_losses],
              share))
    if lost["mesh"] != {"data": n - 1} or lost["requeued"] != 1:
        fail("--ranks %d: the lost-rank rebuild gave %s" % (n, lost))
    bad = {c: w for c, w in worst.items() if w["share_of_tol"] > 1.0 or
           w["loss_rel"] > RANK_LOSS_RTOL or w["backend"] != "nccl" or
           w["wrong_shards"]}
    for case in ("dp_tp", "dp_ep_top2", "dp_pp_1f1b", "dp_pp_tp",
                 "dp_ep_tp"):
        w = worst[case]
        if max(w["param_bytes_by_rank"]) >= w["full_param_bytes"]:
            bad[case] = dict(w, why="a rank holds every parameter whole")
    print(json.dumps({"ranks": {"n": n, "cases": worst,
                                "ranks_s": ranks_s}}))
    print("ranks on %s: %d cases in %.1f s" % (smi, len(worst), ranks_s))
    if bad:
        fail("--ranks %d: cases leave the unsplit ticks: %s" % (n, bad))


SPEC_K = 4
REPEATING = ((8, 8), (5, 30))   # (pattern length, repeats)
TOKEN = "chip-smoke"


class CallLog(object):
    """Wraps a model's paged entry points, its adoption's write
    (``import_kv_blocks``) and a pool's block copy: counts the times a
    call's attention went through a decode kernel (see :meth:`programs`;
    one launch per block each) and, while recording, keeps every call's
    inputs and output in order, tagged by the pool it ran on, with each
    pool's contents at the start, so a pool's run can be replayed call
    for call.  Counts and records are taken under a lock: in phase 10a
    two replicas and a prefill worker share the model, so three device
    threads call at once."""

    KINDS = ("paged_extend", "paged_step", "paged_verify")

    def __init__(self, model):
        self.model = model
        self.originals = {k: getattr(model, k) for k in self.KINDS}
        self.originals["import_kv_blocks"] = model.import_kv_blocks
        self.lock = threading.Lock()
        self.records, self.snapshots, self.recording = [], {}, False
        self.calls = {}
        for kind in self.KINDS:
            setattr(model, kind, self._wrap(kind))
        model.import_kv_blocks = self._imported

    def _record(self, pool, kind, args, out):
        if self.recording:
            with self.lock:
                self.records.append((id(pool), kind, args, out))

    def _wrap(self, kind):
        import numpy
        fn = self.originals[kind]

        def call(pool, *args, **kw):
            out = fn(pool, *args, **kw)
            n = self.programs(kind, pool, args, out)
            if n:
                with self.lock:
                    self.calls[kind] = self.calls.get(kind, 0) + n
            if self.recording:
                self._record(pool, kind, [numpy.array(a) for a in args],
                             numpy.array(out))
            return out
        return call

    def _imported(self, pool, ids, blocks):
        """An adoption's write, recorded: the replay of a decode pool
        rebuilds the adopted blocks exactly as the wire delivered them."""
        import numpy
        out = self.originals["import_kv_blocks"](pool, ids, blocks)
        if self.recording:
            self._record(pool, "import", (
                list(ids), numpy.array(blocks, numpy.float32)), None)
        return out

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
            self._record(pool, "copy", (src, dst), None)
            return fn(storage, src, dst)

        def reset(storage, ids):
            self._record(pool, "reset", list(ids), None)
            return reset_fn(storage, ids)
        pool._copy_fn = copy
        if reset_fn is not None:
            pool._reset_fn = reset

    def start(self, *pools):
        import torch
        torch.cuda.synchronize()
        self.snapshots = {id(p): [[t.clone() for t in group]
                                  for group in p.storage] for p in pools}
        self.records, self.calls, self.recording = [], {}, True

    def stop(self, pool):
        """Ends the recording; returns ``pool``'s records and its
        contents at the start."""
        self.recording = False
        return ([rec[1:] for rec in self.records if rec[0] == id(pool)],
                self.snapshots[id(pool)])

    def kernel_calls(self):
        return sum(self.calls.values())

    def restore(self):
        for kind, fn in self.originals.items():
            setattr(self.model, kind, fn)

    def replay_pool(self, pool):
        """:meth:`replay` of the calls, block copies, resets and
        adoptions that ran on ``pool``."""
        records, snapshot = self.stop(pool)
        return self.replay(records, snapshot, (
            pool.n_blocks, pool.block_size, pool.kv_dtype))

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
            if kind == "import":  # an adoption's write (phase 10a)
                for pool in pools:
                    self.model.import_kv_blocks(pool, *args)
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
        numbers["records"], numbers["snapshot"] = log.stop(
            server.engine.kv_pool)
    return answers, numbers


def divergence(got, want):
    """(first position where two answers differ or their length, share
    of equal positions)."""
    first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 len(want))
    return first, sum(a == b for a, b in zip(got, want)) / len(want)


def check_launches(name, numbers, log, b4, b5, blocks=BLOCKS):
    """The decode kernels launched what the run implies: one launch per
    block (of ``blocks``) for each call ``log`` counted, on the kernel
    the pool's plane calls for (``b4``/``b5``: whether that kernel serves
    this run)."""
    implied = blocks * log.kernel_calls()
    want = (implied if b4 else 0, implied if b5 else 0)
    got = (numbers["b4"], numbers["b5"])
    print("%s: device calls through a decode kernel %s, launches B4 %d, "
          "B5 %d (implied %s = %d layers x calls)" % (
              name, dict(log.calls), got[0], got[1], want, blocks))
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


#: Phase 10a: the serving fabric over phase 7's full-width LM — two
#: decode replicas and a prefill worker (``fabric_replicas=2,
#: fabric_disagg=True``) sharing the loaded model, each with its own
#: queue, device thread and KV pool, behind the tenants FABRIC_TENANTS
#: (``a``: a burst of FABRIC_BURST, then 0.001 requests/s; ``b``
#: unbounded).  The int8 wave serves FABRIC_INT8 (indices of phase 7's
#: prompts, each at least two 16-token blocks long, so its prefill is
#: disaggregated).
FABRIC_BURST = 2
FABRIC_TENANTS = ["a=0.001:%d" % FABRIC_BURST, "b=1000000"]
FABRIC_INT8 = (2, 3, 5, 6)


def post_status(url, body, headers=None):
    """POST returning (status, reply, headers) for any status."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), e.headers


def fabric_pools(server):
    """Each engine of the server's fabric (the replicas, then the
    prefill worker) with its pool made now, before any request."""
    engines = list(server._fabric_engines)
    if server.fabric.prefill is not None:
        engines.append(server.fabric.prefill.engine)
    return [e._ensure_pool() for e in engines]


def fabric_server(model, **kw):
    """The phase's fabric server on ``model``, started, and its pools."""
    from veles_tpu_torch.restful import ModelServer
    server = ModelServer(model, host="127.0.0.1", port=0,
                         max_batch=MAX_BATCH, kv_block_size=KV_BLOCK,
                         deadline=600.0, fabric_replicas=2,
                         fabric_disagg=True, **kw)
    server.start()
    return server, fabric_pools(server)


def fabric_wave(base, prompts, tenant="b"):
    """``prompts`` as one concurrent wave of /api/generate requests of
    ``tenant``; returns the generated tokens."""
    headers = {"X-Tenant": tenant}
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
        futs = [ex.submit(post_status, base + "/api/generate",
                          {"tokens": [p], "max_new_tokens": MAX_NEW},
                          headers) for p in prompts]
        replies = [f.result() for f in futs]
    for i, (status, reply, _) in enumerate(replies):
        if status != 200:
            fail("10a: request %d of tenant %s answered %d: %s" % (
                i, tenant, status, reply))
    return [reply["generated"][0] for _, reply, _ in replies]


def fabric_tenants(base, prompt):
    """Tenant ``a`` gets FABRIC_BURST 200s, then 429 with Retry-After,
    while ``b`` keeps getting 200; an unknown and an anonymous tenant get
    403.  Returns the statuses."""
    body = {"tokens": [prompt], "max_new_tokens": 2}
    got = {"a": [], "b": [], "unknown": None, "anonymous": None}
    for _ in range(FABRIC_BURST + 2):
        status, _, headers = post_status(base + "/api/generate", body,
                                         {"X-Tenant": "a"})
        got["a"].append(status)
        if status == 429 and int(headers.get("Retry-After") or 0) < 1:
            fail("10a: a 429 without Retry-After")
        got["b"].append(post_status(base + "/api/generate", body,
                                    {"X-Tenant": "b"})[0])
    got["unknown"] = post_status(base + "/api/generate", body,
                                 {"X-Tenant": "mallory"})[0]
    got["anonymous"] = post_status(base + "/api/generate", body)[0]
    want = {"a": [200] * FABRIC_BURST + [429, 429],
            "b": [200] * (FABRIC_BURST + 2), "unknown": 403,
            "anonymous": 403}
    print("10a tenants: %s" % got)
    if got != want:
        fail("10a: tenant admission %s, expected %s" % (got, want))
    return got


class AdoptionLog(object):
    """The wire's direct gate.  Every block that a decode replica's
    adoption writes is read back from its pool as f32
    (``export_kv_blocks``), on the device thread that wrote it; every
    export of the prefill worker is kept as it left that pool, before
    the wire.  On the f32 plane the wire and the pool carry the values
    unchanged, so :meth:`mismatches` holds each adoption's blocks bit
    for bit against the prefill export of the same prompt."""

    def __init__(self, server):
        import numpy
        self.model = model = server.engine.model
        self.local, self.lock = threading.local(), threading.Lock()
        self.adopted, self.exported = [], []
        self.importer = model.import_kv_blocks
        self.engines = list(server._fabric_engines)
        self.prefill = server.fabric.prefill.engine

        def imported(pool, ids, blocks):
            out = self.importer(pool, ids, blocks)
            self.local.written = model.export_kv_blocks(pool, ids)
            return out
        model.import_kv_blocks = imported
        for i, engine in enumerate(self.engines):
            def adopted(tokens, payload, _adopt=engine._apply_kv_adopt,
                        _name="r%d" % i):
                # An adoption of a chain the pool holds already writes
                # nothing and records nothing.
                self.local.written = None
                n = _adopt(tokens, payload)
                if self.local.written is not None:
                    with self.lock:
                        self.adopted.append((_name, numpy.array(
                            tokens, numpy.int32), self.local.written))
                return n
            engine._apply_kv_adopt = adopted
        export = self.prefill._apply_kv_export

        def exported(tokens):
            out = export(tokens)
            if out is not None:
                with self.lock:
                    self.exported.append(
                        (numpy.array(tokens, numpy.int32), out[1]))
            return out
        self.prefill._apply_kv_export = exported

    def blocks(self, since=0):
        return sum(w.shape[2] for _, _, w in self.adopted[since:])

    def mismatches(self, since=0):
        """The adoptions from the ``since``-th on whose blocks differ
        from a prefill export of their prompt, as (replica, adoption,
        count of values whose bits differ, or why none was compared)."""
        import numpy
        bad = []
        for i, (name, tokens, written) in enumerate(self.adopted[since:],
                                                    since):
            n = written.shape[2]
            peers = [b for t, b in self.exported
                     if numpy.array_equal(t[:len(tokens)], tokens) and
                     b.shape[2] >= n]
            if not peers:
                bad.append((name, i, "no prefill export"))
            for b in peers:
                diff = int(numpy.count_nonzero(
                    written.view(numpy.uint32) != numpy.ascontiguousarray(
                        b[:, :, :n]).view(numpy.uint32)))
                if diff:
                    bad.append((name, i, diff))
                    break
        return bad

    def restore(self):
        self.model.import_kv_blocks = self.importer
        for engine in self.engines + [self.prefill]:
            engine.__dict__.pop("_apply_kv_adopt", None)
            engine.__dict__.pop("_apply_kv_export", None)


def fabric_plant(base, router_mod, prompt, corrupt):
    """``prompt`` (one no engine has seen) through the fabric with
    ``corrupt`` applied to the unpacked wire payload's blocks."""
    import numpy
    unpack = router_mod.unpack_kv_payload

    def planted(payload, **kw):
        obj = unpack(payload, **kw)
        if obj is not None:
            obj["blocks"] = numpy.array(obj["blocks"])
            corrupt(obj["blocks"])
        return obj

    router_mod.unpack_kv_payload = planted
    try:
        return fabric_wave(base, [prompt])
    finally:
        router_mod.unpack_kv_payload = unpack


def fabric_planted(model, base, router_mod, adoptions):
    """The planted wire faults, each on a prompt no engine has seen,
    through a wrapped ``unpack_kv_payload``.  One value of one adopted
    block flipped in sign must fail the wire's gate (:class:`AdoptionLog`)
    on exactly that value; the token gate's verdict on it is printed.
    One adopted block's k and v scaled by 1000 in every layer must fail
    the token gate."""
    import numpy
    rng = numpy.random.RandomState(SEED % (1 << 31) + 10)
    flip_prompt, scale_prompt = (rng.randint(0, VOCAB, 200).tolist()
                                 for _ in range(2))

    def flip(blocks):
        blocks.view(numpy.uint32)[0, 0, 0, 0, 0, 0] ^= 0x80000000

    def scale(blocks):
        blocks[:, :, 0] *= 1e3

    since = len(adoptions.adopted)
    answer = fabric_plant(base, router_mod, flip_prompt, flip)
    wire = adoptions.mismatches(since)
    seen = token_mismatches(model, [flip_prompt], answer)
    print("10a planted wire fault (one value of one adopted block flipped "
          "in sign): the wire's gate %s %s; the token gate (a reading) "
          "%s %s" % ("fails, as it must:" if wire else "PASSES", wire,
                     "fails:" if seen else "passes", seen))
    if len(wire) != 1 or wire[0][2] != 1:
        fail("10a: the wire's gate did not catch the one flipped value "
             "alone: %s" % wire)
    answer = fabric_plant(base, router_mod, scale_prompt, scale)
    caught = token_mismatches(model, [scale_prompt], answer)
    print("10a planted wire fault (one adopted block's k/v scaled by "
          "1000): the token gate %s %s" % (
              "fails, as it must:" if caught else "PASSES", caught))
    if not caught:
        fail("10a: the planted wire fault passed the token gate")
    return {"flip_wire": wire, "flip_tokens": len(seen),
            "scale_tokens": len(caught)}


def fabric_drain(server, prompts, want):
    """Concurrent requests, then ``stop(drain=True)`` once a replica
    holds a decode row: every request ends 200 with its gated answer or
    503 (still queued), never anything else."""
    base = "http://127.0.0.1:%d" % server.port
    engines = list(server._fabric_engines)
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
        futs = [ex.submit(post_status, base + "/api/generate",
                          {"tokens": [p], "max_new_tokens": MAX_NEW},
                          {"X-Tenant": "b"}) for p in prompts]
        deadline = time.monotonic() + 300
        while not any(e._rows for e in engines) and \
                time.monotonic() < deadline:
            time.sleep(0.002)
        server.stop(drain=True)
        replies = [f.result() for f in futs]
    codes = [status for status, _, _ in replies]
    for (status, reply, _), answer in zip(replies, want):
        if status == 200 and reply["generated"][0] != answer:
            fail("10a: an answer finished during the drain differs")
        if status not in (200, 503):
            fail("10a: a request answered %d during the drain" % status)
    print("10a drain: statuses %s (200 = finished, 503 = still queued; "
          "nothing dropped)" % codes)
    if 200 not in codes:
        fail("10a: the drain finished no request")
    return codes


def phase_fabric(served, smi):
    """Phase 10a, the serving fabric on the card over phase 7's model
    (no second artifact).  The f32 wave: phase 7's prompts, the repeated
    one last, tenant ``b``, through two replicas and disaggregated
    prefill — answers token-identical to phase 7's gated f32 answers,
    blocks adopted, a decode replica's prefix hit on a prompt it never
    prefilled, B4 launched once a block for every call through it
    (across the three engines), every adopted block bit-equal to the
    prefill worker's export (:class:`AdoptionLog`); the tenants'
    200/429/403; the planted wire faults; a drain.  The int8 wave: FABRIC_INT8's prompts on the
    int8 plane, disaggregated, every device call of every pool replayed
    with the plain quant attention on the same planes (adopted blocks
    re-quantized from the f32 wire), B5's launches; how many answers
    equal a single int8 engine's is printed, not gated."""
    import numpy
    import torch
    from veles_tpu_torch.ops import decode_attention as DA
    from veles_tpu_torch.serving import ServingEngine
    from veles_tpu_torch.serving.fabric import router as router_mod
    started = time.monotonic()
    model = served["model"]
    prompts, answers = served["prompts"], served["answers"]
    log = CallLog(model)
    out = {}
    try:
        server, pools = fabric_server(model, tenant=FABRIC_TENANTS)
        base = "http://127.0.0.1:%d" % server.port
        adoptions = AdoptionLog(server)
        try:
            torch.cuda.synchronize()
            DA.decode_attention.launches = 0
            DA.decode_attention.quant_launches = 0
            log.calls = {}
            t0 = time.monotonic()
            got = fabric_wave(base, prompts[:-1])
            got += fabric_wave(base, prompts[-1:])
            wave_s = time.monotonic() - t0
            torch.cuda.synchronize()
            numbers = {"b4": DA.decode_attention.launches,
                       "b5": DA.decode_attention.quant_launches}
            calls = dict(log.calls)
            stats = get(base + "/stats")
            check_launches("10a f32 fabric", numbers, log, True, False)
            bad = [(i, divergence(g, w)[0]) for i, (g, w) in
                   enumerate(zip(got, answers)) if g != w]
            fabric = stats["fabric"]
            hits = {n: r.get("prefix_hits", 0)
                    for n, r in fabric["per_replica"].items()}
            adopts = [e.stats.get("kv.adopt")
                      for e in server._fabric_engines]
            print("10a f32 fabric on %s: %d answers, %d differ from phase "
                  "7's gated f32 answers %s; routed %d, adopted blocks %d "
                  "(kv.adopt per replica %s), prefix hits per replica %s, "
                  "prefill exports %d; the wave %.2f s" % (
                      smi, len(got), len(bad), bad, fabric["routed"],
                      fabric["adopted_blocks"], adopts, hits,
                      server.fabric.prefill.engine.stats.get(
                          "kv.prefill_exported"), wave_s))
            if bad:
                fail("10a: fabric answers differ from the gated f32 "
                     "answers at (request, position) %s" % bad)
            if fabric["adopted_blocks"] < 1 or not any(adopts) or \
                    not any(hits.values()):
                fail("10a: no adopted block served a prefix hit: %s" %
                     fabric)
            wire, wire_blocks = adoptions.mismatches(), adoptions.blocks()
            print("10a wire: %d adoptions wrote %d blocks into the decode "
                  "pools; %d differ, bit for bit, from the prefill "
                  "worker's export of the same prompt (f32 wire, f32 "
                  "pools) %s" % (len(adoptions.adopted), wire_blocks,
                                 len(wire), wire))
            if wire or not adoptions.adopted:
                fail("10a: adopted blocks differ from the prefill "
                     "export: %s" % wire)
            tenants = fabric_tenants(base, prompts[0])
            planted = fabric_planted(model, base, router_mod, adoptions)
        except BaseException:
            server.stop(drain=False)
            raise
        finally:
            adoptions.restore()
        drain = fabric_drain(server, prompts[:4], answers[:4])
        out["f32"] = {"answers": len(got), "wave_s": wave_s,
                      "routed": fabric["routed"],
                      "adopted_blocks": fabric["adopted_blocks"],
                      "prefix_hits": hits, "b4": numbers["b4"],
                      "calls": calls, "tenants": tenants,
                      "wire_blocks": wire_blocks,
                      "planted": planted, "drain": drain}
        b4 = numbers["b4"]
        # The int8 wave.
        int8_prompts = [prompts[i] for i in FABRIC_INT8]
        server, pools = fabric_server(model, kv_dtype="int8")
        base = "http://127.0.0.1:%d" % server.port
        try:
            for pool in pools:
                log.watch(pool)
            log.start(*pools)
            DA.decode_attention.launches = 0
            DA.decode_attention.quant_launches = 0
            t0 = time.monotonic()
            got8 = fabric_wave(base, int8_prompts)
            wave8_s = time.monotonic() - t0
            torch.cuda.synchronize()
            numbers = {"b4": DA.decode_attention.launches,
                       "b5": DA.decode_attention.quant_launches}
            log.recording = False
            adopted8 = server.fabric.occupancy()["adopted_blocks"]
            check_launches("10a int8 fabric", numbers, log, False, True)
        finally:
            server.stop(drain=True)
        replayed = [log.replay_pool(pool) for pool in pools]
        compared = sum(r[0] for r in replayed)
        merged = (compared, sum((r[1] for r in replayed), []),
                  sum((r[2] for r in replayed), []),
                  sum((r[3] for r in replayed), []))
        gate_replay("10a int8 fabric", merged)
        if adopted8 < 1:
            fail("10a: the int8 wave adopted no block")
        single = ServingEngine(model, max_batch=MAX_BATCH,
                               kv_block_size=KV_BLOCK,
                               kv_dtype="int8").start()
        try:
            alone = [single.submit_generate(
                numpy.asarray([p], numpy.int32), MAX_NEW)[0, len(p):]
                .tolist() for p in int8_prompts]
        finally:
            single.stop()
        same = sum(a == b for a, b in zip(got8, alone))
        print("10a int8 fabric: %d answers, B5 launches %d, adopted "
              "blocks %d (re-quantized from the f32 wire); %d of %d "
              "answers equal a single int8 engine's (a reading: the "
              "adopted blocks' codes are the wire's re-quantization, not "
              "the prefill's own); the wave %.2f s; the phase %.1f s" % (
                  len(got8), numbers["b5"], adopted8, same, len(got8),
                  wave8_s, time.monotonic() - started))
        out["int8"] = {"answers": len(got8), "b5": numbers["b5"],
                       "adopted_blocks": adopted8,
                       "equal_single_int8_engine": same,
                       "replay": replay_readings(merged),
                       "wave_s": wave8_s}
    finally:
        log.restore()
    out["phase_s"] = time.monotonic() - started
    return b4, numbers["b5"], out


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
            records, snapshot = log.stop(pool)
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
        replayed = log.replay_pool(pool)
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


#: Seconds each phase of this run took, in order (printed as they end).
PHASE_S = {}


#: A phase still running after this many seconds dumps every thread's
#: stack to the standard error, and again each time as long again.
PHASE_STACKS_AFTER = 240


def timed(name, fn, *args):
    """Runs one phase and prints its seconds and the command's so far
    to both streams at once (the end of either may be all a reader of a
    stopped run sees)."""
    import faulthandler
    t0 = time.monotonic()
    faulthandler.dump_traceback_later(PHASE_STACKS_AFTER, repeat=True)
    try:
        out = fn(*args)
    finally:
        faulthandler.cancel_dump_traceback_later()
    PHASE_S[name] = round(time.monotonic() - t0, 1)
    line = "phase %s: %.1f s (command at %.1f s)" % (
        name, PHASE_S[name], time.monotonic() - STARTED[0])
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    return out


#: The command's start on the monotonic clock (set by main).
STARTED = [time.monotonic()]


def main():
    if sys.argv[1:2] == ["--prewrite"]:
        return prewrite(sys.argv[2])
    started = STARTED[0] = time.monotonic()
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
    # TF32 off and cuDNN deterministic, as every port entry point sets.
    resolve_device("cuda")
    if not torch.backends.cudnn.deterministic:
        fail("backends.CUDADevice left cudnn.deterministic off")
    if "--ranks" in sys.argv[1:]:
        # The parallel styles on several cards, and nothing else.
        timed("build", phase_build)
        n = int(sys.argv[sys.argv.index("--ranks") + 1])
        workdir = os.path.join(HERE, ".chip_smoke")
        os.makedirs(workdir, exist_ok=True)
        try:
            timed("ranks", phase_ranks, n, workdir, smi)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}))
        return 0
    workdir = os.path.join(HERE, ".chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    PREWRITER[0] = Prewriter(workdir)
    try:
        return all_phases(kind, count, smi, workdir, started)
    finally:
        PREWRITER[0].stop()
        shutil.rmtree(workdir, ignore_errors=True)


def all_phases(kind, count, smi, workdir, started):
    """Every phase on one card, in order; prints the readings and the
    kernels' line, then the last two lines."""
    import torch
    from veles_tpu_torch.ops import flash_attention as FA
    timed("build", phase_build)
    max_err, timings = timed("kernels", phase_kernels)
    quant_worst, quant_faults, quant_b4_equal, inv_rows, quant_times = \
        timed("quant_kernels", phase_quant_kernels)
    flash_err, split_shares, flash_times = \
        timed("flash_kernels", phase_flash_kernels)
    lrn_err, lrn_worst, lrn_faults_read, lrn_equal, lrn_times = \
        timed("lrn_kernels", phase_lrn_kernels)
    gc.collect()
    torch.cuda.empty_cache()
    flash_launches, training = timed("training", phase_training, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lrn_launches, lrn_routes, alexnet, alexnet_wf = \
        timed("alexnet", phase_alexnet, smi)
    gc.collect()
    torch.cuda.empty_cache()
    snapshot_launches, snapshots = \
        timed("snapshots", phase_snapshots, workdir, smi, alexnet_wf)
    del alexnet_wf
    gc.collect()
    torch.cuda.empty_cache()
    stream_launches, streamed = timed("streamed", phase_streamed, workdir, smi)
    gc.collect()
    torch.cuda.empty_cache()
    launches, numbers, served = timed("serving", phase_serving, workdir, smi)
    gc.collect()
    torch.cuda.empty_cache()
    fabric_b4, fabric_b5, fabric = timed("fabric", phase_fabric, served, smi)
    gc.collect()
    torch.cuda.empty_cache()
    inwf_flash, inwf_b4, inworkflow = \
        timed("inworkflow", phase_inworkflow, workdir, smi)
    gc.collect()
    torch.cuda.empty_cache()
    pretraining = timed("pretraining", phase_pretraining, workdir, smi)
    gc.collect()
    torch.cuda.empty_cache()
    pop_launches, population = \
        timed("population", phase_population, workdir, smi)
    gc.collect()
    torch.cuda.empty_cache()
    par_flash, par_b4, parallel = \
        timed("parallel", phase_parallel, workdir, smi)
    gc.collect()
    torch.cuda.empty_cache()
    net_launches, net = timed("net", phase_net, workdir, smi)
    gc.collect()
    torch.cuda.empty_cache()
    fleet_launches, fleet = timed("fleet", phase_fleet, workdir, smi)
    gc.collect()
    torch.cuda.empty_cache()
    services_launches, services = \
        timed("services", phase_services, workdir, smi)
    gc.collect()
    torch.cuda.empty_cache()
    reload_path, write_s, waited_s = PREWRITER[0].wait("reload")
    print("reload artifact write: %.1f s by the prewrite process "
          "(waited %.1f s; seed %d)" % (write_s, waited_s, SEED + 1))
    quant_launches, quant = \
        timed("quant_serving", phase_quant_serving, served,
              reload_path, smi)
    quant["fp8"] = timed("fp8", phase_fp8, served)
    quant["verify_exact_accepted"] = \
        timed("verify_exact", phase_verify_exact, served)
    quant["row_count_reading"] = row_count_reading(served["model"])
    step, step16 = timings[(1, POSITIONS)], timings[(16, POSITIONS)]
    kernels = {"kernels": [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "veles_tpu_torch/ops/csrc/decode_attention.cu",
        "replaces": "veles_tpu/ops/pallas_attention.py:616",
        "shape": "B=%d Sq=1 H=%d D=%d L=%d f32" % (
            MAX_BATCH, HEADS, EMBED // HEADS, POSITIONS),
        "launches": launches + fabric_b4 + inwf_b4 + par_b4,
        "launches_by_path": {"serving": launches,
                             "fabric_f32_wave": fabric_b4,
                             "in_workflow_serving": inwf_b4,
                             "pipelined_export_serving": par_b4},
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
        "launches": quant_launches + fabric_b5,
        "launches_by_path": {"quant_serving": quant_launches,
                             "fabric_int8_wave": fabric_b5},
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
            "launches": flash_launches[name] + inwf_flash[name] +
            pop_launches[name] + par_flash[name],
            "launches_by_path": {"training": flash_launches[name],
                                 "in_workflow_training": inwf_flash[name],
                                 "population_tinylm": pop_launches[name],
                                 "parallel_moe_and_pipelined":
                                     par_flash[name]},
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
            "launches": lrn_launches[name] + snapshot_launches[name] +
            stream_launches[name] + pop_launches[name] +
            net_launches[name] + fleet_launches[name] +
            services_launches[name],
            "launches_by_path": {
                "alexnet_run": lrn_launches[name],
                "alexnet_snapshot_ticks_and_artifact_forward":
                    snapshot_launches[name],
                "alexnet_streamed": stream_launches[name],
                "alexnet_population": pop_launches[name],
                "alexnet_data_plane_worker": net_launches[name],
                "alexnet_pbt_fleet_worker": fleet_launches[name],
                "alexnet_services_cli": services_launches[name]},
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
    print(json.dumps({"phase_s": PHASE_S}))
    print(json.dumps({"training": training}))
    print(json.dumps({"alexnet": alexnet}))
    print(json.dumps({"snapshots": snapshots}))
    print(json.dumps({"streamed": streamed}))
    print(json.dumps({"serving": numbers}))
    print(json.dumps({"fabric": fabric}))
    print(json.dumps({"in_workflow_serving": inworkflow}))
    print(json.dumps({"pretraining": pretraining}))
    print(json.dumps({"population": population}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"data_plane": net}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"services": services}))
    print(json.dumps({"quant_serving": quant}))
    print(json.dumps(kernels))
    print("chip_smoke: command time %.1f s" % (time.monotonic() - started))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
