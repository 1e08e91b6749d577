#!/usr/bin/env python3
"""Serving A/B of two trees of the port on one CUDA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 serve_ab.py OTHER_TREE [--rows N ...]
    python3 serve_ab.py OTHER_TREE --kernels
    python3 serve_ab.py OTHER_TREE --lrn

``OTHER_TREE`` is another checkout of the repository (for example the
parent commit unpacked with ``git archive``).  One full-width LM
artifact (the LM bench geometry of ``chip_smoke.py``, random weights
from a seed) is written, then each tree's ``veles_tpu_torch`` serves it
in a process of its own, in turns: other, this, this, other (with
``--rows``, this tree once more per value and order, its
``export.DECODE_ROWS`` set to that value).  Each process reports, on
the f32 plane with ``max_batch`` 8: three waves of 7 concurrent greedy
requests (prompts of 5-700 tokens, 32 new tokens each) through the
``ServingEngine`` — wall time, tok/s, TTFT p50 and decode step p50; the
first wave is cold — and, timed with a host clock around
``torch.cuda.synchronize()``, a 700-token ``paged_extend`` of one row,
a ``paged_step`` of 8 rows and a 5-column ``paged_verify`` of 8 rows
over 64-block tables; then the same step and verify on the int8 KV plane
with int8 weights (B5's path).

With ``--kernels`` no artifact is written: each process times its
tree's decode kernels instead, B4 (f32) and B5 (int8, fp8 codes) at
B=8, H=16, D=128 over a 1024-key table with 1 and 16 query rows, in
turns other, this, this, other.  Every time comes from this tree's
``chip_smoke.decode_timing`` (CUDA events around a CUDA graph of
launches that rotate among input copies of more than twice the L2,
beside the host's time per call) on the same inputs, made from
``chip_smoke.SEED``, so the two trees are read alike.

With ``--lrn`` each process runs its tree's LRN kernels (B6, B7) on the
route its wrapper picks, in turns other, this, this, other: at
``chip_smoke.LRN_SHAPES`` with AlexNet's constants (bfloat16, timed by
this tree's ``chip_smoke.cold_ms``) and at ``LRN_AB_CASES`` (strong
constants, float32 and bfloat16), on inputs made from
``chip_smoke.SEED``; it reports a sha256 of every y and dx, and the
last line says in how many cases the two trees' outputs are the same
bytes.

The card's name and power limit come first, one JSON line per process
after them; a process that reports nothing makes the exit code 1.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PROMPT_LENGTHS = (5, 12, 40, 200, 700, 48, 130)
WAVES, MAX_NEW, MAX_BATCH = 3, 32, 8
KERNEL_SHAPES = [(plane, Sq) for plane in ("f32", "int8", "fp8")
                 for Sq in (1, 16)]
#: ``--lrn``'s cases beside the main-path shapes: (n, C) at the strong
#: constants (k = 1, alpha = n, beta = 0.75) over 3·37·41 rows.
LRN_AB_CASES = [(n, c) for n in (3, 4, 5) for c in (7, 96, 100, 256)]


def measure(tree, path, rows=None):
    """One process: ``tree``'s package serves the artifact at
    ``path``; prints ``RESULT <json>``."""
    sys.path.insert(0, tree)
    import numpy
    import torch
    from veles_tpu_torch import export as X
    from veles_tpu_torch.backends import resolve_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.serving import ServingEngine
    if rows:
        X.DECODE_ROWS = int(rows)
    resolve_device("cuda")
    model = X.ExportedModel(path, device="cuda")
    model._lm_params()
    rng = numpy.random.RandomState(7)
    prompts = [rng.randint(0, 16384, (1, n)).astype(numpy.int32)
               for n in PROMPT_LENGTHS]
    out = {}
    for wave in range(WAVES):
        engine = ServingEngine(model, max_batch=MAX_BATCH, kv_blocks=600,
                               kv_block_size=16).start()
        try:
            t0 = time.monotonic()
            threads = [threading.Thread(target=engine.submit_generate,
                                        args=(p, MAX_NEW)) for p in prompts]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.monotonic() - t0
            latency = engine.stats.snapshot().get("latency", {})
        finally:
            engine.stop()
        out["wave%d" % wave] = dict(
            seconds=wall, tok_per_s=MAX_NEW * len(prompts) / wall,
            ttft_p50_ms=latency.get("ttft.generate", {}).get("p50_ms"),
            itl_p50_ms=latency.get("itl.decode", {}).get("p50_ms"))
    pool = model.make_kv_pool(600, 16)
    tables = numpy.arange(1, 1 + 8 * 64, dtype=numpy.int32).reshape(8, 64)
    temps, seeds = numpy.zeros(8, numpy.float32), numpy.zeros(8, numpy.uint32)
    ones = numpy.ones(8, numpy.int32)

    def ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) / n * 1e3

    tokens = numpy.zeros((1, 1024), numpy.int32)
    tokens[0, :700] = rng.randint(0, 16384, 700)
    out["extend700_ms"] = ms(lambda: model.paged_extend(
        pool, tables[:1], tokens, numpy.zeros(1, numpy.int32),
        numpy.array([700], numpy.int32), temps[:1], seeds[:1]), 5)
    pos = numpy.full(8, 700, numpy.int32)
    out["step_ms"] = ms(lambda: model.paged_step(
        pool, tables, pos, ones, ones, temps, seeds))
    out["verify5_ms"] = ms(lambda: model.paged_verify(
        pool, tables, pos, numpy.ones((8, 5), numpy.int32),
        numpy.full(8, 4, numpy.int64), ones, temps, seeds))
    # The int8 KV plane with int8 weights (B5's path): the same step and
    # verify over a pool whose written blocks hold int8 codes.
    del pool
    root.common.serving.weight_dtype = "int8"
    pool = model.make_kv_pool(600, 16, kv_dtype="int8")
    model.paged_extend(pool, tables[:1], tokens,
                       numpy.zeros(1, numpy.int32),
                       numpy.array([700], numpy.int32), temps[:1],
                       seeds[:1])
    out["int8_step_ms"] = ms(lambda: model.paged_step(
        pool, tables, pos, ones, ones, temps, seeds))
    out["int8_verify5_ms"] = ms(lambda: model.paged_verify(
        pool, tables, pos, numpy.ones((8, 5), numpy.int32),
        numpy.full(8, 4, numpy.int64), ones, temps, seeds))
    root.common.serving.weight_dtype = "f32"
    print("RESULT " + json.dumps(out))


def measure_kernels(tree):
    """One process: ``tree``'s decode kernels at every shape of
    ``KERNEL_SHAPES`` under this tree's timer; prints ``RESULT
    <json>``."""
    sys.path.insert(0, tree)
    # This tree's chip_smoke.py, by path: the other tree has its own.
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    from veles_tpu_torch.backends import resolve_device
    resolve_device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    out = {}
    for plane, Sq in KERNEL_SHAPES:
        row = smoke.decode_timing(plane, Sq, smoke.POSITIONS, gen,
                                  plain=False, library=False)
        out["%s Sq=%d" % (plane, Sq)] = {
            k: row[k] for k in ("kernel_ms", "share", "bound_ms",
                                "host_us")}
    print("RESULT " + json.dumps(out))


def measure_lrn(tree):
    """One process: ``tree``'s LRN kernels on ``--lrn``'s cases; prints
    ``RESULT <json>`` with the sha256 of each output and the main-path
    times."""
    import hashlib
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    from veles_tpu_torch.backends import resolve_device
    from veles_tpu_torch.ops import lrn as L
    resolve_device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    cases = [(name, shape, torch.bfloat16, smoke.ALEXNET_LRN)
             for name, shape in smoke.LRN_SHAPES] + [
        ("n%d_c%d_%s" % (n, c, str(dtype)[6:]), (3, 37, 41, c), dtype,
         dict(n=n, alpha=float(n), beta=0.75, k=1.0))
        for n, c in LRN_AB_CASES for dtype in (torch.float32,
                                               torch.bfloat16)]
    out = {"sha256": {}, "ms": {}}
    for name, shape, dtype, kw in cases:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for kernel, got in (("y", L.lrn_forward(x, **kw)),
                            ("dx", L.lrn_backward(x, dy, **kw))):
            out["sha256"]["%s %s" % (name, kernel)] = hashlib.sha256(
                got.contiguous().view(torch.uint8).cpu().numpy()
                .tobytes()).hexdigest()
        if name in dict(smoke.LRN_SHAPES):
            size = x.numel() * x.element_size()
            out["ms"][name] = {
                "lrn_forward": smoke.cold_ms(
                    lambda a: L.lrn_forward(a, **kw), (x,), 2 * size),
                "lrn_backward": smoke.cold_ms(
                    lambda a, g: L.lrn_backward(a, g, **kw), (x, dy),
                    3 * size)}
        del x, dy
    print("RESULT " + json.dumps(out))


def run_turns(order):
    """Runs each ``(label, command arguments)`` of ``order`` in a
    process of its own and prints its result; returns whether every
    process reported one, and the results."""
    ok, results = True, []
    for label, args in order:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__)] + args,
            capture_output=True, text=True, timeout=900)
        line = [x for x in done.stdout.splitlines()
                if x.startswith("RESULT ")]
        ok &= bool(line)
        result = json.loads(line[0][7:]) if line else None
        results.append((label, result))
        print(json.dumps({"tree": label, "result": result if line
                          else done.stderr[-2000:]}), flush=True)
    return ok, results


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--measure":
        return measure(*sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--measure-kernels":
        return measure_kernels(sys.argv[2])
    if len(sys.argv) > 1 and sys.argv[1] == "--measure-lrn":
        return measure_lrn(sys.argv[2])
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    other = os.path.abspath(sys.argv[1])
    rows = sys.argv[3:] if sys.argv[2:3] == ["--rows"] else []
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        sys.exit("serve_ab.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if sys.argv[2:3] == ["--kernels"]:
        runs = [("other", ["--measure-kernels", other]),
                ("this", ["--measure-kernels", HERE])]
        sys.exit(0 if run_turns(runs + runs[::-1])[0] else 1)
    if sys.argv[2:3] == ["--lrn"]:
        runs = [("other", ["--measure-lrn", other]),
                ("this", ["--measure-lrn", HERE])]
        ok, results = run_turns(runs + runs[::-1])
        if not ok:
            sys.exit(1)
        hashes = {label: r["sha256"] for label, r in results}
        same = sum(hashes["other"][k] == v
                   for k, v in hashes["this"].items())
        print("lrn: the two trees' y and dx are the same bytes in %d/%d "
              "outputs" % (same, len(hashes["this"])))
        sys.exit(0)
    from veles_tpu_torch import export as X
    workdir = os.path.join(HERE, ".chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "ab.veles.tgz")
    X.random_lm_artifact(path, 16384, 2048, 16, 12, 8192, 1024, seed=5,
                         compresslevel=0)
    runs = [("other", ["--measure", other, path]),
            ("this", ["--measure", HERE, path])]
    runs += [("this rows=%s" % r, ["--measure", HERE, path, r])
             for r in rows]
    try:
        ok = run_turns(runs + runs[::-1])[0]
    finally:
        os.remove(path)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
