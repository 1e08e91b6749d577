#!/usr/bin/env python3
"""Serving A/B of two trees of the port on one CUDA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 serve_ab.py OTHER_TREE [--rows N ...]

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
over 64-block tables.  The card's name and power limit come first, one
JSON line per process after them.
"""

import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PROMPT_LENGTHS = (5, 12, 40, 200, 700, 48, 130)
WAVES, MAX_NEW, MAX_BATCH = 3, 32, 8


def measure(tree, path, rows=None):
    """One process: ``tree``'s package serves the artifact at
    ``path``; prints ``RESULT <json>``."""
    sys.path.insert(0, tree)
    import numpy
    import torch
    from veles_tpu_torch import export as X
    from veles_tpu_torch.backends import resolve_device
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
    print("RESULT " + json.dumps(out))


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--measure":
        return measure(*sys.argv[2:])
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    other = os.path.abspath(sys.argv[1])
    rows = sys.argv[3:] if sys.argv[2:3] == ["--rows"] else []
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        sys.exit("serve_ab.py needs a CUDA card")
    from veles_tpu_torch import export as X
    workdir = os.path.join(HERE, ".chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "ab.veles.tgz")
    X.random_lm_artifact(path, 16384, 2048, 16, 12, 8192, 1024, seed=5,
                         compresslevel=0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    runs = [("other", other, None), ("this", HERE, None)]
    runs += [("this rows=%s" % r, HERE, r) for r in rows]
    order = runs + runs[::-1]
    try:
        for label, tree, r in order:
            cmd = [sys.executable, os.path.abspath(__file__), "--measure",
                   tree, path] + ([r] if r else [])
            done = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            line = [x for x in done.stdout.splitlines()
                    if x.startswith("RESULT ")]
            print(json.dumps({"tree": label, "result": json.loads(
                line[0][7:]) if line else done.stderr[-2000:]}),
                flush=True)
    finally:
        os.remove(path)


if __name__ == "__main__":
    main()
