"""``python -m veles_tpu_torch.serve model.veles.tgz [--device cuda]``
— serve an exported artifact over HTTP through the port's serving
engine.  A classifier (dense, conv, pooling, norm units) answers
``POST /api`` with ``output`` and ``labels`` in shape-bucketed batches
(``--warmup`` walks the batch buckets); a causal LM also answers
``POST /api/generate`` (a classifier answers it 400) with paged
KV-cache decode-step continuous batching
(``--kv-blocks`` / ``--kv-block-size`` / ``--no-paged-decode``) over an
f32, bf16, int8 or fp8 KV plane (``--kv-dtype``), weight-only int8
decode matmuls (``--weight-dtype int8``), speculative decoding
(``--spec`` n-gram drafting, ``--spec-draft`` draft model,
``--spec-max-k`` verify width), ``--warmup`` bucket-grid warmup,
per-client rate limiting, queue-depth backpressure, hot weight reload
(``--reload-watch`` / authenticated ``POST /admin/reload``) and
graceful SIGTERM drain (``--drain-timeout``), and the serving fabric:
``--fabric-replicas N`` engine replicas behind the prefix-affinity
router, ``--fabric-disagg`` prefill on a worker whose KV blocks the
replicas adopt, and ``--tenant NAME=RATE[:BURST][@ARTIFACT]`` quotas
keyed by the ``X-Tenant`` header.

``--device`` is ``cuda`` unless ``cpu`` is asked for; without a card
``cuda`` raises."""

import argparse
import signal
import sys
import threading

from .export import KV_DTYPES
from .restful import ModelServer


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.serve",
        description="Serve an exported artifact over HTTP "
                    "(POST /api, POST /api/generate, GET /health, "
                    "GET /stats, GET /metrics Prometheus "
                    "exposition)")
    parser.add_argument("artifact", help="model .veles.tgz path")
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="device to serve on (default cuda; a missing card fails)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8180)
    parser.add_argument(
        "--max-batch", type=int, default=8, metavar="N",
        help="max rows coalesced into one device batch (default 8)")
    parser.add_argument(
        "--queue-depth", type=int, default=64, metavar="N",
        help="bounded request-queue depth; beyond it requests get "
             "429 + Retry-After (default 64)")
    parser.add_argument(
        "--rate-limit", type=float, default=None, metavar="R",
        help="per-client token-bucket rate in requests/s "
             "(default: no limit)")
    parser.add_argument(
        "--deadline", type=float, default=30.0, metavar="SEC",
        help="per-request deadline; expired requests are cancelled "
             "unserved (default 30)")
    parser.add_argument(
        "--token", default=None, metavar="SECRET",
        help="require X-Status-Token on /api/generate")
    parser.add_argument(
        "--warmup", action="store_true",
        help="walk the shape-bucket grid before serving")
    parser.add_argument(
        "--kv-blocks", type=int, default=None, metavar="N",
        help="paged KV cache pool size in blocks (default: sized so "
             "max-batch rows can each hold a full-length sequence)")
    parser.add_argument(
        "--kv-block-size", type=int, default=16, metavar="N",
        help="tokens per paged KV cache block (default 16)")
    parser.add_argument(
        "--kv-dtype", default=None, choices=KV_DTYPES,
        help="paged KV cache storage dtype (default f32); int8/fp8 "
             "quantize per (block, head) with f32 scales stored beside "
             "the blocks and attend through the quantized decode "
             "kernel")
    parser.add_argument(
        "--weight-dtype", default=None, choices=("f32", "int8"),
        help="decode-matmul weight storage (default f32); int8 = "
             "weight-only quantization, per-output-channel scales")
    parser.add_argument(
        "--no-paged-decode", action="store_true",
        help="disable paged decode-step continuous batching and "
             "fall back to whole-request generate batching")
    parser.add_argument(
        "--spec", action="store_true",
        help="speculative decoding on the paged decode loop with the "
             "prompt-lookup (n-gram) drafter — greedy output is the "
             "plain decode's on the f32 plane")
    parser.add_argument(
        "--spec-draft", default=None, metavar="PATH",
        help="speculative draft model: a second exported artifact "
             "(same vocabulary, geometry-checked) proposing tokens "
             "through its own paged pool; implies --spec")
    parser.add_argument(
        "--spec-max-k", type=int, default=4, metavar="K",
        help="max draft tokens verified per dispatch (1..15; "
             "default 4)")
    parser.add_argument(
        "--spec-draft-blocks", type=int, default=None, metavar="N",
        help="draft-model KV pool size in blocks (default: the "
             "target pool's size)")
    parser.add_argument(
        "--drain-timeout", type=float, default=30.0, metavar="SEC",
        help="graceful-stop budget: on SIGTERM admissions close "
             "with 503 + Retry-After and live decode rows get this "
             "long to finish before the process exits 0 (default "
             "30)")
    parser.add_argument(
        "--reload-watch", default=None, metavar="PATH",
        help="hot-reload watch target: a serving artifact or a "
             "*_current.lnk snapshot pointer — when it changes, the "
             "sha256-manifest-verified artifact is hot-swapped in "
             "without dropping live streams")
    parser.add_argument(
        "--reload-poll", type=float, default=5.0, metavar="SEC",
        help="reload-watch poll interval (default 5)")
    parser.add_argument(
        "--fabric-replicas", type=int, default=1, metavar="N",
        help="serving fabric: run N engine replicas behind the "
             "prefix-affinity consistent-hash router — requests "
             "sharing a prompt prefix land on the same replica and "
             "hit its KV prefix cache (default 1: no fabric)")
    parser.add_argument(
        "--fabric-disagg", action="store_true",
        help="serving fabric: disaggregate prefill from decode — a "
             "dedicated prefill worker fills KV blocks and ships "
             "them to the decode replicas as versioned tensors over "
             "the zero-copy wire")
    parser.add_argument(
        "--tenant", action="append", default=None,
        metavar="NAME=RATE[:BURST][@ARTIFACT]",
        help="serving fabric: register a tenant with a token-bucket "
             "quota (repeatable); once any tenant is registered, "
             "requests without a known X-Tenant get 403 and "
             "over-quota tenants get 429 + Retry-After — without "
             "shedding sibling tenants")
    args = parser.parse_args(argv)
    if args.weight_dtype is not None:
        # The decode programs read the weight mode from the config and
        # quantize at their next parameter look-up.
        from .config import root
        root.common.serving.weight_dtype = args.weight_dtype
    server = ModelServer(
        args.artifact, host=args.host, port=args.port,
        token=args.token, max_batch=args.max_batch,
        queue_depth=args.queue_depth, rate_limit=args.rate_limit,
        deadline=args.deadline, warmup=args.warmup,
        paged=False if args.no_paged_decode else None,
        kv_blocks=args.kv_blocks, kv_block_size=args.kv_block_size,
        kv_dtype=args.kv_dtype, spec=args.spec,
        spec_draft=args.spec_draft, spec_max_k=args.spec_max_k,
        spec_draft_blocks=args.spec_draft_blocks,
        drain_timeout=args.drain_timeout,
        reload_watch=args.reload_watch, reload_poll=args.reload_poll,
        fabric_replicas=args.fabric_replicas,
        fabric_disagg=args.fabric_disagg, tenant=args.tenant,
        device=args.device)
    install_sigterm_drain(server)
    try:
        server.serve()
    except KeyboardInterrupt:
        server.stop(drain=True)
    return 0


def install_sigterm_drain(server):
    """SIGTERM → graceful drain → exit 0: in-flight requests finish,
    late arrivals get 503 + Retry-After.  The drain runs on a helper
    thread — signal handlers must return quickly, and ``server.stop``
    joins the device thread.  No-op outside the main thread."""
    def on_term(_signum, _frame):
        threading.Thread(target=lambda: server.stop(drain=True),
                         daemon=True,
                         name="veles-sigterm-drain").start()

    try:
        signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        pass  # not the main thread


if __name__ == "__main__":
    sys.exit(main())
