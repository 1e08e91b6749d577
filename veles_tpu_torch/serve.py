"""``python -m veles_tpu_torch.serve model.veles.tgz [--device cuda]``
— serve an exported LM artifact over HTTP through the port's serving
engine: paged KV-cache decode-step continuous batching
(``--kv-blocks`` / ``--kv-block-size`` / ``--no-paged-decode``) over an
f32, bf16, int8 or fp8 KV plane (``--kv-dtype``), weight-only int8
decode matmuls (``--weight-dtype int8``), speculative decoding
(``--spec`` n-gram drafting, ``--spec-draft`` draft model,
``--spec-max-k`` verify width), ``--warmup`` bucket-grid warmup,
per-client rate limiting, queue-depth backpressure, hot weight reload
(``--reload-watch`` / authenticated ``POST /admin/reload``) and
graceful SIGTERM drain (``--drain-timeout``).

``--device`` is ``cuda`` unless ``cpu`` is asked for; without a card
``cuda`` raises.  The JAX server's fabric flags (``--fabric-replicas``,
``--fabric-disagg``, ``--tenant``) are accepted only to fail with a
clear "not yet ported" error."""

import argparse
import signal
import sys
import threading

from .export import KV_DTYPES
from .restful import ModelServer

#: Flags of the JAX package's server whose machinery the port has not
#: ported yet; giving any of them fails.
NOT_PORTED = ("fabric_replicas", "fabric_disagg", "tenant")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.serve",
        description="Serve an exported LM artifact over HTTP "
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
    not_ported = parser.add_argument_group("not yet ported")
    not_ported.add_argument("--fabric-replicas", default=None)
    not_ported.add_argument("--fabric-disagg", action="store_true")
    not_ported.add_argument("--tenant", action="append", default=None)
    args = parser.parse_args(argv)
    given = [name for name in NOT_PORTED if getattr(args, name)]
    if given:
        parser.error("not yet ported in veles_tpu_torch: %s" %
                     ", ".join("--" + g.replace("_", "-")
                               for g in given))
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
