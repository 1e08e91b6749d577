"""Prefill/decode disaggregation: KV blocks as versioned tensors.

TTFT-heavy work (prefill: one big attention pass over the whole
prompt) and ITL-heavy work (decode: one token per step for every
live stream) have opposite shapes, and on one engine they contend
for the same device thread — a long prefill stalls every decoding
stream's next token.  Disaggregation splits them: a PREFILL worker
(its own engine, its own pool, its own device thread) fills the
prompt's full KV blocks, exports them with
``KVBlockPool.export_prefix_blocks`` + ``ExportedModel
.export_kv_blocks``, and ships them as a versioned tensor payload;
the DECODE replica adopts them (``ServingEngine.adopt_kv_prefix`` →
``adopt_prefix_blocks``, refcount-correct) so its own prefill step
degenerates to a one-token tail extension — the decode thread never
runs the long pass.

The wire format is the data plane's zero-copy tensor framing
(:func:`veles_tpu_torch.network_common.encode_tensor_parts`): a KV block
tensor is exactly the shape the delta data plane already moves, so
the fabric adds a payload SCHEMA, not a new codec:

``{"fmt": 1, "tokens": int32[n·bs], "n_blocks": n, "block_size":
bs, "weight_version": v, "blocks": f32[L, 2, n, bs, H, D]}``

``weight_version`` is load-bearing: KV computed under other weights
must never serve a reloaded model, so adoption refuses on skew
(``kv.adopt_stale``) exactly like ``reload()`` flushes the local
prefix cache.
"""

import numpy

from ...network_common import (decode_tensor_parts,
                               encode_tensor_parts)

#: Payload schema version — bump on any layout change; adoption
#: refuses unknown versions (forward-compat across a rolling fabric
#: upgrade: new prefill workers keep old decode replicas working by
#: sending the highest version both sides speak).
KV_WIRE_FMT = 1


def pack_kv_payload(tokens, n_blocks, blocks, block_size,
                    weight_version, codec=None):
    """One contiguous wire buffer for ``n_blocks`` full KV blocks of
    ``tokens`` (``blocks``: the ``(L, 2, n, bs, H, D)`` array from
    ``export_kv_blocks``).  The tensor bytes ride as raw frames —
    never re-pickled — via the zero-copy framing."""
    obj = {
        "fmt": KV_WIRE_FMT,
        "tokens": numpy.ascontiguousarray(
            tokens, dtype=numpy.int32)[:int(n_blocks) * block_size],
        "n_blocks": int(n_blocks),
        "block_size": int(block_size),
        "weight_version": int(weight_version),
        "blocks": numpy.ascontiguousarray(blocks,
                                          dtype=numpy.float32),
    }
    return b"".join(bytes(part)
                    for part in encode_tensor_parts(obj, codec))


def unpack_kv_payload(payload, max_message=None):
    """Parses a :func:`pack_kv_payload` buffer back into the payload
    dict, or None on malformation / unknown schema version (the
    dead-peer contract of the framing: a bad peer is dropped, never
    crashed on)."""
    obj = decode_tensor_parts(payload, max_message=max_message)
    if not isinstance(obj, dict) or \
            obj.get("fmt") != KV_WIRE_FMT:
        return None
    try:
        n = int(obj["n_blocks"])
        bs = int(obj["block_size"])
        blocks = obj["blocks"]
        tokens = obj["tokens"]
        int(obj["weight_version"])
    except (KeyError, TypeError, ValueError):
        return None
    if n < 1 or bs < 1 or blocks.ndim != 6 or \
            blocks.shape[1] != 2 or blocks.shape[2] != n or \
            blocks.shape[3] != bs or len(tokens) != n * bs:
        return None
    return obj


class PrefillWorker(object):
    """The prefill side: a dedicated paged engine whose only job is
    running prompt prefills and exporting the resulting KV blocks.

    Reuses the whole engine machinery (coalesced chunk prefill,
    prefix cache, pool accounting) instead of re-implementing the
    attention pass: a prefill is a ``max_new=1`` greedy generate —
    the engine registers the prompt's full-block prefixes in its own
    pool as a side effect, and :meth:`prefill_payload` exports them.
    Repeated prompts hit the worker's prefix cache and export
    without recompute."""

    def __init__(self, engine):
        if not getattr(engine, "paged", False):
            from ...error import Bug
            raise Bug("prefill worker needs a paged engine "
                      "(an LM artifact with the paged surface)")
        self.engine = engine

    def prefill_payload(self, tokens, codec=None):
        """Prefills ``tokens`` on the worker engine and returns the
        packed wire payload covering its full blocks, or None when
        the prompt spans no full block / the worker pool cannot hold
        it (the caller prefills locally — disaggregation is an
        optimization, never load-bearing)."""
        engine = self.engine
        tokens = numpy.ascontiguousarray(tokens, dtype=numpy.int32)
        try:
            # The export runs ON the worker's device thread (op
            # queue) — reading pool storage from this thread would
            # race the decode step's donated buffers.
            exported = engine.export_kv_prefix(tokens)
            if exported is None:
                # Cold cache (or a lazily-unbuilt pool): one greedy
                # prefill registers the prompt's full blocks — and
                # builds the pool — then re-export.
                engine.submit_generate(tokens[None], 1)
                exported = engine.export_kv_prefix(tokens)
        except Exception as e:
            engine.warning("prefill export failed (%s) — the "
                           "decode side prefills locally", e)
            engine.stats.incr("kv.prefill_shed")
            return None
        if exported is None:
            engine.stats.incr("kv.prefill_shed")
            return None
        n, blocks, block_size, weight_version = exported
        engine.stats.incr("kv.prefill_exported")
        return pack_kv_payload(tokens, n, blocks, block_size,
                               weight_version, codec=codec)

    def stop(self, drain=True, timeout=None):
        self.engine.stop(drain=drain, timeout=timeout)
