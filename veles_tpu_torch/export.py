"""Exported-model artifacts and the LM serving programs, in PyTorch.

The port of ``veles_tpu/export.py`` for causal LMs.  Three groups:

* **Artifact side** — :class:`ExportedModel` reads the JAX package's
  artifact (a tar.gz of ``manifest.json``, ``weights.npz`` and
  ``model.bin``, with the same format/version checks), and
  :func:`write_artifact` writes the same three members the JAX
  package's ``export_workflow`` packs, so either package loads what
  the other wrote.  :class:`KVBlockPool` is the JAX package's host-side
  block accounting, copied whole: refcounts, the prefix sha1 chain,
  copy-on-write, TRASH block 0.
* **Device side** — the LM chain's ``forward``, ``generate``,
  ``generate_bucketed`` (the engine's whole-request path) and the
  paged programs ``paged_extend`` / ``paged_step`` / ``paged_verify``
  (speculative decoding's K+1-row chunks) over per-layer
  ``(n_blocks, block_size, H, D)`` pool tensors in one of four KV
  storage planes (``KV_DTYPES``): f32, a scale-free bf16 cast, and
  int8 / fp8-e4m3 codes with per-(block, head) float32 scales.  A
  row's results never depend on how many rows share its call: every
  product of a decode chunk (a step, a verify, a short extend) runs on
  exactly ``DECODE_ROWS`` rows (:func:`_mm` — a BLAS or cuBLAS product
  picks its method by the row count, and its one-row path rounds
  otherwise), the layer norm computes each row alone, and an extend
  runs each row by itself, on every plane.  A row's last prompt
  position always runs as a one-row chunk (:func:`extend_chunks`), the
  program a whole-prompt prefix-cache hit re-feeds, so a hit's first
  logits are its first serving's bit for bit.
  On the scaled planes what a block stores also depends on how its
  positions were grouped into writes, so there a verify runs the step
  program column by column, and a freshly allocated block starts at
  zero.  Every
  chunk of at most ``DECODE_MAX_Q`` query rows attends through the
  hand-written flash-decode kernels
  (:func:`~veles_tpu_torch.ops.decode_attention.decode_attention`: B4
  on the f32 and bf16 planes, B5 on the int8 and fp8 codes); longer
  prefill chunks use the dense masked softmax, as the JAX package does
  by design.  The decode programs run in one of two weight modes
  (``root.common.serving.weight_dtype``): f32, or weight-only int8
  matmuls with per-output-channel scales; ``forward`` stays f32.
* **Weight carry-over and swap** — :func:`lm_params_from_numpy` turns
  the JAX package's parameters (numpy arrays, as its
  ``ExportedModel.weights`` holds them) into the port's parameter
  dict; :meth:`ExportedModel.swap_weights` hot-swaps a same-geometry
  artifact's weights in place.

Not ported yet, and refused with :class:`~veles_tpu_torch.error.Bug`:
unit types other than the causal LM chain (embedding → transformer
blocks → lm_head) and KV export/adopt across pools.

Sampling: the JAX package draws from threefry keys
(``PRNGKey(seed)``, ``fold_in(gen_idx)``), whose bits torch cannot
reproduce.  The port keeps the invariant instead: one counter-based
stream per row keyed on ``(seed, gen_idx)`` (:func:`_sample_rows`),
shared by ``generate_bucketed``, ``paged_extend`` and ``paged_step``,
so paged and whole-request sampled decode agree inside the port.
Greedy decode (temperature 0) is the same argmax in both packages.
"""

import collections
import hashlib
import io
import json
import struct
import tarfile
import time

import numpy
import torch

from .backends import resolve_device
from .config import get as config_get
from .config import root
from .distributable import SniffedLock
from .error import Bug
from .json_encoders import dumps_json
from .ops.decode_attention import (DECODE_MAX_Q, MAX_HEAD_DIM,
                                   decode_attention,
                                   decode_attention_reference)
from .serving.buckets import CompileCache, bucket_of

FORMAT_NAME = "veles-tpu-model"
FORMAT_VERSION = 1
MAGIC = b"VTPM"

#: Unit types the port executes: the causal LM chain.
PORTED_UNITS = ("embedding", "transformer_block", "lm_head", "dropout")

#: Storage dtypes of the paged KV pool.  "f32" is the exact path;
#: "bf16" a scale-free cast; "int8" and "fp8" carry per-(block, head)
#: float32 scales beside the block tensors and quantize on scatter /
#: dequantize on gather (block granularity, so refcounts, COW and the
#: prefix cache's sha1 keys never see the quantization).
KV_DTYPES = ("f32", "bf16", "int8", "fp8")

#: Symmetric clip range per scaled storage dtype (None: scale-free).
_KV_QMAX = {"f32": None, "bf16": None, "int8": 127.0, "fp8": 448.0}

#: Bytes per stored k/v element.
_KV_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1, "fp8": 1}

#: The torch dtype of each storage plane.
_KV_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8, "fp8": torch.float8_e4m3fn}


def kv_dtype_supported(kv_dtype):
    """Whether the storage dtype is one the port holds (every plane of
    ``KV_DTYPES``: torch has ``float8_e4m3fn`` on every device)."""
    return kv_dtype in KV_DTYPES


def check_kv_dtype(kv_dtype):
    """Canonical KV storage dtype name (None → "f32"), or Bug naming
    the valid set for unknown names."""
    kv_dtype = "f32" if kv_dtype is None else str(kv_dtype)
    if not kv_dtype_supported(kv_dtype):
        raise Bug("unknown KV storage dtype %r — valid: %s" %
                  (kv_dtype, ", ".join(KV_DTYPES)))
    return kv_dtype


def _kv_unpack(storage):
    """``(ks, vs, sks, svs)`` from a pool storage tuple — the scale
    lists are None for scale-free (f32/bf16) pools."""
    if len(storage) == 4:
        return storage
    ks, vs = storage
    return ks, vs, None, None


def _kv_quantize(vals, scale_full, kv_dtype):
    """Quantizes float32 ``vals`` at an already-broadcast
    ``scale_full`` (zero scale → zero code, so never-written rows stay
    exact zeros).  int8 rounds half to even (``torch.round``); fp8
    clips to ±448, then the cast rounds to nearest even — both as the
    JAX package does, bit for bit."""
    qmax = _KV_QMAX[kv_dtype]
    positive = scale_full > 0.0
    safe = torch.where(positive, scale_full, 1.0)
    x = torch.clamp(vals / safe, -qmax, qmax)
    if kv_dtype == "int8":
        x = torch.round(x)
    return torch.where(positive, x, 0.0).to(_KV_TORCH[kv_dtype])


# -- artifact writer ------------------------------------------------------

def _pack_str(s):
    data = s.encode("utf-8")
    return struct.pack("<H", len(data)) + data


def _flat_config(config):
    """Flattens geometry tuples into scalar keys the native parser
    reads: padding → pt/pb/pl/pr, sliding → sh/sw."""
    flat = {}
    for key, value in config.items():
        if key == "padding":
            (pt, pb), (pl, pr) = value
            flat.update(pad_top=pt, pad_bottom=pb, pad_left=pl,
                        pad_right=pr)
        elif key == "sliding":
            sh, sw = value
            flat.update(stride_h=sh, stride_w=sw)
        elif key == "output_sample_shape":
            flat["n_out"] = int(numpy.prod(value))
        else:
            flat[key] = float(value)
    return flat


def _pack_binary(manifest, weight_arrays):
    """``model.bin``: topology and weights in the flat layout the
    native runtime parses."""
    out = [MAGIC, struct.pack("<II", FORMAT_VERSION,
                              len(manifest["units"]))]
    in_shape = manifest["input"]["sample_shape"]
    out.append(struct.pack("<I", len(in_shape)))
    out.append(struct.pack("<%dI" % len(in_shape), *in_shape))
    for entry in manifest["units"]:
        out.append(_pack_str(entry["type"]))
        out.append(_pack_str(entry["name"]))
        flat = _flat_config(entry["config"])
        out.append(struct.pack("<I", len(flat)))
        for key in sorted(flat):
            out.append(_pack_str(key))
            out.append(struct.pack("<d", float(flat[key])))
        params = entry["params"]
        out.append(struct.pack("<I", len(params)))
        for pname in sorted(params):
            arr = weight_arrays[params[pname]]
            out.append(_pack_str(pname))
            out.append(struct.pack("<I", arr.ndim))
            out.append(struct.pack("<%dI" % arr.ndim, *arr.shape))
            out.append(numpy.ascontiguousarray(
                arr, dtype=numpy.float32).tobytes())
    return b"".join(out)


def write_artifact(path, manifest, weights, compresslevel=9):
    """Writes ``manifest`` (a dict whose units name their weights by
    key) and ``weights`` ({key: float32 array}) as the JAX package's
    ``export_workflow`` packs them: ``manifest.json``, ``weights.npz``
    and ``model.bin`` in one tar.gz.  ``compresslevel`` is gzip's
    (9, the tarfile default, is what the JAX package writes; 1 is the
    fast setting for multi-GB artifacts — still a valid artifact)."""
    npz_buf = io.BytesIO()
    numpy.savez(npz_buf, **weights)
    blobs = {
        "manifest.json": dumps_json(manifest, indent=2).encode(),
        "weights.npz": npz_buf.getvalue(),
        "model.bin": _pack_binary(manifest, weights),
    }
    del npz_buf
    with tarfile.open(path, "w:gz", compresslevel=compresslevel) as tar:
        for name in list(blobs):
            blob = blobs.pop(name)
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return path


def random_lm_artifact(path, vocab, embed, n_heads, n_blocks, hidden,
                       max_position, seed=0, compresslevel=9):
    """Writes a causal-LM artifact (embedding → ``n_blocks`` pre-LN
    transformer blocks → lm_head) with random weights drawn from a
    numpy generator seeded by ``seed``: every matrix and bias with std
    1/√fan_in, LayerNorm gains 1 and shifts 0.  At that scale the
    softmax of a wide model stays spread, so attention errors show in
    the outputs.  Returns ``path``."""
    rng = numpy.random.default_rng(seed)

    def g(fan_in, *shape):
        return rng.standard_normal(shape, dtype=numpy.float32) * \
            numpy.float32(1.0 / numpy.sqrt(fan_in))

    E, HID = int(embed), int(hidden)
    weights = {"emb__weights": g(E, vocab, E),
               "emb__pos": g(E, max_position, E)}
    units = [{"name": "emb", "type": "embedding",
              "config": {"vocab_size": int(vocab), "embed_dim": E},
              "params": {"weights": "emb__weights", "pos": "emb__pos"}}]
    for b in range(int(n_blocks)):
        name = "blk%d" % b
        params = {}
        for pname, shape, fan_in in [
                ("ln1_g", (E,), None), ("ln1_b", (E,), None),
                ("wq", (E, E), E), ("bq", (E,), E),
                ("wk", (E, E), E), ("bk", (E,), E),
                ("wv", (E, E), E), ("bv", (E,), E),
                ("wo", (E, E), E), ("bo", (E,), E),
                ("ln2_g", (E,), None), ("ln2_b", (E,), None),
                ("w1", (E, HID), E), ("b1", (HID,), E),
                ("w2", (HID, E), HID), ("b2", (E,), HID)]:
            key = "%s__%s" % (name, pname)
            if fan_in is None:
                fill = 1.0 if pname.endswith("_g") else 0.0
                weights[key] = numpy.full(shape, fill, numpy.float32)
            else:
                weights[key] = g(fan_in, *shape)
            params[pname] = key
        units.append({"name": name, "type": "transformer_block",
                      "config": {"n_heads": int(n_heads), "causal": 1},
                      "params": params})
    weights["head__weights"] = g(E, E, vocab)
    units.append({"name": "head", "type": "lm_head",
                  "config": {"output_sample_shape": [int(vocab)]},
                  "params": {"weights": "head__weights"}})
    manifest = {"format": FORMAT_NAME, "version": FORMAT_VERSION,
                "workflow": "RandomLM", "checksum": "seed%d" % seed,
                "created": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
                "input": {"sample_shape": [int(max_position)],
                          "dtype": "int32"},
                "output": {"sample_shape": [int(vocab)]},
                "units": units}
    return write_artifact(path, manifest, weights,
                          compresslevel=compresslevel)


# -- paged KV cache: the block pool --------------------------------------

class KVBlockPool(object):
    """A vLLM-style block pool for the paged serving decode path:
    the device holds one fixed tensor of ``(n_blocks, block_size, H,
    D)`` k/v blocks per layer (``storage``, owned by the model that
    built the pool), and every request addresses it through a
    per-request BLOCK TABLE of physical block ids — so N concurrent
    streams of wildly different lengths share one allocation instead
    of each owning a dense ``(B, L, H, D)`` cache sized to its max.

    This object is the HOST-side half: block accounting (free list +
    per-block refcounts), the prompt-prefix cache (full-block
    prefixes keyed by token hash, LRU-bounded, each entry holding a
    ref on its blocks so a common system prompt stays resident and
    is prefilled ONCE), and copy-on-write (a row about to WRITE into
    a shared block gets a private copy first).  Device tensors are
    opaque here — the owning model supplies ``copy_fn(storage, src,
    dst) -> storage`` and updates ``storage`` through its own
    scatter/gather programs; on a scaled plane also ``reset_fn(storage,
    ids) -> storage``, run on every freshly allocated block, which
    zeroes the blocks' codes and scales: a scale only grows with
    writes, so a reused block would otherwise quantize its new owner's
    first write at its previous owner's scale, and what a row stores
    would depend on which blocks the pool happened to hand it.

    Block 0 is the TRASH block: table padding and out-of-range
    writes land there, so padded rows in a coalesced device batch
    can scatter junk without owning real blocks.  Accounting is
    lock-guarded: the engine's device thread allocates/frees while
    HTTP threads read ``occupancy()`` for ``/stats``.
    """

    TRASH = 0

    def __init__(self, n_blocks, block_size, storage=None,
                 copy_fn=None, prefix_capacity=256, kv_dtype=None,
                 block_bytes=0, reset_fn=None):
        n_blocks = int(n_blocks)
        block_size = int(block_size)
        if n_blocks < 2:
            raise Bug("a KV block pool needs >= 2 blocks (block 0 "
                      "is the trash block), got %d" % n_blocks)
        if block_size < 1:
            raise Bug("block_size must be >= 1, got %d" % block_size)
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.storage = storage
        self._copy_fn = copy_fn
        self._reset_fn = reset_fn
        # Storage dtype + per-block device bytes: immutable after
        # construction, so occupancy() reads them lock-free — only
        # the COUNTS need the lock.
        self.kv_dtype = check_kv_dtype(kv_dtype)
        self.block_bytes = int(block_bytes)
        self.prefix_capacity = int(prefix_capacity)
        self._lock = SniffedLock(name="KVBlockPool.lock")
        # LIFO free list: recently-freed blocks are re-used first
        # (their pages are warm).  Block 0 (trash) is never free.
        self._free = list(range(n_blocks - 1, 0, -1))  # guarded-by: _lock
        self._refs = {}  # guarded-by: _lock
        # digest -> tuple(block ids); OrderedDict as LRU (most
        # recently hit last).  Entries hold one ref per block.
        self._prefix = collections.OrderedDict()  # guarded-by: _lock
        self.prefix_hits = 0  # guarded-by: _lock
        self.prefix_misses = 0  # guarded-by: _lock
        self.cow_copies = 0  # guarded-by: _lock

    @property
    def usable(self):
        """Blocks available to requests (total minus trash)."""
        return self.n_blocks - 1

    def free_count(self):
        with self._lock:
            return len(self._free)

    def used_count(self):
        with self._lock:
            return self.usable - len(self._free)

    def blocks_for(self, n_tokens):
        """Blocks needed to hold ``n_tokens`` cache slots."""
        return -(-int(n_tokens) // self.block_size)

    # -- allocation ------------------------------------------------------

    def alloc(self, n):
        """``n`` fresh block ids (ref 1 each), or None when the pool
        cannot supply them even after evicting cached prefixes —
        the caller sheds load.  Prefix entries are evicted LRU-first
        under pressure: cached prompts are an optimization, never a
        reason to refuse live traffic."""
        n = int(n)
        with self._lock:
            while len(self._free) < n and self._prefix:
                _, ids = self._prefix.popitem(last=False)
                self._release_locked(ids)
            if len(self._free) < n:
                return None
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._refs[b] = 1
        if self._reset_fn is not None and out:
            self.storage = self._reset_fn(self.storage, out)
        return out

    def retain(self, ids):
        """Adds one ref per block — the generic counterpart of
        :meth:`release` for callers that hand a table to a second
        owner (``lookup_prefix``/``register_prefix`` take their own
        refs internally)."""
        with self._lock:
            for b in ids:
                if b == self.TRASH:
                    continue
                self._refs[b] += 1

    def release(self, ids):
        """Drops one ref per block; blocks at zero return to the
        free list.  Trash ids are ignored (table padding)."""
        with self._lock:
            self._release_locked(ids)

    def refs_of(self, block_id):
        """Current refcount of one block (0 for free/trash) — asked
        before writing into a table tail block whether anyone else
        holds it (refs > 1 ⇒ copy-on-write first)."""
        with self._lock:
            return self._refs.get(int(block_id), 0)

    def _release_locked(self, ids):
        for b in ids:
            if b == self.TRASH:
                continue
            left = self._refs[b] - 1
            if left:
                self._refs[b] = left
            else:
                del self._refs[b]
                self._free.append(b)

    # -- prefix sharing --------------------------------------------------

    def prefix_chain(self, tokens):
        """Chained per-block digests (digest_j = sha1(digest_{j-1} ·
        block_j tokens), the vLLM scheme): O(L) total hashing for
        every full-block prefix of a prompt, computed OUTSIDE the
        pool lock so adoption never blocks ``occupancy()`` readers
        on hashing.  Callers doing lookup-then-register pass the
        same chain to both so each prompt is hashed ONCE."""
        tokens = numpy.ascontiguousarray(tokens, dtype=numpy.int32)
        bs = self.block_size
        chain = []
        digest = b""
        for j in range(len(tokens) // bs):
            digest = hashlib.sha1(
                digest + tokens[j * bs:(j + 1) * bs].tobytes()
            ).digest()
            chain.append(digest)
        return chain

    def lookup_prefix(self, tokens, chain=None):
        """The longest cached full-block prefix of ``tokens``:
        ``(n_full_blocks_matched, block_ids)`` with one ref per
        returned block ALREADY TAKEN for the caller, or ``(0, [])``.
        Matching is by token-content hash at full-block granularity
        — a request sharing a system prompt adopts its blocks
        instead of re-prefilling them."""
        if chain is None:
            chain = self.prefix_chain(tokens)
        with self._lock:
            for j in range(len(chain), 0, -1):
                ids = self._prefix.get(chain[j - 1])
                if ids is None:
                    continue
                self._prefix.move_to_end(chain[j - 1])
                for b in ids:
                    self._refs[b] += 1
                self.prefix_hits += 1
                return j, list(ids)
            self.prefix_misses += 1
            return 0, []

    def register_prefix(self, tokens, block_ids, chain=None):
        """Registers every full-block prefix of a just-prefilled
        prompt (``block_ids`` = its table, position-ordered) so later
        requests can adopt the blocks.  Existing entries are kept
        (their blocks already hold the same content); the LRU bound
        evicts the coldest entries past ``prefix_capacity``."""
        if chain is None:
            chain = self.prefix_chain(tokens)
        with self._lock:
            for j, key in enumerate(chain, start=1):
                if key in self._prefix:
                    self._prefix.move_to_end(key)
                    continue
                ids = tuple(block_ids[:j])
                for b in ids:
                    self._refs[b] += 1
                self._prefix[key] = ids
            while len(self._prefix) > self.prefix_capacity:
                _, ids = self._prefix.popitem(last=False)
                self._release_locked(ids)

    # -- cross-pool export / adoption ------------------------------------

    def export_prefix_blocks(self, tokens, chain=None):
        """The longest cached full-block prefix of ``tokens`` as an
        EXPORTABLE handle: ``(n_full_blocks, block_ids)`` with one
        ref per block taken for the caller — identical contract to
        :meth:`lookup_prefix`, named for the disaggregation wire: the
        caller serializes the addressed device blocks and then MUST
        :meth:`release` the ids.  The refs pin the blocks against
        eviction/COW while their bytes are in flight."""
        return self.lookup_prefix(tokens, chain=chain)

    def adopt_prefix_blocks(self, tokens, n_blocks, write_fn=None,
                            chain=None):
        """Adopts ``n_blocks`` full blocks of remotely-prefilled KV
        into THIS pool's prefix cache: allocates destination blocks,
        lets ``write_fn(ids)`` scatter the shipped tensor data into
        them, then registers every full-block prefix so the next local
        request with the same prompt adopts the blocks instead of
        re-prefilling.

        Refcount-correct by construction: after registration the
        alloc refs are RELEASED, so the prefix-cache entries are the
        only owners — block ``j`` (0-based) is held by entries
        ``j+1 .. n`` exactly as a locally-prefilled prefix would be,
        and LRU eviction / ``drop_prefixes`` return the blocks to the
        free list with no residue.  Idempotent: if the full chain is
        already cached the existing ids are returned untouched.
        Returns the block ids, or None when the pool cannot supply
        ``n_blocks`` even after evicting colder prefixes (the caller
        skips adoption — it is an optimization, never load-bearing)."""
        if chain is None:
            chain = self.prefix_chain(tokens)
        n_blocks = min(int(n_blocks), len(chain))
        if n_blocks <= 0:
            return []
        with self._lock:
            ids = self._prefix.get(chain[n_blocks - 1])
            if ids is not None:
                self._prefix.move_to_end(chain[n_blocks - 1])
                return list(ids)
        ids = self.alloc(n_blocks)
        if ids is None:
            return None
        if write_fn is not None:
            try:
                write_fn(ids)
            except Exception:
                self.release(ids)
                raise
        bs = self.block_size
        tokens = numpy.ascontiguousarray(tokens,
                                         dtype=numpy.int32)
        self.register_prefix(tokens[:n_blocks * bs], ids,
                             chain=chain[:n_blocks])
        self.release(ids)
        return ids

    # -- copy-on-write ---------------------------------------------------

    def cow_copy(self, block_id):
        """Copy-on-write: a fresh private block holding a device copy
        of ``block_id``'s content (the caller is about to WRITE into
        a position that falls inside a shared block — e.g. a fully
        prefix-cached prompt re-feeding its last token).  The caller
        keeps responsibility for releasing its ref on the shared
        original.  Returns the new id, or None when the pool is
        exhausted."""
        ids = self.alloc(1)
        if ids is None:
            return None
        if self._copy_fn is not None:
            self.storage = self._copy_fn(self.storage, int(block_id),
                                         int(ids[0]))
        with self._lock:
            self.cow_copies += 1
        return ids[0]

    def drop_prefixes(self):
        """Releases every cached prompt-prefix entry (blocks return
        to the free list once unreferenced) and returns how many were
        dropped.  Live rows keep their tables — only the cache is
        invalidated."""
        with self._lock:
            dropped = len(self._prefix)
            while self._prefix:
                _, ids = self._prefix.popitem(last=False)
                self._release_locked(ids)
            return dropped

    # -- observability ---------------------------------------------------

    def occupancy(self):
        """The ``/stats`` pool section: block occupancy plus prefix-
        cache and COW counters, and the BYTES the blocks occupy
        (blocks × block geometry × storage dtype)."""
        with self._lock:
            used = self.usable - len(self._free)
            return {
                "block_size": self.block_size,
                "blocks_total": self.usable,
                "blocks_free": len(self._free),
                "blocks_used": used,
                "storage_dtype": self.kv_dtype,
                "block_bytes": self.block_bytes,
                "bytes_total": self.usable * self.block_bytes,
                "bytes_used": used * self.block_bytes,
                "prefix_entries": len(self._prefix),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "cow_copies": self.cow_copies,
            }


# -- the LM chain and its parameters --------------------------------------

def lm_chain(units):
    """(embedding, [blocks], lm_head) entries of a unit table, or Bug
    when it is not a causal LM.  Dropout entries are inert at
    inference and skipped."""
    entries = [e for e in units if e["type"] != "dropout"]
    if any(e["type"] == "moe_transformer_block" for e in entries):
        raise Bug("moe_transformer_block is not yet ported")
    if len(entries) < 3 or entries[0]["type"] != "embedding" or \
            entries[-1]["type"] != "lm_head" or \
            any(e["type"] != "transformer_block"
                for e in entries[1:-1]):
        raise Bug(
            "the torch port serves an embedding → transformer_block* "
            "→ lm_head chain; artifact has %s" %
            [e["type"] for e in units])
    for e in entries[1:-1]:
        if not e["config"].get("causal", 1):
            raise Bug("generation requires causal attention "
                      "(block %s is bidirectional)" % e["name"])
    return entries[0], entries[1:-1], entries[-1]


def lm_params_from_numpy(units, weights, device):
    """The port's LM parameter dict from the JAX package's parameters
    (``{key: numpy array}`` as ``veles_tpu.export.ExportedModel
    .weights`` holds them, addressed through the unit table):
    ``emb_w``, ``emb_pos``, ``head_w``, ``head_b`` (None without a head
    bias) and ``blocks`` — one ``{param name: tensor}`` per block —
    as float32 tensors on ``device``.  The same structure and values
    as the JAX package's ``ExportedModel._lm_params()``."""
    emb, blocks, head = lm_chain(units)
    device = resolve_device(device).torch_device

    def t(key):
        return torch.from_numpy(numpy.ascontiguousarray(
            weights[key], dtype=numpy.float32)).to(device)

    return {
        "emb_w": t(emb["params"]["weights"]),
        "emb_pos": t(emb["params"]["pos"]),
        "head_w": t(head["params"]["weights"]),
        "head_b": t(head["params"]["bias"])
        if "bias" in head["params"] else None,
        "blocks": [{n: t(e["params"][n]) for n in e["params"]}
                   for e in blocks],
    }


# -- shared LM decode helpers ---------------------------------------------
# ONE implementation of the block, the head projection and the per-row
# select, shared by forward, the dense bucketed programs and the paged
# extend/step programs.

#: Rows of every product of a decode chunk: a BLAS or cuBLAS product
#: chooses its method by the row count (the CPU's one-row path rounds
#: differently from two rows and more; cuBLAS at 8 rows from 40, and a
#: batched product with the batch count), so the rows go through in
#: products of exactly this many.  16 rows cost a step of 8 nothing
#: measurable and a verify of 8 rows x 5 columns three products.
DECODE_ROWS = 16


def extend_chunks(n):
    """The chunk lengths :meth:`ExportedModel.paged_extend` runs a row's
    ``n`` new tokens in: one chunk of at most ``DECODE_MAX_Q`` rows;
    else the first ``n − 1`` rows (a dense prefill chunk) and then the
    last position alone.  A whole-prompt prefix-cache hit re-feeds only
    the prompt's last token, a one-row chunk whose products and
    attention take the decode path; ending every longer chunk with the
    same one-row program makes the hit compute the position as the
    prompt's first serving did, bit for bit (chunks of at most
    ``DECODE_MAX_Q`` rows already do: each of their rows is computed
    alone)."""
    return [n] if n <= DECODE_MAX_Q else [n - 1, 1]


def _ln(v, g, b, eps=1e-5):
    """Layer norm, ``(v − mean)·rsqrt(var + eps)·g + b`` over the last
    dim: one kernel that computes each row alone, so a row's result does
    not depend on how many rows share the call."""
    return torch.nn.functional.layer_norm(v, v.shape[-1:], g, b, eps)


def _attend(q, kc, vc, key_mask, attend=decode_attention, k_scale=None,
            v_scale=None):
    """The seam: chunks of at most ``DECODE_MAX_Q`` query rows go
    through ``attend`` (the flash-decode wrapper in serving), longer
    ones (prefills) through the dense masked softmax, by design, as in
    the JAX package's ``_paged_block``.  Given scales, k/v are stored
    codes: ``attend`` receives them with their per-position scales
    (B5 on the card), the dense path dequantizes."""
    if q.shape[1] <= DECODE_MAX_Q:
        if k_scale is None:
            return attend(q, kc, vc, key_mask)
        return attend(q, kc, vc, key_mask, k_scale=k_scale,
                      v_scale=v_scale)
    return decode_attention_reference(q, kc, vc, key_mask, k_scale,
                                      v_scale)


def _mm(h, p, name):
    """``h @ W`` for a decode-program weight.  The rows of a decode
    chunk — at most ``DECODE_MAX_Q`` positions a sequence: a step, a
    verify chunk, a short extend, which can compute the same position as
    one another — go through in products of exactly ``DECODE_ROWS``
    rows, the last one zero-padded, so each row's result is a function
    of the row alone, whatever the call's row count; a longer prefill
    chunk, which an extend runs alone for its row, is one product.  When
    the parameter dict carries a ``<name>__s`` per-output-channel scale
    (the weight-only int8 plane), the int8 weight is widened for the
    product and the scale applies to the result — ``(h @ W.float()) *
    s``, as the JAX package computes it outside any kernel; the widened
    copy lives for the one product only."""
    s = p.get(name + "__s")
    w = p[name] if s is None else p[name].to(s.dtype)
    if h.dim() == 3 and h.shape[1] > DECODE_MAX_Q:
        y = h @ w
    else:
        rows = h.reshape(-1, h.shape[-1])
        n = rows.shape[0]
        if n % DECODE_ROWS:
            rows = torch.nn.functional.pad(
                rows, (0, 0, 0, DECODE_ROWS - n % DECODE_ROWS))
        chunks = rows.split(DECODE_ROWS)
        y = chunks[0] @ w if len(chunks) == 1 else \
            torch.cat([c @ w for c in chunks])
        y = y[:n].reshape(*h.shape[:-1], w.shape[-1])
    return y if s is None else y * s


def _block(p, x, n_heads, attn_fn):
    """One pre-LN transformer block: ``x + MHA(LN(x))``, then
    ``+ MLP(LN(·))``.  ``attn_fn(q, k, v)`` takes the chunk's
    ``(B, S, H, D)`` projections and returns its attention output —
    it owns the cache write and the key table (none, dense cache or
    block pool)."""
    B, S, E = x.shape
    H = n_heads
    D = E // H
    h = _ln(x, p["ln1_g"], p["ln1_b"])
    if "wqkv" in p:
        # Fused-QKV artifact: one head-major (E, 3E) projection.
        qkv = (_mm(h, p, "wqkv") + p["bqkv"]).reshape(B, S, H, 3, D)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    else:
        q = (_mm(h, p, "wq") + p["bq"]).reshape(B, S, H, D)
        k = (_mm(h, p, "wk") + p["bk"]).reshape(B, S, H, D)
        v = (_mm(h, p, "wv") + p["bv"]).reshape(B, S, H, D)
    attn = attn_fn(q, k, v)
    x = x + _mm(attn.reshape(B, S, E), p, "wo") + p["bo"]
    h = _ln(x, p["ln2_g"], p["ln2_b"])
    return x + _mm(torch.relu(_mm(h, p, "w1") + p["b1"]), p, "w2") + \
        p["b2"]


def _head_logits(x_last, params):
    """The lm_head projection of the decode programs (its int8 weight
    and per-output-channel scale under the int8 weight mode)."""
    y = _mm(x_last, params, "head_w")
    return y + params["head_b"] if params["head_b"] is not None else y


_MASK32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer finalizer on int64 tensors (products stay
    below 2^63, so CPU and CUDA agree bit for bit)."""
    x = x & _MASK32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _MASK32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _MASK32
    return x ^ (x >> 16)


def _row_uniforms(seeds, gen_idx, n):
    """(B, n) uniforms in (0, 1), a counter-based function of each
    row's ``(seed, gen_idx)`` and the column: the port's per-row
    sampling stream."""
    cols = torch.arange(n, device=seeds.device, dtype=torch.int64)
    key = _mix32(_mix32(seeds.to(torch.int64))
                 ^ (gen_idx.to(torch.int64) * 0x27D4EB2F))
    bits = _mix32(key[:, None] ^ _mix32(cols[None, :] + 0x165667B1))
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _sample_rows(logits, seeds, gen_idx, temps):
    """Greedy (temperature 0) or temperature sampling per row: the
    sampled rows take the Gumbel-max of ``logits / T`` under the
    row's ``(seed, gen_idx)`` stream.  ``temps`` None means every row
    is greedy (decided on the host, so no device sync is needed)."""
    greedy = torch.argmax(logits, dim=-1)
    if temps is None:
        return greedy
    u = _row_uniforms(seeds, gen_idx, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temps > 0.0, sampled, greedy)


# -- execution from the artifact ----------------------------------------

class ExportedModel(object):
    """Loads an artifact and serves its causal-LM chain on ``device``
    ("cuda" unless the caller asks for "cpu"; a missing card raises).

    Pool updates are IN PLACE: the paged programs scatter each chunk's
    k/v into the pool's per-layer tensors and copy-on-write copies
    blocks inside them, so the pool costs one allocation for its whole
    life (the JAX package rebuilds the arrays functionally and donates
    the old buffers)."""

    def __init__(self, path, device="cuda", compile_capacity=32):
        self.device = resolve_device(device)
        self.torch_device = self.device.torch_device
        if hasattr(path, "read"):
            tar = tarfile.open(fileobj=path, mode="r|gz")
            self.path = getattr(path, "name", None)
        else:
            tar = tarfile.open(path, "r|gz")
            self.path = path
        # One streaming pass: the members are read in archive order
        # and the pass stops once both are in hand, so the trailing
        # model.bin (a second copy of the weights for the native
        # runtime) is never decompressed.
        blobs = {}
        with tar:
            for member in tar:
                if member.name in ("manifest.json", "weights.npz"):
                    blobs[member.name] = tar.extractfile(member).read()
                    if len(blobs) == 2:
                        break
        missing = {"manifest.json", "weights.npz"} - set(blobs)
        if missing:
            raise Bug("%s lacks %s" % (path, ", ".join(sorted(missing))))
        self.manifest = json.loads(blobs["manifest.json"])
        if self.manifest.get("format") != FORMAT_NAME:
            raise Bug("%s is not a %s artifact" % (path, FORMAT_NAME))
        if self.manifest.get("version", 0) > FORMAT_VERSION:
            raise Bug("artifact version %s is newer than this "
                      "runtime (%d)" % (self.manifest.get("version"),
                                        FORMAT_VERSION))
        self.units = self.manifest["units"]
        for entry in self.units:
            if entry["type"] not in PORTED_UNITS:
                raise Bug("unit type %r (unit %s) is not yet ported — "
                          "the torch port serves causal LMs" %
                          (entry["type"], entry["name"]))
        lm_chain(self.units)
        self.weights = dict(numpy.load(io.BytesIO(
            blobs.pop("weights.npz"))))
        self.input_shape = tuple(
            self.manifest["input"]["sample_shape"])
        #: Per-shape accounting of the entry points (hits/misses feed
        #: ``/stats``); the port runs eagerly and builds nothing.
        self.compile_cache = CompileCache(capacity=int(compile_capacity))
        #: Monotonically increasing weight generation: 1 at load,
        #: bumped by every :meth:`swap_weights`.
        self.weight_version = 1
        _, H, D = self._paged_geometry()
        if D > MAX_HEAD_DIM:
            raise Bug("head dim %d exceeds the decode kernel's maximum "
                      "(%d)" % (D, MAX_HEAD_DIM))
        self._device = None
        self._lm_params_cache = None

    @property
    def max_position(self):
        """The LM positional-table size (prompt+generated tokens must
        fit)."""
        emb, _, _ = lm_chain(self.units)
        return int(self.weights[emb["params"]["pos"]].shape[0])

    # ---- weights: the decode weight mode and hot swap -----------------

    def _device_weights(self):
        """The float32 parameter dict on the model's device — one
        upload per weight generation; ``forward`` reads it as it is."""
        if self._device is None:
            self._device = lm_params_from_numpy(
                self.units, self.weights, self.device)
        return self._device

    @staticmethod
    def _decode_weight_mode():
        """The weight plane of the decode programs:
        ``root.common.serving.weight_dtype`` — "f32" (default) or
        "int8" (weight-only int8 matmuls with per-output-channel
        scales).  ``forward`` never quantizes: it stays the f32 oracle.
        The mode rides every decode compile-cache key."""
        mode = str(config_get(root.common.serving.weight_dtype, "f32"))
        if mode not in ("f32", "int8"):
            raise Bug("unknown decode weight dtype %r — valid: f32, "
                      "int8" % (mode,))
        return mode

    #: 2-D decode matmul weights that ride the weight-only int8 plane
    #: (embeddings are gathers, norms and biases stay f32).
    _WQ_NAMES = ("wq", "wk", "wv", "wqkv", "wo", "w1", "w2")

    @staticmethod
    def _quantize_weight(d, name):
        """Per-output-channel symmetric int8: ``W ≈ Q · s`` with
        ``s = amax(|W|, axis=0) / 127`` — stored as ``<name>`` (int8)
        plus ``<name>__s`` (f32 row vector).  Zero columns quantize to
        zero codes with zero scale, an exact round trip."""
        w = d.get(name)
        if w is None or w.ndim != 2:
            return
        s = torch.amax(torch.abs(w), dim=0) / 127.0
        safe = torch.where(s > 0.0, s, 1.0)
        d[name] = torch.clamp(torch.round(w / safe), -127,
                              127).to(torch.int8)
        d[name + "__s"] = s

    def _lm_params(self):
        """The decode programs' parameter dict under the current weight
        mode, cached per mode and dropped by :meth:`swap_weights` — so a
        hot swap re-quantizes: the swapped weights rebuild it, on the
        thread that runs the decode programs."""
        mode = self._decode_weight_mode()
        cached = self._lm_params_cache
        if cached is None or cached[0] != mode:
            dev = self._device_weights()
            params = dict(dev, blocks=[dict(bp) for bp in dev["blocks"]])
            if mode == "int8":
                with torch.inference_mode():
                    for bp in params["blocks"]:
                        for name in self._WQ_NAMES:
                            self._quantize_weight(bp, name)
                    self._quantize_weight(params, "head_w")
            self._lm_params_cache = (mode, params)
        return self._lm_params_cache[1]

    def geometry_of(self):
        """The swap-compatibility fingerprint: the unit table plus
        every weight's shape.  Two artifacts with equal geometry can
        hot-swap weights in place."""
        return (self.units,
                {k: tuple(v.shape) for k, v in self.weights.items()})

    def same_geometry(self, other):
        """True when ``other``'s weights can be swapped into this model
        in place."""
        return self.geometry_of() == other.geometry_of()

    def swap_weights(self, new_weights):
        """In-place hot weight swap: replaces every parameter with the
        same-named array from ``new_weights`` and bumps
        :attr:`weight_version`.  The compile-cache accounting survives;
        the device parameters are rebuilt (and, under the int8 weight
        mode, re-quantized) at their next use.  Raises :class:`Bug` on
        any geometry mismatch (missing/extra/reshaped keys); the caller
        falls back to a full model replacement (drain-and-swap)."""
        new = {k: numpy.asarray(v, dtype=numpy.float32)
               for k, v in new_weights.items()}
        mine = {k: tuple(v.shape) for k, v in self.weights.items()}
        theirs = {k: tuple(v.shape) for k, v in new.items()}
        if mine != theirs:
            missing = sorted(set(mine) - set(theirs))
            extra = sorted(set(theirs) - set(mine))
            reshaped = sorted(
                "%s %s->%s" % (k, mine[k], theirs[k])
                for k in set(mine) & set(theirs)
                if mine[k] != theirs[k])
            raise Bug(
                "weight geometry mismatch — in-place swap impossible"
                " (missing: %s; new: %s; reshaped: %s)" %
                (missing or "-", extra or "-", reshaped or "-"))
        self.weights = new
        self._device = None
        self._lm_params_cache = None
        self.weight_version += 1
        return self.weight_version

    def _tensor(self, array, dtype):
        return torch.as_tensor(numpy.array(array), dtype=dtype,
                               device=self.torch_device)

    def _temps(self, temps):
        """Per-row temperatures on the device, or None when every row
        is greedy."""
        temps = numpy.asarray(temps, dtype=numpy.float32)
        if not (temps > 0.0).any():
            return None
        return self._tensor(temps, torch.float32)

    def _lm_static(self):
        """(n_heads per block, positional-table size, vocab size)."""
        emb, blocks, _head = lm_chain(self.units)
        n_heads = [int(e["config"]["n_heads"]) for e in blocks]
        P = int(self.weights[emb["params"]["pos"]].shape[0])
        V = int(self.weights[emb["params"]["weights"]].shape[0])
        return n_heads, P, V

    # ---- forward ------------------------------------------------------

    def forward(self, x):
        """The LM chain over token ids ``x`` (B, S): returns the (B, S,
        V) logits as numpy, every block under the causal mask."""
        tokens = self._tensor(numpy.asarray(x, dtype=numpy.float32),
                              torch.float32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        params = self._device_weights()
        n_heads, P, V = self._lm_static()
        B, S = tokens.shape
        if S > P:
            raise Bug("sequence of %d tokens exceeds the model's "
                      "positional table (%d)" % (S, P))
        with torch.inference_mode():
            t = torch.clamp(tokens.to(torch.int64), 0, V - 1)
            x = params["emb_w"][t] + params["emb_pos"][:S]
            causal = torch.tril(torch.ones(
                (S, S), dtype=torch.bool,
                device=self.torch_device)).expand(B, S, S)
            for p, H in zip(params["blocks"], n_heads):
                x = _block(p, x, H, lambda q, k, v: decode_attention_reference(
                    q, k, v, causal))
            y = _head_logits(x, params)
        return y.cpu().numpy()

    def forward_bucketed(self, x, batch_bucket):
        """Serving forward with the batch dim padded up to
        ``batch_bucket`` (zeros — rows are independent, pad outputs
        are dropped)."""
        x = numpy.asarray(x, dtype=numpy.float32)
        if x.ndim == 1:
            x = x[None]
        n = x.shape[0]
        batch_bucket = max(int(batch_bucket), n)
        if batch_bucket > n:
            x = numpy.concatenate(
                [x, numpy.zeros((batch_bucket - n,) + x.shape[1:],
                                numpy.float32)], axis=0)
        self.compile_cache.get_or_build(
            ("fwd",) + tuple(x.shape), lambda: True)
        return self.forward(x)[:n]

    # ---- dense-cache generation ---------------------------------------

    @staticmethod
    def _cached_block(p, x, ck, cv, start, n_heads, key_mask=None,
                      attend=decode_attention):
        """One pre-LN block over the chunk of positions
        [start, start+S) against a (B, L, H, D) cache: the chunk's k/v
        are written into the cache IN PLACE, then the queries attend
        the whole cache under ``key_mask`` (B, S, L), or the global
        causal mask when it is None (unfilled positions lie in the
        masked future)."""
        B, S, _ = x.shape
        L = ck.shape[1]
        if key_mask is None:
            qpos = start + torch.arange(S, device=x.device)
            key_mask = (qpos[:, None] >= torch.arange(
                L, device=x.device)[None, :])[None].expand(B, S, L)

        def attn_fn(q, kn, vn):
            ck[:, start:start + S] = kn
            cv[:, start:start + S] = vn
            return _attend(q, ck, cv, key_mask, attend)

        return _block(p, x, n_heads, attn_fn)

    def generate(self, prompt, max_new_tokens, temperature=0.0,
                 seed=0, return_logits=False, attend=decode_attention):
        """Autoregressive decoding: greedy when ``temperature`` == 0,
        else temperature sampling.  Returns the (B, prompt+new) token
        array — with ``return_logits``, also the (B, new, V)
        pre-sampling logits.  The prompt length rounds up to a
        power-of-two bucket (at least 16) and rides
        :meth:`generate_bucketed`, as in the JAX package;
        ``return_logits`` runs the exact prompt length.

        ``attend`` is the attention of every chunk of at most
        ``DECODE_MAX_Q`` rows: the flash-decode wrapper.  Tests and the
        chip check pass ``decode_attention_reference`` to run the same
        program with plain attention; nothing in serving reaches this
        argument."""
        prompt = numpy.atleast_2d(
            numpy.asarray(prompt, dtype=numpy.int32))
        if prompt.shape[1] < 1:
            raise Bug("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise Bug("max_new_tokens must be >= 1")
        temperature = float(temperature)
        if not numpy.isfinite(temperature) or temperature < 0.0:
            raise Bug("temperature must be finite and >= 0")
        B, S0 = prompt.shape
        max_new = int(max_new_tokens)
        limit = self.max_position
        if S0 + max_new > limit:
            raise Bug(
                "prompt %d + %d new tokens exceeds the model's "
                "positional table (%d)" % (S0, max_new, limit))
        S0b = S0 if return_logits else bucket_of(S0, floor=16,
                                                 cap=limit)
        padded = numpy.zeros((B, S0b), dtype=numpy.int32)
        padded[:, :S0] = prompt
        out = self.generate_bucketed(
            padded, numpy.full(B, S0, dtype=numpy.int32), max_new,
            temperatures=temperature,
            seeds=(int(seed) + numpy.arange(B)) & 0xFFFFFFFF,
            attend=attend, return_logits=return_logits)
        if return_logits:
            gen, logits = out
            return numpy.concatenate([prompt, gen], axis=1), logits
        return numpy.concatenate([prompt, out], axis=1)

    def generate_bucketed(self, prompts, lengths, max_new_tokens,
                          temperatures=0.0, seeds=0,
                          attend=decode_attention, return_logits=False):
        """The serving engine's coalesced whole-request decode:
        ``prompts`` (B, S0b) right-padded int32, ``lengths`` (B,) true
        prompt lengths, scalar-or-(B,) ``temperatures`` / ``seeds``.
        Returns the (B, max_new_tokens) GENERATED tokens.

        Exactness: right-padding keeps every real prompt token at its
        true position, so the causal prefill is exact for real
        positions; each decode step embeds the new token at its
        LOGICAL position (len+j per row) while writing its k/v into
        the uniform cache slot S0b+j, and the per-row key mask admits
        exactly the real prompt slots and the generated slots so far.
        Attention is permutation-invariant over key slots, so greedy
        decode matches the unpadded computation."""
        prompts = numpy.atleast_2d(
            numpy.asarray(prompts, dtype=numpy.int32))
        B, S0b = prompts.shape
        lengths = numpy.asarray(lengths, dtype=numpy.int32)
        if lengths.shape != (B,):
            raise Bug("lengths shape %s does not match batch %d" %
                      (lengths.shape, B))
        if S0b < 1 or (lengths < 1).any() or (lengths > S0b).any():
            raise Bug("prompt lengths must lie in [1, %d]" % S0b)
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise Bug("max_new_tokens must be >= 1")
        temps = numpy.ascontiguousarray(numpy.broadcast_to(
            numpy.asarray(temperatures, numpy.float32), (B,)))
        if not numpy.isfinite(temps).all() or (temps < 0.0).any():
            raise Bug("temperature must be finite and >= 0")
        seeds = numpy.ascontiguousarray(numpy.broadcast_to(
            numpy.asarray(seeds, numpy.int64) & 0xFFFFFFFF, (B,)))
        n_heads, P, V = self._lm_static()
        # max_new is a BUCKET, deliberately not validated against the
        # table: decode steps past it read clamped embeddings and
        # produce junk a caller slices away.
        if S0b > P or int(lengths.max()) >= P:
            raise Bug(
                "prompt of %d tokens exceeds the model's positional "
                "table (%d)" % (max(S0b, int(lengths.max())), P))
        self.compile_cache.get_or_build(
            ("genb", B, S0b, max_new, self._decode_weight_mode()),
            lambda: True)
        params = self._lm_params()
        dev = self.torch_device
        L = S0b + max_new
        with torch.inference_mode():
            lengths_t = self._tensor(lengths, torch.int64)
            seeds_t = self._tensor(seeds, torch.int64)
            temps_t = self._temps(temps)
            emb_w, emb_pos = params["emb_w"], params["emb_pos"]
            t = torch.clamp(self._tensor(prompts, torch.int64), 0, V - 1)
            x = emb_w[t] + emb_pos[:S0b]
            caches = []
            for p, H in zip(params["blocks"], n_heads):
                D = emb_w.shape[1] // H
                ck = torch.zeros((B, L, H, D), dtype=torch.float32,
                                 device=dev)
                cv = torch.zeros_like(ck)
                x = self._cached_block(p, x, ck, cv, 0, H,
                                       attend=attend)
                caches.append((ck, cv))
            rows = torch.arange(B, device=dev)
            idx = torch.clamp(lengths_t - 1, 0, S0b - 1)
            logits = _head_logits(x[rows, idx], params)
            tok = _sample_rows(logits, seeds_t,
                               torch.zeros_like(seeds_t), temps_t)
            toks, all_logits = [tok], [logits]
            slots = torch.arange(L, device=dev)
            for j in range(max_new - 1):
                slot = S0b + j
                posn = torch.clamp(lengths_t + j, 0, P - 1)
                xj = (emb_w[torch.clamp(tok, 0, V - 1)] +
                      emb_pos[posn])[:, None]
                kmask = ((slots[None, :] < lengths_t[:, None]) |
                         ((slots[None, :] >= S0b) &
                          (slots[None, :] <= slot)))[:, None, :]
                for (ck, cv), p, H in zip(caches, params["blocks"],
                                          n_heads):
                    xj = self._cached_block(p, xj, ck, cv, slot, H,
                                            key_mask=kmask,
                                            attend=attend)
                logits = _head_logits(xj[:, 0], params)
                tok = _sample_rows(
                    logits, seeds_t, torch.full_like(seeds_t, j + 1),
                    temps_t)
                toks.append(tok)
                all_logits.append(logits)
            gen = torch.stack(toks, dim=1).to(torch.int32).cpu().numpy()
            if return_logits:
                return gen, torch.stack(all_logits, dim=1).cpu().numpy()
        return gen

    # ---- paged serving decode (block-pool KV cache) -------------------

    def _paged_geometry(self):
        """(n_layers, n_heads, head_dim) of the LM chain, or Bug —
        the paged pool stacks every layer's blocks in one per-layer
        tensor list, so the head geometry must be uniform."""
        emb, blocks, _ = lm_chain(self.units)
        heads = {int(e["config"]["n_heads"]) for e in blocks}
        if len(heads) != 1:
            raise Bug("paged decode requires a uniform head count "
                      "across blocks, got %s" % sorted(heads))
        H = heads.pop()
        E = int(self.weights[emb["params"]["weights"]].shape[1])
        if E % H:
            raise Bug("embed dim %d not divisible by %d heads" %
                      (E, H))
        return len(blocks), H, E // H

    def make_kv_pool(self, n_blocks, block_size=16, kv_dtype=None):
        """A :class:`KVBlockPool` backed by per-layer device tensors of
        ``(n_blocks, block_size, H, D)`` k/v blocks — the paged
        substrate of the serving engine's decode-step batching.
        ``kv_dtype`` picks the storage plane (default: the
        ``root.common.serving.kv_dtype`` config, "f32"): "f32" is the
        exact path, "bf16" a scale-free cast, "int8"/"fp8" codes with
        per-(block, head) float32 scale tensors ``(n_blocks, H)`` beside
        the blocks (storage ``(ks, vs, sks, svs)``; ``block_bytes``
        counts the scales; a freshly allocated block is zeroed)."""
        if kv_dtype is None:
            kv_dtype = config_get(root.common.serving.kv_dtype, "f32")
        kv_dtype = check_kv_dtype(kv_dtype)
        L, H, D = self._paged_geometry()
        n, bs = int(n_blocks), int(block_size)
        dev = self.torch_device
        ks = [torch.zeros((n, bs, H, D), dtype=_KV_TORCH[kv_dtype],
                          device=dev) for _ in range(L)]
        vs = [torch.zeros_like(k) for k in ks]
        block_bytes = 2 * L * bs * H * D * _KV_ITEMSIZE[kv_dtype]
        if _KV_QMAX[kv_dtype] is not None:
            sks = [torch.zeros((n, H), dtype=torch.float32, device=dev)
                   for _ in range(L)]
            svs = [torch.zeros_like(t) for t in sks]
            storage = (ks, vs, sks, svs)
            block_bytes += 2 * L * H * 4
        else:
            storage = (ks, vs)
        return KVBlockPool(n_blocks, block_size, storage=storage,
                           copy_fn=self._kv_copy_block,
                           kv_dtype=kv_dtype, block_bytes=block_bytes,
                           reset_fn=self._kv_reset_blocks
                           if len(storage) == 4 else None)

    @staticmethod
    def _kv_copy_block(storage, src, dst):
        """Copy-on-write of one block, in place in every layer's
        tensors — on a quantized pool the scale rows copy with the
        codes, bit for bit, so the copy dequantizes to exactly the
        shared original's values."""
        with torch.inference_mode():
            for tensors in storage:
                for t in tensors:
                    t[dst].copy_(t[src])
        return storage

    @staticmethod
    def _kv_reset_blocks(storage, ids):
        """Zeroes blocks ``ids`` — codes and scale rows — in every layer
        of a scaled pool, in place, so a reused block is what a fresh
        pool's is: its first write quantizes at its own amax."""
        ks, vs, sks, svs = storage
        idx = torch.as_tensor(ids, dtype=torch.int64, device=ks[0].device)
        with torch.inference_mode():
            for t in list(ks) + list(vs):
                t.view(torch.uint8).index_fill_(0, idx, 0)
            for t in list(sks) + list(svs):
                t.index_fill_(0, idx, 0.0)
        return storage

    def export_kv_blocks(self, pool, ids):
        """KV export to another pool (prefill/decode disaggregation) —
        not yet ported."""
        raise Bug("KV export/adopt (export_kv_blocks) is not yet ported")

    def import_kv_blocks(self, pool, ids, blocks):
        """KV adoption from another pool — not yet ported."""
        raise Bug("KV export/adopt (import_kv_blocks) is not yet ported")

    def _write_index(self, tables, start, n_cols, n_real, bs):
        """Where a chunk's k/v go, computed on the host from host
        arrays: ``(wblock, wslot, written)`` device tensors — per row
        and chunk column the physical block and in-block slot of
        position ``start + column`` (clipped to the table), and the
        sorted distinct blocks written.  Columns at or past a row's
        ``n_real`` write to the TRASH block: tables cover exactly the
        row's real span, so a clipped junk column could land on a real
        slot, and a scatter whose duplicate indices carry different
        values is order-undefined."""
        T = tables.shape[1]
        offs = numpy.arange(n_cols)
        wpos = numpy.clip(numpy.asarray(start)[:, None] + offs[None, :],
                          0, T * bs - 1)
        wblock = numpy.take_along_axis(tables, wpos // bs, axis=1)
        wblock = numpy.where(offs[None, :] < numpy.asarray(n_real)[:, None],
                             wblock, KVBlockPool.TRASH)
        return (self._tensor(wblock, torch.int64),
                self._tensor(wpos % bs, torch.int64),
                self._tensor(numpy.unique(wblock), torch.int64))

    @staticmethod
    def _quantized_write(codes, scales, vals, wblock, wslot, written,
                         kv_dtype):
        """The quantized plane's scatter, in place, in the JAX
        package's four steps: (1) scatter-max ``amax / qmax`` of the
        chunk's values into the written blocks' scales; (2) rescale the
        written blocks' stored codes by old / new scale (rounded for
        int8) — a block whose scale did not grow has a ratio of exactly
        1.0, an exact code round trip; blocks the chunk does not write
        are not touched, so a shared prefix block stays bit-stable;
        (3) quantize the chunk at the grown scales and scatter it.  The
        old codes and scales are read before any write of the step.
        (4), the gather, is the caller's."""
        qmax = _KV_QMAX[kv_dtype]
        H = scales.shape[1]
        amax = torch.amax(torch.abs(vals), dim=-1) / qmax  # (B, S, H)
        old = scales[written]
        old_codes = codes[written].to(torch.float32)
        scales.scatter_reduce_(
            0, wblock.reshape(-1, 1).expand(-1, H), amax.reshape(-1, H),
            "amax", include_self=True)
        new = scales[written]
        ratio = old / torch.where(new > 0.0, new, 1.0)
        rescaled = old_codes * ratio[:, None, :, None]
        if kv_dtype == "int8":
            rescaled = torch.round(rescaled)
        codes[written] = rescaled.to(codes.dtype)
        codes[wblock, wslot] = _kv_quantize(
            vals, scales[wblock][..., None], kv_dtype)

    @classmethod
    def _paged_block(cls, p, x, pk, pv, tables, write, key_mask, n_heads,
                     attend=decode_attention, sk=None, sv=None,
                     kv_dtype="f32"):
        """One pre-LN block against the POOLED cache: the chunk's k/v
        scatter IN PLACE to ``write`` = ``(wblock, wslot, written)``
        (physical block and in-block slot per row AND chunk position,
        so rows at different sequence positions share one batch), then
        the whole table is gathered back ``(B, T·bs, H, D)`` and the
        queries attend it under ``key_mask``.  On the bf16 plane the
        gather is widened to float32 (B4); on the int8/fp8 planes
        (``sk``/``sv``: per-(block, head) scales) the write quantizes
        (:meth:`_quantized_write`) and the gather keeps the codes and
        broadcasts the scales to ``(B, T·bs, H)``, so ``attend`` (B5)
        dequantizes inside the kernel."""
        B = x.shape[0]
        wblock, wslot, written = write

        def attn_fn(q, kn, vn):
            T, bs, H, D = tables.shape[1], pk.shape[1], pk.shape[2], \
                pk.shape[3]
            if sk is None:
                pk[wblock, wslot] = kn.to(pk.dtype)
                pv[wblock, wslot] = vn.to(pv.dtype)
                kc = pk[tables].reshape(B, -1, H, D)
                vc = pv[tables].reshape(B, -1, H, D)
                return _attend(q, kc.to(torch.float32),
                               vc.to(torch.float32), key_mask, attend)
            cls._quantized_write(pk, sk, kn, wblock, wslot, written,
                                 kv_dtype)
            cls._quantized_write(pv, sv, vn, wblock, wslot, written,
                                 kv_dtype)

            def per_position(scales):
                return scales[tables][:, :, None, :].expand(
                    B, T, bs, H).reshape(B, T * bs, H)

            return _attend(q, pk[tables].reshape(B, -1, H, D),
                           pv[tables].reshape(B, -1, H, D), key_mask,
                           attend, per_position(sk), per_position(sv))

        return _block(p, x, n_heads, attn_fn)

    def _paged_layers(self, pool, params, x, tables_t, write, key_mask,
                      attend):
        """The chunk through every block against ``pool``'s planes."""
        n_heads, _, _ = self._lm_static()
        ks, vs, sks, svs = _kv_unpack(pool.storage)
        for i, (p, H) in enumerate(zip(params["blocks"], n_heads)):
            x = self._paged_block(
                p, x, ks[i], vs[i], tables_t, write, key_mask, H, attend,
                sks[i] if sks is not None else None,
                svs[i] if svs is not None else None, pool.kv_dtype)
        return x

    def _paged_key(self, kind, pool, *shape):
        """The compile-cache key of a paged entry point: its shape, the
        pool geometry and both quantization modes."""
        self.compile_cache.get_or_build(
            (kind,) + shape + (pool.n_blocks, pool.block_size,
                               pool.kv_dtype, self._decode_weight_mode()),
            lambda: True)

    def paged_extend(self, pool, tables, tokens, prior, chunk_lens,
                     temps, seeds, attend=decode_attention):
        """Prefill/extend entry point for the serving engine:
        ``tables`` (B, T) int32 block tables (trash-padded),
        ``tokens`` (B, Sc) right-padded chunk tokens, ``prior`` (B,)
        cached positions per row, ``chunk_lens`` (B,) real chunk
        lengths.  Each row's real tokens are embedded at logical
        positions ``prior + i``, their k/v scattered into the row's
        table blocks, and the chunk attends the pool causally over
        absolute positions — ``prior = 0`` is a fresh prefill,
        ``prior = k·bs`` extends a shared prefix of k cached blocks.
        Updates ``pool.storage`` in place and returns the (B,) first
        generated tokens (sampling stream index 0).  ``attend`` is the
        attention of chunks of at most ``DECODE_MAX_Q`` rows (the
        kernels; tests and the chip check pass the plain version).

        Each real row (a table that is not all TRASH) runs alone, at its
        own chunk length and table span, so what it computes and stores
        is a function of the row alone, however the engine grouped the
        rows (see :meth:`paged_verify`); pad rows return 0.  A row of
        more than ``DECODE_MAX_Q`` tokens runs as two chunks
        (:func:`extend_chunks`): all but its last position, which only
        write their k/v, and then the last position alone, which
        samples — exactly the call a whole-prompt prefix-cache hit
        makes when it re-feeds the prompt's last token."""
        tables = numpy.ascontiguousarray(tables, dtype=numpy.int32)
        tokens = numpy.ascontiguousarray(tokens, dtype=numpy.int32)
        B, T = tables.shape
        self._paged_key("pext", pool, B, tokens.shape[1], T)
        prior = numpy.asarray(prior, dtype=numpy.int64)
        clens = numpy.asarray(chunk_lens, dtype=numpy.int64)
        temps = numpy.asarray(temps, dtype=numpy.float32)
        seeds = numpy.asarray(seeds)
        bs = pool.block_size
        out = numpy.zeros(B, numpy.int32)
        for r in numpy.flatnonzero((tables[:, 0] != KVBlockPool.TRASH) &
                                   (clens > 0)):
            start = 0
            for n in extend_chunks(int(clens[r])):
                at = int(prior[r]) + start
                span = min(T, -(-(at + n) // bs))
                last = start + n == clens[r]
                got = self._extend(
                    pool, tables[r:r + 1, :span],
                    tokens[r:r + 1, start:start + n],
                    numpy.array([at]), numpy.array([n]), temps[r:r + 1],
                    seeds[r:r + 1], attend, sample=last)
                start += n
            out[r] = got[0][0]
        return out

    def _extend(self, pool, tables, tokens, prior, chunk_lens, temps,
                seeds, attend, sample=True):
        """:meth:`paged_extend`'s program over one batch of rows:
        ``(first tokens, the logits they were sampled from)``, or None
        when ``sample`` is False (the chunk only writes its k/v)."""
        B, T = tables.shape
        Sc = tokens.shape[1]
        n_heads, P, V = self._lm_static()
        params = self._lm_params()
        dev = self.torch_device
        bs = pool.block_size
        with torch.inference_mode():
            prior_t = self._tensor(prior, torch.int64)
            clen_t = self._tensor(chunk_lens, torch.int64)
            qpos = prior_t[:, None] + torch.arange(Sc, device=dev)[None, :]
            t = torch.clamp(self._tensor(tokens, torch.int64), 0, V - 1)
            x = params["emb_w"][t] + \
                params["emb_pos"][torch.clamp(qpos, 0, P - 1)]
            write = self._write_index(tables, prior, Sc, chunk_lens, bs)
            key_mask = (torch.arange(T * bs, device=dev)[None, None, :]
                        <= qpos[:, :, None])
            x = self._paged_layers(pool, params, x,
                                   self._tensor(tables, torch.int64),
                                   write, key_mask, attend)
            if not sample:
                return None
            idx = torch.clamp(clen_t - 1, 0, Sc - 1)
            logits = _head_logits(x[torch.arange(B, device=dev), idx],
                                  params)
            seeds_t = self._tensor(seeds, torch.int64)
            tok0 = _sample_rows(logits, seeds_t,
                                torch.zeros_like(seeds_t),
                                self._temps(temps))
            return tok0.to(torch.int32).cpu().numpy(), logits

    def paged_step(self, pool, tables, pos, tok, gen_idx, temps,
                   seeds, attend=decode_attention):
        """One decode step for the engine's continuous batch: each
        row feeds its previous token at position ``pos`` (k/v
        scattered to table block ``pos // bs``, slot ``pos % bs``),
        attends positions 0..pos through the gathered table, and
        samples the next token at stream index ``gen_idx`` — the same
        per-row stream as ``generate_bucketed``.  Rows of DIFFERENT
        requests, lengths, and ages share one call; pad rows carry
        all-trash tables and scatter junk into block 0."""
        tables = numpy.ascontiguousarray(tables, dtype=numpy.int32)
        B, T = tables.shape
        self._paged_key("pstep", pool, B, T)
        return self._step(pool, tables, pos, tok, numpy.ones(B), gen_idx,
                          temps, seeds, attend)

    def _step(self, pool, tables, pos, tok, writes, gen_idx, temps, seeds,
              attend):
        """:meth:`paged_step`'s program; rows whose ``writes`` entry is
        0 send their k/v to the TRASH block."""
        B, T = tables.shape
        n_heads, P, V = self._lm_static()
        params = self._lm_params()
        dev = self.torch_device
        bs = pool.block_size
        with torch.inference_mode():
            pos_t = self._tensor(pos, torch.int64)
            tok_t = torch.clamp(self._tensor(tok, torch.int64), 0, V - 1)
            x = (params["emb_w"][tok_t] +
                 params["emb_pos"][torch.clamp(pos_t, 0, P - 1)])[:, None]
            write = self._write_index(tables, pos, 1, writes, bs)
            key_mask = (torch.arange(T * bs, device=dev)[None, None, :]
                        <= pos_t[:, None, None])
            x = self._paged_layers(pool, params, x,
                                   self._tensor(tables, torch.int64),
                                   write, key_mask, attend)
            logits = _head_logits(x[:, 0], params)
            tok_new = _sample_rows(
                logits, self._tensor(seeds, torch.int64),
                self._tensor(gen_idx, torch.int64),
                self._temps(temps))
            return tok_new.to(torch.int32).cpu().numpy()

    def paged_verify(self, pool, tables, pos, toks, draft_lens,
                     gen_idx, temps, seeds, attend=decode_attention):
        """Speculative verify entry point for the serving engine:
        ``toks`` (B, K+1) holds each row's current token followed by up
        to K draft tokens (``draft_lens`` true counts) at positions
        ``pos..pos+K``.  Returns the (B, K+1) TARGET tokens: column
        ``j`` sampled at stream index ``gen_idx + j``, the stream the
        plain step would use at that generation index.  The caller
        accepts the longest prefix where draft j+1 equals output j and
        feeds the output at the first mismatch as the bonus token, so
        greedy decode is the argmax over the same logits as plain
        decode, and sampled decode draws the same stream.

        On the f32 and bf16 planes the columns are one chunk (k/v
        scattered through the table like a prefill chunk) under the
        per-position causal mask; junk columns past a row's draft count
        write to the TRASH block, and K+1 <= ``DECODE_MAX_Q`` rows
        attend through ``attend`` (B4).  Every product runs on
        ``DECODE_ROWS``-row chunks, as the step's do, and the layer
        norm and B4 compute each row alone, so column j's logits are
        the plain step's bit for bit.

        On the int8/fp8 planes a block's scale grows with each write
        and re-rounds the block's codes, so what a block stores depends
        on how its positions were grouped into writes, and a rejected
        draft would grow it too: a chunk cannot store what plain decode
        stores.  There column j runs as the plain step program itself,
        at the step's shapes (B5 at one query row), and a row writes
        only while its drafts are accepted; the columns stop once every
        row has rejected, and a column a row did not reach returns -1.
        The planes then hold exactly what plain decode leaves, and the
        tokens are plain decode's, bit for bit."""
        tables = numpy.ascontiguousarray(tables, dtype=numpy.int32)
        toks = numpy.ascontiguousarray(toks, dtype=numpy.int32)
        B, T = tables.shape
        Sq = toks.shape[1]
        self._paged_key("pver", pool, B, Sq, T)
        if _KV_QMAX[pool.kv_dtype] is not None:
            return self._verify_stepwise(pool, tables, pos, toks,
                                         draft_lens, gen_idx, temps,
                                         seeds, attend)
        n_heads, P, V = self._lm_static()
        params = self._lm_params()
        dev = self.torch_device
        bs = pool.block_size
        with torch.inference_mode():
            pos_t = self._tensor(pos, torch.int64)
            qpos = pos_t[:, None] + torch.arange(Sq, device=dev)[None, :]
            t = torch.clamp(self._tensor(toks, torch.int64), 0, V - 1)
            x = params["emb_w"][t] + \
                params["emb_pos"][torch.clamp(qpos, 0, P - 1)]
            # Column 0 is the row's current token, columns 1..dlen its
            # drafts: dlen + 1 real columns.
            write = self._write_index(
                tables, pos, Sq,
                numpy.asarray(draft_lens, dtype=numpy.int64) + 1, bs)
            key_mask = (torch.arange(T * bs, device=dev)[None, None, :]
                        <= qpos[:, :, None])
            x = self._paged_layers(pool, params, x,
                                   self._tensor(tables, torch.int64),
                                   write, key_mask, attend)
            logits = _head_logits(x, params)  # (B, Sq, V)
            temps_t = self._temps(temps)
            if temps_t is None:
                out = torch.argmax(logits, dim=-1)
            else:
                seeds_t = self._tensor(seeds, torch.int64)
                gen_t = self._tensor(gen_idx, torch.int64)
                out = torch.stack([
                    _sample_rows(logits[:, j], seeds_t, gen_t + j,
                                 temps_t) for j in range(Sq)], dim=1)
            return out.to(torch.int32).cpu().numpy()

    def _verify_stepwise(self, pool, tables, pos, toks, draft_lens,
                         gen_idx, temps, seeds, attend):
        """:meth:`paged_verify` on a scaled plane: column by column
        through :meth:`_step`, each row writing while it accepts."""
        B, Sq = toks.shape
        pos = numpy.asarray(pos, dtype=numpy.int64)
        gen_idx = numpy.asarray(gen_idx, dtype=numpy.int64)
        dlens = numpy.asarray(draft_lens, dtype=numpy.int64)
        out = numpy.full((B, Sq), -1, numpy.int32)
        live = numpy.ones(B, bool)
        for j in range(Sq):
            got = self._step(pool, tables, pos + j, toks[:, j], live,
                             gen_idx + j, temps, seeds, attend)
            out[live, j] = got[live]
            if j + 1 == Sq:
                break
            live &= (dlens > j) & (got == toks[:, j + 1])
            if not live.any():
                break
        return out
