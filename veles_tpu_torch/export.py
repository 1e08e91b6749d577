"""Exported-model artifacts and the LM serving programs, in PyTorch.

The port of ``veles_tpu/export.py``.  Three groups:

* **Artifact side** — :func:`export_workflow` writes a trained
  workflow's forward chain as the JAX package's writer does (the same
  manifest keys, ``weights.npz`` keys and ``model.bin`` bytes; tar.gz
  members through :func:`write_artifact`), and :class:`ExportedModel`
  reads either package's artifact (same format/version checks) and runs
  every ``EXPORTABLE`` unit type but the MoE block: ``forward`` on the
  model's device (NHWC convolutions, ceil-mode pooling, the veles
  activations; ``norm`` through the LRN forward kernel B6 on a CUDA
  tensor), and ``forward_numpy``, the JAX package's numpy mirror of the
  native runtime, line for line.  :class:`KVBlockPool` is the JAX
  package's host-side block accounting, copied whole: refcounts, the
  prefix sha1 chain, copy-on-write, TRASH block 0.
* **Device side** — for causal LMs: the LM chain's ``forward``,
  ``generate``,
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
KV export/adopt across pools.  A ``moe_transformer_block`` artifact
runs through ``forward`` (top-1 routing at its ``capacity_factor``, as
the JAX package's does); ``generate`` refuses it as the JAX package's
does.  The decode programs and the paged surface need the causal-LM
chain (embedding → transformer blocks → lm_head); any other chain
refuses them as the JAX package's ``generate`` does.

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
from .ops import lrn as ops_lrn
from .serving.buckets import CompileCache, bucket_of

FORMAT_NAME = "veles-tpu-model"
FORMAT_VERSION = 1
MAGIC = b"VTPM"

#: Unit types the artifact format understands, with their exportable
#: numeric config keys.
EXPORTABLE = {
    "all2all": (), "all2all_tanh": (), "all2all_relu": (),
    "all2all_str": (), "all2all_sigmoid": (), "softmax": (),
    "conv": ("kx", "ky", "n_kernels"),
    "conv_tanh": ("kx", "ky", "n_kernels"),
    "conv_relu": ("kx", "ky", "n_kernels"),
    "conv_str": ("kx", "ky", "n_kernels"),
    "conv_sigmoid": ("kx", "ky", "n_kernels"),
    "max_pooling": ("kx", "ky"),
    "maxabs_pooling": ("kx", "ky"),
    "avg_pooling": ("kx", "ky"),
    "norm": ("alpha", "beta", "k", "n"),
    "dropout": (),
    "mean_disp": (),
    "activation_tanh": (), "activation_relu": (),
    "activation_str": (), "activation_sigmoid": (),
    # Long tail (reference unit_factory.cc registers every forward
    # type): RBM inference = sigmoid dense over the CD-trained
    # weights; tied-weight deconv decoders; Kohonen BMU distances.
    "rbm": (),
    "all2all_deconv": (), "all2all_deconv_sigmoid": (),
    "all2all_deconv_tanh": (),
    "kohonen": (),
    # Transformer family (no reference counterpart — the TPU build's
    # long-context extension, deployable like everything else).
    "embedding": ("vocab_size", "embed_dim"),
    "transformer_block": ("n_heads",),
    "moe_transformer_block": ("n_heads", "n_experts",
                              "capacity_factor"),
    "lm_head": (),
}

TANH_A, TANH_B = 1.7159, 0.6666

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


# -- exporting a trained workflow ------------------------------------------

def _unit_entry(unit):
    """manifest entry + {param_name: array} for one forward unit."""
    mapping = getattr(type(unit), "MAPPING", None)
    from .mean_disp_normalizer import MeanDispNormalizer
    if isinstance(unit, MeanDispNormalizer):
        mapping = "mean_disp"
    if mapping not in EXPORTABLE:
        raise Bug("unit %s (type %s, MAPPING %r) is not exportable" %
                  (unit.name, type(unit).__name__, mapping))
    config = {}
    for key in EXPORTABLE[mapping]:
        config[key] = getattr(unit, key)
    # Geometry carried uniformly when present.
    for key in ("padding", "sliding"):
        if hasattr(unit, key):
            config[key] = getattr(unit, key)
    if hasattr(unit, "output_sample_shape") and \
            unit.output_sample_shape is not None:
        config["output_sample_shape"] = list(unit.output_sample_shape)
    params = {}
    if mapping == "mean_disp":
        for pname in ("mean", "rdisp"):
            vec = getattr(unit, pname)
            vec.map_read()
            params[pname] = numpy.asarray(
                vec.mem, dtype=numpy.float32)
    elif mapping == "rbm":
        # Inference forward is h = sigmoid(v·W + c): the visible bias
        # only matters for the training-time Gibbs chain, so the
        # artifact carries weights + hidden bias and rides the dense
        # execution path (reference libVeles executes every unit as a
        # forward-only chain, unit.h:41).
        unit.weights.map_read()
        params["weights"] = numpy.asarray(unit.weights.mem,
                                          dtype=numpy.float32)
        if unit.include_bias and unit.bias:
            unit.bias.map_read()
            params["bias"] = numpy.asarray(unit.bias.mem,
                                           dtype=numpy.float32)
    elif mapping.startswith("all2all_deconv"):
        # Tied weights live on the paired encoder; the standalone
        # artifact materializes them transposed so the decoder is an
        # ordinary dense unit (y = x·Wᵀ + b  →  x·(Wᵀ) with W stored
        # pre-transposed) for every runtime.
        enc_w = unit.encoder.weights
        enc_w.map_read()
        w = numpy.asarray(enc_w.mem, dtype=numpy.float32)
        params["weights"] = numpy.ascontiguousarray(w.T)
        if unit.include_bias and unit.vbias:
            unit.vbias.map_read()
            params["bias"] = numpy.asarray(unit.vbias.mem,
                                           dtype=numpy.float32)
        config["output_sample_shape"] = [int(w.shape[0])]
    elif mapping == "kohonen":
        unit.weights.map_read()
        params["weights"] = numpy.asarray(unit.weights.mem,
                                          dtype=numpy.float32)
        config["output_sample_shape"] = [int(unit.n_neurons)]
    elif mapping == "embedding":
        for pname, vec in unit.trainables.items():
            vec.map_read()
            params[pname] = numpy.asarray(vec.mem,
                                          dtype=numpy.float32)
    elif mapping in ("transformer_block", "moe_transformer_block"):
        config["causal"] = int(unit.causal)
        for pname, vec in unit.trainables.items():
            vec.map_read()
            params[pname] = numpy.asarray(vec.mem,
                                          dtype=numpy.float32)
    elif mapping == "lm_head":
        # Tied heads materialize the embedding weights transposed so
        # the artifact is standalone (same treatment as deconv).
        if unit.tie_to is not None:
            src = unit.tie_to.weights
            src.map_read()
            w = numpy.ascontiguousarray(
                numpy.asarray(src.mem, dtype=numpy.float32).T)
        else:
            unit.weights.map_read()
            w = numpy.asarray(unit.weights.mem, dtype=numpy.float32)
        params["weights"] = w
        if unit.include_bias and unit.bias:
            unit.bias.map_read()
            params["bias"] = numpy.asarray(unit.bias.mem,
                                           dtype=numpy.float32)
        config["output_sample_shape"] = [int(w.shape[1])]
    else:
        for pname, vec in getattr(unit, "trainables", {}).items():
            if not vec:
                continue
            vec.map_read()
            params[pname] = numpy.asarray(
                vec.mem, dtype=numpy.float32)
    return {"name": unit.name, "type": mapping,
            "config": config}, params


def forward_chain(workflow):
    """The exportable forward units, in execution order.  Uses the
    ``forwards`` convention (every sample workflow defines it), with
    any normalizer between loader and first layer included."""
    chain = []
    forwards = getattr(workflow, "forwards", None)
    if not forwards:
        raise Bug("workflow %s has no .forwards chain to export"
                  % workflow.name)
    first = forwards[0]
    norm = getattr(workflow, "normalizer", None)
    if norm is not None and getattr(first, "input", None) is \
            getattr(norm, "output", None):
        chain.append(norm)
    chain.extend(forwards)
    return chain


def _expand_unit(unit):
    """One forward unit → its (entry, params) pairs.  A pipelined
    transformer stack (parameters stacked on a leading n_blocks dim)
    unstacks into n_blocks ``transformer_block`` entries: the pipeline
    is a training layout, so a stack trained under dp×pp deploys
    through the same surfaces as a sequential model."""
    from .znicz.attention import PipelinedTransformerStack
    if not isinstance(unit, PipelinedTransformerStack):
        return [_unit_entry(unit)]
    out = []
    for i in range(unit.n_blocks):
        params = {}
        for pname, vec in unit.trainables.items():
            vec.map_read()
            params[pname] = numpy.ascontiguousarray(
                numpy.asarray(vec.mem, dtype=numpy.float32)[i])
        entry = {"name": "%s_block%d" % (unit.name, i),
                 "type": "transformer_block",
                 "config": {"n_heads": unit.n_heads,
                            "causal": int(unit.causal)}}
        out.append((entry, params))
    return out


def export_workflow(workflow, path, compresslevel=9):
    """Writes the inference artifact of a trained workflow: the
    manifest keys, the ``weights.npz`` keys and the ``model.bin``
    bytes the JAX package's ``export_workflow`` writes for the same
    chain.  ``compresslevel`` is the tar.gz's (9, the JAX package's;
    lower levels write large models faster, the members unchanged)."""
    chain = forward_chain(workflow)
    units = []
    weight_arrays = {}
    for unit in chain:
        for entry, params in _expand_unit(unit):
            entry["params"] = {}
            for pname, arr in params.items():
                key = "%s__%s" % (entry["name"], pname)
                if key in weight_arrays:
                    raise Bug("duplicate weight key %r — unit names "
                              "in the chain must be unique" % key)
                weight_arrays[key] = arr
                entry["params"][pname] = key
            units.append(entry)
    for entry in units:
        shape = entry["config"].get("output_sample_shape")
        if shape is not None and len(shape) > 1:
            # model.bin flattens dense outputs to n_out; a spatial
            # dense output feeding a conv/pool would lose geometry in
            # the native runtime — refuse rather than mis-execute.
            raise Bug("unit %s has multi-dim dense output shape %s — "
                      "not representable in the native artifact" %
                      (entry["name"], shape))
    in_vec = chain[0].input
    out_vec = chain[-1].output
    manifest = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "workflow": type(workflow).__name__,
        "checksum": workflow.checksum,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "input": {"sample_shape": list(in_vec.shape[1:]),
                  # Token models declare int32; the wire format for
                  # forward() inputs stays float (values are cast).
                  "dtype": str(in_vec.dtype)},
        "output": {"sample_shape": list(out_vec.shape[1:])},
        "units": units,
    }
    return write_artifact(path, manifest, weight_arrays,
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
        # The JAX package's refusal: the routed-expert FFN has no cached
        # decode path.
        raise Bug("MoE blocks are not yet supported by generate() — "
                  "serve moe_transformer_block artifacts through "
                  "forward()")
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


def _is_lm_chain(units):
    """True when ``units`` form the causal-LM chain :func:`lm_chain`
    accepts."""
    try:
        lm_chain(units)
    except Bug:
        return False
    return True


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


def _block(p, x, n_heads, attn_fn, mlp=None):
    """One pre-LN transformer block: ``x + MHA(LN(x))``, then
    ``+ MLP(LN(·))``.  ``attn_fn(q, k, v)`` takes the chunk's
    ``(B, S, H, D)`` projections and returns its attention output —
    it owns the cache write and the key table (none, dense cache or
    block pool); ``mlp(h)`` replaces the dense MLP (the MoE block)."""
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
    if mlp is not None:
        return x + mlp(h)
    return x + _mm(torch.relu(_mm(h, p, "w1") + p["b1"]), p, "w2") + \
        p["b2"]


def _moe_mlp(p, cfg):
    """The artifact forward's MoE FFN: ``ops.moe.moe_ffn`` (top-1) at
    the entry's capacity factor over the block's tokens."""
    from .ops.moe import moe_ffn

    def mlp(h):
        B, S, E = h.shape
        y, _aux, _load = moe_ffn(
            h.reshape(B * S, E), p["router"], p["w1"], p["b1"], p["w2"],
            p["b2"], capacity_factor=float(cfg.get("capacity_factor",
                                                   1.25)))
        return y.reshape(B, S, E)
    return mlp


def _head_logits(x_last, params):
    """The lm_head projection of the decode programs (its int8 weight
    and per-output-channel scale under the int8 weight mode)."""
    y = _mm(x_last, params, "head_w")
    return y + params["head_b"] if params["head_b"] is not None else y


# -- the non-LM chain's operations -----------------------------------------

def _np_softmax(v):
    e = numpy.exp(v - v.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


#: Activation per dense-family unit type (shared by the numpy mirror and
#: the device chain).
_DENSE_ACT = {
    "all2all": "linear", "all2all_tanh": "tanh",
    "all2all_relu": "softplus", "all2all_str": "str",
    "all2all_sigmoid": "sigmoid", "softmax": "softmax",
    "rbm": "sigmoid",
    "all2all_deconv": "linear",
    "all2all_deconv_sigmoid": "sigmoid",
    "all2all_deconv_tanh": "tanh",
}

#: Activation per convolution type.
_CONV_ACT = {"conv": "linear", "conv_tanh": "tanh",
             "conv_relu": "softplus", "conv_str": "str",
             "conv_sigmoid": "sigmoid"}

_ACTS = {
    "linear": lambda v: v,
    "tanh": lambda v: TANH_A * numpy.tanh(TANH_B * v),
    "softplus": lambda v: numpy.log1p(numpy.exp(-numpy.abs(v))) +
    numpy.maximum(v, 0.0),
    "str": lambda v: numpy.maximum(v, 0.0),
    "sigmoid": lambda v: 1.0 / (1.0 + numpy.exp(-v)),
    "softmax": _np_softmax,
}

_TORCH_ACTS = {
    "linear": lambda v: v,
    "tanh": lambda v: TANH_A * torch.tanh(TANH_B * v),
    "softplus": lambda v: torch.log1p(torch.exp(-torch.abs(v))) +
    torch.clamp_min(v, 0.0),
    "str": lambda v: torch.clamp_min(v, 0.0),
    "sigmoid": torch.sigmoid,
    "softmax": lambda v: torch.softmax(v, dim=-1),
}


def _torch_act(name, v):
    return _TORCH_ACTS[name](v)


def _torch_conv(x, w, b, cfg):
    """NHWC ``x`` convolved with the HWIO kernel ``w`` at the artifact's
    sliding and (asymmetric) padding, plus ``b``."""
    (pt, pb), (pl, pr) = cfg["padding"]
    sh, sw = cfg["sliding"]
    xc = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                 (pl, pr, pt, pb))
    y = torch.nn.functional.conv2d(xc, w.permute(3, 2, 0, 1), b,
                                   stride=(sh, sw))
    return y.permute(0, 2, 3, 1)


def _torch_pool(t, cfg, x):
    """Ceil-mode pooling of NHWC ``x`` with tail padding, as the JAX
    package's ``_jax_pool``: max over ``-inf`` padding, maxabs as the
    element of the larger magnitude between the window's max and min
    (the min on a tie of magnitudes goes to the max), avg over the
    window's in-bounds population."""
    ky, kx = int(cfg["ky"]), int(cfg["kx"])
    sh, sw = cfg["sliding"]
    (pt, pb), (pl, pr) = cfg["padding"]
    H, W = x.shape[1], x.shape[2]
    out_h = -(-(H + pt + pb - ky) // sh) + 1
    out_w = -(-(W + pl + pr - kx) // sw) + 1
    need_h = (out_h - 1) * sh + ky - (H + pt)
    need_w = (out_w - 1) * sw + kx - (W + pl)
    pad = (0, 0, pl, max(pr, need_w), pt, max(pb, need_h))

    def windows(v, fill):
        vp = torch.nn.functional.pad(v, pad, value=fill)
        return vp.unfold(1, ky, sh).unfold(2, kx, sw)[:, :out_h, :out_w]

    if t == "avg_pooling":
        ssum = windows(x, 0.0).sum(dim=(-2, -1))
        cnt = windows(torch.ones_like(x), 0.0).sum(dim=(-2, -1))
        return ssum / cnt
    hi = windows(x, -numpy.inf).amax(dim=(-2, -1))
    if t == "maxabs_pooling":
        lo = windows(x, numpy.inf).amin(dim=(-2, -1))
        return torch.where(-lo > hi, lo, hi)
    return hi


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
            t = entry["type"]
            if t not in EXPORTABLE:
                raise Bug("unknown unit type %r (unit %s) in artifact" %
                          (t, entry["name"]))
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
        #: Whether the chain is a causal LM (embedding →
        #: transformer_block* → lm_head): only those have the decode
        #: programs, the paged surface and a positional table.
        self.is_lm = _is_lm_chain(self.units)
        if self.is_lm:
            _, H, D = self._paged_geometry()
            if D > MAX_HEAD_DIM:
                raise Bug("head dim %d exceeds the decode kernel's "
                          "maximum (%d)" % (D, MAX_HEAD_DIM))
        self._device = None
        self._chain_weights = None
        self._lm_params_cache = None

    @property
    def max_position(self):
        """The LM positional-table size (prompt+generated tokens must
        fit), or None when the artifact is not a causal LM."""
        if not self.is_lm:
            return None
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
        self._chain_weights = None
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
        """The artifact's forward chain on the model's device, as numpy.
        A causal LM takes token ids ``x`` (B, S) and returns the (B, S,
        V) logits, every block under the causal mask; any other chain
        takes samples of the manifest's input shape (or flat) and runs
        :meth:`_chain`."""
        if not self.is_lm:
            x = self._shape_input(numpy.asarray(x, dtype=numpy.float32))
            with torch.inference_mode():
                y = self._chain(self._tensor(x, torch.float32))
            return y.cpu().numpy()
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

    # ---- the chain on the device ---------------------------------------

    def _flat_weights(self):
        """Every weight as a float32 tensor on the model's device — one
        upload per weight generation."""
        if self._chain_weights is None:
            self._chain_weights = {
                k: torch.from_numpy(numpy.ascontiguousarray(
                    v, dtype=numpy.float32)).to(self.torch_device)
                for k, v in self.weights.items()}
        return self._chain_weights

    def _chain(self, x):
        """The forward chain over the float32 tensor ``x`` (shaped by
        :meth:`_shape_input`), as the JAX package's traced chain runs
        it: NHWC convolutions with the artifact's sliding and padding,
        ceil-mode pooling with tail padding, the veles activations
        (``conv_relu`` / ``all2all_relu`` are softplus).  ``norm`` is
        :func:`~veles_tpu_torch.ops.lrn.lrn_forward`: a CUDA tensor
        launches the forward LRN kernel (B6) or raises, a CPU tensor
        takes the plain banded version."""
        weights = self._flat_weights()

        def par(entry, name):
            return weights[entry["params"][name]]

        for entry in self.units:
            t = entry["type"]
            cfg = entry["config"]
            if t == "mean_disp":
                x = (x - par(entry, "mean")) * par(entry, "rdisp")
            elif t == "dropout":
                pass
            elif t.startswith("activation_"):
                x = _torch_act(t.split("activation_")[1], x)
            elif t.startswith("all2all") or t in ("softmax", "rbm"):
                y = x.reshape(x.shape[0], -1) @ par(entry, "weights")
                if "bias" in entry["params"]:
                    y = y + par(entry, "bias")
                x = _torch_act(_DENSE_ACT[t], y)
                shape = cfg.get("output_sample_shape")
                if shape:
                    x = x.reshape((x.shape[0],) + tuple(shape))
            elif t == "kohonen":
                # float64, as the numpy mirror: the expanded distance
                # cancels near zero where the map converged.
                w = par(entry, "weights").double()
                xf = x.reshape(x.shape[0], -1).double()
                x = ((xf * xf).sum(1, keepdim=True) - 2.0 * (xf @ w.T) +
                     (w * w).sum(1)).float()
            elif t.startswith("conv"):
                x = _torch_conv(x, par(entry, "weights"),
                                par(entry, "bias")
                                if "bias" in entry["params"] else None,
                                cfg)
                x = _torch_act(_CONV_ACT[t], x)
            elif t.endswith("pooling"):
                x = _torch_pool(t, cfg, x)
            elif t == "norm":
                x = ops_lrn.lrn_forward(
                    x.contiguous(), int(cfg["n"]), float(cfg["alpha"]),
                    float(cfg["beta"]), float(cfg["k"]))
            elif t == "embedding":
                w = par(entry, "weights")
                tokens = torch.clamp(x.to(torch.int64), 0,
                                     w.shape[0] - 1)
                x = w[tokens] + par(entry, "pos")[:tokens.shape[1]]
            elif t in ("transformer_block", "moe_transformer_block"):
                p = {n: par(entry, n) for n in entry["params"]}
                B, S = x.shape[0], x.shape[1]
                mask = torch.ones((S, S), dtype=torch.bool,
                                  device=x.device)
                if cfg.get("causal", 1):
                    mask = torch.tril(mask)
                mask = mask.expand(B, S, S)
                x = _block(p, x, int(cfg["n_heads"]),
                           lambda q, k, v, m=mask:
                           decode_attention_reference(q, k, v, m),
                           mlp=_moe_mlp(p, cfg)
                           if t == "moe_transformer_block" else None)
            elif t == "lm_head":
                x = x @ par(entry, "weights")
                if "bias" in entry["params"]:
                    x = x + par(entry, "bias")
            else:
                raise Bug("unknown unit type %r" % t)
        return x

    # ---- numpy reference path (the native runtime's mirror) -----------
    # The JAX package's numpy code, line for line: the same artifact
    # gives the same bytes in both packages.

    def _shape_input(self, x):
        """Reshapes flat samples to the manifest geometry; a 2-D
        input over a 1-D sample shape of DIFFERENT length passes
        through — token models accept any sequence length (the pos
        table is sliced to fit), e.g. the generation parity tests
        feed growing prefixes."""
        if tuple(x.shape[1:]) == self.input_shape:
            return x
        n = 1
        for d in self.input_shape:
            n *= d
        if x.size == x.shape[0] * n:
            return x.reshape((x.shape[0],) + self.input_shape)
        if x.ndim == 2 and len(self.input_shape) == 1 and \
                self.units and self.units[0]["type"] == "embedding":
            # Token models only: any sequence length is legitimate
            # (the pos table is sliced to fit).  Dense artifacts keep
            # the strict-width check — the numpy path mirrors the
            # native runtime, which rejects wrong-size samples.
            return x
        raise Bug("input shape %s does not fit samples of %s" %
                  (x.shape, self.input_shape))

    def forward_numpy(self, x):
        x = numpy.asarray(x, dtype=numpy.float32)
        x = self._shape_input(x)
        for entry in self.units:
            x = self._run_numpy(entry, x)
        return x

    def _param(self, entry, name):
        return self.weights[entry["params"][name]]

    def _run_numpy(self, entry, x):
        t = entry["type"]
        cfg = entry["config"]
        if t == "mean_disp":
            return (x - self._param(entry, "mean")) * \
                self._param(entry, "rdisp")
        if t == "dropout":
            return x
        if t.startswith("activation_"):
            return _ACTS[t.split("activation_")[1]](x)
        if t.startswith("all2all") or t in ("softmax", "rbm"):
            w = self._param(entry, "weights")
            y = x.reshape(x.shape[0], -1) @ w
            if "bias" in entry["params"]:
                y = y + self._param(entry, "bias")
            y = _ACTS[_DENSE_ACT[t]](y)
            shape = cfg.get("output_sample_shape")
            if shape:
                y = y.reshape((x.shape[0],) + tuple(shape))
            return y
        if t == "kohonen":
            return self._kohonen_numpy(entry, x)
        if t == "embedding":
            w = self._param(entry, "weights")
            # Clamp OOV ids like the native runtime and jax indexing
            # do — the mirror must not raise/wrap where they clamp.
            tokens = numpy.clip(x.astype(numpy.int32), 0,
                                w.shape[0] - 1)
            return (w[tokens] +
                    self._param(entry, "pos")[:tokens.shape[1]]
                    ).astype(numpy.float32)
        if t == "transformer_block":
            return self._transformer_numpy(entry, x)
        if t == "moe_transformer_block":
            return self._transformer_numpy(
                entry, x,
                mlp=lambda h, p: self._moe_ffn_numpy(entry, h, p))
        if t == "lm_head":
            w = self._param(entry, "weights")
            y = x @ w
            if "bias" in entry["params"]:
                y = y + self._param(entry, "bias")
            return y.astype(numpy.float32)
        if t.startswith("conv"):
            return self._conv_numpy(entry, x)
        if t.endswith("pooling"):
            return self._pool_numpy(entry, x)
        if t == "norm":
            return self._lrn_numpy(cfg, x)
        raise Bug("unknown unit type %r in artifact" % t)

    def _transformer_numpy(self, entry, x, mlp=None):
        """Pre-LN block, numpy mirror of the JAX package's
        ``transformer_block_apply`` (``mlp(h, p)`` replaces the dense
        MLP)."""
        cfg = entry["config"]
        H = int(cfg["n_heads"])
        causal = bool(cfg.get("causal", 1))
        p = {n: self._param(entry, n) for n in entry["params"]}

        def ln(v, g, b, eps=1e-5):
            mu = v.mean(axis=-1, keepdims=True)
            var = ((v - mu) ** 2).mean(axis=-1, keepdims=True)
            return (v - mu) / numpy.sqrt(var + eps) * g + b

        B, S, E = x.shape
        D = E // H
        h = ln(x, p["ln1_g"], p["ln1_b"])
        if "wqkv" in p:
            # Fused-QKV artifact: one (E, 3E) head-major projection
            # (znicz/attention.fuse_qkv_arrays layout).
            qkv = (h @ p["wqkv"] + p["bqkv"]).reshape(B, S, H, 3, D)
            q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        else:
            q = (h @ p["wq"] + p["bq"]).reshape(B, S, H, D)
            k = (h @ p["wk"] + p["bk"]).reshape(B, S, H, D)
            v = (h @ p["wv"] + p["bv"]).reshape(B, S, H, D)
        scores = numpy.einsum("bqhd,bkhd->bhqk", q, k) / \
            numpy.sqrt(D)
        if causal:
            mask = numpy.tril(numpy.ones((S, S), bool))
            scores = numpy.where(mask, scores, -1e30)
        scores -= scores.max(axis=-1, keepdims=True)
        pattn = numpy.exp(scores)
        pattn /= pattn.sum(axis=-1, keepdims=True)
        attn = numpy.einsum("bhqk,bkhd->bqhd", pattn, v) \
            .reshape(B, S, E)
        x = x + attn @ p["wo"] + p["bo"]
        h = ln(x, p["ln2_g"], p["ln2_b"])
        if mlp is not None:
            return (x + mlp(h, p)).astype(numpy.float32)
        h = numpy.maximum(h @ p["w1"] + p["b1"], 0.0)
        return (x + h @ p["w2"] + p["b2"]).astype(numpy.float32)

    def _moe_ffn_numpy(self, entry, h, p):
        """Top-1 capacity routing, the numpy mirror of ``ops.moe``
        ``moe_ffn``: tokens flatten batch-major, each goes to its argmax
        expert while the expert has queue slots left (capacity = cf·T/E
        over the whole batch, in token order); overflow tokens
        contribute zero."""
        cfg = entry["config"]
        nexp = int(cfg["n_experts"])
        cf = float(cfg.get("capacity_factor", 1.25))
        B, S, E = h.shape
        tok = h.reshape(B * S, E).astype(numpy.float32)
        T = tok.shape[0]
        capacity = max(1, int(cf * T / nexp))
        logits = tok @ p["router"]
        logits -= logits.max(axis=-1, keepdims=True)
        probs = numpy.exp(logits)
        probs /= probs.sum(axis=-1, keepdims=True)
        gate = probs.max(axis=-1)
        expert = probs.argmax(axis=-1)
        y = numpy.zeros_like(tok)
        count = numpy.zeros(nexp, dtype=numpy.int64)
        for t in range(T):
            e = int(expert[t])
            if count[e] < capacity:
                h1 = numpy.maximum(tok[t] @ p["w1"][e] + p["b1"][e], 0.0)
                y[t] = gate[t] * (h1 @ p["w2"][e] + p["b2"][e])
            count[e] += 1
        return y.reshape(B, S, E)

    def _kohonen_numpy(self, entry, x):
        # Squared distance to each SOM neuron (KohonenForward emits
        # the full distance map; BMU = argmin over the last axis).
        # float64 accumulation: the expanded form cancels near zero
        # exactly where the SOM converged, and the native runtime
        # accumulates exact squared differences in double.
        w = self._param(entry, "weights") \
            .astype(numpy.float64)  # (n_neurons, n_in)
        xf = x.reshape(x.shape[0], -1).astype(numpy.float64)
        return ((xf * xf).sum(1, keepdims=True) - 2.0 * (xf @ w.T) +
                (w * w).sum(1)).astype(numpy.float32)

    def _conv_numpy(self, entry, x):
        cfg = entry["config"]
        w = self._param(entry, "weights")  # HWIO
        ky, kx = w.shape[0], w.shape[1]
        (pt, pb), (pl, pr) = cfg["padding"]
        sh, sw = cfg["sliding"]
        xp = numpy.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
        n, H, W, C = xp.shape
        out_h = (H - ky) // sh + 1
        out_w = (W - kx) // sw + 1
        # im2col: patches (n, out_h, out_w, ky*kx*C)
        cols = numpy.empty((n, out_h, out_w, ky * kx * C),
                           dtype=numpy.float32)
        for iy in range(ky):
            for ix in range(kx):
                patch = xp[:, iy:iy + sh * out_h:sh,
                           ix:ix + sw * out_w:sw, :]
                cols[..., (iy * kx + ix) * C:(iy * kx + ix + 1) * C] \
                    = patch
        y = cols @ w.reshape(-1, w.shape[-1])
        if "bias" in entry["params"]:
            y = y + self._param(entry, "bias")
        act = {"conv": "linear", "conv_tanh": "tanh",
               "conv_relu": "softplus", "conv_str": "str",
               "conv_sigmoid": "sigmoid"}[entry["type"]]
        return _ACTS[act](y)

    def _pool_numpy(self, entry, x):
        cfg = entry["config"]
        t = entry["type"]
        ky, kx = int(cfg["ky"]), int(cfg["kx"])
        sh, sw = cfg["sliding"]
        (pt, pb), (pl, pr) = cfg["padding"]
        n, H, W, C = x.shape
        # Ceil-mode output + tail padding (matches Pooling
        # _window_padding).
        out_h = -(-(H + pt + pb - ky) // sh) + 1
        out_w = -(-(W + pl + pr - kx) // sw) + 1
        need_h = (out_h - 1) * sh + ky - (H + pt)
        need_w = (out_w - 1) * sw + kx - (W + pl)
        pb2, pr2 = max(pb, need_h), max(pr, need_w)
        if t == "avg_pooling":
            fill = 0.0
        else:
            fill = numpy.nan  # excluded via nan-aware reductions
        xp = numpy.full((n, H + pt + pb2, W + pl + pr2, C), fill,
                        dtype=numpy.float32)
        xp[:, pt:pt + H, pl:pl + W, :] = x
        y = numpy.empty((n, out_h, out_w, C), dtype=numpy.float32)
        if t == "avg_pooling":
            # Sum over zero-padded windows, divided by the true
            # (unpadded) window population.
            ones = numpy.zeros_like(xp)
            ones[:, pt:pt + H, pl:pl + W, :] = 1.0
        for oy in range(out_h):
            for ox in range(out_w):
                win = xp[:, oy * sh:oy * sh + ky,
                         ox * sw:ox * sw + kx, :]
                flat = win.reshape(n, -1, C)
                if t == "avg_pooling":
                    cnt = ones[:, oy * sh:oy * sh + ky,
                               ox * sw:ox * sw + kx, :] \
                        .reshape(n, -1, C).sum(axis=1)
                    y[:, oy, ox] = flat.sum(axis=1) / \
                        numpy.maximum(cnt, 1.0)
                elif t == "maxabs_pooling":
                    # nan→-inf (not nanargmax: an all-padding window
                    # must yield NaN, matching the native runtime,
                    # rather than raise on the all-NaN slice).
                    absf = numpy.where(numpy.isnan(flat),
                                       -numpy.inf, numpy.abs(flat))
                    idx = absf.argmax(axis=1)
                    y[:, oy, ox] = numpy.take_along_axis(
                        flat, idx[:, None, :], axis=1)[:, 0]
                else:
                    y[:, oy, ox] = numpy.nanmax(flat, axis=1)
        return y

    @staticmethod
    def _lrn_numpy(cfg, x):
        alpha, beta, k, n = (cfg["alpha"], cfg["beta"], cfg["k"],
                             int(cfg["n"]))
        c = x.shape[-1]
        half = n // 2
        sq = x * x
        ssum = numpy.zeros_like(x)
        for j in range(c):
            lo, hi = max(0, j - half), min(c, j + (n - 1 - half) + 1)
            ssum[..., j] = sq[..., lo:hi].sum(axis=-1)
        return x / (k + (alpha / n) * ssum) ** beta

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
        lm_chain(self.units)   # a Bug naming the chain when not an LM
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
        """The addressed pool blocks as ONE host array ``(L, 2, n,
        block_size, H, D)`` float32 (k then v per layer) — the tensor
        the disaggregation wire ships (``serving.fabric.disagg`` frames
        it with ``encode_tensor_parts``).  A bf16 pool widens, an
        int8/fp8 pool dequantizes (code · per-(block, head) scale), so
        the wire is storage-dtype-agnostic.  The caller holds refs on
        ``ids`` (``export_prefix_blocks``) so the blocks cannot be
        reused mid-read, and runs on the engine's device thread."""
        ks, vs, sks, svs = _kv_unpack(pool.storage)
        idx = torch.as_tensor(list(ids), dtype=torch.int64,
                              device=ks[0].device)
        out = []
        with torch.inference_mode():
            for i, (k, v) in enumerate(zip(ks, vs)):
                kb = k[idx].to(torch.float32)
                vb = v[idx].to(torch.float32)
                if sks is not None:
                    kb = kb * sks[i][idx][:, None, :, None]
                    vb = vb * svs[i][idx][:, None, :, None]
                out.append(torch.stack([kb, vb]))
            return torch.stack(out).cpu().numpy()

    def import_kv_blocks(self, pool, ids, blocks):
        """Scatters a shipped ``(L, 2, n, block_size, H, D)`` host array
        (:meth:`export_kv_blocks` on the peer) into THIS pool's storage
        at ``ids``: a float32 or bf16 pool takes the values cast to its
        dtype; an int8/fp8 pool re-quantizes them with fresh
        per-(block, head) scales, ``amax / qmax`` over each block's
        rows and dims, through the plane's quantizer (the JAX package's,
        bit for bit).  The write is the copy-on-write copy's: in place,
        block rows only, on the engine's device thread (the serving
        path routes it through the op queue, so it never races a decode
        step)."""
        ks, vs, sks, svs = _kv_unpack(pool.storage)
        # A copy: the wire's arrays are read-only views of its buffer.
        blocks = numpy.array(blocks, dtype=numpy.float32)
        L = len(ks)
        if blocks.shape[:2] != (L, 2) or blocks.shape[2] != len(ids) or \
                blocks.shape[3:] != tuple(ks[0].shape[1:]):
            raise Bug("imported KV block shape %s does not match pool "
                      "geometry (L=%d, block=%s, n=%d)" % (
                          blocks.shape, L, tuple(ks[0].shape[1:]),
                          len(ids)))
        dev = ks[0].device
        idx = torch.as_tensor(list(ids), dtype=torch.int64, device=dev)
        vals = torch.from_numpy(blocks).to(dev)
        with torch.inference_mode():
            for i in range(L):
                kb, vb = vals[i, 0], vals[i, 1]  # (n, bs, H, D)
                if sks is None:
                    ks[i][idx] = kb.to(ks[i].dtype)
                    vs[i][idx] = vb.to(vs[i].dtype)
                    continue
                qmax = _KV_QMAX[pool.kv_dtype]
                for codes, scales, x in ((ks[i], sks[i], kb),
                                         (vs[i], svs[i], vb)):
                    scale = torch.amax(torch.abs(x), dim=(1, 3)) / qmax
                    codes[idx] = _kv_quantize(
                        x, scale[:, None, :, None], pool.kv_dtype)
                    scales[idx] = scale

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
