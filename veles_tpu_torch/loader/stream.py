"""Streamed (not device-resident) minibatch loader (the JAX package's
``loader.stream``).

The dataset stays on disk or in host memory; nothing of it lives on
the device beyond the blocks in flight:

* a host pool (:class:`concurrent.futures.ThreadPoolExecutor`)
  materializes (decodes, reads, normalizes) each block of K minibatch
  ticks into staging buffers — page-locked host memory when the step
  runs on the card;
* each block goes to the device by a ``non_blocking`` copy on a copy
  stream of its own, and the step's stream waits for that copy (a
  CUDA event) before it reads the block.  The step itself is
  asynchronous too, so with one block of lookahead the host fill of
  block K+1 and its upload overlap the device compute of block K.

The epoch walk therefore runs one block AHEAD of what the rest of the
graph observes.  Flag publication is split: the inherited serve
machinery advances the *walk* (private), and :meth:`run` publishes the
flags of the block it actually dispatched, so the decision unit and
snapshots see truthful epoch accounting.

A staging buffer stays referenced by its block until the copy out of
it has completed (:meth:`StreamLoader._take` waits for the copy's event
before it lets the buffer go): a page-locked buffer refilled while its
copy is in flight would corrupt the block silently.

On a worker of the data plane, ``apply_data_from_master`` materializes
the coordinator's indices as the current minibatch.
"""

import os

import numpy
import torch

from ..accelerated_units import TracedUnit
from ..error import BadFormatError
from ..memory import Vector, torch_device
from .base import Loader, TRAIN, VALID, TEST  # noqa: F401


class StreamLoader(Loader, TracedUnit):
    """Serves minibatch *data* from the host each tick (contrast
    :class:`..fullbatch.FullBatchLoader`, which keeps the originals on
    the device and gathers inside the step).

    Subclasses implement :meth:`materialize` (one sample) or override
    :meth:`fill_rows` (a batch of samples — vectorize when the source
    allows it), and ``load_data`` must set :attr:`sample_shape` and
    :attr:`sample_dtype` besides ``class_lengths``.

    kwargs: ``decode_workers`` — host pool size (default
    ``os.cpu_count()``); ``prefetch`` — one block of lookahead (default
    True; off for strictly synchronous debugging).
    """

    hide_from_registry = True

    #: Published flags of the dispatched block (class-level defaults so
    #: the epoch_number property works before any publication).
    _pub_ = None
    _serving_ = False

    def __init__(self, workflow, **kwargs):
        super(StreamLoader, self).__init__(workflow, **kwargs)
        self.minibatch_data = Vector()
        self.minibatch_labels = Vector()
        self.decode_workers = int(kwargs.get(
            "decode_workers", os.cpu_count() or 4))
        self.prefetch = bool(kwargs.get("prefetch", True))
        self.sample_shape = None
        self.sample_dtype = numpy.float32

    def init_unpickled(self):
        super(StreamLoader, self).init_unpickled()
        self._staged_ = None
        self._pool_ = None
        self._copy_stream_ = None
        self._pub_ = None
        self._serving_ = False

    # -- walk/published epoch split ----------------------------------------
    # serve_* both reads and writes epoch_number (the ``+= 1`` at epoch
    # end, the shuffle-limit check), so the walk's value stays private
    # while the published value describes the dispatched block.  The
    # other flags are written before they are read in every serve and
    # are simply re-assigned at publication.

    @property
    def epoch_number(self):
        if not self._serving_ and self._pub_ is not None:
            return self._pub_["epoch_number"]
        return self._w_epoch_number

    @epoch_number.setter
    def epoch_number(self, value):
        self._w_epoch_number = value

    # -- ILoader -----------------------------------------------------------

    def create_minibatch_data(self):
        if self.sample_shape is None:
            raise BadFormatError(
                "%s.load_data must set sample_shape" % self)
        mb = self.max_minibatch_size
        self.minibatch_data.mem = numpy.zeros(
            (mb,) + tuple(self.sample_shape), dtype=self.sample_dtype)
        self.minibatch_labels.mem = numpy.zeros(mb, dtype=numpy.int32)

    def fill_minibatch(self):
        self._fill_current()

    # -- materialization hooks ---------------------------------------------

    def materialize(self, index):
        """Returns (sample_array, label) for one global index."""
        raise NotImplementedError()

    def fill_rows(self, indices, out_data, out_labels):
        """Materializes the samples of 1-D global ``indices`` into
        ``out_data[i]`` / ``out_labels[i]`` (numpy views of the staging
        buffers).  The default loops over :meth:`materialize`; override
        to vectorize (memmap fancy indexing, batched decode, ...)."""
        for i, gi in enumerate(indices):
            arr, lab = self.materialize(int(gi))
            out_data[i] = arr
            out_labels[i] = lab

    @property
    def pool(self):
        if self._pool_ is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool_ = ThreadPoolExecutor(
                max_workers=self.decode_workers,
                thread_name_prefix="veles-decode")
        return self._pool_

    def _on_card(self):
        return torch_device(self.device).type == "cuda"

    def _staging(self, shape, dtype):
        """An uninitialized host tensor of numpy ``dtype``, page-locked
        when the step runs on the card."""
        tdtype = torch.from_numpy(numpy.zeros(0, dtype=dtype)).dtype
        return torch.empty(tuple(shape), dtype=tdtype,
                           pin_memory=self._on_card())

    def _fill_block(self, idxs, masks):
        """(K, mb) indices and masks → (K, mb, *sample) data and (K, mb)
        labels, host tensors (page-locked on the card); the decode runs
        across the worker pool, the padded rows are zeros."""
        K, mb = idxs.shape
        data = self._staging((K, mb) + tuple(self.sample_shape),
                             self.sample_dtype)
        labels = self._staging((K, mb), numpy.int32)
        data_np, labels_np = data.numpy(), labels.numpy()
        jobs = []
        for t in range(K):
            n = int(masks[t].sum())
            data_np[t, n:] = 0
            labels_np[t, n:] = 0
            if n == 0:
                continue
            if K == 1 and self.decode_workers > 1:
                # A one-tick block: split its rows so the pool still
                # parallelizes the decode.
                step = max(1, -(-n // self.decode_workers))
                for lo in range(0, n, step):
                    hi = min(n, lo + step)
                    jobs.append((idxs[t][lo:hi], data_np[t][lo:hi],
                                 labels_np[t][lo:hi]))
            else:
                jobs.append((idxs[t][:n], data_np[t][:n],
                             labels_np[t][:n]))
        if len(jobs) == 1:
            self.fill_rows(*jobs[0])
        elif jobs:
            futures = [self.pool.submit(self.fill_rows, *j)
                       for j in jobs]
            for f in futures:
                f.result()
        return data, labels

    def _fill_current(self):
        """Synchronous fill of the single current minibatch (the eager
        path)."""
        if self.minibatch_size:
            data, labels = self._fill_block(
                self.minibatch_indices.mem[None, :],
                self.minibatch_mask.mem[None, :])
            data, labels = data.numpy()[0], labels.numpy()[0]
        else:
            mb = self.max_minibatch_size
            data = numpy.zeros((mb,) + tuple(self.sample_shape),
                               dtype=self.sample_dtype)
            labels = numpy.zeros(mb, dtype=numpy.int32)
        self.minibatch_data.mem = data
        self.minibatch_labels.mem = labels

    # -- fused-step contract -----------------------------------------------

    def step_batch_vectors(self):
        """The DATA is the per-tick host → device feed (contrast the
        full-batch loader: indices only)."""
        return [self.minibatch_data, self.minibatch_labels,
                self.minibatch_mask, self.minibatch_class_vec]

    def tforward(self, read, write, params, ctx, state=None):
        """Nothing to compute: the minibatch tensors enter the step as
        batch inputs; downstream units read them from the bag."""

    # -- the tick ----------------------------------------------------------

    def _upload(self, host):
        """Starts the copy of ``host`` ({vector id: host tensor}) to the
        step's device; returns ({vector id: device tensor}, the copy's
        CUDA event or None on the CPU, where the host tensors are the
        block)."""
        device = torch_device(self.device)
        if device.type != "cuda":
            return {k: v.to(device) for k, v in host.items()}, None
        if self._copy_stream_ is None:
            self._copy_stream_ = torch.cuda.Stream(device)
        with torch.cuda.stream(self._copy_stream_):
            blocks = {k: v.to(device, non_blocking=True)
                      for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._copy_stream_)
        return blocks, ready

    def _produce_block(self, ticks):
        """Advances the private walk by one block, materializes it and
        starts its upload."""
        self._serving_ = True
        try:
            served = self.serve_block(ticks)
            flags = {
                "minibatch_class": self.minibatch_class,
                "minibatch_size": self.minibatch_size,
                "last_minibatch": self.last_minibatch,
                "epoch_ended": self.epoch_ended,
                "epoch_number": self._w_epoch_number,
            }
        finally:
            self._serving_ = False
        idxs = served[str(id(self.minibatch_indices))]
        masks = served[str(id(self.minibatch_mask))]
        cls_arr = served[str(id(self.minibatch_class_vec))]
        data, labels = self._fill_block(idxs, masks)
        host = {str(id(self.minibatch_data)): data,
                str(id(self.minibatch_labels)): labels}
        for vec, arr in ((self.minibatch_mask, masks),
                         (self.minibatch_class_vec, cls_arr)):
            staged = self._staging(arr.shape, arr.dtype)
            staged.numpy()[...] = arr
            host[str(id(vec))] = staged
        blocks, ready = self._upload(host)
        return {"blocks": blocks, "flags": flags, "ready": ready,
                "staging": host, "in_flight": list(self._in_flight_)}

    def _take(self, entry):
        """The block of ``entry``, ordered after its copy on the step's
        stream; its staging buffers are let go once the copy is done."""
        ready = entry["ready"]
        if ready is not None:
            compute = torch.cuda.current_stream(
                torch_device(self.device))
            compute.wait_event(ready)
            for tensor in entry["blocks"].values():
                # Allocated on the copy stream, read on the step's: the
                # caching allocator must not reuse it before the step
                # is done with it.
                tensor.record_stream(compute)
            ready.synchronize()
        entry["staging"] = None
        return entry["blocks"]

    def _apply_flags(self, flags):
        self.minibatch_class = flags["minibatch_class"]
        self.minibatch_size = flags["minibatch_size"]
        self.last_minibatch = flags["last_minibatch"]
        self.epoch_ended = flags["epoch_ended"]
        self._pub_ = flags

    def run(self):
        wf = self.workflow
        if getattr(wf, "fused", False):
            ticks = max(1, getattr(wf, "ticks_per_dispatch", 1))
            entry = self._staged_
            self._staged_ = None
            if entry is None:
                entry = self._produce_block(ticks)
            # Publish before the dispatch: wf.training reads
            # minibatch_is_training for this block.
            self._apply_flags(entry["flags"])
            wf.begin_tick()
            wf.execute_block(self._take(entry))
            if self.prefetch:
                # Stage the next block while the device computes this
                # one; its serve overwrites the flag attributes, so the
                # dispatched block's flags are published again for the
                # decision.
                self._staged_ = self._produce_block(ticks)
                self._apply_flags(entry["flags"])
                self._in_flight_ = (entry["in_flight"] +
                                    self._staged_["in_flight"])
            else:
                self._in_flight_ = entry["in_flight"]
            return
        # The eager path (graphs that are not fused).
        self.serve_next_minibatch()
        self._fill_current()
        if hasattr(wf, "begin_tick"):
            wf.begin_tick()
        TracedUnit.run(self)

    def invalidate_staged(self):
        """Drops the prefetched block (a rebuild: its device tensors
        belong to the old device set and its indices were requeued from
        ``_in_flight_``)."""
        self._staged_ = None

    # -- a worker materializes its assigned indices ------------------------

    def apply_data_from_master(self, data):
        super(StreamLoader, self).apply_data_from_master(data)
        self._fill_current()

    # -- pickling: the staged (undispatched) block is requeued --------------

    def __getstate__(self):
        state = super(StreamLoader, self).__getstate__()
        staged = self._staged_
        if staged is not None:
            state["failed_minibatches"] = (
                list(state["failed_minibatches"]) +
                [(idx, cls) for idx, cls in staged["in_flight"]])
        return state
