"""Minibatch-serving loader base (the JAX package's ``loader.base``,
local mode).

* three sample classes — TEST(0), VALIDATION(1), TRAIN(2) — walked in
  class order within each epoch;
* a shuffled train index space (validation/test stay ordered), shuffled
  by the host prng so both packages serve the same batches;
* epoch accounting: ``last_minibatch``, ``epoch_ended``,
  ``epoch_number``;
* a failed-minibatch retry queue, re-served before fresh indices;
* the final partial minibatch of a class is PADDED to
  ``max_minibatch_size`` and ``minibatch_mask`` marks the valid rows;
* block mode: :meth:`Loader.serve_block` serves up to K same-class
  minibatches at once;
* the data plane: a coordinator's loader ships only indices to its
  workers — one minibatch a job, or a block of up to K same-class
  minibatches (``--job-ticks``) — and keeps each worker's served jobs
  until they are answered, so a lost worker's minibatches are served
  again; a worker's loader takes them as its current minibatch (or
  stages the block for the job's ticks).
"""

import numpy

from .. import prng
from ..error import BadFormatError
from ..memory import Vector
from ..registry import MappedUnitRegistry
from ..units import Unit

#: Sample-class ids (reference: loader/base.py:72-80).
TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAME = ("test", "validation", "train")


def init_parser(parser):
    """The loader flags of the command line."""
    parser.add_argument(
        "--train-ratio", type=float, default=None, metavar="R",
        help="train on a random R-fraction of the train set "
             "(sets root.common.loader.train_ratio)")
    parser.add_argument(
        "--shuffle-limit", type=int, default=None, metavar="N",
        help="stop reshuffling train indices after epoch N")


class UserLoaderRegistry(MappedUnitRegistry):
    """String → loader class factory (reference: base.py:83-93)."""
    registry = {}


class ILoader(object):
    """The loader contract (reference: base.py:100)."""

    def load_data(self):
        """Populates class_lengths (and dataset payloads)."""
        raise NotImplementedError()

    def create_minibatch_data(self):
        """Allocates minibatch output vectors."""
        raise NotImplementedError()

    def fill_minibatch(self):
        """Materializes the current minibatch from indices."""
        raise NotImplementedError()


class Loader(Unit, metaclass=UserLoaderRegistry):
    """Serves minibatches tick by tick (reference: base.py:120)."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.max_minibatch_size = kwargs.get("minibatch_size", 100)
        self.class_lengths = [0, 0, 0]
        self.epoch_number = 0
        self.prng_key = kwargs.get("prng_key", 0)
        from ..config import root as _root
        self.shuffle_limit = kwargs.get(
            "shuffle_limit",
            _root.common.loader.get("shuffle_limit", numpy.inf))
        if self.shuffle_limit in (-1, None):
            self.shuffle_limit = numpy.inf
        # Per-run config default lets the ensemble trainer vary the
        # train subset without touching workflow constructors
        # (reference: --train-ratio flag, loader/base.py).
        self.train_ratio = kwargs.get(
            "train_ratio", _root.common.loader.get("train_ratio", 1.0))
        # Strict dataset analysis (unseen-label rejection) can be
        # opted out for datasets whose labels are not classification
        # classes (e.g. per-sample ids).
        self.validate_labels = kwargs.get("validate_labels", True)
        super(Loader, self).__init__(workflow, **kwargs)
        self.view_group = "LOADER"
        # Per-tick outputs (host scalars + device vectors).
        self.minibatch_class = TRAIN
        self.minibatch_size = 0
        self.last_minibatch = False
        self.epoch_ended = False
        self.minibatch_indices = Vector()
        self.minibatch_mask = Vector()
        # Device-side copy of minibatch_class so evaluators can route
        # on-device epoch accumulation without a host sync.
        self.minibatch_class_vec = Vector()
        # Epoch state.
        self.global_offset = 0
        self.shuffled_indices = Vector()
        self.failed_minibatches = []

    def init_unpickled(self):
        super(Loader, self).init_unpickled()
        # Minibatches served but possibly not yet committed by the
        # step.  Single-tick serves hold one entry; a block serve
        # holds the whole block.
        self._in_flight_ = []
        # Coordinator: each worker's served jobs, oldest first, each a
        # list of (indices, class) ticks.  Worker: the block of the
        # current multi-tick job.
        self._pending_indices_ = {}
        self._staged_block_ = None

    # -- derived sizes -----------------------------------------------------

    @property
    def total_samples(self):
        return sum(self.class_lengths)

    @property
    def class_end_offsets(self):
        ends, acc = [], 0
        for ln in self.class_lengths:
            acc += ln
            ends.append(acc)
        return ends

    @property
    def minibatch_is_training(self):
        return self.minibatch_class == TRAIN

    def class_of_offset(self, offset):
        for cls, end in enumerate(self.class_end_offsets):
            if offset < end:
                return cls
        raise BadFormatError("offset %d beyond dataset" % offset)

    # -- lifecycle ---------------------------------------------------------

    def initialize(self, **kwargs):
        super(Loader, self).initialize(**kwargs)
        self.load_data()
        if self.total_samples == 0:
            raise BadFormatError("loader has no samples after load_data")
        train_subset = None
        if self.class_lengths[TRAIN] > 0 and self.train_ratio < 1.0:
            # A RANDOM subset per run (ensemble bagging diversity) —
            # not the leading slice, which would give every instance
            # the identical samples and discard the tail entirely.
            full_train = self.class_lengths[TRAIN]
            keep = max(1, int(full_train * self.train_ratio))
            train_start = self.class_lengths[0] + self.class_lengths[1]
            train_subset = train_start + numpy.sort(
                prng.get(self.prng_key).choice(
                    full_train, size=keep, replace=False)
                .astype(numpy.int32))
            self.class_lengths[TRAIN] = keep
        resumed = bool(self.shuffled_indices) and \
            self.shuffled_indices.size == self.total_samples
        if not resumed:
            # Fresh run; a snapshot resume keeps the pickled index
            # order + global_offset so the epoch continues mid-walk
            # (reference: loader state rides the workflow pickle).
            base = numpy.arange(self.total_samples, dtype=numpy.int32)
            if train_subset is not None:
                base[self.class_lengths[0] + self.class_lengths[1]:] \
                    = train_subset
            self.shuffled_indices.mem = base
        self.minibatch_indices.mem = numpy.zeros(
            self.max_minibatch_size, dtype=numpy.int32)
        self.minibatch_mask.mem = numpy.zeros(
            self.max_minibatch_size, dtype=numpy.float32)
        self.minibatch_class_vec.mem = numpy.zeros(
            (), dtype=numpy.int32)
        self.create_minibatch_data()
        self.analyze_dataset()
        if not resumed:
            self.shuffle()

    # -- dataset analysis (reference: base.py:753 analyze_dataset) ---------

    def dataset_labels(self):
        """Per-class label arrays ``[test, validation, train]`` (None
        entries for classes without labels; return None to skip
        analysis entirely).  Subclasses with materialized labels
        override this."""
        return None

    def slice_labels_by_class(self, labels):
        """Splits a flat [test|validation|train] label array by the
        class offsets.  The train slice runs to the END of the array,
        not to the (possibly train_ratio-shrunk) offset, so analysis
        always covers the full stored train set."""
        out, start = [], 0
        for cls, end in enumerate(self.class_end_offsets):
            stop = len(labels) if cls == TRAIN else end
            out.append(labels[start:stop] if stop > start else None)
            start = end
        return out

    def analyze_dataset(self):
        """Sanity-checks the loaded dataset at initialize (reference:
        base.py:753 + _setup_labels_mapping:922): per-class sample
        counts, label-range/mapping validation (a validation or test
        label never seen in training fails LOUDLY — it would
        otherwise surface as silently bad accuracy), per-class label
        histograms with imbalance warnings, and a train-vs-other
        distribution comparison."""
        self.info("dataset: %s",
                  ", ".join("%d %s" % (n, CLASS_NAME[cls])
                            for cls, n in
                            enumerate(self.class_lengths) if n))
        labels = self.dataset_labels()
        if labels is None:
            return
        # Sequence models carry PER-TOKEN label arrays (N, S, ...):
        # the dtype/range and unseen-label checks still apply (a
        # vocab id in validation but not training is exactly the
        # silent-bad-accuracy bug this function exists to catch) over
        # the flattened tokens, but per-class BALANCE warnings are
        # meaningless there and are suppressed.  Ragged per-sample
        # label lists cannot be analyzed at all — skip with a notice.
        sequence_labels = False
        flat = []
        for arr in labels:
            if arr is None:
                flat.append(None)
                continue
            try:
                a = numpy.asarray(arr)
            except ValueError:
                # Ragged per-sample lists: keep object dtype so the
                # loop's dtype check below still fails LOUDLY under
                # validate_labels instead of silently skipping.
                a = numpy.asarray(arr, dtype=object)
            # Trailing singleton axes ((N, 1) column vectors) are
            # ordinary class labels, not sequences; only they are
            # squeezed — a (1, S) single-sequence split must stay
            # sequence-shaped.
            while a.ndim > 1 and a.shape[-1] == 1:
                a = a[..., 0]
            if a.ndim > 1:
                sequence_labels = True
                a = a.ravel()
            flat.append(a)
        labels = flat
        self.label_stats = {}
        histograms = {}
        for cls, arr in enumerate(labels):
            if arr is None or not len(arr):
                continue
            if not numpy.issubdtype(arr.dtype, numpy.integer) or \
                    arr.min() < 0:
                problem = ("%s labels are not non-negative integers "
                           "(dtype %s)" % (CLASS_NAME[cls],
                                           arr.dtype))
                if self.validate_labels:
                    raise BadFormatError(
                        problem + " — pass validate_labels=False if "
                        "these are not class labels")
                # Opted out: ids/regression targets — skip histogram
                # analysis for this class.
                self.info("%s; skipping label analysis", problem)
                continue
            values, counts = numpy.unique(arr, return_counts=True)
            histograms[cls] = dict(zip(values.tolist(),
                                       counts.tolist()))
        if not histograms:
            return
        train_hist = histograms.get(TRAIN, {})
        for cls, hist in histograms.items():
            if cls != TRAIN and train_hist and self.validate_labels:
                # Mapping validation: every evaluated label must be
                # learnable (reference _validate_and_fix_other_labels).
                unseen = sorted(set(hist) - set(train_hist))
                if unseen:
                    raise BadFormatError(
                        "%s set contains labels never seen in "
                        "training: %s (pass validate_labels=False "
                        "if these are not class labels)"
                        % (CLASS_NAME[cls], unseen[:10]))
            counts = numpy.array(list(hist.values()), dtype=float)
            mean, std = counts.mean(), counts.std()
            self.label_stats[CLASS_NAME[cls]] = {
                "classes": len(hist),
                "min": int(counts.min()), "max": int(counts.max()),
                "mean": float(mean), "std": float(std)}
            msg = ("%s labels: %d classes, count min %d / mean %d / "
                   "max %d (std %d)" % (CLASS_NAME[cls], len(hist),
                                        counts.min(), mean,
                                        counts.max(), std))
            if sequence_labels:
                # Token-frequency skew is normal language statistics,
                # not a dataset bug — no imbalance warnings.
                self.debug("%s (per-token)", msg)
            elif not self.validate_labels:
                # The user declared these are not real class labels
                # (synthetic benches, ids): stats stay available but
                # imbalance is not a warning-worthy dataset bug.
                self.info("%s", msg)
            elif std > mean / 2:
                self.warning("%s — SEVERELY imbalanced", msg)
            elif std > mean / 10:
                self.warning("%s — imbalanced", msg)
            else:
                self.info("%s", msg)
        # Distribution drift: a validation/test set whose label mix
        # differs wildly from training skews the reported metrics
        # (reference _compare_label_distributions); token mixes of
        # sequence targets are expected to drift — skip the whole
        # computation there, and for declared non-class labels
        # (validate_labels=False) drift is not a dataset bug either.
        if train_hist and not sequence_labels and \
                self.validate_labels:
            total_train = sum(train_hist.values())
            for cls in (TEST, VALID):
                hist = histograms.get(cls)
                if not hist:
                    continue
                total = sum(hist.values())
                drift = max(
                    abs(hist.get(lbl, 0) / total -
                        cnt / total_train)
                    for lbl, cnt in train_hist.items())
                if drift > 0.1:
                    self.warning(
                        "%s label distribution deviates from train "
                        "by up to %.0f%%", CLASS_NAME[cls],
                        drift * 100)

    def shuffle(self):
        """Shuffles ONLY the train tail of the index space
        (reference: base.py:709)."""
        if self.epoch_number >= self.shuffle_limit:
            return
        if self.class_lengths[TRAIN] == 0:
            return
        train_start = self.class_end_offsets[VALID]
        arr = self.shuffled_indices.mem
        prng.get(self.prng_key).shuffle(arr[train_start:])
        self.shuffled_indices.mem = arr

    # -- the tick ----------------------------------------------------------

    def run(self):
        self.serve_next_minibatch()
        self.fill_minibatch()

    def serve_next_minibatch(self, slave_id=None):
        """Advances the global offset and publishes the next minibatch's
        indices + flags; with ``slave_id`` the minibatch is recorded as
        that worker's pending job."""
        if self.failed_minibatches:
            # Re-serve lost work first; entries carry their sample
            # class so retries don't inherit whatever class was served
            # last.
            indices, cls = self.failed_minibatches.pop()
            self.minibatch_class = cls
            self.last_minibatch = False
            self.epoch_ended = False
        else:
            indices = self._next_fresh_indices()
        if slave_id is not None:
            self._pending_indices_.setdefault(slave_id, []).append(
                [(indices, self.minibatch_class)])
        count = len(indices)
        mask = numpy.zeros(self.max_minibatch_size, dtype=numpy.float32)
        mask[:count] = 1.0
        padded = numpy.zeros(self.max_minibatch_size, dtype=numpy.int32)
        padded[:count] = indices
        self.minibatch_indices.mem = padded
        self.minibatch_mask.mem = mask
        self.minibatch_class_vec.mem = numpy.array(
            self.minibatch_class, dtype=numpy.int32)
        self.minibatch_size = count
        self._in_flight_ = [(numpy.array(indices,
                                         dtype=numpy.int32),
                             self.minibatch_class)]
        return indices

    def _next_fresh_indices(self):
        ends = self.class_end_offsets
        if self.global_offset >= self.total_samples:
            self.global_offset = 0
        # (class_of_offset never yields an empty class: an empty
        # class's end equals its start, and the strict < scan passes
        # it by.)
        cls = self.class_of_offset(self.global_offset)
        self.minibatch_class = cls
        cls_end = ends[cls]
        start = self.global_offset
        stop = min(start + self.max_minibatch_size, cls_end)
        self.global_offset = stop
        indices = numpy.array(
            self.shuffled_indices.mem[start:stop], dtype=numpy.int32)
        self._update_flags(stop)
        return indices

    def _update_flags(self, stop):
        """Epoch/flag logic."""
        ends = self.class_end_offsets
        self.last_minibatch = stop in ends and stop != 0
        self.epoch_ended = (stop == self.total_samples)
        if self.epoch_ended:
            self.epoch_number += 1
            self.global_offset = 0
            self.shuffle()

    def _walk_block(self, max_ticks):
        """The one block walk: serves up to ``max_ticks`` consecutive
        minibatches of the SAME sample class (stopping at class
        boundaries so epoch flags stay truthful; failed-batch retries
        are served singly — they may belong to a different class than
        the current walk).  Returns ``(idxs, masks, entries, cls)``:
        padded per-tick index/mask arrays, the trimmed
        ``[(indices, class), ...]`` in-flight entries, and the block's
        class."""
        idxs, masks, entries = [], [], []
        cls = None
        for _ in range(max_ticks):
            if self.failed_minibatches and idxs:
                break
            next_off = self.global_offset \
                if self.global_offset < self.total_samples else 0
            next_cls = self.class_of_offset(next_off)
            if cls is not None and next_cls != cls:
                break
            served = self.serve_next_minibatch()
            cls = self.minibatch_class
            entries.append((numpy.array(served, dtype=numpy.int32),
                            int(cls)))
            idxs.append(self.minibatch_indices.mem.copy())
            masks.append(self.minibatch_mask.mem.copy())
            if self.last_minibatch or self.failed_minibatches:
                break
        return idxs, masks, entries, cls

    def serve_block(self, max_ticks):
        """Serves up to ``max_ticks`` consecutive minibatches of the
        SAME sample class.  Returns {vector_id: (K, ...) array} with
        K = ticks actually served — NOT padded: jit specializes the
        block program per distinct K (a handful per run: the full
        block, the train remainder, the validation remainder), which
        beats burning a full block of conv compute on all-zero masks
        (a 256-sample validation pass used to cost as much as a
        ticks_per_dispatch×batch training block)."""
        idxs, masks, entries, cls = self._walk_block(max_ticks)
        # The WHOLE block is in flight until its one dispatch commits
        # (per-tick serves above each overwrote the record).
        self._in_flight_ = entries
        return {
            str(id(self.minibatch_indices)): numpy.stack(idxs),
            str(id(self.minibatch_mask)): numpy.stack(masks),
            str(id(self.minibatch_class_vec)): numpy.full(
                len(idxs), cls, dtype=numpy.int32),
        }

    # -- the distributed contract ------------------------------------------

    def generate_data_for_slave(self, slave=None):
        """The coordinator ships only indices.  With a negotiated
        multi-tick job size (``--job-ticks``) one job carries up to K
        same-class minibatches, run by the worker as one block; blocks
        stop at class boundaries (and at failed-minibatch retries,
        which are served singly), so every tick of a job shares one
        (epoch, class) accounting bucket."""
        get = getattr(self.workflow, "slave_protocol", None)
        ticks = int((get(slave) if get is not None else {})
                    .get("ticks", 1) or 1)
        if ticks <= 1:
            indices = self.serve_next_minibatch(slave_id=slave)
            return {"indices": indices,
                    "minibatch_class": self.minibatch_class,
                    "epoch_number": self.epoch_number}
        epoch = self.epoch_number
        idxs, masks, entries, cls = self._walk_block(ticks)
        if slave is not None:
            self._pending_indices_.setdefault(slave, []).append(entries)
        return {"block": {
                    "indices": numpy.stack(idxs),
                    "mask": numpy.stack(masks),
                    "classes": numpy.full(len(idxs), cls,
                                          dtype=numpy.int32)},
                "minibatch_class": cls,
                "epoch_number": epoch}

    def apply_data_from_master(self, data):
        """Worker side: the job's minibatch becomes the current one (a
        block is staged for :meth:`take_staged_block`, its first tick
        mirrored into the single-tick vectors)."""
        if "block" in data:
            blk = data["block"]
            indices = numpy.asarray(blk["indices"], dtype=numpy.int32)
            mask = numpy.asarray(blk["mask"], dtype=numpy.float32)
            classes = numpy.asarray(blk["classes"], dtype=numpy.int32)
            self._staged_block_ = {
                str(id(self.minibatch_indices)): indices,
                str(id(self.minibatch_mask)): mask,
                str(id(self.minibatch_class_vec)): classes,
            }
            self.minibatch_indices.mem = indices[0].copy()
            self.minibatch_mask.mem = mask[0].copy()
            self.minibatch_size = int(mask[0].sum())
            self.minibatch_class = int(classes[0])
            self.minibatch_class_vec.mem = classes[0].copy()
            self.epoch_number = data["epoch_number"]
            return
        self._staged_block_ = None
        indices = numpy.asarray(data["indices"], dtype=numpy.int32)
        count = len(indices)
        padded = numpy.zeros(self.max_minibatch_size, dtype=numpy.int32)
        padded[:count] = indices
        mask = numpy.zeros(self.max_minibatch_size, dtype=numpy.float32)
        mask[:count] = 1.0
        self.minibatch_indices.mem = padded
        self.minibatch_mask.mem = mask
        self.minibatch_size = count
        self.minibatch_class = data["minibatch_class"]
        self.minibatch_class_vec.mem = numpy.array(
            self.minibatch_class, dtype=numpy.int32)
        self.epoch_number = data["epoch_number"]

    def take_staged_block(self):
        """Worker side: the job's staged multi-tick block ({vector id →
        (K, ...) array}) or None; consumed once per job."""
        block = self._staged_block_
        self._staged_block_ = None
        return block

    def apply_data_from_slave(self, data, slave=None):
        jobs = self._pending_indices_.get(slave)
        if jobs:
            jobs.pop(0)  # the oldest job answered (serve order, FIFO)
            if not jobs:
                self._pending_indices_.pop(slave, None)

    def drop_slave(self, slave=None):
        """Requeues every tick of every pending job of the dropped
        worker, with its class."""
        for entry in self._pending_indices_.pop(slave, ()):
            self.failed_minibatches.extend(entry)

    # -- pickling: pending work is requeued so nothing is lost -------------

    def __getstate__(self):
        state = super(Loader, self).__getstate__()
        pending = [tick
                   for jobs in self._pending_indices_.values()
                   for entry in jobs
                   for tick in entry]
        state["failed_minibatches"] = (
            list(self.failed_minibatches) + pending)
        return state

    # -- subclass hooks ----------------------------------------------------

    def load_data(self):
        raise NotImplementedError()

    def create_minibatch_data(self):
        raise NotImplementedError()

    def fill_minibatch(self):
        """Host-side materialization hook; device-resident loaders do
        the gather inside the fused step instead."""
