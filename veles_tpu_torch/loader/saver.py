"""Minibatch stream dump and replay (the JAX package's
``loader.saver``): :class:`MinibatchesSaver` writes the preprocessed
minibatch stream of a run to disk, :class:`MinibatchesLoader` feeds a
later run from the dump.  The dump's format is the JAX package's: a
magic line, then one pickled record per minibatch."""

import gzip
import pickle

import numpy

from ..error import BadFormatError
from ..memory import map_read_all
from ..units import Unit
from .fullbatch import FullBatchLoader

MAGIC = b"VTPUMB1\n"


class MinibatchesSaver(Unit):
    """Appends every served minibatch to a (gzipped) pickle stream.
    Link after the loader:
    ``saver.link_attrs(loader, "minibatch_data", "minibatch_labels",
    "minibatch_mask", "minibatch_class")``.  Minibatches that live on
    the card come to the host in one transfer per tick."""

    def __init__(self, workflow, **kwargs):
        self.file_name = kwargs.get("file_name", "minibatches.dmp.gz")
        self.compression = kwargs.get("compression", "gz")
        super(MinibatchesSaver, self).__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self._fout_ = None
        self.demand("minibatch_data", "minibatch_mask", "minibatch_class")

    def initialize(self, **kwargs):
        super(MinibatchesSaver, self).initialize(**kwargs)
        opener = gzip.open if self.compression == "gz" else open
        self._fout_ = opener(self.file_name, "wb")
        self._fout_.write(MAGIC)

    def run(self):
        labels = getattr(self, "minibatch_labels", None)
        if labels is not None and not labels:
            labels = None
        fields = [self.minibatch_data, self.minibatch_mask]
        map_read_all(fields + ([labels] if labels is not None else []))
        record = {
            "data": numpy.array(self.minibatch_data.mem),
            "labels": None if labels is None else numpy.array(labels.mem),
            "mask": numpy.array(self.minibatch_mask.mem),
            "class": int(self.minibatch_class),
        }
        pickle.dump(record, self._fout_, protocol=pickle.HIGHEST_PROTOCOL)

    def stop(self):
        if self._fout_ is not None:
            self._fout_.close()
            self._fout_ = None


def read_minibatch_stream(path):
    """Yields the records of a dump."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fin:
        if fin.read(len(MAGIC)) != MAGIC:
            raise BadFormatError("%s is not a minibatch dump" % path)
        while True:
            try:
                yield pickle.load(fin)
            except EOFError:
                return


class MinibatchesLoader(FullBatchLoader):
    """Replays a dump as a full-batch dataset (valid rows only, grouped
    by sample class)."""

    MAPPING = "minibatches"

    def __init__(self, workflow, **kwargs):
        super(MinibatchesLoader, self).__init__(workflow, **kwargs)
        self.file_name = kwargs["file_name"]

    def load_data(self):
        per_class = {0: ([], []), 1: ([], []), 2: ([], [])}
        for rec in read_minibatch_stream(self.file_name):
            valid = rec["mask"] > 0
            arrs, labs = per_class[rec["class"]]
            arrs.append(rec["data"][valid])
            if rec["labels"] is not None:
                labs.append(rec["labels"][valid])
        datas, labels = [], []
        lengths = [0, 0, 0]
        for cls in (0, 1, 2):
            arrs, labs = per_class[cls]
            if not arrs:
                continue
            data = numpy.concatenate(arrs)
            lengths[cls] = len(data)
            datas.append(data)
            if labs:
                labels.append(numpy.concatenate(labs))
        if not datas:
            raise BadFormatError("dump %s is empty" % self.file_name)
        self.original_data.mem = numpy.concatenate(datas)
        if labels:
            self.original_labels.mem = numpy.concatenate(labels)
        self.class_lengths = lengths
