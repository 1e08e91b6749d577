"""Pickled-array dataset loader (the JAX package's ``loader.pickles``):
one pickle file per sample class, each holding the samples and
optionally labels and targets."""

import pickle

import numpy

from ..error import BadFormatError
from .base import TEST, VALID, TRAIN
from .fullbatch import FullBatchLoader


class PicklesLoader(FullBatchLoader):
    """kwargs ``test_path``/``validation_path``/``train_path`` name
    pickle files holding an array, a ``(data, labels[, targets])``
    tuple, or a dict with "data"/"labels"/"targets" keys."""

    MAPPING = "pickles"

    def __init__(self, workflow, **kwargs):
        super(PicklesLoader, self).__init__(workflow, **kwargs)
        self.paths = {TEST: kwargs.get("test_path"),
                      VALID: kwargs.get("validation_path"),
                      TRAIN: kwargs.get("train_path")}

    @staticmethod
    def _unpack(obj):
        if isinstance(obj, dict):
            return obj["data"], obj.get("labels"), obj.get("targets")
        if isinstance(obj, tuple) and len(obj) >= 2:
            return obj[0], obj[1], (obj[2] if len(obj) > 2 else None)
        return obj, None, None

    def load_data(self):
        datas, labels, targets = [], [], []
        lengths = [0, 0, 0]
        for cls in (TEST, VALID, TRAIN):
            path = self.paths[cls]
            if not path:
                continue
            with open(path, "rb") as fin:
                data, labs, tgts = self._unpack(pickle.load(fin))
            data = numpy.asarray(data)
            lengths[cls] = len(data)
            datas.append(data)
            if labs is not None:
                labels.append(numpy.asarray(labs, dtype=numpy.int32))
            if tgts is not None:
                targets.append(numpy.asarray(tgts))
        if not datas:
            raise BadFormatError("%s: no pickle paths given" % self)
        self.original_data.mem = numpy.concatenate(datas)
        if labels:
            self.original_labels.mem = numpy.concatenate(labels)
        if targets:
            self.original_targets.mem = numpy.concatenate(targets)
        self.class_lengths = lengths
