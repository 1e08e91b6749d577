"""HDF5 dataset loader (the JAX package's ``loader.hdf5``): per-class
HDF5 files with dataset keys for samples and labels.  ``h5py`` is
imported when a loader reads, not when the module is imported."""

import numpy

from ..error import BadFormatError
from .base import TEST, VALID, TRAIN
from .fullbatch import FullBatchLoader


class HDF5Loader(FullBatchLoader):
    """kwargs ``test_path``/``validation_path``/``train_path`` name .h5
    files; ``data_key``/``labels_key`` select the datasets (default
    "data"/"labels")."""

    MAPPING = "hdf5"

    def __init__(self, workflow, **kwargs):
        super(HDF5Loader, self).__init__(workflow, **kwargs)
        self.paths = {TEST: kwargs.get("test_path"),
                      VALID: kwargs.get("validation_path"),
                      TRAIN: kwargs.get("train_path")}
        self.data_key = kwargs.get("data_key", "data")
        self.labels_key = kwargs.get("labels_key", "labels")

    def load_data(self):
        import h5py
        datas, labels = [], []
        lengths = [0, 0, 0]
        for cls in (TEST, VALID, TRAIN):
            path = self.paths[cls]
            if not path:
                continue
            with h5py.File(path, "r") as fin:
                data = numpy.asarray(fin[self.data_key])
                lengths[cls] = len(data)
                datas.append(data)
                if self.labels_key in fin:
                    labels.append(numpy.asarray(fin[self.labels_key],
                                                dtype=numpy.int32))
        if not datas:
            raise BadFormatError("%s: no hdf5 paths given" % self)
        self.original_data.mem = numpy.concatenate(datas)
        if labels:
            self.original_labels.mem = numpy.concatenate(labels)
        self.class_lengths = lengths
