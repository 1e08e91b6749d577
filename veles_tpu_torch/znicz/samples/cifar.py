"""CIFAR-10 convolutional workflow (the JAX package's
``znicz/samples/cifar.py``; parity config #2 of BASELINE.json).

The znicz/caffe "cifar-quick" shape as a declarative
``StandardWorkflow`` layer list — conv(32,5×5,pad2) →
maxpool(3×3,s2) → conv(32,5×5,pad2) → avgpool(3×3,s2) →
conv(64,5×5,pad2) → avgpool(3×3,s2) → fc(64) → softmax(10) — each
tick (gather, convs, cross-entropy, backward, momentum updates) one
step of ``accelerated_units.StepCompiler``.  Run::

    python -m veles_tpu_torch veles_tpu_torch/znicz/samples/cifar.py \
        root.cifar.max_epochs=5

Dataset: the real CIFAR-10 python batches under
``root.common.dirs.datasets/cifar-10-batches-py`` when present;
otherwise the JAX package's synthetic fallback (class-dependent color
and frequency patterns plus noise, the same bytes from the same
generator), so the workflow trains offline.
"""

import os
import pickle

import numpy

from ...config import root, get as config_get
from ...loader.fullbatch import FullBatchLoader
from ..standard_workflow import StandardWorkflow


class CifarLoader(FullBatchLoader):
    """60k-sample CIFAR-10 (50k train / 10k validation) or the
    synthetic offline fallback."""

    MAPPING = "cifar_loader"

    #: Fallback geometry (kept small so CPU tests stay fast).
    FALLBACK_TRAIN = 1000
    FALLBACK_VALID = 300

    def load_data(self):
        cifar_dir = os.path.join(
            config_get(root.common.dirs.datasets, "."),
            "cifar-10-batches-py")
        train_files = [os.path.join(cifar_dir, "data_batch_%d" % i)
                       for i in range(1, 6)]
        test_file = os.path.join(cifar_dir, "test_batch")
        if all(map(os.path.isfile, train_files)) and \
                os.path.isfile(test_file):
            self._load_real(train_files, test_file)
        else:
            self._load_synthetic_fallback()

    @staticmethod
    def _read_batch(path):
        with open(path, "rb") as fin:
            d = pickle.load(fin, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = numpy.asarray(d[b"labels"], dtype=numpy.int32)
        return data.astype(numpy.float32), labels

    def _load_real(self, train_files, test_file):
        train_x, train_y = [], []
        for path in train_files:
            x, y = self._read_batch(path)
            train_x.append(x)
            train_y.append(y)
        train_x = numpy.concatenate(train_x)
        train_y = numpy.concatenate(train_y)
        test_x, test_y = self._read_batch(test_file)
        # znicz normalized CIFAR linearly to [-1, 1].
        data = numpy.concatenate([test_x, train_x]) / 127.5 - 1.0
        labels = numpy.concatenate([test_y, train_y])
        self.original_data.mem = data.astype(numpy.float32)
        self.original_labels.mem = labels
        self.class_lengths = [0, len(test_x), len(train_x)]
        self.info("loaded real CIFAR-10: %d train, %d validation",
                  len(train_x), len(test_x))

    def _load_synthetic_fallback(self):
        n_train, n_valid = self.FALLBACK_TRAIN, self.FALLBACK_VALID
        n = n_train + n_valid
        rng = numpy.random.RandomState(0)
        labels = (numpy.arange(n) % 10).astype(numpy.int32)
        rng.shuffle(labels)
        yy, xx = numpy.mgrid[0:32, 0:32].astype(numpy.float32) / 31.0
        data = numpy.empty((n, 32, 32, 3), dtype=numpy.float32)
        for i, lab in enumerate(labels):
            freq = 1.0 + (lab % 5)
            phase = (lab // 5) * numpy.pi / 2
            pattern = numpy.sin(2 * numpy.pi * freq * xx + phase) * \
                numpy.cos(2 * numpy.pi * freq * yy)
            color = numpy.array([(lab % 3) - 1.0,
                                 ((lab // 3) % 3) - 1.0,
                                 ((lab // 9) % 3) - 1.0]) * 0.5
            img = pattern[:, :, None] * 0.5 + color[None, None, :]
            data[i] = img + rng.normal(0, 0.15, img.shape)
        self.original_data.mem = numpy.clip(data, -1, 1)
        self.original_labels.mem = labels
        self.class_lengths = [0, n_valid, n_train]
        self.info("CIFAR files absent — synthetic fallback: %d train, "
                  "%d validation", n_train, n_valid)


def cifar_layers(lr=0.001, moment=0.9, decay=0.004):
    gd = {"learning_rate": lr, "gradient_moment": moment,
          "weights_decay": decay}
    return [
        {"type": "conv_str",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": 2,
                "weights_stddev": 1e-4}, "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "conv_str",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": 2,
                "weights_stddev": 0.01}, "<-": dict(gd)},
        {"type": "avg_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "conv_str",
         "->": {"n_kernels": 64, "kx": 5, "ky": 5, "padding": 2,
                "weights_stddev": 0.01}, "<-": dict(gd)},
        {"type": "avg_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "all2all_tanh",
         "->": {"output_sample_shape": (64,),
                "weights_stddev": 0.1}, "<-": dict(gd)},
        {"type": "softmax",
         "->": {"output_sample_shape": (10,),
                "weights_stddev": 0.1}, "<-": dict(gd)},
    ]


class CifarWorkflow(StandardWorkflow):
    """The CIFAR-10 conv training workflow."""

    #: Snapshot name stem (``cifar_current.lnk``).
    snapshot_prefix = "cifar"

    def __init__(self, workflow, minibatch_size=100,
                 learning_rate=0.001, gradient_moment=0.9,
                 weights_decay=0.004, max_epochs=None,
                 fail_iterations=50, layers=None,
                 loader_cls=CifarLoader, **kwargs):
        super(CifarWorkflow, self).__init__(
            workflow,
            layers=layers or cifar_layers(
                learning_rate, gradient_moment, weights_decay),
            loader_cls=loader_cls,
            loader_config={"minibatch_size": minibatch_size},
            decision_config={"max_epochs": max_epochs,
                             "fail_iterations": fail_iterations},
            loss_function="softmax", **kwargs)


def run(load, main):
    load(CifarWorkflow,
         minibatch_size=config_get(root.cifar.minibatch_size, 100),
         learning_rate=config_get(root.cifar.learning_rate, 0.001),
         max_epochs=config_get(root.cifar.max_epochs, 50))
    main()
