"""MNIST784 fully-connected workflow (the JAX package's
``znicz/samples/mnist.py``; parity config #1 of BASELINE.json):
Repeater → FullBatchLoader → All2AllTanh(100) → All2AllSoftmax(10) →
EvaluatorSoftmax → DecisionGD → GD chain → loop, every tick one step.

Dataset: real MNIST IDX files under ``root.common.dirs.datasets/mnist``
when present; otherwise scikit-learn's bundled 8×8 digits upsampled to
28×28 (the same 784 features), so the workflow runs offline.  Run::

    python -m veles_tpu_torch veles_tpu_torch/znicz/samples/mnist.py \
        --device cpu
"""

import gzip
import os
import struct

import numpy

from ...accelerated_units import AcceleratedWorkflow
from ...config import root, get as config_get
from ...loader.fullbatch import FullBatchLoader
from ...plumbing import Repeater
from ..all2all import All2AllTanh, All2AllSoftmax
from ..evaluator import EvaluatorSoftmax
from ..decision import DecisionGD
from ..gd import GDTanh, GDSoftmax


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fin:
        magic, = struct.unpack(">I", fin.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, fin.read(4 * ndim))
        data = numpy.frombuffer(fin.read(), dtype=numpy.uint8)
    return data.reshape(dims)


class MnistLoader(FullBatchLoader):
    """70k-sample MNIST (60k train / 10k validation) or the offline
    digits fallback (~1.4k train / ~0.4k validation)."""

    MAPPING = "mnist_loader"

    def load_data(self):
        mnist_dir = os.path.join(
            config_get(root.common.dirs.datasets, "."), "mnist")
        candidates = {
            "train_images": ("train-images-idx3-ubyte",
                             "train-images-idx3-ubyte.gz"),
            "train_labels": ("train-labels-idx1-ubyte",
                             "train-labels-idx1-ubyte.gz"),
            "test_images": ("t10k-images-idx3-ubyte",
                            "t10k-images-idx3-ubyte.gz"),
            "test_labels": ("t10k-labels-idx1-ubyte",
                            "t10k-labels-idx1-ubyte.gz"),
        }
        paths = {}
        for key, names in candidates.items():
            for name in names:
                p = os.path.join(mnist_dir, name)
                if os.path.isfile(p):
                    paths[key] = p
                    break
        if len(paths) == 4:
            self._load_idx(paths)
        else:
            self._load_digits_fallback()

    def _load_idx(self, paths):
        train = _read_idx(paths["train_images"]).astype(
            numpy.float32) / 255.0
        train_l = _read_idx(paths["train_labels"]).astype(numpy.int32)
        test = _read_idx(paths["test_images"]).astype(
            numpy.float32) / 255.0
        test_l = _read_idx(paths["test_labels"]).astype(numpy.int32)
        n_train, n_valid = len(train), len(test)
        data = numpy.concatenate(
            [test.reshape(n_valid, -1), train.reshape(n_train, -1)])
        labels = numpy.concatenate([test_l, train_l])
        self.original_data.mem = data
        self.original_labels.mem = labels
        self.class_lengths = [0, n_valid, n_train]
        self.info("loaded real MNIST: %d train, %d validation",
                  n_train, n_valid)

    def _load_digits_fallback(self):
        from sklearn.datasets import load_digits
        digits = load_digits()
        images = digits.images.astype(numpy.float32) / 16.0
        labels = digits.target.astype(numpy.int32)
        # Nearest-neighbour 8×8 → 28×28 so the feature shape matches
        # MNIST784.
        idx = (numpy.arange(28) * 8) // 28
        images = images[:, idx][:, :, idx]
        n = len(images)
        n_valid = n // 5
        # validation first (class order TEST, VALID, TRAIN).
        self.original_data.mem = images.reshape(n, -1)
        self.original_labels.mem = labels
        self.class_lengths = [0, n_valid, n - n_valid]
        self.info("MNIST files absent — digits fallback: %d train, "
                  "%d validation", n - n_valid, n_valid)


class MnistWorkflow(AcceleratedWorkflow):
    """The MNIST784 training workflow."""

    def __init__(self, workflow, layers=(100, 10), minibatch_size=100,
                 learning_rate=0.03, gradient_moment=0.9,
                 weights_decay=0.0005, max_epochs=None,
                 fail_iterations=25, loader_cls=MnistLoader,
                 loader_config=None, **kwargs):
        super(MnistWorkflow, self).__init__(workflow, **kwargs)

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        self.loader = loader_cls(self, minibatch_size=minibatch_size,
                                 **(loader_config or {}))
        self.loader.link_from(self.repeater)

        # Forward stack: tanh hiddens, softmax output.
        self.forwards = []
        prev, prev_vec = self.loader, self.loader.minibatch_data
        for i, width in enumerate(layers):
            last = i == len(layers) - 1
            cls = All2AllSoftmax if last else All2AllTanh
            layer = cls(self, output_sample_shape=(width,),
                        name="fc%d" % i)
            layer.link_from(prev)
            layer.input = prev_vec
            self.forwards.append(layer)
            prev, prev_vec = layer, layer.output

        self.evaluator = EvaluatorSoftmax(self)
        self.evaluator.link_from(prev)
        self.evaluator.input = self.forwards[-1].logits
        self.evaluator.labels = self.loader.minibatch_labels
        self.evaluator.mask = self.loader.minibatch_mask
        self.evaluator.minibatch_class_vec = \
            self.loader.minibatch_class_vec

        self.decision = DecisionGD(
            self, max_epochs=max_epochs,
            fail_iterations=fail_iterations,
            evaluator=self.evaluator)
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "last_minibatch",
            "epoch_ended", "epoch_number")

        # GD chain, output layer first.
        self.gds = []
        prev_gd = self.decision
        for layer in reversed(self.forwards):
            gd_cls = GDSoftmax if isinstance(layer, All2AllSoftmax) \
                else GDTanh
            gd = gd_cls(self, target=layer,
                        learning_rate=learning_rate,
                        gradient_moment=gradient_moment,
                        weights_decay=weights_decay,
                        name="gd_" + layer.name)
            gd.link_from(prev_gd)
            self.gds.append(gd)
            prev_gd = gd

        self.repeater.link_from(prev_gd)
        self.repeater.gate_block = self.decision.complete
        self.end_point.link_from(prev_gd)
        self.end_point.gate_block = ~self.decision.complete


def run(load, main):
    """The command line's hook (``root.mnist.*`` overrides)."""
    load(MnistWorkflow,
         layers=tuple(config_get(root.mnist.layers, (100, 10))),
         minibatch_size=config_get(root.mnist.minibatch_size, 100),
         learning_rate=config_get(root.mnist.learning_rate, 0.03),
         max_epochs=config_get(root.mnist.max_epochs, 25))
    main()
