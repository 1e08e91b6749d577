"""ImageNet AlexNet workflow (the JAX package's
``znicz/samples/imagenet.py``; parity config #3 of BASELINE.json).

uint8 originals stay on the device, each minibatch is gathered inside
the step and normalized there by the mean-disp normalizer, then runs
the ungrouped AlexNet: conv96@11×11s4 → LRN → maxpool3s2 →
conv256@5×5p2 → LRN → maxpool → conv384@3×3p1 → conv384 → conv256 →
maxpool → fc4096+dropout → fc4096+dropout → softmax1000 (~61M
parameters at 227 px and 1000 classes).  The two LRN layers run the
hand-written kernels on the card (``znicz/lrn.py``).  Run::

    python -m veles_tpu_torch veles_tpu_torch/znicz/samples/imagenet.py \
        root.imagenet.minibatch_size=512 root.imagenet.max_epochs=1

(the default device is the CUDA card; for a CPU run add ``--device
cpu`` and a small synthetic set, e.g. ``root.imagenet.sim_image_size=67
root.imagenet.sim_train=64 root.imagenet.sim_valid=32
root.imagenet.minibatch_size=16`` — the full-width stack at 67 px
ends in a 1×1×256 map).

Dataset: preprocessed numpy archives under
``root.common.dirs.datasets/imagenet`` (``{train,valid}_data.npy``
uint8 NHWC + ``{train,valid}_labels.npy`` int32) when present;
otherwise a synthetic class-structured uint8 set sized by the loader's
kwargs.  The streamed (disk-memmapped) loader is not yet ported
(ROADMAP A4): ``StreamedImagenetLoader`` raises.
"""

import os

import numpy

from ...config import root, get as config_get
from ...loader.base import VALID
from ...loader.fullbatch import FullBatchLoader
from ...mean_disp_normalizer import MeanDispNormalizer
from ..standard_workflow import StandardWorkflow


def fill_synthetic(out, labels, rng, s):
    """Class-dependent spatial frequency/phase patterns + noise,
    quantized to bytes: learnable by a conv stack, and the uint8 →
    mean-disp path is the real pipeline's.  Byte for byte the JAX
    package's: the same labels and generator give the same images."""
    yy, xx = numpy.mgrid[0:s, 0:s].astype(numpy.float32) / (s - 1)
    for i, lab in enumerate(labels):
        freq = 1.0 + (lab % 7)
        phase = (lab // 7) * 0.7
        pattern = numpy.sin(2 * numpy.pi * freq * xx + phase) * \
            numpy.cos(2 * numpy.pi * freq * yy + phase)
        img = pattern[:, :, None] * 80.0 + 128.0 + \
            rng.normal(0, 20.0, (s, s, 3))
        out[i] = numpy.clip(img, 0, 255).astype(numpy.uint8)


def analyze_mean_disp(train, chunk_bytes=1 << 28):
    """Train-set per-pixel mean and reciprocal dispersion (the
    normalizer's constants), accumulated in float64 over chunks of any
    array-like, so the originals are never copied to float whole."""
    n = len(train)
    s = numpy.zeros(train.shape[1:], dtype=numpy.float64)
    s2 = numpy.zeros(train.shape[1:], dtype=numpy.float64)
    chunk = max(1, chunk_bytes // max(
        1, int(numpy.prod(train.shape[1:])) * 8))
    for i in range(0, n, chunk):
        part = numpy.asarray(train[i:i + chunk],
                             dtype=numpy.float64)
        s += part.sum(axis=0)
        s2 += (part * part).sum(axis=0)
    mean = s / n
    disp = numpy.sqrt(numpy.maximum(s2 / n - mean * mean, 0.0))
    rdisp = 1.0 / numpy.maximum(disp, 1e-3)
    return mean.astype(numpy.float32), rdisp.astype(numpy.float32)


class ImagenetLoader(FullBatchLoader):
    """Device-resident uint8 image loader with the mean/rdisp
    analysis."""

    MAPPING = "imagenet_loader"

    def __init__(self, workflow, **kwargs):
        super(ImagenetLoader, self).__init__(workflow, **kwargs)
        from ...memory import Vector
        self.mean = Vector()
        self.rdisp = Vector()
        # Synthetic-fallback geometry.
        self.sim_image_size = kwargs.get("sim_image_size", 227)
        self.sim_classes = kwargs.get("sim_classes", 1000)
        self.sim_train = kwargs.get("sim_train", 2048)
        self.sim_valid = kwargs.get("sim_valid", 256)

    def load_data(self):
        d = os.path.join(config_get(root.common.dirs.datasets, "."),
                         "imagenet")
        names = ("train_data.npy", "train_labels.npy",
                 "valid_data.npy", "valid_labels.npy")
        paths = [os.path.join(d, n) for n in names]
        if all(map(os.path.isfile, paths)):
            self._load_npy(*paths)
        else:
            self._load_synthetic()
        self._analyze_mean_disp()

    def _load_npy(self, train_d, train_l, valid_d, valid_l):
        train = numpy.load(train_d)
        train_labels = numpy.load(train_l).astype(numpy.int32)
        valid = numpy.load(valid_d)
        valid_labels = numpy.load(valid_l).astype(numpy.int32)
        self.original_data.mem = numpy.concatenate([valid, train])
        self.original_labels.mem = numpy.concatenate(
            [valid_labels, train_labels])
        self.class_lengths = [0, len(valid), len(train)]
        self.info("loaded imagenet npy: %d train, %d validation",
                  len(train), len(valid))

    def _load_synthetic(self):
        s = self.sim_image_size
        n = self.sim_train + self.sim_valid
        rng = numpy.random.RandomState(0)
        labels = (numpy.arange(n) % self.sim_classes).astype(
            numpy.int32)
        rng.shuffle(labels)
        data = numpy.empty((n, s, s, 3), dtype=numpy.uint8)
        fill_synthetic(data, labels, rng, s)
        self.original_data.mem = data
        self.original_labels.mem = labels
        self.class_lengths = [0, self.sim_valid, self.sim_train]
        self.info("imagenet files absent — synthetic fallback: "
                  "%d train, %d validation (%dpx, %d classes)",
                  self.sim_train, self.sim_valid, s, self.sim_classes)

    def _analyze_mean_disp(self):
        train_start = self.class_end_offsets[VALID]
        mean, rdisp = analyze_mean_disp(
            self.original_data.mem[train_start:])
        self.mean.mem = mean
        self.rdisp.mem = rdisp


class StreamedImagenetLoader(FullBatchLoader):
    """The streamed (disk-memmapped, double-buffered) ImageNet loader
    of the JAX package: not yet ported (it needs ``loader/stream.py``,
    ROADMAP A4)."""

    MAPPING = "imagenet_stream_loader"

    def __init__(self, workflow, **kwargs):
        raise NotImplementedError(
            "StreamedImagenetLoader is not yet ported (ROADMAP A4: "
            "loader/stream.py)")


def alexnet_layers(n_classes=1000, lr=0.01, moment=0.9, decay=5e-4):
    gd = {"learning_rate": lr, "gradient_moment": moment,
          "weights_decay": decay}
    return [
        {"type": "conv_str",
         "->": {"n_kernels": 96, "kx": 11, "ky": 11,
                "sliding": (4, 4), "weights_stddev": 0.01,
                "bias_stddev": 0}, "<-": dict(gd)},
        {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5,
                                "k": 2.0}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "conv_str",
         "->": {"n_kernels": 256, "kx": 5, "ky": 5, "padding": 2,
                "weights_stddev": 0.01}, "<-": dict(gd)},
        {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5,
                                "k": 2.0}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "conv_str",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": 1,
                "weights_stddev": 0.01}, "<-": dict(gd)},
        {"type": "conv_str",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": 1,
                "weights_stddev": 0.01}, "<-": dict(gd)},
        {"type": "conv_str",
         "->": {"n_kernels": 256, "kx": 3, "ky": 3, "padding": 1,
                "weights_stddev": 0.01}, "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "all2all_str",
         "->": {"output_sample_shape": (4096,),
                "weights_stddev": 0.005}, "<-": dict(gd)},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "all2all_str",
         "->": {"output_sample_shape": (4096,),
                "weights_stddev": 0.005}, "<-": dict(gd)},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "softmax",
         "->": {"output_sample_shape": (n_classes,),
                "weights_stddev": 0.01}, "<-": dict(gd)},
    ]


class AlexNetWorkflow(StandardWorkflow):
    """The AlexNet training workflow with in-step byte normalization."""

    def __init__(self, workflow, layers=None, minibatch_size=256,
                 learning_rate=0.01, gradient_moment=0.9,
                 weights_decay=5e-4, max_epochs=None,
                 fail_iterations=10, loader_cls=ImagenetLoader,
                 loader_config=None, n_classes=1000, **kwargs):
        cfg = {"minibatch_size": minibatch_size}
        cfg.update(loader_config or {})
        super(AlexNetWorkflow, self).__init__(
            workflow,
            layers=layers or alexnet_layers(
                n_classes, learning_rate, gradient_moment,
                weights_decay),
            loader_cls=loader_cls, loader_config=cfg,
            decision_config={"max_epochs": max_epochs,
                             "fail_iterations": fail_iterations},
            loss_function="softmax", **kwargs)

    def first_source(self):
        """Inserts the mean-disp normalizer between the loader's byte
        gather and conv1."""
        self.normalizer = MeanDispNormalizer(self)
        self.normalizer.link_from(self.loader)
        self.normalizer.input = self.loader.minibatch_data
        self.normalizer.mean = self.loader.mean
        self.normalizer.rdisp = self.loader.rdisp
        return self.normalizer, self.normalizer.output


#: ``root.imagenet`` keys handed to the loader (the synthetic set's
#: geometry and the label check).
LOADER_KEYS = ("sim_image_size", "sim_classes", "sim_train", "sim_valid",
               "validate_labels")


def run(load, main):
    """The command line's hook: ``root.imagenet.minibatch_size``,
    ``learning_rate``, ``max_epochs``, ``n_classes``, ``layers`` (a
    list of layer dicts; default :func:`alexnet_layers`) and the loader
    keys of :data:`LOADER_KEYS`."""
    cfg = root.imagenet
    loader_config = {key: cfg.get(key) for key in LOADER_KEYS
                     if cfg.get(key) is not None}
    load(AlexNetWorkflow,
         minibatch_size=config_get(cfg.minibatch_size, 256),
         learning_rate=config_get(cfg.learning_rate, 0.01),
         max_epochs=config_get(cfg.max_epochs, 90),
         n_classes=config_get(cfg.n_classes, 1000),
         layers=config_get(cfg.layers, None),
         loader_config=loader_config)
    main()
