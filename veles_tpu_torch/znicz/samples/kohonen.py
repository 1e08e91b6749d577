"""Kohonen self-organizing map workflow (the JAX package's
``znicz/samples/kohonen.py``).

Graph: Repeater → loader → KohonenForward (best-matching unit) →
KohonenTrainer (neighbourhood pseudo-loss, decaying σ) → decision →
GDKohonen → loop, every tick one step.

Dataset: any FullBatchLoader through ``loader_cls``; the default draws
clustered 2-D blobs from a seeded ``numpy.random.RandomState`` (the same
points as the JAX sample), so the sample runs offline and the map's
organization can be checked (``umatrix()``, ``quantization_error()``).
Run::

    python -m veles_tpu_torch veles_tpu_torch/znicz/samples/kohonen.py \
        --device cpu root.kohonen.max_epochs=12 --random-seed 5
"""

import numpy

from ...accelerated_units import AcceleratedWorkflow
from ...config import root, get as config_get
from ...loader.fullbatch import FullBatchLoader
from ...plumbing import Repeater
from ..decision import DecisionBase
from ..kohonen import GDKohonen, KohonenForward, KohonenTrainer


class BlobLoader(FullBatchLoader):
    """Clustered 2-D points."""

    MAPPING = "som_blob_loader"

    def __init__(self, workflow, **kwargs):
        super(BlobLoader, self).__init__(workflow, **kwargs)
        self.n_clusters = kwargs.get("n_clusters", 4)
        self.n_points = kwargs.get("n_points", 100)
        self.spread = kwargs.get("spread", 0.02)

    def load_data(self):
        rng = numpy.random.RandomState(0)
        centers = rng.rand(self.n_clusters, 2).astype(numpy.float32)
        pts = numpy.concatenate([
            c + rng.normal(0, self.spread, (self.n_points, 2))
            for c in centers])
        self.original_data.mem = pts.astype(numpy.float32)
        self.original_labels.mem = numpy.repeat(
            numpy.arange(self.n_clusters, dtype=numpy.int32),
            self.n_points)
        self.class_lengths = [0, 0, len(pts)]


class KohonenWorkflow(AcceleratedWorkflow):
    """The SOM training workflow."""

    def __init__(self, workflow, shape=(8, 8), minibatch_size=50,
                 learning_rate=0.4, sigma_decay=0.95,
                 max_epochs=None, loader_cls=BlobLoader,
                 loader_config=None, **kwargs):
        super(KohonenWorkflow, self).__init__(workflow, **kwargs)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        self.loader = loader_cls(self, minibatch_size=minibatch_size,
                                 **(loader_config or {}))
        self.loader.link_from(self.repeater)

        self.som = KohonenForward(self, shape=shape, weights_stddev=0.3)
        self.som.link_from(self.loader)
        self.som.input = self.loader.minibatch_data
        self.forwards = [self.som]

        self.trainer = KohonenTrainer(self, forward=self.som,
                                      sigma_decay=sigma_decay)
        self.trainer.link_from(self.som)
        self.trainer.input = self.loader.minibatch_data
        self.trainer.mask = self.loader.minibatch_mask

        self.decision = DecisionBase(self, max_epochs=max_epochs)
        self.decision.link_from(self.trainer)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "last_minibatch",
            "epoch_ended", "epoch_number")

        self.gd = GDKohonen(self, target=self.som,
                            learning_rate=learning_rate)
        self.gd.link_from(self.decision)
        self.gds = [self.gd]
        self.repeater.link_from(self.gd)
        self.repeater.gate_block = self.decision.complete
        self.end_point.link_from(self.gd)
        self.end_point.gate_block = ~self.decision.complete

    def umatrix(self):
        """The U-matrix: each node's mean distance to its grid
        neighbours."""
        self.som.weights.map_read()
        gy, gx = self.som.shape
        w = numpy.array(self.som.weights.mem).reshape(gy, gx, -1)
        u = numpy.zeros((gy, gx), dtype=numpy.float64)
        for y in range(gy):
            for x in range(gx):
                dists = []
                for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    ny, nx = y + dy, x + dx
                    if 0 <= ny < gy and 0 <= nx < gx:
                        dists.append(numpy.linalg.norm(
                            w[y, x] - w[ny, nx]))
                u[y, x] = numpy.mean(dists)
        return u

    def quantization_error(self):
        """Mean distance of every sample to its best-matching unit."""
        self.som.weights.map_read()
        self.loader.original_data.map_read()
        w = numpy.array(self.som.weights.mem)
        x = numpy.array(self.loader.original_data.mem).reshape(
            len(self.loader.original_data.mem), -1)
        d = ((x[:, None, :] - w[None, :, :]) ** 2).sum(-1)
        return float(numpy.sqrt(d.min(axis=1)).mean())


def run(load, main):
    """The command line's hook (``root.kohonen.*`` overrides)."""
    load(KohonenWorkflow,
         shape=tuple(config_get(root.kohonen.shape, (8, 8))),
         minibatch_size=config_get(root.kohonen.minibatch_size, 50),
         learning_rate=config_get(root.kohonen.learning_rate, 0.4),
         max_epochs=config_get(root.kohonen.max_epochs, 20))
    main()
