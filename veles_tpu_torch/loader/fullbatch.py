"""Device-resident full-batch loader (the JAX package's
``loader.fullbatch``).

The ENTIRE dataset lives in device memory and each minibatch is
assembled inside the step by gathering rows for the served indices
(``index_select`` on the device): the indices, the mask and the class
are the only per-tick host → device traffic (a few hundred bytes).
"""

import numpy
import torch

from ..accelerated_units import TracedUnit
from ..memory import Vector
from .base import Loader


class FullBatchLoader(Loader, TracedUnit):
    """Keeps the originals on the device; gathers minibatches inside
    the step."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(FullBatchLoader, self).__init__(workflow, **kwargs)
        self.original_data = Vector()
        self.original_labels = Vector()
        self.original_targets = Vector()
        self.minibatch_data = Vector()
        self.minibatch_labels = Vector()
        self.minibatch_targets = Vector()

    # -- ILoader -----------------------------------------------------------

    def create_minibatch_data(self):
        """Allocates minibatch output shells (their shapes drive the
        downstream layers' initialization; contents come from the
        step)."""
        mb = self.max_minibatch_size
        self.minibatch_data.mem = numpy.zeros(
            (mb,) + tuple(self.original_data.shape[1:]),
            dtype=self.original_data.dtype)
        if self.original_labels:
            self.minibatch_labels.mem = numpy.zeros(
                mb, dtype=numpy.int32)
        if self.original_targets:
            self.minibatch_targets.mem = numpy.zeros(
                (mb,) + tuple(self.original_targets.shape[1:]),
                dtype=self.original_targets.dtype)

    def dataset_labels(self):
        """Class-sliced views of the resident labels (originals are
        stored [test, validation, train] concatenated)."""
        if not self.original_labels:
            return None
        return self.slice_labels_by_class(self.original_labels.mem)

    def initialize(self, **kwargs):
        super(FullBatchLoader, self).initialize(**kwargs)
        for vec in (self.original_data, self.original_labels,
                    self.original_targets):
            if vec:
                vec.initialize(self.device)

    # -- fused-step contract -----------------------------------------------

    def step_batch_vectors(self):
        """Per-tick host → device inputs."""
        return [self.minibatch_indices, self.minibatch_mask,
                self.minibatch_class_vec]

    def step_const_vectors(self):
        """Large device-resident constants read by the step."""
        consts = [self.original_data]
        if self.original_labels:
            consts.append(self.original_labels)
        if self.original_targets:
            consts.append(self.original_targets)
        return consts

    def tforward(self, read, write, params, ctx, state=None):
        """The minibatch gather on the device."""
        idx = read(self.minibatch_indices).long()
        write(self.minibatch_data,
              torch.index_select(read(self.original_data), 0, idx))
        if self.original_labels:
            write(self.minibatch_labels,
                  torch.index_select(read(self.original_labels), 0, idx))
        if self.original_targets:
            write(self.minibatch_targets,
                  torch.index_select(read(self.original_targets), 0, idx))

    def run(self):
        """Host part of the tick: serve indices, then trigger the step
        (which gathers and runs everything downstream).  In block mode,
        serves a same-class block and runs its ticks."""
        wf = self.workflow
        ticks = getattr(wf, "ticks_per_dispatch", 1)
        if ticks > 1 and getattr(wf, "fused", False):
            blocks = self.serve_block(ticks)
            wf.begin_tick()
            wf.execute_block(blocks)
            return
        self.serve_next_minibatch()
        if wf is not None and hasattr(wf, "begin_tick"):
            wf.begin_tick()
        TracedUnit.run(self)
