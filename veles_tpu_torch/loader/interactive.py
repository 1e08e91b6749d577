"""Queue-fed loaders (the JAX package's ``loader.interactive``): a
loader whose minibatches arrive from an external producer through a
thread-safe queue instead of a dataset file.  :class:`QueueLoader` is
that shape; :class:`InteractiveLoader` (fed from a shell) and
:class:`RestfulLoader` (fed by HTTP requests) are its names for the
two producers of the reference.
"""

import queue

import numpy

from ..memory import Vector
from .base import Loader, TEST


class QueueLoader(Loader):
    """Serves externally submitted samples (inference streams).

    Producers call :meth:`feed` (a blocking queue put); each tick takes
    up to ``minibatch_size`` pending samples, pads the rest with zeros,
    masks them out and publishes the minibatch as TEST.  ``stop()``
    unblocks a consumer waiting for its first sample.
    """

    MAPPING = "queue"

    def __init__(self, workflow, **kwargs):
        super(QueueLoader, self).__init__(workflow, **kwargs)
        self.sample_shape = tuple(kwargs.get("sample_shape", ()))
        self.minibatch_data = Vector()
        self.minibatch_labels = Vector()
        self.minibatch_contexts = []
        self.queue = queue.Queue(maxsize=kwargs.get("queue_size", 1024))
        self._sentinel = object()

    def feed(self, sample, context=None):
        """Producer side: submits one sample, with an opaque context
        handed back beside the results."""
        self.queue.put((numpy.asarray(sample, dtype=numpy.float32),
                        context))

    def load_data(self):
        if not self.sample_shape:
            raise ValueError("%s requires sample_shape" % self)
        # A queue has no dataset: one TEST pseudo-sample keeps the
        # epoch accounting well formed.
        self.class_lengths = [1, 0, 0]

    def create_minibatch_data(self):
        self.minibatch_data.mem = numpy.zeros(
            (self.max_minibatch_size,) + self.sample_shape,
            dtype=numpy.float32)
        self.minibatch_labels.mem = numpy.zeros(
            self.max_minibatch_size, dtype=numpy.int32)
        self.minibatch_contexts = [None] * self.max_minibatch_size

    def serve_next_minibatch(self):
        self.minibatch_class = TEST
        self.last_minibatch = True
        self.epoch_ended = True
        return []

    def fill_minibatch(self):
        """Blocks for the first sample, then drains up to a full
        minibatch."""
        data = self.minibatch_data.mem
        mask = numpy.zeros(self.max_minibatch_size, dtype=numpy.float32)
        count = 0
        while count < self.max_minibatch_size:
            try:
                item = self.queue.get(block=(count == 0))
            except queue.Empty:
                break
            if item is self._sentinel:
                break
            sample, context = item
            data[count] = sample.reshape(self.sample_shape)
            self.minibatch_contexts[count] = context
            count += 1
        self.minibatch_data.mem = data
        mask[:count] = 1.0
        self.minibatch_mask.mem = mask
        self.minibatch_size = count

    def stop(self):
        self.queue.put(self._sentinel)


class InteractiveLoader(QueueLoader):
    """The name of the queue loader fed from an interactive session."""
    MAPPING = "interactive"


class RestfulLoader(QueueLoader):
    """The name of the queue loader fed by HTTP requests."""
    MAPPING = "restful"
