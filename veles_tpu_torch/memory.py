"""Host/device array pairs (the JAX package's ``memory``).

Every tensor a unit owns is a :class:`Vector` pairing a host numpy
array with a device ``torch.Tensor``, moved between the two by the
explicit ``map_read`` / ``map_write`` / ``map_invalidate`` / ``unmap``
protocol, so host code never observes stale data:

* ``map_read`` pulls device → host only when the device copy is newer;
* ``map_write`` makes the host copy authoritative; the next
  ``devmem`` access (or ``unmap``) uploads it;
* ``devmem = tensor`` (the output of a step) makes the device copy
  authoritative without any transfer.

The device is the one the Vector was initialized with (a
``backends.Device``); a Vector never initialized lives on the CPU.
Pickling maps device → host first.

Under a mesh the step may *hold* a Vector (:meth:`Vector.hold`): its
value then lives as this rank's shard inside the step, the Vector drops
its full tensor, and the first full read (``devmem``, ``map_read``,
``map_write``, a pickle) asks the holder to gather it back — a
collective, so every rank of the mesh reads alike.  Writing the Vector
(``mem =``, ``devmem =``, ``map_invalidate``, ``reset``) ends the hold.
"""

import threading

import numpy
import torch

from .distributable import Pickleable


def torch_device(device):
    """The ``torch.device`` of a port Device (or None → the CPU)."""
    if device is None:
        return torch.device("cpu")
    return getattr(device, "torch_device", None) or torch.device(device)


class Vector(Pickleable):
    """A host+device array."""

    def __init__(self, data=None):
        super(Vector, self).__init__()
        self._mem = None
        if data is not None:
            self.mem = data

    def init_unpickled(self):
        super(Vector, self).init_unpickled()
        self._devmem_ = None
        self._device_ = None
        # Host authoritative (_host_dirty_), device authoritative with
        # a stale host (_host_stale_), or synced (neither).
        self._host_dirty_ = True
        self._host_stale_ = False
        self._lock_ = threading.RLock()
        # The mesh placement (``parallel.mesh``): transient, re-applied
        # on whatever topology exists after a restore.
        self._placement_ = None
        # The step holding this Vector's shard (see ``hold``), with the
        # full value's shape and dtype.
        self._holder_ = None
        self._held_meta_ = None

    @property
    def placement(self):
        """One mesh axis (or None) per dimension, or None: how a mesh
        splits this tensor over its ranks (``parallel.mesh``)."""
        return self._placement_

    @placement.setter
    def placement(self, value):
        self._placement_ = None if value is None else tuple(value)

    # -- host side ---------------------------------------------------------

    @property
    def mem(self):
        return self._mem

    @mem.setter
    def mem(self, value):
        with self._lock_:
            if value is None:
                self.reset()
                return
            self._holder_ = None
            self._mem = numpy.ascontiguousarray(value)
            self._host_dirty_ = True
            self._host_stale_ = False

    @property
    def shape(self):
        if self._holder_ is not None:
            return self._held_meta_[0]
        if self._mem is not None:
            return self._mem.shape
        if self._devmem_ is not None:
            return tuple(self._devmem_.shape)
        return None

    @property
    def dtype(self):
        if self._holder_ is not None:
            return self._held_meta_[1]
        if self._mem is not None:
            return self._mem.dtype
        if self._devmem_ is not None:
            # numpy has no bfloat16: such a tensor reports its torch
            # dtype.
            dt = self._devmem_.dtype
            return dt if dt == torch.bfloat16 else numpy.dtype(
                str(dt).replace("torch.", ""))
        return None

    @property
    def size(self):
        shape = self.shape
        if shape is None:
            return 0
        n = 1
        for d in shape:
            n *= d
        return n

    @property
    def nbytes(self):
        if self._holder_ is not None:
            return self.size * self._held_meta_[2]
        if self._mem is not None:
            return self._mem.nbytes
        if self._devmem_ is not None:
            return self._devmem_.numel() * self._devmem_.element_size()
        return 0

    def __bool__(self):
        return self._mem is not None or self._devmem_ is not None or \
            self._holder_ is not None

    def __len__(self):
        shape = self.shape
        return shape[0] if shape else 0

    def __getitem__(self, key):
        self.map_read()
        return self._mem[key]

    def __setitem__(self, key, value):
        self.map_write()
        self._mem[key] = value

    def __repr__(self):
        return "<Vector shape=%s dtype=%s device=%s>" % (
            self.shape, self.dtype,
            self._devmem_.device if self._devmem_ is not None else "no")

    # -- device side -------------------------------------------------------

    @property
    def device(self):
        return self._device_

    def initialize(self, device):
        """Attaches to a device; the upload is lazy."""
        with self._lock_:
            if device is self._device_:
                return
            self._unhold()
            if self._devmem_ is not None:
                self._host_sync()
                self._free_device()
            self._device_ = device

    @property
    def devmem(self):
        """The current device tensor — uploads host data first if the
        host copy is authoritative."""
        with self._lock_:
            self._unhold()
            if self._host_dirty_ or self._devmem_ is None:
                self._upload()
            return self._devmem_

    @devmem.setter
    def devmem(self, value):
        """Takes a freshly computed device tensor: the device copy
        becomes authoritative and the host copy stale, with no
        transfer until ``map_read``."""
        with self._lock_:
            self._holder_ = None
            self._devmem_ = value
            self._host_dirty_ = False
            self._host_stale_ = value is not None
            if value is not None and self._mem is not None and \
                    tuple(value.shape) != self._mem.shape:
                self._mem = None

    def hold(self, holder):
        """The value now lives as a shard inside ``holder`` (a
        ``StepCompiler``): the full device tensor is dropped, and the
        next full read calls ``holder.gather_state()``, which writes
        every held Vector back through ``devmem``."""
        with self._lock_:
            if self._holder_ is None:
                t = self._devmem_
                self._held_meta_ = (
                    self.shape, self.dtype, t.element_size()
                    if t is not None else numpy.dtype(self.dtype).itemsize)
            self._holder_ = holder
            self._devmem_ = None
            self._host_dirty_ = False
            self._host_stale_ = True

    @property
    def holder(self):
        """The step holding this Vector's shard, or None."""
        return self._holder_

    def _unhold(self):
        if self._holder_ is not None:
            self._holder_.gather_state()

    def _upload(self):
        if self._mem is None:
            return
        # A copy: torch.from_numpy alone would alias the host array on
        # the CPU device.
        self._devmem_ = torch.from_numpy(self._mem).to(
            torch_device(self._device_), copy=True)
        self._host_dirty_ = False
        self._host_stale_ = False

    def _host_sync(self):
        """Device → host, only when the device copy is authoritative
        and the host copy stale."""
        if self._devmem_ is not None and self._host_stale_:
            self._mem = self._devmem_.detach().cpu().numpy().copy()
            self._host_stale_ = False

    def _free_device(self):
        self._devmem_ = None
        self._host_dirty_ = self._mem is not None
        self._host_stale_ = False

    # -- map protocol ------------------------------------------------------

    def map_read(self):
        """Ensures the host copy reflects the freshest data."""
        with self._lock_:
            self._unhold()
            self._host_sync()

    def map_write(self):
        """Host copy becomes authoritative; device copy is stale."""
        with self._lock_:
            self._unhold()
            self._host_sync()
            self._host_dirty_ = True
            self._host_stale_ = False

    def map_invalidate(self):
        """Host copy becomes authoritative WITHOUT downloading first
        (the caller will overwrite everything)."""
        with self._lock_:
            self._holder_ = None
            self._host_dirty_ = True
            self._host_stale_ = False

    def unmap(self):
        """Pushes host data to the device if the host copy is
        authoritative."""
        with self._lock_:
            if self._host_dirty_ and self._mem is not None and \
                    self._device_ is not None:
                self._upload()

    def reset(self, new_mem=None):
        """Drops all data."""
        with self._lock_:
            self._holder_ = None
            self._free_device()
            self._mem = None
            if new_mem is not None:
                self.mem = new_mem

    # -- pickling ----------------------------------------------------------

    def __getstate__(self):
        self.map_read()
        return super(Vector, self).__getstate__()


def map_read_all(vectors):
    """``map_read`` of several Vectors with one device → host transfer
    per device: the device copies that are newer than their host copies
    are packed into one byte tensor, copied to the host once and split.
    (bfloat16 tensors, which numpy cannot hold, take ``map_read``'s own
    path.)  Held Vectors are gathered first."""
    for vec in vectors:
        vec._unhold()
    stale = {}
    for vec in vectors:
        t = vec._devmem_
        if t is not None and vec._host_stale_ and \
                t.dtype != torch.bfloat16:
            stale.setdefault(t.device, []).append(vec)
    for vecs in stale.values():
        tensors = [v._devmem_.detach().contiguous() for v in vecs]
        host = torch.cat([t.reshape(-1).view(torch.uint8)
                          for t in tensors]).cpu().numpy()
        offset = 0
        for vec, t in zip(vecs, tensors):
            n = t.numel() * t.element_size()
            dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
            with vec._lock_:
                vec._mem = host[offset:offset + n].view(dtype).reshape(
                    tuple(t.shape)).copy()
                vec._host_stale_ = False
            offset += n
    for vec in vectors:
        vec.map_read()
