"""One rank's view of the placed step tensors: local slices of full
values, their gathering back, and the group of ranks that hold copies
of each slice (the step's helpers under a mesh)."""

import torch

from . import collectives as C


class RankView(object):
    """This rank's coordinates on ``mesh`` and the placement arithmetic
    of the step: :meth:`local` slices a full tensor, :meth:`gather`
    (differentiable) and :meth:`gather_full` (not) put a slice back
    together, :meth:`copy_axes` are the axes a gradient sums over."""

    def __init__(self, mesh, data_axis):
        import torch.distributed as dist
        self.mesh = mesh
        self.rank = dist.get_rank() if dist.is_initialized() else \
            int(mesh.ranks.ravel()[0])
        self.coords = mesh.coords(self.rank)
        self.world = mesh.size
        self.data_axis = data_axis

    def local(self, full, placement):
        """The slice of ``full`` this rank holds under ``placement``."""
        t = full
        for dim, axis in enumerate(placement):
            if axis is None:
                continue
            n = self.mesh.shape[axis]
            size = t.shape[dim] // n
            t = t.narrow(dim, self.coords[axis] * size, size)
        return t

    def gather(self, local, placement):
        """The full value from every rank's slice, differentiably (the
        backward reduce-scatters)."""
        t = local
        for dim, axis in enumerate(placement):
            if axis is not None:
                t = C.all_gather(t, dim, self.mesh.group(axis))
        return t

    def gather_full(self, local, placement):
        with torch.no_grad():
            return self.gather(local, placement)

    def copy_axes(self, placement):
        """The mesh axes along which ranks hold the same slice."""
        return tuple(a for a in self.mesh.axis_names
                     if a not in placement)

    def copies(self, placement):
        n = 1
        for a in self.copy_axes(placement):
            n *= self.mesh.shape[a]
        return n

    def batch_group(self):
        """The group over which the minibatch is split (the evaluators'
        ``batch_sum``)."""
        if self.data_axis is None:
            return None
        return self.mesh.group(self.data_axis)


def zero_axis(param_placement, slot_placement):
    """The axis ZeRO put on a slot's dim 0 that its parameter does not
    carry there, or None."""
    if not slot_placement:
        return None
    axis = slot_placement[0]
    p0 = param_placement[0] if param_placement else None
    return axis if axis is not None and axis != p0 else None
