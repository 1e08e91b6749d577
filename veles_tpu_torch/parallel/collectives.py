"""Differentiable collectives over ``torch.distributed`` process groups.

Each function is an ``autograd.Function`` whose backward is the true
adjoint of its forward, so a step that every rank of a world runs as
the same program differentiates exactly: ``all_reduce`` ↔
``all_reduce``, ``all_gather`` ↔ reduce-scatter, ``all_to_all`` ↔ the
reverse ``all_to_all``, the ring ``shift`` ↔ the opposite shift.  The
step scales each rank's loss by ``1 / world`` and sums each gradient
over the ranks that hold copies of the same parameter slice
(:func:`reduce_gradients`), which yields the gradient of the one loss
the ranks compute together.

``group`` None means "no group": every function is then the identity
(a workflow without a mesh).  A group of one rank still runs the
collective — on the card that is an NCCL call — except the point-to-
point shift, which a one-rank ring does not need.
"""

import torch
import torch.distributed as dist


def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group):
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce(x, group):
    """Sum of ``x`` over the group, on every rank."""
    if group is None:
        return x
    return _AllReduce.apply(x, group)


def _gather(x, dim, group):
    n = group_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, dim, group):
    n = group_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


def all_gather(x, dim, group):
    """The group's shards of ``x`` concatenated along ``dim`` in rank
    order, on every rank."""
    if group is None:
        return x
    return _AllGather.apply(x, dim, group)


def reduce_scatter(x, dim, group):
    """Sum over the group, each rank keeping its slice along ``dim``
    (not differentiable: the step's ZeRO-2 gradient path)."""
    if group is None:
        return x
    return _reduce_scatter(x, dim, group)


def _all_to_all(x, split_dim, concat_dim, group):
    n = group_size(group)
    pieces = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()
    out = torch.empty_like(pieces)
    dist.all_to_all_single(out, pieces, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, concat_dim, split_dim, ctx.group), None,
                None, None)


def all_to_all(x, split_dim, concat_dim, group):
    """Chunk ``i`` of ``x`` along ``split_dim`` goes to rank ``i``; the
    chunks received are concatenated along ``concat_dim`` in rank
    order (``lax.all_to_all(..., tiled=True)``)."""
    if group is None:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def _shift(x, step, group):
    """Sends ``x`` to the group rank ``rank + step`` and returns what
    arrived from ``rank - step``."""
    n = group_size(group)
    if n == 1:
        return x
    rank = group_rank(group)
    to = dist.get_global_rank(group, (rank + step) % n)
    frm = dist.get_global_rank(group, (rank - step) % n)
    x = x.contiguous()
    buf = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, to, group=group),
           dist.P2POp(dist.irecv, buf, frm, group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, step, group):
        ctx.step, ctx.group = step, group
        return _shift(x, step, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.step, ctx.group), None, None


def shift(x, group, step=1):
    """The ring hand-off (``lax.ppermute`` with ``i → i + step``):
    every rank sends ``x`` on and receives its predecessor's."""
    if group is None:
        return x
    return _Shift.apply(x, step, group)


def reduce_gradients(grads, groups):
    """Sums each gradient over its group, one ``all_reduce`` per group
    over the gradients it holds flattened together.  ``groups`` maps a
    gradient's name to its group (None: nothing to sum)."""
    buckets = {}
    for name, group in groups.items():
        if group is not None:
            buckets.setdefault(group, []).append(name)
    out = dict(grads)
    for group, names in buckets.items():
        flat = torch.cat([grads[n].reshape(-1).float() for n in names])
        dist.all_reduce(flat, group=group)
        offset = 0
        for n in names:
            g = grads[n]
            out[n] = flat[offset:offset + g.numel()].reshape(
                g.shape).to(g.dtype)
            offset += g.numel()
    return out
