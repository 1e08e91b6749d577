"""Pipeline parallelism over a mesh's stage axis (the JAX package's
``ops.pipeline``): GPipe, 1F1B (PipeDream-flush) and interleaved
(Megatron) schedules on ``torch.distributed``.

A stack of identically shaped layer applications lies one stage per
rank (the stacked parameters split on their leading dim), the batch
splits into M microbatches, and at every step of the schedule each rank
applies its chunk to the microbatch it holds and hands the activation
to the next stage by point-to-point (``collectives.shift``).

* :func:`schedule_steps` — the static table every schedule runs, a
  pure-Python simulation; :func:`bubble_fraction` reads the idle share
  from it; :func:`_table_arrays` packs it;
* :func:`pipeline` (and :func:`gpipe`) — the table-driven loop.  Its
  backward is one ``autograd.Function`` that walks the table in
  reverse: each active step re-runs its chunk from the input it saved
  (the rematerialization that defines 1F1B's memory class — every
  schedule here keeps one chunk input per step, not the chunks'
  internals) and hands the input gradient back to the previous stage;
  every rank runs the same shifts in the same order, active or idle;
* :func:`sequential_stack` — the same layers in a plain loop, the
  parity oracle.

Every schedule computes the function :func:`sequential_stack` computes.
"""

import numpy
import torch

#: Valid pipeline schedules.
SCHEDULES = ("gpipe", "1f1b", "interleaved")


def init_parser(parser):
    """The pipeline flags of the command line (handed to
    ``root.common.engine`` by ``__main__``)."""
    parser.add_argument(
        "--pp-schedule", default=None, choices=SCHEDULES,
        help="pipeline-parallel schedule for stage-stacked transformer "
             "stacks: 'gpipe' (fill-and-drain, default), '1f1b' "
             "(PipeDream-flush) or 'interleaved' (Megatron V-chunk "
             "stages; see --pp-chunks)")
    parser.add_argument(
        "--pp-chunks", type=int, default=None, metavar="V",
        help="interleaved schedule: virtual chunks per pipeline stage "
             "(default: one chunk per local block; the block count must "
             "divide into stages x chunks)")


def _validate(x, n_microbatches, n_layers, n_stages):
    """The argument checks, with the JAX package's messages."""
    if not torch.is_floating_point(x):
        raise TypeError(
            "pipeline input dtype %s is not a float dtype — the "
            "pipelined stack carries a float activation stream (embed "
            "integer tokens before the stack instead of relying on a "
            "silent astype)" % str(x.dtype).replace("torch.", ""))
    B = x.shape[0]
    if n_microbatches < 1:
        raise ValueError(
            "n_microbatches must be >= 1, got %d" % n_microbatches)
    if n_microbatches > B:
        raise ValueError(
            "n_microbatches=%d exceeds the batch size %d — every "
            "microbatch needs at least one sample (lower n_microbatches "
            "or raise the minibatch size)" % (n_microbatches, B))
    if B % n_microbatches:
        raise ValueError("batch %d not divisible into %d microbatches"
                         % (B, n_microbatches))
    if n_layers % n_stages:
        raise ValueError(
            "%d stacked layers do not divide over %d pipeline stages"
            % (n_layers, n_stages))


def sequential_stack(fn, stacked_params, x):
    """The stacked layers applied in order — the parity oracle:
    ``fn(p[L-1], … fn(p[0], x))`` with x as float32."""
    n = next(iter(stacked_params.values())).shape[0]
    h = x.float()
    for i in range(n):
        h = fn({k: v[i] for k, v in stacked_params.items()}, h)
    return h


# -- schedule tables -------------------------------------------------------

def schedule_steps(schedule, n_stages, n_microbatches, n_chunks=1):
    """The static schedule table: T steps, each a list of ``n_stages``
    entries — None (an idle slot) or a dict with ``chunk`` (local chunk
    index), ``mb`` (microbatch), ``fresh`` (input is the microbatch
    itself) and ``final`` (output is the finished microbatch).  GPipe
    and 1F1B are stage-granular with T = M + S − 1; interleaved packs
    groups of min(S, M) microbatches through V chunks per rank (global
    chunk j on rank j mod S), T = M·V + S − 1 for M ≥ S."""
    S, M, V = n_stages, n_microbatches, n_chunks
    if schedule not in SCHEDULES:
        raise ValueError("unknown pipeline schedule %r — valid: %s"
                         % (schedule, list(SCHEDULES)))
    if schedule in ("gpipe", "1f1b"):
        if V != 1:
            raise ValueError(
                "schedule %r is stage-granular — n_chunks must be 1 "
                "(got %d); virtual chunks belong to 'interleaved'"
                % (schedule, V))
        steps = []
        for t in range(M + S - 1):
            row = []
            for s in range(S):
                m = t - s
                row.append(None if not 0 <= m < M else dict(
                    chunk=0, mb=m, fresh=(s == 0), final=(s == S - 1)))
            steps.append(row)
        return steps
    g = min(S, M)
    if M % g:
        raise ValueError(
            "interleaved schedule needs n_microbatches (%d) divisible by "
            "the group size min(stages, microbatches) = %d — pad the "
            "microbatch count or use gpipe/1f1b" % (M, g))
    n_steps = (M // g - 1) * V * S + (g - 1) + (V * S - 1) + 1
    steps = [[None] * S for _ in range(n_steps)]
    for k in range(M // g):
        for m in range(g):
            for j in range(V * S):
                t = k * V * S + m + j
                d = j % S
                if steps[t][d] is not None:  # pragma: no cover
                    raise AssertionError(
                        "interleaved schedule conflict at step %d device "
                        "%d" % (t, d))
                steps[t][d] = dict(chunk=j // S, mb=k * g + m,
                                   fresh=(j == 0),
                                   final=(j == V * S - 1))
    return steps


def bubble_fraction(schedule, n_stages, n_microbatches, n_chunks=1):
    """Idle device-steps over all device-steps of the table."""
    table = schedule_steps(schedule, n_stages, n_microbatches, n_chunks)
    total = len(table) * n_stages
    active = sum(1 for row in table for e in row if e is not None)
    return (total - active) / float(total)


def _table_arrays(table, n_stages):
    """The table as (T, S) numpy arrays: chunk index, fresh flag, feed
    microbatch, final flag, output slot."""
    T = len(table)
    chunk = numpy.zeros((T, n_stages), numpy.int32)
    fresh = numpy.zeros((T, n_stages), numpy.float32)
    feed = numpy.zeros((T, n_stages), numpy.int32)
    final = numpy.zeros((T, n_stages), numpy.float32)
    slot = numpy.zeros((T, n_stages), numpy.int32)
    for t, row in enumerate(table):
        for d, e in enumerate(row):
            if e is None:
                continue
            chunk[t, d] = e["chunk"]
            if e["fresh"]:
                fresh[t, d] = 1.0
                feed[t, d] = e["mb"]
            if e["final"]:
                final[t, d] = 1.0
                slot[t, d] = e["mb"]
    return chunk, fresh, feed, final, slot


# -- the scheduled loop ------------------------------------------------------

class _Schedule(torch.autograd.Function):
    """The table-driven loop of one rank as one differentiable
    operation: x_mb (M, mb, ...) and the rank's chunk-major parameters
    (V, Lc, ...) in, the finished microbatches out (zeros where another
    stage finishes them)."""

    @staticmethod
    def forward(ctx, run, x_mb, *params):
        ctx.run = run
        ctx.names = run.names
        outs, saved = run.forward(x_mb, params)
        ctx.save_for_backward(x_mb, *params)
        ctx.saved_inputs = saved
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        x_mb, *params = ctx.saved_tensors
        gx, gparams = ctx.run.backward(x_mb, params, ctx.saved_inputs,
                                       g_outs)
        return (None, gx) + tuple(gparams)


class _Runner(object):
    def __init__(self, fn, names, table, group, n_chunks):
        from ..parallel import collectives as C
        self.C = C
        self.fn = fn
        self.names = names
        self.table = table
        self.group = group
        self.V = n_chunks
        self.stage = C.group_rank(group)

    def _chunk(self, params, c):
        return {n: p[c] for n, p in zip(self.names, params)}

    def forward(self, x_mb, params):
        M = x_mb.shape[0]
        mb_shape = tuple(x_mb.shape[1:])
        zeros = x_mb.new_zeros(mb_shape, dtype=torch.float32)
        outs = x_mb.new_zeros((M,) + mb_shape, dtype=torch.float32)
        recv, saved = zeros, {}
        T = len(self.table)
        with torch.no_grad():
            for t, row in enumerate(self.table):
                e = row[self.stage]
                out = zeros
                if e is not None:
                    inp = x_mb[e["mb"]].float() if e["fresh"] else recv
                    if not e["fresh"]:
                        saved[t] = inp
                    out = sequential_stack(
                        self.fn, self._chunk(params, e["chunk"]), inp)
                    if e["final"]:
                        outs[e["mb"]] = out
                if t != T - 1:
                    recv = self.C._shift(out, 1, self.group)
        return outs, saved

    def backward(self, x_mb, params, saved, g_outs):
        mb_shape = tuple(x_mb.shape[1:])
        zeros = x_mb.new_zeros(mb_shape, dtype=torch.float32)
        gx = torch.zeros_like(x_mb, dtype=torch.float32)
        gparams = [torch.zeros_like(p) for p in params]
        g_next = zeros
        for t in reversed(range(len(self.table))):
            e = self.table[t][self.stage]
            g_send = zeros
            if e is not None:
                g_out = g_next
                if e["final"]:
                    g_out = g_out + g_outs[e["mb"]]
                inp = (x_mb[e["mb"]].float() if e["fresh"]
                       else saved[t]).detach().requires_grad_(True)
                chunk = [p[e["chunk"]].detach().requires_grad_(True)
                         for p in params]
                with torch.enable_grad():
                    out = sequential_stack(
                        self.fn, dict(zip(self.names, chunk)), inp)
                    grads = torch.autograd.grad(out, [inp] + chunk, g_out,
                                                allow_unused=True)
                for gp, g in zip(gparams, grads[1:]):
                    if g is not None:
                        gp[e["chunk"]] += g
                if e["fresh"]:
                    gx[e["mb"]] += grads[0]
                else:
                    g_send = grads[0]
            if t:
                g_next = self.C._shift(g_send, -1, self.group)
        return gx.to(x_mb.dtype), gparams


def _interleave_order(n_layers, n_stages, V):
    """Layer order that puts global chunk j on rank j mod S, chunk-major
    per rank (rank d holds chunks d, d+S, …)."""
    lc = n_layers // (n_stages * V)
    order = []
    for d in range(n_stages):
        for a in range(V):
            j = a * n_stages + d
            order.extend(range(j * lc, (j + 1) * lc))
    return order


def pipeline(fn, stacked_params, x, mesh, stage_axis, n_microbatches,
             schedule="gpipe", n_chunks=None):
    """``sequential_stack(fn, all layers, x)`` pipelined over the mesh's
    ``stage_axis``: ``stacked_params`` is this rank's stage slice (a
    dict of tensors with a leading local-layer dim), x (B, ...) the
    rank's float input (the same on every stage).  ``schedule`` is one
    of :data:`SCHEDULES`; ``n_chunks`` (interleaved only) the virtual
    chunks per stage, default one per local layer.  Returns y (B, ...)
    float32 on every stage."""
    from ..parallel import collectives as C
    if schedule not in SCHEDULES:
        raise ValueError("unknown pipeline schedule %r — valid: %s"
                         % (schedule, list(SCHEDULES)))
    if schedule in ("gpipe", "1f1b") and n_chunks not in (None, 1):
        raise ValueError(
            "schedule %r is stage-granular — n_chunks must be 1 (got "
            "%r); virtual chunks belong to 'interleaved'"
            % (schedule, n_chunks))
    n_stages = mesh.shape[stage_axis]
    local_layers = next(iter(stacked_params.values())).shape[0]
    n_layers = local_layers * n_stages
    _validate(x, n_microbatches, n_layers, n_stages)
    if schedule == "interleaved":
        V = local_layers if n_chunks is None else n_chunks
        if V < 1 or local_layers % V:
            raise ValueError(
                "interleaved schedule: %d layers per stage do not divide "
                "into %r chunks" % (local_layers, V))
    else:
        V = 1
    table = schedule_steps(schedule, n_stages, n_microbatches,
                           n_chunks=V)
    group = mesh.group(stage_axis)
    params = dict(stacked_params)
    if V > 1:
        # Interleaved placement: the whole stack, reordered chunk-major
        # per rank, then this rank's slice (the gather's backward
        # reduce-scatters the gradients back to the stage slices).
        order = torch.as_tensor(_interleave_order(n_layers, n_stages, V))
        stage = C.group_rank(group)
        mine = order[stage * local_layers:(stage + 1) * local_layers]
        params = {k: C.all_gather(v, 0, group).index_select(
            0, mine.to(v.device)) for k, v in params.items()}
    names = sorted(params)
    chunked = [params[n].reshape((V, local_layers // V) +
                                 tuple(params[n].shape[1:]))
               for n in names]
    B = x.shape[0]
    x_mb = x.reshape((n_microbatches, B // n_microbatches) +
                     tuple(x.shape[1:]))
    run = _Runner(fn, names, table, group, V)
    outs = _Schedule.apply(run, x_mb, *chunked)
    # Only the stage that finishes a microbatch holds it; the sum over
    # the stage axis hands every stage the outputs.
    outs = C.all_reduce(outs, group)
    return outs.reshape((B,) + tuple(outs.shape[2:]))


def gpipe(fn, stacked_params, x, mesh, stage_axis, n_microbatches):
    """:func:`pipeline` with the GPipe schedule."""
    return pipeline(fn, stacked_params, x, mesh, stage_axis,
                    n_microbatches, schedule="gpipe")
