"""Mixture-of-Experts dispatch (the JAX package's ``ops.moe``):
GShard/Switch top-k routing with capacity, and the expert-parallel
dispatch over ``torch.distributed``.

* :func:`top1_routing` — the GShard top-1 path;
* :func:`topk_routing` — k ≥ 2 choices per token with rank-major
  capacity priority (every token's first choice queues before any
  second choice), renormalized gates, the Switch load-balance auxiliary
  (eq. 4) over the rank-0 choices and the ST-MoE router z-loss;
* :func:`moe_capacity` — ``capacity_factor · k · T / E``, at least 1;
* :func:`moe_ffn_topk` / :func:`moe_ffn` — the dispatch, the experts'
  FFNs as one batched product, the gate-weighted combine: the function
  of the JAX package's one-hot einsums, with each kept token moved to
  its slots (and back) by index instead of a (T, E, C) product;
* :func:`moe_ffn_parallel` — the same function when a mesh splits the
  tokens over a data axis and the experts over an expert axis: the
  router logits are all-gathered over the data axis so the routing (and
  its capacity queue) is the whole minibatch's, each rank dispatches
  its tokens' slots to the experts' ranks by ``all_to_all``, runs its
  own experts, and the outputs come back by ``all_to_all``.
"""

import torch
import torch.nn.functional as F


def init_parser(parser):
    """The MoE routing flags of the command line (handed to
    ``root.common.engine`` by ``__main__``)."""
    parser.add_argument(
        "--moe-topk", type=int, default=None, metavar="K",
        help="Mixture-of-Experts router: experts per token (default "
             "1 = the Switch/GShard top-1 path; k>=2 dispatches each "
             "token to its k best experts with rank-major capacity "
             "priority and renormalized gates)")
    parser.add_argument(
        "--moe-router-z", type=float, default=None, metavar="W",
        help="router z-loss weight (ST-MoE): penalizes "
             "mean(logsumexp(router logits)^2); 0 (default) disables "
             "the term")


def _one_hot(index, n):
    """float32 one-hot rows, all zero for an index outside [0, n) (as
    ``jax.nn.one_hot`` gives them: a queue position past the capacity)."""
    inside = (index >= 0) & (index < n)
    return F.one_hot(index.clamp(0, n - 1), n).float() * \
        inside[..., None].float()


def moe_capacity(capacity_factor, n_tokens, n_experts, top_k=1):
    """Slots per expert: ``capacity_factor · k · T / E``, at least 1."""
    return max(1, int(capacity_factor * top_k * n_tokens / n_experts))


def _route_slots(logits, capacity, top_k):
    """The routing policy, as slot indices: each token's k experts
    (T, k), its queue slot in each (T, k) — the rank-major queue, every
    token's first choice before any second —, whether the slot is within
    capacity (T, k), its gates (T, k) — renormalized over the k choices
    for k > 1 —, the aux over the rank-0 choices, the z-loss and the
    load (E,) over all k ranks.  The dispatch then moves each kept token
    once — the one-hot einsums' exact terms without their T·E·C
    products; :func:`top1_routing`/:func:`topk_routing` give the same
    routing as the JAX package's (T, E, C) tensors."""
    T, E = logits.shape
    if not 1 <= top_k <= E:
        raise ValueError("top_k=%d must satisfy 1 <= k <= %d experts"
                         % (top_k, E))
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    if top_k == 1:
        gate, expert = probs.max(dim=-1, keepdim=True)
    else:
        gate, expert = torch.topk(probs, top_k, dim=-1)
        gate = gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True),
                                      1e-9)
    onehot = F.one_hot(expert, E).float()                  # (T, k, E)
    flat = onehot.transpose(0, 1).reshape(top_k * T, E)
    position = (torch.cumsum(flat, dim=0) - 1.0) * flat
    slot = position.sum(dim=-1).long().reshape(top_k, T).t()
    keep = slot < capacity
    f = onehot[:, 0, :].mean(dim=0)
    p = probs.mean(dim=0)
    aux = (f * p).sum() * E
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return expert, slot, keep, gate, aux, z, onehot.sum(dim=(0, 1))


def _dense(expert, slot, keep, gate, n_experts, capacity):
    """Dispatch and combine (T, E, C) of a :func:`_route_slots` routing:
    one_hot(expert) · keep · one_hot(slot), summed over the k choices,
    and the same weighted by each choice's gate."""
    disp = (F.one_hot(expert, n_experts).float()[..., None] *
            keep[..., None, None].float() *
            _one_hot(slot, capacity)[:, :, None, :])       # (T, k, E, C)
    return disp.sum(dim=1), (disp * gate[..., None, None]).sum(dim=1)


def top1_routing(logits, capacity):
    """Top-1 router: logits (T, E), ``capacity`` slots per expert
    (overflow tokens are dropped).  Returns dispatch (T, E, C) 0/1,
    combine (T, E, C) = dispatch · gate, the load-balance aux
    (Σ_e f_e · p_e · E) and the per-expert load (E,) before capacity."""
    expert, slot, keep, gate, aux, _, load = _route_slots(logits,
                                                          capacity, 1)
    return _dense(expert, slot, keep, gate, logits.shape[1],
                  capacity) + (aux, load)


def topk_routing(logits, k, capacity):
    """Top-k router: logits (T, E), k choices per token, ``capacity``
    slots per expert over the rank-major queue.  Returns dispatch and
    combine (T, E, C) — the gates renormalized over the k choices for
    k > 1 —, the aux over the rank-0 choices, the z-loss
    mean(logsumexp(logits)²) and the load (E,) over all k ranks."""
    expert, slot, keep, gate, aux, z, load = _route_slots(logits,
                                                          capacity, k)
    return _dense(expert, slot, keep, gate, logits.shape[1],
                  capacity) + (aux, z, load)


def _dispatch(x, expert, slot, keep, n_experts, capacity):
    """(E, C, D): each kept token of x (T, D) in its experts' slots."""
    T, k = expert.shape
    tok = torch.arange(T, device=x.device)[:, None].expand(T, k)[keep]
    idx = (expert * capacity + slot)[keep]
    return x.new_zeros((n_experts * capacity, x.shape[1])).index_add(
        0, idx, x[tok]).reshape(n_experts, capacity, x.shape[1])


def _combine(expert_out, expert, slot, keep, gate, first=0):
    """(T, D): each token's gate-weighted outputs of its kept slots
    among ``expert_out`` (E', C, D), experts ``first`` .. first+E'-1."""
    T, k = expert.shape
    n, capacity, D = expert_out.shape
    mine = keep & (expert >= first) & (expert < first + n)
    tok = torch.arange(T, device=expert.device)[:, None].expand(T, k)[mine]
    idx = ((expert - first) * capacity + slot)[mine]
    rows = expert_out.reshape(n * capacity, D)[idx] * gate[mine][:, None]
    return expert_out.new_zeros((T, D)).index_add(0, tok, rows)


def _experts(expert_in, w1, b1, w2, b2, reduce=None):
    """The experts' FFNs over their slots: (E, C, D) → (E, C, D).  The
    hidden dim may be a model-axis shard; ``reduce`` then sums the
    row-parallel product before b2."""
    h = torch.relu(torch.einsum("ecd,edh->ech", expert_in, w1.float()) +
                   b1.float()[:, None, :])
    out = torch.einsum("ech,ehd->ecd", h, w2.float())
    if reduce is not None:
        out = reduce(out)
    return out + b2.float()[:, None, :]


def moe_ffn_topk(x, router_w, w1, b1, w2, b2, capacity_factor=1.25,
                 top_k=1):
    """Top-k MoE feed-forward over tokens x (T, D): router_w (D, E),
    w1 (E, D, H), b1 (E, H), w2 (E, H, D), b2 (E, D).  Returns
    (y (T, D) float32, aux_loss, z_loss, expert_load (E,)) — the JAX
    package's dispatch/combine einsums, computed by moving each kept
    token to its slots and back."""
    T, D = x.shape
    E = router_w.shape[1]
    capacity = moe_capacity(capacity_factor, T, E, top_k)
    xf = x.float()
    expert, slot, keep, gate, aux, z, load = _route_slots(
        xf @ router_w.float(), capacity, top_k)
    expert_out = _experts(_dispatch(xf, expert, slot, keep, E, capacity),
                          w1, b1, w2, b2)
    return _combine(expert_out, expert, slot, keep, gate), aux, z, load


def moe_ffn(x, router_w, w1, b1, w2, b2, capacity_factor=1.25, top_k=1,
            router_z_weight=0.0):
    """:func:`moe_ffn_topk` returning (y, aux, load), with
    ``router_z_weight · z_loss`` folded into the aux."""
    y, aux, z, load = moe_ffn_topk(x, router_w, w1, b1, w2, b2,
                                   capacity_factor=capacity_factor,
                                   top_k=top_k)
    if router_z_weight:
        aux = aux + router_z_weight * z
    return y, aux, load


def moe_ffn_parallel(x, router_w, w1, b1, w2, b2, capacity_factor=1.25,
                     top_k=1, data_group=None, expert_group=None,
                     reduce=None):
    """:func:`moe_ffn_topk` over a mesh: x (T_l, D) are this rank's
    tokens — its slice of the data axis, the same on every rank of the
    expert axis — and w1/b1/w2/b2 its experts' slice (E_l = E / n_ep
    experts, in expert-axis order).  The routing runs on the logits of
    the whole minibatch (all-gathered over ``data_group``), so the
    capacity queue, the aux and the z-loss are those of
    :func:`moe_ffn_topk` on all tokens.  Within the expert group each
    rank takes 1/n_ep of its tokens: their slot contributions go to the
    experts' ranks by ``all_to_all``, summed over the data axis; each
    rank runs its experts; the gate-weighted outputs come back by
    ``all_to_all`` and are all-gathered over the expert group.  The
    experts' hidden dim may be a model-axis shard (``reduce`` sums the
    row-parallel product, as in :func:`_experts`).  Returns what
    :func:`moe_ffn_topk` returns, y for this rank's tokens."""
    from ..parallel import collectives as C
    T_l, D = x.shape
    n_data, n_ep = C.group_size(data_group), C.group_size(expert_group)
    E = router_w.shape[1]
    E_l = w1.shape[0]
    if E_l * n_ep != E:
        raise ValueError("%d local experts × %d expert ranks != %d "
                         "router experts" % (E_l, n_ep, E))
    if T_l % n_ep:
        raise ValueError("%d tokens do not split over %d expert ranks"
                         % (T_l, n_ep))
    capacity = moe_capacity(capacity_factor, T_l * n_data, E, top_k)
    xf = x.float()
    logits = C.all_gather(xf @ router_w.float(), 0, data_group)
    expert, slot, keep, gate, aux, z, load = _route_slots(
        logits, capacity, top_k)
    d = C.group_rank(data_group)
    local = slice(d * T_l, (d + 1) * T_l)
    expert, slot, keep, gate = (t[local] for t in (expert, slot, keep,
                                                   gate))
    ts = T_l // n_ep
    e = C.group_rank(expert_group)
    mine = slice(e * ts, (e + 1) * ts)
    # My tokens' slot contributions to every expert, sent to the ranks
    # of those experts; each rank sums what its peers sent, then over
    # the data axis.
    partial = _dispatch(xf[mine], expert[mine], slot[mine], keep[mine],
                        E, capacity)
    expert_in = C.all_to_all(partial, 0, 0, expert_group)
    expert_in = expert_in.reshape(n_ep, E_l, capacity, D).sum(dim=0)
    expert_in = C.all_reduce(expert_in, data_group)
    expert_out = _experts(expert_in, w1, b1, w2, b2, reduce)
    # Every peer's tokens' share of my experts' outputs, sent back.
    back = torch.stack([
        _combine(expert_out, *(t[j * ts:(j + 1) * ts]
                               for t in (expert, slot, keep, gate)),
                 first=e * E_l) for j in range(n_ep)])
    y = C.all_to_all(back, 0, 0, expert_group)
    y = y.reshape(n_ep, ts, D).sum(dim=0)
    return C.all_gather(y, 0, expert_group), aux, z, load
