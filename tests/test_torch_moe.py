"""The port's Mixture-of-Experts (``veles_tpu_torch.ops.moe`` and the
MoE TinyLM) against the JAX package's ``veles_tpu/ops/moe.py`` and the
numpy oracle of ``tests/test_moe_topk.py``, in this process: the same
logits and weights, made with numpy from a seed, through both.

Tolerances: routing tensors exactly (0/1 dispatch, gates to 1e-6); the
FFN output, aux, z-loss and the gradients within rtol 1e-5, atol 1e-6;
the MoE TinyLM's ticks at float32 within rtol 1e-4, atol 2e-5 (as the
dense TinyLM's cases of ``test_torch_training``).  The top-1 path is
held to ``top1_routing``'s semantics, not to the JAX package's
``test_top1_path_is_bit_compatible`` (which fails on the JAX package
itself).  The expert-parallel dispatch over ranks is in
``test_torch_distributed``; here ``moe_ffn_parallel`` without groups
must equal ``moe_ffn_topk``."""

import numpy
import pytest
import torch

from veles_tpu.ops import moe as JM
from veles_tpu_torch.ops import moe as TM
from test_moe_topk import _geometry, _route_oracle
from test_torch_mesh import clean_roots  # noqa: F401 (a fixture)


def _j(*arrays):
    import jax.numpy as jnp
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(numpy.array(a)) for a in arrays]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_routing_matches_jax_and_oracle(k):
    """top-k routing (and top-1 for k = 1): dispatch, combine, aux,
    z-loss and load equal the JAX package's; dispatch and combine equal
    the numpy oracle's rank-major capacity fill."""
    x, router, *_ = _geometry(seed=3, T=24)
    logits = x @ router
    cap = TM.moe_capacity(1.0, 24, 4, k)
    assert cap == JM.moe_capacity(1.0, 24, 4, k)
    got = TM.topk_routing(torch.from_numpy(logits), k, cap)
    want = JM.topk_routing(*_j(logits), k, cap)
    for g, w in zip(got, want):
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(w),
                                      rtol=1e-6, atol=1e-6)
    _, _, disp, comb = _route_oracle(logits, k, cap)
    numpy.testing.assert_array_equal(got[0].numpy(), disp)
    numpy.testing.assert_allclose(got[1].numpy(), comb, atol=1e-6)
    if k == 1:
        got1 = TM.top1_routing(torch.from_numpy(logits), cap)
        want1 = JM.top1_routing(*_j(logits), cap)
        for g, w in zip(got1, want1):
            numpy.testing.assert_allclose(g.numpy(), numpy.asarray(w),
                                          rtol=1e-6, atol=1e-6)


def test_rank0_choices_win_capacity():
    """Every token's first choice queues before any second choice: with
    capacity for half the tokens, no second choice lands while a first
    choice of the same expert was dropped."""
    x, router, *_ = _geometry(seed=5, T=16)
    logits = torch.from_numpy(x @ router)
    disp, _, _, _, _ = TM.topk_routing(logits, 2, 4)
    _, order, _, _ = _route_oracle(logits.numpy(), 2, 4)
    for e in range(4):
        first = [t for t in range(16) if order[t, 0] == e]
        kept_first = sum(int(disp[t, e].sum()) for t in first)
        second = [t for t in range(16) if order[t, 1] == e]
        kept_second = sum(int(disp[t, e].sum()) for t in second)
        if kept_second:
            assert kept_first == len(first)
        assert kept_first + kept_second <= 4


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_and_gradients_match_jax(k):
    """y, aux, z and load of ``moe_ffn_topk``, and the gradients of
    Σy + aux + 0.01·z with respect to every input, equal the JAX
    package's."""
    import jax
    arrays = _geometry(seed=11, T=20)
    jy, jaux, jz, jload = JM.moe_ffn_topk(*_j(*arrays), top_k=k)
    ty, taux, tz, tload = TM.moe_ffn_topk(*_t(*arrays), top_k=k)
    for g, w in ((ty, jy), (taux, jaux), (tz, jz), (tload, jload)):
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(w),
                                      rtol=1e-5, atol=1e-6)

    def jloss(*a):
        y, aux, z, _ = JM.moe_ffn_topk(*a, top_k=k)
        return y.sum() + aux + 0.01 * z
    want = jax.grad(jloss, argnums=tuple(range(6)))(*_j(*arrays))
    leaves = [t.requires_grad_(True) for t in _t(*arrays)]
    y, aux, z, _ = TM.moe_ffn_topk(*leaves, top_k=k)
    (y.sum() + aux + 0.01 * z).backward()
    for leaf, w in zip(leaves, want):
        numpy.testing.assert_allclose(leaf.grad.numpy(), numpy.asarray(w),
                                      rtol=1e-5, atol=1e-6)


def test_moe_ffn_folds_the_z_loss():
    arrays = _geometry(seed=2)
    jy, jaux, _ = JM.moe_ffn(*_j(*arrays), top_k=2, router_z_weight=0.1)
    ty, taux, _ = TM.moe_ffn(*_t(*arrays), top_k=2, router_z_weight=0.1)
    numpy.testing.assert_allclose(taux.numpy(), numpy.asarray(jaux),
                                  rtol=1e-5)
    numpy.testing.assert_allclose(ty.numpy(), numpy.asarray(jy),
                                  rtol=1e-5, atol=1e-6)


def test_parallel_dispatch_without_groups_is_the_plain_ffn():
    arrays = _t(*_geometry(seed=4, T=16))
    for k in (1, 2):
        want = TM.moe_ffn_topk(*arrays, top_k=k)
        got = TM.moe_ffn_parallel(*arrays, top_k=k)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_bad_k_is_refused():
    logits = torch.zeros(4, 3)
    for k in (0, 4):
        with pytest.raises(ValueError, match="top_k=%d must satisfy" % k):
            TM.topk_routing(logits, k, 2)


@pytest.fixture
def f32_roots(clean_roots):
    """Both packages' config trees from a clean slate at
    precision_level 1, put back whole afterwards."""
    for r in clean_roots:
        r.common.engine.precision_level = 1
    yield clean_roots


MOE_LM = {"top1": dict(n_experts=4),
          "top2": dict(n_experts=4, top_k=2),
          "top2-z": dict(n_experts=4, top_k=2, router_z_weight=0.01),
          "knob-top2": dict(n_experts=4)}


@pytest.mark.parametrize("case", sorted(MOE_LM))
def test_moe_tinylm_ticks_match_jax(case, f32_roots):
    """The MoE TinyLM trains the same ticks as the JAX package's (a
    validation tick, then train ticks): losses, every parameter and the
    router-health rows (``moe_acc``) per class; "knob-top2" takes k
    from ``root.common.engine.moe_top_k`` in both trees."""
    import jax
    from test_torch_training import _build, _arrays
    if case == "knob-top2":
        for r in f32_roots:
            r.common.engine.moe_top_k = 2
    jwf, twf = _build(seed=31, **MOE_LM[case])
    assert twf.forwards[1].top_k == jwf.forwards[1].top_k
    for step in range(4):
        jwf.loader.run()
        twf.loader.run()
        want = float(jax.device_get(jwf.step_metrics["loss"]))
        assert float(twf.step_metrics["loss"]) == pytest.approx(
            want, rel=1e-5), step
        w, g = _arrays(jwf), _arrays(twf)
        for unit, attrs in w.items():
            for attr, arr in attrs.items():
                numpy.testing.assert_allclose(
                    g[unit][attr], arr, rtol=1e-4, atol=2e-5,
                    err_msg="%s step %d %s/%s" % (case, step, unit, attr))
    for cls in (1, 2):
        numpy.testing.assert_allclose(
            twf.forwards[1].read_moe_acc(cls),
            jwf.forwards[1].read_moe_acc(cls), rtol=1e-4, atol=1e-5)
