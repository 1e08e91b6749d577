"""The port's ring step (``ops.attention.ring_step``, on the flash chunk
contract of ``ops.flash_attention``) against the JAX package's
``flash_chunk`` / ``flash_resume`` / ``merge_partials`` in interpret
mode, in this process, on the chunk's plain version (CPU tensors).

* one step and two-step carries at global offsets: ``(out, lse)`` and
  the gradients of q, k, v (through the lse of the merge) within rtol
  2e-5, atol 2e-5 (gradients rtol 2e-4) at float32 operands;
* the ring's chunk loop at N = 2 and N = 4 virtual ranks — each rank's
  queries folding the k/v shard of rank ``rank − step`` at offsets
  ``rank·S/N`` and ``src·S/N`` — merged equals the whole-sequence
  attention of both packages, forward and backward;
* the streaming (``sp_ring_kernel`` "xla") and Ulysses paths without a
  group equal the plain attention; the gathered attention's padded
  blockwise path equals the JAX package's.

The multi-rank ring and Ulysses are in ``test_torch_distributed``."""

import numpy
import pytest
import torch

from veles_tpu_torch.ops import attention as TA
from veles_tpu_torch.ops import flash_attention as TF


def _qkv(B=2, S=24, H=3, D=5, seed=0):
    rng = numpy.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype("f") for _ in range(3)]


def _jax_chunks(q, k, v, causal, chunks, q_offset=0):
    """JAX's flash_resume over ``chunks`` [(offset, length)]."""
    import jax.numpy as jnp
    from veles_tpu.ops import pallas_attention as PA
    carry = None
    for off, n in chunks:
        carry = PA.flash_resume(
            carry, q, k[:, off:off + n], v[:, off:off + n], causal=causal,
            q_offset=q_offset, k_offset=off, operand_dtype=jnp.float32,
            interpret=True)
    return carry


def _port_chunks(q, k, v, causal, chunks, q_offset=0):
    carry = None
    for off, n in chunks:
        carry = TA.ring_step(carry, q, k[:, off:off + n],
                             v[:, off:off + n], causal, q_offset, off,
                             torch.float32)
    return carry


CHUNKS = {"one": [(0, 24)], "two": [(0, 12), (12, 12)],
          "three-reversed": [(16, 8), (8, 8), (0, 8)]}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("chunks", sorted(CHUNKS))
def test_ring_step_matches_jax_flash_resume(chunks, causal):
    """(out, lse) of the carried steps, and the gradients of
    Σout² + Σlse, equal the JAX package's interpret-mode kernels."""
    import jax
    import jax.numpy as jnp
    q, k, v = _qkv(seed=7)
    plan = CHUNKS[chunks]
    # Queries at a global offset past the keys' start: the causal mask
    # takes q_offset into account.
    q_off = 8 if causal else 0
    qs = q[:, :16]
    jout, jlse = _jax_chunks(*map(jnp.asarray, (qs, k, v)), causal, plan,
                             q_off)
    tq, tk, tv = [torch.from_numpy(a).requires_grad_(True)
                  for a in (qs, k, v)]
    tout, tlse = _port_chunks(tq, tk, tv, causal, plan, q_off)
    numpy.testing.assert_allclose(tout.detach().numpy(),
                                  numpy.asarray(jout), rtol=2e-5,
                                  atol=2e-5)
    numpy.testing.assert_allclose(tlse.detach().numpy(),
                                  numpy.asarray(jlse), rtol=2e-5,
                                  atol=2e-5)

    def jloss(*a):
        o, lse = _jax_chunks(*a, causal, plan, q_off)
        return (o ** 2).sum() + lse.sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (qs, k, v)))
    ((tout ** 2).sum() + tlse.sum()).backward()
    for leaf, w, name in zip((tq, tk, tv), want, "qkv"):
        numpy.testing.assert_allclose(leaf.grad.numpy(), numpy.asarray(w),
                                      rtol=2e-4, atol=2e-5,
                                      err_msg="d" + name)


def test_merge_partials_matches_jax_with_a_void_chunk():
    """A fully masked chunk (lse ≈ −1e30) weighs 0 in both packages."""
    import jax.numpy as jnp
    from veles_tpu.ops import pallas_attention as PA
    rng = numpy.random.RandomState(2)
    o1, o2 = rng.randn(2, 2, 4, 3, 5).astype("f")
    l1 = rng.randn(2, 4, 3).astype("f")
    l2 = numpy.full((2, 4, 3), -1e30, "f")
    want = PA.merge_partials(*map(jnp.asarray, (o1, l1, o2, l2)))
    got = TF.merge_partials(*map(torch.from_numpy, (o1, l1, o2, l2)))
    for g, w in zip(got, want):
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(w),
                                      rtol=1e-6, atol=1e-6)
    numpy.testing.assert_allclose(got[0].numpy(), o1, rtol=1e-6)


def virtual_ring(q, k, v, n, causal):
    """The ring's chunk loop of ``n`` ranks in one process: rank r holds
    the r-th sequence shard of q, k, v; at step s it folds the k/v
    shard of rank (r − s) mod n at offsets r·S/n and src·S/n.  Returns
    the ranks' outputs concatenated along the sequence."""
    S = q.shape[1] // n
    outs = []
    for r in range(n):
        carry = None
        for step in range(n):
            src = (r - step) % n
            carry = TA.ring_step(carry, q[:, r * S:(r + 1) * S],
                                 k[:, src * S:(src + 1) * S],
                                 v[:, src * S:(src + 1) * S], causal,
                                 r * S, src * S, torch.float32)
        outs.append(carry[0])
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_virtual_ring_equals_whole_sequence_attention(n, causal):
    """The ring loop at N virtual ranks == the whole-sequence attention
    of the port (plain) and of the JAX package, forward; its gradients
    == the port's whole-sequence gradients."""
    import jax.numpy as jnp
    from veles_tpu.ops import attention as JA
    q, k, v = _qkv(S=32, seed=n)
    tq, tk, tv = [torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v)]
    ring = virtual_ring(tq, tk, tv, n, causal)
    full = TA.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal, precision="f32", kernel="xla")
    jfull = JA.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                         precision="f32", kernel="xla")
    numpy.testing.assert_allclose(ring.detach().numpy(), full.numpy(),
                                  rtol=2e-5, atol=2e-5)
    numpy.testing.assert_allclose(ring.detach().numpy(),
                                  numpy.asarray(jfull), rtol=2e-5,
                                  atol=2e-5)
    (ring ** 2).sum().backward()
    rq, rk, rv = [torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v)]
    (TA.attention(rq, rk, rv, causal=causal, precision="f32",
                  kernel="xla") ** 2).sum().backward()
    for a, b, name in ((tq, rq, "dq"), (tk, rk, "dk"), (tv, rv, "dv")):
        numpy.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                      rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("kernel", ["xla", "auto"])
def test_single_rank_ring_and_ulysses_are_plain_attention(kernel):
    q, k, v = (torch.from_numpy(a) for a in _qkv(S=16, H=4))
    want = TA.attention(q, k, v, causal=True, precision="f32",
                        kernel="xla")
    got = TA.ring_attention(q, k, v, None, causal=True, kernel=kernel,
                            precision="f32")
    numpy.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                                  atol=2e-5)
    uly = TA.ulysses_attention(q, k, v, None, causal=True)
    numpy.testing.assert_allclose(uly.numpy(), want.numpy(), rtol=2e-5,
                                  atol=2e-5)


def test_gathered_attention_pads_like_jax():
    """Past ULYSSES_DENSE_MAX with no dividing block, both packages pad
    to a 512 multiple and mask the padded keys."""
    import jax.numpy as jnp
    from veles_tpu.ops import attention as JA
    q, k, v = _qkv(B=1, S=1100, H=1, D=4, seed=9)
    want = JA._gathered_attention(*map(jnp.asarray, (q, k, v)), True)
    got = TA._gathered_attention(*map(torch.from_numpy, (q, k, v)), True)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  rtol=1e-4, atol=1e-5)


def test_ring_knob_and_modes_are_checked():
    from veles_tpu_torch.config import root
    from veles_tpu_torch.parallel import make_mesh
    q = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError, match="unknown ring kernel mode"):
        TA.ring_attention(q, q, q, None, kernel="cuda")
    saved = dict(root.common.engine.__dict__)
    try:
        root.common.engine.sp_ring_kernel = "nope"
        with pytest.raises(ValueError, match="unknown ring kernel mode"):
            TA.ring_attention(q, q, q, None)
    finally:
        root.common.engine.__dict__.clear()
        root.common.engine.__dict__.update(saved)
    mesh = make_mesh(range(2), {"seq": 2})
    with pytest.raises(ValueError, match="sequence-parallel mode"):
        TA.sequence_parallel_attention(q, q, q, mesh, "seq",
                                       mode="zigzag")
    assert TA.SP_MODES == ("ring", "ulysses")
    with pytest.raises(ValueError, match="ulysses needs heads"):
        from unittest import mock
        with mock.patch("veles_tpu_torch.parallel.collectives.group_size",
                        return_value=3):
            TA.ulysses_attention(q, q, q, object())
