"""The port's pipeline schedules (``veles_tpu_torch.ops.pipeline``)
against the JAX package's, in this process (no process group): the
schedule tables, bubble fractions and packed arrays equal the JAX
package's exactly; the validation errors carry its messages; the
sequential stack and the pipelined TinyLM's ticks (no mesh: the stack
runs sequentially) agree with it at float32 within rtol 1e-4, atol
2e-5.  The stage-parallel runs are in ``test_torch_distributed``."""

import numpy
import pytest
import torch

from veles_tpu.ops import pipeline as JPL
from veles_tpu_torch.ops import pipeline as TPL
from veles_tpu_torch.parallel import make_mesh
from test_torch_mesh import clean_roots  # noqa: F401 (a fixture)

TABLES = [("gpipe", 4, 6, 1), ("1f1b", 4, 8, 1), ("1f1b", 2, 1, 1),
          ("interleaved", 4, 8, 2), ("interleaved", 2, 2, 3),
          ("interleaved", 4, 2, 2), ("gpipe", 1, 3, 1)]


@pytest.mark.parametrize("schedule,S,M,V", TABLES)
def test_schedule_tables_equal_jax(schedule, S, M, V):
    want = JPL.schedule_steps(schedule, S, M, n_chunks=V)
    assert TPL.schedule_steps(schedule, S, M, n_chunks=V) == want
    assert TPL.bubble_fraction(schedule, S, M, V) == \
        JPL.bubble_fraction(schedule, S, M, V)
    for a, b in zip(TPL._table_arrays(want, S),
                    JPL._table_arrays(want, S)):
        assert a.dtype == b.dtype and numpy.array_equal(a, b)


def test_bubble_fractions_match_formulas():
    """gpipe/1f1b (S−1)/(M+S−1); interleaved (S−1)/(M·V+S−1)."""
    for S, M in ((4, 8), (2, 6), (4, 4)):
        for sch in ("gpipe", "1f1b"):
            assert TPL.bubble_fraction(sch, S, M) == pytest.approx(
                (S - 1) / (M + S - 1))
    assert TPL.bubble_fraction("interleaved", 4, 8, 2) == \
        pytest.approx(3 / (8 * 2 + 3))


def _raises(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except (TypeError, ValueError) as e:
        return type(e), str(e)
    return None


def _mlp_stack(n_layers, width=16, seed=0):
    rng = numpy.random.RandomState(seed)
    return {"w": rng.normal(0, 0.3, (n_layers, width, width)).astype(
                numpy.float32),
            "b": rng.normal(0, 0.1, (n_layers, width)).astype(
                numpy.float32)}


def test_validation_errors_equal_jax():
    """Each bad argument raises the JAX package's error type and
    message: unknown schedule, chunks with a stage-granular schedule,
    chunks that do not divide, a microbatch count the group size does
    not divide, integer inputs, more microbatches than samples, an
    indivisible batch, layers that do not divide over the stages."""
    import jax.numpy as jnp
    from veles_tpu.parallel import make_mesh as jmesh
    jm, tm = jmesh(axes={"stage": 4}), make_mesh(range(4), {"stage": 4})
    full = _mlp_stack(4)
    local = {k: v[:1] for k, v in full.items()}

    def fn_j(p, h):
        return h

    def fn_t(p, h):
        return h
    cases = [
        (dict(schedule="zigzag"), (8, 4, 16), numpy.float32, 4),
        (dict(schedule="1f1b", n_chunks=2), (8, 4, 16), numpy.float32, 4),
        (dict(schedule="gpipe", n_chunks=2), (8, 4, 16), numpy.float32, 4),
        (dict(schedule="interleaved", n_chunks=3), (8, 4, 16),
         numpy.float32, 4),
        (dict(schedule="gpipe"), (8, 4, 16), numpy.int32, 4),
        (dict(schedule="gpipe"), (2, 4, 16), numpy.float32, 4),
        (dict(schedule="gpipe"), (6, 4, 16), numpy.float32, 4),
        (dict(schedule="1f1b"), (8, 4, 16), numpy.float32, 0),
    ]
    for kw, shape, dtype, mbs in cases:
        x = numpy.zeros(shape, dtype)
        want = _raises(JPL.pipeline, fn_j,
                       {k: jnp.asarray(v) for k, v in full.items()},
                       jnp.asarray(x), jm, "stage", mbs, **kw)
        got = _raises(TPL.pipeline, fn_t,
                      {k: torch.from_numpy(v) for k, v in local.items()},
                      torch.from_numpy(x), tm, "stage", mbs, **kw)
        assert want is not None and got == want, (kw, shape, dtype)
    got = _raises(TPL._validate, torch.zeros(8, 4), 4, 3, 2)
    want = _raises(JPL._validate, jnp.zeros((8, 4)), 4, 3, 2)
    assert got == want and "do not divide" in got[1]
    for args in (("interleaved", 4, 6, 2), ("1f1b", 4, 4, 2),
                 ("zigzag", 2, 2, 1)):
        assert _raises(TPL.schedule_steps, *args) == \
            _raises(JPL.schedule_steps, *args)


def test_sequential_stack_equals_jax():
    import jax.numpy as jnp
    params = _mlp_stack(3)
    x = numpy.random.RandomState(1).normal(0, 1, (8, 16)).astype(
        numpy.float32)

    def fj(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def ft(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    want = numpy.asarray(JPL.sequential_stack(
        fj, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x)))
    got = TPL.sequential_stack(
        ft, {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x)).numpy()
    numpy.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture
def f32_roots(clean_roots):
    """Both packages' config trees from a clean slate at
    precision_level 1, put back whole afterwards."""
    for r in clean_roots:
        r.common.engine.precision_level = 1
    yield


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_pipelined_tinylm_ticks_match_jax(schedule, f32_roots, tmp_path):
    """The pipelined TinyLM (2 stacked blocks, no mesh: sequential)
    trains the same ticks as the JAX package's, every schedule; the
    stack's export unstacks into the JAX package's entries, weights
    within the same tolerance."""
    import jax
    from test_torch_training import _build, _arrays
    jwf, twf = _build(seed=7, pipelined=True, n_microbatches=2,
                      schedule=schedule)
    assert type(twf.forwards[1]).__name__ == "PipelinedTransformerStack"
    for step in range(3):
        jwf.loader.run()
        twf.loader.run()
        want = float(jax.device_get(jwf.step_metrics["loss"]))
        assert float(twf.step_metrics["loss"]) == pytest.approx(
            want, rel=1e-5)
        w, g = _arrays(jwf), _arrays(twf)
        for unit, attrs in w.items():
            for attr, arr in attrs.items():
                numpy.testing.assert_allclose(
                    g[unit][attr], arr, rtol=1e-4, atol=2e-5,
                    err_msg="%s step %d %s/%s" % (schedule, step, unit,
                                                  attr))
    # The export unstacks the stack into transformer_block entries, as
    # the JAX package's does, and the port serves it as a causal LM.
    from veles_tpu.export import export_workflow as jexport
    from veles_tpu.export import ExportedModel as JModel
    from veles_tpu_torch.export import export_workflow as texport
    from veles_tpu_torch.export import ExportedModel as TModel
    jexport(jwf, str(tmp_path / "j.tgz"))
    texport(twf, str(tmp_path / "t.tgz"))
    jm, tm = JModel(str(tmp_path / "j.tgz")), \
        TModel(str(tmp_path / "t.tgz"), device="cpu")
    assert [(e["name"], e["type"]) for e in tm.units] == \
        [(e["name"], e["type"]) for e in jm.units]
    assert [e["type"] for e in tm.units] == \
        ["embedding", "transformer_block", "transformer_block", "lm_head"]
    assert sorted(tm.weights) == sorted(jm.weights)
    for key, arr in jm.weights.items():
        numpy.testing.assert_allclose(tm.weights[key], arr, rtol=1e-4,
                                      atol=2e-5, err_msg=key)
    assert tm.is_lm
