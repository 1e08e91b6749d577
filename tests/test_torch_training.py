"""The port's training path (``veles_tpu_torch``'s fused tick and the
TinyLM workflow) against the JAX package, on the CPU at a tiny size:
vocab 16, seq 32, embed 32, 4 heads, 2 blocks, minibatch 16.

Both packages build the same workflow from the same seed; the host
halves of their generators are the same numpy code, so the initial
weights are bit-equal and the loaders serve the same minibatches.
Then each tick's loss and every parameter after it are held to the
JAX package's:

* ``precision_level`` 1 (float32 stream): loss rtol 1e-5, parameters
  rtol 1e-5 / atol 1e-6 — the same float32 math, sums in another order
  (the observed gap is ~1e-8 on weights of size ~1);
* ``precision_level`` 0 (bfloat16 stream, the default): loss rtol
  1e-3 (observed ≤ 6e-5); for each parameter tensor, the norm of the
  gap between the two packages within 5e-2 of the norm of the JAX
  package's change since initialization, plus 1e-5.  Activations and
  gradients are rounded to bfloat16 on both sides, and a sum-order
  difference can move a rounding by one bfloat16 ulp (2^-8 ≈ 4e-3
  relative): the first tick's gradients agree to within one such ulp,
  and later ticks compound those flips into the updates — the
  observed gap after four train ticks is ≤ 3.2e-2 of the change (the
  attention projections, whose gradients are smallest at
  initialization).  The 1e-5 floor covers the key bias, whose
  gradient is zero in exact arithmetic (softmax ignores a per-row
  constant), so both packages move it by rounding noise alone.

The optimizers are held to the numpy oracle of
``tests/test_optimizers.py`` (copied below), not to the JAX package's
fused step.
"""

import json
import os
import subprocess
import sys

import jax
import numpy
import pytest
import torch

import veles_tpu.prng as jprng
from veles_tpu.config import root as jroot
from veles_tpu.launcher import Launcher as JLauncher
from veles_tpu.znicz.samples.tinylm import TinyLMWorkflow as JTinyLM

from veles_tpu_torch import prng as tprng
from veles_tpu_torch.accelerated_units import params_from_numpy
from veles_tpu_torch.config import root as troot
from veles_tpu_torch.launcher import Launcher as TLauncher
from veles_tpu_torch.znicz.samples.tinylm import TinyLMWorkflow as TTinyLM

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = dict(vocab_size=16, seq_len=32, embed_dim=32, n_heads=4,
                n_blocks=2, minibatch_size=16,
                loader_config={"n_train": 64, "n_valid": 16})
TOL = {1: dict(loss=1e-5, rtol=1e-5, atol=1e-6),
       0: dict(loss=1e-3, change=5e-2, atol=1e-5)}
KNOBS = ("precision_level", "remat", "fused_qkv", "optimizer")


@pytest.fixture
def engines():
    """Sets engine knobs in both packages' config trees and restores
    them afterwards; returns a setter."""
    saved = [{k: r.common.engine.get(k) for k in KNOBS}
             for r in (jroot, troot)]

    def set_knobs(**knobs):
        for r in (jroot, troot):
            for key, value in knobs.items():
                setattr(r.common.engine, key, value)

    yield set_knobs
    for r, values in zip((jroot, troot), saved):
        for key, value in values.items():
            if value is None:
                r.common.engine.__dict__.pop(key, None)
            else:
                setattr(r.common.engine, key, value)


def _build(seed=None, port_only=False, **kwargs):
    kw = dict(GEOMETRY, **kwargs)
    tprng.reset()
    if seed is not None:
        tprng.get(0).seed(seed)
    tl = TLauncher()
    twf = TTinyLM(tl, **kw)
    tl.initialize(device="cpu")
    if port_only:
        return twf
    jprng.reset()
    if seed is not None:
        jprng.get(0).seed(seed)
    jl = JLauncher()
    jwf = JTinyLM(jl, **kw)
    jl.initialize()
    return jwf, twf


def _arrays(wf, which="trainables"):
    """{unit name: {attr: host array}} of every unit's trainables (or
    tstate)."""
    out = {}
    for u in wf.units:
        vectors = getattr(u, which, None)
        if not vectors or not isinstance(vectors, dict):
            continue
        out[u.name] = {}
        for attr, vec in vectors.items():
            vec.map_read()
            out[u.name][attr] = numpy.array(vec.mem)
    return out


def _assert_params_close(jwf, twf, tol, what, init=None):
    """Parameters within ``tol``: elementwise rtol/atol, or — with a
    "change" tolerance — each tensor's change since ``init`` within
    that fraction of its largest change."""
    want, got = _arrays(jwf), _arrays(twf)
    assert sorted(want) == sorted(got)
    for unit, attrs in want.items():
        assert sorted(attrs) == sorted(got[unit])
        for attr, arr in attrs.items():
            msg = "%s: %s/%s" % (what, unit, attr)
            if "change" not in tol:
                numpy.testing.assert_allclose(
                    got[unit][attr], arr, rtol=tol["rtol"],
                    atol=tol["atol"], err_msg=msg)
                continue
            want_change = arr - init[unit][attr]
            gap = numpy.linalg.norm(got[unit][attr] - arr)
            bound = tol["change"] * numpy.linalg.norm(want_change) + \
                tol["atol"]
            assert gap <= bound, "%s: |Δ gap| %.3g > %.3g" % (
                msg, gap, bound)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_initial_weights_bit_equal(engines, fused):
    """Same seed, same host init: every parameter and optimizer slot
    equal bit for bit, split and fused QKV layouts."""
    engines(precision_level=0)
    jwf, twf = _build(seed=1234, fused_qkv=fused)
    for which in ("trainables", "tstate"):
        want, got = _arrays(jwf, which), _arrays(twf, which)
        assert sorted(want) == sorted(got)
        for unit, attrs in want.items():
            assert sorted(attrs) == sorted(got[unit]), unit
            for attr, arr in attrs.items():
                assert got[unit][attr].dtype == arr.dtype
                assert numpy.array_equal(got[unit][attr], arr), \
                    "%s/%s" % (unit, attr)


def test_same_minibatches(engines):
    """Both loaders serve the same index order, classes and epoch
    flags over two epochs (shuffles come from the host prng)."""
    engines(precision_level=0)
    jwf, twf = _build(seed=77)
    for _ in range(2 * 5):  # 5 minibatches per epoch
        served = []
        for loader in (jwf.loader, twf.loader):
            loader.serve_next_minibatch()
            served.append((loader.minibatch_indices.mem.tolist(),
                           loader.minibatch_mask.mem.tolist(),
                           loader.minibatch_class, loader.last_minibatch,
                           loader.epoch_ended, loader.epoch_number))
        assert served[0] == served[1]


#: (precision_level, ticks_per_dispatch, fused_qkv, remat)
TICK_CASES = {
    "f32-single-split-remat": (1, 1, False, True),
    "f32-single-fused": (1, 1, True, False),
    "f32-block-split": (1, 3, False, False),
    "f32-block-fused-remat": (1, 3, True, True),
    "bf16-single-split-remat": (0, 1, False, True),
    "bf16-single-fused": (0, 1, True, False),
    "bf16-block-fused-remat": (0, 3, True, True),
}


@pytest.mark.parametrize("case", sorted(TICK_CASES))
def test_ticks_match_jax(engines, case):
    """Per-tick loss and parameters equal the JAX package's for the
    first ticks (a validation tick, then train ticks), single-tick and
    block mode, split and fused QKV, remat on and off; the epoch
    accumulators agree too."""
    level, ticks, fused, remat = TICK_CASES[case]
    tol = TOL[level]
    engines(precision_level=level, remat=remat)
    jwf, twf = _build(seed=99, fused_qkv=fused, ticks_per_dispatch=ticks)
    init = _arrays(jwf)
    for step in range(3 if ticks > 1 else 5):
        jwf.loader.run()
        twf.loader.run()
        assert numpy.array_equal(jwf.loader.minibatch_indices.mem,
                                 twf.loader.minibatch_indices.mem)
        if ticks == 1:
            want = float(jax.device_get(jwf.step_metrics["loss"]))
            got = float(twf.step_metrics["loss"])
            assert got == pytest.approx(want, rel=tol["loss"]), step
        _assert_params_close(jwf, twf, tol, "%s step %d" % (case, step),
                             init)
    for cls in (1, 2):
        want = jwf.evaluator.read_epoch_acc(cls)
        got = twf.evaluator.read_epoch_acc(cls)
        numpy.testing.assert_allclose(got, want, rtol=tol["loss"],
                                      atol=tol["atol"])


def test_first_token_recall_reaches_zero_error(engines):
    """The sample's own task: first-token recall trains to 0.0
    validation error in block mode, as the JAX sample does."""
    engines(precision_level=0)
    twf = _build(port_only=True, seed=42, ticks_per_dispatch=4,
                 n_blocks=1, loader_config=None, minibatch_size=64,
                 max_epochs=8)
    twf.workflow.run()
    results = twf.gather_results()
    assert results["epochs"] == 8
    assert results["min_validation_err"] == 0.0


def _oracle_update(name, hyper, attr, p, g, slots):
    """Per-rule numpy reference (float32 throughout, like the step) —
    tests/test_optimizers.py's oracle."""
    f32 = numpy.float32
    lr, decay = f32(hyper["learning_rate"]), f32(
        hyper["weights_decay"])
    if name == "sgd":
        moment = f32(hyper["gradient_moment"])
        geff = g + decay * p if hyper["weights_decay"] else g
        key = "velocity_" + attr
        if hyper["gradient_moment"] and key in slots:
            v = moment * slots[key] - lr * geff
            return p + v, {key: v}
        return p - lr * geff, {}
    if name in ("adam", "adamw"):
        b1, b2 = f32(hyper["beta1"]), f32(hyper["beta2"])
        eps = f32(hyper["eps"])
        t = slots["adam_t_" + attr] + f32(1.0)
        geff = g + decay * p \
            if (name == "adam" and hyper["weights_decay"]) else g
        m = b1 * slots["adam_m_" + attr] + (f32(1) - b1) * geff
        v = b2 * slots["adam_v_" + attr] + \
            (f32(1) - b2) * geff * geff
        mhat = m / (f32(1) - b1 ** t)
        vhat = v / (f32(1) - b2 ** t)
        step = lr * mhat / (numpy.sqrt(vhat) + eps)
        if name == "adamw":
            step = step + lr * decay * p
        return p - step, {"adam_m_" + attr: m, "adam_v_" + attr: v,
                          "adam_t_" + attr: t}
    assert name == "lion"
    b1, b2 = f32(hyper["beta1"]), f32(hyper["beta2"])
    m0 = slots["lion_m_" + attr]
    u = numpy.sign(b1 * m0 + (f32(1) - b1) * g)
    step = lr * u + lr * decay * p
    return p - step, {"lion_m_" + attr: b2 * m0 + (f32(1) - b2) * g}


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "lion"])
def test_optimizer_matches_numpy_oracle(engines, name):
    """Three train ticks, each checked against the numpy oracle applied
    to the exact gradients the step computed (rtol 1e-5, atol 1e-6:
    float32 on both sides)."""
    engines(precision_level=1, optimizer=name)
    twf = _build(port_only=True, seed=5)
    for gd in twf.gds:
        assert gd.optimizer == name
        gd.weights_decay = 0.0005
    c = twf.compiler
    twf.loader.serve_next_minibatch()  # the validation minibatch
    for step in range(3):
        twf.loader.serve_next_minibatch()
        assert twf.loader.minibatch_is_training
        c._ensure_compiled()
        params = {n: v.devmem for n, v in c._param_vecs.items()}
        states = {n: v.devmem for n, v in c._state_vecs.items()}
        batch = {str(id(v)): v.devmem for v in c.batch_vectors}
        consts = {str(id(v)): v.devmem for v in c.const_vectors}
        leaves = {n: p.clone().requires_grad_(True)
                  for n, p in params.items()}
        from veles_tpu_torch.accelerated_units import StepContext
        loss = c._run_forward(leaves, states, batch, consts,
                              StepContext())[0]
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        p0 = {n: p.numpy().copy() for n, p in params.items()}
        s0 = {n: s.numpy().copy() for n, s in states.items()}
        c.execute(training=True)
        for gd in twf.gds:
            slots0 = {s: s0["%s/%s" % (gd.name, s)] for s in gd.tstate}
            for attr in gd.target.trainables:
                pkey = "%s/%s" % (gd.target.name, attr)
                exp_p, exp_slots = _oracle_update(
                    name, gd._hyper_dict(attr), attr, p0[pkey],
                    grads[pkey].numpy(), slots0)
                got = c._param_vecs[pkey].devmem.numpy()
                numpy.testing.assert_allclose(
                    got, exp_p, rtol=1e-5, atol=1e-6,
                    err_msg="%s step %d %s" % (name, step, pkey))
                for sname, exp in exp_slots.items():
                    got = c._state_vecs["%s/%s" % (gd.name, sname)] \
                        .devmem.numpy()
                    numpy.testing.assert_allclose(
                        got, exp, rtol=1e-5, atol=1e-6,
                        err_msg="%s step %d %s" % (name, step, sname))


def test_params_from_numpy_carries_weights_and_slots(engines):
    """The JAX workflow's parameters and momentum slots, read after two
    ticks, loaded into a port workflow whose own parameters and slots
    were zeroed (same seed, so the loaders serve the same batches): the
    port then holds them bit for bit, and its next tick equals the JAX
    package's (float32 tolerance above)."""
    engines(precision_level=1)
    jwf, twf = _build(seed=31)
    for _ in range(2):
        jwf.loader.run()
        twf.loader.serve_next_minibatch()  # keep the loaders in step
    arrays = _arrays(jwf)
    for unit, slots in _arrays(jwf, "tstate").items():
        if unit.startswith("GD"):
            arrays[unit] = slots
    for unit, attrs in arrays.items():
        vectors = dict(twf[unit].tstate, **twf[unit].trainables)
        for attr in attrs:
            vectors[attr].mem = numpy.zeros_like(attrs[attr])
    params_from_numpy(twf, arrays)
    for which in ("trainables", "tstate"):
        got = _arrays(twf, which)
        for unit in arrays:
            for attr, arr in got.get(unit, {}).items():
                if attr in arrays[unit]:
                    assert numpy.array_equal(arr, arrays[unit][attr])
    jwf.loader.run()
    twf.loader.run()
    assert float(twf.step_metrics["loss"]) == pytest.approx(
        float(jax.device_get(jwf.step_metrics["loss"])), rel=1e-5)
    _assert_params_close(jwf, twf, TOL[1], "after params_from_numpy")
    with pytest.raises(KeyError):
        params_from_numpy(twf, {"block0": {"nope": arrays["block0"]["wq"]}})
    with pytest.raises(ValueError):
        params_from_numpy(twf, {"block0": {"wq": arrays["block0"]["w1"]}})


def test_cli_trains_tinylm_on_cpu(tmp_path):
    """python -m veles_tpu_torch <tinylm.py> --device cpu writes its
    results; first-token recall reaches 0.0 validation error."""
    result = tmp_path / "result.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch",
         os.path.join("veles_tpu_torch", "znicz", "samples", "tinylm.py"),
         "--device", "cpu", "--random-seed", "42",
         "--result-file", str(result)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    data = json.loads(result.read_text())
    assert data["device"] == "cpu"
    assert data["results"]["epochs"] == 8
    assert data["results"]["min_validation_err"] == 0.0


def test_cli_refuses_what_is_not_ported():
    """Modes of the JAX CLI that the port lacks raise "not yet
    ported" (``--frontend``, ROADMAP A8b-ii); a missing card raises
    instead of running on the CPU."""
    from veles_tpu_torch.__main__ import Main
    # --trace-out (A8a) and --dry-run (A8b-i) are ported: they parse.
    assert Main(["wf.py", "--trace-out", "t.json"]).parse().trace_out \
        == "t.json"
    assert Main(["wf.py", "--dry-run", "init"]).parse().dry_run == "init"
    with pytest.raises(NotImplementedError, match="A8b-ii"):
        Main(["wf.py", "--frontend"]).parse()
    if not torch.cuda.is_available():
        from veles_tpu_torch.error import DeviceNotFoundError
        with pytest.raises(DeviceNotFoundError):
            TLauncher().initialize()
    # The MoE TinyLM builds (its ticks are held to the JAX package's
    # in test_torch_moe.py).
    assert TTinyLM(TLauncher(), n_experts=4).forwards[1].n_experts == 4
