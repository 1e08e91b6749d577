"""The port's StandardWorkflow path — the AlexNet sample and the MNIST784
FC sample — against the JAX package's, tick by tick, on the CPU.

The AlexNet geometry is cut to a tiny stack of the same unit types
(uint8 gather → mean-disp normalizer → conv → LRN at AlexNet's
constants → max-pool with a ceil-mode tail → conv → LRN at constants
where the window dominates, with the asymmetric even window n = 4 →
max-pool → fc → dropout → fc → dropout → softmax) at 32 px, 10
classes, minibatch 16, 64 train and 32 validation images.  MNIST runs
the sample's own (100, 10) tanh/softmax stack on the digits fallback.

Both packages build the same workflow from the same seed: the initial
weights are bit-equal and the loaders serve the same minibatches.
Dropout masks are handed across: the JAX run's ``jax.random.bernoulli``
draws are captured (``jax.debug.callback`` inside its compiled step)
and fed, by shape and in order, to the port's ``DropoutForward.
draw_mask`` — a test-only monkeypatch, since the two generators draw
different numbers by design.  Each tick's loss and every parameter
after it are then held to the JAX package's:

* ``precision_level`` 1 (float32): loss rtol 1e-5; each parameter
  tensor's gap (norm) within 1e-4 of the norm of its change since
  initialization, plus 1e-7 (observed ≤ 7.4e-6: the same float32 math,
  sums in another order);
* ``precision_level`` 0 (bfloat16 stream and conv operands): loss rtol
  1e-4 (observed ≤ 6.2e-7); each gap within 0.1 of the change, plus
  1e-5.  The conv's bfloat16 partial results round at other places in
  XLA's CPU convolution and in PyTorch's (``tests/test_torch_conv.py``:
  up to 0.017 of a gradient's norm per tick), the conv biases' gradients
  sum the most such values, and momentum carries each tick's gap into
  the next: observed ≤ 0.052 of the change (conv1's bias) after four
  train ticks.
"""

import collections
import json
import math
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
from veles_tpu.znicz.samples.imagenet import AlexNetWorkflow as JAlexNet
from veles_tpu.znicz.samples.mnist import MnistWorkflow as JMnist

from veles_tpu_torch import prng as tprng
from veles_tpu_torch import resilience
from veles_tpu_torch.accelerated_units import params_from_numpy
from veles_tpu_torch.config import root as troot
from veles_tpu_torch.launcher import Launcher as TLauncher
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.ops import lrn as ops_lrn
from veles_tpu_torch.znicz.dropout import DropoutForward
from veles_tpu_torch.znicz.samples.imagenet import AlexNetWorkflow as \
    TAlexNet
from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow as TMnist

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GD = {"learning_rate": 0.02, "gradient_moment": 0.9, "weights_decay": 5e-4}
TINY_ALEXNET = [
    {"type": "conv_str",
     "->": {"n_kernels": 8, "kx": 5, "ky": 5, "sliding": (2, 2),
            "weights_stddev": 0.05, "bias_stddev": 0}, "<-": dict(GD)},
    {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5, "k": 2.0}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "conv_str",
     "->": {"n_kernels": 12, "kx": 3, "ky": 3, "padding": 1,
            "weights_stddev": 0.05}, "<-": dict(GD)},
    {"type": "norm", "->": {"alpha": 4.0, "beta": 0.75, "n": 4, "k": 1.0}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "all2all_str",
     "->": {"output_sample_shape": (32,), "weights_stddev": 0.05},
     "<-": dict(GD)},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "all2all_str",
     "->": {"output_sample_shape": (24,), "weights_stddev": 0.05},
     "<-": dict(GD)},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "softmax",
     "->": {"output_sample_shape": (10,), "weights_stddev": 0.05},
     "<-": dict(GD)},
]
ALEXNET = dict(layers=TINY_ALEXNET, minibatch_size=16, max_epochs=3,
               loader_config={"sim_image_size": 32, "sim_classes": 10,
                              "sim_train": 64, "sim_valid": 32})
MNIST = dict(layers=(100, 10), minibatch_size=100, max_epochs=3,
             learning_rate=0.1)
WORKFLOWS = {"alexnet": (JAlexNet, TAlexNet, ALEXNET),
             "mnist": (JMnist, TMnist, MNIST)}
TOL = {1: dict(loss=1e-5, change=1e-4, atol=1e-7),
       0: dict(loss=1e-4, change=0.1, atol=1e-5)}


@pytest.fixture
def engines():
    """Sets precision_level in both packages' trees; restores it."""
    saved = [r.common.engine.get("precision_level") for r in (jroot, troot)]

    def set_level(level):
        for r in (jroot, troot):
            r.common.engine.precision_level = level

    yield set_level
    for r, value in zip((jroot, troot), saved):
        if value is None:
            r.common.engine.__dict__.pop("precision_level", None)
        else:
            r.common.engine.precision_level = value


@pytest.fixture
def dropout_bridge(monkeypatch):
    """Captures every mask the JAX step draws (by shape, in order) and
    hands it to the port's next draw of that shape; returns the queue."""
    captured = collections.defaultdict(list)
    bernoulli = jax.random.bernoulli

    def capture(key, p, shape):
        mask = bernoulli(key, p, shape)
        jax.debug.callback(
            lambda v: captured[v.shape].append(numpy.asarray(v)), mask)
        return mask

    def replay(self, ctx, shape, keep, device):
        return torch.from_numpy(numpy.array(captured[tuple(shape)].pop(0)))

    monkeypatch.setattr(jax.random, "bernoulli", capture)
    monkeypatch.setattr(DropoutForward, "draw_mask", replay)
    return captured


def _build(which, seed, port_only=False, **kwargs):
    jcls, tcls, geometry = WORKFLOWS[which]
    kw = dict(geometry, **kwargs)
    tprng.reset()
    tprng.get(0).seed(seed)
    tl = TLauncher()
    twf = tcls(tl, **kw)
    tl.initialize(device="cpu")
    if port_only:
        return twf
    jprng.reset()
    jprng.get(0).seed(seed)
    jl = JLauncher()
    jwf = jcls(jl, **kw)
    jl.initialize()
    return jwf, twf


def _arrays(wf, which="trainables"):
    out = {}
    for u in wf.units:
        vectors = getattr(u, which, None)
        if not vectors or not isinstance(vectors, dict):
            continue
        for attr, vec in vectors.items():
            vec.map_read()
            out["%s/%s" % (u.name, attr)] = numpy.array(vec.mem)
    return out


@pytest.mark.parametrize("which", sorted(WORKFLOWS))
def test_initial_state_bit_equal(engines, which):
    """Same seed: every parameter and optimizer slot, the resident
    dataset and (AlexNet) the normalizer's mean and rdisp are equal bit
    for bit."""
    engines(0)
    jwf, twf = _build(which, seed=1234)
    for kind in ("trainables", "tstate"):
        want, got = _arrays(jwf, kind), _arrays(twf, kind)
        assert sorted(want) == sorted(got)
        for name, arr in want.items():
            assert got[name].dtype == arr.dtype, name
            assert numpy.array_equal(got[name], arr), name
    vectors = ["original_data", "original_labels"]
    if which == "alexnet":
        vectors += ["mean", "rdisp"]
    for attr in vectors:
        want = getattr(jwf.loader, attr)
        got = getattr(twf.loader, attr)
        want.map_read()
        got.map_read()
        assert numpy.array_equal(got.mem, want.mem), attr


#: (workflow, precision_level, ticks_per_dispatch)
TICK_CASES = {
    "alexnet-f32": ("alexnet", 1, 1),
    "alexnet-bf16": ("alexnet", 0, 1),
    "alexnet-f32-block": ("alexnet", 1, 2),
    "mnist-f32": ("mnist", 1, 1),
    "mnist-bf16": ("mnist", 0, 1),
}


@pytest.mark.parametrize("case", sorted(TICK_CASES))
def test_ticks_match_jax(engines, dropout_bridge, case):
    """An epoch and a half of ticks (validation, then train, then the
    next validation) with the same minibatches and dropout masks: per
    tick loss and parameters within the stated tolerance, and the epoch
    accumulators after them."""
    which, level, ticks = TICK_CASES[case]
    tol = TOL[level]
    engines(level)
    jwf, twf = _build(which, seed=99, ticks_per_dispatch=ticks)
    init = _arrays(jwf)
    steps = 8 if ticks == 1 else 4
    if which == "mnist":
        steps = 6
    trained = 0
    for step in range(steps):
        jwf.loader.run()
        twf.loader.run()
        assert numpy.array_equal(jwf.loader.minibatch_indices.mem,
                                 twf.loader.minibatch_indices.mem)
        if twf.loader.minibatch_class != TRAIN:
            # The JAX block program draws masks in validation ticks too
            # (its train/eval select is traced); the port's do not.
            dropout_bridge.clear()
        else:
            trained += 1
        assert not any(dropout_bridge.values()), "masks left unused"
        if ticks == 1:
            want = float(jax.device_get(jwf.step_metrics["loss"]))
            got = float(twf.step_metrics["loss"])
            assert got == pytest.approx(want, rel=tol["loss"]), step
        want, got = _arrays(jwf), _arrays(twf)
        for name, arr in want.items():
            gap = numpy.linalg.norm(got[name] - arr)
            bound = tol["change"] * numpy.linalg.norm(arr - init[name]) + \
                tol["atol"]
            assert gap <= bound, "%s step %d %s: gap %.3g > %.3g" % (
                case, step, name, gap, bound)
    assert trained
    for cls in (1, 2):
        numpy.testing.assert_allclose(
            twf.evaluator.read_epoch_acc(cls),
            jwf.evaluator.read_epoch_acc(cls), rtol=tol["loss"], atol=1e-5)


def test_params_from_numpy_carries_the_conv_stack(engines, dropout_bridge):
    """The JAX workflow's conv, FC and softmax weights and momentum
    slots, read after a validation and a train tick, load into a port
    workflow whose own were zeroed: the port holds them bit for bit and
    its next train tick equals the JAX package's (float32 tolerance)."""
    engines(1)
    jwf, twf = _build("alexnet", seed=31)
    for _ in range(3):
        jwf.loader.run()
        twf.loader.serve_next_minibatch()  # keep the loaders in step
    dropout_bridge.clear()
    arrays = {}
    for unit in jwf.units:
        for which in ("trainables", "tstate"):
            vectors = getattr(unit, which, None)
            if not isinstance(vectors, dict) or unit is jwf.evaluator:
                continue
            for attr, vec in vectors.items():
                vec.map_read()
                arrays.setdefault(unit.name, {})[attr] = numpy.array(
                    vec.mem)
    assert {"conv_str0", "conv_str3", "all2all_str6", "softmax10",
            "gd_conv_str0"} <= set(arrays)
    for unit, attrs in arrays.items():
        vectors = dict(twf[unit].tstate, **twf[unit].trainables)
        for attr, arr in attrs.items():
            vectors[attr].mem = numpy.zeros_like(arr)
    params_from_numpy(twf, arrays)
    for unit, attrs in arrays.items():
        vectors = dict(twf[unit].tstate, **twf[unit].trainables)
        for attr, arr in attrs.items():
            vectors[attr].map_read()
            assert numpy.array_equal(vectors[attr].mem, arr), (unit, attr)
    jwf.loader.run()
    twf.loader.run()
    assert float(twf.step_metrics["loss"]) == pytest.approx(
        float(jax.device_get(jwf.step_metrics["loss"])), rel=1e-5)
    want, got = _arrays(jwf), _arrays(twf)
    for name, arr in want.items():
        numpy.testing.assert_allclose(got[name], arr, rtol=1e-5, atol=1e-7,
                                      err_msg=name)


def test_tiny_alexnet_converges_through_the_plain_lrn(engines):
    """The byte pipeline trains: tests/test_alexnet.py's stack and gate
    (< 30 % validation error on the synthetic classes after 6 epochs);
    on the CPU the LRN layer launches no kernel."""
    engines(0)
    gd = {"learning_rate": 0.02, "gradient_moment": 0.9}
    layers = [
        {"type": "conv_str",
         "->": {"n_kernels": 16, "kx": 5, "ky": 5, "sliding": (2, 2),
                "weights_stddev": 0.05}, "<-": dict(gd)},
        {"type": "norm", "->": {}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "dropout", "->": {"dropout_ratio": 0.2}},
        {"type": "softmax",
         "->": {"output_sample_shape": (10,), "weights_stddev": 0.05},
         "<-": dict(gd)},
    ]
    launches = (ops_lrn.lrn_forward.launches, ops_lrn.lrn_backward.launches)
    twf = _build("alexnet", seed=31, port_only=True, max_epochs=6,
                 minibatch_size=100, layers=layers,
                 loader_config={"sim_image_size": 32, "sim_classes": 10,
                                "sim_train": 600, "sim_valid": 200})
    twf.workflow.run()
    results = twf.gather_results()
    assert results["epochs"] == 6
    assert results["min_validation_err"] < 0.30
    assert twf.loader.original_data.devmem.dtype == torch.uint8
    names = [type(u).__name__ for u in twf.compiler.forward_units]
    assert "MeanDispNormalizer" in names and \
        "LRNormalizerForward" in names
    assert (ops_lrn.lrn_forward.launches,
            ops_lrn.lrn_backward.launches) == launches


def test_mnist_converges(engines):
    """tests/test_mnist.py's gate on the digits fallback: < 10 %
    validation and < 5 % train error within 8 epochs."""
    engines(0)
    twf = _build("mnist", seed=1234, port_only=True, max_epochs=8)
    twf.workflow.run()
    results = twf.gather_results()
    assert results["epochs"] == 8
    assert results["min_validation_err"] < 0.10
    assert results["min_train_err"] < 0.05


@pytest.mark.parametrize("policy", ["skip", "lr_backoff"])
def test_guardian_on_a_poisoned_epoch(engines, policy):
    """A NaN in the softmax weights makes every train tick non-finite:
    the step's gate drops every update (the other weights stay as they
    were), and at the epoch's end the guardian records the event and
    applies its policy."""
    engines(1)
    troot.common.guardian.policy = policy
    try:
        twf = _build("alexnet", seed=7, port_only=True, max_epochs=1)
    finally:
        troot.common.guardian.__dict__.pop("policy", None)
    twf.forwards[-1].weights.map_write()
    twf.forwards[-1].weights.mem[0, 0] = numpy.nan
    before = _arrays(twf)
    skipped = resilience.stats.get("guardian.skipped")
    twf.workflow.run()
    after = _arrays(twf)
    for name, arr in before.items():
        assert numpy.array_equal(after[name], arr, equal_nan=True), name
    event = twf.guardian.last_event
    assert event["kind"] == "nan" and event["class"] == TRAIN
    if policy == "skip":
        assert event["action"] == "skipped"
        assert resilience.stats.get("guardian.skipped") == skipped + 1
    else:
        assert event["action"] == "lr_backoff"
        assert all(gd.learning_rate == pytest.approx(0.01)
                   for gd in twf.gds)


def test_cli_trains_full_width_alexnet_on_cpu(tmp_path):
    """python -m veles_tpu_torch <imagenet.py> --device cpu runs the
    full-width AlexNet (the 67 px synthetic set, 1000 classes, one
    epoch of two train ticks and one validation tick) and writes its
    results."""
    result = tmp_path / "result.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch",
         os.path.join("veles_tpu_torch", "znicz", "samples", "imagenet.py"),
         "--device", "cpu", "--random-seed", "3",
         "--result-file", str(result),
         "root.imagenet.sim_image_size=67", "root.imagenet.sim_train=32",
         "root.imagenet.sim_valid=16", "root.imagenet.minibatch_size=16",
         "root.imagenet.max_epochs=1",
         "root.imagenet.validate_labels=False"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    data = json.loads(result.read_text())
    assert data["device"] == "cpu" and data["class"] == "AlexNetWorkflow"
    assert data["results"]["epochs"] == 1
    assert math.isfinite(data["results"]["min_validation_err"])
