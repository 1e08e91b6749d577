"""The port's CIFAR-10 sample (``veles_tpu_torch.znicz.samples.cifar``)
against the JAX package's, on the CPU, on the synthetic fallback.

* Ticks: both packages build ``CifarWorkflow`` from the same seed at
  ``precision_level`` 1 (float32) — the initial parameters and the
  dataset are equal bit for bit — and run the validation ticks and two
  train ticks on the same minibatches: each loss within rtol 1e-5 and
  every parameter after each train tick within ``test_torch_conv.py``'s
  float32 tolerances (rtol 1e-5, an atol of 1e-5 of the tensor's RMS,
  an L2 gap within 1e-5 of its norm; the same float32 math, its sums in
  another order).
* The JAX package's gate (``tests/test_cifar.py``): seed 4242, its
  friendlier init, 5 epochs, validation error < 0.25; the same run with
  stochastic pooling (2x2 windows: it takes non-overlapping ones) trains
  to finite weights.
"""

import jax
import numpy
import pytest
import torch

import veles_tpu.prng as jprng
from veles_tpu.config import root as jroot
from veles_tpu.launcher import Launcher as JLauncher
from veles_tpu.znicz.samples.cifar import CifarWorkflow as JCifar

from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.znicz.samples.cifar import CifarWorkflow, cifar_layers

torch.set_num_threads(2)

RTOL, ATOL_RMS, L2 = 1e-5, 1e-5, 1e-5


@pytest.fixture
def f32_engines():
    saved = [r.common.engine.get("precision_level") for r in (jroot, root)]
    for r in (jroot, root):
        r.common.engine.precision_level = 1
    yield
    for r, value in zip((jroot, root), saved):
        if value is None:
            r.common.engine.__dict__.pop("precision_level", None)
        else:
            r.common.engine.precision_level = value


def _params(wf):
    out = {}
    for unit in wf.units:
        for attr, vec in dict(getattr(unit, "trainables", {}) or {}).items():
            vec.map_read()
            out["%s/%s" % (unit.name, attr)] = numpy.array(vec.mem)
    return out


def test_cifar_ticks_match_jax(f32_engines):
    kw = dict(minibatch_size=100, max_epochs=2)
    jprng.reset()
    jprng.get(0).seed(77)
    jl = JLauncher()
    jwf = JCifar(jl, **kw)
    jl.initialize()
    prng.reset()
    prng.get(0).seed(77)
    tl = Launcher()
    twf = CifarWorkflow(tl, **kw)
    tl.initialize(device="cpu")
    want, got = _params(jwf), _params(twf)
    assert sorted(want) == sorted(got)
    for name in want:
        assert numpy.array_equal(got[name], want[name]), name
    for attr in ("original_data", "original_labels"):
        jv, tv = getattr(jwf.loader, attr), getattr(twf.loader, attr)
        jv.map_read()
        assert numpy.array_equal(tv.mem, jv.mem), attr
    trained = 0
    for _ in range(8):
        jwf.loader.run()
        twf.loader.run()
        assert numpy.array_equal(jwf.loader.minibatch_indices.mem,
                                 twf.loader.minibatch_indices.mem)
        jloss = float(jax.device_get(jwf.step_metrics["loss"]))
        tloss = float(twf.step_metrics["loss"])
        numpy.testing.assert_allclose(tloss, jloss, rtol=1e-5)
        if twf.loader.minibatch_class != TRAIN:
            continue
        trained += 1
        want, got = _params(jwf), _params(twf)
        for name, w in want.items():
            g = got[name]
            atol = ATOL_RMS * float(numpy.sqrt(numpy.mean(w * w)))
            numpy.testing.assert_allclose(g, w, rtol=RTOL, atol=atol,
                                          err_msg=name)
            assert numpy.linalg.norm(g - w) <= L2 * numpy.linalg.norm(w)
        if trained == 2:
            break
    assert trained == 2


def _gate_layers(pool="max_pooling"):
    layers = cifar_layers(0.02, 0.9, 0.0)
    for cfg in layers:
        if "weights_stddev" in cfg.get("->", {}):
            cfg["->"]["weights_stddev"] = 0.05
    if pool != "max_pooling":
        layers[1] = {"type": pool, "->": {"kx": 2, "ky": 2,
                                          "sliding": (2, 2)}}
    return layers


def _train(layers, epochs=5):
    prng.reset()
    prng.get(0).seed(4242)
    launcher = Launcher()
    wf = CifarWorkflow(launcher, max_epochs=epochs, minibatch_size=100,
                       layers=layers)
    launcher.initialize(device="cpu")
    launcher.run()
    return wf


def test_cifar_gate():
    """The JAX package's 5-epoch gate on the port: validation error
    below 0.25; the whole tick is one step; conv1's weights moved."""
    wf = _train(_gate_layers())
    results = wf.gather_results()
    assert results["min_validation_err"] < 0.25
    assert results["epochs"] == 5
    assert len(wf.compiler.forward_units) == 10
    assert len(wf.compiler.gd_map) == 5
    conv0 = wf.forwards[0]
    conv0.weights.map_read()
    assert numpy.abs(conv0.weights.mem).max() > 1e-4


def test_cifar_trains_with_stochastic_pooling():
    wf = _train(_gate_layers("stochastic_pooling"), epochs=2)
    assert type(wf.forwards[1]).__name__ == "StochasticPooling"
    assert wf.gather_results()["epochs"] == 2
    for name, arr in _params(wf).items():
        assert numpy.isfinite(arr).all(), name
