"""The port's znicz layer units against the JAX package's, unit by unit,
on the CPU: conv, pooling, all2all, the standalone activations,
dropout, EvaluatorSoftmax / EvaluatorMSE and the mean-disp normalizer.

Each unit's ``tforward`` runs in both packages on the same seeded numpy
inputs and parameters; the outputs, and the gradients of a seeded
random cotangent with respect to the input and every parameter
(``jax.vjp`` against ``torch.autograd``), are held to each other:

* ``precision_level`` 1 (float32 stream): rtol 1e-5, an atol of 1e-5
  of the reference's RMS, and an L2 gap within 1e-5 of its norm (the
  sums run in another order: observed ≤ 1.7e-6 of the RMS);
* ``precision_level`` 0 (bfloat16 operands and stream): rtol 2^-7 (one
  bfloat16 ulp), an atol of 2^-4 of the reference's RMS and an L2 gap
  within 2^-5 of its norm.  The conv, its bias and its activation each
  round to bfloat16 on both sides, but XLA's CPU convolution and
  PyTorch's round their bfloat16 partial results at other places, so
  the conv outputs differ by up to 2 ulps and its gradients — sums of
  bfloat16 cotangents that cancel — by up to 0.028 of their RMS
  elementwise and 0.017 of their norm (observed); the elementwise
  units (pooling, activations, dropout) agree far closer.
"""

import types

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu.znicz as jz
from veles_tpu.config import root as jroot
from veles_tpu.memory import Vector as JVector
from veles_tpu.mean_disp_normalizer import MeanDispNormalizer as JMeanDisp

import veles_tpu_torch.znicz as tz
from veles_tpu_torch.config import root as troot
from veles_tpu_torch.memory import Vector as TVector
from veles_tpu_torch.mean_disp_normalizer import MeanDispNormalizer as \
    TMeanDisp

torch.set_num_threads(2)

#: precision_level -> (rtol, atol as a share of the reference's RMS, L2
#: gap as a share of the reference's norm).
TOL = {1: (1e-5, 1e-5, 1e-5), 0: (2.0 ** -7, 2.0 ** -4, 2.0 ** -5)}


@pytest.fixture
def precision():
    """Sets precision_level in both packages' trees; restores it."""
    saved = [r.common.engine.get("precision_level") for r in (jroot, troot)]

    def set_level(level):
        for r in (jroot, troot):
            r.common.engine.precision_level = level
        return level

    yield set_level
    for r, value in zip((jroot, troot), saved):
        if value is None:
            r.common.engine.__dict__.pop("precision_level", None)
        else:
            r.common.engine.precision_level = value


def _units(name, **kwargs):
    """The same unit class in both packages (by attribute name), with
    its links set to fresh Vectors."""
    junit = getattr(jz, name)(None, **kwargs)
    tunit = getattr(tz, name)(None, **kwargs)
    junit.input, tunit.input = JVector(), TVector()
    return junit, tunit


def _apply(unit, arrays, params, training=False):
    """Runs ``unit.tforward`` on ``arrays`` (attr → array of the
    framework) and ``params``; returns {written attr name: value}."""
    by_id = {id(getattr(unit, a)): v for a, v in arrays.items()
             if not a.startswith("__")}
    names = {id(v): a for a, v in vars(unit).items()
             if isinstance(v, (JVector, TVector))}
    out = {}

    def write(vec, val):
        out[names.get(id(vec), id(vec))] = val

    ctx = types.SimpleNamespace(training=training, metrics={},
                                loss=None, next_key=lambda: None,
                                batch_sum=lambda v: v)
    ctx.set_loss = lambda v: setattr(ctx, "loss", v)
    ctx.add_metric = lambda k, v: ctx.metrics.__setitem__(k, v)
    upd = unit.tforward(lambda vec: by_id[id(vec)], write, params, ctx,
                        state=arrays.get("__state__"))
    out.update(ctx.metrics)
    if ctx.loss is not None:
        out["loss"] = ctx.loss
    if upd:
        out.update({"state/" + k: v for k, v in upd.items()})
    return out


def _jax(x):
    return jnp.asarray(x)


def _torch(x):
    return torch.from_numpy(numpy.array(x))


def _close(got, want, level, what):
    got = numpy.asarray(got, dtype=numpy.float32)
    want = numpy.asarray(want, dtype=numpy.float32)
    assert got.shape == want.shape, what
    # NaN where both packages divide 0 by 0 (an average-pooling window of
    # padding only), and nowhere else.
    nan = numpy.isnan(want)
    assert numpy.array_equal(numpy.isnan(got), nan), what
    got, want = got[~nan], want[~nan]
    rtol, atol_rms, l2 = TOL[level]
    atol = atol_rms * float(numpy.sqrt(numpy.mean(want * want))) + 1e-30
    numpy.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                  err_msg=what)
    gap = numpy.linalg.norm(got - want)
    assert gap <= l2 * numpy.linalg.norm(want) + 1e-30, \
        "%s: L2 gap %.3g of the norm" % (what, gap / numpy.linalg.norm(want))


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return numpy.asarray(jnp.asarray(v).astype(jnp.float32))


def _check_unit(junit, tunit, x, params, level, out="output", seed=0):
    """Forward of ``out`` and the gradients of a random cotangent with
    respect to x and every param, in both packages; at level 0 the input
    enters in bfloat16, as the activation stream does."""
    rng = numpy.random.RandomState(seed + 1)
    names = sorted(params)

    def jf(xv, *pv):
        return _apply(junit, {"input": xv}, dict(zip(names, pv)))[out]

    jx = _jax(x)
    tx = _torch(x)
    if level == 0 and x.dtype.kind == "f":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jy, vjp = jax.vjp(jf, jx, *[_jax(params[n]) for n in names])
    cot = rng.randn(*jy.shape).astype(numpy.float32)
    jgrads = vjp(jnp.asarray(cot).astype(jy.dtype))

    tx = tx.requires_grad_(x.dtype.kind == "f")
    tparams = {n: _torch(params[n]).requires_grad_(True) for n in names}
    ty = _apply(tunit, {"input": tx}, tparams)[out]
    assert str(ty.dtype).split(".")[-1] == str(jy.dtype), (ty.dtype, jy.dtype)
    _close(_np(ty), _np(jy), level, "%s forward" % type(tunit).__name__)
    leaves = ([tx] if tx.requires_grad else []) + [tparams[n] for n in names]
    tgrads = torch.autograd.grad(ty, leaves, _torch(cot).to(ty.dtype))
    if not tx.requires_grad:
        jgrads = jgrads[1:]
    for name, g, w in zip((["x"] if tx.requires_grad else []) + names,
                          tgrads, jgrads):
        _close(_np(g), _np(w), level,
               "%s d%s" % (type(tunit).__name__, name))
    return _np(ty), _np(jy)


CONV_CASES = {
    "s4-valid-str": ("ConvStrictRelu", dict(n_kernels=6, kx=5, ky=5,
                                            sliding=(4, 4))),
    "s1-pad2-tanh": ("ConvTanh", dict(n_kernels=5, kx=5, ky=3, padding=2)),
    "s2-pad-xy-relu": ("ConvRelu", dict(n_kernels=4, kx=3, ky=3,
                                        sliding=(2, 1), padding=(1, 0))),
    "asym-pad-sigmoid": ("ConvSigmoid", dict(n_kernels=4, kx=3,
                                             padding=(0, 1, 2, 1))),
    "identity": ("Conv", dict(n_kernels=3, kx=2, sliding=(1, 2))),
}


@pytest.mark.parametrize("level", [1, 0])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv(precision, case, level):
    precision(level)
    name, kw = CONV_CASES[case]
    junit, tunit = _units(name, **kw)
    rng = numpy.random.RandomState(len(case))
    x = rng.randn(2, 13, 11, 3).astype(numpy.float32)
    params = {"weights": (rng.randn(kw.get("ky", kw["kx"]), kw["kx"], 3,
                                    kw["n_kernels"]) * 0.3).astype(
                                        numpy.float32),
              "bias": (rng.randn(kw["n_kernels"]) * 0.1).astype(
                  numpy.float32)}
    y, _ = _check_unit(junit, tunit, x, params, level)
    assert y.shape[1:3] == tunit.output_spatial(13, 11)


POOL_CASES = {
    # 14 → 7 windows: the last needs a padded tail (ceil mode).
    "max-ceil-tail": ("MaxPooling", dict(kx=3, ky=3, sliding=(2, 2)), 14),
    "max-exact": ("MaxPooling", dict(kx=3, ky=3, sliding=(2, 2)), 13),
    "maxabs-tail": ("MaxAbsPooling", dict(kx=2, ky=3, sliding=(2, 2)), 10),
    "avg-tail": ("AvgPooling", dict(kx=3, ky=2, sliding=(2, 3)), 11),
    # The last column's windows hold padding only: 0 / 0 in both.
    "avg-padded": ("AvgPooling", dict(kx=2, padding=1), 6),
}


@pytest.mark.parametrize("level", [1, 0])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling(precision, case, level):
    precision(level)
    name, kw, size = POOL_CASES[case]
    junit, tunit = _units(name, **kw)
    rng = numpy.random.RandomState(size)
    # Distinct values in float32 (rounding to bfloat16 may tie some; a
    # tie routes alike in both packages, see the test below).
    x = rng.permutation(2 * size * (size + 1) * 4).reshape(
        2, size, size + 1, 4).astype(numpy.float32) / 50.0 - 3.0
    y, _ = _check_unit(junit, tunit, x, {}, level)
    assert y.shape[1:3] == tunit.output_spatial(size, size + 1)
    if name == "MaxAbsPooling":
        # The signed value of the max-|x| element: some windows negative.
        assert (y < 0).any() and (y > 0).any()


def test_pooling_tail_and_count(precision):
    """Ceil mode pools the ragged tail over the real elements only: the
    max of a tail window is its largest REAL value, and the average
    divides by the count of real elements."""
    precision(1)
    x = numpy.arange(5 * 5, dtype=numpy.float32).reshape(1, 5, 5, 1) - 30
    _, tmax = _units("MaxPooling", kx=2, sliding=(2, 2))
    _, tavg = _units("AvgPooling", kx=2, sliding=(2, 2))
    ymax = _apply(tmax, {"input": _torch(x)}, {})["output"]
    yavg = _apply(tavg, {"input": _torch(x)}, {})["output"]
    assert ymax.shape == (1, 3, 3, 1)
    assert ymax[0, 2, 2, 0] == x[0, 4, 4, 0]        # 1 real element
    assert ymax[0, 0, 2, 0] == x[0, 1, 4, 0]        # 2 real elements
    assert yavg[0, 2, 2, 0] == x[0, 4, 4, 0]
    assert yavg[0, 0, 2, 0] == (x[0, 0, 4, 0] + x[0, 1, 4, 0]) / 2


@pytest.mark.parametrize("name", ["MaxPooling", "MaxAbsPooling"])
def test_max_pool_ties_route_like_jax(precision, name):
    """A planted tie: windows whose maximum appears twice (and overlapping
    windows sharing one).  JAX's reduce-window max and PyTorch's
    max_pool2d each send a window's gradient to ONE of the tied
    elements; both pick the first in row-major window order, so the
    input gradients are equal exactly."""
    precision(1)
    x = numpy.zeros((1, 5, 5, 2), dtype=numpy.float32)
    x[0, 0, 0, 0] = x[0, 0, 1, 0] = 2.0        # tie inside window (0, 0)
    x[0, 2, 2, 0] = x[0, 2, 3, 0] = x[0, 3, 2, 0] = 1.5
    x[0, :, :, 1] = 1.0                        # every window all ties
    junit, tunit = _units(name, kx=3, sliding=(2, 2))
    rng = numpy.random.RandomState(3)
    cot = rng.rand(1, 2, 2, 2).astype(numpy.float32) + 1.0

    def jf(v):
        return _apply(junit, {"input": v}, {})["output"]

    jy, vjp = jax.vjp(jf, _jax(x))
    want = numpy.asarray(vjp(jnp.asarray(cot))[0])
    tx = _torch(x).requires_grad_(True)
    ty = _apply(tunit, {"input": tx}, {})["output"]
    got = torch.autograd.grad(ty, tx, _torch(cot))[0].numpy()
    numpy.testing.assert_array_equal(got, want)
    # One element per window gets the whole cotangent.
    assert numpy.count_nonzero(got[0, :, :, 1]) <= 4
    assert got[0, 0, 0, 0] == cot[0, 0, 0, 0] and got[0, 0, 1, 0] == 0


@pytest.mark.parametrize("level", [1, 0])
@pytest.mark.parametrize("name", ["All2All", "All2AllTanh", "All2AllRelu",
                                  "All2AllStrictRelu", "All2AllSigmoid",
                                  "All2AllSoftmax"])
def test_all2all_flattens_nhwc(precision, name, level):
    """A (B, H, W, C) input flattens per sample in NHWC order, so the
    same weights mean the same features in both packages; the softmax
    layer's logits, probabilities and argmax agree too."""
    precision(level)
    junit, tunit = _units(name, output_sample_shape=(7,))
    rng = numpy.random.RandomState(5)
    x = rng.randn(3, 2, 3, 4).astype(numpy.float32)
    params = {"weights": (rng.randn(24, 7) * 0.3).astype(numpy.float32),
              "bias": (rng.randn(7) * 0.1).astype(numpy.float32)}
    out = "logits" if name == "All2AllSoftmax" else "output"
    _check_unit(junit, tunit, x, params, level, out=out)
    if name == "All2AllSoftmax":
        jout = _apply(junit, {"input": _jax(x)},
                      {k: _jax(v) for k, v in params.items()})
        tout = _apply(tunit, {"input": _torch(x)},
                      {k: _torch(v) for k, v in params.items()})
        _close(_np(tout["output"]), _np(jout["output"]), level, "probs")
        assert numpy.array_equal(tout["max_idx"].numpy(),
                                 numpy.asarray(jout["max_idx"]))
    if name == "All2All" and level == 1:
        # The flatten order: feature (h·W + w)·C + c is x[b, h, w, c].
        tout = _apply(tunit, {"input": _torch(x)},
                      {k: _torch(v) for k, v in params.items()})
        numpy.testing.assert_allclose(
            tout["output"].numpy(),
            x.reshape(3, -1) @ params["weights"] + params["bias"],
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("level", [1, 0])
@pytest.mark.parametrize("name", ["ForwardTanh", "ForwardRelu",
                                  "ForwardStrictRelu", "ForwardSigmoid",
                                  "ForwardLog", "ForwardTanhLog",
                                  "ForwardSinCos", "ForwardMul"])
def test_activations(precision, name, level):
    precision(level)
    kw = {"factor": 1.5} if name == "ForwardMul" else {}
    junit, tunit = _units(name, **kw)
    rng = numpy.random.RandomState(7)
    # Values across ForwardTanhLog's threshold (|x| = 3), and none at
    # |x| = 2 where its unused log branch is singular.
    x = (rng.rand(4, 3, 5) * 12 - 6).astype(numpy.float32)
    x[numpy.abs(numpy.abs(x) - 2.0) < 0.05] = 0.5
    params = {"factor": numpy.float32(1.5) * numpy.ones((), numpy.float32)} \
        if name == "ForwardMul" else {}
    _check_unit(junit, tunit, x, params, level)


def _masks(shape, keep, seed):
    return numpy.random.RandomState(seed).rand(*shape) < keep


@pytest.mark.parametrize("level", [1, 0])
def test_dropout(precision, monkeypatch, level):
    """Eval is the identity; train keeps the masked elements scaled by
    1/keep (rounded to the stream's dtype, as the JAX package's weakly
    typed scalar is) and routes the gradient through the same mask.
    Both packages are handed the same numpy mask: the port's through
    ``draw_mask``, the JAX package's through ``jax.random.bernoulli``
    (the generators differ by design)."""
    precision(level)
    ratio = 0.3
    junit, tunit = _units("DropoutForward", dropout_ratio=ratio)
    rng = numpy.random.RandomState(11)
    x = _np(_jax(rng.randn(4, 6, 5)).astype(jnp.bfloat16))
    mask = _masks(x.shape, 1.0 - ratio, seed=2)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask))
    monkeypatch.setattr(tunit, "draw_mask",
                        lambda ctx, shape, keep, device: _torch(mask))
    dtype = jnp.bfloat16 if level == 0 else jnp.float32
    tdtype = torch.bfloat16 if level == 0 else torch.float32
    for training in (False, True):
        def jf(v):
            return _apply(junit, {"input": v}, {},
                          training=training)["output"]

        jx = _jax(x).astype(dtype)
        jy, vjp = jax.vjp(jf, jx)
        cot = rng.randn(*x.shape).astype(numpy.float32)
        jg = vjp(jnp.asarray(cot).astype(dtype))[0]
        tx = _torch(x).to(tdtype).requires_grad_(True)
        ty = _apply(tunit, {"input": tx}, {},
                    training=training)["output"]
        tg = torch.autograd.grad(ty, tx, _torch(cot).to(tdtype))[0]
        assert numpy.array_equal(_np(ty), _np(jy))
        assert numpy.array_equal(_np(tg), _np(jg))
        if not training:
            assert numpy.array_equal(_np(ty), x)
        else:
            scale = float(torch.tensor(1 / (1 - ratio), dtype=tdtype))
            assert numpy.array_equal(_np(ty), _np(
                _torch(x).to(tdtype) *
                _torch(mask).to(tdtype) * scale))
            assert numpy.array_equal(_np(tg) == 0, ~mask | (cot == 0))


def test_dropout_mask_comes_from_the_step_generator():
    """The port draws its mask from ``ctx.next_key()``: the same
    generator state gives the same mask, and the keep share is near
    1 − ratio."""
    _, tunit = _units("DropoutForward", dropout_ratio=0.25)
    masks = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(123)
        ctx = types.SimpleNamespace(next_key=lambda: gen)
        masks.append(tunit.draw_mask(ctx, (64, 64), 0.75, "cpu"))
    assert torch.equal(masks[0], masks[1])
    assert abs(masks[0].float().mean().item() - 0.75) < 0.03


def _state():
    return {"epoch_acc": numpy.zeros((3, 4), numpy.float32),
            "health_acc": numpy.zeros((3, 4), numpy.float32)}


@pytest.mark.parametrize("level", [1, 0])
def test_evaluator_softmax(precision, level):
    """Masked NLL from the logits, n_err, n_valid, the epoch accumulator
    row and the capture buffer, and the loss's gradient."""
    precision(level)
    jev = jz.EvaluatorSoftmax(None)
    tev = tz.EvaluatorSoftmax(None)
    rng = numpy.random.RandomState(13)
    logits = (rng.randn(6, 5) * 2).astype(numpy.float32)
    labels = rng.randint(0, 5, 6).astype(numpy.int32)
    mask = numpy.array([1, 1, 1, 1, 0, 0], numpy.float32)
    idx = numpy.array([4, 0, 2, 1, 0, 0], numpy.int32)
    for ev, vec in ((jev, JVector), (tev, TVector)):
        ev.input, ev.labels, ev.mask = vec(), vec(), vec()
        ev.minibatch_class_vec = vec()
        ev.capture_outputs = True
        ev.sample_indices = vec()
        ev.capture = vec(numpy.zeros((6, 5), numpy.float32))
    outs = []
    for ev, conv in ((jev, _jax), (tev, _torch)):
        state = {k: conv(v) for k, v in _state().items()}
        state["capture"] = conv(numpy.zeros((6, 5), numpy.float32))
        arrays = {"input": conv(logits), "labels": conv(labels),
                  "mask": conv(mask), "minibatch_class_vec":
                  conv(numpy.int32(2)), "sample_indices": conv(idx),
                  "__state__": state}
        outs.append(_apply(ev, arrays, {}))
    jout, tout = outs
    for key in ("loss", "n_err", "n_valid", "state/epoch_acc",
                "state/capture"):
        numpy.testing.assert_allclose(_np(tout[key]), _np(jout[key]),
                                      rtol=1e-5, atol=1e-6, err_msg=key)
    assert _np(tout["n_valid"]) == 4
    jg = jax.grad(lambda v: _apply(jev, {
        "input": v, "labels": _jax(labels), "mask": _jax(mask),
        "minibatch_class_vec": _jax(numpy.int32(2))}, {})["loss"])(
            _jax(logits))
    tl = _torch(logits).requires_grad_(True)
    loss = _apply(tev, {"input": tl, "labels": _torch(labels),
                        "mask": _torch(mask), "minibatch_class_vec":
                        _torch(numpy.int32(2))}, {})["loss"]
    numpy.testing.assert_allclose(torch.autograd.grad(loss, tl)[0].numpy(),
                                  numpy.asarray(jg), rtol=1e-5, atol=1e-7)


def test_evaluator_mse_and_mean_disp(precision):
    precision(1)
    rng = numpy.random.RandomState(17)
    y = rng.randn(5, 3, 2).astype(numpy.float32)
    t = rng.randn(5, 3, 2).astype(numpy.float32)
    mask = numpy.array([1, 1, 0, 1, 1], numpy.float32)
    outs = []
    for cls, vec, conv in ((jz.EvaluatorMSE, JVector, _jax),
                           (tz.EvaluatorMSE, TVector, _torch)):
        ev = cls(None)
        ev.input, ev.target, ev.mask = vec(t), vec(t), vec()
        ev.minibatch_class_vec = vec()
        outs.append(_apply(ev, {
            "input": conv(y), "target": conv(t), "mask": conv(mask),
            "minibatch_class_vec": conv(numpy.int32(1)),
            "__state__": {k: conv(v) for k, v in _state().items()}},
            {}))
    for key in ("loss", "mse", "n_valid", "state/epoch_acc"):
        numpy.testing.assert_allclose(_np(outs[1][key]), _np(outs[0][key]),
                                      rtol=1e-5, err_msg=key)
    x = rng.randint(0, 256, (4, 6, 5, 3)).astype(numpy.uint8)
    mean = (rng.rand(6, 5, 3) * 128).astype(numpy.float32)
    rdisp = (1.0 / (rng.rand(6, 5, 3) * 60 + 4)).astype(numpy.float32)
    for level in (1, 0):
        precision(level)
        res = []
        for cls, vec, conv in ((JMeanDisp, JVector, _jax),
                               (TMeanDisp, TVector, _torch)):
            unit = cls(None)
            unit.input, unit.mean, unit.rdisp = vec(), vec(), vec()
            res.append(_np(_apply(unit, {"input": conv(x),
                                         "mean": conv(mean),
                                         "rdisp": conv(rdisp)},
                                  {})["output"]))
        # The same float32 arithmetic, then the same rounding.
        numpy.testing.assert_allclose(res[1], res[0], rtol=1e-6, atol=1e-6)


S2D_CASES = {
    # AlexNet conv1's geometry, cut to 35 px: 11x11 at stride 4.
    "conv1": (dict(n_kernels=6, kx=11, ky=11, sliding=(4, 4),
                   space_to_depth=4), 35),
    "padded": (dict(n_kernels=4, kx=4, ky=4, padding=2, sliding=(2, 2),
                    space_to_depth=2), 16),
}


@pytest.mark.parametrize("level", [1, 0])
@pytest.mark.parametrize("case", sorted(S2D_CASES))
def test_space_to_depth_is_the_strided_conv(precision, case, level):
    """``space_to_depth=f`` computes the strided conv it equals: the
    port's output is its plain conv's bit for bit, and the JAX package's
    folded stride-1 conv within the stated tolerance (forward and
    gradients)."""
    precision(level)
    kw, size = S2D_CASES[case]
    junit, tunit = _units("ConvStrictRelu", **kw)
    rng = numpy.random.RandomState(size)
    x = rng.randn(2, size, size, 3).astype(numpy.float32)
    params = {"weights": (rng.randn(kw["ky"], kw["kx"], 3,
                                    kw["n_kernels"]) * 0.2).astype(
                                        numpy.float32),
              "bias": (rng.randn(kw["n_kernels"]) * 0.1).astype(
                  numpy.float32)}
    y, _ = _check_unit(junit, tunit, x, params, level)
    plain_kw = {k: v for k, v in kw.items() if k != "space_to_depth"}
    _, plain = _units("ConvStrictRelu", **plain_kw)
    tparams = {n: _torch(v) for n, v in params.items()}
    tx = _torch(x).to(torch.bfloat16 if level == 0 else torch.float32)
    folded = _apply(tunit, {"input": tx}, tparams)["output"]
    assert torch.equal(folded, _apply(plain, {"input": tx},
                                      tparams)["output"])
    assert y.shape[1:3] == tunit.output_spatial(size, size)


def test_space_to_depth_refusals_match_jax():
    """The stride mismatch and a fold that does not tile its input raise
    the JAX package's ValueErrors, word for word."""
    msgs = []
    for mod in (jz, tz):
        with pytest.raises(ValueError) as err:
            mod.Conv(None, n_kernels=2, kx=4, sliding=(4, 2),
                     space_to_depth=4)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "must equal both strides" in msgs[1]
    junit, tunit = _units("Conv", n_kernels=2, kx=4, sliding=(2, 2),
                          space_to_depth=2)
    x = numpy.zeros((1, 11, 11, 3), dtype=numpy.float32)
    w = {"weights": numpy.zeros((4, 4, 3, 2), numpy.float32),
         "bias": numpy.zeros(2, numpy.float32)}
    msgs = []
    for unit, conv in ((junit, _jax), (tunit, _torch)):
        with pytest.raises(ValueError) as err:
            _apply(unit, {"input": conv(x)},
                   {n: conv(v) for n, v in w.items()})
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "does not tile input 11x11 with kernel 4x4" in msgs[1]


DECONV_CASES = {
    # tests/test_conv.py's geometry: stride 2, pad 1 over 8x8.
    "s2-pad1": (dict(n_kernels=4, kx=3, ky=3, padding=1, sliding=(2, 2)),
                (8, 8)),
    # Trailing rows and columns no window reaches get zeros.
    "s3-tail": (dict(n_kernels=3, kx=5, ky=5, sliding=(3, 3)), (12, 13)),
    "asym-pad": (dict(n_kernels=2, kx=3, ky=2, padding=(0, 1, 2, 1),
                      sliding=(2, 1)), (9, 10)),
}


def _deconv(mod, vec_cls, kw, x, w):
    conv = mod.Conv(None, **kw)
    conv.input = vec_cls(x)
    conv.initialize(device=None) if mod is tz else conv.initialize()
    deconv = mod.Deconv(None, get_weights_from=conv)
    deconv.input = conv.output
    deconv.initialize(device=None) if mod is tz else deconv.initialize()
    return conv, deconv


def _run_deconv(conv, deconv, y, w):
    out = {}
    ctx = types.SimpleNamespace(training=False, metrics={})
    lookup = {id(deconv.input): y, id(conv.weights): w}
    deconv.tforward(lambda vec: lookup[id(vec)],
                    lambda vec, val: out.__setitem__("y", val), {}, ctx)
    return out["y"]


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconv_against_jax(precision, case):
    """The tied transposed conv: the conv input's geometry, values and
    the gradients (cotangent and tied weights) within f32 1e-5 of the
    JAX package's ``jax.vjp`` form, and equal to the port's own conv
    input gradient."""
    precision(1)
    kw, (h, wd) = DECONV_CASES[case]
    rng = numpy.random.RandomState(h * wd)
    x = rng.randn(2, h, wd, 3).astype(numpy.float32)
    w = (rng.randn(kw["ky"], kw["kx"], 3, kw["n_kernels"]) * 0.3).astype(
        numpy.float32)
    jconv, jdec = _deconv(jz, JVector, kw, x, w)
    tconv, tdec = _deconv(tz, TVector, kw, x, w)
    assert tdec.output.shape == jdec.output.shape == (2, h, wd, 3)
    oh, ow = tconv.output_spatial(h, wd)
    y = rng.randn(2, oh, ow, kw["n_kernels"]).astype(numpy.float32)
    jy, vjp = jax.vjp(lambda a, b: _run_deconv(jconv, jdec, a, b),
                      _jax(y), _jax(w))
    cot = rng.randn(*jy.shape).astype(numpy.float32)
    jgrads = vjp(jnp.asarray(cot))
    ty_in = _torch(y).requires_grad_(True)
    tw = _torch(w).requires_grad_(True)
    ty = _run_deconv(tconv, tdec, ty_in, tw)
    assert tuple(ty.shape) == (2, h, wd, 3)
    _close(_np(ty), _np(jy), 1, "Deconv forward")
    tgrads = torch.autograd.grad(ty, (ty_in, tw), _torch(cot))
    for name, g, want in zip(("dy", "dw"), tgrads, jgrads):
        _close(_np(g), _np(want), 1, "Deconv %s" % name)
    tx = _torch(x).requires_grad_(True)
    fwd = tz.conv.conv2d_nhwc(tx, _torch(w), tconv.sliding, tconv.padding)
    dx = torch.autograd.grad(fwd, tx, _torch(y))[0]
    numpy.testing.assert_allclose(_np(ty), _np(dx), rtol=1e-6, atol=1e-6)


STOCHASTIC_CASES = {
    "2x2-tail": ("StochasticPooling", dict(kx=2, ky=2), (7, 8)),
    "3x2-abs": ("StochasticAbsPooling", dict(kx=3, ky=2), (9, 5)),
}


def _stochastic_input(shape, seed):
    rng = numpy.random.RandomState(seed)
    x = rng.randn(*shape).astype(numpy.float32)
    x[0, :2, :2] = 0.0     # an all-zero window: uniform picks
    return x


@pytest.mark.parametrize("level", [1, 0])
@pytest.mark.parametrize("case", sorted(STOCHASTIC_CASES))
def test_stochastic_pooling_inference(precision, case, level):
    """Inference: the probability-weighted mean (uniform on an all-zero
    window, zeros padding the ragged tail), float32, within f32 1e-5 of
    the JAX package's, forward and input gradient.  Where a window's
    channel holds no positive value the JAX package's gradient is NaN
    (its w / max(tot, 1e-30) differentiates to 0 / 0 through the tiny
    clamp); the port's is finite there and is held to JAX's elsewhere."""
    precision(level)
    name, kw, (h, wd) = STOCHASTIC_CASES[case]
    junit, tunit = _units(name, **kw)
    x = _stochastic_input((2, h, wd, 3), h)
    jx = _jax(x).astype(jnp.bfloat16 if level == 0 else jnp.float32)
    tx = _torch(x).to(torch.bfloat16 if level == 0 else torch.float32)
    jy, vjp = jax.vjp(lambda v: _apply(junit, {"input": v}, {})["output"],
                      jx)
    ty = _apply(tunit, {"input": tx.requires_grad_(True)}, {})["output"]
    assert ty.dtype == torch.float32 and jy.dtype == jnp.float32
    _close(_np(ty), _np(jy), 1, "%s forward" % name)
    assert tuple(ty.shape[1:3]) == tunit.output_spatial(h, wd)
    cot = numpy.random.RandomState(4).randn(*jy.shape).astype(
        numpy.float32)
    jg = _np(vjp(jnp.asarray(cot))[0])
    tg = _np(torch.autograd.grad(ty, tx, _torch(cot))[0])
    assert numpy.isfinite(tg).all()
    nan = numpy.isnan(jg)
    assert not nan.all()
    _close(tg[~nan], jg[~nan], 1, "%s dx" % name)


@pytest.mark.parametrize("case", sorted(STOCHASTIC_CASES))
def test_stochastic_pooling_training_bridge(precision, monkeypatch, case):
    """Training: handed the same Gumbel noise (``jax.random.gumbel`` and
    the port's ``draw_gumbel``), both packages pick the same elements:
    the output and the input gradient are equal bit for bit."""
    precision(1)
    name, kw, (h, wd) = STOCHASTIC_CASES[case]
    junit, tunit = _units(name, **kw)
    x = _stochastic_input((2, h, wd, 3), h + 1)
    oh, ow = tunit.output_spatial(h, wd)
    noise = numpy.random.RandomState(5).gumbel(
        size=(2, oh, ow, kw["kx"] * kw["ky"], 3)).astype(numpy.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape: jnp.asarray(noise))
    monkeypatch.setattr(tunit, "draw_gumbel",
                        lambda ctx, shape, device: _torch(noise))

    def jf(v):
        return _apply(junit, {"input": v}, {}, training=True)["output"]

    jy, vjp = jax.vjp(jf, _jax(x))
    cot = numpy.random.RandomState(6).randn(*jy.shape).astype(
        numpy.float32)
    jg = vjp(jnp.asarray(cot))[0]
    tx = _torch(x).requires_grad_(True)
    ty = _apply(tunit, {"input": tx}, {}, training=True)["output"]
    tg = torch.autograd.grad(ty, tx, _torch(cot))[0]
    assert numpy.array_equal(_np(ty), _np(jy))
    assert numpy.array_equal(_np(tg), _np(jg))


def test_stochastic_pooling_picks_in_proportion():
    """Over seeds, training picks each element of a window with a
    frequency proportional to its activation (here 0.1, 0.2, 0.3, 0.4),
    and uniformly in an all-zero window; the noise comes from the step's
    generator."""
    _, tunit = _units("StochasticPooling", kx=2, ky=2)
    win = numpy.array([[1.0, 2.0], [3.0, 4.0]], dtype=numpy.float32)
    x = numpy.zeros((50, 40, 40, 2), dtype=numpy.float32)
    x[..., 0] = numpy.tile(win, (50, 20, 20))
    for seed in (1, 2, 3):
        gen = torch.Generator().manual_seed(seed)
        ctx = types.SimpleNamespace(training=True, metrics={},
                                    next_key=lambda: gen)
        out = {}
        tunit.input = TVector()
        tunit.tforward(lambda vec: _torch(x),
                       lambda vec, val: out.__setitem__("y", val), {}, ctx)
        y = out["y"].numpy()
        picks = y[..., 0].ravel()
        freq = [float((picks == v).mean()) for v in (1.0, 2.0, 3.0, 4.0)]
        numpy.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.01)
        assert not y[..., 1].any()   # all-zero windows pick a zero
