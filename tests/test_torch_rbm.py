"""The port's pretraining units (``veles_tpu_torch.znicz.rbm`` and
``.kohonen``) and samples against the JAX package's, on the CPU.

* RBM: the hidden probabilities h and the free energy to 1e-6, the CD
  pseudo-loss's gradient given the same hidden samples to 1e-5 (JAX's
  ``jax.random.bernoulli`` is patched, for the test only, to hand back
  the samples the port's ``draw_hidden`` gets; the two packages draw
  from other generators, so a chain is otherwise held statistically);
* ``All2AllDeconv*``: forward and gradients (input, tied weights,
  visible bias) to 1e-5;
* Kohonen: distances and winners to 1e-5 on well-separated inputs
  (where no two distances tie within an ulp), and whole trained epochs
  from carried weights — the SOM's weights and its ``ticks`` state —
  to 1e-5;
* the five gates of ``tests/test_rbm.py`` on the port (the RBM ones
  statistical, as the JAX ones are);
* the port's RBM, autoencoder and Kohonen artifacts load in the JAX
  package's ``ExportedModel`` and match the trained units at
  ``tests/test_export_longtail.py``'s tolerances.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu.prng as jprng
import veles_tpu.znicz.kohonen as jkohonen
import veles_tpu.znicz.rbm as jrbm
from veles_tpu.export import ExportedModel as JExportedModel
from veles_tpu.launcher import Launcher as JLauncher
from veles_tpu.memory import Vector as JVector
from veles_tpu.znicz.samples.kohonen import KohonenWorkflow as \
    JKohonenWorkflow

import veles_tpu_torch.prng as tprng
import veles_tpu_torch.znicz.kohonen as tkohonen
import veles_tpu_torch.znicz.rbm as trbm
from veles_tpu_torch.accelerated_units import params_from_numpy
from veles_tpu_torch.export import export_workflow
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.memory import Vector as TVector
from veles_tpu_torch.znicz.samples.kohonen import KohonenWorkflow
from veles_tpu_torch.znicz.samples.mnist_rbm import (MnistAEWorkflow,
                                                     MnistRBMWorkflow)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, tol, what=""):
    got = numpy.asarray(got, numpy.float64)
    want = numpy.asarray(want, numpy.float64)
    assert got.shape == want.shape, what
    scale = float(numpy.sqrt(numpy.mean(want * want))) + 1e-30
    numpy.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                                  err_msg=what)


def _ctx(training=True, key=None):
    ctx = types.SimpleNamespace(training=training, metrics={}, loss=None,
                                next_key=lambda: key)
    ctx.set_loss = lambda v: setattr(ctx, "loss", v)
    ctx.add_metric = lambda k, v: ctx.metrics.__setitem__(k, v)
    return ctx


def _run(unit, inputs, params, ctx, state=None):
    """``unit.tforward`` over ``inputs`` ({Vector: value}); returns
    ({written Vector id: value}, state update)."""
    bag = {id(v): x for v, x in inputs.items()}
    out = {}

    def write(vec, val):
        out[id(vec)] = val

    upd = unit.tforward(lambda vec: bag[id(vec)], write, params, ctx,
                        state=state)
    return out, upd


# -- RBM -------------------------------------------------------------------

def _rbm_case(seed, cd_k, batch=16, n_vis=20, n_hid=8):
    rng = numpy.random.RandomState(seed)
    v0 = (rng.rand(batch, n_vis) > 0.5).astype(numpy.float32)
    params = {"weights": rng.normal(0, 0.3, (n_vis, n_hid)),
              "vbias": rng.normal(0, 0.1, n_vis),
              "bias": rng.normal(0, 0.1, n_hid)}
    params = {k: v.astype(numpy.float32) for k, v in params.items()}
    mask = numpy.ones(batch, numpy.float32)
    mask[-3:] = 0.0   # a padded tail
    samples = [(rng.rand(batch, n_hid) > 0.5).astype(numpy.float32)
               for _ in range(cd_k)]
    return v0, params, mask, samples


def _jax_rbm(v0, params, mask, samples, cd_k, monkeypatch):
    unit = jrbm.RBM(None, output_sample_shape=(params["bias"].size,),
                    cd_k=cd_k)
    unit.input, unit.mask = JVector(), JVector()

    def loss_and_outputs(p):
        it = iter(samples)
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, prob: jnp.asarray(next(it)) > 0.5)
        ctx = _ctx()
        out, _ = _run(unit, {unit.input: jnp.asarray(v0),
                             unit.mask: jnp.asarray(mask)}, p, ctx)
        return ctx.loss, (out[id(unit.output)],
                          out[id(unit.reconstruction)])

    p = {k: jnp.asarray(v) for k, v in params.items()}
    (loss, (h, vk)), grads = jax.value_and_grad(
        loss_and_outputs, has_aux=True)(p)
    monkeypatch.undo()
    fe = unit._free_energy(jnp.asarray(v0), p["weights"], p["vbias"],
                           p["bias"])
    return loss, h, vk, grads, fe


def _port_rbm(v0, params, mask, samples, cd_k):
    unit = trbm.RBM(None, output_sample_shape=(params["bias"].size,),
                    cd_k=cd_k)
    unit.input, unit.mask = TVector(), TVector()
    it = iter(samples)
    drawn = []

    def draw_hidden(ctx, p):
        drawn.append(p)
        return torch.from_numpy(next(it))

    unit.draw_hidden = draw_hidden
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in params.items()}
    ctx = _ctx()
    out, _ = _run(unit, {unit.input: torch.from_numpy(v0),
                         unit.mask: torch.from_numpy(mask)}, p, ctx)
    grads = dict(zip(p, torch.autograd.grad(ctx.loss, list(p.values()))))
    fe = trbm.RBM.free_energy(torch.from_numpy(v0), p["weights"],
                              p["vbias"], p["bias"])
    assert len(drawn) == cd_k and not any(d.requires_grad for d in drawn)
    return (ctx.loss, out[id(unit.output)], out[id(unit.reconstruction)],
            grads, fe)


@pytest.mark.parametrize("cd_k", [1, 2])
def test_rbm_forward_free_energy_and_cd_gradient(cd_k, monkeypatch):
    v0, params, mask, samples = _rbm_case(cd_k, cd_k)
    jloss, jh, jvk, jgrads, jfe = _jax_rbm(v0, params, mask, samples, cd_k,
                                           monkeypatch)
    tloss, th, tvk, tgrads, tfe = _port_rbm(v0, params, mask, samples, cd_k)
    _close(th.detach(), jh, 1e-6, "h")
    _close(tfe.detach(), jfe, 1e-6, "free energy")
    _close(tvk, jvk, 1e-6, "reconstruction")
    _close(tloss.detach(), jloss, 1e-5, "loss")
    for name in params:
        _close(tgrads[name], jgrads[name], 1e-5, name)


def test_rbm_cd_gradient_matches_statistics():
    """The port's autograd of the free-energy difference equals the
    CD-1 statistics v0ᵀh0 − v1ᵀh1 (``tests/test_rbm.py``'s first gate,
    with the port's own sampling)."""
    rng = numpy.random.RandomState(0)
    v0 = torch.from_numpy((rng.rand(16, 20) > 0.5).astype(numpy.float32))
    w = torch.from_numpy(rng.normal(0, 0.1, (20, 8)).astype(
        numpy.float32)).requires_grad_(True)
    b, c = torch.zeros(20), torch.zeros(8)
    unit = trbm.RBM(None, output_sample_shape=(8,))
    unit.input = TVector()
    gen = torch.Generator().manual_seed(3)
    ctx = _ctx(key=gen)
    out, _ = _run(unit, {unit.input: v0},
                  {"weights": w, "vbias": b, "bias": c}, ctx)
    gw, = torch.autograd.grad(ctx.loss, [w])
    h0 = out[id(unit.output)].detach()
    v1 = out[id(unit.reconstruction)]
    h1 = torch.sigmoid(v1 @ w.detach() + c)
    want = -(v0.T @ h0 - v1.T @ h1) / 16.0
    numpy.testing.assert_allclose(gw.numpy(), want.numpy(), rtol=1e-4,
                                  atol=1e-5)


def test_rbm_hidden_samples_follow_the_probabilities():
    """The port's draws are Bernoulli(p): over many draws each unit's
    mean approaches p (the statistical half of the parity)."""
    p = torch.linspace(0.05, 0.95, 10).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    unit = trbm.RBM(None, output_sample_shape=(10,))
    hs = unit.draw_hidden(_ctx(key=gen), p)
    assert hs.dtype == torch.float32
    assert set(hs.unique().tolist()) == {0.0, 1.0}
    numpy.testing.assert_allclose(hs.mean(0).numpy(), p[0].numpy(),
                                  atol=0.03)


# -- All2AllDeconv ---------------------------------------------------------

@pytest.mark.parametrize("name", ["All2AllDeconv", "All2AllDeconvSigmoid",
                                  "All2AllDeconvTanh"])
def test_deconv_forward_and_gradients(name):
    rng = numpy.random.RandomState(4)
    x = rng.normal(0, 1, (6, 5)).astype(numpy.float32)
    w = rng.normal(0, 0.4, (12, 5)).astype(numpy.float32)
    vb = rng.normal(0, 0.1, 12).astype(numpy.float32)
    cot = rng.normal(0, 1, (6, 12)).astype(numpy.float32)
    results = []
    for mod, vec, arr in ((jrbm, JVector, jnp.asarray),
                          (trbm, TVector, torch.from_numpy)):
        enc = types.SimpleNamespace(weights=vec(), name="enc",
                                    is_initialized=True)
        unit = getattr(mod, name)(None, get_weights_from=enc)
        unit.input = vec()

        def out_of(x_, w_, vb_):
            out, _ = _run(unit, {unit.input: x_, enc.weights: w_},
                          {"vbias": vb_}, _ctx())
            return out[id(unit.output)]

        if mod is jrbm:
            y, vjp = jax.vjp(out_of, arr(x), arr(w), arr(vb))
            grads = vjp(arr(cot))
        else:
            leaves = [arr(a.copy()).requires_grad_(True)
                      for a in (x, w, vb)]
            y = out_of(*leaves)
            grads = torch.autograd.grad(y, leaves, arr(cot))
            y = y.detach()
        results.append((y, grads))
    (jy, jg), (ty, tg) = results
    _close(ty, jy, 1e-5, "output")
    for what, a, b in zip(("x", "tied weights", "vbias"), tg, jg):
        _close(a, b, 1e-5, what)


# -- Kohonen ---------------------------------------------------------------

def _separated(rng, n, d, n_neurons):
    """Samples each near one neuron, far from the rest: no two distances
    tie within an ulp."""
    w = rng.normal(0, 1, (n_neurons, d)).astype(numpy.float32) * 3.0
    pick = rng.randint(0, n_neurons, n)
    x = (w[pick] + rng.normal(0, 0.05, (n, d))).astype(numpy.float32)
    return x, w, pick


def test_kohonen_distances_and_winners():
    rng = numpy.random.RandomState(5)
    x, w, pick = _separated(rng, 24, 6, 9)
    outs = []
    for mod, vec, arr in ((jkohonen, JVector, jnp.asarray),
                          (tkohonen, TVector, torch.from_numpy)):
        unit = mod.KohonenForward(None, shape=(3, 3))
        unit.input = vec()
        out, _ = _run(unit, {unit.input: arr(x)}, {"weights": arr(w)},
                      _ctx(training=False))
        outs.append((numpy.asarray(out[id(unit.output)]),
                     numpy.asarray(out[id(unit.winners)])))
    (jd, jw), (td, tw) = outs
    _close(td, jd, 1e-5, "distances")
    assert tw.dtype == jw.dtype == numpy.int32
    numpy.testing.assert_array_equal(tw, jw)
    numpy.testing.assert_array_equal(tw, pick)


@pytest.mark.parametrize("training", [True, False])
def test_kohonen_trainer_loss_gradient_and_ticks(training):
    rng = numpy.random.RandomState(6)
    x, w, _ = _separated(rng, 20, 3, 16)
    mask = numpy.ones(20, numpy.float32)
    mask[-4:] = 0.0
    ticks = numpy.float32(7.0)
    res = []
    for mod, vec, arr in ((jkohonen, JVector, jnp.asarray),
                          (tkohonen, TVector, torch.from_numpy)):
        fwd = mod.KohonenForward(None, shape=(4, 4))
        fwd.weights = vec()
        trainer = mod.KohonenTrainer(None, forward=fwd, sigma_decay=0.93)
        trainer.input, trainer.mask = vec(), vec()
        gy, gx = fwd.shape
        yy, xx = numpy.mgrid[0:gy, 0:gx]
        trainer._grid = numpy.stack(
            [yy.ravel(), xx.ravel()]).T.astype(numpy.float32)

        def loss_of(w_):
            ctx = _ctx(training=training)
            _, upd = _run(trainer, {trainer.input: arr(x),
                                    trainer.mask: arr(mask),
                                    fwd.weights: w_}, {}, ctx,
                          state={"ticks": arr(numpy.array(ticks))})
            return ctx.loss, (upd["ticks"], ctx.metrics["som_quant_err"])

        if mod is jkohonen:
            (loss, (t, qe)), g = jax.value_and_grad(
                loss_of, has_aux=True)(arr(w))
        else:
            leaf = arr(w.copy()).requires_grad_(True)
            loss, (t, qe) = loss_of(leaf)
            g, = torch.autograd.grad(loss, [leaf])
            loss, qe = loss.detach(), qe.detach()
        res.append((loss, t, qe, g))
    (jl, jt, jq, jg), (tl, tt, tq, tg) = res
    _close(tl, jl, 1e-5, "loss")
    _close(tq, jq, 1e-5, "som_quant_err")
    _close(tg, jg, 1e-5, "gradient")
    assert float(tt) == float(jt) == ticks + (1.0 if training else 0.0)


def _som_pair(epochs, shape=(4, 4), seed=5):
    """The Kohonen sample in both packages, the port's weights carried
    from the JAX package's, trained ``epochs`` epochs each."""
    wfs = []
    for prng, launcher_cls, cls in ((jprng, JLauncher, JKohonenWorkflow),
                                    (tprng, Launcher, KohonenWorkflow)):
        prng.reset()
        prng.get(0).seed(seed)
        launcher = launcher_cls()
        wf = cls(launcher, shape=shape, max_epochs=epochs,
                 sigma_decay=0.93)
        if cls is KohonenWorkflow:
            launcher.initialize(device="cpu")
            jwf = wfs[0]
            jwf.som.weights.map_read()
            params_from_numpy(wf, {wf.som.name: {
                "weights": numpy.array(jwf.som.weights.mem0)}})
        else:
            launcher.initialize()
            wf.som.weights.map_read()
            wf.som.weights.mem0 = numpy.array(wf.som.weights.mem)
        launcher.run()
        wfs.append(wf)
    return wfs


def test_kohonen_trained_epochs_from_carried_weights():
    jwf, twf = _som_pair(3)
    for wf in (jwf, twf):
        wf.som.weights.map_read()
        wf.trainer.ticks.map_read()
    # 400 points in minibatches of 50: 8 trained ticks an epoch.
    assert twf.trainer.ticks.mem.tolist() == \
        jwf.trainer.ticks.mem.tolist() == [24.0]
    _close(twf.som.weights.mem, jwf.som.weights.mem, 1e-5, "weights")
    assert twf.quantization_error() == pytest.approx(
        jwf.quantization_error(), rel=1e-5)


def test_kohonen_state_carries_across():
    """``params_from_numpy`` carries the SOM weights and the trainer's
    ``ticks`` state with no special case."""
    tprng.reset()
    tprng.get(0).seed(1)
    launcher = Launcher()
    wf = KohonenWorkflow(launcher, shape=(3, 3), max_epochs=1)
    launcher.initialize(device="cpu")
    w = numpy.full((9, 2), 0.25, numpy.float32)
    params_from_numpy(wf, {wf.som.name: {"weights": w},
                           wf.trainer.name: {"ticks": numpy.full(
                               wf.trainer.ticks.shape, 40, numpy.float32)}})
    launcher.run()
    wf.trainer.ticks.map_read()
    assert wf.trainer.ticks.mem.tolist() == [48.0]


@pytest.mark.parametrize("kind", ["rbm", "ae"])
def test_pretraining_parameters_carry_across(kind):
    """The same seed gives bit-equal initial parameters in both
    packages' RBM and autoencoder workflows, and ``params_from_numpy``
    carries the JAX package's trainables and optimizer slots (the RBM's
    visible bias, the decoder's tied-weight vbias) with no special
    case."""
    from veles_tpu.znicz.samples.mnist_rbm import (
        MnistAEWorkflow as JAE, MnistRBMWorkflow as JRBM)
    cls = {"rbm": (JRBM, MnistRBMWorkflow), "ae": (JAE, MnistAEWorkflow)}
    wfs = []
    for prng, launcher_cls, wf_cls, kw in (
            (jprng, JLauncher, cls[kind][0], {}),
            (tprng, Launcher, cls[kind][1], {"device": "cpu"})):
        prng.reset()
        prng.get(0).seed(21)
        launcher = launcher_cls()
        wf = wf_cls(launcher, n_hidden=16, max_epochs=1)
        launcher.initialize(**kw)
        wfs.append(wf)
    jwf, twf = wfs

    def arrays(wf, which):
        out = {}
        for u in wf.units:
            vecs = getattr(u, which, None)
            if isinstance(vecs, dict) and vecs:
                out[u.name] = {}
                for attr, vec in vecs.items():
                    vec.map_read()
                    out[u.name][attr] = numpy.array(vec.mem)
        return out

    want = arrays(jwf, "trainables")
    got = arrays(twf, "trainables")
    assert sorted(want) == sorted(got)
    for unit, attrs in want.items():
        assert sorted(attrs) == sorted(got[unit])
        for attr, arr in attrs.items():
            numpy.testing.assert_array_equal(got[unit][attr], arr)
    rng = numpy.random.RandomState(2)
    moved = {u: {a: rng.normal(0, 1, v.shape).astype(numpy.float32)
                 for a, v in attrs.items()} for u, attrs in want.items()}
    slots = {u: {a: v + 1.0 for a, v in attrs.items()}
             for u, attrs in arrays(jwf, "tstate").items()
             if u.startswith("GD")}
    assert slots
    params_from_numpy(twf, moved)
    params_from_numpy(twf, slots)
    for unit, attrs in moved.items():
        for attr, arr in attrs.items():
            numpy.testing.assert_array_equal(
                arrays(twf, "trainables")[unit][attr], arr)
    for unit, attrs in slots.items():
        for attr, arr in attrs.items():
            numpy.testing.assert_array_equal(
                arrays(twf, "tstate")[unit][attr], arr)


# -- the gates of tests/test_rbm.py ------------------------------------------

@pytest.fixture(scope="module")
def rbm_trained():
    tprng.reset()
    tprng.get(0).seed(9)
    launcher = Launcher()
    wf = MnistRBMWorkflow(launcher, n_hidden=64, max_epochs=4,
                          learning_rate=0.1)
    launcher.initialize(device="cpu")
    launcher.run()
    return wf


def test_rbm_reconstruction_improves(rbm_trained):
    per_px = rbm_trained.decision.epoch_loss[VALID] / 784.0
    assert per_px < 0.08, per_px
    # The step kept the reconstruction, as the JAX package's persisted
    # outputs are.
    rbm_trained.rbm.reconstruction.map_read()
    assert numpy.isfinite(rbm_trained.rbm.reconstruction.mem).all()
    assert rbm_trained.rbm.reconstruction.mem.std() > 0


def test_ae_tied_weights_train():
    tprng.reset()
    tprng.get(0).seed(10)
    launcher = Launcher()
    wf = MnistAEWorkflow(launcher, n_hidden=64, max_epochs=4)
    launcher.initialize(device="cpu")
    w0 = numpy.array(wf.encoder.weights.mem)
    launcher.run()
    wf.encoder.weights.map_read()
    assert numpy.abs(wf.encoder.weights.mem - w0).max() > 1e-3
    per_px = wf.decision.epoch_loss[VALID] / 784.0
    assert per_px < 0.05, per_px


def test_kohonen_som_organizes():
    twf = _som_pair(12)[1]
    twf.som.weights.map_read()
    w = twf.som.weights.mem
    centers = numpy.random.RandomState(0).rand(4, 2).astype(numpy.float32)
    for c in centers:
        assert numpy.sqrt(((w - c) ** 2).sum(1)).min() < 0.15


def test_kohonen_sample_workflow_cli():
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.config import root
    sample = os.path.join(ROOT, "veles_tpu_torch", "znicz", "samples",
                          "kohonen.py")
    tprng.reset()
    try:
        m = Main([sample, "root.kohonen.max_epochs=12", "--random-seed",
                  "5", "--device", "cpu", "-v", "warning"])
        assert m.run() == 0
        wf = m.workflow
        assert wf.decision.epoch_number == 12
        assert wf.quantization_error() < 0.1
        u = wf.umatrix()
        assert u.shape == (8, 8) and numpy.isfinite(u).all()
        wf.som.winners.map_read()
        assert wf.som.winners.mem.dtype == numpy.int32
    finally:
        root.kohonen.reset()


# -- artifacts in the JAX package's runtime -----------------------------------

def _sigmoid(v):
    return 1.0 / (1.0 + numpy.exp(-v))


@pytest.mark.parametrize("kind", ["rbm", "ae", "som"])
def test_port_artifacts_load_in_the_jax_runtime(kind, tmp_path):
    tprng.reset()
    tprng.get(0).seed({"rbm": 77, "ae": 78, "som": 79}[kind])
    launcher = Launcher()
    if kind == "rbm":
        wf = MnistRBMWorkflow(launcher, n_hidden=32, max_epochs=1,
                              learning_rate=0.1)
    elif kind == "ae":
        wf = MnistAEWorkflow(launcher, n_hidden=32, max_epochs=1,
                             learning_rate=0.1)
    else:
        wf = KohonenWorkflow(launcher, shape=(4, 4), max_epochs=2)
    launcher.initialize(device="cpu")
    launcher.run()
    path = str(tmp_path / ("%s.veles.tgz" % kind))
    export_workflow(wf, path)
    model = JExportedModel(path)
    rng = numpy.random.RandomState(0)
    if kind == "rbm":
        assert [u["type"] for u in model.units] == ["rbm"]
        wf.rbm.weights.map_read()
        wf.rbm.bias.map_read()
        w, c = wf.rbm.weights.mem, wf.rbm.bias.mem
        x = rng.rand(8, w.shape[0]).astype(numpy.float32)
        want = _sigmoid(x @ w + c)
        numpy.testing.assert_allclose(model.forward_numpy(x), want,
                                      rtol=1e-4, atol=1e-5)
        numpy.testing.assert_allclose(model.forward(x), want,
                                      rtol=1e-3, atol=1e-4)
    elif kind == "ae":
        assert [u["type"] for u in model.units] == \
            ["all2all_sigmoid", "all2all_deconv_sigmoid"]
        for vec in (wf.encoder.weights, wf.encoder.bias, wf.decoder.vbias):
            vec.map_read()
        w, c = wf.encoder.weights.mem, wf.encoder.bias.mem
        x = rng.rand(8, w.shape[0]).astype(numpy.float32)
        want = _sigmoid(_sigmoid(x @ w + c) @ w.T + wf.decoder.vbias.mem)
        numpy.testing.assert_allclose(model.forward_numpy(x), want,
                                      rtol=1e-4, atol=1e-5)
    else:
        assert [u["type"] for u in model.units] == ["kohonen"]
        wf.som.weights.map_read()
        w = wf.som.weights.mem
        x = rng.rand(32, w.shape[1]).astype(numpy.float32)
        want = ((x * x).sum(1, keepdims=True) - 2.0 * (x @ w.T) +
                (w * w).sum(1))
        got = model.forward_numpy(x)
        numpy.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
        assert (numpy.argmin(got, 1) == numpy.argmin(want, 1)).all()
