"""The port's population step and engine (``StepCompiler.
compile_population``, ``veles_tpu_torch.population``) against the JAX
package's, on the CPU.

* A tiny AlexNet (``tests/test_torch_alexnet.py``'s stack: conv, LRN at
  AlexNet's constants and at constants where the window dominates,
  max-pool, FC, dropout, softmax; 32 px, 10 classes, minibatch 16) runs
  a validation block and a train block of two ticks as a population of
  P = 3 members with per-member learning rates and momenta, the LRN
  through its plain version under ``torch.func.vmap``.  Both packages'
  populations start from the same member states: the JAX package's
  ``population_arrays``, each member but the first moved by its own
  seeded noise, carried into the port by ``population_from_numpy``.
  Dropout masks are handed to both packages: fixed seeded masks by shape
  (``jax.random.bernoulli`` and ``DropoutForward.draw_mask`` patched in
  the test only).  Held, in float32 (``precision_level`` 1):
  - the port's vmapped members against JAX's ``compile_population``
    step: each parameter's gap (norm) within 1e-4 of the norm of its
    change plus 1e-7 (the tolerance of ``test_torch_alexnet.py``'s f32
    ticks), and the epoch accumulators within rtol 1e-5;
  - the port's vmapped members against the same member run alone
    through the sequential tick with the member's hyperparameters
    (``execute_block(..., hypers=...)``, the ``_hyper_program`` path):
    gap within 1e-5 of the change plus 1e-7 — the vmapped products batch
    the members (a grouped convolution, a batched matrix product) and
    may sum in another order.
* The engine: the vmap backend's gating, the automatic mode, GA over
  the vmap backend through ``--population 4:2`` (and the same argv in
  the JAX package: the same best member's genes and fitness), the
  topology refusal both packages share, and ``--population-vmap off``
  forcing fleet lineages.

Every test restores both packages' ``root`` trees."""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu.prng as jprng
from veles_tpu.config import root as jroot
from veles_tpu.launcher import Launcher as JLauncher
from veles_tpu.znicz.samples.imagenet import AlexNetWorkflow as JAlexNet

from veles_tpu_torch import prng as tprng
from veles_tpu_torch import resilience
from veles_tpu_torch.__main__ import Main, import_workflow_module
from veles_tpu_torch.accelerated_units import population_from_numpy
from veles_tpu_torch.config import Tune, root as troot
from veles_tpu_torch.error import Bug
from veles_tpu_torch.genetics.core import collect_tunes
from veles_tpu_torch.launcher import Launcher as TLauncher
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.population import PopulationEngine
from veles_tpu_torch.population.vmap_backend import VmapSubPopulation
from veles_tpu_torch.znicz.dropout import DropoutForward
from veles_tpu_torch.znicz.samples.imagenet import AlexNetWorkflow as \
    TAlexNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TMNIST = os.path.join(REPO, "veles_tpu_torch", "znicz", "samples",
                      "mnist.py")
JMNIST = os.path.join(REPO, "veles_tpu", "znicz", "samples", "mnist.py")

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
NAMES = ("gradient_moment", "learning_rate")
#: Per member: (gradient_moment, learning_rate).
GENES = numpy.array([[0.9, 0.02], [0.5, 0.05], [0.0, 0.01]],
                    dtype=numpy.float32)
BLOCK = 2


def _config_nodes(node):
    out = [(node, dict(node.__dict__))]
    for _, value in node.items():
        if isinstance(value, type(node)):
            out.extend(_config_nodes(value))
    return out


#: No dataset directory: both MNIST samples take scikit-learn's digits.
NO_DATASETS = "/nonexistent/veles-datasets"


def _clean_slate():
    """The knobs these tests read, set alike in both trees whatever an
    earlier test file left there: no ``root.mnist`` settings, no
    snapshot, guardian or population settings, the default precision,
    optimizer and loader, and no dataset directory."""
    for r in (jroot, troot):
        r.mnist.reset()
        r.ga_test.reset()
        for key in ("snapshotter", "guardian", "snapshot_disabled",
                    "genetics", "population"):
            r.common.__dict__.pop(key, None)
        r.common.engine.__dict__.pop("optimizer", None)
        r.common.engine.precision_level = 0
        r.common.loader.train_ratio = 1.0
        r.common.loader.shuffle_limit = -1
    troot.common.__dict__.pop("dirs", None)
    for r in (jroot, troot):
        r.common.dirs.datasets = NO_DATASETS


@pytest.fixture(autouse=True)
def _kept_roots():
    """Both packages' whole config trees, the port's generators and the
    resilience counters, put back after the test, which starts from
    ``_clean_slate``; at most two intra-op threads during it (the suite
    runs files in parallel workers)."""
    saved = _config_nodes(jroot) + _config_nodes(troot)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    _clean_slate()
    tprng.reset()
    resilience.reset()
    yield
    torch.set_num_threads(threads)
    for node, state in saved:
        node.__dict__.clear()
        node.__dict__.update(state)
    tprng.reset()
    resilience.reset()


@pytest.fixture
def fixed_masks(monkeypatch):
    """The same seeded keep masks, by shape, for both packages' dropout
    draws."""
    masks = {}

    def mask(shape, keep):
        if tuple(shape) not in masks:
            rng = numpy.random.RandomState(sum(shape))
            masks[tuple(shape)] = rng.random_sample(shape) < keep
        return masks[tuple(shape)]

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask(shape, p)))
    monkeypatch.setattr(
        DropoutForward, "draw_mask",
        lambda self, ctx, shape, keep, device: torch.from_numpy(
            mask(tuple(shape), keep)))
    return masks


def _build_alexnet(seed=77):
    for r in (jroot, troot):
        r.common.engine.precision_level = 1
    tprng.reset()
    tprng.get(0).seed(seed)
    tl = TLauncher()
    twf = TAlexNet(tl, **ALEXNET)
    tl.initialize(device="cpu")
    jprng.reset()
    jprng.get(0).seed(seed)
    jl = JLauncher()
    jwf = JAlexNet(jl, **ALEXNET)
    jl.initialize()
    return jwf, twf


def _member_noise(arrays):
    """Each member but the first moved by its own seeded noise (1 % of
    the tensor's scale), so the members differ before the run."""
    rng = numpy.random.RandomState(5)
    out = {}
    for key, arr in sorted(arrays.items()):
        arr = numpy.array(arr)
        if arr.dtype.kind == "f" and arr.ndim > 1:
            scale = 0.01 * (numpy.abs(arr[0]).max() or 1.0)
            noise = rng.standard_normal(arr.shape).astype(arr.dtype)
            noise[0] = 0.0
            arr = arr + scale * noise
        out[key] = arr
    return out


def _by_unit(flat):
    nested = {}
    for key, arr in flat.items():
        unit, attr = key.split("/", 1)
        nested.setdefault(unit, {})[attr] = arr
    return nested


def _blocks(loader, ticks):
    blocks = loader.serve_block(ticks)
    by_role = {role: blocks[str(id(getattr(loader, role)))] for role in (
        "minibatch_indices", "minibatch_mask", "minibatch_class_vec")}
    return blocks, by_role, int(loader.minibatch_class)


def _gate(got, want, init, change, label):
    for name, arr in want.items():
        gap = numpy.linalg.norm(numpy.asarray(got[name], numpy.float64) -
                                arr)
        bound = change * numpy.linalg.norm(arr - init[name]) + 1e-7
        assert gap <= bound, "%s %s: gap %.3g > %.3g" % (label, name, gap,
                                                         bound)


def test_alexnet_population_block_matches_jax_and_sequential(fixed_masks):
    jwf, twf = _build_alexnet()
    jc, tc = jwf.compiler, twf.compiler
    jc.compile_population(NAMES)
    tc.compile_population(NAMES)
    jparams, jstates = jc.population_arrays(len(GENES))
    start_p = _member_noise(jax.device_get(jparams))
    start_s = {k: numpy.array(v) for k, v in
               jax.device_get(jstates).items()}
    tparams, tstates = population_from_numpy(
        twf, _by_unit(dict(start_p, **start_s)))
    for key, arr in start_p.items():
        assert numpy.array_equal(tparams[key].numpy(), arr), key
    jparams = {k: jnp.asarray(v) for k, v in start_p.items()}
    jstates = {k: jnp.asarray(v) for k, v in start_s.items()}
    jconsts = {str(id(v)): v.devmem for v in jc.const_vectors}
    tconsts = {str(id(v)): v.devmem for v in tc.const_vectors}
    gen = tc._generator()
    hypers = torch.from_numpy(GENES)
    walked = []
    for _ in range(3):  # the validation block, then two train blocks
        jb, jroles, jcls = _blocks(jwf.loader, BLOCK)
        tb, troles, tcls = _blocks(twf.loader, BLOCK)
        assert jcls == tcls
        for role in jroles:
            assert numpy.array_equal(jroles[role], troles[role]), role
        walked.append((tb, tcls))
        flag = jnp.float32(1.0 if jcls == TRAIN else 0.0)
        jparams, jstates = jc._pop_block(
            jparams, jstates, {k: jnp.asarray(v) for k, v in jb.items()},
            jconsts, jprng.get().jax_key(), flag, jnp.asarray(GENES))
        tparams, tstates = tc._pop_block(tparams, tstates, tb, tconsts,
                                         gen, tcls == TRAIN, hypers)
    assert [c for _, c in walked] == [VALID, TRAIN, TRAIN]
    want_p = {k: numpy.array(v) for k, v in jax.device_get(jparams).items()}
    got_p = {k: v.numpy() for k, v in tparams.items()}
    assert sorted(want_p) == sorted(got_p)
    for i in range(len(GENES)):
        init = {k: v[i] for k, v in start_p.items()}
        _gate({k: v[i] for k, v in got_p.items()},
              {k: v[i] for k, v in want_p.items()}, init, 1e-4,
              "member %d vs JAX" % i)
    acc = [n for n in jstates if n.endswith("/epoch_acc")]
    assert acc
    for name in acc:
        numpy.testing.assert_allclose(
            tstates[name].numpy(), numpy.array(jax.device_get(
                jstates[name])), rtol=1e-5, atol=1e-5, err_msg=name)
    # Each member alone through the sequential tick, its genes as
    # hypers, from the same start and over the same blocks.
    for i, genes in enumerate(GENES):
        for key, vec in tc._param_vecs.items():
            vec.devmem = torch.from_numpy(start_p[key][i].copy())
        for key, vec in tc._state_vecs.items():
            vec.devmem = torch.from_numpy(start_s[key][i].copy())
        for blocks, cls in walked:
            tc.execute_block(blocks, cls == TRAIN,
                             hypers=dict(zip(NAMES, map(float, genes))))
        alone = {k: v.devmem.numpy() for k, v in tc._param_vecs.items()}
        _gate({k: v[i] for k, v in got_p.items()}, alone,
              {k: v[i] for k, v in start_p.items()}, 1e-5,
              "member %d vs alone" % i)
        for name in acc:
            numpy.testing.assert_allclose(
                tstates[name][i].numpy(),
                tc._state_vecs[name].devmem.numpy(), rtol=1e-6,
                atol=1e-6)
    # The members' learning rates and momenta made them differ.
    w = got_p["conv_str0/weights"]
    assert not numpy.allclose(w[1] - start_p["conv_str0/weights"][1],
                              w[2] - start_p["conv_str0/weights"][2])


def test_hypers_none_leaves_the_sequential_tick_as_it_was(fixed_masks):
    """A tick with ``hypers`` equal to the units' own values computes
    what the plain tick computes (tensor hypers vs Python floats), and a
    tick without ``hypers`` takes the plain path."""
    _, twf = _build_alexnet()
    tc = twf.compiler
    tc.compile()
    twf.loader.serve_block(BLOCK)  # past the validation block
    blocks = twf.loader.serve_block(BLOCK)
    start = {k: v.devmem.clone() for k, v in tc._param_vecs.items()}
    start_s = {k: v.devmem.clone() for k, v in tc._state_vecs.items()}
    tc.execute_block(blocks, True)
    plain = {k: v.devmem.clone() for k, v in tc._param_vecs.items()}
    for key, vec in tc._param_vecs.items():
        vec.devmem = start[key].clone()
    for key, vec in tc._state_vecs.items():
        vec.devmem = start_s[key].clone()
    tc.execute_block(blocks, True, hypers={"learning_rate": 0.02,
                                           "gradient_moment": 0.9})
    for key, vec in tc._param_vecs.items():
        torch.testing.assert_close(vec.devmem, plain[key], rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("remat", [False, True])
def test_tinylm_population_equals_members_alone(remat):
    """A 2-block TinyLM population (P = 2, tuned learning rates) through
    the validation blocks and two train blocks: each member equals the
    member run alone through the sequential tick (within 1e-6 of its
    change; the CPU reads 0).  With remat on, the sequential tick
    rematerializes its blocks and the population step does not
    (``torch.utils.checkpoint`` does not compose with
    ``torch.func.grad``): the same values."""
    from veles_tpu_torch.znicz.samples.tinylm import TinyLMWorkflow
    troot.common.engine.remat = remat
    troot.common.engine.precision_level = 1
    tprng.reset()
    tprng.get(0).seed(42)
    launcher = TLauncher()
    wf = TinyLMWorkflow(launcher, vocab_size=32, seq_len=16, embed_dim=32,
                        n_heads=4, n_blocks=2, minibatch_size=4,
                        max_epochs=1)
    launcher.initialize(device="cpu")
    tc = wf.compiler
    tc.compile_population(("learning_rate",))
    genes = numpy.array([[0.01], [0.05]], dtype=numpy.float32)
    params, states = tc.population_arrays(2)
    start_p = {k: v.clone() for k, v in params.items()}
    start_s = {k: v.clone() for k, v in states.items()}
    consts = {str(id(v)): v.devmem for v in tc.const_vectors}
    walked = []
    while sum(cls == TRAIN for _, cls in walked) < 2:
        blocks = wf.loader.serve_block(2)
        cls = int(wf.loader.minibatch_class)
        walked.append((blocks, cls))
        params, states = tc._pop_block(params, states, blocks, consts,
                                       tc._generator(), cls == TRAIN,
                                       torch.from_numpy(genes))
    for i in range(2):
        for key, vec in tc._param_vecs.items():
            vec.devmem = start_p[key][i].clone()
        for key, vec in tc._state_vecs.items():
            vec.devmem = start_s[key][i].clone()
        for blocks, cls in walked:
            tc.execute_block(blocks, cls == TRAIN,
                             hypers={"learning_rate": float(genes[i, 0])})
        for key, vec in tc._param_vecs.items():
            gap = (vec.devmem - params[key][i]).norm()
            change = (vec.devmem - start_p[key][i]).norm()
            assert gap <= 1e-6 * change + 1e-9, (i, key)
    assert not torch.equal(params["block0/wq"][0], params["block0/wq"][1])


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "lion"])
def test_traced_optimizer_rules_match_jax(name):
    """Every optimizer's ``traced=True`` rule (tensor hyperparameters, the
    population step's) against the JAX package's on the same numpy
    inputs, float32: rtol 1e-6; and the traced rule at the untraced
    values equals the untraced rule (rtol 1e-6)."""
    from veles_tpu.znicz import optimizers as jopt
    from veles_tpu_torch.znicz import optimizers as topt
    rng = numpy.random.RandomState(3)
    param, grad = (rng.standard_normal((6, 5)).astype(numpy.float32)
                   for _ in range(2))
    hyper = {"learning_rate": 0.05, "weights_decay": 0.01,
             "gradient_moment": 0.8, "beta1": 0.85, "beta2": 0.99,
             "eps": 1e-6}

    class GD(object):
        gradient_moment, gradient_moment_bias = 0.8, 0.8
    def slot_value(slot, shape):
        """A step count of 3; moments of either sign, but a second
        moment (adam_v_), a running mean of squares, positive."""
        if shape == ():
            return numpy.float32(3.0)
        v = rng.standard_normal(shape).astype(numpy.float32) * 0.1
        return numpy.abs(v) if slot.startswith("adam_v_") else v
    slots = {s: slot_value(s, shape)
             for s, shape, _ in topt.get(name).slots(
                 "weights", SimpleNamespace(shape=(6, 5),
                                            dtype=numpy.float32), GD())}
    t_param, t_slots = topt.get(name).update(
        "weights", torch.from_numpy(param), torch.from_numpy(grad),
        {k: torch.tensor(v) for k, v in slots.items()},
        {k: torch.tensor(v, dtype=torch.float32) for k, v in hyper.items()},
        traced=True)
    j_param, j_slots = jopt.get(name).update(
        "weights", jnp.asarray(param), jnp.asarray(grad),
        {k: jnp.asarray(v) for k, v in slots.items()},
        {k: jnp.float32(v) for k, v in hyper.items()}, traced=True)
    numpy.testing.assert_allclose(t_param.numpy(), numpy.asarray(j_param),
                                  rtol=1e-6, atol=1e-7)
    assert sorted(t_slots) == sorted(j_slots)
    for k in t_slots:
        numpy.testing.assert_allclose(t_slots[k].numpy(),
                                      numpy.asarray(j_slots[k]),
                                      rtol=1e-6, atol=1e-7)
    plain, _ = topt.get(name).update(
        "weights", torch.from_numpy(param), torch.from_numpy(grad),
        {k: torch.tensor(v) for k, v in slots.items()}, hyper)
    torch.testing.assert_close(t_param, plain, rtol=1e-6, atol=1e-7)


def test_bias_hypers_follow_the_jax_ties():
    """A tensor override of a plain hyper reaches the bias trio only
    where the bias value was left tied at construction; ``_bias``
    overrides reach it always; weights_decay_bias never ties."""
    from veles_tpu.znicz.nn_units import GradientDescentBase as JGD
    from veles_tpu_torch.znicz.nn_units import GradientDescentBase as TGD
    hypers = {"learning_rate": 0.5, "gradient_moment": 0.25,
              "weights_decay": 0.125}
    for kwargs in ({}, {"learning_rate_bias": 0.01},
                   {"gradient_moment_bias": 0.9, "learning_rate": 0.02}):
        units = [cls.__new__(cls) for cls in (JGD, TGD)]
        for unit, cls in zip(units, (JGD, TGD)):
            unit.learning_rate = kwargs.get("learning_rate", 0.01)
            unit.learning_rate_bias = kwargs.get("learning_rate_bias",
                                                 unit.learning_rate)
            unit.weights_decay, unit.weights_decay_bias = 0.0005, 0.0
            unit.gradient_moment = 0.9
            unit.gradient_moment_bias = kwargs.get(
                "gradient_moment_bias", 0.9)
            unit._bias_tied = {
                "learning_rate": "learning_rate_bias" not in kwargs,
                "gradient_moment": "gradient_moment_bias" not in kwargs}
        for attr in ("weights", "bias"):
            for h in (None, hypers, {"learning_rate_bias": 0.75}):
                assert units[1]._hyper(attr, h) == \
                    units[0]._hyper(attr, h), (kwargs, attr, h)


def test_non_finite_member_is_gated_alone():
    """The health row and the non-finite gate are per member: a member
    whose learning rate blows its weights up (its first update lands,
    its gradients are finite) records non-finite ticks after it and has
    those updates dropped, while its sibling's ticks stay finite and
    equal the sibling run alone (MNIST FC, float32; each parameter's gap
    within 1e-5 of its change, the health row within rtol 1e-5)."""
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    troot.common.engine.precision_level = 1
    tprng.reset()
    tprng.get(0).seed(3)
    launcher = TLauncher()
    wf = MnistWorkflow(launcher, layers=(16, 10), max_epochs=1)
    launcher.initialize(device="cpu")
    tc = wf.compiler
    tc.compile_population(("learning_rate",))
    genes = numpy.array([[0.05], [1e36]], dtype=numpy.float32)
    params, states = tc.population_arrays(2)
    start_p = {k: v.clone() for k, v in params.items()}
    start_s = {k: v.clone() for k, v in states.items()}
    consts = {str(id(v)): v.devmem for v in tc.const_vectors}
    walked = []
    while sum(cls == TRAIN for _, cls in walked) < 2:
        blocks = wf.loader.serve_block(3)
        cls = int(wf.loader.minibatch_class)
        walked.append((blocks, cls))
        params, states = tc._pop_block(params, states, blocks, consts,
                                       tc._generator(), cls == TRAIN,
                                       torch.from_numpy(genes))
    health = states["EvaluatorSoftmax/health_acc"]
    assert health[0, TRAIN, 0] == 0 and health[1, TRAIN, 0] > 0
    assert all(torch.isfinite(v[0]).all() for v in params.values())
    for key, vec in tc._param_vecs.items():
        vec.devmem = start_p[key][0].clone()
    for key, vec in tc._state_vecs.items():
        vec.devmem = start_s[key][0].clone()
    for blocks, cls in walked:
        tc.execute_block(blocks, cls == TRAIN,
                         hypers={"learning_rate": float(genes[0, 0])})
    for key, vec in tc._param_vecs.items():
        gap = (params[key][0] - vec.devmem).norm()
        change = (vec.devmem - start_p[key][0]).norm()
        assert gap <= 1e-5 * change + 1e-7, key
    torch.testing.assert_close(
        health[0], tc._state_vecs["EvaluatorSoftmax/health_acc"].devmem,
        rtol=1e-5, atol=1e-7)


def _mnist():
    return import_workflow_module(TMNIST)


def test_vmap_backend_gating():
    """The counterpart of ``tests/test_population.py::
    test_vmap_backend_gating``."""
    module = _mnist()
    troot.mnist.learning_rate = Tune(0.01, 0.001, 0.1)
    tunes = collect_tunes(troot)
    assert VmapSubPopulation.applicable(module, tunes)
    troot.common.population.vmap = False
    assert not VmapSubPopulation.applicable(module, tunes)
    troot.common.population.vmap = True
    troot.ga_test.n_layers = Tune(2, 1, 4)
    assert not VmapSubPopulation.applicable(module, collect_tunes(troot))


def _main(module=None, **kw):
    args = dict(listen_address=None, master_address=None,
                result_file=None, random_seed="42", pbt=False,
                device="cpu")
    args.update(kw)
    return SimpleNamespace(module=module, args=SimpleNamespace(**args))


def test_engine_auto_mode_selection():
    """The counterpart of ``tests/test_population.py::
    test_engine_auto_mode_selection``."""
    main = _main()
    assert PopulationEngine(main, 2).mode == "train"
    troot.mnist.learning_rate = Tune(0.01, 0.001, 0.1)
    assert PopulationEngine(main, 2).mode == "ga"
    main.args.pbt = True
    assert PopulationEngine(main, 2).mode == "pbt"


@pytest.mark.parametrize("case", ["topology"])
def test_fleet_modes_raise_naming_a7a(case):
    """Of the fleet modes that raised until the fleet was ported, the
    one left is a refusal of the JAX package's own: a GA whose tunes are
    not all GD hyperparameters cannot ride fleet lineages (nor the vmap
    backend), and both packages' engines raise ``Bug``.  The modes that
    now run are held in ``test_torch_population_fleet.py``."""
    from veles_tpu.error import Bug as JBug
    from veles_tpu.population import PopulationEngine as JEngine
    from veles_tpu.__main__ import import_workflow_module as jimport
    from veles_tpu.config import Tune as JTune
    troot.mnist.learning_rate = Tune(0.01, 0.001, 0.1)
    troot.ga_test.n_layers = Tune(2, 1, 4)
    engine = PopulationEngine(_main(_mnist()), 2, generations=1)
    assert engine.mode == "ga"
    with pytest.raises(Bug, match="topology"):
        engine.run()
    jroot.mnist.learning_rate = JTune(0.01, 0.001, 0.1)
    jroot.ga_test.n_layers = JTune(2, 1, 4)
    jargs = _main(jimport(JMNIST))
    with pytest.raises(JBug, match="topology"):
        JEngine(jargs, 2, generations=1).run()


def _population_cli(module_path, main_cls, tmp_path, name, extra=()):
    result = tmp_path / name
    rc = main_cls([module_path, "root.mnist.max_epochs=2",
                   "root.mnist.learning_rate=Tune(0.0005, 0.0001, 0.5)",
                   "--population", "4:2", "--result-file", str(result),
                   "--random-seed", "42", "-v", "warning"] +
                  list(extra)).run()
    assert rc == 0
    return json.loads(result.read_text())


def test_population_ga_cli_matches_jax(tmp_path):
    """``--population 4:2`` with a tuned learning rate: GA over the vmap
    backend, one device job per generation (2 here), and the JAX
    package's run of the same argv picks the same best genes with the
    same fitness (within 1e-6)."""
    got = _population_cli(TMNIST, Main, tmp_path, "pop.json",
                          ["--device", "cpu", "--population-vmap", "on"])
    assert resilience.stats.snapshot()["population.vmap_generations"] == 2
    from veles_tpu.__main__ import Main as JMain
    want = _population_cli(JMNIST, JMain, tmp_path, "jax.json")
    for data in (got, want):
        assert data["mode"] == "population"
        assert data["scheduling"] == "ga"
        assert data["size"] == 4 and data["best_member"] == "ga"
        assert data["summary"] == {"mode": "ga"}
    assert set(got["best_overrides"]) == {"mnist.learning_rate"}
    assert got["best_overrides"] == pytest.approx(want["best_overrides"],
                                                  rel=1e-12)
    assert got["best_fitness"] == pytest.approx(want["best_fitness"],
                                                abs=1e-6)
    assert got["best_fitness"] > 0.5


def test_population_vmap_off_is_refused_by_the_cli(tmp_path):
    """``--population-vmap off`` is no longer refused: it forces the GA
    onto fleet lineages (the in-process loopback here), so the result's
    summary is the population master's, with its GA generation, and the
    best chromosome's genes are among the lineages'."""
    result = tmp_path / "pop.json"
    rc = Main([TMNIST, "root.mnist.max_epochs=1",
               "root.mnist.minibatch_size=200",
               "root.mnist.learning_rate=Tune(0.0005, 0.0001, 0.5)",
               "--population", "2:1", "--population-vmap", "off",
               "--device", "cpu", "--result-file", str(result),
               "--random-seed", "42", "-v", "warning"]).run()
    assert rc == 0
    assert "population.vmap_generations" not in resilience.stats.snapshot()
    assert resilience.stats.snapshot()["population.jobs"] > 0
    data = json.loads(result.read_text())
    assert data["scheduling"] == "ga" and data["best_member"] == "ga"
    assert data["summary"]["mode"] == "ga"
    assert data["summary"]["ga_generation"] == 0
    assert set(data["summary"]["fitness"]) == {"g0c0", "g0c1"}
    assert data["best_fitness"] == pytest.approx(
        max(data["summary"]["fitness"].values()), abs=1e-6)
