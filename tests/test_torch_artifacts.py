"""Non-LM artifacts across the two packages, on the CPU.

Four workflows are built in both packages, the JAX package's weights
carried into the port's with ``params_from_numpy``: MNIST FC (the
sample's tanh/softmax stack), an FC stack behind the mean-disp
normalizer (uint8 images), a tiny TinyLM (embedding, blocks, the tied
head materialized) and a conv chain with
``conv_relu`` (softplus), ``conv_str`` and ``conv_tanh``, all three
pooling kinds with ceil-mode tails, and ``norm`` at AlexNet's n = 5 and
at an even n = 4 with a window that dominates.

* ``export_workflow`` writes the same artifact in both: equal
  ``weights.npz`` arrays, bit for bit; equal manifests but ``created``
  and ``checksum`` (the defining source file's hash); ``model.bin``
  byte for byte.
* A JAX-written artifact gives the port's ``forward_numpy`` the JAX
  package's bytes, and the port's ``forward`` (the device chain, here
  on the CPU) agrees within rtol 1e-5, atol 1e-6.
* A port-written artifact loads in ``veles_tpu.export.ExportedModel``
  with the same ``forward_numpy`` bytes, its ``forward`` within the same
  tolerance.
* The long-tail types ``rbm``, ``all2all_deconv*`` and ``kohonen``, from
  hand-written unit tables, the same way; a ``moe_transformer_block``
  artifact loads and ``generate`` refuses it, pointing at ``forward``.
* The port's MNIST and conv artifacts match ``native/veles_infer``
  (through the port's binding, ``veles_tpu_torch.native``) at
  ``tests/test_native.py``'s tolerances (FC rtol 1e-4, atol 1e-5; conv
  rtol 1e-3, atol 1e-5).
* Serving a classifier: ``/api`` labels are the local ``forward``'s
  argmax, ``/api/generate`` answers 400, ``/health`` names the units.
"""

import io
import json
import os
import tarfile
import urllib.error
import urllib.request

import numpy
import pytest
import torch

import veles_tpu.prng as jprng
from veles_tpu.export import ExportedModel as JModel
from veles_tpu.export import export_workflow as jexport
from veles_tpu.launcher import Launcher as JLauncher
from veles_tpu_torch.native import NativeModel
from veles_tpu.znicz.samples.imagenet import AlexNetWorkflow as JAlexNet
from veles_tpu.znicz.samples.mnist import MnistWorkflow as JMnist
from veles_tpu.znicz.samples.tinylm import TinyLMWorkflow as JTinyLM

from veles_tpu_torch import export as texport
from veles_tpu_torch import prng as tprng
from veles_tpu_torch.accelerated_units import params_from_numpy
from veles_tpu_torch.error import Bug, DeviceNotFoundError
from veles_tpu_torch.export import ExportedModel, write_artifact
from veles_tpu_torch.launcher import Launcher as TLauncher
from veles_tpu_torch.restful import ModelServer
from veles_tpu_torch.znicz.samples.imagenet import AlexNetWorkflow as \
    TAlexNet
from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow as TMnist
from veles_tpu_torch.znicz.samples.tinylm import TinyLMWorkflow as TTinyLM

torch.set_num_threads(2)

FC = [
    {"type": "all2all_tanh",
     "->": {"output_sample_shape": (16,), "weights_stddev": 0.05}},
    {"type": "softmax",
     "->": {"output_sample_shape": (10,), "weights_stddev": 0.05}},
]
CONV = [
    {"type": "conv_relu",
     "->": {"n_kernels": 6, "kx": 3, "ky": 3, "padding": 1,
            "weights_stddev": 0.05, "bias_stddev": 0.05}},
    {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5, "k": 2.0}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "conv_str",
     "->": {"n_kernels": 8, "kx": 3, "ky": 3, "weights_stddev": 0.1,
            "bias_stddev": 0.05}},
    {"type": "norm", "->": {"alpha": 4.0, "beta": 0.75, "n": 4, "k": 1.0}},
    {"type": "avg_pooling", "->": {"kx": 2, "ky": 2, "sliding": (2, 2)}},
    {"type": "conv_tanh",
     "->": {"n_kernels": 8, "kx": 2, "ky": 2, "weights_stddev": 0.1}},
    {"type": "maxabs_pooling", "->": {"kx": 2, "ky": 2,
                                      "sliding": (1, 1)}},
    {"type": "all2all_sigmoid",
     "->": {"output_sample_shape": (12,), "weights_stddev": 0.1}},
    {"type": "softmax",
     "->": {"output_sample_shape": (10,), "weights_stddev": 0.1}},
]


def _images(layers, size):
    return dict(layers=layers, minibatch_size=8, max_epochs=1,
                loader_config={"sim_image_size": size, "sim_classes": 10,
                               "sim_train": 16, "sim_valid": 8,
                               "validate_labels": False})


#: name -> (JAX class, port class, kwargs, sample shape of an input)
MODELS = {
    "mnist": (JMnist, TMnist, dict(max_epochs=1), (784,)),
    "fc_mean_disp": (JAlexNet, TAlexNet, _images(FC, 6), (6, 6, 3)),
    "conv": (JAlexNet, TAlexNet, _images(CONV, 19), (19, 19, 3)),
    "tinylm": (JTinyLM, TTinyLM,
               dict(vocab_size=16, seq_len=12, embed_dim=16, n_heads=2,
                    n_blocks=2, minibatch_size=8,
                    loader_config={"n_train": 16, "n_valid": 8,
                                   "validate_labels": False}), (12,)),
}
FORWARD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """name -> (JAX-written path, port-written path)."""
    out = {}
    tmp = tmp_path_factory.mktemp("artifacts")
    for name, (jcls, tcls, kwargs, _) in MODELS.items():
        jprng.reset()
        jprng.get(0).seed(1234)
        jl = JLauncher()
        jwf = jcls(jl, **kwargs)
        jl.initialize()
        tprng.reset()
        tprng.get(0).seed(4321)   # another seed: the weights come across
        tl = TLauncher()
        twf = tcls(tl, **kwargs)
        tl.initialize(device="cpu")
        arrays = {}
        for unit in jwf.units:
            params = getattr(unit, "trainables", None)
            if not isinstance(params, dict) or not params:
                continue
            for vec in params.values():
                vec.map_read()
            arrays[unit.name] = {a: numpy.array(v.mem)
                                 for a, v in params.items()}
        params_from_numpy(twf, arrays)
        paths = (str(tmp / ("%s.jax.veles.tgz" % name)),
                 str(tmp / ("%s.port.veles.tgz" % name)))
        jexport(jwf, paths[0])
        texport.export_workflow(twf, paths[1])
        out[name] = paths
    return out


def _members(path):
    with tarfile.open(path, "r:gz") as tar:
        return {m.name: tar.extractfile(m).read() for m in tar}


def _inputs(name, n=6, seed=0):
    shape = MODELS[name][3]
    rng = numpy.random.RandomState(seed)
    if name == "tinylm":
        return rng.randint(0, 16, (n,) + shape).astype(numpy.float32)
    if len(shape) == 1:
        return rng.rand(n, *shape).astype(numpy.float32)
    return rng.randint(0, 256, (n,) + shape).astype(numpy.float32)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_export_workflow_writes_the_jax_artifact(artifacts, name):
    jax_path, port_path = artifacts[name]
    jm, tm = _members(jax_path), _members(port_path)
    assert list(jm) == list(tm) == ["manifest.json", "weights.npz",
                                    "model.bin"]
    jman, tman = (json.loads(m["manifest.json"]) for m in (jm, tm))
    for manifest in (jman, tman):
        manifest.pop("created")
        manifest.pop("checksum")
    assert jman == tman
    jw = numpy.load(io.BytesIO(jm["weights.npz"]))
    tw = numpy.load(io.BytesIO(tm["weights.npz"]))
    assert sorted(jw.files) == sorted(tw.files)
    for key in jw.files:
        assert jw[key].dtype == tw[key].dtype == numpy.float32, key
        assert jw[key].tobytes() == tw[key].tobytes(), key
    assert jm["model.bin"] == tm["model.bin"]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_artifact_on_the_port(artifacts, name):
    path = artifacts[name][0]
    jmodel, tmodel = JModel(path), ExportedModel(path, device="cpu")
    assert tmodel.is_lm == (name == "tinylm")
    x = _inputs(name)
    want = jmodel.forward_numpy(x)
    got = tmodel.forward_numpy(x)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    numpy.testing.assert_allclose(tmodel.forward(x), want, **FORWARD_TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_artifact_in_the_jax_package(artifacts, name):
    path = artifacts[name][1]
    jmodel, tmodel = JModel(path), ExportedModel(path, device="cpu")
    x = _inputs(name, seed=1)
    want = jmodel.forward_numpy(x)
    assert tmodel.forward_numpy(x).tobytes() == want.tobytes()
    numpy.testing.assert_allclose(jmodel.forward(x), tmodel.forward(x),
                                  **FORWARD_TOL)


def test_norm_runs_through_the_lrn_wrapper(artifacts, monkeypatch):
    """Each ``norm`` entry of the device chain goes through
    ``ops.lrn.lrn_forward`` — on a CUDA tensor the B6 kernel or an
    error, on a CPU tensor the plain banded version."""
    calls = []
    real = texport.ops_lrn.lrn_forward

    def spy(x, n, alpha, beta, k, route=None):
        calls.append((x.device.type, n, alpha, beta, k))
        return real(x, n, alpha, beta, k, route)

    monkeypatch.setattr(texport.ops_lrn, "lrn_forward", spy)
    model = ExportedModel(artifacts["conv"][1], device="cpu")
    model.forward(_inputs("conv", n=2))
    assert calls == [("cpu", 5, 1e-4, 0.75, 2.0), ("cpu", 4, 4.0, 0.75, 1.0)]


def test_the_card_is_the_default_device(artifacts):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is it")
    with pytest.raises(DeviceNotFoundError):
        ExportedModel(artifacts["mnist"][1])


@pytest.mark.cuda
def test_conv_artifact_on_the_card(artifacts):
    """The device chain on the card against ``forward_numpy``, at the
    JAX package's artifact gate (rtol 1e-3): ``norm`` launches B6, once
    per entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B6 runs only there "
                    "(chip_smoke.py checks it on the H100)")
    from veles_tpu_torch.ops import lrn as ops_lrn
    model = ExportedModel(artifacts["conv"][1], device="cuda")
    x = _inputs("conv")
    ops_lrn.reset_launches()
    got = model.forward(x)
    assert ops_lrn.lrn_forward.launches == 2
    numpy.testing.assert_allclose(got, model.forward_numpy(x), rtol=1e-3,
                                  atol=1e-6)


# -- the long tail, from hand-written unit tables --------------------------


def _manifest(units, in_shape, out_shape):
    return {"format": texport.FORMAT_NAME, "version": texport.FORMAT_VERSION,
            "workflow": "HandWritten", "checksum": "-", "created": "-",
            "input": {"sample_shape": list(in_shape), "dtype": "float32"},
            "output": {"sample_shape": list(out_shape)}, "units": units}


def _longtail(kind, rng):
    n_in, n_out = 12, 5
    w = rng.standard_normal((n_in, n_out)).astype(numpy.float32) * 0.5
    b = rng.standard_normal(n_out).astype(numpy.float32) * 0.1
    if kind == "kohonen":
        w = rng.standard_normal((n_out, n_in)).astype(numpy.float32)
        weights = {"som__weights": w}
        params = {"weights": "som__weights"}
    else:
        weights = {"u__weights": w, "u__bias": b}
        params = {"weights": "u__weights", "bias": "u__bias"}
    units = [{"name": "u" if kind != "kohonen" else "som", "type": kind,
              "config": {"output_sample_shape": [n_out]},
              "params": params}]
    return _manifest(units, (n_in,), (n_out,)), weights


@pytest.mark.parametrize("kind", ["rbm", "all2all_deconv",
                                  "all2all_deconv_sigmoid",
                                  "all2all_deconv_tanh", "kohonen"])
def test_longtail_types_agree(tmp_path, kind):
    rng = numpy.random.default_rng(5)
    manifest, weights = _longtail(kind, rng)
    path = write_artifact(str(tmp_path / "m.veles.tgz"), manifest, weights)
    jmodel, tmodel = JModel(path), ExportedModel(path, device="cpu")
    x = rng.standard_normal((7, 12)).astype(numpy.float32)
    want = jmodel.forward_numpy(x)
    assert tmodel.forward_numpy(x).tobytes() == want.tobytes()
    numpy.testing.assert_allclose(tmodel.forward(x), want, rtol=1e-5,
                                  atol=1e-5)


def test_moe_block_is_refused_with_its_pointer(tmp_path):
    """A MoE artifact loads and runs through forward(); generate()
    refuses it, pointing at forward() as the JAX package's does."""
    units = [{"name": "moe", "type": "moe_transformer_block",
              "config": {"n_heads": 2, "n_experts": 2,
                         "capacity_factor": 1.25},
              "params": {}}]
    path = write_artifact(str(tmp_path / "moe.veles.tgz"),
                          _manifest(units, (4,), (4,)), {})
    model = ExportedModel(path, device="cpu")
    assert not model.is_lm
    with pytest.raises(Bug, match="through forward"):
        model.generate(numpy.zeros((1, 2), numpy.int32), 1)


# -- native runtime parity -------------------------------------------------


def test_native_matches_the_port_fc(artifacts):
    path = artifacts["mnist"][1]
    py = ExportedModel(path, device="cpu")
    nat = NativeModel(path)
    assert nat.unit_types == [u["type"] for u in py.units]
    assert nat.input_size == 784 and nat.output_size == 10
    x = numpy.random.RandomState(0).rand(16, 784).astype(numpy.float32)
    numpy.testing.assert_allclose(nat.forward(x), py.forward_numpy(x),
                                  rtol=1e-4, atol=1e-5)


def test_native_matches_the_port_conv(artifacts):
    path = artifacts["conv"][1]
    py = ExportedModel(path, device="cpu")
    nat = NativeModel(path)
    x = _inputs("conv", n=4, seed=1)
    numpy.testing.assert_allclose(
        nat.forward(x), py.forward_numpy(x).reshape(4, -1), rtol=1e-3,
        atol=1e-5)


# -- serving a classifier --------------------------------------------------


def _call(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=data, headers={"Content-Type":
                                         "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("name", ["mnist", "conv"])
def test_serving_a_classifier(artifacts, name):
    srv = ModelServer(artifacts[name][1], host="127.0.0.1", port=0,
                      max_batch=4, warmup=True, device="cpu")
    srv.start()
    try:
        base = "http://127.0.0.1:%d" % srv.port
        assert srv.engine.kv_pool is None and not srv.engine.paged
        assert srv.engine.stats.snapshot()["counters"][
            "warmup.compiles"] >= 1
        x = _inputs(name, n=6, seed=3)
        status, out = _call(base, "/api", {"input": x.tolist()})
        assert status == 200
        local = srv.model.forward(x).reshape(6, -1)
        assert out["labels"] == numpy.argmax(local, axis=-1).tolist()
        numpy.testing.assert_allclose(out["output"], local, rtol=1e-6,
                                      atol=1e-7)
        status, out = _call(base, "/api/generate",
                            {"tokens": [[1, 2]], "max_new_tokens": 2})
        assert status == 400 and "lm_head" in out["error"]
        status, out = _call(base, "/health")
        assert status == 200
        assert out["units"] == [u["type"] for u in srv.model.units]
    finally:
        srv.stop(drain=True)
