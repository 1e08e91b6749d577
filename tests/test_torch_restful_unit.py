"""The port's in-workflow serving unit (``veles_tpu_torch.restful
.RESTfulAPI``) on the CPU: linked after a workflow's decision and gated
until training completes, it exports the workflow and serves it from
the same process.

* MNIST, two epochs: ``/api`` answers 10 probabilities
  (``tests/test_restful.py``'s unit test, on the port);
* a 2-block, narrow TinyLM trained then served by the unit: every
  ``/api/generate`` answer is token-identical to the port's plain
  ``generate`` (``attend=decode_attention_reference``) over the artifact
  it wrote, and to the JAX package's ``generate`` over the same
  artifact's weights;
* ``--serve-kv-dtype int8`` (through the command line's flags) reaches
  the engine's KV plane;
* the unit serves on the workflow's device;
* the serving fabric's kwargs (or the config tree's ``fabric_*``
  keys) build a fabric — replicas, disaggregated prefill, tenants —
  whose answers are token-identical to the plain ``generate``.
"""

import concurrent.futures
import json
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu.export import ExportedModel as JExportedModel

from veles_tpu_torch import prng as tprng
from veles_tpu_torch.__main__ import Main
from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.config import root
from veles_tpu_torch.export import ExportedModel
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.ops.decode_attention import decode_attention_reference
from veles_tpu_torch.restful import RESTfulAPI
from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
from veles_tpu_torch.znicz.samples.tinylm import TinyLMWorkflow

torch.set_num_threads(2)

LM = dict(vocab_size=32, seq_len=32, embed_dim=32, n_heads=4, n_blocks=2,
          minibatch_size=16, max_epochs=2,
          loader_config={"n_train": 64, "n_valid": 16,
                         "validate_labels": False})
PROMPTS = ([3, 1, 4], [1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4],
           [2, 7], [7] * 16)
MAX_NEW = 6


def _post(port, path, payload, headers=None):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(wf, launcher, **kwargs):
    """Links a RESTfulAPI after ``wf``'s decision, gated until training
    completes, and runs the workflow on the CPU."""
    api = RESTfulAPI(wf, host="127.0.0.1", port=0, **kwargs)
    api.link_from(wf.decision)
    api.gate_block = ~wf.decision.complete
    launcher.initialize(device="cpu")
    launcher.run()
    return api


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    tprng.reset()
    tprng.get(0).seed(5)
    launcher = Launcher()
    wf = MnistWorkflow(launcher, max_epochs=2, learning_rate=0.1)
    path = str(tmp_path_factory.mktemp("mnist") / "served.veles.tgz")
    api = _serve(wf, launcher, artifact_path=path)
    yield wf, api, path
    api.stop()


def test_unit_serves_mnist_after_training(mnist):
    wf, api, path = mnist
    assert wf.decision.epoch_number == 2
    assert api.server is not None and api.device == "cpu"
    status, reply = _post(api.port, "/api", {"input": [[0.0] * 784]})
    assert status == 200
    assert len(reply["output"][0]) == 10
    assert abs(sum(reply["output"][0]) - 1.0) < 1e-4
    assert api.export_seconds > 0 and api.start_seconds > 0


def test_unit_answers_as_the_artifact(mnist):
    _, api, path = mnist
    x = numpy.random.RandomState(0).rand(3, 784).astype(numpy.float32)
    status, reply = _post(api.port, "/api", {"input": x.tolist()})
    assert status == 200
    want = ExportedModel(path, device="cpu").forward(x)
    numpy.testing.assert_allclose(numpy.asarray(reply["output"]),
                                  want.reshape(3, -1), rtol=1e-5,
                                  atol=1e-6)


def test_unit_serves_on_the_workflow_device(mnist):
    wf, _, path = mnist
    api = RESTfulAPI(wf, port=0, artifact_path=path + ".2")
    # Not initialized by a workflow: the card, never a silent CPU.
    assert api.device == "cuda"
    api.initialize(device=resolve_device("cpu"))
    assert api.device == "cpu"
    if not torch.cuda.is_available():
        cuda_api = RESTfulAPI(wf, port=0, artifact_path=path + ".3")
        with pytest.raises(Exception, match="cuda|CUDA"):
            cuda_api.run()
        assert cuda_api.server is None


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    tprng.reset()
    tprng.get(0).seed(42)
    launcher = Launcher()
    wf = TinyLMWorkflow(launcher, **LM)
    path = str(tmp_path_factory.mktemp("lm") / "lm.veles.tgz")
    api = _serve(wf, launcher, artifact_path=path, max_batch=4,
                 kv_block_size=4)
    yield wf, api, path
    api.stop()


def test_unit_serves_the_lm_token_identical(lm):
    wf, api, path = lm
    assert wf.decision.epoch_number == LM["max_epochs"]
    with concurrent.futures.ThreadPoolExecutor(len(PROMPTS)) as ex:
        replies = list(ex.map(lambda p: _post(
            api.port, "/api/generate",
            {"tokens": [p], "max_new_tokens": MAX_NEW}), PROMPTS))
    assert [status for status, _ in replies] == [200] * len(PROMPTS)
    answers = [reply["generated"][0] for _, reply in replies]
    assert api.server.engine.kv_pool.kv_dtype == "f32"
    plain = ExportedModel(path, device="cpu")
    jax_model = JExportedModel(path)
    for prompt, got in zip(PROMPTS, answers):
        want = plain.generate(numpy.asarray([prompt]), MAX_NEW,
                              attend=decode_attention_reference)
        assert got == want[0, len(prompt):].tolist(), prompt
        jwant = numpy.asarray(jax_model.generate(numpy.asarray([prompt]),
                                                 MAX_NEW))
        assert got == jwant[0, len(prompt):].tolist(), prompt


def test_serve_kv_dtype_flag_reaches_the_engine_plane(lm, tmp_path):
    wf, _, _ = lm
    saved = dict(root.common.serving.__dict__)
    try:
        main = Main(["wf.py", "--serve-kv-dtype", "int8",
                     "--serve-max-batch", "2", "--serve-warmup"])
        main.parse()
        main.apply_subsystem_flags()
        api = RESTfulAPI(wf, host="127.0.0.1", port=0,
                         artifact_path=str(tmp_path / "int8.veles.tgz"),
                         kv_block_size=4)
        api.initialize(device=resolve_device("cpu"))
        assert (api.kv_dtype, api.max_batch, api.warmup) == \
            ("int8", 2, True)
        api.run()
        try:
            assert api.server.engine.kv_pool.kv_dtype == "int8"
            status, reply = _post(api.port, "/api/generate", {
                "tokens": [PROMPTS[1]], "max_new_tokens": MAX_NEW})
            assert status == 200
            assert len(reply["generated"][0]) == MAX_NEW
        finally:
            api.stop()
        assert api.server is None
    finally:
        root.common.serving.__dict__.clear()
        root.common.serving.__dict__.update(saved)


def _fabric_answers(wf, path, headers=None, **kwargs):
    """The unit with ``kwargs`` exporting ``wf`` to ``path`` and serving
    it on the CPU: its fabric and its answers to PROMPTS, one by one."""
    api = RESTfulAPI(wf, host="127.0.0.1", port=0, artifact_path=path,
                     max_batch=4, kv_block_size=4, **kwargs)
    api.initialize(device=resolve_device("cpu"))
    api.run()
    try:
        fabric = api.server.fabric
        replies = [_post(api.port, "/api/generate",
                         {"tokens": [p], "max_new_tokens": MAX_NEW},
                         headers) for p in PROMPTS]
        occupancy = fabric.occupancy()
    finally:
        api.stop()
    assert [status for status, _ in replies] == [200] * len(PROMPTS)
    return fabric, occupancy, [r["generated"][0] for _, r in replies]


def _plain_answers(path):
    plain = ExportedModel(path, device="cpu")
    return [plain.generate(numpy.asarray([p]), MAX_NEW,
                           attend=decode_attention_reference)[
                               0, len(p):].tolist() for p in PROMPTS]


@pytest.mark.parametrize("kwargs", [{"fabric_replicas": 2},
                                    {"fabric_disagg": True},
                                    {"tenant": ["a=1000"]}],
                         ids=["replicas", "disagg", "tenant"])
def test_fabric_kwargs_raise_naming_a8(kwargs, lm, tmp_path):
    """Each fabric kwarg, refused until the fabric was ported, now
    builds it: two replicas, a prefill worker whose blocks the replica
    adopts (the 16- and 17-token prompts span full 4-token blocks), or
    a tenant (``X-Tenant: a``); the answers are token-identical to the
    plain ``generate`` over the artifact the unit wrote."""
    wf, _, _ = lm
    path = str(tmp_path / "fabric.veles.tgz")
    headers = {"X-Tenant": "a"} if "tenant" in kwargs else None
    fabric, occupancy, answers = _fabric_answers(wf, path, headers,
                                                 **kwargs)
    assert answers == _plain_answers(path)
    assert occupancy["routed"] == len(PROMPTS)
    if "fabric_replicas" in kwargs:
        assert occupancy["replicas"] == 2
    if "fabric_disagg" in kwargs:
        assert fabric.prefill is not None
        assert occupancy["adopted_blocks"] >= 1
    if "tenant" in kwargs:
        assert occupancy["registry"]["tenants"]["a"]["admitted"] == \
            len(PROMPTS)


def test_fabric_from_the_config_tree_raises_too(lm, tmp_path):
    """``root.common.serving.fabric_replicas`` (set by
    ``--serve-fabric-replicas``) builds the fabric too — three replicas
    answering token-identical; an explicit kwarg wins."""
    wf, _, _ = lm
    root.common.serving.fabric_replicas = 3
    try:
        assert RESTfulAPI(None, fabric_replicas=1).fabric_replicas == 1
        path = str(tmp_path / "tree.veles.tgz")
        _, occupancy, answers = _fabric_answers(wf, path)
    finally:
        del root.common.serving.__dict__["fabric_replicas"]
    assert occupancy["replicas"] == 3
    assert answers == _plain_answers(path)
