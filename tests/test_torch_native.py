"""The port's native runtime binding (``veles_tpu_torch.native``) against
the port's artifacts and the JAX package's binding, on the CPU.

The counterparts of the JAX package's ``tests/test_native.py``: the
library builds — here into the port's build directory, never under
``native/`` — and loads an MNIST FC and a conv artifact written by the
port, agreeing with ``ExportedModel.forward_numpy`` at that file's
tolerances (FC rtol 1e-4, atol 1e-5; conv rtol 1e-3, atol 1e-5); the
standalone binary predicts; garbage and a geometry mismatch are
refused.  The parity test: the port's ``NativeModel`` and the JAX
package's, on the same artifact and inputs, give the same outputs bit
for bit.
"""

import os
import struct
import subprocess

import numpy
import pytest
import torch

from veles_tpu_torch import native as tnative
from veles_tpu_torch import prng as tprng
from veles_tpu_torch.config import root as troot
from veles_tpu_torch.error import Bug
from veles_tpu_torch.export import ExportedModel, export_workflow
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.native import NativeModel, build_cli, build_native

from test_torch_artifacts import CONV, _images
from test_torch_network import write_mnist_idx

torch.set_num_threads(2)

FC_TOL = dict(rtol=1e-4, atol=1e-5)
CONV_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """An MNIST FC artifact (two epochs trained on synthetic IDX files)
    and a conv artifact (conv, norm, the three poolings), both written
    by the port; the config nodes used are put back."""
    from veles_tpu_torch.znicz.samples.imagenet import AlexNetWorkflow
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    tmp = tmp_path_factory.mktemp("native")
    write_mnist_idx(str(tmp))
    saved = dict(troot.common.dirs.__dict__)
    troot.common.dirs.datasets = str(tmp)
    out = {}
    try:
        tprng.reset()
        tprng.get(0).seed(1234)
        launcher = Launcher()
        wf = MnistWorkflow(launcher, layers=(32, 10), minibatch_size=32,
                           max_epochs=2, learning_rate=0.05)
        launcher.initialize(device="cpu")
        launcher.run()
        out["mnist"] = str(tmp / "mnist.veles.tgz")
        export_workflow(wf, out["mnist"])
        tprng.reset()
        tprng.get(0).seed(4242)
        launcher = Launcher()
        wf = AlexNetWorkflow(launcher, **_images(CONV, 19))
        launcher.initialize(device="cpu")
        out["conv"] = str(tmp / "conv.veles.tgz")
        export_workflow(wf, out["conv"])
    finally:
        troot.common.dirs.__dict__.clear()
        troot.common.dirs.__dict__.update(saved)
        tprng.reset()
    return out


def test_native_builds_outside_native_dir():
    """The library and the binary land in the port's build directory,
    named by a hash of the sources and flags; a forced rebuild replaces
    the file atomically and leaves no temporary behind."""
    path = build_native()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert not path.startswith(tnative.NATIVE_DIR + os.sep)
    assert build_native() == path
    assert build_native(force=True) == path
    cli = build_cli()
    assert os.access(cli, os.X_OK) and cli != path
    leftovers = [f for f in os.listdir(tnative.BUILD_DIR)
                 if f.startswith(os.path.basename(path)) and
                 f.endswith(".tmp")]
    assert leftovers == []


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(Bug, match="native build failed"):
        tnative.build_native(force=True)


def test_native_matches_the_port_fc(artifacts):
    py = ExportedModel(artifacts["mnist"], device="cpu")
    nat = NativeModel(artifacts["mnist"])
    assert nat.unit_types == [u["type"] for u in py.units]
    assert nat.input_size == 784 and nat.output_size == 10
    x = numpy.random.RandomState(0).rand(16, 784).astype(numpy.float32)
    numpy.testing.assert_allclose(nat.forward(x), py.forward_numpy(x),
                                  **FC_TOL)
    # The same contract as ExportedModel.forward: arrays in, numpy out.
    numpy.testing.assert_allclose(nat.forward(torch.from_numpy(x)),
                                  py.forward(x), **FC_TOL)


def test_native_matches_the_port_conv(artifacts):
    py = ExportedModel(artifacts["conv"], device="cpu")
    nat = NativeModel(artifacts["conv"])
    rng = numpy.random.RandomState(1)
    x = rng.randint(0, 256, (4, 19, 19, 3)).astype(numpy.float32)
    numpy.testing.assert_allclose(
        nat.forward(x), py.forward_numpy(x).reshape(4, -1), **CONV_TOL)
    assert "norm" in nat.unit_types


@pytest.mark.parametrize("name", ["mnist", "conv"])
def test_native_equals_jax_native_bit_for_bit(artifacts, name):
    """The JAX package's binding over its own build of the same sources
    gives the same bytes as the port's."""
    from veles_tpu.native import NativeModel as JNativeModel
    port, jax = NativeModel(artifacts[name]), JNativeModel(artifacts[name])
    assert port.unit_types == jax.unit_types
    shape = (8, 784) if name == "mnist" else (3, 19, 19, 3)
    x = numpy.random.RandomState(7).rand(*shape).astype(numpy.float32)
    assert numpy.array_equal(port.forward(x), jax.forward(x))


def test_native_cli_runs(artifacts, tmp_path):
    binary = build_cli()
    x = numpy.random.RandomState(2).rand(2, 784).astype(numpy.float32)
    raw = tmp_path / "in.f32"
    raw.write_bytes(x.tobytes())
    proc = subprocess.run([binary, artifacts["mnist"], str(raw), "2"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = [numpy.array([float(v) for v in line.split()])
            for line in proc.stdout.strip().splitlines()]
    assert len(rows) == 2
    want = ExportedModel(artifacts["mnist"], device="cpu").forward_numpy(x)
    numpy.testing.assert_allclose(numpy.stack(rows), want, rtol=1e-3,
                                  atol=1e-5)


def test_native_rejects_garbage(tmp_path):
    bad = tmp_path / "junk.bin"
    bad.write_bytes(b"not a model at all")
    with pytest.raises(Bug):
        NativeModel(str(bad))


def test_native_rejects_geometry_mismatch(tmp_path):
    """A model.bin whose parameter dims agree with its data but not with
    the config geometry is refused at load."""
    def s(txt):
        b = txt.encode()
        return struct.pack("<H", len(b)) + b

    blob = b"VTPM" + struct.pack("<III", 1, 1, 1)
    blob += struct.pack("<I", 4)
    blob += s("all2all") + s("fc")
    blob += struct.pack("<I", 1) + s("n_out") + struct.pack("<d", 8.0)
    blob += struct.pack("<I", 1) + s("weights")
    blob += struct.pack("<III", 2, 4, 4)
    blob += struct.pack("<16f", *([0.5] * 16))
    bad = tmp_path / "mismatch.bin"
    bad.write_bytes(blob)
    with pytest.raises(Bug):
        NativeModel(str(bad))


def test_forward_refuses_a_wrong_input_size(artifacts):
    nat = NativeModel(artifacts["mnist"])
    with pytest.raises(Bug, match="input size mismatch"):
        nat.forward(numpy.zeros((2, 783), numpy.float32))
