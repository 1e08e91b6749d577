"""The port's host modules against the JAX package's, on the CPU:
``dummy`` (the Repeater → body → Decision loop of
``tests/test_workflow.py``), ``avatar``, ``input_joiner``,
``harness``, ``downloader``, the numpy.random guard of ``prng`` (every
gate of ``tests/test_random.py``'s poison tests) and the command line's
config-file layering (``tests/test_cli.py``'s config tests: order,
precedence, a bad source raises; a stray ``numpy.random.rand()`` in a
workflow file fails the run).  Host arithmetic is the same numpy code in
both packages, so values are held bit for bit.
"""

import json
import os
import subprocess
import sys
import tarfile
import types
import zipfile

import numpy
import pytest
import torch

import veles_tpu.harness as jharness
import veles_tpu.prng as jprng
from veles_tpu.input_joiner import InputJoiner as JInputJoiner
from veles_tpu.memory import Vector as JVector
from veles_tpu.units import TrivialUnit as JTrivialUnit

from veles_tpu_torch import harness, prng
from veles_tpu_torch.__main__ import Main, apply_config_sources
from veles_tpu_torch.avatar import Avatar
from veles_tpu_torch.config import Tune, root
from veles_tpu_torch.downloader import Downloader
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.error import Bug, DeviceNotFoundError
from veles_tpu_torch.input_joiner import InputJoiner
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.units import TrivialUnit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- dummy -----------------------------------------------------------------

class Counter(TrivialUnit):
    def __init__(self, workflow, **kwargs):
        super(Counter, self).__init__(workflow, **kwargs)
        self.count = 0

    def run(self):
        self.count += 1


def test_repeater_loop_terminates_via_gates():
    """Repeater → body → decision, looping until the decision flips its
    Bool — on a DummyWorkflow."""
    wf = DummyWorkflow()
    complete = Bool(False)
    rep = Repeater(wf)
    body = Counter(wf, name="body")

    class Decision(TrivialUnit):
        def run(self):
            if body.count >= 5:
                self.complete <<= True

    dec = Decision(wf, name="decision")
    dec.complete = complete
    rep.link_from(wf.start_point)
    body.link_from(rep)
    dec.link_from(body)
    rep.link_from(dec)
    rep.gate_block = complete
    wf.end_point.link_from(dec)
    wf.end_point.gate_block = ~complete
    wf.launcher.initialize(device="cpu")
    wf.run()
    assert body.count == 5
    assert bool(complete)
    assert str(wf.launcher.device.torch_device) == "cpu"


def test_dummy_launcher_takes_no_device_by_itself():
    """The default device is the card: without one, initialize raises
    instead of choosing the CPU."""
    launcher = DummyLauncher()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceNotFoundError):
        launcher.initialize()
    assert launcher.initialize(device="cpu") is launcher


# -- avatar and input joiner -----------------------------------------------

def test_avatar_clones_and_isolates():
    wf = DummyWorkflow()
    src = TrivialUnit(wf)
    src.payload = Vector(numpy.zeros(3, dtype=numpy.float32))
    src.scalar = 7
    av = Avatar(wf, source=src, attrs=["payload"]).clone_attr("scalar")
    av.initialize()
    src.payload.mem = numpy.ones(3, dtype=numpy.float32)
    src.scalar = 8
    numpy.testing.assert_array_equal(av.payload.mem, [0, 0, 0])
    assert av.scalar == 7
    av.run()
    numpy.testing.assert_array_equal(av.payload.mem, [1, 1, 1])
    assert av.scalar == 8
    # A device-authoritative source is read back through its host copy.
    src.payload.devmem = torch.full((3,), 2.0)
    av.run()
    numpy.testing.assert_array_equal(av.payload.mem, [2, 2, 2])
    with pytest.raises(ValueError):
        Avatar(wf).initialize()


def test_input_joiner_matches_jax():
    rng = numpy.random.RandomState(2)
    a = rng.randn(4, 2).astype(numpy.float32)
    b = rng.randn(4, 3, 2).astype(numpy.float32)
    c = rng.randint(0, 9, (4, 2, 2, 1)).astype(numpy.int32)
    outs = []
    for joiner_cls, vec in ((JInputJoiner, JVector), (InputJoiner, Vector)):
        joiner = joiner_cls(None, inputs=[vec(a), vec(b)])
        joiner.link_inputs(vec(c))
        joiner.initialize()
        assert joiner.output.shape == (4, 12)
        assert [(getattr(joiner, "offset_%d" % i),
                 getattr(joiner, "length_%d" % i)) for i in range(3)] == \
            [(0, 2), (2, 6), (8, 4)]
        joiner.eager_run()
        joiner.output.map_read()
        outs.append(numpy.array(joiner.output.mem))
    assert outs[1].dtype == numpy.float32
    assert numpy.array_equal(outs[0], outs[1])
    numpy.testing.assert_array_equal(outs[1][0, :2], a[0])


def test_input_joiner_needs_allocated_inputs():
    with pytest.raises(ValueError):
        InputJoiner(None).initialize()
    with pytest.raises(AttributeError):
        InputJoiner(None, inputs=[Vector()]).initialize()


# -- harness ---------------------------------------------------------------

def _draw_module(prng_module, unit_base, workflow_base):
    """A workflow module whose unit records host draws of generator
    0."""

    class Draw(unit_base):
        def run(self):
            self.draws = prng_module.get(0).uniform(size=5)

    class DrawWorkflow(workflow_base):
        def __init__(self, workflow, **kwargs):
            super(DrawWorkflow, self).__init__(workflow, **kwargs)
            self.unit = Draw(self)
            self.unit.link_from(self.start_point)
            self.end_point.link_from(self.unit)

    module = types.ModuleType("draw_module")

    def run(load, main):
        load(DrawWorkflow)
        main()

    module.run = run
    return module


def test_run_workflow_module_same_seed_same_draws():
    """The same seed gives the same host draws in both packages; the
    seed base of a file spec is the JAX package's; the default device is
    the card."""
    from veles_tpu.workflow import Workflow as JWorkflow
    from veles_tpu_torch.workflow import Workflow as TWorkflow
    jwf = jharness.run_workflow_module(
        _draw_module(jprng, JTrivialUnit, JWorkflow), seed=321)
    module = _draw_module(prng, TrivialUnit, TWorkflow)
    twf = harness.run_workflow_module(module, seed=321, device="cpu")
    assert numpy.array_equal(jwf.unit.draws, twf.unit.draws)
    again = harness.run_workflow_module(module, seed=321, device="cpu")
    assert numpy.array_equal(again.unit.draws, twf.unit.draws)
    for spec in ("", None, "17", "/dev/urandom:16:uint32"):
        assert harness.seed_to_int(spec) == jharness.seed_to_int(spec)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceNotFoundError):
            harness.run_workflow_module(module, seed=1)


# -- downloader ------------------------------------------------------------

def test_downloader_unpacks_local_tar_and_zip(tmp_path):
    payload = tmp_path / "payload.txt"
    payload.write_text("hello")
    tar_path = tmp_path / "ds.tar"
    with tarfile.open(tar_path, "w") as tar:
        tar.add(payload, arcname="payload.txt")
    zip_path = tmp_path / "ds.zip"
    with zipfile.ZipFile(zip_path, "w") as z:
        z.writestr("sub/other.txt", "zipped")
    wf = DummyWorkflow()
    target = tmp_path / "out"
    Downloader(wf, url="file://" + str(tar_path), directory=str(target),
               files=["payload.txt"]).initialize()
    assert (target / "payload.txt").read_text() == "hello"
    Downloader(wf, url="file://" + str(zip_path), directory=str(target),
               files=["sub/other.txt"]).initialize()
    assert (target / "sub" / "other.txt").read_text() == "zipped"
    assert not (target / "ds.tar").exists()
    assert not (target / "ds.zip").exists()
    # Present files short-circuit the fetch.
    Downloader(wf, url="file:///nonexistent", directory=str(target),
               files=["payload.txt"]).initialize()
    with pytest.raises(ValueError, match="no url"):
        Downloader(wf, directory=str(tmp_path / "none"),
                   files=["x"]).initialize()


def test_downloader_refuses_zip_slip(tmp_path):
    evil = tmp_path / "evil.zip"
    with zipfile.ZipFile(evil, "w") as z:
        z.writestr("../escaped.txt", "boo")
    target = tmp_path / "out"
    with pytest.raises(ValueError, match="refusing to extract"):
        Downloader(DummyWorkflow(), url="file://" + str(evil),
                   directory=str(target), files=["x"]).initialize()
    assert not (tmp_path / "escaped.txt").exists()


# -- the numpy.random guard ------------------------------------------------

def test_poison_numpy_random_guard():
    """While poisoned, hidden-global-state sampling raises; explicitly
    seeded generators stay usable; unpoisoned() restores."""
    prng.poison_numpy_random()
    try:
        with pytest.raises(AttributeError, match="reproducibility"):
            numpy.random.rand(3)
        with pytest.raises(AttributeError):
            numpy.random.seed(0)
        rs = numpy.random.RandomState(7)
        assert rs.rand(2).shape == (2,)
        gen = numpy.random.default_rng(7)
        assert gen.random(2).shape == (2,)
        g = prng.get(0)
        g.seed(11)
        assert g.uniform(size=3).shape == (3,)
        with prng.unpoisoned():
            numpy.random.rand(1)
        with pytest.raises(AttributeError):
            numpy.random.rand(1)
    finally:
        prng.unpoison_numpy_random()
    numpy.random.rand(1)


def test_poison_is_idempotent():
    prng.poison_numpy_random()
    prng.poison_numpy_random()
    try:
        assert numpy.random.RandomState(1) is not None
    finally:
        prng.unpoison_numpy_random()
    assert numpy.random is prng._np_random
    assert sys.modules["numpy.random"] is prng._np_random


def _call_from(filename):
    """numpy.random.rand(1) called from code that claims ``filename``."""
    code = compile("numpy.random.rand(1)", filename, "exec")
    exec(code, {"numpy": numpy})


def test_guard_sorts_callers(tmp_path, monkeypatch, caplog):
    """The port's files, registered workflow paths and the launch
    directory raise; installed libraries pass; anything else warns once
    per call site.  The JAX package's guard names its own package, so
    the two guards never claim each other's files by name."""
    monkeypatch.chdir(tmp_path)
    elsewhere = os.path.join(os.sep, "opt", "elsewhere")
    prng.poison_numpy_random()
    try:
        with pytest.raises(AttributeError):
            _call_from(os.path.join(elsewhere, "veles_tpu_torch", "x.py"))
        with pytest.raises(AttributeError):
            _call_from(str(tmp_path / "workflow.py"))
        _call_from("/usr/lib/python3/site-packages/torch/x.py")
        with caplog.at_level("WARNING", logger="prng"):
            _call_from(os.path.join(elsewhere, "lib.py"))
        assert "warning only" in caplog.text
        prng.guard_path(os.path.join(elsewhere, "flows"))
        with pytest.raises(AttributeError):
            _call_from(os.path.join(elsewhere, "flows", "wf.py"))
    finally:
        prng.unpoison_numpy_random()
        prng._guarded_paths.discard(os.path.join(elsewhere, "flows"))
    assert prng.PACKAGE == "veles_tpu_torch"
    assert jprng._np_random is numpy.random


# -- config-file layering and the command line -----------------------------

def test_config_overrides_and_files(tmp_path):
    cfg = tmp_path / "cfg.py"
    cfg.write_text("root.cli_test.alpha = 42\n"
                   "root.cli_test.lr = Tune(0.1, 0.01, 1.0)\n")
    try:
        apply_config_sources([str(cfg), "root.cli_test.beta='x'"])
        assert root.cli_test.get("alpha") == 42
        assert root.cli_test.get("beta") == "x"
        assert isinstance(root.cli_test.get("lr"), Tune)
        # In argv order: a later source wins.
        apply_config_sources(["root.cli_test.alpha=1", str(cfg)])
        assert root.cli_test.get("alpha") == 42
        apply_config_sources([str(cfg), "root.cli_test.alpha=1"])
        assert root.cli_test.get("alpha") == 1
    finally:
        root.cli_test.reset()


def test_bad_config_source_raises():
    with pytest.raises(Bug):
        apply_config_sources(["no_such_file.py"])


RECORDING_WORKFLOW = '''
import json
import numpy

from veles_tpu_torch.config import root
from veles_tpu_torch.workflow import Workflow


class Empty(Workflow):
    def __init__(self, workflow, **kwargs):
        super(Empty, self).__init__(workflow, **kwargs)
        self.end_point.link_from(self.start_point)


def run(load, main):
    with open(%r, "w") as fout:
        json.dump({"order": root.cfg_order.get("value"),
                   "extra": root.cfg_order.get("extra"),
                   "compression": root.common.snapshotter.get(
                       "compression"),
                   "guard": type(numpy.random).__name__}, fout)
    load(Empty)
    main()
'''


def test_cli_config_files_then_flags(tmp_path):
    """Positional config files and ``-c`` files apply in argv order with
    the overrides; the explicit flags win over them; the guard is live
    during the run and gone after it."""
    record = tmp_path / "record.json"
    wf = tmp_path / "recording.py"
    wf.write_text(RECORDING_WORKFLOW % str(record))
    first = tmp_path / "first.py"
    first.write_text("root.cfg_order.value = 'first'\n"
                     "root.common.snapshotter.compression = 'bz2'\n")
    second = tmp_path / "second.py"
    second.write_text("root.cfg_order.value = 'second'\n"
                      "root.cfg_order.extra = 3\n")
    saved = root.common.__dict__.get("snapshotter")
    try:
        prng.reset()
        assert Main([str(wf), str(first), "root.cfg_order.value='cli'",
                     "-c", str(second), "--snapshot-compression", "gz",
                     "--device", "cpu", "-v", "error"]).run() == 0
        got = json.loads(record.read_text())
        assert got == {"order": "second", "extra": 3, "compression": "gz",
                       "guard": "_PoisonedRandom"}
        assert numpy.random is prng._np_random
        assert Main([str(wf), str(second), str(first),
                     "--device", "cpu", "-v", "error"]).run() == 0
        got = json.loads(record.read_text())
        assert (got["order"], got["compression"]) == ("first", "bz2")
        assert Main([str(wf), "--device", "cpu", "-v", "error",
                     "root.common.engine.poison_numpy_random=False"]
                    ).run() == 0
        assert json.loads(record.read_text())["guard"] != "_PoisonedRandom"
    finally:
        root.__dict__.pop("cfg_order", None)
        root.common.engine.__dict__.pop("poison_numpy_random", None)
        root.common.__dict__.pop("snapshotter", None)
        if saved is not None:
            root.common.snapshotter = saved
    with pytest.raises(Bug):
        Main([str(wf), str(tmp_path / "missing.py"), "--device",
              "cpu"]).run()


STRAY_WORKFLOW = '''
import numpy

from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import Workflow


class StrayRandomUnit(Unit):
    def run(self):
        numpy.random.rand(3)  # the banned global draw


class StrayWorkflow(Workflow):
    def __init__(self, workflow, **kwargs):
        super(StrayWorkflow, self).__init__(workflow, **kwargs)
        self.stray = StrayRandomUnit(self)
        self.stray.link_from(self.start_point)
        self.end_point.link_from(self.stray)


def run(load, main):
    load(StrayWorkflow)
    main()
'''


def test_cli_flags_stray_numpy_random(tmp_path):
    """A unit calling global numpy.random during a command-line run
    fails it; the same workflow passes with the guard off."""
    wf = tmp_path / "stray_random.py"
    wf.write_text(STRAY_WORKFLOW)
    env = dict(os.environ, PYTHONPATH=ROOT)
    base = [sys.executable, "-m", "veles_tpu_torch", str(wf), "--device",
            "cpu", "-v", "error"]
    proc = subprocess.run(base, cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "forbids direct numpy.random.rand" in proc.stderr
    proc = subprocess.run(
        base + ["root.common.engine.poison_numpy_random=False"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
