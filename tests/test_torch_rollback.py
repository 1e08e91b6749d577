"""The JAX package's guardian gates (``tests/test_guardian.py``) on the
port, on the CPU: a seeded ``step.nan`` chaos plan poisons one train
tick of MNIST FC through the real step; under the ``rollback`` policy
the guardian detects the non-finite epoch, restores every trainable and
optimizer slot from the newest generation that verifies, loads and is
finite (the poisoned generations written after the poison are skipped
by their manifests' ``finite`` flag), reshuffles the train order, and
the run still converges — with the same events and the same result in
two runs from one seed.  Without any snapshot the policy degrades to
skip; ``restore_vectors`` copies matching tensors and refuses a source
whose optimizer slots the live run has no home for.  The command line
reaches the policy through ``--guardian-policy``.
"""

import os

import numpy
import pytest

from veles_tpu_torch import prng
from veles_tpu_torch import resilience
from veles_tpu_torch.__main__ import Main
from veles_tpu_torch.config import root
from veles_tpu_torch.guardian import HealthGuardian, restore_vectors
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.snapshotter import SnapshotterToFile, read_manifest
from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_PY = os.path.join(ROOT, "veles_tpu_torch", "znicz", "samples",
                        "mnist.py")


def _config_nodes(node):
    """(node, a copy of its attributes) for ``node`` and every node under
    it: what a test's command line sets, put back afterwards."""
    out = [(node, dict(node.__dict__))]
    for _, value in node.items():
        if isinstance(value, type(node)):
            out.extend(_config_nodes(value))
    return out


@pytest.fixture(autouse=True)
def port_state():
    """Fresh port generators and resilience state, and every node of the
    configuration put back after the test."""
    saved = _config_nodes(root)
    prng.reset()
    resilience.reset()
    yield
    prng.reset()
    resilience.reset()
    for node, state in saved:
        node.__dict__.clear()
        node.__dict__.update(state)


def build_guarded(directory, policy, chaos, max_epochs=4, seed=11):
    """MNIST with an improvement-gated snapshotter and a guardian,
    decision → snapshotter → guardian → gd chain, as the JAX gate
    builds it (plain codec, every 4th trigger)."""
    prng.reset()
    resilience.reset()
    prng.get(0).seed(seed)
    if chaos:
        resilience.install(chaos)
    launcher = Launcher()
    wf = MnistWorkflow(
        launcher, max_epochs=max_epochs, learning_rate=0.1,
        snapshotter_config={"directory": str(directory), "prefix": "mnist",
                            "time_interval": 0.0, "compression": "",
                            "interval": 4},
        guardian_config={"policy": policy})
    launcher.initialize(device="cpu")
    launcher.run()
    return wf, wf.guardian


def weights_finite(wf):
    out = True
    for layer in wf.forwards:
        for vec in layer.trainables.values():
            vec.map_read()
            out = out and bool(numpy.isfinite(vec.mem).all())
    return out


def test_step_nan_skip_policy_keeps_weights_clean(tmp_path):
    wf, guardian = build_guarded(tmp_path, "skip", "step.nan@30",
                                 max_epochs=3)
    assert resilience.stats.get("chaos.step.nan") == 1
    assert resilience.stats.get("guardian.nan_ticks") >= 1
    assert resilience.stats.get("guardian.skipped") >= 1
    assert guardian.last_event["kind"] == "nan"
    assert guardian.last_event["action"] == "skipped"
    assert weights_finite(wf)
    assert wf.decision.min_validation_err < 0.15


def test_step_nan_rollback_restores_and_converges(tmp_path):
    results = []
    for run in range(2):
        directory = tmp_path / ("run%d" % run)
        wf, guardian = build_guarded(directory, "rollback",
                                     "step.nan@30,seed:42")
        assert guardian.rollbacks == 1
        assert resilience.stats.get("guardian.rollbacks") == 1
        assert weights_finite(wf)
        assert wf.decision.min_validation_err < 0.15
        # The generation written with the poison in the weights says so.
        finite = [read_manifest(os.path.join(str(directory), f))["finite"]
                  for f in sorted(os.listdir(directory))
                  if f.endswith(".pickle")]
        assert True in finite
        results.append((
            wf.decision.min_validation_err,
            [(e["epoch"], e["class"], e["kind"], e["action"])
             for e in guardian.events],
            list(resilience.get_injector().fired),
            [v.mem.tobytes() for v in wf.forwards[0].trainables.values()],
        ))
    assert results[0] == results[1]
    assert results[0][1][0][3] == "rollback"


def test_rollback_without_any_snapshot_degrades_to_skip(tmp_path):
    launcher = Launcher()
    wf = MnistWorkflow(launcher, max_epochs=1)
    snap = SnapshotterToFile(wf, directory=str(tmp_path), prefix="x")
    guardian = HealthGuardian(wf, policy="rollback", snapshotter=snap,
                              decision=wf.decision)
    guardian.epoch_number = 1
    wf.health_device_skip = False
    event = guardian.on_event("nan", TRAIN, "synthetic")
    assert event["action"] == "skipped"
    assert resilience.stats.get("guardian.skipped") == 1
    assert guardian.rollbacks == 0
    assert wf.health_device_skip   # the gate is armed again


def test_rollback_policy_without_a_snapshotter_is_skip():
    launcher = Launcher()
    wf = MnistWorkflow(launcher, max_epochs=1,
                       guardian_config={"policy": "rollback"})
    launcher.initialize(device="cpu")
    assert wf.guardian.policy == "skip"
    assert wf.health_device_skip


def _two_mnists():
    prng.get(0).seed(7)
    a = MnistWorkflow(Launcher(), max_epochs=1)
    prng.get(0).seed(8)
    b = MnistWorkflow(Launcher(), max_epochs=1)
    for wf in (a, b):
        wf.loader.initialize(device="cpu")
        for layer in wf.forwards:
            layer.initialize(device="cpu")
        for gd in wf.gds:
            gd.initialize(device="cpu")
    return a, b


def test_restore_vectors_copies_matching_tensors():
    a, b = _two_mnists()
    restored = restore_vectors(a, b)
    assert restored >= 8  # two layers x (weights, bias) and their slots
    numpy.testing.assert_array_equal(a.forwards[0].weights.mem,
                                     b.forwards[0].weights.mem)


def test_restore_vectors_refuses_orphan_optimizer_slots():
    """A source trained under another optimizer holds slots the live
    run has no home for: the restore raises and copies nothing."""
    a, b = _two_mnists()
    gd = b.gds[0]
    gd._velocities["adam_m_weights"] = gd._velocities.pop(
        "velocity_weights")
    before = a.forwards[0].weights.mem.copy()
    with pytest.raises(ValueError, match="adam_m_weights"):
        restore_vectors(a, b)
    numpy.testing.assert_array_equal(a.forwards[0].weights.mem, before)


def test_cli_guardian_policy_rolls_back(tmp_path):
    """``--guardian-policy rollback`` with ``--snapshot-dir``: the
    planted ``step.nan`` is rolled back once and the run converges."""
    resilience.install("step.nan@30,seed:42")
    main = Main([MNIST_PY, "--device", "cpu", "-r", "11",
                 "--snapshot-dir", str(tmp_path),
                 "--snapshot-compression", "",
                 "--guardian-policy", "rollback",
                 "root.common.snapshotter.time_interval=0",
                 "root.common.snapshotter.interval=4",
                 "root.mnist.learning_rate=0.1",
                 "root.mnist.max_epochs=4"])
    assert main.run() == Main.EXIT_SUCCESS
    wf = main.workflow
    assert root.common.guardian.policy == "rollback"
    assert wf.guardian.rollbacks == 1
    assert weights_finite(wf)
    assert wf.decision.min_validation_err < 0.15
