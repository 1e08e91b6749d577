"""The port's snapshotter against the JAX package's snapshot gates, on
the CPU.

* Every gate of ``tests/test_snapshot.py``, run on the port's classes:
  the registry, resume that continues training, weights preserved, the
  launcher left out of the pickle, the manifest round trip, a corrupt
  newest generation walked back past, the ``snapshot.corrupt`` chaos
  point, retention, longer-prefix families, a dangling pointer, an
  unhealthy generation skipped, and the database backend's retention,
  retry, walk-back and unhealthy rows.  A snapshot pickles the port's
  own classes, so these gates run on the port alone; the
  cross-topology restore is ``test_torch_distributed``'s.
* Across packages, host side: one directory of blobs, manifests and
  pointers (stamps set here) gives the same ordered generations from
  the JAX package's ``iter_generations`` / ``resilience.iter_snapshots``
  as from the port's; the manifests the two packages write for the same
  described fields have the same keys and values but ``created``.
* Bit-identical resume on the CPU in float32: N epochs straight equal
  K epochs + snapshot + ``import_`` + N − K epochs, for MNIST FC and a
  tiny AlexNet (conv, LRN, pooling, dropout, FC) — every trainable,
  optimizer slot and accumulator, and the decision's metrics, bit for
  bit (tolerance 0).  The generators are put back to their state at the
  snapshot (the snapshot carries no more than the JAX package's: the
  global generators are not in it).  The CLI the same way: a run with
  ``--snapshot-dir``, then ``-s <pointer>`` (or ``--auto-resume``),
  writes the results JSON of a straight run but for its wall-clock
  ``runtime``.
"""

import json
import os
import pickle
import sqlite3
import time

import numpy
import pytest

import veles_tpu.resilience as jresilience
import veles_tpu.snapshotter as jsnap
from veles_tpu.launcher import Launcher as JLauncher
from veles_tpu.znicz.samples.mnist import MnistWorkflow as JMnist

from veles_tpu_torch import prng
from veles_tpu_torch import resilience
from veles_tpu_torch.__main__ import Main
from veles_tpu_torch.config import root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.resilience import FaultInjector
from veles_tpu_torch.snapshotter import (
    SnapshotterToFile, SnapshotterToDB, SnapshotterRegistry,
    SnapshotIntegrityError, SnapshotPointerError, SnapshotUnhealthyError,
    corrupt_file, iter_generations, manifest_path, read_manifest,
    sha256_file)
from veles_tpu_torch.units import TrivialUnit
from veles_tpu_torch.workflow import Workflow
from veles_tpu_torch.znicz.samples.imagenet import AlexNetWorkflow
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
    """Fresh port generators, resilience counters and injector, and every
    node of the configuration (the CLI's snapshot, guardian and sample
    keys among them) put back after the test."""
    saved = _config_nodes(root)
    prng.reset()
    resilience.reset()
    yield
    prng.reset()
    resilience.reset()
    for node, state in saved:
        node.__dict__.clear()
        node.__dict__.update(state)


def build(tmp_path, max_epochs, **snap_kwargs):
    """MNIST with an improvement-gated snapshotter between the decision
    and the GD chain, as the JAX gates build it (the plain codec keeps
    the per-tick exports cheap; the codecs have their own test)."""
    launcher = Launcher()
    kwargs = dict(directory=str(tmp_path), time_interval=0.0,
                  compression="")
    kwargs.update(snap_kwargs)
    wf = MnistWorkflow(launcher, max_epochs=max_epochs, learning_rate=0.1,
                       snapshotter_config=kwargs)
    return launcher, wf, wf.snapshotter


def test_registry():
    assert SnapshotterRegistry.registry["file"] is SnapshotterToFile
    assert SnapshotterRegistry.registry["db"] is SnapshotterToDB


def test_snapshot_resume_continues_training(tmp_path):
    prng.get(0).seed(11)
    launcher, wf, snap = build(tmp_path, max_epochs=2)
    launcher.initialize(device="cpu")
    launcher.run()
    first_err = wf.decision.min_validation_err
    first_epochs = wf.decision.epoch_number
    assert snap.destination and os.path.exists(snap.destination)
    link = os.path.join(str(tmp_path), "mnist_current.lnk")
    assert os.path.exists(link)
    wf2 = SnapshotterToFile.import_(link)
    assert wf2.decision.epoch_number == first_epochs
    launcher2 = Launcher()
    launcher2.add_ref(wf2)
    wf2.decision.max_epochs = 5
    launcher2.initialize(device="cpu", snapshot=True)
    launcher2.run()
    assert wf2.decision.epoch_number == 5
    assert wf2.decision.min_validation_err <= first_err + 1e-9


def test_snapshot_preserves_weights(tmp_path):
    prng.get(0).seed(12)
    launcher, wf, snap = build(tmp_path, max_epochs=1)
    launcher.initialize(device="cpu")
    launcher.run()
    wf.forwards[0].weights.map_read()
    w = numpy.array(wf.forwards[0].weights.mem)
    wf2 = SnapshotterToFile.import_(snap.destination)
    numpy.testing.assert_array_equal(wf2.forwards[0].weights.mem, w)


def test_snapshot_excludes_launcher(tmp_path):
    prng.get(0).seed(13)
    launcher, wf, snap = build(tmp_path, max_epochs=1)
    launcher.initialize(device="cpu")
    launcher.run()
    wf2 = SnapshotterToFile.import_(snap.destination)
    assert wf2.workflow is None
    assert wf2.step_metrics == {}   # device tensors stay out


# -- integrity: manifests, retention, generation walks ---------------------


class ParamUnit(TrivialUnit):
    """A unit with one trainable so finiteness checks have teeth."""

    def __init__(self, workflow, value=1.0, **kwargs):
        super(ParamUnit, self).__init__(workflow, **kwargs)
        self.w = Vector(numpy.array([value], dtype=numpy.float32))

    @property
    def trainables(self):
        return {"w": self.w}


class TinyWorkflow(Workflow):
    """A cheap picklable workflow for integrity tests."""

    def __init__(self, launcher, **kwargs):
        super(TinyWorkflow, self).__init__(launcher, **kwargs)
        self.body = ParamUnit(self)
        self.body.link_from(self.start_point)
        self.end_point.link_from(self.body)
        self.tag = 0


def tiny_snapshotter(tmp_path, **kwargs):
    wf = TinyWorkflow(Launcher())
    kwargs.setdefault("directory", str(tmp_path))
    kwargs.setdefault("prefix", "tiny")
    kwargs.setdefault("time_interval", 0.0)
    kwargs.setdefault("compression", "")
    snap = SnapshotterToFile(wf, **kwargs)
    snap.initialize()
    return wf, snap


def export_generations(wf, snap, n, start=0):
    for i in range(start, start + n):
        wf.tag = i
        snap.suffix = "g%d" % i
        snap.export()
        time.sleep(0.01)  # distinct manifest timestamps


def test_manifest_write_verify_roundtrip(tmp_path):
    wf, snap = tiny_snapshotter(tmp_path)
    wf.tag = 7
    snap.suffix = "one"
    snap.export()
    manifest = read_manifest(snap.destination)
    assert manifest["sha256"] == sha256_file(snap.destination)
    assert manifest["size"] == os.path.getsize(snap.destination)
    assert manifest["prefix"] == "tiny"
    assert manifest["codec"] == ""
    assert manifest["finite"] is True
    assert SnapshotterToFile.verify(snap.destination)["sha256"] == \
        manifest["sha256"]
    assert SnapshotterToFile.import_(snap.destination).tag == 7
    os.unlink(manifest_path(snap.destination))
    assert SnapshotterToFile.verify(snap.destination) is None
    assert SnapshotterToFile.import_(snap.destination).tag == 7


@pytest.mark.parametrize("codec", ["gz", "bz2", "xz"])
def test_codecs_roundtrip(tmp_path, codec):
    wf, snap = tiny_snapshotter(tmp_path, compression=codec)
    wf.tag = 3
    snap.export()
    assert snap.destination.endswith(".pickle." + codec)
    assert read_manifest(snap.destination)["codec"] == codec
    assert SnapshotterToFile.import_(snap.destination).tag == 3


def test_corrupt_snapshot_rejected_and_resume_walks_back(tmp_path):
    wf, snap = tiny_snapshotter(tmp_path)
    export_generations(wf, snap, 2)
    newest = snap.destination
    corrupt_file(newest)
    with pytest.raises(SnapshotIntegrityError):
        SnapshotterToFile.import_(newest)
    assert resilience.stats.get("snapshot.verify_fail") == 1
    resumed = Launcher().resume_latest(directory=str(tmp_path))
    assert isinstance(resumed, TinyWorkflow)
    assert resumed.tag == 0
    with pytest.raises(Exception):
        SnapshotterToFile.import_(newest, verify=False)


def test_chaos_snapshot_corrupt_point(tmp_path):
    wf, snap = tiny_snapshotter(tmp_path)
    export_generations(wf, snap, 1)
    snap.injector_ = FaultInjector("snapshot.corrupt@1")
    export_generations(wf, snap, 1, start=1)
    assert resilience.stats.get("chaos.snapshot.corrupt") == 1
    with pytest.raises(SnapshotIntegrityError):
        SnapshotterToFile.verify(snap.destination)
    resumed = Launcher().resume_latest(directory=str(tmp_path))
    assert resumed.tag == 0


def test_retention_prunes_old_generations(tmp_path):
    wf, snap = tiny_snapshotter(tmp_path, keep=2)
    export_generations(wf, snap, 5)
    gens = iter_generations(str(tmp_path), "tiny")
    assert [os.path.basename(p) for p in gens] == \
        ["tiny_g4.pickle", "tiny_g3.pickle"]
    files = sorted(os.listdir(tmp_path))
    assert "tiny_g0.pickle" not in files
    assert "tiny_g0.pickle.manifest.json" not in files
    target = SnapshotterToFile.resolve(
        os.path.join(str(tmp_path), "tiny_current.lnk"))
    assert os.path.isfile(target)
    assert resilience.stats.get("snapshot.prune") == 3
    wf0, snap0 = tiny_snapshotter(tmp_path, keep=0, prefix="un")
    export_generations(wf0, snap0, 4)
    assert len(iter_generations(str(tmp_path), "un")) == 4


def test_retention_ignores_longer_prefix_families(tmp_path):
    wf, snap = tiny_snapshotter(tmp_path, keep=2)
    wf_big, snap_big = tiny_snapshotter(tmp_path, prefix="tiny_big")
    export_generations(wf_big, snap_big, 1)
    export_generations(wf, snap, 3)
    assert len(iter_generations(str(tmp_path), "tiny_big")) == 1
    assert all("tiny_big" not in os.path.basename(p)
               for p in iter_generations(str(tmp_path), "tiny"))
    big = iter_generations(str(tmp_path), "tiny_big")[0]
    os.unlink(manifest_path(big))
    assert all("tiny_big" not in os.path.basename(p)
               for p in iter_generations(str(tmp_path), "tiny"))
    assert iter_generations(str(tmp_path), "tiny_big") == [big]


def test_dangling_pointer_raises_actionable_error(tmp_path):
    wf, snap = tiny_snapshotter(tmp_path)
    export_generations(wf, snap, 2)
    link = os.path.join(str(tmp_path), "tiny_current.lnk")
    os.unlink(snap.destination)
    with pytest.raises(SnapshotPointerError) as e:
        SnapshotterToFile.import_(link)
    assert "tiny_current.lnk" in str(e.value)
    assert "auto-resume" in str(e.value)
    resumed = Launcher().resume_latest(directory=str(tmp_path))
    assert resumed.tag == 0
    with open(link, "w"):
        pass
    with pytest.raises(SnapshotPointerError) as e:
        SnapshotterToFile.import_(link)
    assert "empty" in str(e.value)
    assert Launcher().resume_latest(directory=str(tmp_path)).tag == 0


def test_unhealthy_snapshot_skipped_by_walk(tmp_path):
    wf, snap = tiny_snapshotter(tmp_path)
    export_generations(wf, snap, 1)
    wf.body.w.mem = numpy.array([numpy.nan], dtype=numpy.float32)
    wf.tag = 666
    snap.suffix = "poisoned"
    snap.export()
    assert read_manifest(snap.destination)["finite"] is False
    with pytest.raises(SnapshotUnhealthyError):
        SnapshotterToFile.import_(snap.destination)
    assert resilience.stats.get("snapshot.unhealthy") == 1
    resumed = Launcher().resume_latest(directory=str(tmp_path))
    assert resumed.tag == 0
    assert SnapshotterToFile.import_(snap.destination,
                                     verify=False).tag == 666


def test_db_backend_retention_retry_and_walk_back(tmp_path):
    db = os.path.join(str(tmp_path), "snaps.db")
    wf = TinyWorkflow(Launcher())
    snap = SnapshotterToDB(wf, database=db, prefix="tiny", keep=2,
                           time_interval=0.0, compression="gz",
                           injector=FaultInjector("snapshot.fail@1"))
    snap.initialize()
    for i in range(4):
        wf.tag = i
        snap.suffix = "g%d" % i
        snap.export()
    assert resilience.stats.get("snapshot.retry") == 1
    assert resilience.stats.get("snapshot.write") == 4
    with sqlite3.connect(db) as conn:
        rows = conn.execute("SELECT id FROM snapshots").fetchall()
    assert len(rows) == 2
    assert resilience.stats.get("snapshot.prune") == 2
    assert SnapshotterToDB.import_(db, prefix="tiny").tag == 3
    with sqlite3.connect(db) as conn:
        rid, blob = conn.execute(
            "SELECT id, blob FROM snapshots "
            "ORDER BY id DESC LIMIT 1").fetchone()
        blob = bytes(blob)
        mid = len(blob) // 2
        bad = blob[:mid] + bytes([blob[mid] ^ 0xFF]) + blob[mid + 1:]
        conn.execute("UPDATE snapshots SET blob = ? WHERE id = ?",
                     (sqlite3.Binary(bad), rid))
    assert SnapshotterToDB.import_("sqlite://" + db,
                                   prefix="tiny").tag == 2
    assert resilience.stats.get("snapshot.verify_fail") == 1


def test_db_backend_skips_unhealthy_rows(tmp_path):
    db = os.path.join(str(tmp_path), "snaps.db")
    wf = TinyWorkflow(Launcher())
    snap = SnapshotterToDB(wf, database=db, prefix="tiny",
                           time_interval=0.0, compression="")
    snap.initialize()
    wf.tag = 1
    snap.export()
    wf.body.w.mem = numpy.array([numpy.inf], dtype=numpy.float32)
    wf.tag = 2
    snap.export()
    assert SnapshotterToDB.import_(db, prefix="tiny").tag == 1
    assert resilience.stats.get("snapshot.unhealthy") == 1
    assert SnapshotterToDB.import_(db, prefix="tiny",
                                   verify=False).tag == 2


def test_throttles_interval_and_time(tmp_path):
    """``interval`` exports every N-th trigger; ``time_interval`` holds
    exports at least that many seconds apart; ``--no-snapshots``
    (``root.common.snapshot_disabled``) skips them all."""
    wf, snap = tiny_snapshotter(tmp_path, interval=3)
    for _ in range(7):
        snap.run()
    assert resilience.stats.get("snapshot.write") == 2
    wf, snap = tiny_snapshotter(tmp_path, prefix="slow",
                                time_interval=3600.0)
    snap.run()
    assert resilience.stats.get("snapshot.write") == 2
    root.common.snapshot_disabled = True
    wf, snap = tiny_snapshotter(tmp_path, prefix="off")
    snap.run()
    assert resilience.stats.get("snapshot.write") == 2


# -- across packages, host side --------------------------------------------


def _synthetic_directory(d):
    """Blobs of three families with manifests and pointers, stamps set
    here: "mnist" (3 generations, one legacy without a manifest),
    "mnist_big" (a longer family: 2 generations, one legacy) and "lm"
    (1 generation, and a dangling pointer)."""
    def blob(name, created=None, prefix=None, mtime=None):
        path = os.path.join(d, name)
        with open(path, "wb") as fout:
            fout.write(name.encode())
        if created is not None:
            with open(path + ".manifest.json", "w") as fout:
                json.dump({"format": 1, "prefix": prefix,
                           "created": created, "sha256": "0" * 64,
                           "size": len(name)}, fout)
        if mtime is not None:
            os.utime(path, (mtime, mtime))
        return path

    blob("mnist_a.pickle.gz", created=100.0, prefix="mnist")
    blob("mnist_b.pickle.gz", created=300.0, prefix="mnist")
    blob("mnist_c.pickle", mtime=200.0)
    newest_big = blob("mnist_big_x.pickle", created=400.0,
                      prefix="mnist_big")
    blob("mnist_big_y.pickle", mtime=50.0)
    blob("lm.pickle.xz", created=10.0, prefix="lm")
    blob("mnist_b.pickle.gz.veles.tgz")
    with open(os.path.join(d, "mnist_current.lnk"), "w") as fout:
        fout.write(os.path.join(d, "mnist_b.pickle.gz"))
    with open(os.path.join(d, "mnist_big_current.lnk"), "w") as fout:
        fout.write(newest_big)
    with open(os.path.join(d, "lm_current.lnk"), "w") as fout:
        fout.write(os.path.join(d, "lm_gone.pickle"))
    for i, name in enumerate(("lm_current.lnk", "mnist_current.lnk",
                              "mnist_big_current.lnk")):
        os.utime(os.path.join(d, name), (1000.0 + i, 1000.0 + i))


def test_generation_walks_equal_the_jax_package(tmp_path):
    d = str(tmp_path)
    _synthetic_directory(d)
    for family in ("mnist", "mnist_big", "lm", "none"):
        assert iter_generations(d, family) == \
            jsnap.iter_generations(d, family)
    for prefix in (None, "mnist", "mnist_big", "lm"):
        ours = list(resilience.iter_snapshots(d, prefix))
        assert ours == list(jresilience.iter_snapshots(d, prefix))
        assert resilience.latest_snapshot(d, prefix) == \
            jresilience.latest_snapshot(d, prefix)
    assert [os.path.basename(p) for p in iter_generations(d, "mnist")] \
        == ["mnist_b.pickle.gz", "mnist_c.pickle", "mnist_a.pickle.gz"]
    assert [os.path.basename(p)
            for p in resilience.iter_snapshots(d)][:3] == \
        ["mnist_big_x.pickle", "mnist_big_y.pickle", "mnist_b.pickle.gz"]


def test_manifests_equal_the_jax_package(tmp_path):
    """The same prefix, suffix, codec, decision state and optimizer give
    the same manifest keys and values in both packages, ``created``
    aside (the checksum and size are handed to both writers)."""
    manifests = []
    for pkg, wf_cls, snap_cls, launcher in (
            ("jax", JMnist, jsnap.SnapshotterToFile, JLauncher()),
            ("port", MnistWorkflow, SnapshotterToFile, Launcher())):
        wf = wf_cls(launcher, max_epochs=3)
        wf.decision.epoch_number = 3
        wf.decision.min_validation_err = 0.125
        snap = snap_cls(wf, directory=str(tmp_path / pkg),
                        prefix="mnist", compression="bz2")
        snap.suffix = "12.50pt"
        os.makedirs(snap.directory)
        path = os.path.join(snap.directory, "m.pickle.bz2")
        manifest = snap._write_manifest(path, "ab" * 32, 1234)
        with open(manifest_path(path)) as fin:
            assert json.load(fin) == manifest
        manifests.append(manifest)
    jm, tm = manifests
    assert set(jm) == set(tm)
    assert {k: v for k, v in jm.items() if k != "created"} == \
        {k: v for k, v in tm.items() if k != "created"}


# -- bit-identical resume --------------------------------------------------


GD = {"learning_rate": 0.02, "gradient_moment": 0.9, "weights_decay": 5e-4}
TINY_ALEXNET = [
    {"type": "conv_str",
     "->": {"n_kernels": 8, "kx": 5, "ky": 5, "sliding": (2, 2),
            "weights_stddev": 0.05, "bias_stddev": 0}, "<-": dict(GD)},
    {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5, "k": 2.0}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "all2all_str",
     "->": {"output_sample_shape": (32,), "weights_stddev": 0.05},
     "<-": dict(GD)},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "softmax",
     "->": {"output_sample_shape": (10,), "weights_stddev": 0.05},
     "<-": dict(GD)},
]


def _mnist(launcher, max_epochs, snapshotter_config):
    return MnistWorkflow(launcher, max_epochs=max_epochs, learning_rate=0.1,
                         snapshotter_config=snapshotter_config)


def _alexnet(launcher, max_epochs, snapshotter_config):
    return AlexNetWorkflow(
        launcher, layers=TINY_ALEXNET, minibatch_size=16,
        max_epochs=max_epochs, snapshotter_config=snapshotter_config,
        loader_config={"sim_image_size": 32, "sim_classes": 10,
                       "sim_train": 64, "sim_valid": 32,
                       "validate_labels": False})


@pytest.fixture
def f32_stream():
    saved = root.common.engine.get("precision_level")
    root.common.engine.precision_level = 1
    yield
    root.common.engine.precision_level = saved


@pytest.fixture
def generators_at_snapshot(monkeypatch):
    """{snapshot path: pickled generator 0 at its export} — the state a
    resume puts back."""
    saved = {}
    export = SnapshotterToFile.export

    def recording_export(self):
        export(self)
        saved[self.destination] = pickle.dumps(prng.get(0))

    monkeypatch.setattr(SnapshotterToFile, "export", recording_export)
    return saved


def _state(wf):
    out = {}
    for u in wf.units:
        for which in ("trainables", "tstate"):
            for attr, vec in getattr(u, which, {}).items():
                vec.map_read()
                out["%s/%s" % (u.name, attr)] = numpy.array(vec.mem)
    return out


def _assert_same_run(straight, resumed):
    a, b = _state(straight), _state(resumed)
    assert sorted(a) == sorted(b) and len(a) >= 8
    for key in a:
        assert a[key].tobytes() == b[key].tobytes(), key
    assert straight.decision.get_metric_values() == \
        resumed.decision.get_metric_values()
    for attr in ("epoch_n_err", "epoch_n_valid", "epoch_loss",
                 "epoch_nonfinite", "epoch_grad_norm"):
        assert getattr(straight.decision, attr) == \
            getattr(resumed.decision, attr), attr


@pytest.mark.parametrize("build_fn", [_mnist, _alexnet],
                         ids=["mnist", "alexnet"])
def test_resume_is_bit_identical(tmp_path, f32_stream,
                                 generators_at_snapshot, build_fn):
    N, K = 4, 2

    def run(max_epochs, config=None):
        prng.reset()
        prng.get(0).seed(5)
        launcher = Launcher()
        wf = build_fn(launcher, max_epochs, config)
        launcher.initialize(device="cpu")
        launcher.run()
        return wf

    straight = run(N)
    part = run(K, {"directory": str(tmp_path), "time_interval": 0.0,
                   "compression": "", "interval": 3})
    assert part.decision.epoch_number == K
    link = os.path.join(str(tmp_path), part.snapshot_prefix +
                        "_current.lnk")
    path = SnapshotterToFile.resolve(link)
    resumed = SnapshotterToFile.import_(link)
    prng._generators[0] = pickle.loads(generators_at_snapshot[path])
    resumed.decision.max_epochs = N
    launcher = Launcher()
    launcher.add_ref(resumed)
    launcher.initialize(device="cpu", snapshot=True)
    launcher.run()
    assert resumed.decision.epoch_number == N
    _assert_same_run(straight, resumed)


def _cli(argv, generator=None):
    """Runs the command line in this process; ``generator`` (a pickled
    generator 0) replaces the seeding, as a resume puts it back."""
    main = Main(argv)
    if generator is not None:
        main.seed_random = lambda: prng._generators.__setitem__(
            0, pickle.loads(generator))
    assert main.run() == Main.EXIT_SUCCESS
    return main


@pytest.mark.parametrize("how", ["pointer", "auto_resume"])
def test_cli_resume_writes_the_straight_results(
        tmp_path, f32_stream, generators_at_snapshot, how):
    common = ["--device", "cpu", "-r", "5", "root.mnist.learning_rate=0.1",
              "root.mnist.minibatch_size=200", "--snapshot-compression",
              "", "--snapshot-keep", "2",
              "root.common.snapshotter.time_interval=0",
              "root.common.snapshotter.interval=5"]
    # The straight run snapshots too (elsewhere): the same graph.
    straight = tmp_path / "straight.json"
    _cli([MNIST_PY, "--result-file", str(straight), "--snapshot-dir",
          str(tmp_path / "straight"), "root.mnist.max_epochs=3"] + common)
    snaps = tmp_path / "snaps"
    _cli([MNIST_PY, "--snapshot-dir", str(snaps),
          "root.mnist.max_epochs=2"] + common)
    link = str(snaps / "mnist_current.lnk")
    assert len(iter_generations(str(snaps), "mnist")) == 2
    generator = generators_at_snapshot[SnapshotterToFile.resolve(link)]
    resumed = tmp_path / "resumed.json"
    where = ["-s", link] if how == "pointer" else \
        ["--auto-resume", "--snapshot-dir", str(snaps)]
    main = _cli([MNIST_PY, "--result-file", str(resumed),
                 "--max-epochs", "3"] + where + common,
                generator=generator)
    assert main._snapshot_loaded
    got, want = (json.loads(p.read_text()) for p in (resumed, straight))
    for data in (got, want):
        data.pop("runtime")
    assert got == want
    assert want["results"]["epochs"] == 3
