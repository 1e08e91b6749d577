"""The port's streamed loader (``veles_tpu_torch.loader.stream``) and
``StreamedImagenetLoader`` against the full-batch loader and against
the JAX package, on the CPU.

Every gate of ``tests/test_stream.py`` runs on the port but the
master/worker one (``apply_data_from_master`` waits for the port's
distributed data plane): streamed == full-batch, prefetch off == on,
the published flags, the snapshot requeue, the streamed ImageNet loader
from disk, the streamed file-image loader and the rebuild that drops
the staged block.  The port holds the streamed runs to the resident
runs BIT FOR BIT (the JAX package holds them at rtol 1e-5): the
minibatches are the same bytes and the step is the same code, only the
feed differs.  Against the JAX package, a streamed train tick from the
same weights (carried by ``params_from_numpy``) and minibatch, at
``precision_level`` 1: parameters within rtol 1e-5, atol 1e-7 (the
same float32 math, its sums in another order).
"""

import os
import pickle

import numpy
import pytest
import torch

import veles_tpu.prng as jprng
from veles_tpu.config import root as jroot
from veles_tpu.launcher import Launcher as JLauncher
from veles_tpu.loader.stream import StreamLoader as JStreamLoader
from veles_tpu.znicz.samples.imagenet import \
    StreamedImagenetLoader as JStreamedImagenet
from veles_tpu.znicz.samples.mnist import MnistWorkflow as JMnist

from veles_tpu_torch import prng, resilience
from veles_tpu_torch.accelerated_units import params_from_numpy
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.loader.stream import StreamLoader
from veles_tpu_torch.snapshotter import SnapshotterToFile
from veles_tpu_torch.znicz.samples.imagenet import (
    AlexNetWorkflow, ImagenetLoader, StreamedImagenetLoader)
from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow

torch.set_num_threads(2)

N_TRAIN, N_VALID, DIM, CLASSES = 600, 100, 64, 10


def _dataset():
    rng = numpy.random.RandomState(7)
    n = N_TRAIN + N_VALID
    labels = rng.randint(0, CLASSES, size=n).astype(numpy.int32)
    centers = rng.rand(CLASSES, DIM).astype(numpy.float32)
    data = centers[labels] + rng.normal(
        0, 0.1, (n, DIM)).astype(numpy.float32)
    return data.astype(numpy.float32), labels


DATA, LABELS = _dataset()


class SyntheticFullBatch(FullBatchLoader):
    hide_from_registry = True

    def load_data(self):
        self.original_data.mem = DATA.copy()
        self.original_labels.mem = LABELS.copy()
        self.class_lengths = [0, N_VALID, N_TRAIN]


class SyntheticStream(StreamLoader):
    """Streams the same arrays row by row — nothing resident."""

    hide_from_registry = True

    def load_data(self):
        self.class_lengths = [0, N_VALID, N_TRAIN]
        self.sample_shape = (DIM,)
        self.sample_dtype = numpy.float32

    def fill_rows(self, indices, out_data, out_labels):
        out_data[...] = DATA[indices]
        out_labels[...] = LABELS[indices]


class JSyntheticStream(JStreamLoader):
    hide_from_registry = True

    def load_data(self):
        self.class_lengths = [0, N_VALID, N_TRAIN]
        self.sample_shape = (DIM,)
        self.sample_dtype = numpy.float32

    def fill_rows(self, indices, out_data, out_labels):
        out_data[...] = DATA[indices]
        out_labels[...] = LABELS[indices]


def _train(loader_cls, seed=1234, max_epochs=3, ticks=4, **kwargs):
    prng.reset()
    prng.get(0).seed(seed)
    launcher = Launcher()
    wf = MnistWorkflow(launcher, layers=(32, CLASSES), minibatch_size=50,
                       max_epochs=max_epochs, learning_rate=0.1,
                       ticks_per_dispatch=ticks, loader_cls=loader_cls,
                       **kwargs)
    launcher.initialize(device="cpu")
    launcher.run()
    return wf


def _state(wf):
    return {n: v.devmem.clone() for n, v in
            list(wf.compiler._param_vecs.items()) +
            list(wf.compiler._state_vecs.items())}


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("ticks", [4, 1])
def test_streamed_matches_fullbatch_exactly(ticks):
    """Same data, same seed: the streamed pipeline reproduces the
    resident one's training bit for bit — weights, optimizer slots,
    accumulators and the decision."""
    full = _train(SyntheticFullBatch, ticks=ticks)
    stream = _train(SyntheticStream, ticks=ticks)
    assert stream.decision.epoch_number == full.decision.epoch_number == 3
    _assert_bit_equal(_state(stream), _state(full))
    assert stream.decision.get_metric_values() == \
        full.decision.get_metric_values()
    assert stream.decision.min_validation_err < 0.2


@pytest.mark.parametrize("ticks", [4, 1])
def test_streamed_without_prefetch_matches(ticks):
    """prefetch=False (strictly synchronous) walks the same path."""
    sync = _train(SyntheticStream, ticks=ticks,
                  loader_config={"prefetch": False})
    pre = _train(SyntheticStream, ticks=ticks)
    _assert_bit_equal(_state(sync), _state(pre))


def _manual_loader(seed=5, **kwargs):
    prng.reset()
    prng.get(0).seed(seed)
    loader = SyntheticStream(DummyWorkflow(), minibatch_size=50, **kwargs)
    loader.initialize(device=None)
    return loader


def test_published_flags_describe_dispatched_block():
    """With prefetch on the walk runs a block ahead, but the flags the
    graph reads after each run() describe the dispatched block."""
    loader = _manual_loader()
    ticks = 4
    seen = []
    for _ in range(40):
        entry = loader._staged_ or loader._produce_block(ticks)
        loader._staged_ = None
        loader._apply_flags(entry["flags"])
        staged = loader._produce_block(ticks)
        loader._apply_flags(entry["flags"])
        loader._staged_ = staged
        seen.append((loader.minibatch_class, loader.epoch_number,
                     loader.epoch_ended))
        if loader.epoch_ended:
            break
    classes = [c for c, _e, _d in seen]
    assert classes[0] == VALID
    assert TRAIN in classes
    assert seen[-1][2] is True
    assert seen[-1][1] == 1
    assert all(e == 0 for _c, e, _d in seen[:-1])


def test_snapshot_requeues_staged_block():
    """The prefetched (undispatched) block is not lost across a pickle:
    its indices land in failed_minibatches."""
    loader = _manual_loader()
    loader._staged_ = loader._produce_block(4)
    staged = [idx for idx, _c in loader._staged_["in_flight"]]
    requeued = loader.__getstate__()["failed_minibatches"]
    assert len(requeued) >= len(staged)
    flat = {int(i) for idx, _c in requeued for i in idx}
    for idx in staged:
        assert {int(i) for i in idx} <= flat


def test_rebuild_drops_staged_block():
    loader = _manual_loader()
    loader._staged_ = loader._produce_block(4)
    assert loader._staged_ is not None
    loader.invalidate_staged()
    assert loader._staged_ is None


def test_block_fill_pads_with_zeros_and_uses_the_pool():
    """A one-tick block splits its rows over the decode pool; the padded
    rows of a short minibatch are zeros, whatever the staging held."""
    loader = _manual_loader(decode_workers=3)
    idxs = numpy.zeros((1, 50), dtype=numpy.int32)
    idxs[0, :7] = numpy.arange(100, 107)
    masks = numpy.zeros((1, 50), dtype=numpy.float32)
    masks[0, :7] = 1.0
    calls = []
    fill = loader.fill_rows

    def counting(indices, out_data, out_labels):
        calls.append(len(indices))
        fill(indices, out_data, out_labels)

    loader.fill_rows = counting
    data, labels = loader._fill_block(idxs, masks)
    assert sorted(calls) == [1, 3, 3]
    numpy.testing.assert_array_equal(data.numpy()[0, :7],
                                     DATA[100:107])
    numpy.testing.assert_array_equal(labels.numpy()[0, :7],
                                     LABELS[100:107])
    assert not data.numpy()[0, 7:].any() and not labels.numpy()[0, 7:].any()


def test_execute_block_takes_device_tensors_as_they_are():
    """Blocks already on the step's device enter the step without a
    copy; numpy index blocks are uploaded; a tensor on another device
    raises instead of taking a trip through the host."""
    wf = _train(SyntheticStream, max_epochs=1, ticks=1)
    compiler = wf.compiler
    loader = wf.loader
    entry = loader._produce_block(1)
    blocks = loader._take(entry)
    seen = {}
    tick = compiler._tick

    def spy(batch, training, block=False, hypers=None):
        seen.update({k: v.data_ptr() for k, v in batch.items()})
        return tick(batch, training, block, hypers)

    compiler._tick = spy
    compiler.execute_block(blocks, True)
    for key, tensor in blocks.items():
        assert seen[key] == tensor[0].data_ptr(), key
    meta = {k: v.to("meta") for k, v in blocks.items()}
    with pytest.raises(ValueError, match="the step runs on"):
        compiler.execute_block(meta, True)


def test_step_nan_poisons_a_tensor_block():
    """The step.nan chaos point writes NaN into the first tick of a
    staged block that is a tensor (not only a numpy index block): the
    train epoch reports a non-finite tick."""
    resilience.install("step.nan@3")
    try:
        wf = _train(SyntheticStream, max_epochs=1, ticks=1,
                    guardian_config={"policy": "skip"})
    finally:
        resilience.reset()
    assert wf.decision.epoch_nonfinite[TRAIN] == 1.0


# -- against the JAX package -----------------------------------------------

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


def test_streamed_tick_matches_jax(f32_engines):
    """The validation blocks and one train block streamed through both
    packages from the same weights: the same minibatch bytes, and the
    parameters after the train tick within rtol 1e-5, atol 1e-7."""
    kw = dict(layers=(32, CLASSES), minibatch_size=50, max_epochs=3,
              learning_rate=0.1, ticks_per_dispatch=1)
    jprng.reset()
    jprng.get(0).seed(99)
    jl = JLauncher()
    jwf = JMnist(jl, loader_cls=JSyntheticStream, **kw)
    jl.initialize()
    prng.reset()
    prng.get(0).seed(99)
    tl = Launcher()
    twf = MnistWorkflow(tl, loader_cls=SyntheticStream, **kw)
    tl.initialize(device="cpu")
    weights = {}
    for unit in jwf.units:
        for attr, vec in dict(getattr(unit, "trainables", {}) or {}).items():
            vec.map_read()
            weights.setdefault(unit.name, {})[attr] = numpy.array(vec.mem)
    params_from_numpy(twf, weights)
    for _ in range(3):   # two validation ticks, then a train tick
        jwf.loader.run()
        twf.loader.run()
        assert jwf.loader.minibatch_class == twf.loader.minibatch_class
        for j, t in ((jwf.loader.minibatch_indices,
                      twf.loader.minibatch_indices),):
            assert numpy.array_equal(j.mem, t.mem)
    assert twf.loader.minibatch_class == TRAIN
    for unit in jwf.units:
        for attr, vec in dict(getattr(unit, "trainables", {}) or {}).items():
            vec.map_read()
            got = twf[unit.name].trainables[attr]
            got.map_read()
            numpy.testing.assert_allclose(got.mem, vec.mem, rtol=1e-5,
                                          atol=1e-7, err_msg=unit.name)


# -- the streamed ImageNet loader ------------------------------------------

TINY_LAYERS = [
    {"type": "conv_str",
     "->": {"n_kernels": 8, "kx": 5, "ky": 5, "sliding": (2, 2),
            "weights_stddev": 0.05},
     "<-": {"learning_rate": 0.02}},
    {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5, "k": 2.0}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2, "sliding": (2, 2)}},
    {"type": "softmax", "->": {"output_sample_shape": (4,),
                               "weights_stddev": 0.05},
     "<-": {"learning_rate": 0.02}},
]
SIM = {"sim_train": 256, "sim_valid": 64, "sim_image_size": 24,
       "sim_classes": 4}


def _alexnet(loader_cls, seed=42, max_epochs=2, ticks=4, **loader_config):
    prng.reset()
    prng.get(0).seed(seed)
    launcher = Launcher()
    wf = AlexNetWorkflow(launcher, layers=TINY_LAYERS, minibatch_size=32,
                         ticks_per_dispatch=ticks, max_epochs=max_epochs,
                         n_classes=4, loader_cls=loader_cls,
                         loader_config=loader_config)
    launcher.initialize(device="cpu")
    return launcher, wf


def test_streamed_imagenet_loader_from_disk(tmp_path):
    """The synthetic fallback is written to disk and memmapped — nothing
    resident — and a conv workflow trains from the stream."""
    launcher, wf = _alexnet(StreamedImagenetLoader,
                            cache_dir=str(tmp_path), **SIM)
    loader = wf.loader
    assert os.path.isfile(os.path.join(str(tmp_path), "train_data.npy"))
    assert not hasattr(loader, "original_data")
    assert isinstance(loader._sources_[1][0], numpy.memmap)
    launcher.run()
    assert wf.decision.epoch_number == 2
    assert loader.mean.mem.shape == (24, 24, 3)
    assert wf.decision.min_validation_err < 0.9


def test_streamed_imagenet_files_and_statistics_are_jax_bytes(tmp_path):
    """The port writes the JAX package's synthetic files byte for byte,
    and caches the same mean/rdisp beside the train file; a second load
    reads the cache, and a corrupt cache is recomputed."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jl = JStreamedImagenet(None, cache_dir=str(jdir), **SIM)
    tl = StreamedImagenetLoader(None, cache_dir=str(tdir), **SIM)
    for a, b in zip(jl._write_synthetic(), tl._write_synthetic()):
        assert open(a, "rb").read() == open(b, "rb").read(), b
    train = str(tdir / "train_data.npy")
    mean, rdisp = tl._cached_mean_disp(train,
                                       numpy.load(train, mmap_mode="r"))
    jmean, jrdisp = jl._cached_mean_disp(
        str(jdir / "train_data.npy"),
        numpy.load(str(jdir / "train_data.npy"), mmap_mode="r"))
    assert numpy.array_equal(mean, jmean)
    assert numpy.array_equal(rdisp, jrdisp)
    cache = train + ".meandisp.npz"
    assert os.path.isfile(cache)
    assert not os.path.exists(cache + ".tmp.npz")
    with numpy.load(cache) as z:
        assert numpy.array_equal(z["mean"], mean)
    with open(cache, "wb") as fout:
        fout.write(b"not an npz")
    again = tl._cached_mean_disp(train, numpy.load(train, mmap_mode="r"))
    assert numpy.array_equal(again[0], mean)


@pytest.mark.parametrize("prefetch", [True, False])
def test_streamed_imagenet_equals_resident_on_the_same_files(
        tmp_path, prefetch):
    """The streamed and the resident ImageNet loaders read the same four
    .npy files: two epochs train to the same bits (phase 6c of
    chip_smoke.py holds this at 227 px on the card)."""
    writer = StreamedImagenetLoader(
        None, cache_dir=str(tmp_path / "imagenet"), **SIM)
    writer._write_synthetic()
    saved = root.common.dirs.get("datasets")
    root.common.dirs.datasets = str(tmp_path)
    try:
        runs = []
        for cls, cfg in ((ImagenetLoader, {}),
                         (StreamedImagenetLoader, {"prefetch": prefetch})):
            launcher, wf = _alexnet(cls, ticks=1, **cfg)
            launcher.run()
            runs.append(wf)
    finally:
        if saved is None:
            root.common.dirs.__dict__.pop("datasets", None)
        else:
            root.common.dirs.datasets = saved
    resident, streamed = runs
    assert resident.loader.class_lengths == streamed.loader.class_lengths
    _assert_bit_equal(_state(streamed), _state(resident))
    assert streamed.decision.get_metric_values() == \
        resident.decision.get_metric_values()


def test_streamed_snapshot_resumes_the_staged_block(tmp_path):
    """A snapshot taken mid-epoch with a block staged: the resumed
    workflow serves the requeued block again and its train tick equals
    the live one bit for bit (generator 0 put back as at the
    snapshot)."""
    launcher, wf = _alexnet(StreamedImagenetLoader, ticks=1,
                            cache_dir=str(tmp_path / "data"), **SIM)
    for _ in range(4):
        wf.loader.run()
    staged = [idx.copy() for idx, _ in wf.loader._staged_["in_flight"]]
    assert wf.loader._staged_["flags"]["minibatch_class"] == TRAIN
    gen = pickle.dumps(prng.get(0))
    snap = SnapshotterToFile(wf, directory=str(tmp_path / "snap"),
                             prefix="imagenet", compression="",
                             time_interval=0.0)
    snap.initialize()
    snap.export()
    wf.loader.run()
    live = _state(wf)
    resumed = SnapshotterToFile.import_(snap.destination)
    prng._generators[0] = pickle.loads(gen)
    launcher2 = Launcher()
    launcher2.add_ref(resumed)
    launcher2.initialize(device="cpu", snapshot=True)
    assert [i.tolist() for i, _ in resumed.loader.failed_minibatches] == \
        [i.tolist() for i in staged]
    resumed.loader.run()
    assert [i.tolist() for i, _ in resumed.loader._in_flight_][:1] == \
        [staged[0].tolist()]
    got = _state(resumed)
    for name in wf.compiler._param_vecs:
        assert torch.equal(got[name], live[name]), name


def test_streamed_file_image_loader(tmp_path):
    """Directory-scale streaming: a tree of images is scanned (the list
    only), decoded block by block by the pool, and a workflow trains
    from the stream."""
    from PIL import Image
    from veles_tpu_torch.loader.image import StreamedFileImageLoader
    rng = numpy.random.RandomState(3)
    for split, n_per in (("train", 12), ("valid", 4)):
        for cls, shade in (("dark", 40), ("light", 200)):
            d = tmp_path / split / cls
            d.mkdir(parents=True)
            for i in range(n_per):
                arr = numpy.clip(rng.normal(
                    shade, 25, (10, 10, 3)), 0, 255).astype("uint8")
                Image.fromarray(arr).save(d / ("%d.png" % i))
    prng.reset()
    prng.get(0).seed(11)
    launcher = Launcher()
    wf = MnistWorkflow(
        launcher, layers=(8, 2), minibatch_size=8, max_epochs=3,
        learning_rate=0.05, ticks_per_dispatch=2,
        loader_cls=StreamedFileImageLoader,
        loader_config={
            "train_paths": [str(tmp_path / "train" / "dark"),
                            str(tmp_path / "train" / "light")],
            "validation_paths": [str(tmp_path / "valid" / "dark"),
                                 str(tmp_path / "valid" / "light")],
            "size": (8, 8),
            "normalization_type": "linear"})
    launcher.initialize(device="cpu")
    loader = wf.loader
    assert loader.class_lengths == [0, 8, 24]
    assert loader.n_classes == 2
    assert loader.sample_shape == (8, 8, 3)
    launcher.run()
    assert wf.decision.epoch_number == 3
    assert wf.decision.min_validation_err < 0.3
