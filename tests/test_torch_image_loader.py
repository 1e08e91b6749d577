"""The port's image loaders (``veles_tpu_torch.loader.image``) against
the JAX package's, on PNGs written with PIL in ``tmp_path``.

Every test of ``tests/test_loaders.py`` and
``tests/test_loader_longtail.py`` for the file image loaders runs on
the port — auto-labels, mirror, rotations (quarter turns exact), their
validation, non-square targets, crop padding, MSE target pairing and
its guards — and each builds the same loader in both packages: the
decoded, augmented and normalized arrays and the labels must be
identical (the decode is the same numpy and PIL code).
"""

import math
import sys

import numpy
import pytest

from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.error import BadFormatError as JBadFormatError
import veles_tpu.loader.image as jimage

from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.error import BadFormatError
import veles_tpu_torch.loader.image as timage


@pytest.fixture
def image_tree(tmp_path):
    from PIL import Image
    rng = numpy.random.RandomState(0)
    for cls_name in ("cats", "dogs"):
        d = tmp_path / "train" / cls_name
        d.mkdir(parents=True)
        for i in range(4):
            arr = rng.randint(0, 255, (20, 24, 3)).astype("uint8")
            Image.fromarray(arr).save(d / ("img%d.png" % i))
    return tmp_path


def _write_png(path, arr):
    from PIL import Image
    Image.fromarray(numpy.asarray(arr).astype("uint8")).save(path)


def _both(name, load=False, **kwargs):
    """The loader class ``name`` built and initialized (or, with
    ``load``, only load_data'ed) in both packages; asserts identical
    originals and returns the port's loader."""
    loaders = []
    for mod, wf in ((jimage, JDummyWorkflow()), (timage, DummyWorkflow())):
        loader = getattr(mod, name)(wf, **kwargs)
        if load:
            loader.load_data()
        elif mod is timage:
            loader.initialize(device=None)
        else:
            loader.initialize()
        loaders.append(loader)
    jl, tl = loaders
    assert tl.class_lengths == jl.class_lengths
    for attr in ("original_data", "original_labels", "original_targets"):
        want, got = getattr(jl, attr), getattr(tl, attr)
        assert bool(want) == bool(got), attr
        if want:
            assert got.mem.dtype == want.mem.dtype, attr
            assert numpy.array_equal(got.mem, want.mem), attr
    return tl


def test_file_image_loader(image_tree):
    loader = _both("AutoLabelFileImageLoader",
                   train_paths=[str(image_tree / "train")],
                   size=(16, 16), minibatch_size=4,
                   normalization_type="range_linear")
    assert loader.class_lengths == [0, 0, 8]
    assert loader.original_data.shape == (8, 16, 16, 3)
    assert set(loader.original_labels.mem) == {0, 1}
    assert loader.original_data.mem.min() >= -1.0
    assert loader.original_data.mem.max() <= 1.0
    assert loader.n_classes == 2


def test_image_loader_mirror(image_tree):
    loader = _both("AutoLabelFileImageLoader",
                   train_paths=[str(image_tree / "train")],
                   size=(16, 16), minibatch_size=4, mirror=True)
    assert loader.class_lengths == [0, 0, 16]
    data = loader.original_data.mem
    numpy.testing.assert_array_equal(data[8:], data[:8, :, ::-1])


def test_image_loader_rotations(image_tree):
    """Rotations inflate the TRAIN set with rotated copies; quarter
    turns are exact; labels replicate per rotation."""
    loader = _both("AutoLabelFileImageLoader",
                   train_paths=[str(image_tree / "train")],
                   size=(16, 16), minibatch_size=4,
                   rotations=(0.0, math.pi / 2, 0.1))
    assert loader.class_lengths == [0, 0, 24]
    data = loader.original_data.mem
    numpy.testing.assert_allclose(
        data[16:24], numpy.rot90(data[:8], k=1, axes=(1, 2)), rtol=1e-6)
    labs = loader.original_labels.mem
    assert list(labs[:8]) == list(labs[8:16]) == list(labs[16:24])


def test_image_loader_rotations_validate():
    with pytest.raises(TypeError):
        timage.AutoLabelFileImageLoader(DummyWorkflow(), train_paths=[],
                                        rotations=[0.0])
    with pytest.raises(ValueError):
        timage.AutoLabelFileImageLoader(DummyWorkflow(), train_paths=[],
                                        rotations=(7.0,))


def test_rotation_nonsquare_keeps_shape(image_tree):
    loader = _both("AutoLabelFileImageLoader",
                   train_paths=[str(image_tree / "train")],
                   size=(24, 16), minibatch_size=4,
                   rotations=(0.0, math.pi / 2))
    assert loader.class_lengths == [0, 0, 16]
    assert loader.original_data.shape[1:] == (16, 24, 3)


def test_keep_aspect_ratio_grayscale_and_crop(image_tree, tmp_path):
    """Aspect-preserving scale on a background canvas, the L color
    space, and a crop larger than the image padded with the
    background."""
    loader = _both("AutoLabelFileImageLoader",
                   train_paths=[str(image_tree / "train")],
                   size=(16, 12), keep_aspect_ratio=True,
                   background_color=9, color_space="L", crop=(14, 10))
    assert loader.original_data.shape == (8, 10, 14, 1)
    _write_png(tmp_path / "tiny.png", numpy.full((8, 8, 3), 200))
    loader = _both("FileImageLoader", load=True, size=(8, 8),
                   crop=(16, 16), background_color=7,
                   train_paths=[(str(tmp_path / "tiny.png"), 0)])
    img = loader.original_data.mem[0]
    assert img.shape == (16, 16, 3)
    assert img[8, 8, 0] == 200
    assert img[0, 0, 0] == 7


def _mse_tree(tmp_path):
    inputs, targets = tmp_path / "in", tmp_path / "gt"
    inputs.mkdir()
    targets.mkdir()
    for i in range(3):
        _write_png(inputs / ("img%d.png" % i), numpy.full((8, 8, 3), 50 + i))
        _write_png(targets / ("img%d.png" % i),
                   numpy.full((8, 8, 3), 150 + i))
    return inputs, targets


def test_mse_targets_paired_by_filename(tmp_path):
    inputs, targets = _mse_tree(tmp_path)
    loader = _both("FileImageMSELoader", load=True, size=(8, 8),
                   train_paths=[str(inputs)], target_paths=str(targets))
    assert loader.original_data.mem.shape == (3, 8, 8, 3)
    assert loader.original_targets.mem.shape == (3, 8, 8, 3)
    for i in range(3):
        assert loader.original_data.mem[i, 0, 0, 0] == 50 + i
        assert loader.original_targets.mem[i, 0, 0, 0] == 150 + i
    # A callable maps each input to its target.
    loader = _both("FileImageMSELoader", load=True, size=(8, 8),
                   train_paths=[str(inputs)],
                   target_paths=lambda p: p.replace("/in/", "/gt/"))
    assert loader.original_targets.mem[2, 0, 0, 0] == 152


def test_mse_targets_share_input_normalization(tmp_path):
    inputs, targets = tmp_path / "in2", tmp_path / "gt2"
    inputs.mkdir()
    targets.mkdir()
    ramp = numpy.arange(48).reshape(4, 4, 3) * 5.0
    _write_png(inputs / "a.png", ramp)
    _write_png(targets / "a.png", 235 - ramp)
    loader = _both("FileImageMSELoader", load=True, size=(4, 4),
                   normalization_type="linear", train_paths=[str(inputs)],
                   target_paths=str(targets))
    assert loader.original_data.mem.max() <= 1.001
    assert loader.original_targets.mem.max() <= 1.1


def test_mse_guards(image_tree, tmp_path):
    inputs = tmp_path / "in"
    inputs.mkdir()
    (tmp_path / "gt").mkdir()
    _write_png(inputs / "a.png", numpy.zeros((4, 4, 3)))
    loader = timage.FileImageMSELoader(
        DummyWorkflow(), size=(4, 4), train_paths=[str(inputs)],
        target_paths=str(tmp_path / "gt"))
    with pytest.raises(BadFormatError):
        loader.load_data()
    with pytest.raises(BadFormatError):
        timage.FileImageMSELoader(DummyWorkflow(), mirror=True,
                                  target_paths=str(tmp_path))
    with pytest.raises(BadFormatError):
        timage.FileImageMSELoader(DummyWorkflow())
    with pytest.raises(BadFormatError):
        timage.FileImageMSELoader(
            DummyWorkflow(), train_paths=[str(image_tree / "train")],
            target_paths=str(tmp_path), rotations=(0.0, 0.1))
    with pytest.raises(BadFormatError):
        timage.StreamedFileImageLoader(
            DummyWorkflow(), train_paths=[str(image_tree / "train")],
            rotations=(0.0, math.pi / 2))
    with pytest.raises(JBadFormatError):
        jimage.FileImageMSELoader(JDummyWorkflow())


def test_streamed_file_image_samples_match_jax(image_tree):
    """The streamed loader's file list, labels, normalizer analysis and
    materialized samples are the JAX package's."""
    kwargs = dict(train_paths=[str(image_tree / "train")], size=(12, 10),
                  normalization_type="mean_disp", analysis_samples=5)
    jl = jimage.StreamedFileImageLoader(JDummyWorkflow(), **kwargs)
    tl = timage.StreamedFileImageLoader(DummyWorkflow(), **kwargs)
    jl.load_data()
    tl.load_data()
    assert tl.files == jl.files
    assert tl.class_lengths == jl.class_lengths == [0, 0, 8]
    assert tl.sample_shape == (10, 12, 3)
    for index in range(8):
        jarr, jlab = jl.materialize(index)
        tarr, tlab = tl.materialize(index)
        assert tlab == jlab
        assert numpy.array_equal(tarr, jarr)


def test_decode_without_pil_names_the_loader(image_tree, monkeypatch):
    """Without PIL the decode raises an ImportError that names the
    loader — there is no other decoder and no silent skip."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    loader = timage.AutoLabelFileImageLoader(
        DummyWorkflow(), train_paths=[str(image_tree / "train")],
        size=(16, 16))
    with pytest.raises(ImportError, match="AutoLabelFileImageLoader"):
        loader.load_data()
