"""Image dataset loaders (the JAX package's ``loader.image``).

* :class:`ImageDecoderMixin` — the host decode pipeline: PIL decode
  and color conversion, scale (stretched, or aspect-preserving on a
  background canvas), center crop, rotations (quarter turns exact,
  other angles through ``scipy.ndimage``), on the port's
  ``normalization`` registry;
* :class:`FileImageLoader` / :class:`AutoLabelFileImageLoader` /
  :class:`FileImageMSELoader` — device-resident: every image decoded at
  ``load_data`` into the full-batch originals (mirror and rotation
  augmentation of the train set, MSE target pairing);
* :class:`StreamedFileImageLoader` — directory-scale: only the file
  list is scanned at ``load_data``, images are decoded block by block
  by the stream loader's host pool (``loader/stream.py``).

The decode is the JAX package's code, so the same files give the same
arrays in both packages.  PIL is imported when an image is decoded;
without it the decode raises an ImportError naming the loader — there
is no other decoder.
"""

import os

import numpy

from ..error import BadFormatError
from ..normalization import normalizer_factory
from .fullbatch import FullBatchLoader
from .stream import StreamLoader

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif",
              ".tiff", ".ppm", ".webp")


class ImageDecoderMixin(object):
    """The image preprocessing pipeline shared by the resident
    (full-batch) and streamed image loaders: scale, center crop, color
    space, aspect padding, rotations."""

    def init_image_kwargs(self, kwargs):
        self.size = tuple(kwargs.get("size", (32, 32)))
        self.color_space = kwargs.get("color_space", "RGB")
        self.crop = kwargs.get("crop")
        self.mirror = kwargs.get("mirror", False)
        # Aspect-preserving scale + padding: when True the image is
        # scaled to FIT the target and the remainder filled with
        # ``background_color``; when False it is stretched.
        self.keep_aspect_ratio = kwargs.get("keep_aspect_ratio",
                                            False)
        self.background_color = kwargs.get("background_color", 0)
        # Rotation augmentation (``rotations`` — a tuple of radians;
        # the TRAIN set holds one variant PER LISTED ANGLE, so include
        # 0.0 to keep the unrotated originals — (0.0, a) doubles the
        # set, (a,) alone REPLACES it with rotated copies).
        rotations = kwargs.get("rotations", (0.0,))
        if not isinstance(rotations, tuple):
            raise TypeError("rotations must be a tuple (got %r)" %
                            (rotations,))
        for i, rot in enumerate(rotations):
            if not isinstance(rot, (int, float)):
                raise TypeError("rotations[%d] = %r is not a number" %
                                (i, rot))
            if abs(rot) > 2 * numpy.pi:
                raise ValueError(
                    "rotations[%d] = %s exceeds 2π radians" %
                    (i, rot))
        self.rotations = tuple(sorted(rotations))
        if self.rotations and 0.0 not in self.rotations:
            import logging
            logging.getLogger(type(self).__name__).warning(
                "rotations %s does not include 0.0 — the TRAIN set "
                "will contain ONLY rotated variants (one per listed "
                "angle), not the originals", self.rotations)
        ntype = kwargs.get("normalization_type", "none")
        self.normalizer = normalizer_factory(
            ntype, **kwargs.get("normalization_parameters", {}))

    @property
    def decoded_shape(self):
        """(h, w, c) a decoded sample comes out as."""
        w, h = self.crop if self.crop else self.size
        c = 1 if self.color_space == "L" else 3
        return (h, w, c)

    def _background(self, shape):
        bg = numpy.asarray(self.background_color,
                           dtype=numpy.float32)
        out = numpy.empty(shape, dtype=numpy.float32)
        out[...] = bg
        return out

    def rotate_image(self, arr, angle):
        """Rotates a decoded (h, w, c) array by ``angle`` radians
        around its center, background-filled.  Quarter turns are
        exact (numpy.rot90); arbitrary angles interpolate."""
        if not angle:
            return arr
        quarter = angle / (numpy.pi / 2.0)
        if abs(quarter - round(quarter)) < 1e-9:
            k = int(round(quarter)) % 4
            # The exact fast path must preserve (h, w, c): odd
            # quarter turns transpose the spatial dims, so non-square
            # images take the shape-preserving interpolated path.
            if k % 2 == 0 or arr.shape[0] == arr.shape[1]:
                return numpy.ascontiguousarray(
                    numpy.rot90(arr, k=k, axes=(0, 1)))
        from scipy import ndimage
        bg = float(numpy.mean(self.background_color))
        return ndimage.rotate(
            arr, numpy.degrees(angle), axes=(1, 0), reshape=False,
            mode="constant", cval=bg).astype(numpy.float32)

    def decode_image(self, path):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "%s decodes images with PIL (Pillow), which is not "
                "installed: %s" % (type(self).__name__, e)) from e
        with Image.open(path) as img:
            img = img.convert(self.color_space)
            if self.keep_aspect_ratio:
                tw, th = self.size
                scale = min(tw / img.width, th / img.height)
                nw = max(1, int(round(img.width * scale)))
                nh = max(1, int(round(img.height * scale)))
                img = img.resize((nw, nh))
                arr = numpy.asarray(img, dtype=numpy.float32)
                if arr.ndim == 2:
                    arr = arr[:, :, None]
                canvas = self._background((th, tw, arr.shape[2]))
                top = (th - nh) // 2
                left = (tw - nw) // 2
                canvas[top:top + nh, left:left + nw] = arr
                arr = canvas
            else:
                img = img.resize(self.size)
                arr = numpy.asarray(img, dtype=numpy.float32)
                if arr.ndim == 2:
                    arr = arr[:, :, None]
        if self.crop:
            cw, ch = self.crop
            h, w = arr.shape[:2]
            if ch > h or cw > w:
                # Crop larger than the image: pad with background
                # instead of failing.
                canvas = self._background((max(ch, h), max(cw, w),
                                           arr.shape[2]))
                canvas[(max(ch, h) - h) // 2:
                       (max(ch, h) - h) // 2 + h,
                       (max(cw, w) - w) // 2:
                       (max(cw, w) - w) // 2 + w] = arr
                arr = canvas
                h, w = arr.shape[:2]
            top, left = (h - ch) // 2, (w - cw) // 2
            arr = arr[top:top + ch, left:left + cw]
        return arr


class ImageLoaderBase(FullBatchLoader, ImageDecoderMixin):
    """Device-resident image loader base.

    kwargs: ``size`` (w, h) target scale; ``color_space`` "RGB"/"L";
    ``crop`` optional (w, h) center crop after scale; ``mirror`` adds
    horizontally-flipped copies of TRAIN samples;
    ``normalization_type`` + ``normalization_parameters`` choose a
    host normalizer from the registry.
    """

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(ImageLoaderBase, self).__init__(workflow, **kwargs)
        self.init_image_kwargs(kwargs)

    def _finalize(self, per_class):
        """per_class: {TEST/VALID/TRAIN: (list of arrays, list of
        labels)} → fullbatch originals in class order."""
        datas, labels = [], []
        lengths = [0, 0, 0]
        for cls in (0, 1, 2):
            arrs, labs = per_class.get(cls, ([], []))
            if cls == 2 and arrs and self.rotations != (0.0,):
                arrs = [self.rotate_image(a, rot)
                        for rot in self.rotations for a in arrs]
                labs = list(labs) * len(self.rotations)
            if cls == 2 and self.mirror and arrs:
                arrs = list(arrs) + [a[:, ::-1] for a in arrs]
                labs = list(labs) + list(labs)
            lengths[cls] = len(arrs)
            datas.extend(arrs)
            labels.extend(labs)
        if not datas:
            raise BadFormatError("%s: no images found" % self)
        data = numpy.stack(datas)
        self.normalizer.analyze(data[lengths[0] + lengths[1]:])
        data = self.normalizer.normalize(data)
        self.original_data.mem = data.astype(numpy.float32)
        self.original_labels.mem = numpy.asarray(labels,
                                                 dtype=numpy.int32)
        self.class_lengths = lengths


class FileListMixin(object):
    """Per-class path lists + auto-labeling, shared by the resident
    and streamed file loaders."""

    def init_path_kwargs(self, kwargs):
        self.paths = {0: kwargs.get("test_paths") or [],
                      1: kwargs.get("validation_paths") or [],
                      2: kwargs.get("train_paths") or []}
        self._label_map = {}

    def get_label_from_path(self, path):
        """Default auto-label: the parent directory name, interned to
        a dense int id."""
        key = os.path.basename(os.path.dirname(path))
        return self._label_map.setdefault(key, len(self._label_map))

    def _expand(self, entries):
        out = []
        for e in entries:
            if isinstance(e, tuple):
                out.append(e)
            elif os.path.isdir(e):
                for root_, _dirs, files in sorted(os.walk(e)):
                    for f in sorted(files):
                        if f.lower().endswith(IMAGE_EXTS):
                            p = os.path.join(root_, f)
                            out.append((p, None))
            else:
                out.append((e, None))
        return out


class FileImageLoader(ImageLoaderBase, FileListMixin):
    """Explicit file lists per class.

    kwargs ``test_paths``/``validation_paths``/``train_paths``: lists
    whose entries are image paths or (path, label) pairs; plain paths
    get label from ``get_label_from_path`` (filename prefix by
    default)."""

    MAPPING = "file_image"

    def __init__(self, workflow, **kwargs):
        super(FileImageLoader, self).__init__(workflow, **kwargs)
        self.init_path_kwargs(kwargs)

    def load_data(self):
        per_class = {}
        for cls, entries in self.paths.items():
            arrs, labs = [], []
            for path, label in self._expand(entries):
                arrs.append(self.decode_image(path))
                labs.append(self.get_label_from_path(path)
                            if label is None else label)
            per_class[cls] = (arrs, labs)
        self._finalize(per_class)

    @property
    def n_classes(self):
        return len(self._label_map) or \
            int(self.original_labels.mem.max()) + 1


class AutoLabelFileImageLoader(FileImageLoader):
    """Directory-per-label datasets: pass class directories; labels
    are the subdirectory names."""

    MAPPING = "auto_label_file_image"


class FileImageMSELoader(FileImageLoader):
    """Image→image regression datasets: each input image is paired
    with a TARGET
    image served through ``minibatch_targets`` for EvaluatorMSE
    (denoising, super-resolution, autoencoder ground truths).

    kwargs: ``target_paths`` — a directory (targets matched to inputs
    by filename) or a callable ``path -> target_path``;
    ``target_size`` — target scale, defaulting to ``size``.
    """

    MAPPING = "file_image_mse"

    def __init__(self, workflow, **kwargs):
        super(FileImageMSELoader, self).__init__(workflow, **kwargs)
        self.target_paths = kwargs.get("target_paths")
        self.target_size = tuple(kwargs.get("target_size",
                                            self.size))
        if self.target_paths is None:
            raise BadFormatError(
                "%s requires target_paths (a directory or a "
                "path->path callable)" % self)
        if self.mirror or self.rotations != (0.0,):
            # Fail before any decode work: the target would need the
            # same augmentation, which this loader does not do.
            raise BadFormatError(
                "mirror/rotation augmentation is not supported with "
                "MSE targets")

    def target_path_for(self, path):
        if callable(self.target_paths):
            return self.target_paths(path)
        candidate = os.path.join(self.target_paths,
                                 os.path.basename(path))
        if not os.path.isfile(candidate):
            raise BadFormatError("no target image for %s (looked at "
                                 "%s)" % (path, candidate))
        return candidate

    def decode_target(self, path):
        size, self.size = self.size, self.target_size
        try:
            return self.decode_image(self.target_path_for(path))
        finally:
            self.size = size

    def load_data(self):
        per_class = {}
        targets = []
        for cls in (0, 1, 2):
            arrs, labs = [], []
            for path, label in self._expand(self.paths[cls]):
                arrs.append(self.decode_image(path))
                targets.append(self.decode_target(path))
                labs.append(self.get_label_from_path(path)
                            if label is None else label)
            per_class[cls] = (arrs, labs)
        self._finalize(per_class)
        # Targets ride the SAME normalizer transform as the inputs —
        # a regression target left at raw scale while inputs are
        # normalized would silently shift the learning objective.
        self.original_targets.mem = self.normalizer.normalize(
            numpy.stack(targets)).astype(numpy.float32)


class StreamedFileImageLoader(StreamLoader, ImageDecoderMixin,
                              FileListMixin):
    """Directory-scale image streaming (datasets larger than memory):
    only the file LIST is scanned at ``load_data``; images are decoded
    block by block by the host worker pool and uploaded while the
    previous block trains (see loader/stream.py).

    Same kwargs as :class:`FileImageLoader` (``test_paths`` /
    ``validation_paths`` / ``train_paths``, entries are paths,
    directories, or (path, label) pairs) plus the streaming knobs
    (``decode_workers``, ``prefetch``).  Normalizer state is analyzed
    over up to ``analysis_samples`` (default 256) train images at
    load time — a bounded pass before streaming.  ``mirror`` is
    unsupported (augment downstream instead of doubling the index
    space)."""

    MAPPING = "streamed_file_image"

    def __init__(self, workflow, **kwargs):
        super(StreamedFileImageLoader, self).__init__(workflow,
                                                      **kwargs)
        self.init_image_kwargs(kwargs)
        if self.mirror or self.rotations != (0.0,):
            raise BadFormatError(
                "mirror/rotation augmentation is not supported by "
                "the streamed loader")
        self.init_path_kwargs(kwargs)
        self.analysis_samples = int(kwargs.get("analysis_samples",
                                               256))
        self.files = []   # global index -> (path, label)

    def load_data(self):
        self.files = []
        lengths = [0, 0, 0]
        for cls in (0, 1, 2):
            entries = self._expand(self.paths[cls])
            for path, label in entries:
                self.files.append(
                    (path, self.get_label_from_path(path)
                     if label is None else label))
            lengths[cls] = len(entries)
        if not self.files:
            raise BadFormatError("%s: no images found" % self)
        self.class_lengths = lengths
        self.sample_shape = self.decoded_shape
        self.sample_dtype = numpy.float32
        # Bounded normalizer analysis, ALWAYS at load time (the lazy
        # analyze-on-first-normalize path is not thread-safe under the
        # decode pool).  Train split preferred; an inference-only
        # dataset analyzes over whatever split it has.
        if type(self.normalizer).__name__ != "NoneNormalizer":
            for cls in (2, 1, 0):
                if lengths[cls] == 0:
                    continue
                start = sum(lengths[:cls])
                take = min(self.analysis_samples, lengths[cls])
                sample = numpy.stack([
                    self.decode_image(self.files[start + i][0])
                    for i in range(take)])
                self.normalizer.analyze(sample)
                break
        self.info("streaming %d images (%d/%d/%d test/val/train), "
                  "%d classes", len(self.files), *lengths,
                  self.n_classes)

    @property
    def n_classes(self):
        # Explicit (path, label) entries may carry ids beyond the
        # auto-label map — count from the materialized labels.
        return 1 + max(lab for _p, lab in self.files)

    def dataset_labels(self):
        return self.slice_labels_by_class(numpy.array(
            [lab for _p, lab in self.files], dtype=numpy.int32))

    def materialize(self, index):
        path, label = self.files[index]
        arr = self.decode_image(path)
        arr = self.normalizer.normalize(arr[None])[0]
        return arr.astype(numpy.float32), label
