"""Audio dataset loaders (the JAX package's ``loader.audio``).

:func:`decode_audio` binds libsndfile through ``ctypes`` when the system
library exists (flac, ogg, aiff, ...), and otherwise reads PCM WAV with
the standard library's ``wave`` module.  :class:`AudioFileLoader` slices
the decoded streams into fixed-length windows, each window one sample
of the device-resident full batch; :class:`SpectrogramLoader` turns
each window into log-magnitude STFT features once, at load time, in
numpy.
"""

import ctypes
import ctypes.util
import os

import numpy

from ..error import BadFormatError
from .fullbatch import FullBatchLoader
from .image import FileImageLoader

AUDIO_EXTS = (".wav", ".flac", ".ogg", ".aiff", ".aif", ".au",
              ".snd", ".voc")

_sndfile = None
_sndfile_checked = False


class _SFInfo(ctypes.Structure):
    # sf_info layout (libsndfile sndfile.h)
    _fields_ = [("frames", ctypes.c_int64),
                ("samplerate", ctypes.c_int),
                ("channels", ctypes.c_int),
                ("format", ctypes.c_int),
                ("sections", ctypes.c_int),
                ("seekable", ctypes.c_int)]


def _load_sndfile():
    """Binds libsndfile once; None when the library is absent."""
    global _sndfile, _sndfile_checked
    if _sndfile_checked:
        return _sndfile
    _sndfile_checked = True
    name = ctypes.util.find_library("sndfile")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
        lib.sf_open.restype = ctypes.c_void_p
        lib.sf_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(_SFInfo)]
        lib.sf_readf_float.restype = ctypes.c_int64
        lib.sf_readf_float.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int64]
        lib.sf_close.argtypes = [ctypes.c_void_p]
        _sndfile = lib
    except OSError:
        _sndfile = None
    return _sndfile


def _decode_sndfile(lib, path):
    SFM_READ = 0x10
    info = _SFInfo()
    handle = lib.sf_open(os.fsencode(path), SFM_READ,
                         ctypes.byref(info))
    if not handle:
        raise BadFormatError("libsndfile cannot open %s" % path)
    try:
        data = numpy.zeros(info.frames * info.channels,
                           dtype=numpy.float32)
        got = lib.sf_readf_float(
            handle, data.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), info.frames)
        data = data[:got * info.channels]
        return (data.reshape(-1, info.channels), info.samplerate)
    finally:
        lib.sf_close(handle)


def _decode_wave(path):
    """The standard library's reader: PCM WAV only."""
    import wave
    with wave.open(path, "rb") as w:
        channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = numpy.frombuffer(raw, dtype="<i2").astype(
            numpy.float32) / 32768.0
    elif width == 4:
        data = numpy.frombuffer(raw, dtype="<i4").astype(
            numpy.float32) / 2147483648.0
    elif width == 1:
        data = (numpy.frombuffer(raw, dtype=numpy.uint8).astype(
            numpy.float32) - 128.0) / 128.0
    else:
        raise BadFormatError("unsupported WAV sample width %d in %s"
                             % (width, path))
    return data.reshape(-1, channels), rate


def decode_audio(path):
    """→ (float32 (frames, channels) in [-1, 1], samplerate)."""
    lib = _load_sndfile()
    if lib is not None:
        return _decode_sndfile(lib, path)
    if not path.lower().endswith(".wav"):
        raise BadFormatError(
            "libsndfile is not installed — only PCM .wav decodable "
            "via the stdlib fallback (got %s)" % path)
    return _decode_wave(path)


class AudioFileLoader(FullBatchLoader):
    """Fixed-window audio full-batch loader.

    kwargs: ``test_paths``/``validation_paths``/``train_paths`` —
    audio files, directories, or (path, label) pairs; ``window_size``
    — samples per training window; ``window_step`` — hop (defaults to
    window_size, i.e. non-overlapping); ``mono`` — average channels
    (default True).  Labels default to the parent directory name,
    like the image loaders.
    """

    MAPPING = "audio_file"

    def __init__(self, workflow, **kwargs):
        super(AudioFileLoader, self).__init__(workflow, **kwargs)
        self.window_size = int(kwargs.get("window_size", 4096))
        self.window_step = int(kwargs.get("window_step",
                                          self.window_size))
        self.mono = kwargs.get("mono", True)
        self.paths = {0: kwargs.get("test_paths") or [],
                      1: kwargs.get("validation_paths") or [],
                      2: kwargs.get("train_paths") or []}
        self._label_map = {}
        self.samplerate = None

    get_label_from_path = FileImageLoader.get_label_from_path

    def _expand(self, entries):
        out = []
        for e in entries:
            if isinstance(e, tuple):
                out.append(e)
            elif os.path.isdir(e):
                for root_, _dirs, files in sorted(os.walk(e)):
                    for f in sorted(files):
                        if f.lower().endswith(AUDIO_EXTS):
                            out.append((os.path.join(root_, f),
                                        None))
            else:
                out.append((e, None))
        return out

    def _windows(self, stream):
        """Windows are (window_size,) mono or (window_size, ch) —
        one consistent shape per dataset so the fullbatch stacks."""
        if self.mono and stream.shape[1] > 1:
            stream = stream.mean(axis=1, keepdims=True)
        mono = stream.shape[1] == 1
        flat = stream[:, 0] if mono else stream
        n = (len(flat) - self.window_size) // self.window_step + 1
        if n <= 0:
            # Short file: one zero-padded window (same rank as the
            # full-length case, multichannel included).
            shape = (self.window_size,) if mono else \
                (self.window_size, stream.shape[1])
            padded = numpy.zeros(shape, dtype=numpy.float32)
            padded[:len(flat)] = flat[:self.window_size]
            return [padded]
        return [flat[i * self.window_step:
                     i * self.window_step + self.window_size]
                for i in range(n)]

    def load_data(self):
        datas, labels = [], []
        lengths = [0, 0, 0]
        for cls in (0, 1, 2):
            count = 0
            for path, label in self._expand(self.paths[cls]):
                stream, rate = decode_audio(path)
                if self.samplerate is None:
                    self.samplerate = rate
                elif rate != self.samplerate:
                    raise BadFormatError(
                        "%s: samplerate %d != dataset rate %d"
                        % (path, rate, self.samplerate))
                lab = self.get_label_from_path(path) \
                    if label is None else label
                for window in self._windows(stream):
                    datas.append(window)
                    labels.append(lab)
                    count += 1
            lengths[cls] = count
        if not datas:
            raise BadFormatError("%s: no audio found" % self)
        self.original_data.mem = numpy.stack(datas).astype(
            numpy.float32)
        self.original_labels.mem = numpy.asarray(
            labels, dtype=numpy.int32)
        self.class_lengths = lengths


class SpectrogramLoader(AudioFileLoader):
    """Windowed log-spectrogram features: each window becomes a
    (frames, bins) log-magnitude STFT computed once at load time, in
    numpy — the features are static per dataset, so the FFT is paid
    once instead of every epoch.

    kwargs on top of AudioFileLoader: ``fft_size`` (per-frame FFT,
    default 256), ``hop`` (frame hop, default fft_size//2),
    ``log_floor`` (dB-ish clamp, default 1e-6).
    """

    MAPPING = "audio_spectrogram"

    def __init__(self, workflow, **kwargs):
        super(SpectrogramLoader, self).__init__(workflow, **kwargs)
        self.fft_size = int(kwargs.get("fft_size", 256))
        self.hop = int(kwargs.get("hop", self.fft_size // 2))
        self.log_floor = float(kwargs.get("log_floor", 1e-6))
        if self.hop <= 0:
            raise BadFormatError("hop must be positive (got %d)"
                                 % self.hop)
        if self.window_size < self.fft_size:
            raise BadFormatError(
                "window_size (%d) must be >= fft_size (%d) — no "
                "frame fits" % (self.window_size, self.fft_size))
        self._hann = numpy.hanning(self.fft_size).astype(
            numpy.float32)

    def _spectrogram(self, window):
        # One vectorized rfft over all frames (per-frame Python FFTs
        # would cost millions of tiny calls on large datasets).
        frames = numpy.lib.stride_tricks.sliding_window_view(
            window, self.fft_size)[::self.hop] * self._hann
        mag = numpy.abs(numpy.fft.rfft(frames, axis=-1))
        return numpy.log(numpy.maximum(
            mag, self.log_floor)).astype(numpy.float32)

    def load_data(self):
        super(SpectrogramLoader, self).load_data()
        raw = self.original_data.mem
        if raw.ndim != 2:
            raise BadFormatError(
                "SpectrogramLoader needs mono windows (got shape %s)"
                % (raw.shape,))
        self.original_data.mem = numpy.stack(
            [self._spectrogram(w) for w in raw])
