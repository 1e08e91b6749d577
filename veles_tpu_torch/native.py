"""ctypes binding to the native inference runtime (the JAX package's
``native``).

The C++ runtime (``native/veles_infer.cc``) loads an exported artifact
and runs its forward chain on the host with no Python framework.
:class:`NativeModel` exposes it with the same ``forward(x)`` contract as
:class:`veles_tpu_torch.export.ExportedModel` (samples in, numpy
probabilities out), so the two can be held against each other.

:func:`build_native` compiles the sources of ``native/`` with the
Makefile's own flags (``-O2 -std=c++17 -Wall -Wextra -fPIC -shared …
-lz``) into the port's build directory (``veles_tpu_torch/ops/build/``,
listed in ``.gitignore``), named by a hash of the sources and the
flags and written atomically (a temporary file, then ``os.replace``), so
processes building at the same moment never see a half-written library
and nothing is written under ``native/``.  :func:`build_cli` builds the
standalone command-line binary the same way.  A failed build raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy

from .error import Bug
from .ops.nvcc import BUILD_DIR

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native")
SOURCES = ("veles_infer.cc", "veles_infer.h")
#: The Makefile's CXXFLAGS and LDLIBS.
CXXFLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC")
LDLIBS = ("-lz",)

_lib = None
_lib_lock = threading.Lock()


def _output_path(stem, extra):
    digest = hashlib.sha1()
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as fin:
            digest.update(fin.read())
    digest.update(" ".join(CXXFLAGS + extra + LDLIBS).encode())
    return os.path.join(BUILD_DIR, "%s-%s" % (stem, digest.hexdigest()[:16]))


def _build(stem, extra, force=False):
    """Compiles ``native/veles_infer.cc`` with the Makefile's flags plus
    ``extra`` into the build directory; returns the output's path."""
    path = _output_path(stem, extra)
    if os.path.isfile(path) and not force:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.%d.tmp" % (path, os.getpid(), threading.get_ident())
    cxx = os.environ.get("CXX", "g++")
    argv = [cxx] + list(CXXFLAGS) + list(extra) + [
        "-o", tmp, os.path.join(NATIVE_DIR, "veles_infer.cc")] + \
        list(LDLIBS)
    try:
        proc = subprocess.run(argv, capture_output=True, text=True)
    except OSError as e:
        raise Bug("native build failed: cannot run %s (%s)" % (cxx, e))
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise Bug("native build failed (%s exit %d):\n%s" % (
            " ".join(argv), proc.returncode, proc.stderr[-2000:]))
    os.replace(tmp, path)
    return path


def build_native(force=False):
    """Builds the shared library (unless an up-to-date one exists, or
    ``force``); returns its path."""
    return _build("libveles_infer.so", ("-shared",), force)


def build_cli(force=False):
    """Builds the standalone ``veles_infer`` binary (``artifact input.f32
    batch`` → one row of outputs a line); returns its path."""
    return _build("veles_infer", ("-DVELES_INFER_MAIN",), force)


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_native())
        lib.vt_load.restype = ctypes.c_void_p
        lib.vt_load.argtypes = [ctypes.c_char_p]
        lib.vt_input_size.argtypes = [ctypes.c_void_p]
        lib.vt_output_size.argtypes = [ctypes.c_void_p]
        lib.vt_unit_count.argtypes = [ctypes.c_void_p]
        lib.vt_unit_type.restype = ctypes.c_char_p
        lib.vt_unit_type.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.vt_forward.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        lib.vt_free.argtypes = [ctypes.c_void_p]
        lib.vt_error.restype = ctypes.c_char_p
        _lib = lib
        return lib


class NativeModel(object):
    """An exported artifact loaded by the C++ runtime."""

    def __init__(self, path):
        self._lib = _load_lib()
        self._handle = self._lib.vt_load(
            os.fsencode(os.path.abspath(path)))
        if not self._handle:
            raise Bug("native load failed: %s" %
                      self._lib.vt_error().decode())
        self.input_size = self._lib.vt_input_size(self._handle)
        self.output_size = self._lib.vt_output_size(self._handle)

    @property
    def unit_types(self):
        n = self._lib.vt_unit_count(self._handle)
        return [self._lib.vt_unit_type(self._handle, i).decode()
                for i in range(n)]

    def forward(self, x):
        """(batch, output_size) float32 outputs of ``x`` (batch × the
        artifact's input shape, or flat)."""
        x = numpy.ascontiguousarray(x, dtype=numpy.float32)
        batch = x.shape[0]
        if x.size != batch * self.input_size:
            raise Bug("input size mismatch: got %d elements/sample, "
                      "model wants %d" %
                      (x.size // batch, self.input_size))
        out = numpy.empty((batch, self.output_size), dtype=numpy.float32)
        rc = self._lib.vt_forward(
            self._handle,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), batch,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise Bug("native forward failed: %s" %
                      self._lib.vt_error().decode())
        return out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.vt_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: the library may be gone
