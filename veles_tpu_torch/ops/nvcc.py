"""Builds the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into a library with a plain C interface, which its
wrapper loads with ``ctypes``.  Libraries go to ``build/`` beside this
file (listed in ``.gitignore``), named by a hash of the source and the
flags, and are written atomically, so a second build of an unchanged
source is a file lookup.  :func:`build` starts one ``nvcc`` per
missing library, all at once, and waits for them together.

A missing ``nvcc`` or a failed compile raises: there is no path that
carries on without a kernel on a CUDA tensor.
"""

import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
#: nvcc flags: Hopper's architecture-specific target, no fast math
#: (expf/logf stay IEEE-accurate), ptxas resource report in the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: source path -> ``{"path", "seconds", "log"}`` of its last build
#: (``seconds`` 0.0 and an empty log when the library already existed).
build_info = {}


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin) — the "
                       "port's CUDA kernels cannot be built")


def library_path(source):
    """Where the library of ``source`` is (or will be) built."""
    with open(source, "rb") as fin:
        digest = hashlib.sha1(fin.read() + " ".join(NVCC_FLAGS)
                              .encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, "libveles_%s-%s.so" % (stem, digest))


def build(*sources):
    """Builds every source in ``sources`` whose library is missing, one
    ``nvcc`` process each, all started together; returns the library
    paths in the order given.  Raises when ``nvcc`` is missing or any
    compile fails."""
    paths = [library_path(src) for src in sources]
    started = []
    for src, path in zip(sources, paths):
        if os.path.isfile(path):
            build_info[src] = dict(path=path, seconds=0.0, log="")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (path, os.getpid())
        proc = subprocess.Popen(
            [nvcc_path()] + list(NVCC_FLAGS) + ["-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started.append((src, path, tmp, proc, time.monotonic()))
    failures = []
    for src, path, tmp, proc, t0 in started:
        log, _ = proc.communicate()
        if proc.returncode:
            failures.append("nvcc failed (exit %d) building %s:\n%s" %
                            (proc.returncode, src, log))
            continue
        os.replace(tmp, path)
        build_info[src] = dict(path=path, seconds=time.monotonic() - t0,
                               log=log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths
