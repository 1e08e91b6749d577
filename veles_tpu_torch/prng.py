"""Deterministic, state-preserving pseudo-random generators (the JAX
package's ``prng``).

Every generator owns two halves:

* a host ``numpy.random.RandomState`` for loader shuffles and weight
  init on the host.  Its seeding is the JAX package's code, byte for
  byte, so the same seed gives the same draws in both packages — and
  so bit-equal initial weights;
* a seeded ``torch.Generator`` per device, in place of the JAX
  package's threefry key chain, for randomness inside the step
  (dropout, sampling).  It is seeded from the same 32-bit value the
  threefry key was, but draws other numbers: parity tests hand both
  packages the same host-made inputs instead.

Both halves are captured by ``__getstate__``, so a pickled generator
resumes with identical randomness.

While a run of the command line is live, :func:`poison_numpy_random`
makes the module-level sampling functions of ``numpy.random`` raise for
the port's code and the workflow's (the JAX package's guard).
"""

import contextlib
import logging
import os
import sys

import numpy
import torch

from .logger import Logger

#: The real numpy.random module — the port's own draws survive
#: poisoning.
_np_random = numpy.random


class RandomGenerator(Logger):
    """A named deterministic generator."""

    def __init__(self, key):
        super(RandomGenerator, self).__init__()
        self.key = key
        self._seed = None
        self._state = _np_random.RandomState()
        self._torch = {}
        self.seed(numpy.frombuffer(b"seed" + bytes([key & 0xFF]),
                                   dtype=numpy.uint8))

    # -- seeding -----------------------------------------------------------

    @property
    def seed_value(self):
        return self._seed

    @property
    def device_seed(self):
        """The 32-bit seed of this generator's device streams."""
        return self._device_seed

    def seed(self, seed, count=None, dtype=None):
        """Seeds from an int, array, bytes, or ``file:count:dtype``
        spec."""
        if seed is None:
            seed = numpy.frombuffer(os.urandom(16), dtype=numpy.uint32)
        if isinstance(seed, str):
            seed = self._seed_from_spec(seed)
        if isinstance(seed, (bytes, bytearray)):
            seed = numpy.frombuffer(seed, dtype=numpy.uint8)
        if count is not None and dtype is not None and \
                not isinstance(seed, numpy.ndarray):
            raise ValueError("count/dtype only apply to file specs")
        self._seed = seed
        if isinstance(seed, numpy.ndarray):
            mixed = numpy.uint32(
                numpy.bitwise_xor.reduce(
                    seed.view(numpy.uint8).astype(numpy.uint32) *
                    numpy.arange(1, seed.nbytes + 1, dtype=numpy.uint32)))
            self._state = _np_random.RandomState(
                seed.view(numpy.uint8).astype(numpy.uint32))
            dseed = int(mixed)
        else:
            self._state = _np_random.RandomState(seed)
            dseed = int(seed) & 0xFFFFFFFF
        self._device_seed = dseed ^ (self.key * 0x9E3779B9 & 0xFFFFFFFF)
        self._torch = {}
        return self

    @staticmethod
    def _seed_from_spec(spec):
        """Parses ``/dev/urandom:16:uint32``-style seed specs."""
        parts = spec.split(":")
        count = int(parts[1]) if len(parts) > 1 else 16
        dtype = numpy.dtype(parts[2] if len(parts) > 2 else "uint8")
        with open(parts[0], "rb") as fin:
            data = fin.read(count * dtype.itemsize)
        return numpy.frombuffer(data, dtype=dtype).copy()

    # -- host-side API (numpy semantics) -----------------------------------

    def fill(self, arr, vle_min=-1.0, vle_max=1.0):
        """Uniform fill in place."""
        arr[...] = self._state.uniform(
            low=vle_min, high=vle_max, size=arr.shape).astype(arr.dtype)

    def fill_normal(self, arr, mean=0.0, stddev=1.0):
        arr[...] = self._state.normal(
            loc=mean, scale=stddev, size=arr.shape).astype(arr.dtype)

    def normal(self, loc=0.0, scale=1.0, size=None):
        return self._state.normal(loc=loc, scale=scale, size=size)

    def uniform(self, low=0.0, high=1.0, size=None):
        return self._state.uniform(low=low, high=high, size=size)

    def shuffle(self, arr):
        self._state.shuffle(arr)

    def permutation(self, x):
        return self._state.permutation(x)

    def randint(self, low, high=None, size=None):
        return self._state.randint(low, high=high, size=size)

    def random_sample(self, size=None):
        return self._state.random_sample(size=size)

    def choice(self, a, size=None, replace=True, p=None):
        return self._state.choice(a, size=size, replace=replace, p=p)

    # -- device-side API ---------------------------------------------------

    def torch_generator(self, device="cpu"):
        """The seeded ``torch.Generator`` of ``device``: one stream per
        device, advanced by every draw made with it."""
        device = torch.device(device)
        name = str(device)
        gen = self._torch.get(name)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(self._device_seed)
            self._torch[name] = gen
        return gen

    # -- state -------------------------------------------------------------

    def __getstate__(self):
        return {"key": self.key, "seed": self._seed,
                "np_state": self._state.get_state(),
                "device_seed": self._device_seed,
                "torch": {name: gen.get_state().numpy().tobytes()
                          for name, gen in self._torch.items()}}

    def __setstate__(self, state):
        super(RandomGenerator, self).__init__()
        self.key = state["key"]
        self._seed = state["seed"]
        self._state = _np_random.RandomState()
        self._state.set_state(state["np_state"])
        self._device_seed = state["device_seed"]
        self._torch = {}
        for name, raw in state["torch"].items():
            gen = self.torch_generator(name)
            gen.set_state(torch.frombuffer(bytearray(raw),
                                           dtype=torch.uint8))


_generators = {}


def get(key=0):
    """The global generator registry."""
    gen = _generators.get(key)
    if gen is None:
        gen = _generators[key] = RandomGenerator(key)
    return gen


def reset():
    _generators.clear()


@contextlib.contextmanager
def scoped(store):
    """Installs ``store`` (a plain dict) as the generator registry for
    the block, so the block draws from its own generators: a population
    lineage's builds, loader walks and step keys never advance another
    member's streams.  Generators created inside land in ``store``; the
    previous registry comes back on exit.  Not thread-safe by itself:
    the population master serializes lineage operations."""
    global _generators
    saved = _generators
    _generators = store
    try:
        yield store
    finally:
        _generators = saved


# -- numpy.random poisoning (reproducibility guard) ---------------------
#
# A stray ``numpy.random.rand()`` draws from hidden global state and
# silently breaks a run's reproducibility, so while a run is live the
# module-level sampling functions of ``numpy.random`` raise for the
# port's own code and the workflow's.  The seeded-generator classes
# (RandomState, Generator, default_rng and friends) stay reachable: an
# explicitly seeded generator is reproducible by construction.

#: Extra path prefixes whose callers the guard treats as user code
#: (raise, not warn) — the command line registers the workflow file's
#: directory.
_guarded_paths = set()

#: Call sites already warned about (callers outside the port and the
#: workflow paths warn once instead of raising).
_warned_sites = set()

#: The package name a caller's file path must contain to count as the
#: port's own code.
PACKAGE = __name__.split(".")[0]


def guard_path(path):
    """Registers a directory whose code the guard treats as user
    workflow code: stray draws from there raise."""
    _guarded_paths.add(os.path.abspath(path))


#: Attributes that stay reachable while poisoned.
_POISON_ALLOWED = frozenset((
    "RandomState", "Generator", "default_rng", "BitGenerator",
    "SeedSequence", "MT19937", "PCG64", "PCG64DXSM", "Philox",
    "SFC64",
    # scipy reads numpy.random.mtrand._rand at import time to wire its
    # own default_rng plumbing; banning the submodule attribute would
    # make ``import scipy.stats`` fail.
    "mtrand",
))


class _PoisonedRandom(object):
    """Stand-in installed over ``numpy.random`` while a run is live."""

    def __init__(self, real):
        object.__setattr__(self, "_real", real)

    def __getattr__(self, item):
        real = object.__getattribute__(self, "_real")
        if item in _POISON_ALLOWED or item.startswith("__"):
            return getattr(real, item)
        # Calls from the port itself, from registered workflow paths
        # and from under the launch directory raise; installed
        # libraries (torch, scipy) draw from numpy.random legitimately
        # and pass; anything else warns once per call site.  A tripwire
        # for direct stray use, not a sandbox.
        frame = sys._getframe(1)
        caller = frame.f_code.co_filename
        message = (
            "%s.prng forbids direct numpy.random.%s during a run — it "
            "draws from hidden global state and breaks "
            "reproducibility. Use prng.get().%s / unit.rand().%s, an "
            "explicitly seeded numpy.random.RandomState, or wrap "
            "third-party code in prng.unpoisoned()." %
            (PACKAGE, item, item, item))
        # Installed-library exemption first: a virtualenv inside the
        # project directory must not turn library draws into crashes.
        if ("site-packages" in caller or "dist-packages" in caller) \
                and PACKAGE not in caller:
            return getattr(real, item)
        if PACKAGE in caller or \
                (_launch_cwd[0] is not None and
                 caller.startswith(_launch_cwd[0])) or any(
                caller.startswith(p) for p in _guarded_paths):
            raise AttributeError(message)
        site = (caller, frame.f_lineno)
        if site not in _warned_sites:
            _warned_sites.add(site)
            logging.getLogger("prng").warning(
                "%s (called from %s:%d — warning only: the caller is "
                "outside the port and the workflow paths)", message,
                caller, frame.f_lineno)
        return getattr(real, item)


#: The "user code" directory prefix, captured once at poison time: a
#: per-call ``os.getcwd()`` would change the guard on chdir, and a
#: root-ish cwd ('/') would make the whole filesystem user code.
_launch_cwd = [None]


def _capture_launch_cwd():
    cwd = os.getcwd().rstrip(os.sep)
    # A filesystem root or another very short prefix matches
    # everything: the cwd rule is off then.  The stored prefix ends
    # with a separator, so a sibling directory that shares the cwd as
    # a string prefix never matches.
    _launch_cwd[0] = cwd + os.sep if len(cwd) > 3 else None


def poison_numpy_random():
    """Installs the guard (idempotent) over both access routes:
    ``numpy.random.rand(...)`` and ``from numpy.random import rand``
    (the ``sys.modules`` entry).  A name imported before poisoning
    cannot be revoked."""
    _capture_launch_cwd()
    if not isinstance(numpy.random, _PoisonedRandom):
        poisoned = _PoisonedRandom(_np_random)
        numpy.random = poisoned
        sys.modules["numpy.random"] = poisoned


def unpoison_numpy_random():
    numpy.random = _np_random
    sys.modules["numpy.random"] = _np_random


@contextlib.contextmanager
def unpoisoned():
    """Temporarily restores the real module for third-party code that
    legitimately touches numpy.random internals."""
    was = isinstance(numpy.random, _PoisonedRandom)
    unpoison_numpy_random()
    try:
        yield
    finally:
        if was:
            poison_numpy_random()
