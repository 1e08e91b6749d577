"""Devices of the port: the H100 through CUDA, and the host CPU (the
JAX package's ``backends``).

The JAX package picks a TPU or the CPU and builds a mesh.  A device of
the port is a ``torch.device`` plus the numeric settings the serving
path promises:

* float32 matrix products run in full float32 —
  ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` are set to False when the CUDA
  device is made, because serving promises f32 math (TF32 keeps about
  three decimal digits);
* cuDNN takes its deterministic algorithms —
  ``torch.backends.cudnn.deterministic`` is set to True with TF32 off,
  because the default float32 weight gradient of a convolution sums
  with atomics and a tick from a fixed state would not repeat bit for
  bit, which a snapshot's resume promises;
* asking for ``cuda`` on a machine without a card raises
  :class:`~veles_tpu_torch.error.DeviceNotFoundError`.  Nothing carries
  on on the CPU by itself: the CPU runs only when the caller asks for
  it, as the tests do.

:class:`BackendRegistry` maps a backend name to its class;
:func:`resolve_device` (and :meth:`Device.create`, its JAX name) takes
``cuda``, ``cpu`` or ``auto`` (the card, raising without one).  ``tpu``
has no counterpart and is refused by name (:data:`NO_COUNTERPART`).  :attr:`Device.compute_power` is the
load-balancing scalar of the data plane — 1000 over the seconds of the
client's GEMM timing (``client.measure_computing_power``) — measured
once per card name and cached in ``device_power.json`` under
``root.common.dirs.cache``.
"""

import json
import os

import torch

from .config import root, get as config_get
from .error import DeviceNotFoundError
from .logger import Logger

#: Backend names of the JAX package that have no counterpart, with the
#: reason.
NO_COUNTERPART = {
    "tpu": "the port runs on a CUDA card (cuda) or the host (cpu); "
           "its TPU kernels are CUDA kernels",
}


class BackendRegistry(type):
    """Backend name → Device class."""

    backends = {}

    def __init__(cls, name, bases, clsdict):
        super(BackendRegistry, cls).__init__(name, bases, clsdict)
        backend = clsdict.get("BACKEND")
        if backend is not None:
            BackendRegistry.backends[backend] = cls


class Device(Logger, metaclass=BackendRegistry):
    """One device the port runs on."""

    BACKEND = None
    name = None

    def __init__(self):
        super(Device, self).__init__()
        self.torch_device = torch.device(self.name)
        self._power = None

    @staticmethod
    def create(backend="auto", **kwargs):
        """The JAX package's name for :func:`resolve_device`."""
        return resolve_device(backend, **kwargs)

    @property
    def backend_name(self):
        return self.BACKEND

    @property
    def device_kind(self):
        """The card's name (``torch.cuda.get_device_name``), or
        ``cpu``."""
        if self.torch_device.type == "cuda":
            return torch.cuda.get_device_name(self.torch_device)
        return "cpu"

    # -- computing power ---------------------------------------------------

    @property
    def compute_power(self):
        """The GEMM-throughput scalar of load balancing, cached under
        ``root.common.dirs.cache`` by :meth:`power_key`."""
        if self._power is None:
            self._power = self._load_or_measure_power()
        return self._power

    def power_key(self):
        return "%s:%s" % (self.BACKEND, self.device_kind)

    @staticmethod
    def power_cache_path():
        cache_dir = config_get(root.common.dirs.cache)
        return os.path.join(cache_dir, "device_power.json") \
            if cache_dir else None

    @staticmethod
    def _read_cache(path):
        try:
            with open(path) as fin:
                return json.load(fin)
        except (ValueError, OSError):
            return {}

    def _load_or_measure_power(self):
        path = self.power_cache_path()
        key = self.power_key()
        if path and os.path.isfile(path):
            cached = self._read_cache(path).get(key)
            if cached is not None:
                return cached
        power = self.measure_power()
        if path:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            cache = self._read_cache(path) if os.path.isfile(path) else {}
            cache[key] = power
            tmp = "%s.%d.tmp" % (path, os.getpid())
            with open(tmp, "w") as fout:
                json.dump(cache, fout)
            os.replace(tmp, path)
        return power

    def measure_power(self):
        """Times the client's GEMM on this device: 1000 / seconds."""
        from .client import measure_computing_power
        power = measure_computing_power(device=self.torch_device)
        self.info("measured compute power of %s: %.1f", self.device_kind,
                  power)
        return power

    def __repr__(self):
        return "<%s %s>" % (type(self).__name__, self.torch_device)


class CPUDevice(Device):
    """The host CPU — the device of the tests: every kernel wrapper
    takes its plain PyTorch version on CPU tensors."""

    BACKEND = name = "cpu"


class CUDADevice(Device):
    """A card through CUDA (``index``, card 0 by default), with TF32 off
    and cuDNN deterministic."""

    BACKEND = name = "cuda"

    def __init__(self, index=0):
        if not torch.cuda.is_available():
            raise DeviceNotFoundError(
                "device 'cuda' requested but torch sees no CUDA card "
                "(torch %s, built for CUDA %s) — pass device='cpu' to "
                "run on the host" % (torch.__version__,
                                     torch.version.cuda))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        super(CUDADevice, self).__init__()
        self.torch_device = torch.device("cuda", index)


#: The port's backends by name (the registry's entries).
DEVICES = BackendRegistry.backends


def resolve_device(name="cuda", **kwargs):
    """The :class:`Device` for ``name`` (a backend name — ``cuda``,
    ``cpu``, or ``auto`` or empty for the card —, a ``torch.device`` or
    a :class:`Device`).  Unknown names, ``tpu`` and a missing card
    raise :class:`DeviceNotFoundError`."""
    if isinstance(name, Device):
        return name
    if isinstance(name, torch.device):
        name = name.type
    name = str(name or "auto")
    cls = DEVICES.get("cuda" if name == "auto" else name)
    if cls is None:
        reason = NO_COUNTERPART.get(name)
        raise DeviceNotFoundError(
            "unknown device %r — valid: auto, %s%s" % (
                name, ", ".join(sorted(DEVICES)),
                "; it has no counterpart in the port: " + reason
                if reason else ""))
    return cls(**kwargs)
