"""Devices of the port: the H100 through CUDA, and the host CPU.

The JAX package's ``backends`` picks a TPU or the CPU and builds a
mesh.  The port has one card and no mesh yet, so a device here is a
``torch.device`` plus the numeric settings the serving path promises:

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
"""

import torch

from .error import DeviceNotFoundError


class Device(object):
    """One device the port runs on."""

    name = None

    def __init__(self):
        self.torch_device = torch.device(self.name)

    def __repr__(self):
        return "<%s %s>" % (type(self).__name__, self.torch_device)


class CPUDevice(Device):
    """The host CPU — the device of the tests: every kernel wrapper
    takes its plain PyTorch version on CPU tensors."""

    name = "cpu"


class CUDADevice(Device):
    """A card through CUDA (``index``, card 0 by default), with TF32 off
    and cuDNN deterministic."""

    name = "cuda"

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


DEVICES = {"cuda": CUDADevice, "cpu": CPUDevice}


def resolve_device(name="cuda"):
    """The :class:`Device` for ``name`` ("cuda" or "cpu", a
    ``torch.device`` or a :class:`Device`).  Unknown names and a
    missing card raise."""
    if isinstance(name, Device):
        return name
    if isinstance(name, torch.device):
        name = name.type
    cls = DEVICES.get(str(name))
    if cls is None:
        raise DeviceNotFoundError(
            "unknown device %r — valid: %s" %
            (name, ", ".join(sorted(DEVICES))))
    return cls()
