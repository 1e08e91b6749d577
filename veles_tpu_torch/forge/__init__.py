"""Forge — the model package registry (the JAX package's ``forge``):
a versioned, git-backed model repository with list, details, fetch,
upload and delete over HTTP (:mod:`veles_tpu_torch.forge.server`) and
its client and command line (:mod:`veles_tpu_torch.forge.client`,
``python -m veles_tpu_torch.forge``).
"""

#: A model package must carry this manifest with these fields.  Defined
#: before the submodule imports — they read these from the partially
#: initialized package.
MANIFEST_NAME = "manifest.json"
REQUIRED_FIELDS = ("name", "workflow", "short_description")

from .server import ForgeServer  # noqa: E402,F401
from .client import ForgeClient  # noqa: E402,F401
