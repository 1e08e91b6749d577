"""Loaders of the port: the minibatch-serving base and the
device-resident full-batch loader."""

from .base import (CLASS_NAME, TEST, VALID, TRAIN, Loader,  # noqa: F401
                   ILoader, UserLoaderRegistry)
from .fullbatch import FullBatchLoader  # noqa: F401
