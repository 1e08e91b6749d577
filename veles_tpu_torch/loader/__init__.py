"""Loaders of the port: the minibatch-serving base, the
device-resident full-batch loader, the streamed loader and the image
loaders (``loader.image``)."""

from .base import (CLASS_NAME, TEST, VALID, TRAIN, Loader,  # noqa: F401
                   ILoader, UserLoaderRegistry)
from .fullbatch import FullBatchLoader  # noqa: F401
from .stream import StreamLoader  # noqa: F401
from .image import (ImageLoaderBase, FileImageLoader,  # noqa: F401
                    AutoLabelFileImageLoader, FileImageMSELoader,
                    StreamedFileImageLoader)
