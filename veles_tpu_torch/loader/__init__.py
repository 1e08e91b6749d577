"""Loaders of the port: the minibatch-serving base, the
device-resident full-batch loader, the streamed loader, the image
loaders (``loader.image``), the queue-fed loaders
(``loader.interactive``), pickles, HDF5, minibatch dumps
(``loader.saver``), audio and WebHDFS text.  Importing the package
registers every loader's MAPPING."""

from .base import (CLASS_NAME, TEST, VALID, TRAIN, Loader,  # noqa: F401
                   ILoader, UserLoaderRegistry)
from .fullbatch import FullBatchLoader  # noqa: F401
from .stream import StreamLoader  # noqa: F401
from .image import (ImageLoaderBase, FileImageLoader,  # noqa: F401
                    AutoLabelFileImageLoader, FileImageMSELoader,
                    StreamedFileImageLoader)
from .interactive import (QueueLoader, InteractiveLoader,  # noqa: F401
                          RestfulLoader)
from .pickles import PicklesLoader  # noqa: F401
from .hdf5 import HDF5Loader  # noqa: F401
from .saver import (MinibatchesSaver, MinibatchesLoader,  # noqa: F401
                    read_minibatch_stream)
from .audio import (AudioFileLoader, SpectrogramLoader,  # noqa: F401
                    decode_audio)
from .hdfs_loader import WebHDFSClient, HDFSTextLoader  # noqa: F401
