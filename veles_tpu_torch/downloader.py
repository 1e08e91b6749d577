"""Dataset downloader unit (the JAX package's ``downloader``): fetches
a dataset archive (http, https or file URL) before ``load_data`` and
unpacks it into the datasets directory, skipping the fetch when the
expected files already exist.  Tar members are extracted with the
``"data"`` filter and zip members that would land outside the target
directory are refused.
"""

import os
import shutil
import tarfile
import urllib.request
import zipfile

from .config import root, get as config_get
from .units import Unit


class Downloader(Unit):
    """kwargs: ``url`` — archive or file location; ``directory`` —
    target directory (default ``root.common.dirs.datasets``);
    ``files`` — names whose presence short-circuits the fetch."""

    def __init__(self, workflow, **kwargs):
        self.url = kwargs.get("url")
        self.directory = kwargs.get(
            "directory", config_get(root.common.dirs.datasets, "."))
        self.files = list(kwargs.get("files", ()))
        super(Downloader, self).__init__(workflow, **kwargs)
        self.view_group = "SERVICE"

    @property
    def already_present(self):
        return self.files and all(
            os.path.exists(os.path.join(self.directory, f))
            for f in self.files)

    def initialize(self, **kwargs):
        super(Downloader, self).initialize(**kwargs)
        if self.already_present:
            self.debug("dataset already present in %s", self.directory)
            return
        if not self.url:
            raise ValueError("%s: no url and files missing" % self)
        os.makedirs(self.directory, exist_ok=True)
        archive = os.path.join(self.directory,
                               os.path.basename(self.url) or "dataset")
        self.info("fetching %s", self.url)
        with urllib.request.urlopen(self.url) as resp, \
                open(archive, "wb") as fout:
            shutil.copyfileobj(resp, fout)
        self._unpack(archive)

    def _unpack(self, archive):
        if tarfile.is_tarfile(archive):
            with tarfile.open(archive) as tar:
                tar.extractall(self.directory, filter="data")
            os.remove(archive)
        elif zipfile.is_zipfile(archive):
            with zipfile.ZipFile(archive) as z:
                # The zip-slip guard (the tar path has it from
                # filter="data"): refuse members that would resolve
                # outside the target directory.
                target = os.path.realpath(self.directory)
                for info in z.infolist():
                    dest = os.path.realpath(
                        os.path.join(target, info.filename))
                    if dest != target and not dest.startswith(
                            target + os.sep):
                        raise ValueError(
                            "refusing to extract %r outside %s" %
                            (info.filename, target))
                z.extractall(self.directory)
            os.remove(archive)
        # A plain file stays as fetched.
