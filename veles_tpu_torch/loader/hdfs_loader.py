"""HDFS text streaming loader (the JAX package's
``loader.hdfs_loader``): streams a text file from HDFS in fixed line
chunks through the unit's ``output`` until ``finished`` flips.  The
transport is the WebHDFS REST API through the standard library's
``urllib``, so any namenode with WebHDFS enabled serves it.
"""

import json
import urllib.parse
import urllib.request

from ..error import BadFormatError
from ..mutable import Bool
from ..units import Unit
from .base import UserLoaderRegistry


class WebHDFSClient(object):
    """Minimal WebHDFS REST client (OPEN / GETFILESTATUS /
    LISTSTATUS)."""

    def __init__(self, address, user=None, timeout=30.0):
        if not address.startswith("http"):
            address = "http://" + address
        self.base = address.rstrip("/")
        self.user = user
        self.timeout = timeout

    def _url(self, path, op, **params):
        if not path.startswith("/"):
            path = "/" + path
        params["op"] = op
        if self.user:
            params["user.name"] = self.user
        return "%s/webhdfs/v1%s?%s" % (
            self.base, urllib.parse.quote(path),
            urllib.parse.urlencode(params))

    def open(self, path):
        """Returns the file's bytes (urllib follows the namenode →
        datanode redirect WebHDFS issues)."""
        with urllib.request.urlopen(self._url(path, "OPEN"),
                                    timeout=self.timeout) as resp:
            return resp.read()

    def iter_chunks(self, path, chunk_bytes=1 << 20):
        """Streams the file in ``chunk_bytes`` pieces using WebHDFS
        OPEN's offset/length params — multi-GB files never land in
        memory whole."""
        offset = 0
        while True:
            url = self._url(path, "OPEN", offset=offset,
                            length=chunk_bytes)
            with urllib.request.urlopen(
                    url, timeout=self.timeout) as resp:
                blob = resp.read()
            if not blob:
                return
            yield blob
            if len(blob) < chunk_bytes:
                return
            offset += len(blob)

    def stat(self, path):
        with urllib.request.urlopen(
                self._url(path, "GETFILESTATUS"),
                timeout=self.timeout) as resp:
            return json.loads(resp.read())["FileStatus"]

    def list(self, path):
        with urllib.request.urlopen(
                self._url(path, "LISTSTATUS"),
                timeout=self.timeout) as resp:
            statuses = json.loads(resp.read())
        return [s["pathSuffix"] for s in
                statuses["FileStatuses"]["FileStatus"]]


class HDFSTextLoader(Unit, metaclass=UserLoaderRegistry):
    """Streams an HDFS text file in line chunks.

    kwargs: ``file`` — HDFS path; ``address`` — namenode
    ``host:port`` (WebHDFS); ``chunk`` — lines per run; ``user`` —
    optional user.name.  Each ``run()`` refills ``output`` with the
    next chunk; ``finished`` flips at EOF (gate downstream units on
    it).
    """

    MAPPING = "hdfs_text"

    def __init__(self, workflow, **kwargs):
        super(HDFSTextLoader, self).__init__(workflow, **kwargs)
        if "file" not in kwargs or "address" not in kwargs:
            raise BadFormatError(
                "HDFSTextLoader requires file= and address= kwargs")
        self.file_name = kwargs["file"]
        self.chunk_lines_number = int(kwargs.get("chunk", 1000))
        self.hdfs_client = WebHDFSClient(
            kwargs["address"], user=kwargs.get("user"),
            timeout=kwargs.get("timeout", 30.0))
        self.output = [""] * self.chunk_lines_number
        self.finished = Bool(False)
        self._lines_ = None

    def initialize(self, **kwargs):
        super(HDFSTextLoader, self).initialize(**kwargs)
        self.debug("opening hdfs://%s (%s)", self.file_name,
                   self.hdfs_client.stat(self.file_name))
        self._lines_ = self._iter_lines()

    def _iter_lines(self):
        """Streaming line iterator over chunked OPEN reads — the
        whole file is never held at once."""
        tail = b""
        for blob in self.hdfs_client.iter_chunks(self.file_name):
            blob = tail + blob
            lines = blob.split(b"\n")
            tail = lines.pop()
            for line in lines:
                yield line.decode("utf-8", errors="replace")
        if tail:
            yield tail.decode("utf-8", errors="replace")

    def run(self):
        if bool(self.finished):
            return
        count = 0
        for i in range(self.chunk_lines_number):
            try:
                self.output[i] = next(self._lines_)
                count += 1
            except StopIteration:
                self.output[i:] = [""] * (
                    self.chunk_lines_number - i)
                self.finished <<= True
                break
        self.debug("served %d lines", count)
