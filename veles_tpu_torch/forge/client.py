"""Forge client and command line: packages a model directory
(``manifest.json``, the workflow source and anything else, e.g. an
exported artifact) and pushes it to, or pulls it from, a
:class:`~veles_tpu_torch.forge.server.ForgeServer`.

Run: ``python -m veles_tpu_torch.forge {list,details,fetch,upload,delete}
[TARGET] --server host:port [--version V] [-o DIR] [--token T]``
(the token defaults to ``$VELES_FORGE_TOKEN``).
"""

import io
import json
import os
import tarfile
import urllib.parse
import urllib.request

from ..error import BadFormatError
from ..logger import Logger
from . import MANIFEST_NAME, REQUIRED_FIELDS


class ForgeClient(Logger):
    def __init__(self, server, token=None, timeout=60.0):
        super(ForgeClient, self).__init__()
        if not server.startswith("http"):
            server = "http://" + server
        self.base = server.rstrip("/")
        self.token = token
        self.timeout = timeout

    def _request(self, path, data=None, **params):
        url = "%s%s" % (self.base, path)
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(url, data=data)
        if self.token:
            req.add_header("X-Forge-Token", self.token)
        return urllib.request.urlopen(req, timeout=self.timeout)

    # -- actions -----------------------------------------------------------

    def list(self):
        with self._request("/service", query="list") as resp:
            return json.loads(resp.read())

    def details(self, name):
        with self._request("/service", query="details",
                           name=name) as resp:
            return json.loads(resp.read())

    def upload(self, package_dir, version=None):
        """Packages a model directory and pushes it."""
        manifest_path = os.path.join(package_dir, MANIFEST_NAME)
        if not os.path.isfile(manifest_path):
            raise BadFormatError("%s lacks %s" % (package_dir,
                                                  MANIFEST_NAME))
        with open(manifest_path) as fin:
            manifest = json.load(fin)
        missing = [f for f in REQUIRED_FIELDS if f not in manifest]
        if missing:
            raise BadFormatError("manifest lacks: %s"
                                 % ", ".join(missing))
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            for root_, _dirs, files in os.walk(package_dir):
                for f in sorted(files):
                    full = os.path.join(root_, f)
                    tar.add(full, arcname=os.path.relpath(
                        full, package_dir))
        params = {"name": manifest["name"]}
        if version:
            params["version"] = version
        with self._request("/upload", data=buf.getvalue(),
                           **params) as resp:
            reply = json.loads(resp.read())
        self.info("uploaded %s: %s", manifest["name"], reply)
        return reply

    def fetch(self, name, dest_dir, version=None):
        """Downloads + unpacks a package; returns (dir, version)."""
        params = {"name": name}
        if version:
            params["version"] = version
        with self._request("/fetch", **params) as resp:
            got_version = resp.headers.get("X-Forge-Version", "")
            blob = resp.read()
        os.makedirs(dest_dir, exist_ok=True)
        with tarfile.open(fileobj=io.BytesIO(blob),
                          mode="r:gz") as tar:
            for member in tar.getmembers():
                if member.name.startswith("/") or \
                        ".." in member.name.split("/"):
                    raise BadFormatError("unsafe member %r"
                                         % member.name)
            try:
                tar.extractall(dest_dir, filter="data")
            except TypeError:  # Python < 3.12
                # No "data" filter here, so symlink/hardlink/device
                # members could write outside dest_dir — reject them
                # on this fallback only (the filter above permits
                # safe in-tree symlinks).
                for member in tar.getmembers():
                    if not (member.isreg() or member.isdir()):
                        raise BadFormatError(
                            "non-regular member %r (type %r)"
                            % (member.name, member.type))
                tar.extractall(dest_dir)
        self.info("fetched %s@%s -> %s", name, got_version, dest_dir)
        return dest_dir, got_version

    def delete(self, name):
        with self._request("/service", data=b"", query="delete",
                           name=name) as resp:
            return json.loads(resp.read())


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(prog="veles_tpu_torch.forge")
    parser.add_argument("action",
                        choices=("list", "details", "fetch",
                                 "upload", "delete"))
    parser.add_argument("target", nargs="?", default="",
                        help="model name (fetch/details/delete) or "
                             "package dir (upload)")
    parser.add_argument("-s", "--server", required=True,
                        metavar="HOST:PORT")
    parser.add_argument("--version", default=None)
    parser.add_argument("-o", "--output", default=".",
                        help="fetch destination directory")
    parser.add_argument("--token", default=os.environ.get(
        "VELES_FORGE_TOKEN"))
    args = parser.parse_args(argv)
    client = ForgeClient(args.server, token=args.token)
    if args.action == "list":
        print(json.dumps(client.list(), indent=2))
    elif args.action == "details":
        print(json.dumps(client.details(args.target), indent=2))
    elif args.action == "fetch":
        client.fetch(args.target, args.output,
                     version=args.version)
    elif args.action == "upload":
        client.upload(args.target, version=args.version)
    elif args.action == "delete":
        print(json.dumps(client.delete(args.target)))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
