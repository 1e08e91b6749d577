"""Forge server: a versioned model-package registry over HTTP, on the
framework's stdlib HTTP base (``http_common``):

* ``GET /service?query=list`` — `[{name, version, short_description,
  versions}]`
* ``GET /service?query=details&name=N`` — full manifest + history
* ``GET /fetch?name=N[&version=V]`` — package tar.gz (latest when no
  version)
* ``POST /upload?name=N&version=V`` — package tar.gz body (manifest
  validated before anything lands)
* ``POST /service?query=delete&name=N`` — drop a model
* ``GET /`` — a minimal HTML gallery.

Versioning keeps every uploaded tarball under
``<root>/<model>/<version>.tar.gz`` plus a git repo per model when
git is available (it enriches the history; its absence does not
break the registry).  Mutating
requests require ``X-Forge-Token`` when the server was given a token.
"""

import io
import json
import os
import re
import shutil
import subprocess
import tarfile
import time

from ..error import BadFormatError
from ..http_common import JsonHttpServer, JsonRequestHandler
from . import MANIFEST_NAME, REQUIRED_FIELDS

_NAME_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


def validate_package(blob):
    """Checks a package tarball: manifest present + required fields;
    returns the manifest.  Member paths are vetted (zip-slip); a
    body that is not a gzipped tar is a client error, not a server
    crash."""
    try:
        tar_cm = tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz")
    except (tarfile.TarError, OSError, EOFError) as e:
        raise BadFormatError("not a package tarball: %s" % e)
    with tar_cm as tar:
        names = tar.getnames()
        for name in names:
            if name.startswith("/") or ".." in name.split("/"):
                raise BadFormatError("unsafe member path %r" % name)
        try:
            manifest = json.loads(
                tar.extractfile(MANIFEST_NAME).read())
        except (KeyError, ValueError, AttributeError):
            raise BadFormatError("package lacks a valid %s"
                                 % MANIFEST_NAME)
    missing = [f for f in REQUIRED_FIELDS if f not in manifest]
    if missing:
        raise BadFormatError("manifest lacks required fields: %s"
                             % ", ".join(missing))
    if manifest["workflow"] not in names:
        raise BadFormatError("manifest names workflow %r which is "
                             "not in the package"
                             % manifest["workflow"])
    return manifest


class ForgeServer(JsonHttpServer):
    def __init__(self, root_dir, host="0.0.0.0", port=8187,
                 token=None):
        self.root_dir = os.path.abspath(root_dir)
        os.makedirs(self.root_dir, exist_ok=True)
        self.token = token

        class Handler(JsonRequestHandler):
            def _authorized(self):
                outer = self.outer
                if outer.token is None:
                    return True
                if self.headers.get("X-Forge-Token") == outer.token:
                    return True
                self.reply(403, {"error": "bad or missing "
                                          "X-Forge-Token"})
                return False

            def do_GET(self):
                import urllib.parse
                outer = self.outer
                url = urllib.parse.urlparse(self.path)
                params = dict(urllib.parse.parse_qsl(url.query))
                if url.path == "/service":
                    query = params.get("query")
                    if query == "list":
                        self.reply(200, outer.list_models())
                    elif query == "details":
                        try:
                            self.reply(200, outer.details(
                                params.get("name", "")))
                        except KeyError as e:
                            self.reply(404, {"error": str(e)})
                    else:
                        self.reply(400,
                                   {"error": "unknown query %r"
                                    % query})
                elif url.path == "/fetch":
                    try:
                        blob, version = outer.fetch(
                            params.get("name", ""),
                            params.get("version"))
                    except KeyError as e:
                        self.reply(404, {"error": str(e)})
                        return
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/gzip")
                    self.send_header("X-Forge-Version", version)
                    self.send_header("Content-Length",
                                     str(len(blob)))
                    self.end_headers()
                    self.wfile.write(blob)
                elif url.path in ("/", "/index.html"):
                    self.reply(200, outer.render_gallery(),
                               "text/html")
                else:
                    self.reply(404, {"error": "not found"})

            def do_POST(self):
                import urllib.parse
                outer = self.outer
                url = urllib.parse.urlparse(self.path)
                params = dict(urllib.parse.parse_qsl(url.query))
                if not self._authorized():
                    return
                if url.path == "/upload":
                    length = int(self.headers.get("Content-Length",
                                                  0))
                    blob = self.rfile.read(length)
                    try:
                        manifest = outer.upload(
                            params.get("name", ""),
                            params.get("version", ""), blob)
                    except BadFormatError as e:
                        self.reply(400, {"error": str(e)})
                        return
                    self.reply(200, {"status": "stored",
                                     "name": manifest["name"]})
                elif url.path == "/service" and \
                        params.get("query") == "delete":
                    try:
                        outer.delete(params.get("name", ""))
                        self.reply(200, {"status": "deleted"})
                    except KeyError as e:
                        self.reply(404, {"error": str(e)})
                else:
                    self.reply(404, {"error": "not found"})

        super(ForgeServer, self).__init__(
            Handler, host=host, port=port, thread_name="veles-forge")
        self.info("forge registry at %s (port %d)", self.root_dir,
                  self.port)

    # -- registry operations ---------------------------------------------

    def _model_dir(self, name, must_exist=True):
        if not _NAME_RE.match(name or ""):
            raise KeyError("bad model name %r" % name)
        path = os.path.join(self.root_dir, name)
        if must_exist and not os.path.isdir(path):
            raise KeyError("no model named %r" % name)
        return path

    def _versions(self, name):
        """Upload order from the order file — mtime would promote a
        re-uploaded OLD version to latest and ties on coarse-mtime
        filesystems order arbitrarily."""
        path = self._model_dir(name)
        order_path = os.path.join(path, "versions.json")
        order = []
        if os.path.isfile(order_path):
            with open(order_path) as fin:
                order = json.load(fin)
        present = {f[:-len(".tar.gz")] for f in os.listdir(path)
                   if f.endswith(".tar.gz")}
        versions = [v for v in order if v in present]
        versions.extend(sorted(present - set(versions)))
        return versions

    def _record_version(self, path, version):
        order_path = os.path.join(path, "versions.json")
        order = []
        if os.path.isfile(order_path):
            with open(order_path) as fin:
                order = json.load(fin)
        if version not in order:  # re-upload keeps its position
            order.append(version)
            with open(order_path, "w") as fout:
                json.dump(order, fout)

    def upload(self, name, version, blob):
        manifest = validate_package(blob)
        if name and name != manifest["name"]:
            raise BadFormatError(
                "query name %r != manifest name %r"
                % (name, manifest["name"]))
        name = manifest["name"]
        if not _NAME_RE.match(name):
            raise BadFormatError("bad model name %r" % name)
        version = version or manifest.get("version") or \
            time.strftime("%Y%m%d%H%M%S")
        if not _NAME_RE.match(version):
            raise BadFormatError("bad version %r" % version)
        path = self._model_dir(name, must_exist=False)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, version + ".tar.gz"),
                  "wb") as fout:
            fout.write(blob)
        with open(os.path.join(path, MANIFEST_NAME), "w") as fout:
            json.dump(dict(manifest, version=version), fout,
                      indent=2)
        self._record_version(path, version)
        self._git(path, version)
        self.info("stored %s version %s (%d bytes)", name, version,
                  len(blob))
        return manifest

    def _git(self, path, version):
        """Per-model git history, best-effort — the registry works
        without git."""
        git = shutil.which("git")
        if git is None:
            return
        try:
            if not os.path.isdir(os.path.join(path, ".git")):
                subprocess.run([git, "init", "-q"], cwd=path,
                               check=True, capture_output=True)
            subprocess.run([git, "add", "-A"], cwd=path, check=True,
                           capture_output=True)
            subprocess.run(
                [git, "-c", "user.name=forge",
                 "-c", "user.email=forge@localhost",
                 "commit", "-q", "-m", "version %s" % version,
                 "--allow-empty"],
                cwd=path, check=True, capture_output=True)
        except subprocess.CalledProcessError as e:
            self.warning("git versioning failed: %s",
                         e.stderr.decode(errors="replace")[-500:])

    def fetch(self, name, version=None):
        versions = self._versions(name)
        if not versions:
            raise KeyError("model %r has no versions" % name)
        if version is None:
            version = versions[-1]
        elif version not in versions:
            raise KeyError("model %r has no version %r"
                           % (name, version))
        with open(os.path.join(self._model_dir(name),
                               version + ".tar.gz"), "rb") as fin:
            return fin.read(), version

    def list_models(self):
        out = []
        for name in sorted(os.listdir(self.root_dir)):
            path = os.path.join(self.root_dir, name)
            manifest_path = os.path.join(path, MANIFEST_NAME)
            if not os.path.isfile(manifest_path):
                continue
            with open(manifest_path) as fin:
                manifest = json.load(fin)
            out.append({
                "name": name,
                "version": manifest.get("version"),
                "short_description":
                    manifest.get("short_description", ""),
                "versions": self._versions(name),
            })
        return out

    def details(self, name):
        path = self._model_dir(name)
        with open(os.path.join(path, MANIFEST_NAME)) as fin:
            manifest = json.load(fin)
        return dict(manifest, versions=self._versions(name))

    def delete(self, name):
        shutil.rmtree(self._model_dir(name))
        self.info("deleted model %s", name)

    def render_gallery(self):
        import html as html_mod
        import urllib.parse
        rows = "".join(
            "<tr><td><b>%s</b></td><td>%s</td><td>%s</td>"
            "<td><a href='/fetch?name=%s'>fetch</a></td></tr>"
            % (html_mod.escape(m["name"]),
               html_mod.escape(str(m["version"])),
               html_mod.escape(m["short_description"]),
               urllib.parse.quote(m["name"]))
            for m in self.list_models())
        return ("<html><head><title>veles_tpu forge</title></head>"
                "<body><h1>Model gallery</h1><table border=1>"
                "<tr><th>name</th><th>version</th><th>description"
                "</th><th></th></tr>%s</table></body></html>" % rows)
