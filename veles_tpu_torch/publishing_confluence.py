"""Confluence wiki publishing backend (the JAX package's
``publishing_confluence``).

The client targets the Confluence REST API (``/rest/api/content``):
the end-of-run report becomes a page under a space and an optional
parent page, created or version-bumped in the *storage*
representation; plot PNGs ride as attachments referenced with
``<ac:image>`` markup.

Config (``backend_config={"confluence": {...}}`` on the Publisher, or
``root.common.publishing.confluence``): ``server`` (base URL),
``username``/``password`` (basic auth; an API token works as the
password), ``space`` (the space KEY), ``parent`` (optional parent
page title), ``page`` (title, default = workflow name).
"""

import base64
import html
import json
import urllib.error
import urllib.request
import uuid

from .error import BadFormatError
from .logger import Logger
from .publishing import Backend


class ConfluenceClient(Logger):
    """Minimal REST client."""

    def __init__(self, server, username, password, timeout=60):
        super(ConfluenceClient, self).__init__()
        self.base = server.rstrip("/")
        self.timeout = timeout
        token = base64.b64encode(
            ("%s:%s" % (username, password)).encode()).decode()
        self._auth = "Basic " + token

    def _request(self, method, path, payload=None, content_type=None,
                 body=None):
        headers = {"Authorization": self._auth}
        data = body
        if payload is not None:
            data = json.dumps(payload).encode()
            headers["Content-Type"] = "application/json"
        elif content_type:
            headers["Content-Type"] = content_type
            # Confluence requires this header on attachment POSTs.
            headers["X-Atlassian-Token"] = "no-check"
        req = urllib.request.Request(
            self.base + path, data=data, headers=headers,
            method=method)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:500]
            raise BadFormatError(
                "confluence %s %s -> HTTP %d: %s"
                % (method, path, e.code, detail))
        except (urllib.error.URLError, OSError) as e:
            raise BadFormatError(
                "confluence %s %s failed: %s" % (method, path, e))

    def get_page(self, space, title):
        """Returns {id, version} for a page, or None."""
        from urllib.parse import quote
        reply = self._request(
            "GET", "/rest/api/content?spaceKey=%s&title=%s"
            "&expand=version" % (quote(space), quote(title)))
        results = reply.get("results") or []
        if not results:
            return None
        page = results[0]
        return {"id": page["id"],
                "version": page["version"]["number"]}

    def store_page(self, space, title, storage_body, parent=None):
        """Creates the page or bumps its version with a new body;
        returns the page id."""
        existing = self.get_page(space, title)
        payload = {
            "type": "page",
            "title": title,
            "space": {"key": space},
            "body": {"storage": {"value": storage_body,
                                 "representation": "storage"}},
        }
        if existing is None:
            if parent:
                parent_page = self.get_page(space, parent)
                if parent_page is None:
                    raise BadFormatError(
                        "confluence parent page %r not found in "
                        "space %s" % (parent, space))
                payload["ancestors"] = [{"id": parent_page["id"]}]
            reply = self._request("POST", "/rest/api/content",
                                  payload)
            return reply["id"]
        payload["version"] = {"number": existing["version"] + 1}
        self._request("PUT", "/rest/api/content/%s" % existing["id"],
                      payload)
        return existing["id"]

    def _find_attachment(self, page_id, filename):
        from urllib.parse import quote
        reply = self._request(
            "GET", "/rest/api/content/%s/child/attachment"
            "?filename=%s" % (page_id, quote(filename)))
        results = reply.get("results") or []
        return results[0]["id"] if results else None

    def attach(self, page_id, filename, blob, mime="image/png"):
        """Uploads or REPLACES one attachment: a POST with an
        already-used filename is a 400 on real Confluence, so updates
        go through the attachment's ``/data`` endpoint."""
        boundary = uuid.uuid4().hex
        body = b"".join([
            b"--", boundary.encode(), b"\r\n",
            b'Content-Disposition: form-data; name="file"; '
            b'filename="', filename.encode(), b'"\r\n',
            b"Content-Type: ", mime.encode(), b"\r\n\r\n",
            blob, b"\r\n--", boundary.encode(), b"--\r\n"])
        existing = self._find_attachment(page_id, filename)
        path = "/rest/api/content/%s/child/attachment" % page_id
        if existing is not None:
            path += "/%s/data" % existing
        self._request(
            "POST", path,
            content_type="multipart/form-data; boundary=%s"
            % boundary, body=body)


class ConfluenceBackend(Backend):
    """Publishes the report as a wiki page + attached plots."""

    MAPPING = "confluence"

    def __init__(self, **kwargs):
        from .config import root, get as config_get
        cfg = root.common.publishing.confluence
        self.server = kwargs.get("server", config_get(cfg.server, ""))
        self.username = kwargs.get("username",
                                   config_get(cfg.username, ""))
        self.password = kwargs.get("password",
                                   config_get(cfg.password, ""))
        self.space = kwargs.get("space", config_get(cfg.space, ""))
        self.parent = kwargs.get("parent",
                                 config_get(cfg.parent, None))
        self.page = kwargs.get("page", config_get(cfg.page, None))
        if not (self.server and self.space):
            raise BadFormatError(
                "confluence backend needs server + space "
                "(root.common.publishing.confluence.*)")

    def storage_body(self, report):
        """The page body in Confluence *storage* markup; plots are
        referenced as attachments (data: URIs are not supported
        there)."""
        esc = lambda v: html.escape(str(v), quote=True)  # noqa: E731
        parts = ["<p><em>Generated %s</em></p>"
                 % esc(report["generated"]),
                 "<h2>Results</h2><ul>"]
        for key, value in sorted(report["results"].items()):
            parts.append("<li><strong>%s</strong>: %s</li>"
                         % (esc(key), esc(value)))
        parts.append(
            "</ul><h2>Run</h2><p>mode %s, %.1f s, %d units, "
            "checksum <code>%s</code></p>"
            % (esc(report["mode"]), report["runtime"],
               report["units"], esc(report["checksum"])))
        for i, plot in enumerate(report["plots"]):
            parts.append(
                '<h3>%s</h3><ac:image><ri:attachment '
                'ri:filename="plot_%d.png"/></ac:image>'
                % (esc(plot["name"]), i))
        return "".join(parts)

    def render(self, report, output_dir):
        client = ConfluenceClient(self.server, self.username,
                                  self.password)
        title = self.page or report["workflow"]
        page_id = client.store_page(self.space, title,
                                    self.storage_body(report),
                                    parent=self.parent)
        for i, plot in enumerate(report["plots"]):
            client.attach(page_id, "plot_%d.png" % i,
                          self._png_of(plot))
        url = "%s/spaces/%s/pages/%s" % (self.server.rstrip("/"),
                                         self.space, page_id)
        return url
