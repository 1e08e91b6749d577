"""The port's operator services — the forge registry, the publisher and
its backends, the shell unit — against the JAX package's, on the CPU.

The counterparts of the JAX package's ``tests/test_services.py`` (its
frontend test waits for ROADMAP A8b-ii): forge upload, list, fetch and
delete; its git history; bad packages; token auth; the gallery's
escaping; a bad upload body; the version order after a re-upload; the
Markdown, HTML and PDF reports of an MNIST run; the Confluence backend
against a local stub server (page under a parent, plot attachment,
basic auth, a version bump on re-publish); the scripted shell.  The
parity tests: the same packages give the same forge listings and
details in both packages, and the same MNIST run gives the same
Markdown report but for its timestamp, runtime, timings table and
source checksum.

Every server binds port 0 and every test runs under
``test_torch_network.kept_process_state``.
"""

import io
import json
import os
import shutil
import subprocess
import tarfile
import threading
import urllib.error
import urllib.request

import pytest

from veles_tpu_torch import prng as tprng
from veles_tpu_torch.error import BadFormatError
from veles_tpu_torch.launcher import Launcher

from test_torch_network import MLP, kept_process_state, write_mnist_idx


@pytest.fixture(autouse=True)
def _process_state():
    with kept_process_state():
        yield


# -- forge -------------------------------------------------------------------


@pytest.fixture
def forge(tmp_path):
    from veles_tpu_torch.forge import ForgeServer
    server = ForgeServer(str(tmp_path / "registry"), host="127.0.0.1",
                         port=0).start()
    yield server
    server.stop()


def _make_package(tmp_path, name="mnist-fc", extra=None):
    pkg = tmp_path / name
    pkg.mkdir(exist_ok=True)
    manifest = {"name": name, "workflow": "workflow.py",
                "short_description": "MNIST FC net", "author": "tests"}
    manifest.update(extra or {})
    (pkg / "manifest.json").write_text(json.dumps(manifest))
    (pkg / "workflow.py").write_text("# the workflow module\n")
    (pkg / "config.py").write_text("root.mnist.layers = (64, 10)\n")
    return str(pkg)


def _client(server, **kw):
    from veles_tpu_torch.forge import ForgeClient
    return ForgeClient("127.0.0.1:%d" % server.port, **kw)


def test_forge_upload_list_fetch_delete(forge, tmp_path):
    client = _client(forge)
    pkg = _make_package(tmp_path)
    client.upload(pkg, version="v1")
    client.upload(pkg, version="v2")
    models = client.list()
    assert len(models) == 1
    assert models[0]["name"] == "mnist-fc"
    assert models[0]["versions"] == ["v1", "v2"]
    assert client.details("mnist-fc")["short_description"] == \
        "MNIST FC net"
    dest = tmp_path / "fetched"
    _, version = client.fetch("mnist-fc", str(dest))
    assert version == "v2"
    assert (dest / "workflow.py").is_file()
    _, version = client.fetch("mnist-fc", str(dest), version="v1")
    assert version == "v1"
    client.delete("mnist-fc")
    assert client.list() == []


def test_forge_listings_match_jax(forge, tmp_path):
    """The same uploads to the port's registry and the JAX package's
    give the same listing, details (the stored manifest with its
    version history) and fetched files."""
    from veles_tpu.forge import ForgeClient as JClient
    from veles_tpu.forge import ForgeServer as JServer
    jserver = JServer(str(tmp_path / "jreg"), host="127.0.0.1",
                      port=0).start()
    try:
        clients = (_client(forge),
                   JClient("127.0.0.1:%d" % jserver.port))
        pkgs = [_make_package(tmp_path, "alpha"),
                _make_package(tmp_path, "beta",
                              extra={"version": "7", "tags": ["x"]})]
        for client in clients:
            client.upload(pkgs[0], version="v1")
            client.upload(pkgs[1])
            client.upload(pkgs[0], version="v2")
            client.upload(pkgs[0], version="v1")
        assert clients[0].list() == clients[1].list()
        assert [m["name"] for m in clients[0].list()] == ["alpha", "beta"]
        for name in ("alpha", "beta"):
            assert clients[0].details(name) == clients[1].details(name)
        for i, client in enumerate(clients):
            _, version = client.fetch("alpha", str(tmp_path / str(i)))
            assert version == "v2"
        assert sorted(os.listdir(tmp_path / "0")) == \
            sorted(os.listdir(tmp_path / "1"))
        assert forge.render_gallery() == jserver.render_gallery()
    finally:
        jserver.stop()


def test_forge_git_history(forge, tmp_path):
    if shutil.which("git") is None:
        pytest.skip("no git")
    client = _client(forge)
    pkg = _make_package(tmp_path)
    client.upload(pkg, version="v1")
    client.upload(pkg, version="v2")
    log = subprocess.run(
        ["git", "log", "--oneline"], cwd=os.path.join(forge.root_dir,
                                                      "mnist-fc"),
        capture_output=True, text=True).stdout
    assert "version v1" in log and "version v2" in log


def test_forge_rejects_bad_packages(forge, tmp_path):
    from veles_tpu_torch.forge.server import validate_package
    client = _client(forge)
    pkg = tmp_path / "bad"
    pkg.mkdir()
    (pkg / "manifest.json").write_text(json.dumps({"name": "bad"}))
    with pytest.raises(BadFormatError):
        client.upload(str(pkg))
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        blob = b"evil"
        info = tarfile.TarInfo("../../escape")
        info.size = len(blob)
        tar.addfile(info, io.BytesIO(blob))
    with pytest.raises(BadFormatError):
        validate_package(buf.getvalue())


def test_forge_token_auth(tmp_path):
    from veles_tpu_torch.forge import ForgeServer
    server = ForgeServer(str(tmp_path / "reg"), host="127.0.0.1", port=0,
                         token="sekrit").start()
    try:
        pkg = _make_package(tmp_path)
        with pytest.raises(urllib.error.HTTPError) as e:
            _client(server).upload(pkg)
        assert e.value.code == 403
        good = _client(server, token="sekrit")
        good.upload(pkg, version="v1")
        assert good.list()[0]["name"] == "mnist-fc"
    finally:
        server.stop()


def test_forge_gallery_escapes_manifest_html(forge, tmp_path):
    client = _client(forge)
    pkg = _make_package(tmp_path, name="xss-model", extra={
        "short_description": "<script>alert(1)</script>"})
    client.upload(pkg, version="v1")
    page = forge.render_gallery()
    assert "<script>alert(1)</script>" not in page
    assert "&lt;script&gt;" in page


def test_forge_bad_upload_body_is_400(forge):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/upload?name=x" % forge.port,
        data=b"this is not a tarball")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_forge_reupload_keeps_version_order(forge, tmp_path):
    client = _client(forge)
    pkg = _make_package(tmp_path)
    for version in ("v1", "v2", "v1"):
        client.upload(pkg, version=version)
    _, version = client.fetch("mnist-fc", str(tmp_path / "refetch"))
    assert version == "v2"


def test_forge_command_line(forge, tmp_path, capsys):
    from veles_tpu_torch.forge.client import main
    pkg = _make_package(tmp_path)
    server = "127.0.0.1:%d" % forge.port
    assert main(["upload", pkg, "-s", server, "--version", "v3"]) == 0
    capsys.readouterr()
    assert main(["list", "-s", server]) == 0
    assert json.loads(capsys.readouterr().out)[0]["versions"] == ["v3"]
    assert main(["fetch", "mnist-fc", "-s", server,
                 "-o", str(tmp_path / "out")]) == 0
    assert (tmp_path / "out" / "manifest.json").is_file()


# -- publishing ------------------------------------------------------------


@pytest.fixture
def mnist_data(tmp_path):
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root as troot
    write_mnist_idx(str(tmp_path))
    for r in (jroot, troot):
        r.common.dirs.datasets = str(tmp_path)
        r.common.engine.precision_level = 1
    return jroot, troot


def _published_mnist(pkg, out, backends, **kw):
    """The MNIST run of ``pkg`` ("port" or "jax") with a validation-error
    plotter and a Publisher gated on the decision's completion."""
    if pkg == "port":
        from veles_tpu_torch.plotting_units import AccumulatingPlotter
        from veles_tpu_torch.publishing import Publisher
        from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
        prng, launcher = tprng, Launcher()
    else:
        import veles_tpu.prng as prng
        from veles_tpu.launcher import Launcher as JLauncher
        from veles_tpu.plotting_units import AccumulatingPlotter
        from veles_tpu.publishing import Publisher
        from veles_tpu.znicz.samples.mnist import MnistWorkflow
        launcher = JLauncher()
    prng.reset()
    prng.get(0).seed(5)
    wf = MnistWorkflow(launcher, **MLP)
    plot = AccumulatingPlotter(wf, name="val err", input=wf.decision,
                               input_field="min_validation_err")
    plot.link_from(wf.decision)
    pub = Publisher(wf, backends=backends, output_dir=str(out), **kw)
    pub.link_from(wf.decision)
    pub.gate_block = ~wf.decision.complete
    if pkg == "port":
        launcher.initialize(device="cpu")
    else:
        launcher.initialize()
    launcher.run()
    return wf, pub


def test_publisher_renders_all_backends(mnist_data, tmp_path):
    out = tmp_path / "report"
    _, pub = _published_mnist("port", out, ("markdown", "html", "pdf"))
    assert len(pub.outputs) == 3
    md = (out / "report.md").read_text()
    assert "min_validation_err" in md and "MnistWorkflow" in md
    assert "plot_0" in md and "## Config" in md
    assert "data:image/png;base64," in (out / "report.html").read_text()
    assert (out / "report.pdf").stat().st_size > 1000
    assert (out / "images" / "plot_0.png").read_bytes().startswith(
        b"\x89PNG")


def _comparable(markdown):
    """A Markdown report without what differs by design between two runs
    of two packages: the timestamp, the runtime, the unit timings and
    the checksum of the workflow's source file."""
    lines, skip = [], False
    for line in markdown.splitlines():
        if line.startswith("## "):
            skip = line == "## Unit timings"
        if skip or line.startswith(("*Generated ", "- runtime: ",
                                    "- checksum: ")):
            continue
        lines.append(line)
    return lines


def test_markdown_report_matches_jax(mnist_data, tmp_path):
    """The same MNIST run's Markdown report in both packages, minus the
    timestamp, runtime, timings and checksum (the config section left
    out: each package's tree holds its own knobs)."""
    reports = []
    for pkg in ("port", "jax"):
        out = tmp_path / pkg
        _published_mnist(pkg, out, ("markdown",), include_config=False)
        reports.append((out / "report.md").read_text())
    assert _comparable(reports[0]) == _comparable(reports[1])
    assert "- **min_validation_err**:" in reports[0]


class _FakeConfluence(threading.Thread):
    """A minimal in-memory Confluence REST endpoint: pages by title,
    attachments by page, the Authorization headers seen."""

    def __init__(self):
        super(_FakeConfluence, self).__init__(daemon=True,
                                              name="test-confluence")
        import http.server
        outer = self
        self.pages = {}
        self.attachments = {}
        self.auth_seen = []
        self._next_id = 1000

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, payload):
                blob = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_GET(self):
                from urllib.parse import urlparse, parse_qs
                outer.auth_seen.append(self.headers.get("Authorization"))
                q = parse_qs(urlparse(self.path).query)
                if "/child/attachment" in self.path:
                    page_id = self.path.split("/")[4]
                    fname = q.get("filename", [""])[0]
                    found = fname in outer.attachments.get(page_id, {})
                    self._reply(200, {"results": [
                        {"id": "att-%s-%s" % (page_id, fname)}]
                        if found else []})
                    return
                page = outer.pages.get(q.get("title", [""])[0])
                self._reply(200, {"results": [] if page is None else [{
                    "id": page["id"],
                    "version": {"number": page["version"]}}]})

            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                if "/child/attachment" in self.path:
                    page_id = self.path.split("/")[4]
                    fname = body.split(b'filename="')[1].split(
                        b'"')[0].decode()
                    payload = body.split(b"\r\n\r\n", 1)[1].rsplit(
                        b"\r\n--", 1)[0]
                    existing = outer.attachments.setdefault(page_id, {})
                    if fname in existing and \
                            not self.path.endswith("/data"):
                        self._reply(400, {"message": "duplicate filename"})
                        return
                    existing[fname] = payload
                    self._reply(200, {})
                    return
                data = json.loads(body)
                pid = str(outer._next_id)
                outer._next_id += 1
                outer.pages[data["title"]] = {
                    "id": pid, "version": 1,
                    "body": data["body"]["storage"]["value"],
                    "parent": (data.get("ancestors") or
                               [{"id": None}])[0]["id"]}
                self._reply(200, {"id": pid})

            def do_PUT(self):
                data = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))))
                page = outer.pages[data["title"]]
                page["version"] = data["version"]["number"]
                page["body"] = data["body"]["storage"]["value"]
                self._reply(200, {"id": page["id"]})

        self.httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]

    def run(self):
        self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.join(10)


def test_publisher_confluence_backend(mnist_data, tmp_path):
    """A page under the parent, the plot attached, basic auth; a second
    publish bumps the page's version and replaces the attachment."""
    import base64
    from veles_tpu_torch.config import root as troot
    server = _FakeConfluence()
    server.start()
    try:
        server.pages["Experiments"] = {"id": "7", "version": 3,
                                       "body": "", "parent": None}
        cfg = troot.common.publishing.confluence
        cfg.server = "http://127.0.0.1:%d" % server.port
        cfg.username = "bot"
        cfg.password = "token123"
        cfg.space = "ML"
        cfg.parent = "Experiments"
        cfg.page = None
        _, pub = _published_mnist("port", tmp_path, ("confluence",))
        assert len(pub.outputs) == 1
        page = server.pages["MnistWorkflow"]
        assert page["parent"] == "7"
        assert "min_validation_err" in page["body"]
        assert 'ri:filename="plot_0.png"' in page["body"]
        assert server.attachments[page["id"]]["plot_0.png"].startswith(
            b"\x89PNG")
        assert pub.outputs[0].endswith("/pages/%s" % page["id"])
        assert "Basic " + base64.b64encode(b"bot:token123").decode() in \
            server.auth_seen
        pub.run()
        assert server.pages["MnistWorkflow"]["version"] == 2
    finally:
        server.stop()


def test_confluence_backend_needs_server_and_space():
    from veles_tpu_torch.publishing_confluence import ConfluenceBackend
    with pytest.raises(BadFormatError):
        ConfluenceBackend(server="http://127.0.0.1:1")
    backend = ConfluenceBackend(server="http://x", space="ML")
    body = backend.storage_body({
        "generated": "<now>", "results": {"<k>": 1}, "mode": "m",
        "runtime": 1.0, "units": 2, "checksum": "c", "plots": []})
    assert "&lt;k&gt;" in body and "<k>" not in body


# -- the shell -------------------------------------------------------------


def test_shell_scripted_commands(mnist_data):
    from veles_tpu_torch.interaction import Shell
    from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
    tprng.reset()
    tprng.get(0).seed(1)
    launcher = Launcher()
    wf = MnistWorkflow(launcher, **dict(MLP, learning_rate=0.1))
    shell = Shell(wf, once=True, commands=[
        "workflow.probe_value = len(units)",
        "workflow.probed_lr = units['gd_fc1'].learning_rate",
        "workflow.shell_runs = getattr(workflow, 'shell_runs', 0) + 1",
    ])
    shell.link_from(wf.decision)
    launcher.initialize(device="cpu")
    launcher.run()
    assert wf.probe_value == len(wf.units)
    assert wf.probed_lr == 0.1
    assert wf.shell_runs == 1  # once=True: the first firing only
    assert set(shell.namespace()) == {"workflow", "launcher", "units",
                                      "numpy"}
