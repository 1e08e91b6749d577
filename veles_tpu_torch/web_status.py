"""Web status dashboard (the JAX package's ``web_status``).

Launchers post heartbeats here (``Launcher(status_address=...)``,
``--status-address``); a stdlib ThreadingHTTPServer serves

* ``POST /update`` — launchers post heartbeat JSON; the response
  carries any queued commands for that master (the command round-trip
  rides the heartbeat instead of a callback socket — no inbound
  connection to the master needed);
* ``GET /`` — HTML dashboard of running workflows and their workers;
* ``GET /api/status`` — the raw JSON;
* ``POST /service`` — queue ``pause``/``resume`` (optionally
  per-worker) for a master.

* ``GET /metrics`` — Prometheus text of every tracked master's
  numeric heartbeat values.

Stale masters (no heartbeat for ``expiry`` seconds) are dropped.  With
a ``token`` every POST must carry it in ``X-Status-Token``.  Every
heartbeat field is escaped before it reaches the page.

Run: ``python -m veles_tpu_torch.web_status [--host H] [--port P]
[--token T]``.
"""

import html
import json
import threading
import time

from .http_common import JsonHttpServer, JsonRequestHandler

_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu status</title>
<meta http-equiv="refresh" content="5">
<style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #999; padding: 4px 10px; }}
th {{ background: #eee; }}
.dead {{ color: #999; }}
</style></head>
<body><h1>veles_tpu — running workflows</h1>
{rows}
<p>{count} master(s); page refreshes every 5 s.</p>
</body></html>"""


class WebStatusServer(JsonHttpServer):
    """The dashboard server."""

    def __init__(self, host="127.0.0.1", port=8090, expiry=30.0,
                 token=None):
        self.expiry = expiry
        self.token = token
        self._masters = {}  # id -> {payload, received}
        self._commands = {}  # id -> [command dicts]
        self._lock = threading.Lock()

        class Handler(JsonRequestHandler):
            def do_GET(self):
                outer = self.outer
                if self.path in ("/", "/index.html"):
                    self.reply(200, outer.render_page(),
                               "text/html")
                elif self.path == "/api/status":
                    self.reply(200, outer.status())
                elif self.path == "/metrics":
                    from .observability.metrics import CONTENT_TYPE
                    self.reply(200, outer.metrics_text(),
                               CONTENT_TYPE)
                else:
                    self.reply(404, {"error": "not found"})

            def do_POST(self):
                outer = self.outer
                if outer.token is not None and \
                        not self.check_token(outer.token):
                    self.reply(403, {"error": "bad token"})
                    return
                try:
                    payload = self.read_json()
                except ValueError:
                    self.reply(400, {"error": "bad json"})
                    return
                if self.path == "/update":
                    self.reply(200,
                               {"commands": outer.update(payload)})
                elif self.path == "/service":
                    try:
                        outer.queue_command(payload)
                        self.reply(200, {"status": "queued"})
                    except KeyError as e:
                        self.reply(400, {"error": str(e)})
                else:
                    self.reply(404, {"error": "not found"})

        super(WebStatusServer, self).__init__(
            Handler, host=host, port=port,
            thread_name="veles-web-status")

    # -- state -------------------------------------------------------------

    def update(self, payload):
        """Records a heartbeat; returns + clears queued commands.
        Launchers ship heavy static sections (graph, plots) only when
        new or changed — missing sections carry over from the
        previous beat."""
        mid = payload.get("id")
        if not mid:
            return []
        with self._lock:
            prev = self._masters.get(mid)
            if prev is not None:
                for section in ("graph", "plots"):
                    if section not in payload and \
                            section in prev["payload"]:
                        payload[section] = prev["payload"][section]
            self._masters[mid] = {"payload": payload,
                                  "received": time.time()}
            self._gc_locked()
            return self._commands.pop(mid, [])

    def queue_command(self, payload):
        mid = payload["master"]
        command = payload["command"]
        if command not in ("pause", "resume", "stop"):
            raise KeyError("unknown command %r" % command)
        with self._lock:
            if mid not in self._masters:
                raise KeyError("unknown master %r" % mid)
            self._commands.setdefault(mid, []).append(
                {"command": command,
                 "slave": payload.get("slave")})

    def status(self):
        with self._lock:
            self._gc_locked()
            now = time.time()
            return {mid: dict(entry["payload"],
                              age=now - entry["received"])
                    for mid, entry in self._masters.items()}

    def _gc_locked(self):
        cutoff = time.time() - self.expiry
        for mid in [m for m, e in self._masters.items()
                    if e["received"] < cutoff]:
            del self._masters[mid]
            self._commands.pop(mid, None)

    #: Heartbeat sections whose numeric leaves are re-exposed as
    #: labeled Prometheus gauges on ``GET /metrics`` — ONE scrape
    #: endpoint covers every master this dashboard tracks.
    METRIC_SECTIONS = ("comms", "resilience", "perf", "serving",
                      "fabric", "population", "fleet", "metrics")

    def metrics_text(self):
        """Prometheus text exposition: this process's own registry
        plus, per tracked master, every numeric value from the
        heartbeat's metric-bearing sections as a gauge labeled
        ``{master="<id>"}``."""
        from .observability import metrics as obs_metrics
        samples = []
        for mid, info in sorted(self.status().items()):
            for section in self.METRIC_SECTIONS:
                data = info.get(section)
                if not isinstance(data, dict):
                    continue
                for key, value in sorted(data.items()):
                    if isinstance(value, bool) or \
                            not isinstance(value, (int, float)):
                        continue
                    samples.append(("%s.%s" % (section, key),
                                    {"master": mid}, value))
            age = info.get("age")
            if isinstance(age, (int, float)):
                samples.append(("master.heartbeat_age_seconds",
                                {"master": mid}, age))
        return obs_metrics.render_prometheus(
            [obs_metrics.registry], extra_samples=samples)

    def render_page(self):
        # Heartbeat JSON is network-supplied: escape every interpolated
        # field so a hostile peer cannot store XSS into the dashboard.
        esc = lambda v: html.escape(str(v), quote=True)  # noqa: E731
        status = self.status()
        rows = []
        for mid, info in sorted(status.items()):
            workers = info.get("slaves", {})
            wtable = "".join(
                "<tr><td>%s</td><td>%s</td><td>%s</td><td>%s</td>"
                "</tr>" %
                (esc(sid), esc(w.get("state")),
                 esc(w.get("jobs_done")),
                 esc(w.get("jobs_per_s", "")))
                for sid, w in workers.items())
            try:
                runtime = float(info.get("runtime", 0.0))
            except (TypeError, ValueError):
                runtime = 0.0
            resilience = info.get("resilience")
            resilience_row = (
                "<tr><th>resilience</th><td>%s</td></tr>" %
                esc(json.dumps(resilience, sort_keys=True))
                if isinstance(resilience, dict) and resilience
                else "")
            # Comms row: wire bytes/frames and serialize/compress/
            # send timing totals from the distributed data plane.
            comms = info.get("comms")
            comms_row = (
                "<tr><th>comms</th><td>%s</td></tr>" %
                esc(json.dumps(comms, sort_keys=True))
                if isinstance(comms, dict) and comms else "")
            # Serving row: decode tok/s + paged KV-pool occupancy
            # from any in-process serving engine riding the beat.
            serving = info.get("serving")
            serving_row = (
                "<tr><th>serving</th><td>%s</td></tr>" %
                esc(json.dumps(serving, sort_keys=True))
                if isinstance(serving, dict) and serving else "")
            # Perf row: live device-time + MFU attribution of the
            # fused step (observability heartbeat "perf" section).
            perf = info.get("perf")
            perf_row = (
                "<tr><th>perf</th><td>%s</td></tr>" %
                esc(json.dumps(perf, sort_keys=True))
                if isinstance(perf, dict) and perf else "")
            # Training health (guardian heartbeat section): flag a
            # master that detected NaN/spike events prominently.
            health = info.get("health")
            health_row = ""
            if isinstance(health, dict) and health:
                style = ' style="color:#b00"' if \
                    health.get("events") else ""
                health_row = (
                    "<tr><th>health</th><td%s>%s</td></tr>" %
                    (style, esc(json.dumps(health, sort_keys=True,
                                           default=str))))
            # Population row: live per-member fitness + lineage
            # generations from the population engine's heartbeat
            # section.
            population = info.get("population")
            population_row = (
                "<tr><th>population</th><td>%s</td></tr>" %
                esc(json.dumps(population, sort_keys=True))
                if isinstance(population, dict) and population
                else "")
            # Fabric row: replica count, draining, routed totals and
            # the cross-replica prefix hit-rate from any serving
            # fabric riding the beat.
            fabric = info.get("fabric")
            fabric_row = (
                "<tr><th>fabric</th><td>%s</td></tr>" %
                esc(json.dumps(fabric, sort_keys=True))
                if isinstance(fabric, dict) and fabric else "")
            # Fleet row: membership epoch, live size, and the
            # join/leave/drain tallies from the elastic fleet's
            # heartbeat section.
            fleet = info.get("fleet")
            fleet_row = (
                "<tr><th>fleet</th><td>%s</td></tr>" %
                esc(json.dumps(fleet, sort_keys=True))
                if isinstance(fleet, dict) and fleet else "")
            rows.append(
                "<h2>%s <small>(%s)</small></h2>"
                "<table><tr><th>mode</th><td>%s</td></tr>"
                "<tr><th>epoch</th><td>%s</td></tr>"
                "<tr><th>runtime</th><td>%.0f s</td></tr>"
                "<tr><th>metrics</th><td>%s</td></tr>%s%s%s%s%s%s%s%s"
                "</table>" %
                (esc(info.get("workflow", "?")), esc(mid),
                 esc(info.get("mode", "?")), esc(info.get("epoch", "?")),
                 runtime,
                 esc(json.dumps(info.get("metrics", {}))),
                 health_row, resilience_row, comms_row,
                 serving_row, fabric_row, perf_row, population_row,
                 fleet_row) +
                ("<h3>workers</h3><table><tr><th>id</th><th>state"
                 "</th><th>jobs</th><th>jobs/s</th></tr>%s</table>"
                 % wtable if workers else "") +
                self._render_graph(info.get("graph")) +
                self._render_plots(info.get("plots")))
        return _PAGE.format(rows="\n".join(rows) or
                            "<p>nothing running.</p>",
                            count=len(status))

    #: DOT → rendered-SVG-img cache (graphviz layout is expensive and
    #: the graph is static; render each distinct DOT once, not per
    #: page load). Class-level, bounded.
    _SVG_CACHE = {}
    _SVG_CACHE_MAX = 32

    def _render_graph(self, dot):
        """Workflow graph section.  When the graphviz binary exists
        the DOT is rendered server-side to SVG and embedded as a
        data-URI <img> (img context: embedded scripts in a hostile
        SVG never execute); the DOT source is always available in a
        collapsible block.

        Server-side rendering runs ONLY when heartbeat POSTs require
        the status token: without auth, any client could POST
        arbitrary DOT to be parsed by the graphviz C library (a
        memory-unsafety attack surface) and each hash-distinct DOT
        costs a subprocess with a 10 s timeout (cheap DoS).  Unauth'd
        deployments still get the escaped DOT source block."""
        if not dot or not isinstance(dot, str) or len(dot) > 65536:
            return ""
        import base64
        import hashlib
        import shutil
        import subprocess
        dot_src = ("<details><summary>workflow graph (DOT)</summary>"
                   "<pre>%s</pre></details>" %
                   html.escape(dot, quote=True))
        if self.token is None:
            # No cache interaction either: a token-less instance must
            # not poison the class-level cache with empty renders for
            # an authed instance in the same process.
            return "<h3>graph</h3>" + dot_src
        cls = type(self)
        key = hashlib.sha256(dot.encode()).hexdigest()
        svg_img = cls._SVG_CACHE.get(key)
        if svg_img is None:
            svg_img = ""
            dot_bin = shutil.which("dot")
            if dot_bin:
                try:
                    proc = subprocess.run(
                        [dot_bin, "-Tsvg"], input=dot.encode(),
                        capture_output=True, timeout=10)
                    if proc.returncode == 0:
                        svg_img = (
                            '<p><img alt="workflow graph" '
                            'src="data:image/svg+xml;base64,%s">'
                            "</p>" % base64.b64encode(
                                proc.stdout).decode())
                except (OSError, subprocess.SubprocessError):
                    pass
            if len(cls._SVG_CACHE) >= cls._SVG_CACHE_MAX:
                cls._SVG_CACHE.clear()
            cls._SVG_CACHE[key] = svg_img
        return "<h3>graph</h3>" + svg_img + dot_src

    @staticmethod
    def _render_plots(plots):
        """Latest plot images riding the heartbeat, embedded as
        data-URI <img> after validating each blob really is a PNG."""
        if not isinstance(plots, dict) or not plots:
            return ""
        import base64
        imgs = []
        for name in sorted(plots)[:8]:
            blob = plots[name]
            if not isinstance(blob, str) or len(blob) > 512 * 1024:
                continue
            try:
                raw = base64.b64decode(blob, validate=True)
            except (ValueError, TypeError):
                continue
            if not raw.startswith(b"\x89PNG\r\n\x1a\n"):
                continue
            imgs.append(
                '<figure style="display:inline-block">'
                '<img alt="%s" style="max-width:420px" '
                'src="data:image/png;base64,%s">'
                "<figcaption>%s</figcaption></figure>" %
                (html.escape(str(name), quote=True), blob,
                 html.escape(str(name), quote=True)))
        if not imgs:
            return ""
        return "<h3>plots</h3>" + "".join(imgs)

    # -- lifecycle: start/serve/stop inherited from JsonHttpServer ---------

    def start(self):
        super(WebStatusServer, self).start()
        self.info("web status on port %d", self.port)
        return self

    def serve(self):
        self.info("web status on port %d", self.port)
        super(WebStatusServer, self).serve()


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(prog="veles_tpu_torch.web_status")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument(
        "--token", default=None,
        help="shared secret required (X-Status-Token header) on POSTs")
    args = parser.parse_args(argv)
    server = WebStatusServer(host=args.host, port=args.port,
                             token=args.token)
    try:
        server.serve()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
