"""End-of-run report publishing (the JAX package's ``publishing``).

The :class:`Publisher` unit collects the workflow's name, config,
results, unit timings and its plotters' last captures, and renders them
through a registry of backends — Markdown (``report.md`` + PNGs), HTML
(one page, images inlined as base64), PDF (matplotlib's ``PdfPages``)
and Confluence (a wiki page with attachments over the REST API, see
``publishing_confluence``).  Plots render with matplotlib on the host;
the training process needs it only when a Publisher with plots runs.
"""

import base64
import io
import json
import os
import time

from .json_encoders import dumps_json
from .registry import MappedObjectRegistry
from .units import Unit


class BackendRegistry(MappedObjectRegistry):
    """String → report backend."""
    registry = {}


class Backend(metaclass=BackendRegistry):
    def render(self, report, output_dir):
        raise NotImplementedError()

    @staticmethod
    def _png_of(plot):
        """Renders one plotter's (class, data) capture to PNG
        bytes."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(8, 6))
        try:
            plot["cls"].render(plot["data"], fig)
            buf = io.BytesIO()
            fig.savefig(buf, format="png")
            return buf.getvalue()
        finally:
            plt.close(fig)


class MarkdownBackend(Backend):
    """report.md + images/."""

    MAPPING = "markdown"

    def render(self, report, output_dir):
        img_dir = os.path.join(output_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        lines = ["# %s" % report["workflow"], "",
                 "*Generated %s*" % report["generated"], "",
                 "## Results", ""]
        for key, value in sorted(report["results"].items()):
            lines.append("- **%s**: %s" % (key, value))
        lines += ["", "## Run", "",
                  "- mode: %s" % report["mode"],
                  "- runtime: %.1f s" % report["runtime"],
                  "- units: %d" % report["units"],
                  "- checksum: `%s`" % report["checksum"], ""]
        if report["unit_stats"]:
            lines += ["## Unit timings", "",
                      "| unit | time (s) | runs |", "|---|---|---|"]
            for name, rt, runs in report["unit_stats"]:
                lines.append("| %s | %.3f | %d |" % (name, rt, runs))
            lines.append("")
        for i, plot in enumerate(report["plots"]):
            png = self._png_of(plot)
            img = os.path.join(img_dir, "plot_%d.png" % i)
            with open(img, "wb") as fout:
                fout.write(png)
            lines.append("![%s](images/plot_%d.png)"
                         % (plot["name"], i))
        if report.get("config"):
            lines += ["", "## Config", "", "```json",
                      dumps_json(report["config"], indent=2), "```"]
        path = os.path.join(output_dir, "report.md")
        with open(path, "w") as fout:
            fout.write("\n".join(lines) + "\n")
        return path


class HTMLBackend(Backend):
    """Self-contained page, plots inlined."""

    MAPPING = "html"

    def render(self, report, output_dir):
        os.makedirs(output_dir, exist_ok=True)
        parts = ["<html><head><title>%s</title></head><body>"
                 % report["workflow"],
                 "<h1>%s</h1><p><i>%s</i></p>" %
                 (report["workflow"], report["generated"]),
                 "<h2>Results</h2><ul>"]
        for key, value in sorted(report["results"].items()):
            parts.append("<li><b>%s</b>: %s</li>" % (key, value))
        parts.append("</ul><h2>Run</h2><p>mode %s, %.1f s, %d units"
                     "</p>" % (report["mode"], report["runtime"],
                               report["units"]))
        for plot in report["plots"]:
            b64 = base64.b64encode(self._png_of(plot)).decode()
            parts.append("<h3>%s</h3><img src='data:image/png;"
                         "base64,%s'/>" % (plot["name"], b64))
        parts.append("</body></html>")
        path = os.path.join(output_dir, "report.html")
        with open(path, "w") as fout:
            fout.write("\n".join(parts))
        return path


class PDFBackend(Backend):
    """Multi-page PDF via matplotlib."""

    MAPPING = "pdf"

    def render(self, report, output_dir):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.backends.backend_pdf import PdfPages
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, "report.pdf")
        with PdfPages(path) as pdf:
            fig = plt.figure(figsize=(8.27, 11.69))
            fig.text(0.5, 0.92, report["workflow"], ha="center",
                     fontsize=20)
            fig.text(0.5, 0.88, report["generated"], ha="center",
                     fontsize=9)
            text = "\n".join("%s: %s" % kv for kv in
                             sorted(report["results"].items()))
            fig.text(0.1, 0.5, text, fontsize=11, va="center")
            pdf.savefig(fig)
            plt.close(fig)
            for plot in report["plots"]:
                fig = plt.figure(figsize=(8.27, 11.69))
                plot["cls"].render(plot["data"], fig)
                pdf.savefig(fig)
                plt.close(fig)
        return path


class Publisher(Unit):
    """Report unit: link after the Decision, gate on completion.

    kwargs: ``backends`` — names from the registry (default
    ("markdown",)); ``output_dir``; ``include_config`` — embed the
    effective config tree; ``backend_config`` — {backend name:
    constructor kwargs} (e.g. the confluence server/space; backends
    otherwise read their root.common.publishing.* config).
    """

    def __init__(self, workflow, **kwargs):
        super(Publisher, self).__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.backends = tuple(kwargs.get("backends", ("markdown",)))
        self.output_dir = kwargs.get("output_dir", "report")
        self.include_config = kwargs.get("include_config", True)
        self.backend_config = dict(kwargs.get("backend_config") or {})
        self.outputs = []

    def gather_report(self):
        from .config import root
        from .plotter import Plotter
        wf = self.workflow
        launcher = getattr(wf, "launcher", None)
        plots = []
        for unit in wf.units:
            if isinstance(unit, Plotter) and \
                    unit.last_data is not None:
                plots.append({"name": unit.name,
                              "cls": type(unit),
                              "data": unit.last_data})
        stats = [(u.name, u.run_time, u.run_count)
                 for u in sorted(wf.units, key=lambda u: -u.run_time)
                 if u is not self][:10]
        return {
            "workflow": type(wf).__name__,
            "generated": time.strftime("%Y-%m-%d %H:%M:%S UTC",
                                       time.gmtime()),
            "mode": getattr(launcher, "mode", "standalone"),
            "runtime": getattr(launcher, "runtime", 0.0),
            "units": len(wf.units),
            "checksum": wf.checksum,
            "results": wf.gather_results(),
            "unit_stats": stats,
            "plots": plots,
            "config": json.loads(dumps_json(root.as_dict()))
            if self.include_config else None,
        }

    def run(self):
        report = self.gather_report()
        self.outputs = []
        for name in self.backends:
            backend = BackendRegistry.registry[name](
                **self.backend_config.get(name, {}))
            path = backend.render(report, self.output_dir)
            self.outputs.append(path)
            self.info("published %s report -> %s", name, path)

# Import side-effect registration of the network backend (kept in its
# own module so the core publisher stays dependency-light).
from . import publishing_confluence  # noqa: E402,F401
