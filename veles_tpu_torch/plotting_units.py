"""The plotter unit families (the JAX package's ``plotting_units``):
``AccumulatingPlotter``, ``ImmediatePlotter``, ``MatrixPlotter``,
``ImagePlotter``, ``Histogram``, ``MultiHistogram``, ``TableMaxMin``
and ``SlaveStats``.  Each captures host-side data when its gate fires
and ships a (class name, data) payload for the viewer process to render
(see ``plotter``); the data are plain numpy and Python values.

Link patterns mirror znicz usage: AccumulatingPlotter after the
Decision (error curves), MatrixPlotter on a confusion matrix, Histogram/MultiHistogram on layer weights, ImagePlotter on
minibatch inputs, SlaveStats on the master's worker table.
"""

import numpy

from .memory import Vector
from .plotter import Plotter


def _host(value):
    """Snapshot of a linked value as plain numpy: a Vector through
    ``map_read`` (one copy from the card), a callable's result."""
    if isinstance(value, Vector):
        value.map_read()
        return numpy.array(value.mem)
    if callable(value):
        value = value()
    return numpy.asarray(value)


class AccumulatingPlotter(Plotter):
    """Appends one scalar per firing and plots the series — the
    error-vs-epoch curve."""

    def __init__(self, workflow, **kwargs):
        super(AccumulatingPlotter, self).__init__(workflow, **kwargs)
        self.input = kwargs.get("input")
        self.input_field = kwargs.get("input_field")
        self.label = kwargs.get("label", self.name)
        self.fit_poly_power = kwargs.get("fit_poly_power", 0)
        self.values = []
        self.demand("input")

    def plot_data(self):
        value = self.input
        if self.input_field is not None:
            if isinstance(self.input_field, int):
                value = value[self.input_field]
            else:
                value = getattr(value, self.input_field)
        if value is not None and float(value) < 1e29:
            # 1e30 is the decisions' "no measurement yet" sentinel —
            # charting it would flatten the real curve to zero.
            self.values.append(float(value))
        return {"label": self.label, "values": list(self.values),
                "fit_poly_power": self.fit_poly_power}

    @staticmethod
    def render(data, fig):
        ax = fig.add_subplot(111)
        ys = data["values"]
        ax.plot(range(1, len(ys) + 1), ys, "b-o",
                label=data["label"])
        power = data.get("fit_poly_power", 0)
        if power and len(ys) > power:
            xs = numpy.arange(1, len(ys) + 1)
            fit = numpy.polyval(numpy.polyfit(xs, ys, power), xs)
            ax.plot(xs, fit, "g--", label="fit")
        ax.set_xlabel("firing")
        ax.set_ylabel(data["label"])
        ax.legend()
        ax.grid(True)


class ImmediatePlotter(Plotter):
    """Plots linked x/y arrays as-is each firing."""

    def __init__(self, workflow, **kwargs):
        super(ImmediatePlotter, self).__init__(workflow, **kwargs)
        self.inputs = kwargs.get("inputs", [])
        self.fixed_x = kwargs.get("fixed_x")

    def plot_data(self):
        series = []
        for item in self.inputs:
            y = _host(item).ravel()
            x = (_host(self.fixed_x).ravel()
                 if self.fixed_x is not None
                 else numpy.arange(len(y)))
            series.append({"x": x, "y": y})
        return {"series": series}

    @staticmethod
    def render(data, fig):
        ax = fig.add_subplot(111)
        for i, s in enumerate(data["series"]):
            ax.plot(s["x"], s["y"], label="series %d" % i)
        ax.legend()
        ax.grid(True)


class MatrixPlotter(Plotter):
    """Heatmap of a linked matrix — the confusion-matrix plot."""

    def __init__(self, workflow, **kwargs):
        super(MatrixPlotter, self).__init__(workflow, **kwargs)
        self.input = kwargs.get("input")
        self.reversed_labels = kwargs.get("reversed_labels", False)
        self.demand("input")

    def plot_data(self):
        return {"matrix": _host(self.input),
                "name": self.name}

    @staticmethod
    def render(data, fig):
        m = numpy.asarray(data["matrix"])
        ax = fig.add_subplot(111)
        im = ax.imshow(m, interpolation="nearest", cmap="viridis")
        fig.colorbar(im, ax=ax)
        if m.size <= 400:  # annotate readable matrices only
            for (i, j), v in numpy.ndenumerate(m):
                ax.text(j, i, "%g" % v, ha="center", va="center",
                        color="white", fontsize=7)
        ax.set_title(data.get("name", "matrix"))


class ImagePlotter(Plotter):
    """Grid of sample images from a linked batch Vector."""

    def __init__(self, workflow, **kwargs):
        super(ImagePlotter, self).__init__(workflow, **kwargs)
        self.input = kwargs.get("input")
        self.count = kwargs.get("count", 9)
        self.image_shape = kwargs.get("image_shape")
        self.demand("input")

    def plot_data(self):
        imgs = _host(self.input)[:self.count]
        if self.image_shape is not None:
            imgs = imgs.reshape((-1,) + tuple(self.image_shape))
        return {"images": imgs}

    @staticmethod
    def render(data, fig):
        imgs = numpy.asarray(data["images"])
        n = len(imgs)
        cols = int(numpy.ceil(numpy.sqrt(n))) or 1
        rows = int(numpy.ceil(n / cols)) or 1
        for i, img in enumerate(imgs):
            ax = fig.add_subplot(rows, cols, i + 1)
            if img.ndim == 1:
                side = int(numpy.sqrt(img.size))
                img = img[:side * side].reshape(side, side)
            if img.ndim == 3 and img.shape[-1] == 1:
                img = img[..., 0]
            ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
            ax.axis("off")


class Histogram(Plotter):
    """Distribution of a linked array — weight histograms (auto-binned
    over ``n_bars``)."""

    def __init__(self, workflow, **kwargs):
        super(Histogram, self).__init__(workflow, **kwargs)
        self.input = kwargs.get("input")
        self.n_bars = kwargs.get("n_bars", 50)
        self.demand("input")

    def plot_data(self):
        values = _host(self.input).ravel()
        counts, edges = numpy.histogram(values, bins=self.n_bars)
        return {"counts": counts, "edges": edges,
                "name": self.name}

    @staticmethod
    def render(data, fig):
        ax = fig.add_subplot(111)
        edges = numpy.asarray(data["edges"])
        ax.bar(edges[:-1], data["counts"],
               width=numpy.diff(edges), align="edge")
        ax.set_title(data.get("name", "histogram"))


class MultiHistogram(Plotter):
    """One histogram per linked array, as subplots."""

    def __init__(self, workflow, **kwargs):
        super(MultiHistogram, self).__init__(workflow, **kwargs)
        self.inputs = kwargs.get("inputs", [])
        self.n_bars = kwargs.get("n_bars", 30)

    def plot_data(self):
        hists = []
        for item in self.inputs:
            values = _host(item).ravel()
            counts, edges = numpy.histogram(values, bins=self.n_bars)
            hists.append({"counts": counts, "edges": edges})
        return {"hists": hists}

    @staticmethod
    def render(data, fig):
        hists = data["hists"]
        cols = int(numpy.ceil(numpy.sqrt(len(hists)))) or 1
        rows = int(numpy.ceil(len(hists) / cols)) or 1
        for i, h in enumerate(hists):
            ax = fig.add_subplot(rows, cols, i + 1)
            edges = numpy.asarray(h["edges"])
            ax.bar(edges[:-1], h["counts"],
                   width=numpy.diff(edges), align="edge")


class TableMaxMin(Plotter):
    """Max/min table over linked arrays — rendered as a matplotlib
    table and logged as text."""

    def __init__(self, workflow, **kwargs):
        super(TableMaxMin, self).__init__(workflow, **kwargs)
        self.inputs = kwargs.get("inputs", [])
        self.labels = kwargs.get("labels")

    def plot_data(self):
        rows = []
        for i, item in enumerate(self.inputs):
            arr = _host(item)
            label = (self.labels[i] if self.labels else
                     "input %d" % i)
            rows.append({"label": label,
                         "max": float(arr.max()),
                         "min": float(arr.min())})
        for row in rows:
            self.debug("%-20s max %+.6f min %+.6f", row["label"],
                       row["max"], row["min"])
        return {"rows": rows}

    @staticmethod
    def render(data, fig):
        ax = fig.add_subplot(111)
        ax.axis("off")
        cells = [["%s" % r["label"], "%.6f" % r["max"],
                  "%.6f" % r["min"]] for r in data["rows"]]
        ax.table(cellText=cells,
                 colLabels=["name", "max", "min"], loc="center")


class SlaveStats(Plotter):
    """Master-side worker table: jobs done / power per worker."""

    def __init__(self, workflow, **kwargs):
        super(SlaveStats, self).__init__(workflow, **kwargs)
        self.period = kwargs.get("period", 1)

    def plot_data(self):
        launcher = getattr(self.workflow, "launcher", None)
        server = getattr(launcher, "server", None)
        workers = []
        if server is not None:
            for sid, desc in server.slaves.items():
                workers.append({
                    "id": sid, "power": desc.power,
                    "jobs_done": desc.jobs_done,
                    "state": desc.state,
                    "blacklisted": desc.blacklisted,
                })
        return {"workers": workers}

    @staticmethod
    def render(data, fig):
        workers = data["workers"]
        ax = fig.add_subplot(111)
        if not workers:
            ax.text(0.5, 0.5, "no workers", ha="center")
            return
        names = [w["id"] for w in workers]
        ax.bar(range(len(workers)),
               [w["jobs_done"] for w in workers])
        ax.set_xticks(range(len(workers)))
        ax.set_xticklabels(names, rotation=30, fontsize=7)
        ax.set_ylabel("jobs done")
