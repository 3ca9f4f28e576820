"""Stock plotter units.

The port of ``veles_tpu/plotting/units.py`` (reference
``veles/plotter.py:48-161``, the Plotter unit contract, and
``veles/plotting_units.py:52-822``, the stock plotters). The split of
responsibilities serves the in-process render thread (see
``plotting/server.py``):

- ``fill()`` — host-side accumulation from linked attrs, every run;
- ``snapshot()`` — plain-data dict (picklable) of what redraw needs;
- ``redraw(pp, figure, data)`` — a *classmethod* pure renderer: it takes
  only the snapshot, so it can run on the render thread (or a remote
  viewer) without touching live unit state — the role the reference's
  strip-pickle + ZMQ shipping played.

Throttling (``redraw_threshold`` seconds between redraws, reference
``plotter.py:148-152``) and the global ``root.common.disable.plotting``
gate are in the base ``run()``. A plotter reads its inputs on the host:
unit Arrays through ``mem``, tensors (on the card too) copied down.
Constructing a plotter without matplotlib raises ImportError naming it,
unless ``root.common.disable.plotting`` is set.
"""

import time

import numpy
import torch

from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.plotting.server import require_matplotlib


def _host(value):
    """A linked value as a numpy array: an Array's ``mem``, a tensor
    copied to the host, anything else through ``numpy.asarray``."""
    value = getattr(value, "mem", value)
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return numpy.asarray(value)


class Plotter(Unit):
    """Base plotter unit (reference ``plotter.py:48``)."""

    hide_from_registry = True
    VIEW_GROUP = "PLOTTER"

    def __init__(self, workflow, **kwargs):
        self.redraw_threshold = kwargs.pop("redraw_threshold", 2.0)
        if not root.common.disable.get("plotting", False):
            require_matplotlib(type(self).__name__)
        super().__init__(workflow, **kwargs)

    def init_unpickled(self):
        super().init_unpickled()
        self._last_redraw_ = 0.0
        self._server_ = None

    @property
    def graphics_server(self):
        if self._server_ is None:
            launcher = getattr(self.workflow, "workflow", None)
            self._server_ = getattr(launcher, "graphics_server", None)
        return self._server_

    @graphics_server.setter
    def graphics_server(self, value):
        self._server_ = value

    def initialize(self, **kwargs):
        server = kwargs.get("graphics_server")
        if server is not None:
            self._server_ = server

    def run(self):
        self.fill()
        if root.common.disable.get("plotting", False):
            return
        if time.time() - self._last_redraw_ < self.redraw_threshold:
            return
        server = self.graphics_server
        if server is None:
            return
        self._last_redraw_ = time.time()
        server.enqueue(self)

    # -- the plotter contract -------------------------------------------------
    def fill(self):
        """Accumulate from linked attrs (host-side, cheap)."""

    def snapshot(self):
        """Plain-data dict consumed by :meth:`redraw`."""
        raise NotImplementedError

    @classmethod
    def redraw(cls, pp, figure, data):
        """Render ``data`` onto ``figure`` (render-thread side)."""
        raise NotImplementedError


class AccumulatingPlotter(Plotter):
    """Time-series of a scalar (e.g. error %%) with a last-N window,
    least-squares polynomial smoothing and a whole-history minimap
    (reference ``plotting_units.py:52-181``).

    Link ``input`` (+ optional ``input_field``/``input_offset``) from the
    producing unit; plotters sharing a ``name`` share a figure."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "AccumulatingPlotter")
        self.plot_style = kwargs.pop("plot_style", "k-")
        self.ylim = kwargs.pop("ylim", None)
        self.last = kwargs.pop("last", 11)
        self.fit_poly_power = kwargs.pop("fit_poly_power", 2)
        self.minimap_size = kwargs.pop("minimap", 0.25)
        self.label = kwargs.pop("label", "")
        super().__init__(workflow, **kwargs)
        self.values = []
        self.input_field = None
        self.input_offset = 0
        self.demand("input")

    def fill(self):
        value = self.input
        if self.input_field is not None:
            value = (value[self.input_field]
                     if isinstance(self.input_field, int)
                     else getattr(value, self.input_field))
        if isinstance(value, torch.Tensor) and value.dim():
            value = value.detach().cpu().numpy()
        if isinstance(value, numpy.ndarray):
            value = value[self.input_offset]
        if value is not None:
            self.values.append(float(value))

    def snapshot(self):
        return {"values": list(self.values), "style": self.plot_style,
                "ylim": self.ylim, "last": self.last,
                "poly": self.fit_poly_power, "minimap": self.minimap_size,
                "label": self.label}

    @classmethod
    def redraw(cls, pp, figure, data):
        values = data["values"]
        if not values:
            return
        axes = figure.add_subplot(111)
        axes.grid(True)
        if data["ylim"]:
            axes.set_ylim(*data["ylim"])
        last = data["last"]
        window = values[-last:] if last else values
        begin = len(values) - len(window)
        xs = numpy.arange(len(window)) + begin
        if data["poly"] and len(window) > data["poly"]:
            smooth_x = numpy.linspace(begin, begin + len(window) - 1, 100)
            smooth_y = numpy.poly1d(numpy.polyfit(
                xs, window, data["poly"]))(smooth_x)
            axes.plot(smooth_x, smooth_y, data["style"], linewidth=2)
            axes.plot(xs, window, data["style"][:-1] + "o")
        else:
            axes.plot(xs, window, data["style"][:-1] + "-", marker="o",
                      label=data["label"] or None)
        if data["minimap"] and len(values) > len(window):
            mini = figure.add_axes((1 - data["minimap"], 1 - data["minimap"],
                                    data["minimap"], data["minimap"]))
            mini.xaxis.set_visible(False)
            mini.yaxis.set_visible(False)
            mini.plot(values, data["style"])
        if data["label"]:
            axes.legend(loc=2)


class MatrixPlotter(Plotter):
    """Confusion-matrix style table: cell counts plus per-row/column
    totals, rendered as an annotated heatmap (reference
    ``plotting_units.py:184-365``). Link ``input`` to the confusion
    matrix and ``reversed_labels_mapping`` from the loader."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "MatrixPlotter")
        super().__init__(workflow, **kwargs)
        self.reversed_labels_mapping = None
        self.demand("input")

    def snapshot(self):
        if self.input is None:  # producer has nothing yet (e.g. fused)
            return {"matrix": [], "labels": []}
        matrix = _host(self.input)
        labels = self.reversed_labels_mapping
        if labels is None:
            labels = [str(i) for i in range(matrix.shape[0])]
        return {"matrix": matrix.tolist(),
                "labels": [str(l) for l in labels]}

    @classmethod
    def redraw(cls, pp, figure, data):
        if not data["matrix"]:
            return
        matrix = numpy.asarray(data["matrix"], numpy.float64)
        labels = data["labels"]
        axes = figure.add_subplot(111)
        axes.imshow(matrix, cmap="Blues", interpolation="nearest")
        n = matrix.shape[0]
        threshold = matrix.max() / 2 if matrix.size else 0
        for i in range(n):
            for j in range(matrix.shape[1]):
                axes.text(j, i, "%d" % matrix[i, j], ha="center",
                          va="center",
                          color="white" if matrix[i, j] > threshold
                          else "black")
        axes.set_xticks(range(len(labels)))
        axes.set_xticklabels(labels, rotation=45)
        axes.set_yticks(range(len(labels)))
        axes.set_yticklabels(labels)
        axes.set_xlabel("predicted")
        axes.set_ylabel("target")


class ImagePlotter(Plotter):
    """Grid of input arrays drawn as images (reference
    ``plotting_units.py:368-477``)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "ImagePlotter")
        self.yuv = kwargs.pop("yuv", False)
        super().__init__(workflow, **kwargs)
        self.inputs = []
        self.input_fields = []

    def fill(self):
        pass

    def snapshot(self):
        images = []
        for inp, field in zip(self.inputs,
                              self.input_fields or [None] * len(self.inputs)):
            value = inp
            if field is not None:
                value = (inp[field] if isinstance(field, int)
                         else getattr(inp, field))
            arr = _host(value)
            # numpy arrays are already picklable plain data — copying
            # decouples from live buffers without a tolist() explosion
            images.append(numpy.array(arr))
        return {"images": images}

    @classmethod
    def redraw(cls, pp, figure, data):
        images = data["images"]
        if not images:
            return
        cols = int(numpy.ceil(numpy.sqrt(len(images))))
        rows = int(numpy.ceil(len(images) / cols))
        for i, img in enumerate(images):
            axes = figure.add_subplot(rows, cols, i + 1)
            axes.axis("off")
            if img.ndim == 3 and img.shape[-1] in (3, 4):
                span = img.max() - img.min() or 1.0
                axes.imshow((img - img.min()) / span)
            else:
                axes.imshow(img.squeeze(), cmap="gray",
                            interpolation="nearest")


class ImmediatePlotter(Plotter):
    """Up to three series plotted directly from linked arrays each run
    (reference ``plotting_units.py:480-533``)."""

    STYLES = ["k-", "g-", "r-"]

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "ImmediatePlotter")
        self.ylim = kwargs.pop("ylim", None)
        super().__init__(workflow, **kwargs)
        self.inputs = []
        self.input_fields = []

    def snapshot(self):
        series = []
        for inp, field in zip(self.inputs,
                              self.input_fields or [None] * len(self.inputs)):
            value = inp if field is None else (
                inp[field] if isinstance(field, int) else getattr(inp, field))
            series.append(numpy.ravel(_host(value)).tolist())
        return {"series": series, "ylim": self.ylim}

    @classmethod
    def redraw(cls, pp, figure, data):
        axes = figure.add_subplot(111)
        axes.grid(True)
        if data["ylim"]:
            axes.set_ylim(*data["ylim"])
        for i, series in enumerate(data["series"]):
            axes.plot(series, cls.STYLES[i % len(cls.STYLES)])


class Histogram(Plotter):
    """Bar histogram of provided ``x``/``y`` arrays (reference
    ``plotting_units.py:536-626``)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Histogram")
        super().__init__(workflow, **kwargs)
        self.demand("x", "y")

    def snapshot(self):
        return {"x": numpy.ravel(_host(self.x)).tolist(),
                "y": numpy.ravel(_host(self.y)).tolist()}

    @classmethod
    def redraw(cls, pp, figure, data):
        axes = figure.add_subplot(111)
        xs, ys = data["x"], data["y"]
        if not xs:
            return
        width = ((max(xs) - min(xs)) / max(len(xs), 1)) * 0.8 or 0.8
        axes.bar(xs, ys, width=width, color="#ffa0ef", edgecolor="lavender")
        axes.grid(True)


class AutoHistogramPlotter(Plotter):
    """Histogram with automatic binning (Sturges' rule) over a linked
    value array (reference ``plotting_units.py:629-678``)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "AutoHistogram")
        super().__init__(workflow, **kwargs)
        self.demand("input")

    def snapshot(self):
        values = numpy.ravel(_host(self.input))
        nbins = max(1, int(numpy.ceil(numpy.log2(len(values)) + 1))) \
            if len(values) else 1
        return {"values": values.tolist(), "bins": nbins}

    @classmethod
    def redraw(cls, pp, figure, data):
        if not data["values"]:
            return
        axes = figure.add_subplot(111)
        axes.hist(data["values"], bins=data["bins"], color="#ffa0ef")
        axes.grid(True)


class MultiHistogram(Plotter):
    """Grid of per-row histograms of a weights matrix (reference
    ``plotting_units.py:681-766``)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "MultiHistogram")
        self.hist_number = kwargs.pop("hist_number", 16)
        self.n_bars = kwargs.pop("n_bars", 25)
        super().__init__(workflow, **kwargs)
        self.demand("input")

    def snapshot(self):
        matrix = _host(self.input)
        matrix = matrix.reshape(matrix.shape[0], -1)
        n = min(self.hist_number, matrix.shape[0])
        return {"rows": [matrix[i].tolist() for i in range(n)],
                "bins": self.n_bars}

    @classmethod
    def redraw(cls, pp, figure, data):
        rows = data["rows"]
        if not rows:
            return
        cols = int(numpy.ceil(numpy.sqrt(len(rows))))
        grid = int(numpy.ceil(len(rows) / cols))
        for i, row in enumerate(rows):
            axes = figure.add_subplot(grid, cols, i + 1)
            axes.hist(row, bins=data["bins"], color="#ffa0ef")
            axes.xaxis.set_visible(False)
            axes.yaxis.set_visible(False)


class TableMaxMin(Plotter):
    """Text table of max/min over linked arrays (reference
    ``plotting_units.py:769-819``)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "TableMaxMin")
        super().__init__(workflow, **kwargs)
        self.inputs = []
        self.input_names = []

    def snapshot(self):
        rows = []
        for inp, name in zip(self.inputs, self.input_names):
            arr = _host(inp)
            rows.append((str(name), float(arr.max()), float(arr.min())))
        return {"rows": rows}

    @classmethod
    def redraw(cls, pp, figure, data):
        axes = figure.add_subplot(111)
        axes.axis("off")
        table = [["name", "max", "min"]] + [
            [n, "%.6f" % mx, "%.6f" % mn] for n, mx, mn in data["rows"]]
        axes.table(cellText=table, loc="center")


class SlaveStats(Plotter):
    """Fleet observability table: per-slave power/jobs from the master's
    ``fleet_status()`` (reference ``plotting_units.py:822+`` SlaveStats).
    Link ``fleet_server`` to the fleet Server instance."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "SlaveStats")
        self.period = kwargs.pop("period", 1)
        super().__init__(workflow, **kwargs)
        self.fleet_server = None

    def snapshot(self):
        status = (self.fleet_server.fleet_status()
                  if self.fleet_server is not None else {})
        return {"status": status}

    @classmethod
    def redraw(cls, pp, figure, data):
        axes = figure.add_subplot(111)
        axes.axis("off")
        slaves = data["status"].get("slaves", [])
        table = [["id", "mid", "power", "jobs"]] + [
            [str(s.get("id")), str(s.get("mid")),
             "%.1f" % float(s.get("power", 0)),
             str(s.get("jobs_done", s.get("jobs", 0)))]
            for s in slaves]
        axes.table(cellText=table, loc="center")
