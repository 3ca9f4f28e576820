"""The port's plotting (veles_tpu_torch/plotting/) against the JAX
package's on the CPU, where matplotlib is installed.

Every stock plotter is fed the same inputs in both packages: its
snapshot (what it hands the render thread) equals JAX's, and what its
``redraw`` draws equals what JAX's draws, read back from the figure as
arrays (line data, images, bar and histogram patches, texts, table
cells), not as pixels. Each renders a file through the port's
``GraphicsServer``. ``add_standard_plotters`` on a training run
accumulates JAX's validation errors. Without matplotlib (the card's
host) asking for a plotter or a rendering server raises naming it."""

import importlib.util
import os

import matplotlib
import numpy
import pytest
import torch

matplotlib.use("Agg", force=True)
import matplotlib.pyplot as pp  # noqa: E402

from veles_tpu.core import prng as jprng  # noqa: E402
from veles_tpu.dummy import DummyLauncher as JDummyLauncher  # noqa: E402
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow  # noqa: E402
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow  # noqa: E402
from veles_tpu import plotting as jplotting  # noqa: E402
from veles_tpu_torch import plotting  # noqa: E402
from veles_tpu_torch.convert import unit_params_from_jax  # noqa: E402
from veles_tpu_torch.core import prng  # noqa: E402
from veles_tpu_torch.core.config import root  # noqa: E402
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow  # noqa: E402
from veles_tpu_torch.memory import Array  # noqa: E402
from veles_tpu_torch.models.mlp import MLPWorkflow  # noqa: E402

torch.set_num_threads(1)

#: seconds the render thread may take for the whole queue (matplotlib is
#: imported above, so no cold import happens on the thread)
FLUSH = 60


class _FleetServer:
    def fleet_status(self):
        return {"slaves": [{"id": "s1", "mid": "m1", "power": 2.5,
                            "jobs_done": 7},
                           {"id": "s2", "mid": "m2", "power": 1.0}]}


def _fill(kind, unit, rng, port):
    """Link the same inputs into a plotter of either package: numpy for
    JAX, torch tensors and Arrays for the port."""
    def tensor(array):
        return torch.from_numpy(array) if port else array
    if kind == "AccumulatingPlotter":
        unit.input = None
        for value in rng.rand(15):
            unit.input = [0, float(value), 0]
            unit.input_field = 1
            unit.fill()
    elif kind == "MatrixPlotter":
        unit.input = tensor(rng.randint(0, 30, (4, 4)).astype(numpy.int32))
        unit.reversed_labels_mapping = ["a", "b", "c", "d"]
    elif kind == "ImagePlotter":
        unit.inputs = [tensor(rng.rand(6, 6).astype(numpy.float32)),
                       tensor(rng.rand(5, 5, 3).astype(numpy.float32)),
                       tensor(rng.rand(2, 4, 4).astype(numpy.float32))]
        unit.input_fields = [None, None, 1]
    elif kind == "ImmediatePlotter":
        unit.inputs = [tensor(rng.rand(20).astype(numpy.float32)),
                       tensor(rng.rand(3, 20).astype(numpy.float32))]
        unit.input_fields = [None, 2]
    elif kind == "Histogram":
        unit.x = tensor(numpy.linspace(0, 1, 12).astype(numpy.float32))
        unit.y = tensor(rng.rand(12).astype(numpy.float32))
    elif kind == "AutoHistogramPlotter":
        unit.input = tensor(rng.randn(300).astype(numpy.float32))
    elif kind == "MultiHistogram":
        weights = rng.randn(20, 30).astype(numpy.float32)
        unit.input = Array(torch.from_numpy(weights)) if port else weights
    elif kind == "TableMaxMin":
        unit.inputs = [tensor(rng.randn(10).astype(numpy.float32)),
                       tensor(rng.randn(3, 3).astype(numpy.float32))]
        unit.input_names = ["weights", "bias"]
    elif kind == "SlaveStats":
        unit.fleet_server = _FleetServer()


KINDS = ("AccumulatingPlotter", "MatrixPlotter", "ImagePlotter",
         "ImmediatePlotter", "Histogram", "AutoHistogramPlotter",
         "MultiHistogram", "TableMaxMin", "SlaveStats")


def _plotters(kind, seed=0):
    """The JAX plotter and the port's of ``kind``, filled alike."""
    jplot = getattr(jplotting, kind)(JDummyWorkflow(), name=kind)
    tplot = getattr(plotting, kind)(DummyWorkflow(), name=kind)
    _fill(kind, jplot, numpy.random.RandomState(seed), port=False)
    _fill(kind, tplot, numpy.random.RandomState(seed), port=True)
    return jplot, tplot


def _plain(value):
    """A snapshot as nested plain data: arrays as lists."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, numpy.ndarray):
        return ["array", str(value.dtype), value.tolist()]
    return value


def _drawn(figure):
    """What a figure holds, as arrays: per axes its lines' data, images,
    patches (bars and histogram bins), texts and table cells."""
    out = []
    for axes in figure.axes:
        out.append({
            "lines": [line.get_xydata().tolist() for line in axes.lines],
            "images": [numpy.asarray(image.get_array()).tolist()
                       for image in axes.images],
            "patches": [(patch.get_x(), patch.get_y(), patch.get_width(),
                         patch.get_height())
                        for patch in axes.patches
                        if hasattr(patch, "get_height")],
            "texts": [text.get_text() for text in axes.texts],
            "tables": [[cell.get_text().get_text()
                        for _, cell in sorted(table.get_celld().items())]
                       for table in axes.tables],
            "ticks": [t.get_text() for t in axes.get_xticklabels()],
            "labels": (axes.get_xlabel(), axes.get_ylabel())})
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_and_drawing_equal_jax(kind):
    jplot, tplot = _plotters(kind)
    jsnap, tsnap = jplot.snapshot(), tplot.snapshot()
    assert _plain(tsnap) == _plain(jsnap)
    figures = []
    for cls, snap in ((type(jplot), jsnap), (type(tplot), tsnap)):
        figure = pp.figure()
        try:
            cls.redraw(pp, figure, snap)
            figures.append(_drawn(figure))
        finally:
            pp.close(figure)
    assert figures[1] == figures[0]
    assert any(any(axes.values()) for axes in figures[0])


def test_every_plotter_renders_a_file_through_the_server(tmp_path):
    server = plotting.GraphicsServer(directory=str(tmp_path))
    heard = []
    server.add_listener(lambda name, path: heard.append(name))
    try:
        for kind in KINDS:
            server.enqueue(_plotters(kind)[1])
        assert server.flush(timeout=FLUSH)
    finally:
        server.shutdown()
    assert sorted(server.rendered) == sorted(KINDS) == sorted(heard)
    for kind, path in server.rendered.items():
        assert path == os.path.join(str(tmp_path), kind + ".png")
        with open(path, "rb") as fin:
            assert fin.read(8) == b"\x89PNG\r\n\x1a\n"
    assert not server._thread.is_alive()


def test_pdf_and_none_backends(tmp_path):
    plot = _plotters("Histogram")[1]
    pdf = plotting.GraphicsServer(backend="pdf", directory=str(tmp_path))
    none = plotting.GraphicsServer(backend="none",
                                   directory=str(tmp_path / "none"))
    try:
        pdf.enqueue(plot)
        none.enqueue(plot)
        assert pdf.flush(timeout=FLUSH) and none.flush(timeout=1)
    finally:
        pdf.shutdown()
        none.shutdown()
    assert pdf.rendered["Histogram"].endswith("Histogram.pdf")
    assert none.rendered == {} and not (tmp_path / "none").exists()


def test_run_throttles_and_obeys_disable_plotting(monkeypatch):
    """Plotter.run fills every time, enqueues at most once a
    ``redraw_threshold`` and never with plotting disabled."""
    queued = []

    class Server:
        def enqueue(self, plotter):
            queued.append(plotter.name)
    plot = plotting.AccumulatingPlotter(DummyWorkflow(), name="acc",
                                        redraw_threshold=3600)
    plot.graphics_server = Server()
    plot.input = [0, 5, 0]
    plot.input_field = 1
    plot.run()
    plot.run()
    assert queued == ["acc"] and plot.values == [5.0, 5.0]
    monkeypatch.setattr(root.common.disable, "plotting", True)
    plot._last_redraw_ = 0.0
    plot.run()
    assert queued == ["acc"] and len(plot.values) == 3


def test_without_matplotlib_plotters_raise_naming_it(monkeypatch):
    real = importlib.util.find_spec

    def find_spec(name, *args, **kwargs):
        return None if name == "matplotlib" else real(name, *args,
                                                      **kwargs)
    monkeypatch.setattr(importlib.util, "find_spec", find_spec)
    for kind in KINDS:
        with pytest.raises(ImportError, match="matplotlib"):
            getattr(plotting, kind)(DummyWorkflow())
    with pytest.raises(ImportError, match="matplotlib"):
        plotting.GraphicsServer()
    assert plotting.GraphicsServer(backend="none").backend == "none"
    monkeypatch.setattr(root.common.disable, "plotting", True)
    plotting.MatrixPlotter(DummyWorkflow())


def _mlp_kwargs():
    from sklearn.datasets import load_digits
    digits = load_digits()
    perm = numpy.random.RandomState(0).permutation(len(digits.data))
    x = digits.data.astype(numpy.float32)[perm]
    y = digits.target.astype(numpy.int32)[perm]
    return dict(layers=(32, 10), loader_kwargs=dict(
        data=x, labels=y, class_lengths=[0, 297, 1500], minibatch_size=100,
        normalization_type="linear"), learning_rate=0.1, max_epochs=3,
        name="digits")


def _record_valid_errors(wf):
    seen = []
    summary = wf.decision._epoch_summary

    def recorded(stats, epoch):
        seen.append(float(stats[1][0]))
        summary(stats, epoch)

    wf.decision._epoch_summary = recorded
    return seen


def test_standard_plotters_follow_the_run_as_jax(tmp_path):
    """``add_standard_plotters(weights=True)`` from JAX's weights: the
    same three plotters, the runs' per-epoch validation errors equal, the
    error curve holding only values from them, and the launcher's server
    renders the three figures. (A plotter runs on the unit graph's pool
    and reads the decision's ``epoch_ended`` gate when it runs, not when
    the decision fired it, so in either package it may miss an epoch
    that the next tick has already moved past.)"""
    jprng.get("default").seed(4321)
    jprng.get("loader").seed(8765)
    jwf = JMLPWorkflow(JDummyLauncher(), **_mlp_kwargs())
    jplots = jwf.add_standard_plotters(weights=True)
    jwf.initialize()
    layers = [{"weights": numpy.asarray(f.weights.data),
               "bias": numpy.asarray(f.bias.data)} for f in jwf.forwards]
    launcher = DummyLauncher()
    launcher.graphics_server = plotting.GraphicsServer(
        directory=str(tmp_path))
    prng.get("loader").seed(8765)
    twf = MLPWorkflow(launcher, device="cpu", **_mlp_kwargs())
    tplots = twf.add_standard_plotters(weights=True)
    unit_params_from_jax(twf, layers)
    twf.initialize()
    for plot in tplots:
        plot.redraw_threshold = 0
    jerrors, terrors = _record_valid_errors(jwf), _record_valid_errors(twf)
    jwf.run()
    twf.run()
    try:
        assert launcher.graphics_server.flush(timeout=FLUSH)
    finally:
        launcher.graphics_server.shutdown()
    assert [type(p).__name__ for p in tplots] \
        == [type(p).__name__ for p in jplots]
    assert terrors == jerrors and len(terrors) == 3
    for plots, errors in ((tplots, terrors), (jplots, jerrors)):
        values = plots[0].values
        assert values and set(values) <= set(errors)
    assert sorted(launcher.graphics_server.rendered) == sorted(
        p.name for p in tplots)
