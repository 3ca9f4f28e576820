"""Live training visualization: the port of ``veles_tpu/plotting/``
(reference ``veles/plotter.py``, ``plotting_units.py``,
``graphics_server.py``).

matplotlib draws every figure. It is on the CPU box where the tests run
and not on the card's host: there, asking for a plotter (or a
:class:`GraphicsServer` that renders) raises ImportError naming
matplotlib, unless ``root.common.disable.plotting`` turns plotting off."""

from veles_tpu_torch.plotting.server import (  # noqa: F401
    GraphicsServer, require_matplotlib)
from veles_tpu_torch.plotting.units import (  # noqa: F401
    AccumulatingPlotter, AutoHistogramPlotter, Histogram, ImagePlotter,
    ImmediatePlotter, MatrixPlotter, MultiHistogram, Plotter, SlaveStats,
    TableMaxMin)
