"""Graphics server: the render backend behind Plotter units.

The port of ``veles_tpu/plotting/server.py`` (reference
``veles/graphics_server.py:73-245`` + ``graphics_client.py``). Plotters
enqueue *snapshots* — ``(plotter_class, figure name, plain-data dict)`` —
and one render thread draws them with matplotlib Agg and writes image
files under ``root.common.dirs.plots`` (default: ``plots`` beside the
flight recorder's ``run`` directory); ``add_listener`` callbacks fire
after each render.

Backends: ``file`` (PNG, default), ``pdf``, ``none`` (drop everything).
Every backend but ``none`` needs matplotlib: without it the server
raises at construction, naming it.
"""

import importlib.util
import os
import queue
import threading

from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.logger import Logger


def require_matplotlib(what="plotting"):
    """Raise ImportError naming matplotlib when this host lacks it."""
    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError(
            "%s needs matplotlib, which is not installed on this host "
            "(set root.common.disable.plotting = True to run without "
            "plots)" % what)


class GraphicsServer(Logger):
    """Render queue + worker thread (reference ``GraphicsServer`` role)."""

    def __init__(self, backend=None, directory=None):
        super().__init__()
        self.backend = backend or root.common.get("graphics_backend", "file")
        if self.backend != "none":
            require_matplotlib("the graphics server")
        self.directory = directory or root.common.dirs.get(
            "plots", os.path.join(
                os.path.dirname(root.common.dirs.get("run", ".")), "plots"))
        self._queue = queue.Queue()
        self._listeners = []
        self._rendered = {}
        self._thread = None
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------
    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._render_loop, name="graphics-server",
                    daemon=True)
                self._thread.start()

    def shutdown(self, timeout=10):
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=timeout)

    def flush(self, timeout=180):
        """Block until everything enqueued so far has rendered, at most
        ``timeout`` seconds (a cold matplotlib import can take tens of
        seconds on a loaded host). Returns False when the wait expired:
        renders enqueued before it may then be missing."""
        if self._thread is None or not self._thread.is_alive():
            return True
        done = threading.Event()
        self._queue.put(done)
        if not done.wait(timeout=timeout):
            self.warning(
                "flush timed out after %.0fs — renders enqueued before "
                "it may be missing", timeout)
            return False
        return True

    # -- producer side -------------------------------------------------------
    def enqueue(self, plotter):
        """Queue one snapshot of ``plotter`` for rendering."""
        if self.backend == "none":
            return
        snapshot = plotter.snapshot()
        self._ensure_thread()
        self._queue.put((type(plotter), plotter.name, snapshot))

    def add_listener(self, callback):
        """``callback(name, path)`` after each rendered figure."""
        self._listeners.append(callback)

    @property
    def rendered(self):
        """name -> last written file path."""
        return dict(self._rendered)

    # -- render thread -------------------------------------------------------
    def _render_loop(self):
        import matplotlib
        matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as pp

        while True:
            item = self._queue.get()
            if item is None:
                return
            if isinstance(item, threading.Event):
                item.set()
                continue
            cls, name, snapshot = item
            try:
                figure = pp.figure(name)
                figure.clf()
                cls.redraw(pp, figure, snapshot)
                path = self._write(figure, name)
                self._rendered[name] = path
                for listener in self._listeners:
                    listener(name, path)
            except Exception as exc:
                self.warning("failed to render %s: %s", name, exc)

    def _write(self, figure, name):
        os.makedirs(self.directory, exist_ok=True)
        ext = "pdf" if self.backend == "pdf" else "png"
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in name)
        path = os.path.join(self.directory, "%s.%s" % (safe, ext))
        tmp = path + ".tmp"
        figure.savefig(tmp, format=ext)
        os.replace(tmp, path)
        return path
