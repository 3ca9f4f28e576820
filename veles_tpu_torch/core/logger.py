"""Class-mixin logging with ANSI colors, file duplication and event spans.

The port's copy of ``veles_tpu/core/logger.py`` (reference
``veles/logger.py:59-332``): the ``Logger`` mixin giving every object a
per-class logger, ``setup_logging`` with a colored console formatter,
duplicating all logging to a file, and the ``event()`` span API writing
to a local JSONL file. Left out: the MongoDB duplicator and the flight
recorder note (the observe plane is a later slice).
"""

import json
import logging
import os
import sys
import threading
import time


class ColorFormatter(logging.Formatter):
    """ANSI color console formatter (reference ``logger.py:66-114``)."""

    COLORS = {
        logging.DEBUG: "\033[1;34m",     # blue
        logging.INFO: "\033[1;32m",      # green
        logging.WARNING: "\033[1;33m",   # yellow
        logging.ERROR: "\033[1;31m",     # red
        logging.CRITICAL: "\033[1;41m",  # red background
    }
    RESET = "\033[0m"

    def __init__(self, colorize=True):
        super().__init__(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            "%H:%M:%S")
        self.colorize = colorize

    def format(self, record):
        text = super().format(record)
        if self.colorize:
            color = self.COLORS.get(record.levelno)
            if color:
                return "%s%s%s" % (color, text, self.RESET)
        return text


class Logger:
    """Mixin: every instance gets ``self.logger`` named after its class and
    debug/info/warning/error helpers (reference ``logger.py:59``)."""

    def __init__(self, **kwargs):
        logger_name = kwargs.pop("logger_name", type(self).__name__)
        self._logger_ = logging.getLogger(logger_name)
        super().__init__()

    @property
    def logger(self):
        try:
            if self._logger_ is not None:
                return self._logger_
        except AttributeError:
            pass
        # objects restored from pickle rebuild their logger lazily
        self._logger_ = logging.getLogger(type(self).__name__)
        return self._logger_

    @logger.setter
    def logger(self, value):
        self._logger_ = value

    def change_log_name(self, name):
        self._logger_ = logging.getLogger(name)

    def debug(self, msg, *args, **kwargs):
        self.logger.debug(msg, *args, **kwargs)

    def info(self, msg, *args, **kwargs):
        self.logger.info(msg, *args, **kwargs)

    def warning(self, msg, *args, **kwargs):
        self.logger.warning(msg, *args, **kwargs)

    def error(self, msg, *args, **kwargs):
        self.logger.error(msg, *args, **kwargs)

    def exception(self, msg="Exception", *args, **kwargs):
        self.logger.exception(msg, *args, **kwargs)

    # -- event span API (reference logger.py:264-289) -----------------------
    def event(self, name, etype, **attrs):
        """Record a span event: ``etype`` is "begin", "end" or "single"."""
        if etype not in ("begin", "end", "single"):
            raise ValueError("event type must be begin, end or single, "
                             "got %r" % (etype,))
        get_event_recorder().record(
            name=name, etype=etype, source=type(self).__name__, **attrs)


_setup_done = False


def setup_logging(level=logging.INFO, colorize=None):
    """Install the colored stderr handler on the root logger
    (reference ``logger.py:116-185``)."""
    global _setup_done
    if colorize is None:
        colorize = sys.stderr.isatty()
    rl = logging.getLogger()
    rl.setLevel(level)
    if not _setup_done:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(ColorFormatter(colorize))
        rl.addHandler(handler)
        _setup_done = True
    return rl


def duplicate_all_logging_to_file(path, level=logging.DEBUG):
    """Add a file handler mirroring everything (reference
    ``logger.py:187``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    handler = logging.FileHandler(path)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logging.getLogger().addHandler(handler)
    return handler


class EventRecorder:
    """Append-only JSONL event-span log (the reference's MongoDB event
    store, ``logger.py:210-289``). Records nothing until :meth:`open`
    gives it a file."""

    def __init__(self, path=None, session=None):
        self.session = session or "%d" % os.getpid()
        self._lock = threading.Lock()
        self._fd = None
        if path is not None:
            self.open(path)

    @property
    def enabled(self):
        return self._fd is not None

    def open(self, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with self._lock:
            self._fd = open(path, "a", buffering=1)

    def record(self, **attrs):
        if self._fd is None:
            return
        attrs.setdefault("time", time.time())
        attrs.setdefault("mono", time.monotonic())
        attrs.setdefault("session", self.session)
        line = json.dumps(attrs, default=str) + "\n"
        with self._lock:
            if self._fd is not None:
                self._fd.write(line)

    def close(self):
        with self._lock:
            if self._fd is not None:
                self._fd.close()
                self._fd = None


_event_recorder = EventRecorder()


def get_event_recorder():
    return _event_recorder


def enable_event_recording(path):
    _event_recorder.open(path)
    return _event_recorder
