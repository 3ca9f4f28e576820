"""Class-mixin logging with ANSI colors, file duplication and event spans.

The port's copy of ``veles_tpu/core/logger.py`` (reference
``veles/logger.py:59-332``): the ``Logger`` mixin giving every object a
per-class logger, ``setup_logging`` with a colored console formatter,
duplicating all logging to a file, and the ``event()`` span API writing
to a local JSONL file and to any sink registered on the recorder, and
the MongoDB duplicator (:class:`MongoLogHandler`,
:func:`duplicate_all_logging_to_mongo`, reference ``logger.py:210``,
``:292``), which takes an injected client where pymongo is absent. Every
``event()`` also notes itself in the flight recorder's ring
(``observe/flight.py``).
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
        # the always-on black box keeps the last events too; lazy
        # import: observe.tracing imports this module at its top
        from veles_tpu_torch.observe.flight import get_flight_recorder
        get_flight_recorder().note("event", name=name, etype=etype,
                                   source=type(self).__name__)


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


class MongoLogHandler(logging.Handler):
    """Duplicate every log record into a MongoDB collection (reference
    ``MongoLogHandler``, ``logger.py:292``). pymongo is not a dependency:
    the default ``client_factory`` imports it when called and raises
    RuntimeError naming it where it is absent; a caller may inject any
    factory returning an object with
    ``client[db][collection].insert_one(doc)``."""

    def __init__(self, addr="127.0.0.1:27017", docid=None,
                 database="veles", collection="logs",
                 client_factory=None, level=logging.DEBUG):
        super().__init__(level)
        if client_factory is None:
            def client_factory(address):
                try:
                    import pymongo
                except ImportError:
                    raise RuntimeError(
                        "MongoDB log duplication needs pymongo installed "
                        "(the JSONL event recorder needs nothing: see "
                        "enable_event_recording)") from None
                return pymongo.MongoClient("mongodb://%s" % address)
        self.docid = docid or "%d" % os.getpid()
        self._collection = client_factory(addr)[database][collection]
        self._emitting = threading.local()
        self.on_close = None  # duplicate_all_logging_to_mongo's detach

    def close(self):
        detach = self.on_close
        self.on_close = None
        if detach is not None:
            detach()
        super().close()

    def emit(self, record):
        # pymongo logs its own records during insert_one: skip them,
        # and any record raised while this thread is inserting, or the
        # mirror recurses
        if record.name.startswith("pymongo") \
                or getattr(self._emitting, "active", False):
            return
        self._emitting.active = True
        try:
            self._collection.insert_one({
                "session": self.docid,
                "time": record.created,
                "level": record.levelname,
                "logger": record.name,
                "message": record.getMessage(),
            })
        except Exception:
            self.handleError(record)
        finally:
            self._emitting.active = False


def duplicate_all_logging_to_mongo(addr, docid=None, client_factory=None,
                                   background=True):
    """Mirror the root logger into MongoDB (reference ``logger.py:210``)
    and the event spans into its ``events`` collection, both under the
    handler's session ``docid``.

    ``background=True`` inserts from a listener thread (a
    ``QueueHandler``/``QueueListener`` pair for the records, a worker
    for the spans), so a slow server never blocks a log call. Tear down
    with ``close()`` on the returned handler: it detaches the root
    handler, flushes and stops the listener and the worker, and
    unregisters the span sink."""
    handler = MongoLogHandler(addr, docid=docid,
                              client_factory=client_factory)
    root_logger = logging.getLogger()
    listener = queue_handler = event_worker = event_queue = None
    events = handler._collection.database["events"]
    if background:
        import queue as queue_mod
        from logging.handlers import QueueHandler, QueueListener

        queue_handler = QueueHandler(queue_mod.SimpleQueue())
        listener = QueueListener(queue_handler.queue, handler)
        listener.start()
        root_logger.addHandler(queue_handler)
        event_queue = queue_mod.SimpleQueue()

        def sink(attrs):
            event_queue.put(dict(attrs, session=handler.docid))

        def drain():
            warned = False
            while True:
                item = event_queue.get()
                if item is None:
                    return
                try:
                    events.insert_one(item)
                except Exception:
                    # the span is dropped (the JSONL recorder still has
                    # it); said once
                    if not warned:
                        warned = True
                        logging.getLogger("MongoLogHandler").exception(
                            "event insert failed (further failures "
                            "silent; spans remain in the JSONL log)")

        event_worker = threading.Thread(target=drain,
                                        name="mongo-events", daemon=True)
        event_worker.start()
    else:
        root_logger.addHandler(handler)

        def sink(attrs):
            events.insert_one(dict(attrs, session=handler.docid))

    get_event_recorder().add_sink(sink)

    def detach():
        get_event_recorder().remove_sink(sink)
        if listener is not None:
            root_logger.removeHandler(queue_handler)
            listener.stop()
            event_queue.put(None)  # after the queued spans (FIFO)
            event_worker.join(timeout=10)
            if event_worker.is_alive():
                logging.getLogger("MongoLogHandler").warning(
                    "mongo event queue not fully flushed within 10s; "
                    "remaining spans may be lost (daemon worker still "
                    "inserting)")
        else:
            root_logger.removeHandler(handler)

    handler.on_close = detach
    return handler


class EventRecorder:
    """Append-only JSONL event-span log (the reference's MongoDB event
    store, ``logger.py:210-289``). Writes nothing to disk until
    :meth:`open` gives it a file; hands every span to the registered
    sinks (:meth:`add_sink`) either way."""

    def __init__(self, path=None, session=None):
        self.session = session or "%d" % os.getpid()
        self._lock = threading.Lock()
        self._fd = None
        self._sinks = []
        self._sink_warned = set()
        if path is not None:
            self.open(path)

    def add_sink(self, sink):
        """Register an extra span consumer (the Mongo duplicator):
        ``sink(attrs)`` is called for every recorded span. A sink that
        raises is kept and reported once: an outage neither stops the
        run nor ends the duplication."""
        with self._lock:
            self._sinks.append(sink)
            self._sink_warned.discard(id(sink))

    def remove_sink(self, sink):
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)
            self._sink_warned.discard(id(sink))

    @property
    def enabled(self):
        return self._fd is not None

    def open(self, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with self._lock:
            self._fd = open(path, "a", buffering=1)

    def record(self, **attrs):
        with self._lock:
            sinks = list(self._sinks)
        if self._fd is None and not sinks:
            return
        attrs.setdefault("time", time.time())
        attrs.setdefault("mono", time.monotonic())
        attrs.setdefault("session", self.session)
        if self._fd is not None:
            line = json.dumps(attrs, default=str) + "\n"
            with self._lock:
                if self._fd is not None:
                    self._fd.write(line)
        for sink in sinks:
            try:
                sink(attrs)
            except Exception:
                with self._lock:
                    warn = id(sink) not in self._sink_warned
                    self._sink_warned.add(id(sink))
                if warn:
                    logging.getLogger("EventRecorder").exception(
                        "event sink failed (kept; reported once)")

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
