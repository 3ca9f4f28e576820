"""Trace propagation: trace_id/span_id context and span events.

The port's copy of ``veles_tpu/observe/tracing.py:39-277``. Every span
event carries ``trace_id`` / ``span_id`` / ``parent_id``, a monotonic
stamp, its thread and process; serving requests propagate context
through the ``X-Veles-Trace`` header, and ``python -m veles_tpu_torch
observe export-trace`` turns the JSONL into a Chrome ``trace_event``
JSON that ``ui.perfetto.dev`` loads: one serving request is followable
from admission through its prefill and decode chunks to the collect
across threads. Each span event goes to the port's
``core/logger.EventRecorder`` and to the flight recorder's ring; a
completed span also feeds the fleet span ring
(``observe/fleetscope.py``, ``tracing.py:120-135``), whose summaries a
fleet slave ships on its update frames.

Fast path (the overhead-guard tests pin it): a DISABLED tracer returns
one shared null span from ``span()``: no allocation, no id, no recorder
traffic, so an instrumented hot path costs one attribute check.

Cross-thread spans: ``contextvars`` carry the context within a thread;
handing a trace to another thread (the serving driver) is explicit:
carry ``span.context()`` and pass it as ``parent=``.

Device alignment: while ``Tracer.annotate_device`` is on (the profiler
window, ``observe/profile.py``), every span also opens a
``torch.profiler.record_function`` range of its name and, once the
process has put work on the card, an NVTX range, so host span names
stand over the kernels they launched in a profile.
"""

import contextvars
import os
import threading
import time
import uuid

import torch

from veles_tpu_torch.core.logger import get_event_recorder
from veles_tpu_torch.observe.fleetscope import get_span_ring
from veles_tpu_torch.observe.flight import get_flight_recorder

#: the serving trace header: "<trace_id>/<span_id>" (hex)
TRACE_HEADER = "X-Veles-Trace"

_current = contextvars.ContextVar("veles_trace_span", default=None)


def _new_id():
    return uuid.uuid4().hex[:16]


class NullSpan:
    """The shared disabled-path span: every operation is a no-op and
    ``span()`` hands out THIS singleton, so disabled tracing allocates
    nothing."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def context(self):
        return None

    def annotate(self, **attrs):
        return self

    def finish(self):
        pass


NULL_SPAN = NullSpan()


class _DeviceRange:
    """A ``record_function`` range of the span's name, and an NVTX range
    when the process has initialised CUDA: what the profiler window
    shows over the span's kernels. An NVTX library that refuses the push
    leaves the ``record_function`` range alone (an annotation, never a
    reason to fail the span's work)."""

    __slots__ = ("_function", "_nvtx")

    def __init__(self, name):
        self._function = torch.profiler.record_function(name)
        self._function.__enter__()
        self._nvtx = False
        if torch.cuda.is_initialized():
            try:
                torch.cuda.nvtx.range_push(name)
                self._nvtx = True
            except RuntimeError:
                pass

    def close(self):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._function.__exit__(None, None, None)


class Span:
    """One span: records ``begin``/``end`` events through the
    EventRecorder with trace ids, a wall stamp and a monotonic stamp
    (``mono``, what the Chrome exporter orders by), the recording thread
    (``tid``) and process (``pid``)."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "attrs", "_token", "_finished", "_annotation",
                 "_t0_mono")

    def __init__(self, tracer, name, trace_id, parent_id, **attrs):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self._token = None
        self._finished = False
        self._annotation = None
        self._t0_mono = None

    def context(self):
        """The (trace_id, span_id) pair to hand across threads or
        processes (header, holder dict)."""
        return (self.trace_id, self.span_id)

    def annotate(self, **attrs):
        """Attach attributes; they ride the END event (so late facts —
        token counts, outcomes — land on the span)."""
        self.attrs.update(attrs)
        return self

    def _record(self, etype):
        mono = time.monotonic()
        payload = dict(
            name=self.name, etype=etype, trace_id=self.trace_id,
            span_id=self.span_id, parent_id=self.parent_id,
            mono=mono, tid=threading.get_ident(),
            pid=os.getpid(), **self.attrs)
        get_event_recorder().record(**payload)
        # the black box holds the last spans whichever EventRecorder is
        # active (flight.py; a bounded append)
        get_flight_recorder().note_span(payload)
        if etype == "begin":
            self._t0_mono = mono
            return
        # COMPLETED spans (end/single) feed the fleet span ring: a fleet
        # slave piggybacks their summaries on its update frames. A
        # disabled ring costs one attribute check.
        ring = get_span_ring()
        if ring.enabled:
            t0 = self._t0_mono if etype == "end" \
                and self._t0_mono is not None else mono
            ring.note_span(self.name, self.trace_id, self.span_id,
                           self.parent_id, t0,
                           max(0.0, (mono - t0) * 1000.0),
                           threading.get_ident())

    def __enter__(self):
        self._token = _current.set(self)
        if self.tracer.annotate_device:
            self._annotation = _DeviceRange(self.name)
        self._record("begin")
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attrs.setdefault("error", repr(exc))
        self.finish()
        return False

    def finish(self):
        if self._finished:
            return
        self._finished = True
        if self._annotation is not None:
            try:
                self._annotation.close()
            finally:
                self._annotation = None
        self._record("end")
        if self._token is not None:
            try:
                _current.reset(self._token)
            except ValueError:
                pass  # finished on a different thread than it began
            self._token = None


class Tracer:
    """Span factory. Disabled (the default) it returns the shared
    :data:`NULL_SPAN`; enabled it creates real spans that inherit the
    ambient trace (or mint a new trace_id) and flow through the
    EventRecorder to the JSONL file and the Chrome exporter."""

    def __init__(self, enabled=False):
        self.enabled = enabled
        #: when True (the profiler window is open), every span also
        #: opens a record_function (and NVTX) range of its name
        self.annotate_device = False

    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def span(self, name, parent=None, **attrs):
        """Open a span. ``parent`` overrides the ambient context: a
        ``(trace_id, span_id)`` pair (from a header or a holder), a
        Span, or None to inherit from this thread's current span."""
        if not self.enabled:
            return NULL_SPAN
        if parent is None:
            ambient = _current.get()
            if ambient is not None and ambient.trace_id is not None:
                parent = (ambient.trace_id, ambient.span_id)
        elif isinstance(parent, Span):
            parent = (parent.trace_id, parent.span_id)
        if parent:
            trace_id, parent_id = parent
        else:
            trace_id, parent_id = _new_id(), None
        return Span(self, name, trace_id, parent_id, **attrs)

    def event(self, name, parent=None, **attrs):
        """A zero-duration span (etype "single"): one recorded point
        with full trace identity — submissions, completions."""
        if not self.enabled:
            return NULL_SPAN
        span = self.span(name, parent=parent, **attrs)
        span._record("single")
        span._finished = True
        return span


_tracer = Tracer(enabled=False)


def get_tracer():
    return _tracer


def current_context():
    """This thread's (trace_id, span_id), or None."""
    span = _current.get()
    if span is None or span.trace_id is None:
        return None
    return (span.trace_id, span.span_id)


# -- wire formats ----------------------------------------------------------

def format_trace_header(context):
    """(trace_id, span_id) -> the X-Veles-Trace value."""
    if not context:
        return None
    return "%s/%s" % context


def parse_trace_header(value):
    """X-Veles-Trace value -> (trace_id, span_id) or None. Hostile
    input degrades to None: a garbage header must never 500 a serving
    request."""
    if not value or not isinstance(value, str):
        return None
    trace_id, _, span_id = value.partition("/")
    trace_id = trace_id.strip()
    span_id = span_id.strip()
    if not trace_id or len(trace_id) > 64 or len(span_id) > 64:
        return None
    if not all(c in "0123456789abcdefABCDEF-" for c in trace_id + span_id):
        return None
    return (trace_id, span_id or None)


def parse_trace_field(value):
    """A ``[trace_id, span_id]`` wire field -> context tuple or None;
    tolerates garbage like the header parser."""
    if not isinstance(value, (list, tuple)) or len(value) != 2:
        return None
    trace_id, span_id = value
    if not isinstance(trace_id, str) or not trace_id:
        return None
    return (trace_id, span_id if isinstance(span_id, str) else None)
