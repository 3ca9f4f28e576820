"""The always-on flight recorder: a bounded ring and black-box dumps.

The port's copy of ``veles_tpu/observe/flight.py:43-286``. Tracing is
opt-in; the black box is not: a process-global bounded ring
(``collections.deque(maxlen=MAX_ENTRIES)``), ON by default, records the
cheap facts as they happen (span events while tracing is on,
``Logger.event`` marks, the decoder's admit, step, dispatch and collect
entries, breaker transitions, weight swaps) and dumps a timestamped JSON
(temporary file + ``os.replace``) when something dies:

- a circuit-breaker trip (``GenerateAPI._trip``),
- an unhandled unit exception (``Workflow.on_error``),
- SIGTERM (:func:`install_signal_handlers`, installed by the CLI).

The dump keeps the JAX package's ``SCHEMA_VERSION`` 1 and key set, so
its ``load_dump`` and ``blackbox_main`` read what the port writes: the
request ledger's in-flight and slowest rows (``requests``: a breaker
trip ships the requests it shed, ``observe slo`` autopsies them) and
memscope's per-owner decomposition (``memscope``). Dumps go to
``root.common.dirs.run`` (``$VELES_TPU_HOME/run`` when that is set).
Inspect them with ``python -m veles_tpu_torch observe blackbox
[PATH]``.

Cost: a ``note()`` is one enabled-flag check, one small dict and one
``deque.append`` (atomic under the GIL): no lock, no I/O, no registry
traffic, and only at the millisecond-scale dispatch sites.
"""

import collections
import json
import logging
import os
import signal
import threading
import time

#: ring capacity: enough to hold the last few seconds of a busy serving
#: box (spans + dispatches) — the window that explains a death
MAX_ENTRIES = 2048

#: black-box schema version (bump on breaking layout changes)
SCHEMA_VERSION = 1


class FlightRecorder:
    """The process black box. ``note()`` appends; ``dump()`` writes."""

    def __init__(self, enabled=True, capacity=MAX_ENTRIES):
        self.enabled = enabled
        self._entries = collections.deque(maxlen=capacity)
        # RLock: a repeated SIGTERM (orchestrators re-send it) lands
        # the handler on the main thread WHILE it is already dumping —
        # a plain Lock would self-deadlock and the process would hang
        # instead of dumping and dying
        self._dump_lock = threading.RLock()
        self._dump_failed_warned = False
        self.dumps = 0
        self.last_dump_path = None

    # -- recording (the hot-path side) ------------------------------------
    def note(self, kind, **attrs):
        """Append one entry. Bounded cost: flag check, dict build,
        GIL-atomic deque append."""
        if not self.enabled:
            return
        attrs["kind"] = kind
        attrs["t"] = time.time()
        attrs["mono"] = time.monotonic()
        self._entries.append(attrs)

    def note_span(self, payload):
        """Span-event hook (``tracing.Span._record`` calls this beside
        the EventRecorder write, so the black box holds the last spans
        regardless of which recorder instance is active)."""
        if not self.enabled:
            return
        entry = dict(payload)
        entry["kind"] = "span"
        entry.setdefault("mono", time.monotonic())
        self._entries.append(entry)

    def entries(self):
        """A list copy of the ring (oldest first)."""
        return list(self._entries)

    # -- dumping (the crash side) -----------------------------------------
    def _dump_dir(self):
        from veles_tpu_torch.core.config import root

        return root.common.dirs.get("run", ".")

    def dump(self, reason, path=None, extra=None):
        """Write the black box: ring entries, a registry snapshot (when
        metrics are live) and the device-truth summary, atomically (a
        temporary file, then ``os.replace``). Returns the path, or None
        on failure, warned once: a dying process must not die harder
        because its black box could not be written. Nothing is computed
        anywhere else in its place."""
        doc = {
            "schema": SCHEMA_VERSION,
            "reason": reason,
            "time": time.time(),
            "mono": time.monotonic(),
            "pid": os.getpid(),
            "entries": self.entries(),
        }
        if extra:
            doc["extra"] = extra
        try:
            from veles_tpu_torch.observe.metrics import (
                get_metrics_registry)
            registry = get_metrics_registry()
            if registry.enabled:
                doc["metrics"] = [list(row)
                                  for row in registry.snapshot()]
        except Exception:   # noqa: BLE001 - a dying process dumps what
            pass            # it can
        try:
            from veles_tpu_torch.observe.xla_stats import (
                get_compile_tracker)
            tracker = get_compile_tracker()
            if tracker.enabled:
                doc["xla"] = tracker.snapshot()
        except Exception:   # noqa: BLE001
            pass
        # the request-truth tail (observe/reqledger.py): a breaker trip
        # dumps BEFORE it sheds, so the in-flight rows are the requests
        # it is about to shed; empty where the ledger holds nothing
        doc["requests"] = {"inflight": [], "slowest": []}
        try:
            from veles_tpu_torch.observe.reqledger import (
                get_request_ledger)
            ledger = get_request_ledger()
            if ledger.enabled and (ledger.staged_total
                                   or ledger.resolved_total):
                doc["requests"] = ledger.debug_snapshot(slowest=16)
        except Exception:   # noqa: BLE001
            pass
        # who held the device memory when the box dumped: memscope's
        # owner decomposition (observe/memscope.py)
        try:
            from veles_tpu_torch.observe.memscope import get_memscope
            summary = get_memscope().summary()
            if summary.get("tagged_bytes"):
                doc["memscope"] = summary
        except Exception:   # noqa: BLE001
            pass
        with self._dump_lock:
            try:
                if path is None:
                    directory = self._dump_dir()
                    os.makedirs(directory, exist_ok=True)
                    stamp = time.strftime("%Y%m%d-%H%M%S")
                    # dumps counter in the name: several failures in
                    # the same second (one device fault failing many
                    # units) must not overwrite each other
                    path = os.path.join(
                        directory, "blackbox-%s-%s-%d-%d.json"
                        % (stamp, reason.replace("/", "_"),
                           os.getpid(), self.dumps))
                tmp = path + ".tmp"
                with open(tmp, "w") as fout:
                    json.dump(doc, fout, default=str)
                os.replace(tmp, path)
            except OSError:
                if not self._dump_failed_warned:
                    self._dump_failed_warned = True
                    logging.getLogger("FlightRecorder").exception(
                        "black-box dump failed (reported once)")
                return None
            self.dumps += 1
            self.last_dump_path = path
        logging.getLogger("FlightRecorder").warning(
            "black box dumped (%s): %s", reason, path)
        return path


_flight = FlightRecorder()


def get_flight_recorder():
    return _flight


# -- signal wiring ----------------------------------------------------------

def install_signal_handlers(signals=(signal.SIGTERM,)):
    """Dump the black box on SIGTERM (CLI runs — library embedders keep
    their own signal policy), then chain to the previous handler (or
    re-raise the default so the process still dies). Returns the
    previous-handler map; a non-main-thread install is a no-op."""
    recorder = get_flight_recorder()
    previous = {}

    def handler(signum, frame):
        recorder.note("signal", signum=signum)
        recorder.dump("sigterm" if signum == signal.SIGTERM
                      else "signal-%d" % signum)
        old = previous.get(signum)
        if callable(old):
            old(signum, frame)
        elif old != signal.SIG_IGN:
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    for signum in signals:
        try:
            previous[signum] = signal.signal(signum, handler)
        except (ValueError, OSError):  # not the main thread
            return {}
    return previous


# -- the `veles_tpu_torch observe blackbox` CLI ---------------------------

def load_dump(path):
    """Load one black-box dump; raises on unreadable/garbage files."""
    with open(path, "r") as fin:
        doc = json.load(fin)
    if not isinstance(doc, dict) or "entries" not in doc:
        raise ValueError("%s is not a black-box dump" % path)
    return doc


def _summarize(doc, path, tail=0):
    lines = ["%s" % path,
             "  reason: %s  pid: %s  entries: %d  schema: %s" % (
                 doc.get("reason"), doc.get("pid"),
                 len(doc.get("entries", [])), doc.get("schema"))]
    # entry census by kind: one line says what the ring recorded
    kinds = collections.Counter(
        str(entry.get("kind", "?"))
        for entry in doc.get("entries", [])
        if isinstance(entry, dict))
    if kinds:
        lines.append("  kinds: " + ", ".join(
            "%s=%d" % kv for kv in sorted(kinds.items())))
    when = doc.get("time")
    if when:
        lines.append("  time: %s" % time.strftime(
            "%Y-%m-%d %H:%M:%S", time.localtime(when)))
    xla = doc.get("xla")
    if isinstance(xla, dict):
        lines.append("  xla: %d compiles, %d storms" % (
            sum((xla.get("compiles") or {}).values()),
            sum((xla.get("storms") or {}).values())))
    for entry in doc.get("entries", [])[-tail:] if tail else []:
        lines.append("  %-10s %s" % (
            entry.get("kind", "?"),
            json.dumps({k: v for k, v in entry.items()
                        if k not in ("kind", "t", "mono")},
                       default=str)[:160]))
    return "\n".join(lines)


def blackbox_main(path=None, tail=20):
    """``veles_tpu_torch observe blackbox [PATH]``: summarize one dump, or
    list the dumps in a directory (default: the run dir) newest-first
    and show the newest one's tail. Returns 0, or 1 when nothing is
    found."""
    import glob

    if path is None:
        path = get_flight_recorder()._dump_dir()
    if os.path.isdir(path):
        dumps = sorted(glob.glob(os.path.join(path, "blackbox-*.json")),
                       key=os.path.getmtime, reverse=True)
        if not dumps:
            print("no black-box dumps under %s" % path)
            return 1
        for i, dump_path in enumerate(dumps):
            try:
                doc = load_dump(dump_path)
            except (OSError, ValueError) as exc:
                print("%s: unreadable (%s)" % (dump_path, exc))
                continue
            print(_summarize(doc, dump_path,
                             tail=tail if i == 0 else 0))
        return 0
    try:
        doc = load_dump(path)
    except (OSError, ValueError) as exc:
        print("cannot load %s: %s" % (path, exc))
        return 1
    print(_summarize(doc, path, tail=tail))
    return 0
