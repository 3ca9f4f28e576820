"""Stdlib HTTP-server plumbing for the serving front.

The port's own copy of ``veles_tpu/core/httpd.py:31-341``: the
ThreadingHTTPServer-on-a-daemon-thread lifecycle, JSON replies, a
request-body cap that answers 413 before buffering anything, the
``/healthz`` + ``/readyz`` routes with their Retry-After pricing, and
the observe plane's routes: ``GET /metrics`` (:func:`serve_metrics`,
Prometheus text or OpenMetrics by ``Accept``), the ``GET /debug/`` index
(:func:`serve_debug_index`) and its four surfaces: ``/debug/requests``
(the request ledger), ``/debug/history`` (the metric history),
``/debug/serve`` (the serve scope) and ``/debug/memory`` (memscope).
Binds loopback by default.
"""

import json
import threading
from http.server import ThreadingHTTPServer

#: default request-body cap (bytes)
MAX_BODY = 32 * 1024 * 1024


class _Server(ThreadingHTTPServer):
    #: the listen backlog: socketserver's default of 5 drops the
    #: connections of a burst of concurrent clients, whose SYNs are
    #: retried after 1 s and then 3 s
    request_queue_size = 128


class QuietHandlerMixin:
    """Suppress the per-request stderr log lines."""

    def log_message(self, *args):
        pass


class BodyTooLarge(ValueError):
    """Raised by :func:`read_body` after the 413 has been sent."""


def reply(handler, body, code=200, content_type="application/json",
          headers=None):
    """Write one complete HTTP response. A peer walking away mid-reply
    marks the connection closed instead of raising into the handler."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    elif isinstance(body, str):
        body = body.encode()
    try:
        handler.send_response(code)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            handler.send_header(key, value)
        handler.end_headers()
        handler.wfile.write(body)
    except OSError:
        handler.close_connection = True


def read_body(handler, limit=MAX_BODY):
    """Read the request body, bounded. An absent or garbage
    ``Content-Length`` reads as empty; one above ``limit`` answers 413
    at once and raises :class:`BodyTooLarge`."""
    try:
        length = int(handler.headers.get("Content-Length", 0))
    except (TypeError, ValueError):
        length = 0
    if length < 0:
        length = 0
    if length > limit:
        reply(handler, {"error": "request body %d bytes exceeds the "
                                 "%d byte cap" % (length, limit)},
              code=413)
        handler.close_connection = True
        raise BodyTooLarge("body %d > cap %d" % (length, limit))
    return handler.rfile.read(length)


def retry_after_headers(source, need=1, fallback=1.0):
    """The ``Retry-After`` header of a 429 or 503 priced by ``source``'s
    ``retry_after_s(need)`` (a ServingHealth prices by its pool's page
    release rate), clamped to [1, 60] seconds; a source without one, or
    one that raises, gives ``fallback``."""
    seconds = None
    price = getattr(source, "retry_after_s", None)
    if price is not None:
        try:
            seconds = price(need)
        except Exception:   # noqa: BLE001 - never break the reply
            seconds = None
    if seconds is None:
        seconds = fallback
    return {"Retry-After": "%d" % int(min(60, max(1, round(seconds))))}


def serve_health(handler, health):
    """Route ``GET /healthz`` and ``GET /readyz`` against ``health`` (an
    object with ``snapshot()`` and a ``ready`` bool). ``/healthz``
    always answers 200 with the snapshot; ``/readyz`` 200 only while the
    front can serve, else 503 with the snapshot and a Retry-After, so a
    load balancer drains a rebuilding replica. Returns True when the
    path was one of the two."""
    path = handler.path.split("?")[0]
    if path == "/healthz":
        reply(handler, health.snapshot())
        return True
    if path == "/readyz":
        if health.ready:
            reply(handler, {"ready": True})
        else:
            reply(handler, {"ready": False, "state": health.snapshot()},
                  code=503, headers=retry_after_headers(health))
        return True
    return False


def serve_metrics(handler, registry=None):
    """Route ``GET /metrics``: the exposition of ``registry`` (default:
    the process-global one). Returns True when the path was handled.
    The first mount enables the registry and the device-truth plane
    (``observe/xla_stats.ensure_registered``).

    Content negotiation: a scraper advertising
    ``application/openmetrics-text`` in ``Accept`` gets the OpenMetrics
    rendering (histogram bucket exemplars, the ``# EOF`` terminator);
    everyone else gets the plain 0.0.4 text, so exemplars never break a
    legacy scraper."""
    path = handler.path.split("?")[0]
    if path != "/metrics":
        return False
    if registry is None:
        from veles_tpu_torch.observe.metrics import get_metrics_registry
        registry = get_metrics_registry()
    registry.enable()  # scrapeable == enabled
    from veles_tpu_torch.observe.xla_stats import ensure_registered
    ensure_registered(registry)
    # the metric history is on wherever /metrics is (idempotent), and
    # the serving goodput families ride every mount, gated on traffic
    from veles_tpu_torch.observe.history import start_history_sampler
    start_history_sampler()
    from veles_tpu_torch.observe.servescope import ensure_serve_registered
    ensure_serve_registered(registry)
    accept = str(getattr(handler, "headers", {}).get("Accept") or "")
    if "application/openmetrics-text" in accept:
        reply(handler, registry.expose(openmetrics=True),
              content_type="application/openmetrics-text; "
                           "version=1.0.0; charset=utf-8")
    else:
        reply(handler, registry.expose(),
              content_type="text/plain; version=0.0.4; charset=utf-8")
    return True


#: the debug surfaces mounted on the serving HTTP fronts, path -> one-line
#: description: what ``GET /debug/`` answers
DEBUG_SURFACES = {
    "/debug/requests": "request-truth ledger: in-flight + slowest "
                       "resolved request rows (observe/reqledger.py)",
    "/debug/history": "metric flight recorder: windowed series tails "
                      "+ anomaly-rule states (observe/history.py)",
    "/debug/serve": "serving goodput observatory: per-slot occupancy "
                    "timeline + token-waste decomposition "
                    "(observe/servescope.py; assemble with `python -m "
                    "veles_tpu_torch observe serve-trace`)",
    "/debug/memory": "per-owner device-memory attribution: reconciled "
                     "owner bytes + untagged residue, lifecycle-edge "
                     "leak verdicts and the pool headroom forecast "
                     "(observe/memscope.py)",
}


def serve_debug_index(handler, surfaces=None):
    """Route ``GET /debug`` / ``GET /debug/``: the debug surfaces mounted
    on this server (path -> description). Returns True when the path was
    handled."""
    path = handler.path.split("?")[0]
    if path not in ("/debug", "/debug/"):
        return False
    reply(handler, {"surfaces": dict(DEBUG_SURFACES
                                     if surfaces is None
                                     else surfaces)})
    return True


def _query(handler):
    """``(path, {key: value})`` of the request's URL."""
    path, _, query = handler.path.partition("?")
    params = {}
    for part in query.split("&"):
        key, sep, value = part.partition("=")
        if sep:
            params[key] = value
    return path, params


def serve_debug_serve(handler, scope=None, ledger=None):
    """Route ``GET /debug/serve``: the serve scope's payload
    (``observe/servescope.py``): the goodput and waste decomposition,
    the per-slot occupancy timeline and the ledger rows it merges with,
    which ``observe serve-trace`` assembles into a Perfetto trace.
    Returns True when handled."""
    if _query(handler)[0] != "/debug/serve":
        return False
    if scope is None:
        from veles_tpu_torch.observe.servescope import get_serve_scope
        scope = get_serve_scope()
    if ledger is None:
        from veles_tpu_torch.observe.reqledger import get_request_ledger
        ledger = get_request_ledger()
    reply(handler, scope.debug_snapshot(ledger=ledger))
    return True


def serve_debug_requests(handler, ledger=None):
    """Route ``GET /debug/requests``: the request ledger's in-flight rows
    and the N slowest resolved (``?n=``, default 8, capped 64)
    (``observe/reqledger.py``). Returns True when handled."""
    path, params = _query(handler)
    if path != "/debug/requests":
        return False
    if ledger is None:
        from veles_tpu_torch.observe.reqledger import get_request_ledger
        ledger = get_request_ledger()
    n = 8
    try:
        n = max(1, min(64, int(params.get("n", n))))
    except ValueError:
        pass
    reply(handler, ledger.debug_snapshot(slowest=n))
    return True


def serve_debug_history(handler, history=None):
    """Route ``GET /debug/history``: the metric history's windowed series
    tails and anomaly-rule states (``observe/history.py``); ``series=``
    filters by name substring, ``window=`` keeps the trailing seconds.
    404 while the history is disabled. Returns True when handled."""
    path, params = _query(handler)
    if path != "/debug/history":
        return False
    if history is None:
        from veles_tpu_torch.observe.history import get_metric_history
        history = get_metric_history()
    if history is None:
        reply(handler, {"error": "metric history disabled "
                                 "(root.common.observe.history)"},
              code=404)
        return True
    window = None
    try:
        if "window" in params:
            window = max(0.0, float(params["window"]))
    except ValueError:
        pass
    reply(handler, history.debug_snapshot(
        series=params.get("series") or None, window=window))
    return True


def serve_debug_memory(handler, scope=None):
    """Route ``GET /debug/memory``: memscope's reconciled per-owner
    attribution, the trailing lifecycle-edge verdicts (``edges=``,
    default 16, capped 64) and the pool headroom forecast
    (``observe/memscope.py``). Returns True when handled."""
    path, params = _query(handler)
    if path != "/debug/memory":
        return False
    if scope is None:
        from veles_tpu_torch.observe.memscope import get_memscope
        scope = get_memscope()
    edges = 16
    try:
        edges = max(1, min(64, int(params.get("edges", edges))))
    except ValueError:
        pass
    reply(handler, scope.debug_snapshot(edges=edges))
    return True


def enable_metrics(holder=None):
    """Turn the process-global registry on (idempotent) with the
    device-truth plane and the serving goodput families attached, and
    start the metric history's sampler; every HTTP surface calls this at
    start, so its counters accumulate from the first request, not the
    first scrape. ``holder`` (the front) keeps the sampler running until
    it releases it (``history.release_history_sampler``). Returns the
    registry."""
    from veles_tpu_torch.observe.history import start_history_sampler
    from veles_tpu_torch.observe.metrics import get_metrics_registry
    from veles_tpu_torch.observe.servescope import ensure_serve_registered
    from veles_tpu_torch.observe.xla_stats import ensure_registered
    registry = ensure_registered(get_metrics_registry().enable())
    ensure_serve_registered(registry)
    start_history_sampler(holder)
    return registry


def start_server(handler_cls, host="127.0.0.1", port=0, name="httpd"):
    """Start a ThreadingHTTPServer on a daemon thread. Returns
    ``(httpd, resolved_port)``; stop with ``httpd.shutdown()`` and
    ``httpd.server_close()``."""
    httpd = _Server((host, port), handler_cls)
    thread = threading.Thread(target=httpd.serve_forever, name=name,
                              daemon=True)
    thread.start()
    return httpd, httpd.server_address[1]
