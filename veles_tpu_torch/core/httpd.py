"""Stdlib HTTP-server plumbing for the serving front.

The port's own copy of ``veles_tpu/core/httpd.py:31-131, 331-341``: the
ThreadingHTTPServer-on-a-daemon-thread lifecycle, JSON replies, a
request-body cap that answers 413 before buffering anything, and the
``/healthz`` + ``/readyz`` routes with their Retry-After pricing. Binds
loopback by default.
"""

import json
import threading

#: default request-body cap (bytes)
MAX_BODY = 32 * 1024 * 1024


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


def start_server(handler_cls, host="127.0.0.1", port=0, name="httpd"):
    """Start a ThreadingHTTPServer on a daemon thread. Returns
    ``(httpd, resolved_port)``; stop with ``httpd.shutdown()`` and
    ``httpd.server_close()``."""
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer((host, port), handler_cls)
    thread = threading.Thread(target=httpd.serve_forever, name=name,
                              daemon=True)
    thread.start()
    return httpd, httpd.server_address[1]
