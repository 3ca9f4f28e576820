"""Stdlib HTTP-server plumbing for the serving front.

The port's own copy of ``veles_tpu/core/httpd.py:31-89, 331-341``: the
ThreadingHTTPServer-on-a-daemon-thread lifecycle, JSON replies, and a
request-body cap that answers 413 before buffering anything. Binds
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
