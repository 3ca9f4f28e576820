"""Web status dashboard.

The port of ``veles_tpu/web_status.py`` (reference
``veles/web_status.py:113-165`` + the ``web/`` SPA): a dependency-free
stdlib server, embeddable in-process or run standalone via ``python -m
veles_tpu_torch.web_status``:

- ``POST /update``   — masters push status JSON;
- ``GET  /service``  — AJAX: current statuses as JSON;
- ``GET  /``         — self-contained HTML dashboard (live over SSE):
  workflows table (name, mode, slaves, runtime, fleet, serving, device,
  trends) + the live unit graphs + the latest rendered plots;
- ``GET  /plots/<f>``— serves the GraphicsServer's rendered images;
- ``GET  /events``   — tail of the event JSONL stream;
- ``GET  /metrics``  — the process's metric families (``core/httpd``),
  the device truth with the mesh gauges and the reduce plane among them.

:class:`StatusNotifier` is the launcher-side agent (reference
``launcher.py:852-885``): a daemon thread that assembles and POSTs the
status snapshot every ``notification_interval``. The device column reads
``observe/xla_stats.device_summary``: the card's memory, the kernel
builds and the active mesh (``data2``). The fleet column formats what a
fleet master reports (``fleet/server.Server.fleet_status``), which reaches
it through the master's launcher and its notifier (``status["fleet"]``,
``web_status.py:728-745``) and reads as the JAX package's
(tests/test_torch_fleet_observe.py).
"""

import glob
import json
import os
import threading
import time
import urllib.parse
import urllib.request

from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.observe.xla_stats import format_device_stats

_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu status</title>
<noscript><meta http-equiv="refresh" content="3"></noscript>
<style>
 body { font-family: sans-serif; margin: 2em; }
 table { border-collapse: collapse; }
 td, th { border: 1px solid #999; padding: 4px 10px; }
 img { max-width: 420px; margin: 8px; border: 1px solid #ccc; }
</style></head><body>
<h1>veles_tpu status</h1>
<h2>Workflows</h2>
<table id="wf"><tr><th>name</th><th>mode</th><th>slaves</th>
<th>runtime (s)</th><th>fleet health</th><th>serving</th>
<th>device</th><th>trends</th><th>updated</th></tr>%(rows)s</table>
<h2>Workflow graphs</h2><div id="graphs">%(graphs)s</div>
<h2>Plots</h2><div id="plots">%(plots)s</div>
<script>
// live updates over SSE (/stream): swap the table and re-point the
// plot/graph <img> cache-busters when the server says state changed —
// a running training is watchable without page reloads (the reference
// streamed live plots over epgm multicast, graphics_server.py:100-133)
function esc(s) {
  return String(s).replace(/[&<>"']/g, function(c) {
    return {'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',
            "'":'&#39;'}[c]; });
}
var src = new EventSource('/stream');
src.onmessage = function(ev) {
  var state = JSON.parse(ev.data);
  var rows = ['<tr><th>name</th><th>mode</th><th>slaves</th>' +
              '<th>runtime (s)</th><th>fleet health</th>' +
              '<th>serving</th><th>device</th><th>trends</th>' +
              '<th>updated</th></tr>'];
  (state.workflows || []).forEach(function(w) {
    rows.push('<tr><td>' + esc(w.name) + '</td><td>' + esc(w.mode) +
              '</td><td>' + (0 | w.slaves) + '</td><td>' +
              Math.round(w.runtime) + '</td><td>' + esc(w.fleet || '') +
              '</td><td>' + esc(w.serving || '') +
              '</td><td>' + esc(w.device || '') +
              '</td><td>' + esc(w.trends || '') +
              '</td><td>' + esc(w.updated) + '</td></tr>');
  });
  document.getElementById('wf').innerHTML = rows.join('');
  var graphs = [];
  (state.graphs || []).forEach(function(g) {
    graphs.push('<h3>' + esc(g.name) + '</h3><img src="/graph/' +
                encodeURIComponent(g.key) + '.svg?t=' + g.t +
                '" style="max-width:100%%;border:1px solid #ccc"/>');
  });
  document.getElementById('graphs').innerHTML =
    graphs.join('') || '<p>none</p>';
  var plots = [];
  (state.plots || []).forEach(function(p) {
    plots.push('<img src="/plots/' + encodeURIComponent(p.name) +
               '?t=' + p.mtime + '" alt="' + esc(p.name) + '"/>');
  });
  document.getElementById('plots').innerHTML =
    plots.join('') || '<p>none</p>';
};
</script>
</body></html>"""

def tail_lines(path, limit, block=65536):
    """The last ``limit`` text lines of ``path``, reading only from the
    end: seek backwards in ``block``-byte strides until enough newlines
    (or the file start) are in hand. Bytes read is bounded by the tail
    itself, not the file size. Undecodable bytes are replaced, a
    torn first line (mid-block cut) is dropped by the line split."""
    with open(path, "rb") as fin:
        fin.seek(0, os.SEEK_END)
        size = fin.tell()
        chunks = []
        pos = size
        newlines = 0
        while pos > 0 and newlines <= limit:
            step = min(block, pos)
            pos -= step
            fin.seek(pos)
            chunk = fin.read(step)
            chunks.append(chunk)
            newlines += chunk.count(b"\n")
        data = b"".join(reversed(chunks))
    # when the loop stopped mid-file (pos > 0) it holds > limit
    # newlines, so the slice always drops the possibly-torn first line
    lines = data.decode("utf-8", "replace").splitlines()
    return lines[-limit:]


def format_fleet_health(fleet):
    """The master's ledger/chaos counters as one table cell (consumed by
    both the static page and the /stream JS — formatted server-side so
    the two views cannot drift). Empty for standalone runs."""
    if not isinstance(fleet, dict):
        return ""
    parts = []
    if fleet.get("plane") == "control":
        # the compiler-visible wire (docs/compiler_fleet.md): say so,
        # since "jobs done" then means assignments, not weight merges
        parts.append("control-plane")
    ledger = fleet.get("ledger")
    if isinstance(ledger, dict):
        parts.append("%s/%s jobs done" % (ledger.get("done", 0),
                                          ledger.get("issued", 0)))
        if ledger.get("requeued"):
            parts.append("%s requeued" % ledger["requeued"])
        if ledger.get("fenced_total"):
            parts.append("%s fenced" % ledger["fenced_total"])
    sync = fleet.get("sync")
    if isinstance(sync, dict) and (sync.get("applied")
                                   or sync.get("fenced")):
        parts.append("%s syncs" % sync.get("applied", 0)
                     + (" (%s fenced)" % sync["fenced"]
                        if sync.get("fenced") else ""))
    reduce_rows = fleet.get("reduce")
    if isinstance(reduce_rows, dict) and reduce_rows:
        steps = sum(e.get("steps", 0) for e in reduce_rows.values()
                    if isinstance(e, dict))
        bytes_total = sum(e.get("bytes", 0)
                          for e in reduce_rows.values()
                          if isinstance(e, dict))
        idles = [e["idle"] for e in reduce_rows.values()
                 if isinstance(e, dict) and e.get("idle") is not None]
        cell = "in-program reduce: %d steps" % steps
        if bytes_total:
            cell += " · %.1f MB wire" % (bytes_total / 1e6)
        if idles:
            cell += " · idle %d%%" % round(100 * max(idles))
        parts.append(cell)
    goodput = fleet.get("goodput")
    if isinstance(goodput, dict) and goodput.get("jobs"):
        cell = "goodput %d%%" % round(
            100.0 * (goodput.get("fraction") or 0.0))
        if goodput.get("wasted_s"):
            cell += " · %.1fs wasted" % goodput["wasted_s"]
        parts.append(cell)
    straggler = fleet.get("straggler")
    if isinstance(straggler, dict) and straggler.get("slave"):
        parts.append("straggler %s (%.1fx median)"
                     % (straggler["slave"],
                        straggler.get("score", 0.0)))
    chaos = fleet.get("chaos")
    if isinstance(chaos, dict):
        fired = ", ".join("%s %s" % (v, k.replace("_", " "))
                          for k, v in sorted(chaos.items()) if v)
        if fired:
            parts.append("chaos: " + fired)
    return " · ".join(parts)


def format_serving_health(serving):
    """A ServingHealth.snapshot() as one table cell (the serving twin of
    :func:`format_fleet_health`): readiness + breaker state + the
    non-zero survival counters. Empty for non-serving masters."""
    if not isinstance(serving, dict):
        return ""
    parts = ["ready" if serving.get("ready") else "NOT READY"]
    breaker = serving.get("breaker")
    if breaker and breaker != "closed":
        parts.append("breaker %s" % breaker)
    try:
        inflight = int(serving.get("inflight", 0))
    except (TypeError, ValueError):
        inflight = 0
    if inflight:
        parts.append("%d in flight" % inflight)
    counters = serving.get("counters")
    if isinstance(counters, dict):
        fired = ", ".join("%s %s" % (counters[key], key)
                          for key in ("completed", "trips", "rebuilds",
                                      "shed", "expired", "rejected",
                                      "errors")
                          if counters.get(key))
        if fired:
            parts.append(fired)
    latency = serving.get("latency_ms")
    if isinstance(latency, dict):
        # the serving-performance observability pair (docs/
        # serving_performance.md): staged->first-token and
        # staged->slot-admitted p95s over the rolling window
        for kind, label in (("ttft", "ttft"), ("tpot", "tpot"),
                            ("queue_wait", "queue")):
            entry = latency.get(kind)
            if isinstance(entry, dict) and entry.get("count"):
                parts.append("%s p95 %sms" % (label, entry["p95"]))
    governor = serving.get("governor")
    if isinstance(governor, dict):
        # the closed-loop cell (observe/governor.py): the governed
        # tier while degraded, plus how many times the ladder moved —
        # a dashboard scan shows "tier int8 (governed)" the moment
        # graceful degradation engages
        if governor.get("demoted"):
            parts.append("tier %s (governed)" % governor.get("tier"))
        gov_counters = governor.get("counters")
        if isinstance(gov_counters, dict):
            moves = (gov_counters.get("demotions", 0)
                     + gov_counters.get("promotions", 0))
            if moves:
                parts.append("%d tier moves" % moves)
            if gov_counters.get("guard_trips"):
                parts.append("%d guard trips"
                             % gov_counters["guard_trips"])
    slo = serving.get("slo")
    if isinstance(slo, dict) and slo.get("burn_rate") is not None:
        # the SLO cell (observe/slo.py): the worst short-window burn
        # rate — >1.0 means the error budget is burning faster than
        # sustainable, the number an on-call scans for first
        parts.append("burn %.1fx (%s/%s)"
                     % (slo["burn_rate"], slo.get("objective"),
                        slo.get("window")))
    scope = serving.get("servescope")
    if isinstance(scope, dict):
        # the goodput-observatory pair (observe/servescope.py): slot
        # occupancy and the useful share of dispatched tokens — the
        # "was the chip time worth it" cell beside the burn rate
        occupancy = scope.get("occupancy")
        if isinstance(occupancy, (int, float)):
            parts.append("occupancy %d%%" % round(occupancy * 100))
        goodput = scope.get("goodput")
        if isinstance(goodput, (int, float)):
            parts.append("goodput %d%%" % round(goodput * 100))
        cause = scope.get("dominant_cause")
        share = scope.get("waste_share")
        if cause and isinstance(share, (int, float)) and share >= 0.25:
            # only call the cause out once waste is worth a look
            parts.append("waste %d%% (%s)" % (round(share * 100),
                                              cause))
    pool = serving.get("pool")
    if isinstance(pool, dict):
        # the paged-KV pair (docs/paged_kv.md): page occupancy and the
        # prefix-cache hit rate, next to the survival counters
        try:
            parts.append("pages %d/%d" % (pool.get("pages_used", 0),
                                          pool.get("pages_total", 0)))
        except TypeError:
            pass
        rate = pool.get("prefix_hit_rate")
        if isinstance(rate, (int, float)):
            parts.append("prefix hit %d%%" % round(rate * 100))
    memscope = serving.get("memscope")
    if isinstance(memscope, dict):
        # the HBM attribution cell (observe/memscope.py): who owns the
        # bytes, how long the pool lasts at the current admission
        # rate, and whether a lifecycle edge leaked — the on-call's
        # first look before the raw device gauge
        owner = memscope.get("top_owner")
        tagged = memscope.get("tagged_bytes")
        if owner and isinstance(tagged, (int, float)) and tagged:
            parts.append("hbm %dMB (top %s)"
                         % (round(tagged / 1e6), owner))
        headroom = memscope.get("headroom_s")
        if isinstance(headroom, (int, float)):
            parts.append("headroom ~%ds" % round(headroom))
        leaks = memscope.get("leaks")
        if leaks:
            parts.append("%d leaks (%s)"
                         % (leaks,
                            memscope.get("last_leak_owner", "?")))
    return " · ".join(parts)


def format_trends_cell(trends):
    """Metric-history sparkline cells (observe/history.py) as one
    table cell: the notifier ships ``[{"label", "spark", "last"}]``
    rows and this renders ``label ▁▂▅█ last`` per series — formatted
    server-side so the static page and the /stream JS cannot drift.
    Empty for masters without a history (old notifiers, disabled)."""
    if not isinstance(trends, list):
        return ""
    from veles_tpu_torch.observe.history import sparkline
    parts = []
    for cell in trends[:8]:
        if not isinstance(cell, dict):
            continue
        spark = cell.get("spark")
        if isinstance(spark, list):
            spark = sparkline(spark, width=16)
        parts.append("%s %s %s" % (cell.get("label", "?"),
                                   spark or "", cell.get("last", "")))
    return " · ".join(parts)


#: view-group fill colors for the live graph (the reference's viz.js
#: page colored by the same VIEW_GROUP taxonomy)
_GROUP_FILL = {"LOADER": "#c8e6c9", "WORKER": "#bbdefb",
               "TRAINER": "#ffe0b2", "EVALUATOR": "#e1bee7",
               "SERVICE": "#fff9c4", "PLUMBING": "#eeeeee"}


def render_graph_svg(graph):
    """A unit DAG as a self-contained SVG (no graphviz binary, no CDN
    viz.js — the environment has neither; the DAGs are 10-40 nodes, so
    a layered BFS layout is plenty). Back-edges (the repeater loop)
    route around the left side."""
    from html import escape

    nodes = [n for n in list(graph.get("nodes") or [])[:200]
             if isinstance(n, dict) and n.get("id") is not None]
    edges = [e for e in list(graph.get("edges") or [])[:600]
             if isinstance(e, (list, tuple)) and len(e) == 2]
    if not nodes:
        return "<svg xmlns='http://www.w3.org/2000/svg'/>"
    index = {n.get("id"): n for n in nodes}
    targets = {e[1] for e in edges}
    roots = [n.get("id") for n in nodes if n.get("id") not in targets] \
        or [nodes[0].get("id")]
    out = {}
    for a, b in edges:
        out.setdefault(a, []).append(b)
    rank = {r: 0 for r in roots}
    frontier = list(roots)
    while frontier:  # BFS depth = rank; cycles stop at the visited set
        node = frontier.pop(0)
        for nxt in out.get(node, []):
            if nxt not in rank and nxt in index:
                rank[nxt] = rank[node] + 1
                frontier.append(nxt)
    for n in nodes:  # disconnected nodes park at the bottom
        rank.setdefault(n.get("id"), max(rank.values()) + 1)
    by_rank = {}
    for nid, r in rank.items():
        by_rank.setdefault(r, []).append(nid)
    row_h, pad, char_w = 64, 24, 7
    pos, widths = {}, {}
    width = pad
    for r in sorted(by_rank):
        x = pad + 40  # left gutter for back-edges
        for nid in by_rank[r]:
            node = index[nid]
            w = max(90, char_w * len(str(node.get("label", ""))) + 16)
            pos[nid] = (x, pad + r * row_h)
            widths[nid] = w
            x += w + 18
        width = max(width, x)
    height = pad * 2 + (max(by_rank) + 1) * row_h
    parts = [
        "<svg xmlns='http://www.w3.org/2000/svg' width='%d' height='%d'"
        " font-family='sans-serif' font-size='11'>" % (width, height),
        "<defs><marker id='arr' markerWidth='8' markerHeight='8' "
        "refX='7' refY='3' orient='auto'>"
        "<path d='M0,0 L7,3 L0,6 z' fill='#555'/></marker></defs>"]
    for a, b in edges:
        if a not in pos or b not in pos:
            continue
        ax, ay = pos[a]
        bx, by = pos[b]
        ax += widths[a] / 2
        bx += widths[b] / 2
        if rank[b] > rank[a]:  # forward: straight line
            parts.append(
                "<line x1='%.0f' y1='%.0f' x2='%.0f' y2='%.0f' "
                "stroke='#555' marker-end='url(#arr)'/>"
                % (ax, ay + 30, bx, by))
        else:  # back-edge (repeater loop): route around the gutter
            parts.append(
                "<path d='M%.0f,%.0f C %d,%.0f %d,%.0f %.0f,%.0f' "
                "fill='none' stroke='#999' stroke-dasharray='4,3' "
                "marker-end='url(#arr)'/>"
                % (ax, ay + 30, 8, ay + 30, 8, by + 15, bx - 4,
                   by + 15))
    for nid, (x, y) in pos.items():
        node = index[nid]
        fill = _GROUP_FILL.get(str(node.get("group", "")), "#eeeeee")
        runs = node.get("runs", 0)
        label = escape(str(node.get("label", "")))
        cls = escape(str(node.get("cls", "")))
        parts.append(
            "<g><rect x='%d' y='%d' width='%d' height='30' rx='4' "
            "fill='%s' stroke='%s'/>"
            "<text x='%d' y='%d' text-anchor='middle'>%s</text>"
            "<text x='%d' y='%d' text-anchor='middle' fill='#666' "
            "font-size='9'>%s%s</text></g>"
            % (x, y, widths[nid], fill,
               "#1565c0" if runs else "#999",
               x + widths[nid] / 2, y + 13, label,
               x + widths[nid] / 2, y + 25, cls,
               escape(" x%d" % runs) if runs else ""))
    parts.append("</svg>")
    return "".join(parts)


class WebStatusServer(Logger):
    """Status receiver + dashboard (reference ``WebServer``,
    ``web_status.py:113``)."""

    #: drop master records not refreshed for this long (reference GC)
    STALE_AFTER = 3600.0
    #: /stream server-side change-poll cadence (seconds)
    STREAM_POLL = 0.5

    def __init__(self, port=None, host=None, plots_directory=None,
                 events_path=None):
        super().__init__()
        self.port = port if port is not None \
            else root.common.web.get("port", 8090)
        # loopback by default — same posture as the fleet server
        self.host = host or root.common.web.get("host", "127.0.0.1")
        self.plots_directory = plots_directory
        self.events_path = events_path
        self._statuses = {}
        self._lock = threading.Lock()
        self._httpd = None
        self._shutdown = threading.Event()

    def start(self):
        from http.server import BaseHTTPRequestHandler
        from veles_tpu_torch.core.httpd import (
            DEBUG_SURFACES, BodyTooLarge, enable_metrics, QuietHandlerMixin,
            read_body, reply, serve_debug_history, serve_debug_index,
            serve_debug_serve, serve_metrics, start_server)

        # the dashboard holds the metric history's sampler until stop()
        enable_metrics(holder=self)
        server = self

        class Handler(QuietHandlerMixin, BaseHTTPRequestHandler):
            def do_POST(self):
                if self.path != "/update":
                    self.send_error(404)
                    return
                try:
                    status = json.loads(read_body(self).decode())
                except BodyTooLarge:
                    return  # 413 sent before anything was buffered
                except ValueError:
                    reply(self, {"error": "bad json"}, code=400)
                    return
                if not isinstance(status, dict):
                    reply(self, {"error": "status must be an object"},
                          code=400)
                    return
                server.update(status)
                reply(self, {"ok": True})

            def do_GET(self):
                if serve_metrics(self):
                    pass
                elif serve_debug_history(self):
                    pass
                elif serve_debug_serve(self):
                    pass
                elif serve_debug_index(self, surfaces={
                        path: text for path, text
                        in DEBUG_SURFACES.items()
                        if path != "/debug/requests"}):
                    # the index lists what THIS server mounts (the
                    # dashboard has no request-ledger endpoint)
                    pass
                elif self.path.startswith("/service"):
                    reply(self, server.statuses())
                elif self.path.startswith("/events"):
                    reply(self, server.tail_events())
                elif self.path.startswith("/plots.json"):
                    reply(self, server.plots_state())
                elif self.path.startswith("/stream"):
                    self._serve_stream()
                elif self.path.startswith("/plots/"):
                    self._serve_plot(self.path[len("/plots/"):])
                elif self.path.startswith("/graph/"):
                    key = self.path[len("/graph/"):].partition("?")[0]
                    if key.endswith(".svg"):
                        key = key[:-4]
                    # the page quoted the key into the URL
                    key = urllib.parse.unquote(key)
                    graph = server.statuses().get(key, {}).get("graph")
                    if not isinstance(graph, dict):
                        self.send_error(404)
                        return
                    try:
                        svg = render_graph_svg(graph)
                    except Exception:
                        # /update is unauthenticated: a malformed graph
                        # payload must 404, never wedge the connection
                        self.send_error(404)
                        return
                    reply(self, svg, 200, "image/svg+xml")
                elif self.path in ("/", "/index.html"):
                    reply(self, server.render_page(), 200, "text/html")
                else:
                    self.send_error(404)

            def _serve_stream(self):
                """SSE: one state event immediately, then one whenever a
                plot mtime or a master status changes (polled server-side
                every STREAM_POLL seconds). One thread per subscriber
                (ThreadingHTTPServer); ends on client disconnect or
                server shutdown."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                last = None
                try:
                    while not server._shutdown.is_set():
                        state = server.live_state()
                        digest = json.dumps(state, sort_keys=True)
                        if digest != last:
                            last = digest
                            self.wfile.write(
                                b"data: " + digest.encode() + b"\n\n")
                            self.wfile.flush()
                        server._shutdown.wait(server.STREAM_POLL)
                except (BrokenPipeError, ConnectionResetError,
                        OSError):
                    pass  # subscriber went away

            def _serve_plot(self, name):
                name = name.partition("?")[0]  # cache-buster query
                directory = server.plots_directory
                if not directory or os.path.sep in name or ".." in name:
                    self.send_error(404)
                    return
                path = os.path.join(directory, name)
                if not os.path.isfile(path):
                    self.send_error(404)
                    return
                with open(path, "rb") as fin:
                    data = fin.read()
                ctype = ("application/pdf" if name.endswith(".pdf")
                         else "image/png")
                reply(self, data, 200, ctype)

        self._httpd, self.port = start_server(
            Handler, self.host, self.port, name="web-status")
        self.info("web status on http://%s:%d/", self.host, self.port)
        return self

    def stop(self):
        self._shutdown.set()  # wake + end the /stream subscriber loops
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            from veles_tpu_torch.observe.history import (
                release_history_sampler)
            release_history_sampler(self)

    # -- state ----------------------------------------------------------------
    def update(self, status):
        with self._lock:
            # str() coercion: hostile ids must be hashable AND sortable
            # against other masters' string keys
            key = str(status.get("id") or status.get("name", "?"))
            status["updated"] = time.time()
            self._statuses[key] = status
            # GC stale masters (reference old-record GC)
            cutoff = time.time() - self.STALE_AFTER
            for k in [k for k, s in self._statuses.items()
                      if s["updated"] < cutoff]:
                del self._statuses[k]

    def statuses(self):
        with self._lock:
            return dict(self._statuses)

    def plots_state(self):
        """The rendered plots as [{"name", "mtime"}] — the polling half
        of the live view (and what /stream diffs against)."""
        out = []
        if self.plots_directory and os.path.isdir(self.plots_directory):
            for path in sorted(glob.glob(
                    os.path.join(self.plots_directory, "*.png"))):
                try:
                    mtime = int(os.stat(path).st_mtime)
                except OSError:
                    continue
                out.append({"name": os.path.basename(path),
                            "mtime": mtime})
        return out

    def live_state(self):
        """The compact state snapshot /stream pushes: workflow rows,
        graph stamps, plot mtimes — everything the live page redraws."""
        workflows, graphs = [], []
        for key, s in sorted(self.statuses().items()):
            try:
                runtime = float(s.get("runtime", 0))
            except (TypeError, ValueError):
                runtime = 0.0
            slaves = s.get("slaves", [])
            workflows.append({
                "name": str(s.get("name", key)),
                "mode": str(s.get("mode", "?")),
                "slaves": len(slaves)
                if isinstance(slaves, (list, tuple)) else 0,
                "runtime": runtime,
                "fleet": format_fleet_health(s.get("fleet")),
                "serving": format_serving_health(s.get("serving")),
                "device": format_device_stats(s.get("device")),
                "trends": format_trends_cell(s.get("trends")),
                "updated": time.strftime(
                    "%X", time.localtime(s.get("updated", 0)))})
            if isinstance(s.get("graph"), dict):
                graphs.append({"key": key,
                               "name": str(s.get("name", key)),
                               "t": int(s.get("updated", 0))})
        return {"workflows": workflows, "graphs": graphs,
                "plots": self.plots_state()}

    def tail_events(self, limit=200):
        """The last ``limit`` events, read by seeking from the END of
        the JSONL file in fixed blocks — the dashboard polls this every
        few seconds, and a long run's event log grows to many MB;
        reading it whole per poll was an accidental O(file) tax on the
        serving box (the events the page shows are only the tail)."""
        path = self.events_path
        if not path or not os.path.isfile(path):
            return []
        out = []
        for line in tail_lines(path, limit):
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
        return out

    def render_page(self):
        # /update is unauthenticated: escape everything interpolated into
        # the page (stored-XSS guard) and coerce numerics defensively
        from html import escape
        rows = []
        for key, s in sorted(self.statuses().items()):
            try:
                runtime = float(s.get("runtime", 0))
            except (TypeError, ValueError):
                runtime = 0.0
            slaves = s.get("slaves", [])
            rows.append(
                "<tr><td>%s</td><td>%s</td><td>%d</td><td>%.0f</td>"
                "<td>%s</td><td>%s</td><td>%s</td><td>%s</td>"
                "<td>%s</td></tr>" % (
                    escape(str(s.get("name", key))),
                    escape(str(s.get("mode", "?"))),
                    len(slaves) if isinstance(slaves, (list, tuple))
                    else 0,
                    runtime,
                    escape(format_fleet_health(s.get("fleet"))),
                    escape(format_serving_health(s.get("serving"))),
                    escape(format_device_stats(s.get("device"))),
                    escape(format_trends_cell(s.get("trends"))),
                    time.strftime("%X",
                                  time.localtime(s.get("updated", 0)))))
        graphs = []
        for key, s in sorted(self.statuses().items()):
            if isinstance(s.get("graph"), dict):
                # mtime-style cache-buster: the 3s meta-refresh must
                # re-fetch the re-rendered live graph, like the plots
                graphs.append(
                    "<h3>%s</h3><img src='/graph/%s.svg?t=%d' "
                    "style='max-width:100%%;border:1px solid #ccc'/>"
                    % (escape(str(s.get("name", key))),
                       urllib.parse.quote(key),
                       int(s.get("updated", 0))))
        plots = []
        if self.plots_directory and os.path.isdir(self.plots_directory):
            for path in sorted(glob.glob(
                    os.path.join(self.plots_directory, "*.png"))):
                name = escape(os.path.basename(path), quote=True)
                # cache-buster (file mtime): the page meta-refreshes
                # every 3s and the browser must re-fetch a re-rendered
                # plot, not show its cached copy — this is the live
                # remote viewer (reference epgm multicast role,
                # graphics_server.py:100-133)
                try:
                    stamp = int(os.stat(path).st_mtime)
                except OSError:
                    stamp = 0
                plots.append('<img src="/plots/%s?t=%d" alt="%s"/>'
                             % (name, stamp, name))
        return _PAGE % {"rows": "".join(rows) or
                        "<tr><td colspan=9>none</td></tr>",
                        "graphs": "".join(graphs) or "<p>none</p>",
                        "plots": "".join(plots) or "<p>none</p>"}


class StatusNotifier:
    """Launcher-side status pusher (reference ``launcher.py:852-885``):
    POSTs the workflow/fleet snapshot to a WebStatusServer every
    ``notification_interval`` seconds."""

    def __init__(self, launcher, url=None, interval=None):
        self.launcher = launcher
        self.url = url or "http://%s:%d/update" % (
            root.common.web.get("host", "localhost"),
            root.common.web.get("port", 8090))
        self.interval = interval if interval is not None \
            else root.common.web.get("notification_interval", 1.0)
        self._stop = threading.Event()
        self._thread = None
        self._started_at = time.time()

    def snapshot(self):
        launcher = self.launcher
        status = {
            "id": "%s-%d" % (getattr(launcher.workflow, "name", "workflow"),
                             os.getpid()),
            "name": getattr(launcher.workflow, "name", "workflow"),
            "mode": launcher.mode,
            "runtime": time.time() - self._started_at,
            "slaves": [],
        }
        agent = getattr(launcher, "agent", None)
        if agent is not None and hasattr(agent, "fleet_status"):
            fleet = agent.fleet_status()
            status["slaves"] = fleet.get("slaves", [])
            # job-ledger + chaos observability (docs/fleet_robustness.md):
            # the dashboard's proof that requeue/fencing actually works
            status["fleet"] = {
                key: fleet.get(key)
                for key in ("epoch", "queued_jobs", "ledger", "chaos",
                            "plane", "sync", "reduce", "goodput",
                            "straggler")}
        # serving-survival observability (docs/serving_robustness.md):
        # a serving API mirrors its breaker state and trip/rebuild/
        # shed/expired counters onto the dashboard. Two attachment
        # points: a standalone GenerateAPI hung on the launcher as
        # `launcher.serving_api`, or a serving unit (RESTfulAPI) found
        # IN the workflow via its `health` attribute.
        serving_health = getattr(
            getattr(launcher, "serving_api", None), "health", None)
        if serving_health is None:
            try:
                units = list(launcher.workflow)
            except TypeError:
                units = []
            for unit in units:
                candidate = getattr(unit, "health", None)
                if candidate is not None \
                        and hasattr(candidate, "snapshot") \
                        and hasattr(candidate, "ready"):
                    serving_health = candidate
                    break
        if serving_health is not None \
                and hasattr(serving_health, "snapshot"):
            status["serving"] = serving_health.snapshot()
        # the trends column (observe/history.py): sparkline tails of
        # the key series — burn rate, latency, pool pressure — so the
        # dashboard shows where each master is HEADING, not just where
        # it is; empty until something mounted /metrics
        try:
            from veles_tpu_torch.observe.history import get_metric_history
            history = get_metric_history()
            if history is not None and history.samples_total:
                status["trends"] = history.dashboard_cells()
        except Exception:
            pass
        # device-truth column (observe/xla_stats.py): memory, compile
        # totals, storms, live MFU — only once the tracker is on (a
        # /metrics mount), so idle masters don't pay the device poll
        try:
            from veles_tpu_torch.observe.xla_stats import (
                device_summary, get_compile_tracker)
            if get_compile_tracker().enabled:
                status["device"] = device_summary()
        except Exception:
            pass
        # the live unit DAG (+ run counters) for the dashboard's graph
        # view — the reference's viz.js workflow page
        # (web_status.py:113-165), rendered server-side as SVG here
        if hasattr(launcher.workflow, "graph_snapshot"):
            try:
                status["graph"] = launcher.workflow.graph_snapshot()
            except Exception:
                pass
        return status

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="status-notifier", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=10.0):
        """Stop the pushes and wait for the thread (a push in flight
        times out within 5 s)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def notify_once(self):
        body = json.dumps(self.snapshot()).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status == 200

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.notify_once()
            except Exception:
                pass  # dashboard down is never fatal to training


def main():  # pragma: no cover - manual entry point
    from veles_tpu_torch.core.logger import setup_logging
    setup_logging()
    server = WebStatusServer(
        plots_directory=os.path.join(
            os.path.dirname(root.common.dirs.get("run", ".")), "plots"))
    server.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":  # pragma: no cover
    main()
