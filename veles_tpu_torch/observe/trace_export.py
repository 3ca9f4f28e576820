"""Chrome ``trace_event`` exporter for the JSONL span stream.

The port's copy of ``veles_tpu/observe/trace_export.py:26-400``.
``python -m veles_tpu_torch observe export-trace events.jsonl -o
trace.json`` converts the EventRecorder's span events (begin/end/single
with trace ids and monotonic stamps, ``observe/tracing.py``) into the
Chrome trace-event JSON that ``ui.perfetto.dev`` and
``chrome://tracing`` load. Spans become complete ("X") events with their
trace identity in ``args`` (:func:`span_tree` walks those parent links);
unpaired begins become "B" events, so a crashed run's half-open spans
stay visible; events without trace ids (``Logger.event`` marks) still
export, keyed by name and source. Every source pid gets a stable small
Chrome pid with ``process_name``/``thread_name`` metadata rows. For the
same events file the JSON equals the JAX exporter's key for key.

``observe blackbox`` reads flight-recorder dumps (``observe/flight.py``);
``observe fleet-trace`` assembles a fleet master's ``/debug/fleet``
payload into one clock-aligned Chrome trace (``observe/fleetscope.py``).
"""

import json


def load_events(path):
    """Read the JSONL event stream, skipping undecodable lines (a
    crashed writer can truncate the last one)."""
    events = []
    with open(path, "r") as fin:
        for line in fin:
            try:
                event = json.loads(line)
            except ValueError:
                continue
            if isinstance(event, dict):
                events.append(event)
    return events


def _stamp_us(event, t0):
    """Microsecond timestamp: prefer the monotonic field (immune to
    wall-clock steps), fall back to wall time for legacy events."""
    stamp = event.get("mono")
    if stamp is None:
        stamp = event.get("time", 0.0)
    return (float(stamp) - t0) * 1e6


def _args(event):
    out = {key: value for key, value in event.items()
           if key not in ("name", "etype", "mono", "tid", "pid")}
    return out


def chrome_trace(events, process_names=None):
    """Span events -> the ``{"traceEvents": [...]}`` dict.

    ``process_names`` optionally maps a source pid (whatever the
    events carry in their ``pid`` field — an OS pid, or a fleet
    process key like ``"mid:pid"``) to a display name for its
    ``process_name`` metadata row; unnamed processes render as
    ``pid <value>``."""
    stamps = [float(e["mono"]) for e in events if "mono" in e] or \
        [float(e.get("time", 0.0)) for e in events]
    t0 = min(stamps) if stamps else 0.0
    procs = {}    # source pid -> stable small Chrome pid
    threads = set()  # (chrome pid, tid) seen

    def _pid_of(event):
        key = event.get("pid", event.get("session", 0))
        try:
            hash(key)
        except TypeError:
            key = str(key)
        index = procs.get(key)
        if index is None:
            index = procs[key] = len(procs) + 1
        return index

    open_spans = {}
    trace_events = []
    for event in events:
        etype = event.get("etype")
        if etype not in ("begin", "end", "single"):
            continue
        key = event.get("span_id") or (
            "%s/%s" % (event.get("name"), event.get("source")))
        tid = event.get("tid", 0)
        if isinstance(tid, bool) or not isinstance(tid, int):
            tid = 0
        pid = _pid_of(event)
        threads.add((pid, tid))
        base = {
            "name": str(event.get("name", "?")),
            "cat": str(event.get("trace_id") or "events"),
            "pid": pid,
            "tid": tid,
            "args": _args(event),
        }
        if etype == "single":
            trace_events.append(dict(base, ph="i", s="t",
                                     ts=_stamp_us(event, t0)))
        elif etype == "begin":
            open_spans[key] = (event, base)
        else:  # end
            begun = open_spans.pop(key, None)
            if begun is None:
                # end without begin (rotated file): emit instant
                trace_events.append(dict(base, ph="i", s="t",
                                         ts=_stamp_us(event, t0)))
                continue
            begin_event, begin_base = begun
            ts = _stamp_us(begin_event, t0)
            dur = max(0.0, _stamp_us(event, t0) - ts)
            merged_args = dict(begin_base["args"])
            merged_args.update(base["args"])
            trace_events.append(dict(begin_base, ph="X", ts=ts,
                                     dur=dur, args=merged_args))
    # half-open spans (crash mid-span): visible as B events
    for event, base in open_spans.values():
        trace_events.append(dict(base, ph="B",
                                 ts=_stamp_us(event, t0)))
    trace_events.sort(key=lambda e: e["ts"])
    # process/thread metadata rows: stable per-process pids so a
    # merged multi-process trace renders one row per process
    metadata = []
    for key, index in procs.items():
        label = (process_names or {}).get(key)
        if label is None:
            label = "pid %s" % (key,)
        metadata.append({"name": "process_name", "ph": "M",
                         "pid": index, "tid": 0, "ts": 0,
                         "args": {"name": str(label)}})
    for pid, tid in sorted(threads, key=str):
        metadata.append({"name": "thread_name", "ph": "M",
                         "pid": pid, "tid": tid, "ts": 0,
                         "args": {"name": "tid %s" % (tid,)}})
    return {"traceEvents": metadata + trace_events,
            "displayTimeUnit": "ms"}


def export_chrome_trace(events_path, out_path):
    """JSONL span file -> Chrome trace JSON file; returns the event
    count written."""
    trace = chrome_trace(load_events(events_path))
    with open(out_path, "w") as fout:
        json.dump(trace, fout)
    return len(trace["traceEvents"])


def span_tree(trace):
    """Walk a Chrome trace dict into ``{trace_id: {span_id: parent_id}}``
    — the verification view the tests (and quick scripts) use to assert
    one request yields ONE connected tree."""
    trees = {}
    for event in trace.get("traceEvents", []):
        args = event.get("args", {})
        trace_id = args.get("trace_id")
        span_id = args.get("span_id")
        if not trace_id or not span_id:
            continue
        trees.setdefault(trace_id, {})[span_id] = args.get("parent_id")
    return trees


def main(argv=None):
    """``python -m veles_tpu_torch observe``: ``export-trace`` (Chrome
    trace), ``blackbox`` (flight-recorder dumps), ``slo`` (the request
    waterfalls' autopsy), ``serve-trace`` (the per-slot Perfetto trace),
    ``incident`` (a metric-history incident's timeline), ``record`` and
    ``replay`` (traffic traces, ``observe/replay.py``), ``capacity``
    (``observe/capacity.py``), ``regress`` (``observe/regress.py``) and
    ``fleet-trace`` (``observe/fleetscope.py``). Returns the exit
    code."""
    import argparse
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch observe",
        description="observability tooling: trace export, black boxes, "
                    "request autopsies, serving traces, incidents, "
                    "traffic record and replay, capacity and regress")
    sub = parser.add_subparsers(dest="command", required=True)
    export = sub.add_parser(
        "export-trace",
        help="convert a span JSONL file to Chrome trace JSON "
             "(load in ui.perfetto.dev)")
    export.add_argument("events", help="events JSONL path (see "
                                       "--trace-events)")
    fleet = sub.add_parser(
        "fleet-trace",
        help="assemble the merged master+slave fleet timeline into a "
             "Perfetto-loadable Chrome trace (observe/fleetscope.py): "
             "a saved GET /debug/fleet payload, or --live URL of the "
             "fleet metrics sidecar")
    fleet.add_argument("artifact", nargs="?", default=None,
                       help="saved /debug/fleet JSON (or an artifact "
                            "embedding one under 'fleetscope')")
    fleet.add_argument("--live", default=None, metavar="URL",
                       help="fetch <URL>/debug/fleet instead of a "
                            "file")
    fleet.add_argument("-o", "--output", default=None,
                       help="trace output path (default: "
                            "<artifact>.trace.json / fleet.trace.json)")
    export.add_argument("-o", "--output", default=None,
                        help="output path (default: <events>.trace.json)")
    blackbox = sub.add_parser(
        "blackbox",
        help="inspect flight-recorder black-box dumps: a dump file, or "
             "a directory to list (default: the run dir)")
    blackbox.add_argument("path", nargs="?", default=None,
                          help="dump file or directory")
    blackbox.add_argument("--tail", type=int, default=20,
                          help="ring entries to show from the newest "
                               "dump (default 20)")
    serve = sub.add_parser(
        "serve-trace",
        help="assemble the per-slot occupancy timeline and the request "
             "waterfalls into a Perfetto-loadable Chrome trace: a saved "
             "GET /debug/serve payload, or --live URL")
    serve.add_argument("artifact", nargs="?", default=None,
                       help="saved /debug/serve JSON (or an artifact "
                            "embedding one under 'servescope')")
    serve.add_argument("--live", default=None, metavar="URL",
                       help="fetch <URL>/debug/serve instead of a file")
    serve.add_argument("-o", "--output", default=None,
                       help="trace output path (default: "
                            "<artifact>.trace.json / serve.trace.json)")
    slo = sub.add_parser(
        "slo",
        help="waterfall autopsy of the slowest requests from a black box "
             "or a saved /debug/requests JSON, or --live URL")
    slo.add_argument("artifact", nargs="?", default=None,
                     help="black-box dump or /debug/requests JSON")
    slo.add_argument("--live", default=None, metavar="URL",
                     help="fetch <URL>/debug/requests (and the SLO "
                          "gauges of <URL>/metrics) instead of a file")
    slo.add_argument("--slowest", type=int, default=8,
                     help="resolved requests to autopsy (default 8)")
    incident = sub.add_parser(
        "incident",
        help="render a metric-history incident's timeline and its "
             "leading indicator, or a live server's (--live URL)")
    incident.add_argument("artifact", nargs="?", default=None,
                          help="incident JSON, or a directory to list "
                               "(default: the run dir)")
    incident.add_argument("--live", default=None, metavar="URL",
                          help="fetch <URL>/debug/history instead of a "
                               "saved artifact")
    incident.add_argument("--slowest", type=int, default=4,
                          help="request waterfalls to include "
                               "(default 4)")
    record = sub.add_parser(
        "record",
        help="export a replayable anonymized traffic trace from the "
             "request-truth ledger (observe/replay.py): a saved "
             "/debug/requests JSON, "
             "or --live URL of a serving surface")
    record.add_argument("artifact", nargs="?", default=None,
                        help="saved /debug/requests JSON")
    record.add_argument("--live", default=None, metavar="URL",
                        help="fetch <URL>/debug/requests instead of "
                             "a file")
    record.add_argument("-o", "--output", default=None,
                        help="trace output path (default: "
                             "veles.trace.jsonl)")
    record.add_argument("--salt", default="veles",
                        help="tenant-hash salt (pass a secret to make "
                             "tenant ids unrecoverable; default "
                             "'veles')")
    replay_p = sub.add_parser(
        "replay",
        help="replay a recorded trace open-loop against a live "
             "endpoint at a fixed warp (observe/replay.py)")
    replay_p.add_argument("trace", help="trace JSONL path")
    replay_p.add_argument("--live", required=True, metavar="URL",
                          help="serving surface to replay against")
    replay_p.add_argument("--warp", type=float, default=1.0,
                          help="arrival-rate warp factor (default 1)")
    replay_p.add_argument("--seed", type=int, default=0,
                          help="warp-plan seed (default 0)")
    replay_p.add_argument("--vocab", type=int, default=8,
                          help="synthesized prompt token-id bound "
                               "(default 8)")
    replay_p.add_argument("--workers", type=int, default=16,
                          help="client concurrency cap (default 16)")
    replay_p.add_argument("--burst-compress", type=float, default=0.0,
                          help="squeeze above-median arrival gaps by "
                               "this fraction (default 0)")
    replay_p.add_argument("--long-context-skew", type=float,
                          default=0.0,
                          help="probability a prompt is stretched to "
                               "the trace max (default 0)")
    capacity = sub.add_parser(
        "capacity",
        help="the capacity-cliff finder (observe/capacity.py): replay "
             "a trace at escalating warps until an SLO objective "
             "breaches, emit a capacity report naming the "
             "first-breaching series + dominant waste cause")
    capacity.add_argument("trace", help="trace JSONL path")
    capacity.add_argument("--live", required=True, metavar="URL",
                          help="serving surface to escalate against")
    capacity.add_argument("-o", "--output", default=None,
                          help="report path (default: "
                               "<trace>.capacity.json)")
    capacity.add_argument("--start-warp", type=float, default=1.0)
    capacity.add_argument("--warp-step", type=float, default=1.5)
    capacity.add_argument("--max-warp", type=float, default=16.0)
    capacity.add_argument("--refine-steps", type=int, default=2,
                          help="geometric bisection probes after the "
                               "first breach (default 2)")
    capacity.add_argument("--seed", type=int, default=0)
    capacity.add_argument("--availability", type=float, default=0.99,
                          help="client-side availability floor "
                               "(default 0.99)")
    capacity.add_argument("--p95-ms", type=float, default=None,
                          help="client-side request p95 wall bound")
    capacity.add_argument("--vocab", type=int, default=8)
    capacity.add_argument("--workers", type=int, default=16)
    regress = sub.add_parser(
        "regress",
        help="compare two BENCH artifacts with spread-aware per-key "
             "tolerances; exit 1 on regression (observe/regress.py)")
    regress.add_argument("old", help="previous-round BENCH json")
    regress.add_argument("new", help="candidate BENCH json")
    regress.add_argument("--tolerance", type=float, default=0.1,
                         help="base relative tolerance before the "
                              "per-key spread allowance (default 0.1)")
    regress.add_argument("--json", action="store_true",
                         help="machine-readable findings")
    args = parser.parse_args(argv)
    if args.command == "fleet-trace":
        if not args.artifact and not args.live:
            parser.error("observe fleet-trace needs an ARTIFACT or "
                         "--live URL")
        from veles_tpu_torch.observe.fleetscope import fleet_trace_main
        return fleet_trace_main(args.artifact, live=args.live,
                                output=args.output)
    if args.command == "blackbox":
        from veles_tpu_torch.observe.flight import blackbox_main
        return blackbox_main(args.path, tail=args.tail)
    if args.command == "serve-trace":
        if not args.artifact and not args.live:
            parser.error("observe serve-trace needs an ARTIFACT or "
                         "--live URL")
        from veles_tpu_torch.observe.servescope import serve_trace_main
        return serve_trace_main(args.artifact, live=args.live,
                                output=args.output)
    if args.command == "slo":
        if not args.artifact and not args.live:
            parser.error("observe slo needs an ARTIFACT or --live URL")
        from veles_tpu_torch.observe.slo import slo_main
        return slo_main(args.artifact, live=args.live,
                        slowest=args.slowest)
    if args.command == "incident":
        from veles_tpu_torch.observe.history import incident_main
        return incident_main(args.artifact, live=args.live,
                             slowest=args.slowest)
    if args.command == "record":
        if not args.artifact and not args.live:
            parser.error("observe record needs an ARTIFACT or "
                         "--live URL")
        from veles_tpu_torch.observe.replay import record_main
        return record_main(args.artifact, live=args.live,
                           output=args.output, salt=args.salt)
    if args.command == "replay":
        from veles_tpu_torch.observe.replay import replay_main
        return replay_main(args.trace, live=args.live, warp=args.warp,
                           seed=args.seed, vocab=args.vocab,
                           workers=args.workers,
                           burst_compress=args.burst_compress,
                           long_context_skew=args.long_context_skew)
    if args.command == "capacity":
        from veles_tpu_torch.observe.capacity import capacity_main
        return capacity_main(args.trace, live=args.live,
                             output=args.output,
                             start_warp=args.start_warp,
                             warp_step=args.warp_step,
                             max_warp=args.max_warp,
                             refine_steps=args.refine_steps,
                             seed=args.seed,
                             availability=args.availability,
                             p95_ms=args.p95_ms, vocab=args.vocab,
                             workers=args.workers)
    if args.command == "regress":
        from veles_tpu_torch.observe.regress import compare_main
        return compare_main(args.old, args.new,
                            tolerance=args.tolerance,
                            as_json=args.json)
    out = args.output or args.events + ".trace.json"
    count = export_chrome_trace(args.events, out)
    print("wrote %d trace events to %s (open in ui.perfetto.dev)"
          % (count, out))
    return 0
