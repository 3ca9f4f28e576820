"""The capacity search.

The port of ``veles_tpu/observe/capacity.py``. ``python -m
veles_tpu_torch observe capacity TRACE --live URL`` asks how much the
front sustains at the recorded traffic mix before an objective breaches.
It replays the trace open-loop (``observe/replay.py``) at geometrically
rising warps until a breach: the server's SLO burn
(``veles_slo_burn_rate`` read off ``/metrics``), the client's
availability or a client-side p95 bound; then it bisects geometrically
between the last sustained and the first breaching warp.

On a breach the report names the first-breaching series (from the
metric history's live document, ``observe/history.py``) and the serve
scope's dominant waste cause (``/debug/serve``). The report's ``keys``
carry the directions the regression gate reads
(``capacity_sustained_tokens_per_sec`` and ``capacity_cliff_warp_x``
higher-better, ``replay_schedule_skew_ms`` lower-better,
``observe/regress.py``).
"""

import json
import math
import os
import re
import time

from veles_tpu_torch.observe.replay import (load_trace, plan_fingerprint,
                                      replay, tenant_mix, warp_plan)

#: capacity report format version
CAPACITY_SCHEMA = 1

#: one scrape line of an SLO burn gauge: veles_slo_burn_rate{...} 1.23
_BURN_RE = re.compile(
    r'^veles_slo_burn_rate(\{[^}]*\})?\s+([0-9.eE+-]+)\s*$')


def server_burn(url, timeout=5.0):
    """Max ``veles_slo_burn_rate`` off a live /metrics scrape as
    (value, labels) — None when the surface has no SLO engine (or no
    scrape); burn > 1.0 means an objective is burning error budget
    faster than its window allows."""
    import urllib.request

    try:
        with urllib.request.urlopen("%s/metrics" % url.rstrip("/"),
                                    timeout=timeout) as resp:
            text = resp.read().decode()
    except Exception:
        return None
    worst = None
    for line in text.splitlines():
        match = _BURN_RE.match(line.strip())
        if not match:
            continue
        value = float(match.group(2))
        if worst is None or value > worst[0]:
            worst = (value, match.group(1) or "")
    return worst


class CapacityFinder:
    """Rate-escalation controller: escalate warp geometrically until
    breach, then back off and bisect the cliff (see module docstring).
    ``runner``/``breach`` injection makes the loop scriptable — the
    tests drive it against a scripted endpoint with zero sockets."""

    def __init__(self, rows, url=None, start_warp=1.0, warp_step=1.5,
                 max_warp=64.0, refine_steps=2, seed=0,
                 availability=0.99, p95_ms=None, burn_threshold=1.0,
                 runner=None, breach=None, replay_kw=None,
                 warp_kw=None):
        self.rows = rows
        self.url = url.rstrip("/") if url else None
        self.start_warp = float(start_warp)
        self.warp_step = max(1.01, float(warp_step))
        self.max_warp = float(max_warp)
        self.refine_steps = int(refine_steps)
        self.seed = int(seed)
        self.availability = float(availability)
        self.p95_ms = p95_ms
        self.burn_threshold = float(burn_threshold)
        self._runner = runner or self._replay_runner
        self._breach = breach or self._default_breach
        self.replay_kw = dict(replay_kw or {})
        self.warp_kw = dict(warp_kw or {})
        self.escalation = []

    # -- the default (live-endpoint) runner + breach predicate ----------
    def _replay_runner(self, warp):
        plan = warp_plan(self.rows, warp=warp, seed=self.seed,
                         **self.warp_kw)
        summary = replay(plan, url=self.url, seed=self.seed,
                         **self.replay_kw)
        summary["plan_fingerprint"] = plan_fingerprint(plan)
        return summary

    def _default_breach(self, summary):
        """(breached, detail): server burn first — it sees ttft/tpot
        truth the client cannot — then client-side availability and
        the optional wall bound."""
        if self.url is not None:
            burn = server_burn(self.url)
            if burn is not None and burn[0] > self.burn_threshold:
                return True, {"objective": "slo_burn",
                              "series": "veles_slo_burn_rate",
                              "labels": burn[1],
                              "value": round(burn[0], 4)}
        if summary.get("requests") \
                and summary.get("availability", 1.0) \
                < self.availability:
            return True, {"objective": "availability",
                          "series": "replay_availability",
                          "value": round(summary["availability"], 4)}
        if self.p95_ms is not None \
                and summary.get("request_wall_ms_p95", 0.0) \
                > float(self.p95_ms):
            return True, {"objective": "request_p95_ms",
                          "series": "replay_request_wall_ms_p95",
                          "value": summary["request_wall_ms_p95"]}
        return False, None

    # -- the escalate-then-bisect loop ----------------------------------
    def _probe(self, warp, phase):
        summary = self._runner(warp)
        breached, detail = self._breach(summary)
        self.escalation.append({
            "warp": round(warp, 4), "phase": phase,
            "breached": bool(breached), "detail": detail,
            "tokens_per_sec": summary.get("tokens_per_sec", 0.0),
            "summary": summary})
        return breached, detail, summary

    def run(self):
        """Escalate until breach (or max_warp), refine by geometric
        bisection, and return the capacity report doc."""
        sustained = None       # (warp, summary) last non-breaching
        breach_at = None       # (warp, detail, summary) first breach
        warp = self.start_warp
        while warp <= self.max_warp + 1e-9:
            breached, detail, summary = self._probe(warp, "escalate")
            if breached:
                breach_at = (warp, detail, summary)
                break
            sustained = (warp, summary)
            warp *= self.warp_step
        if breach_at is not None and sustained is not None:
            # backoff: geometric bisection between the last sustained
            # and the first breaching warp tightens the cliff estimate
            lo, hi = sustained[0], breach_at[0]
            for _ in range(self.refine_steps):
                mid = math.sqrt(lo * hi)
                if hi / lo < 1.05:
                    break
                breached, detail, summary = self._probe(mid, "refine")
                if breached:
                    hi, breach_at = mid, (mid, detail, summary)
                else:
                    lo, sustained = mid, (mid, summary)
        return self.report(sustained, breach_at)

    # -- the breach-window autopsy handoff ------------------------------
    def _incident(self):
        """The metric history's incident machinery names the
        first-breaching series from the live /debug/history; best-effort
        — a surface without history still gets a capacity number."""
        if self.url is None:
            return None
        try:
            from veles_tpu_torch.observe.history import _live_doc
            return _live_doc(self.url)
        except Exception:
            return None

    def _dominant_waste(self):
        """The servescope's dominant waste cause off /debug/serve."""
        if self.url is None:
            return None
        try:
            import urllib.request
            with urllib.request.urlopen(
                    "%s/debug/serve" % self.url, timeout=5) as resp:
                payload = json.loads(resp.read().decode())
            return payload.get("dominant_cause")
        except Exception:
            return None

    def report(self, sustained, breach_at):
        """Assemble the capacity report doc (keys + autopsy)."""
        incident = self._incident() if breach_at else None
        leading = (incident or {}).get("leading_indicator") or {}
        detail = breach_at[1] if breach_at else None
        first_series = leading.get("series") \
            or (detail or {}).get("series")
        doc = {
            "kind": "veles-capacity-report",
            "schema": CAPACITY_SCHEMA,
            "created": time.time(),
            "endpoint": self.url,
            "seed": self.seed,
            "mix": {"tenants": tenant_mix(self.rows),
                    "requests": len(self.rows)},
            "keys": {
                "capacity_sustained_tokens_per_sec":
                    (sustained[1].get("tokens_per_sec", 0.0)
                     if sustained else 0.0),
                "capacity_sustained_warp_x":
                    (round(sustained[0], 4) if sustained else 0.0),
                "capacity_cliff_warp_x":
                    (round(breach_at[0], 4) if breach_at
                     else round(self.max_warp, 4)),
                "replay_schedule_skew_ms":
                    (sustained[1].get("schedule_skew_ms_p95", 0.0)
                     if sustained else 0.0),
            },
            "breached": breach_at is not None,
            "breach": {
                "warp_x": round(breach_at[0], 4),
                "detail": detail,
                "first_breaching_series": first_series,
                "first_breaching_rule": leading.get("rule"),
                "dominant_waste_cause": self._dominant_waste(),
            } if breach_at else None,
            "incident": incident,
            "escalation": [
                {k: v for k, v in entry.items() if k != "summary"}
                for entry in self.escalation],
        }
        return doc


def render_capacity_report(doc):
    """The human sentence a capacity report exists to produce."""
    keys = doc.get("keys") or {}
    mix = doc.get("mix") or {}
    lines = []
    if doc.get("breached"):
        breach = doc.get("breach") or {}
        detail = breach.get("detail") or {}
        lines.append(
            "this config sustains %.1f tokens/sec at this mix "
            "(x%.2f warp) before %s breaches (cliff at x%.2f)"
            % (keys.get("capacity_sustained_tokens_per_sec", 0.0),
               keys.get("capacity_sustained_warp_x", 0.0),
               detail.get("objective") or "an SLO objective",
               keys.get("capacity_cliff_warp_x", 0.0)))
        if breach.get("first_breaching_series"):
            lines.append("  first-breaching series: %s%s"
                         % (breach["first_breaching_series"],
                            " (rule %s)" % breach["first_breaching_rule"]
                            if breach.get("first_breaching_rule")
                            else ""))
        if breach.get("dominant_waste_cause"):
            lines.append("  dominant waste cause: %s"
                         % breach["dominant_waste_cause"])
    else:
        lines.append(
            "no breach up to x%.2f warp: sustained %.1f tokens/sec "
            "at this mix (raise --max-warp to find the cliff)"
            % (keys.get("capacity_cliff_warp_x", 0.0),
               keys.get("capacity_sustained_tokens_per_sec", 0.0)))
    tenants = (mix.get("tenants") or {})
    if tenants:
        lines.append("  mix: %d requests, tenants %s"
                     % (mix.get("requests", 0),
                        ", ".join("%s=%.0f%%" % (t or "(anon)",
                                                 share * 100.0)
                                  for t, share in tenants.items())))
    lines.append("  escalation: %s"
                 % " -> ".join(
                     "x%.2f%s" % (e["warp"],
                                  " BREACH" if e["breached"] else "")
                     for e in doc.get("escalation") or ()))
    return "\n".join(lines)


def write_capacity_report(doc, path):
    """Atomic write + sha256 sidecar (the bench-artifact
    discipline)."""
    import hashlib

    from veles_tpu_torch.observe.regress import _atomic_write

    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    text = json.dumps(doc, indent=1, sort_keys=True, default=str)
    _atomic_write(path, text)
    digest = hashlib.sha256(text.encode()).hexdigest()
    _atomic_write(path + ".sha256",
                  "%s  %s\n" % (digest, os.path.basename(path)))
    return path


def capacity_main(trace, live, output=None, start_warp=1.0,
                  warp_step=1.5, max_warp=16.0, refine_steps=2,
                  seed=0, availability=0.99, p95_ms=None, vocab=8,
                  workers=16, prompt_cap=None, budget_cap=None):
    """``observe capacity TRACE --live URL``: the full
    escalate-until-breach run + report artifact. Returns 0 on a
    completed run (breach found or max warp sustained), 1 on a broken
    trace/endpoint."""
    try:
        header, rows = load_trace(trace)
    except (OSError, ValueError) as exc:
        print("cannot load trace %s: %s" % (trace, exc))
        return 1
    if not rows:
        print("trace %s has no requests" % trace)
        return 1
    if header.get("lossy"):
        print("note: trace is lossy (%s)"
              % json.dumps(header.get("loss") or {}))
    replay_kw = {"vocab": vocab, "workers": workers}
    if prompt_cap:
        replay_kw["prompt_cap"] = prompt_cap
    if budget_cap:
        replay_kw["budget_cap"] = budget_cap
    finder = CapacityFinder(rows, url=live, start_warp=start_warp,
                            warp_step=warp_step, max_warp=max_warp,
                            refine_steps=refine_steps, seed=seed,
                            availability=availability, p95_ms=p95_ms,
                            replay_kw=replay_kw)
    doc = finder.run()
    doc["trace"] = str(trace)
    output = output or (str(trace) + ".capacity.json")
    write_capacity_report(doc, output)
    print(render_capacity_report(doc))
    print("capacity report -> %s" % output)
    return 0
