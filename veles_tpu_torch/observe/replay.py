"""Traffic record and replay.

The port of ``veles_tpu/observe/replay.py``. The record half exports a
replayable, anonymised trace from the request ledger
(``observe/reqledger.py``): arrival cadence, prompt bucket and length,
admission kind, salted tenant hash, token budget, chunk cadence and
deadline, one JSONL row per resolved request behind a versioned header
line, with a sha256 sidecar. Prompt text is never in the ledger, so it is
never in a trace; tenant ids are salted sha256 prefixes. A bounded ledger
under-records (chunk cap, resolved-ring overflow, dropped in-flight
rows): the header's ``lossy`` field carries the exact tallies.

The replay half is an open-loop load generator: arrivals follow the
recorded cadence through a deterministic seeded warp plan (rate warp,
tenant-mix reweighting, long-context skew, burst compression), not the
responses, so a slowing server keeps receiving arrivals on schedule. The
same trace, seed and knobs give the same plan, bit for bit.

The capacity search on top lives in ``observe/capacity.py``; the CLI
(``python -m veles_tpu_torch observe record | replay | capacity``) in
``observe/trace_export.py``.
"""

import hashlib
import json
import os
import queue
import random
import threading
import time

#: trace file format version (the header's ``schema`` field); bump on
#: any row-shape change so a replayer can refuse what it cannot honor
TRACE_SCHEMA = 1

#: the anonymization contract, enforced at write time: a trace row may
#: carry these keys and NOTHING else. No trace ids, no error strings,
#: no raw tenant names, and prompt text never existed upstream.
TRACE_ROW_FIELDS = frozenset((
    "t", "tenant", "prompt_len", "bucket", "budget", "deadline_s",
    "admit", "outcome", "tokens", "wall_ms", "ttft_ms", "chunks"))

#: per-row chunk-cadence stamps kept in a trace (the ledger already
#: caps at its own chunk_cap; this is the export-side bound)
TRACE_CHUNK_CAP = 128


def hash_tenant(tenant, salt):
    """Salted sha256 prefix of a tenant id — stable within one salt
    (mix reweighting and share analysis keep working), unlinkable to
    the raw id without it. Empty stays empty so anonymous traffic is
    not conflated with a hashed tenant."""
    if not tenant:
        return ""
    return hashlib.sha256(
        ("%s|%s" % (salt, tenant)).encode()).hexdigest()[:16]


def _salt_fingerprint(salt):
    """A short public fingerprint of the salt (never the salt): two
    traces recorded with the same salt are correlatable by tenant hash,
    and this says whether they were — without enabling a dictionary
    attack on the tenant ids."""
    return hashlib.sha256(("fp|%s" % salt).encode()).hexdigest()[:8]


def _row_ttft_ms(row):
    stages = dict((s[0], s[1]) for s in row.get("stages") or ())
    if "first_token" in stages and "staged" in stages:
        return round((stages["first_token"] - stages["staged"])
                     * 1000.0, 3)
    return None


def build_trace(rows, salt="veles", source=""):
    """Anonymize ledger-shaped ``rows`` (resolved only) into
    (header, trace_rows). Arrival offsets come from the rows' shared
    monotonic ``staged`` stamps, rebased to the first arrival; loss
    tallies must be merged into the header by the caller via
    ``loss=``-style dict (record_trace does)."""
    resolved = [r for r in rows
                if r.get("outcome") is not None
                and r.get("staged") is not None]
    resolved.sort(key=lambda r: r["staged"])
    t0 = resolved[0]["staged"] if resolved else 0.0
    out = []
    for row in resolved:
        admit = row.get("admit") or {}
        chunks = []
        staged = row["staged"]
        for chunk in (row.get("chunks") or ())[:TRACE_CHUNK_CAP]:
            chunks.append([round((chunk[0] - staged) * 1000.0, 3),
                           int(chunk[1])])
        entry = {
            "t": round(row["staged"] - t0, 6),
            "tenant": hash_tenant(row.get("tenant") or "", salt),
            "prompt_len": int(row.get("prompt_len") or 0),
            "bucket": int(row.get("bucket") or 0),
            "budget": int(row.get("budget") or 0),
            "deadline_s": float(row.get("deadline_s") or 0.0),
            "admit": admit.get("kind"),
            "outcome": row.get("outcome"),
            "tokens": int(row.get("tokens") or 0),
            "wall_ms": float(row.get("wall_ms") or 0.0),
            "ttft_ms": _row_ttft_ms(row),
            "chunks": chunks,
        }
        unexpected = set(entry) - TRACE_ROW_FIELDS
        assert not unexpected, unexpected  # the contract, at the seam
        out.append(entry)
    span = out[-1]["t"] if out else 0.0
    header = {
        "kind": "veles-trace",
        "schema": TRACE_SCHEMA,
        "created": time.time(),
        "source": source,
        "salt_fingerprint": _salt_fingerprint(salt),
        "count": len(out),
        "span_s": round(span, 6),
        "lossy": False,
        "loss": {"inflight_dropped": 0, "chunk_stamps_dropped": 0,
                 "resolved_ring_overflow": 0},
    }
    return header, out


def _merge_loss(header, loss):
    """Fold ledger loss tallies into the header and stamp ``lossy``."""
    merged = dict(header.get("loss") or {})
    for key, value in (loss or {}).items():
        merged[key] = merged.get(key, 0) + int(value)
    header["loss"] = merged
    header["lossy"] = any(v for v in merged.values())
    return header


def record_trace(ledger, path, salt="veles", source=""):
    """Export ``ledger``'s resolved rows as a trace file at ``path``
    (JSONL + sha256 sidecar); returns the header. The ledger's loss
    tallies (chunk-cap drops, ring overflow, in-flight drops) stamp
    the header — a lossy trace says so, and says by how much."""
    header, rows = build_trace(ledger.resolved(), salt=salt,
                               source=source or "ledger")
    _merge_loss(header, ledger.loss_tallies())
    write_trace(header, rows, path)
    return header


def record_from_snapshot(payload, path, salt="veles", source=""):
    """Export a trace from a saved/fetched ``/debug/requests`` payload
    (the ``observe record --live URL`` path). The snapshot carries at
    most the N slowest resolved rows, so when the server resolved more
    than we captured the loss dict says ``capture_truncated`` — a
    remote recording is honest about being a sample."""
    rows = list(payload.get("slowest") or [])
    header, trace_rows = build_trace(rows, salt=salt,
                                     source=source or "snapshot")
    loss = {"inflight_dropped": int(payload.get("dropped_total") or 0),
            "chunk_stamps_dropped":
                int(payload.get("chunk_stamps_dropped_total") or 0),
            "resolved_ring_overflow":
                int(payload.get("ring_overflow_total") or 0)}
    resolved_total = int(payload.get("resolved_total") or 0)
    if resolved_total > header["count"]:
        loss["capture_truncated"] = resolved_total - header["count"]
    _merge_loss(header, loss)
    write_trace(header, trace_rows, path)
    return header


def write_trace(header, rows, path):
    """Atomic JSONL write (header line first) + the two-file sha256
    sidecar, the bench-artifact discipline (observe/regress.py): hash
    the bytes just written, never a re-read."""
    from veles_tpu_torch.observe.regress import _atomic_write

    lines = [json.dumps(header, sort_keys=True)]
    lines.extend(json.dumps(row, sort_keys=True) for row in rows)
    text = "\n".join(lines) + "\n"
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    _atomic_write(path, text)
    digest = hashlib.sha256(text.encode()).hexdigest()
    _atomic_write(path + ".sha256",
                  "%s  %s\n" % (digest, os.path.basename(path)))
    return path


def load_trace(path, verify=True):
    """Load (header, rows) from a trace file. With ``verify`` (the
    default) an existing sidecar must match — a torn or edited trace
    is refused, not replayed; a missing sidecar is tolerated (hand-cut
    traces are legitimate fixtures)."""
    with open(path, "rb") as fin:
        raw = fin.read()
    if verify and os.path.exists(path + ".sha256"):
        with open(path + ".sha256") as fin:
            recorded = fin.read().split()[0]
        actual = hashlib.sha256(raw).hexdigest()
        if recorded != actual:
            raise ValueError(
                "trace %s does not match its sha256 sidecar "
                "(%s != %s)" % (path, actual[:12], recorded[:12]))
    lines = [ln for ln in raw.decode().splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty trace file %s" % path)
    header = json.loads(lines[0])
    if header.get("kind") != "veles-trace":
        raise ValueError("%s is not a veles-trace file" % path)
    if int(header.get("schema") or 0) > TRACE_SCHEMA:
        raise ValueError(
            "trace schema %s is newer than this replayer (%d)"
            % (header.get("schema"), TRACE_SCHEMA))
    rows = [json.loads(ln) for ln in lines[1:]]
    return header, rows


# -- the deterministic warp planner -----------------------------------------

def warp_plan(rows, warp=1.0, seed=0, tenant_weights=None,
              long_context_skew=0.0, long_context_len=None,
              burst_compress=0.0):
    """Turn trace rows into an arrival plan under seeded time-warps.
    Every knob is deterministic in (rows, seed, knobs) — the plan is
    the experiment definition, and two runs of the same experiment get
    bit-identical plans (pinned in tests/test_replay.py).

    - ``warp``: arrival cadence compressed xN (t / warp) — the
      rate-escalation axis the capacity finder drives.
    - ``tenant_weights``: {tenant_hash: relative weight}; 0 drops a
      tenant, 2.0 doubles it (integer part duplicates, the fractional
      remainder is one seeded coin flip per row). Unlisted tenants keep
      weight 1.0.
    - ``long_context_skew``: probability a row's prompt_len is
      stretched to ``long_context_len`` (default: the trace's max) —
      "what if the mix shifts long-context" without a new recording.
    - ``burst_compress``: inter-arrival gaps ABOVE the median shrink
      by this fraction — quiet valleys close up, bursts pile into each
      other, total load rises only modestly. 0 disables.
    """
    rng = random.Random(int(seed) ^ 0x5EED)
    weights = dict(tenant_weights or {})
    # 1) tenant-mix reweighting (order-preserving resampling)
    kept = []
    for row in sorted(rows, key=lambda r: (r.get("t", 0.0))):
        weight = float(weights.get(row.get("tenant") or "", 1.0))
        copies = int(weight)
        if rng.random() < weight - copies:
            copies += 1
        kept.extend([row] * copies)
    # 2) burst compression on the reweighted arrival gaps
    ts = [float(r.get("t") or 0.0) for r in kept]
    if burst_compress > 0.0 and len(ts) > 2:
        gaps = [b - a for a, b in zip(ts, ts[1:])]
        median = sorted(gaps)[len(gaps) // 2]
        squeezed = [g * (1.0 - burst_compress) if g > median else g
                    for g in gaps]
        acc = [ts[0]]
        for gap in squeezed:
            acc.append(acc[-1] + gap)
        ts = acc
    # 3) rate warp + 4) long-context skew, one plan entry per arrival
    factor = max(1e-9, float(warp))
    max_len = max([int(r.get("prompt_len") or 1) for r in kept] or [1])
    stretch = int(long_context_len or max_len)
    plan = []
    for index, (row, t) in enumerate(zip(kept, ts)):
        prompt_len = max(1, int(row.get("prompt_len") or 1))
        if long_context_skew > 0.0 \
                and rng.random() < long_context_skew:
            prompt_len = max(prompt_len, stretch)
        plan.append({
            "index": index,
            "at": round(t / factor, 6),
            "tenant": row.get("tenant") or "",
            "prompt_len": prompt_len,
            "budget": max(1, int(row.get("budget") or 1)),
            "deadline_s": float(row.get("deadline_s") or 0.0),
            "tokens_recorded": int(row.get("tokens") or 0),
        })
    plan.sort(key=lambda e: (e["at"], e["index"]))
    return plan


def plan_fingerprint(plan):
    """sha256 of the canonical plan JSON — what the determinism pin
    compares (same trace + seed + knobs => same fingerprint)."""
    return hashlib.sha256(
        json.dumps(plan, sort_keys=True).encode()).hexdigest()


# -- the open-loop replayer -------------------------------------------------

def percentile(values, q):
    """Nearest-rank percentile of a list (0 on empty)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(0, min(len(ordered) - 1,
                      int(round(q / 100.0 * (len(ordered) - 1)))))
    return float(ordered[rank])


def http_poster(url, path="/generate", timeout=30.0):
    """The default transport: POST one planned request to a live
    GenerateAPI/router surface, returns (status, tokens_delivered).
    429/503 sheds come back as their status with 0 tokens — the
    summary books them as shed, not errors."""
    import urllib.error
    import urllib.request

    base = url.rstrip("/")
    if base.endswith(path):
        base = base[:-len(path)]

    def poster(entry, payload):
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        if entry.get("tenant"):
            req.add_header("X-Veles-Tenant", entry["tenant"])
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                body = json.loads(resp.read().decode())
                return resp.status, len(body.get("tokens") or ())
        except urllib.error.HTTPError as exc:
            exc.read()
            return exc.code, 0

    return poster


def replay(plan, url=None, poster=None, vocab=8, seed=0, workers=16,
           timeout=30.0, prompt_cap=None, budget_cap=None, stop=None):
    """Replay an arrival plan OPEN-LOOP: a scheduler releases each
    request at its planned instant off a shared monotonic base — a
    slowing server keeps receiving arrivals on schedule; the bounded
    worker pool only caps client-side concurrency (and its saturation
    shows up honestly as schedule skew). Prompt token ids are seeded
    per arrival (prompt TEXT was never recorded); ``poster`` injection
    makes the whole loop scriptable in tests. Returns a summary dict
    with delivered-token fidelity and schedule-skew percentiles."""
    if poster is None:
        if url is None:
            raise ValueError("replay needs a url or a poster")
        poster = http_poster(url, timeout=timeout)
    results = [None] * len(plan)
    work = queue.Queue()
    base = time.monotonic() + 0.05  # lead-in so arrival 0 isn't late

    def run_one():
        while True:
            item = work.get()
            if item is None:
                return
            index, entry = item
            sent = time.monotonic()
            skew_ms = max(0.0, (sent - (base + entry["at"])) * 1000.0)
            prng = random.Random((int(seed) << 20) ^ index)
            n = entry["prompt_len"]
            if prompt_cap:
                n = min(n, int(prompt_cap))
            tokens = [prng.randrange(1, max(2, int(vocab)))
                      for _ in range(max(1, n))]
            payload = {"tokens": tokens}
            budget = entry["budget"]
            if budget_cap:
                budget = min(budget, int(budget_cap))
            payload["n_tokens"] = budget
            if entry.get("deadline_s"):
                payload["deadline_s"] = entry["deadline_s"]
            try:
                status, delivered = poster(entry, payload)
            except Exception:
                status, delivered = -1, 0
            results[index] = {"index": index, "status": int(status),
                              "tokens": int(delivered),
                              "skew_ms": round(skew_ms, 3),
                              "wall_ms": round((time.monotonic() - sent)
                                               * 1000.0, 3)}

    pool = [threading.Thread(target=run_one, daemon=True,
                             name="replay-%d" % i)
            for i in range(max(1, int(workers)))]
    for thread in pool:
        thread.start()
    for index, entry in enumerate(plan):
        if stop is not None and stop.is_set():
            break
        delay = base + entry["at"] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        work.put((index, entry))
    for _ in pool:
        work.put(None)
    for thread in pool:
        thread.join(timeout=timeout + 10.0)
    duration_s = max(1e-9, time.monotonic() - base)
    return summarize_replay(plan, results, duration_s)


def summarize_replay(plan, results, duration_s):
    """Fold per-request results into the replay summary the fidelity
    keys and the capacity finder consume."""
    done = [r for r in results if r is not None]
    ok = [r for r in done if r["status"] == 200]
    shed = [r for r in done if r["status"] in (429, 503)]
    errors = [r for r in done
              if r["status"] not in (200, 429, 503)]
    delivered = sum(r["tokens"] for r in ok)
    recorded = sum(e.get("tokens_recorded") or 0 for e in plan)
    skews = [r["skew_ms"] for r in done]
    walls = [r["wall_ms"] for r in ok]
    return {
        "requests": len(plan),
        "completed": len(ok),
        "shed": len(shed),
        "errors": len(errors) + (len(plan) - len(done)),
        "availability": (len(ok) / float(len(done))) if done else 0.0,
        "tokens_delivered": delivered,
        "tokens_recorded": recorded,
        "delivered_ratio": (delivered / float(recorded)) if recorded
                           else 0.0,
        "duration_s": round(duration_s, 6),
        "tokens_per_sec": round(delivered / duration_s, 3),
        "schedule_skew_ms_p50": round(percentile(skews, 50), 3),
        "schedule_skew_ms_p95": round(percentile(skews, 95), 3),
        "schedule_skew_ms_max": round(max(skews) if skews else 0.0, 3),
        "request_wall_ms_p95": round(percentile(walls, 95), 3),
    }


def tenant_mix(rows):
    """Tenant-hash -> share of arrivals (what a capacity report means
    by "at this mix")."""
    counts = {}
    for row in rows:
        key = row.get("tenant") or ""
        counts[key] = counts.get(key, 0) + 1
    total = float(sum(counts.values()) or 1)
    return {tenant: round(n / total, 4)
            for tenant, n in sorted(counts.items())}


# -- CLI (dispatched from observe/trace_export.py) --------------------------

def _fetch_json(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read().decode())


def record_main(artifact=None, live=None, output=None, salt="veles"):
    """``observe record [ARTIFACT | --live URL] -o TRACE``:
    export an anonymized trace from a saved /debug/requests payload or
    a live serving surface. Returns 0, or 1 when nothing is
    recordable."""
    output = output or "veles.trace.jsonl"
    if live:
        base = live.rstrip("/")
        try:
            payload = _fetch_json("%s/debug/requests?n=64" % base)
        except Exception as exc:
            print("cannot fetch %s/debug/requests: %s" % (base, exc))
            return 1
        header = record_from_snapshot(payload, output, salt=salt,
                                      source=base)
    else:
        try:
            with open(artifact) as fin:
                payload = json.load(fin)
        except (OSError, ValueError) as exc:
            print("cannot load %s: %s" % (artifact, exc))
            return 1
        if "slowest" not in payload and "requests" in payload:
            payload = payload["requests"]  # a /debug/serve embedding
        header = record_from_snapshot(payload, output, salt=salt,
                                      source=str(artifact))
    print("recorded %d requests spanning %.3fs -> %s"
          % (header["count"], header["span_s"], output))
    if header["lossy"]:
        print("LOSSY recording: %s" % json.dumps(header["loss"]))
    if not header["count"]:
        print("nothing recorded (no resolved requests in the source)")
        return 1
    return 0


def replay_main(trace, live, warp=1.0, seed=0, vocab=8, workers=16,
                burst_compress=0.0, long_context_skew=0.0):
    """``observe replay TRACE --live URL [--warp N]``:
    one open-loop replay at a fixed warp; prints the fidelity summary.
    Returns 0, or 1 when the trace cannot be loaded."""
    try:
        header, rows = load_trace(trace)
    except (OSError, ValueError) as exc:
        print("cannot load trace %s: %s" % (trace, exc))
        return 1
    plan = warp_plan(rows, warp=warp, seed=seed,
                     burst_compress=burst_compress,
                     long_context_skew=long_context_skew)
    print("replaying %d arrivals (x%.2f warp, seed %d, plan %s) "
          "against %s"
          % (len(plan), warp, seed, plan_fingerprint(plan)[:12], live))
    summary = replay(plan, url=live, vocab=vocab, seed=seed,
                     workers=workers)
    print(json.dumps(summary, indent=1, sort_keys=True))
    return 0
