"""Bench artifacts with atomic writes, and the regression gate.

The port of ``veles_tpu/observe/regress.py``. Two halves:

- the writer (:class:`BenchArtifact`) streams each section's keys into a
  schema-versioned JSON as they are measured; every write is a temporary
  file and ``os.replace`` with a SHA-256 sidecar, and the document
  carries its keys' digest, the device fingerprint (torch's backend, the
  card's name, the device count, the torch version) and the git sha;
- the comparator (:func:`compare`, ``python -m veles_tpu_torch observe
  regress OLD NEW``) is per key and direction-aware (time keys regress
  up, throughput keys down), each key allowed the base tolerance plus
  both runs' recorded spreads (``*_spread``). Exit 0 clean, 1 on a
  regression, 2 on an unreadable or forged artifact.

:func:`load_bench` reads every historical shape: the sentinel schema,
the round wrapper (``{"tail": ..., "parsed": ...}``), a flat bench line,
and keys recovered from a truncated tail by a scanning parser.
"""

import hashlib
import json
import os
import re
import time

SCHEMA_VERSION = 1

#: numeric key suffixes where LOWER is better: times, byte counts,
#: overhead shares, burn rates, ladder transitions, waste shares, shed
#: requests and the untagged memory share (the JAX package's comments at
#: ``veles_tpu/observe/regress.py:43-146`` give each family's reason).
#: NOT "_sec" alone (throughput keys end in "tokens_per_sec") and not the
#: bare "_fraction" (goodput and occupancy are higher-better). The AOT
#: cold start's keys are lower-better: ``coldstart_*_ms`` by "_ms", and
#: ``coldstart_compiles`` (the builds an AOT-booted warm-up books: flat
#: zero is the bundle's proof) by "_compiles"
_LOWER_BETTER = ("_ms", "_seconds", "_sec_mean", "_overhead_fraction",
                 "_overhead_pct", "_std", "_bytes", "_hit_fraction",
                 "_flatness", "_compiles", "burn_rate", "_transitions",
                 "_ns", "_anomaly_rate", "_waste_share",
                 "_shed_requests", "_untagged_fraction")
#: key suffixes that are measurement metadata, never compared
_SKIP_SUFFIXES = ("_config", "_spread", "_warn", "_spread_warn")
#: spread-carrying metric suffixes: "<base><suffix>" looks up
#: "<base>_spread" for its tolerance allowance
_SPREAD_METRIC_SUFFIXES = ("_tokens_per_sec", "_images_per_sec",
                           "_step_ms", "_device_ms", "_block_ms",
                           "_ms", "_mfu", "_gflops", "_speedup")

#: the scanning parser for truncated artifacts: complete
#: "key": <number|bool|null|"str"> pairs survive anywhere in the text
_KV_RE = re.compile(
    r'"([A-Za-z_][A-Za-z0-9_]*)"\s*:\s*'
    r'(-?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|true|false|null|"[^"]*")')


def sha256_of(path):
    digest = hashlib.sha256()
    with open(path, "rb") as fin:
        for block in iter(lambda: fin.read(1 << 16), b""):
            digest.update(block)
    return digest.hexdigest()


def _atomic_write(path, text):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as fout:
        fout.write(text)
    os.replace(tmp, path)


def _keys_digest(keys):
    """Canonical hash of the measured keys, embedded IN the artifact
    doc — atomic with the payload it protects, unlike the two-file
    sidecar pair (a kill between the artifact and sidecar replaces
    leaves a stale sidecar beside an intact artifact)."""
    return hashlib.sha256(
        json.dumps(keys, sort_keys=True, default=str).encode()
    ).hexdigest()


def device_fingerprint():
    """What machine produced this artifact, enough to refuse a
    cross-device comparison knowingly: torch's backend (``cuda`` or
    ``cpu``), the device's name, the device count and torch's
    version."""
    out = {}
    try:
        import torch
        if torch.cuda.is_available():
            out["backend"] = "cuda"
            out["device_kind"] = torch.cuda.get_device_name(0)
            out["device_count"] = torch.cuda.device_count()
        else:
            out["backend"] = "cpu"
            out["device_kind"] = "cpu"
            out["device_count"] = 1
        out["torch"] = torch.__version__
    except Exception:   # noqa: BLE001 - the artifact is written anyway
        pass
    return out


def git_sha(cwd=None):
    import subprocess
    try:
        proc = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True,
            text=True, timeout=10,
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode == 0:
            return proc.stdout.strip()
    except Exception:
        pass
    return None


class BenchArtifact:
    """Incremental, atomic, hash-sidecar'd bench artifact writer.

    ``update({...})`` merges keys and rewrites the file immediately —
    a bench process killed mid-run (or a captured stdout truncated at
    the tail) leaves every section completed so far on disk, intact."""

    def __init__(self, path, meta=None):
        self.path = path
        self.keys = {}
        self.meta = {
            "schema": SCHEMA_VERSION,
            "created": time.time(),
            "device": device_fingerprint(),
            "git_sha": git_sha(),
        }
        if meta:
            self.meta.update(meta)

    @property
    def sidecar_path(self):
        return self.path + ".sha256"

    def update(self, mapping):
        """Merge a section's keys and persist (atomic + sidecar)."""
        if not mapping:
            return self
        self.keys.update(mapping)
        self.write()
        return self

    def write(self):
        doc = dict(self.meta, updated=time.time(), keys=self.keys,
                   keys_sha256=_keys_digest(self.keys))
        try:
            directory = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(directory, exist_ok=True)
            text = json.dumps(doc, indent=1, default=str)
            _atomic_write(self.path, text)
            # hash the bytes just written, no re-read (the same
            # write-tee doctrine as the snapshotter's sidecars)
            digest = hashlib.sha256(text.encode()).hexdigest()
            _atomic_write(self.sidecar_path, "%s  %s\n" % (
                digest, os.path.basename(self.path)))
        except OSError:
            import logging
            logging.getLogger("BenchArtifact").exception(
                "bench artifact write failed: %s", self.path)
        return self.path


def verify_sidecar(path):
    """True when the ``.sha256`` sidecar matches, False on mismatch
    (an empty/torn sidecar is a mismatch, not a crash), None when
    there is no sidecar to check."""
    sidecar = path + ".sha256"
    if not os.path.isfile(sidecar):
        return None
    with open(sidecar, "r") as fin:
        fields = fin.read().split()
    if not fields:
        return False
    return fields[0].strip() == sha256_of(path)


def recover_keys(text):
    """Scan arbitrary (possibly truncated) text for complete
    ``"key": value`` pairs — the salvage path for artifacts that lost
    their head or tail."""
    out = {}
    for match in _KV_RE.finditer(text):
        key, raw = match.group(1), match.group(2)
        try:
            out[key] = json.loads(raw)
        except ValueError:
            continue
    return out


def load_bench(path):
    """Load any BENCH artifact shape into ``(keys, info)``.

    Handles: the sentinel schema (``{"schema", "keys"}``), the round
    driver wrapper (``{"tail", "parsed", ...}`` — a truncated tail
    degrades to the scanning parser), and a flat bench dict. ``info``
    records the format, truncation recovery and sidecar verdict."""
    info = {"path": path, "sidecar": verify_sidecar(path),
            "recovered": False}
    with open(path, "r") as fin:
        text = fin.read()
    try:
        doc = json.loads(text)
    except ValueError:
        # the file ITSELF is torn: salvage what scans
        info["format"] = "torn"
        info["recovered"] = True
        return recover_keys(text), info
    if not isinstance(doc, dict):
        raise ValueError("%s: not a JSON object" % path)
    if isinstance(doc.get("keys"), dict) and "schema" in doc:
        info["format"] = "sentinel-v%s" % doc.get("schema")
        info["meta"] = {k: doc.get(k)
                        for k in ("device", "git_sha", "created")}
        recorded = doc.get("keys_sha256")
        if recorded is not None:
            info["keys_intact"] = recorded == _keys_digest(doc["keys"])
        return dict(doc["keys"]), info
    if "tail" in doc or "parsed" in doc:
        info["format"] = "driver-wrapper"
        parsed = doc.get("parsed")
        if isinstance(parsed, dict):
            return dict(parsed), info
        tail = doc.get("tail") or ""
        try:
            line = json.loads(tail)
            if isinstance(line, dict):
                return line, info
        except ValueError:
            pass
        # a tail that lost its head (BENCH_r05.json): salvage the
        # complete pairs instead of declaring the artifact unmeasured
        info["recovered"] = True
        return recover_keys(tail), info
    info["format"] = "flat"
    return dict(doc), info


# -- comparison -------------------------------------------------------------

def _comparable(key, value):
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return False
    return not key.endswith(_SKIP_SUFFIXES)


def _lower_is_better(key):
    return key.endswith(_LOWER_BETTER)


def _spread_for(keys, key):
    """The recorded run-to-run spread backing ``key``: its own
    ``<key>_spread`` sibling, or the shared ``<base>_spread`` after
    stripping a known metric suffix."""
    direct = keys.get(key + "_spread")
    if isinstance(direct, (int, float)) and not isinstance(direct, bool):
        return float(direct)
    for suffix in _SPREAD_METRIC_SUFFIXES:
        if key.endswith(suffix):
            sibling = keys.get(key[:-len(suffix)] + "_spread")
            if isinstance(sibling, (int, float)) \
                    and not isinstance(sibling, bool):
                return float(sibling)
    return 0.0


def compare(old, new, base_tolerance=0.1, allow_missing=()):
    """Compare two key dicts; returns the findings list, worst first.

    Each comparable key's allowance is ``base_tolerance`` plus both
    runs' recorded spreads (spread-aware: the noisy decode keys carry
    their own noise budget; tight keys stay tight). A key present in
    ``old`` but absent from ``new`` is itself a regression — that is
    exactly how tail truncation silently drops a headline key."""
    findings = []
    for key in sorted(old):
        old_value = old[key]
        if not _comparable(key, old_value):
            continue
        if key not in new:
            if key in allow_missing:
                continue
            findings.append({"key": key, "verdict": "missing",
                             "old": old_value, "new": None})
            continue
        new_value = new[key]
        if isinstance(new_value, bool) \
                or not isinstance(new_value, (int, float)):
            findings.append({"key": key, "verdict": "type-changed",
                             "old": old_value, "new": new_value})
            continue
        tolerance = base_tolerance + _spread_for(old, key) \
            + _spread_for(new, key)
        entry = {"key": key, "old": old_value, "new": new_value,
                 "tolerance": round(tolerance, 4)}
        if old_value == 0:
            entry["verdict"] = "ok"  # no meaningful ratio off zero
            findings.append(entry)
            continue
        ratio = new_value / old_value
        entry["ratio"] = round(ratio, 4)
        if _lower_is_better(key):
            regressed = ratio > 1.0 + tolerance and old_value > 0
        else:
            regressed = ratio < 1.0 - tolerance and old_value > 0
        entry["verdict"] = "regressed" if regressed else "ok"
        findings.append(entry)
    for key in sorted(set(new) - set(old)):
        if _comparable(key, new[key]):
            findings.append({"key": key, "verdict": "new",
                             "old": None, "new": new[key]})
    order = {"missing": 0, "type-changed": 0, "regressed": 1, "ok": 2,
             "new": 3}
    findings.sort(key=lambda f: (order.get(f["verdict"], 2), f["key"]))
    return findings


def regressions(findings):
    return [f for f in findings
            if f["verdict"] in ("regressed", "missing", "type-changed")]


def compare_main(old_path, new_path, tolerance=0.1, as_json=False,
                 allow_missing=()):
    """``observe regress OLD NEW``: exit 0 clean, 1 on
    regression, 2 on unreadable/forged artifacts."""
    try:
        old, old_info = load_bench(old_path)
        new, new_info = load_bench(new_path)
    except (OSError, ValueError) as exc:
        print("cannot load artifacts: %s" % exc)
        return 2
    for info in (old_info, new_info):
        if info.get("keys_intact") is False:
            print("INTEGRITY FAILURE: %s embedded keys hash does not "
                  "match its keys" % info["path"])
            return 2
        if info["sidecar"] is False:
            if info.get("keys_intact"):
                # the crash-window case: a kill between the artifact
                # and sidecar replaces leaves a stale sidecar beside
                # an intact artifact — the embedded hash is atomic
                # with the keys, so trust it and say so
                print("warning: %s .sha256 sidecar is stale (the "
                      "embedded keys hash verifies); proceeding"
                      % info["path"])
            else:
                print("INTEGRITY FAILURE: %s does not match its "
                      ".sha256 sidecar" % info["path"])
                return 2
        if info["recovered"]:
            print("note: %s recovered from a truncated artifact "
                  "(%d keys salvaged)"
                  % (info["path"],
                     len(old if info is old_info else new)))
    if not old:
        print("no comparable keys in %s" % old_path)
        return 2
    findings = compare(old, new, base_tolerance=tolerance,
                       allow_missing=allow_missing)
    bad = regressions(findings)
    if as_json:
        print(json.dumps({"old": old_info, "new": new_info,
                          "regressions": len(bad),
                          "findings": findings}, indent=1,
                         default=str))
    else:
        for finding in findings:
            if finding["verdict"] == "ok":
                continue
            print("%-12s %-45s old=%s new=%s%s" % (
                finding["verdict"].upper(), finding["key"],
                finding.get("old"), finding.get("new"),
                (" (ratio %.3f, tol %.3f)"
                 % (finding["ratio"], finding["tolerance"]))
                if "ratio" in finding else ""))
        ok = sum(1 for f in findings if f["verdict"] == "ok")
        print("%d keys compared ok, %d new, %d regression(s)" % (
            ok, sum(1 for f in findings if f["verdict"] == "new"),
            len(bad)))
    return 1 if bad else 0
