"""Compare two workflow snapshots.

The port of ``veles_tpu/scripts/compare_snapshots.py`` (reference
``veles/scripts/compare_snapshots.py``): load two of the port's pickled
workflows and report their structural and numerical differences (unit
sets, each Array's largest absolute difference, changed scalar
attributes). Exit code 0 when identical within the tolerance, 1
otherwise.

Usage: ``python -m veles_tpu_torch.scripts.compare_snapshots A.pickle.gz
B.pickle.gz [--tolerance 1e-6] [--device cpu]``
"""

import argparse
import json

import numpy

from veles_tpu_torch.memory import Array
from veles_tpu_torch.snapshotter import SnapshotterToFile


def unit_state(unit):
    """A unit's Arrays (as host numpy) and scalar attributes."""
    arrays, scalars = {}, {}
    for key, value in vars(unit).items():
        if key.endswith("_"):
            continue
        if isinstance(value, Array) and value.data is not None:
            arrays[key] = value.mem
        elif isinstance(value, (int, float, str, bool)):
            scalars[key] = value
    return arrays, scalars


def compare(workflow_a, workflow_b, tolerance=1e-6):
    """Diff report dict for two workflows."""
    units_a = {u.name: u for u in workflow_a.units}
    units_b = {u.name: u for u in workflow_b.units}
    report = {
        "only_in_a": sorted(set(units_a) - set(units_b)),
        "only_in_b": sorted(set(units_b) - set(units_a)),
        "array_diffs": {},
        "scalar_diffs": {},
    }
    for name in sorted(set(units_a) & set(units_b)):
        arrays_a, scalars_a = unit_state(units_a[name])
        arrays_b, scalars_b = unit_state(units_b[name])
        for key in sorted(set(arrays_a) & set(arrays_b)):
            a, b = arrays_a[key], arrays_b[key]
            if a.shape != b.shape:
                report["array_diffs"]["%s.%s" % (name, key)] = {
                    "shape_a": list(a.shape), "shape_b": list(b.shape)}
                continue
            delta = float(numpy.max(numpy.abs(
                a.astype(numpy.float64) - b.astype(numpy.float64)))) \
                if a.size else 0.0
            # NaN-safe: a diverged (NaN) snapshot reads as DIFFERENT
            if not delta <= tolerance:
                report["array_diffs"]["%s.%s" % (name, key)] = {
                    "max_abs_delta": delta}
        for key in sorted(set(scalars_a) & set(scalars_b)):
            if scalars_a[key] != scalars_b[key]:
                report["scalar_diffs"]["%s.%s" % (name, key)] = {
                    "a": scalars_a[key], "b": scalars_b[key]}
    report["identical"] = not any(
        report[k] for k in ("only_in_a", "only_in_b", "array_diffs",
                            "scalar_diffs"))
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="compare_snapshots",
        description="diff two pickled workflow snapshots")
    parser.add_argument("snapshot_a")
    parser.add_argument("snapshot_b")
    parser.add_argument("--tolerance", type=float, default=1e-6)
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="where the snapshots are loaded")
    args = parser.parse_args(argv)
    report = compare(
        SnapshotterToFile.import_(args.snapshot_a, device=args.device),
        SnapshotterToFile.import_(args.snapshot_b, device=args.device),
        args.tolerance)
    print(json.dumps(report, indent=1, default=str))
    return 0 if report["identical"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
