"""The readings that a cell's limits are set from: the program's checks
and the control's, on each seed.

    python3 bench/readings.py --workload <config>.<traffic> \
        --seeds 11 12 13 [--seconds 2] [--out readings.json]

The cell is found from ``bench/``'s files, whether ``BENCHMARK.json``
lists it or not.  Each seed is one run of the cell
(:func:`bench.harness.run_cell`) with a short window and ``control``
set: the program's checked streams are judged against the float64
reference as in every run, and the control, the reference in TF32 put
in the program's place one precision below the float32 the
configurations state, goes through the same checks.  The benchmark's
own runs never run the control; this is for setting and re-checking
the limits on the card, at the cell's own sizes.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float = 2.0,
             device: str = "cuda") -> dict:
    """One short run of ``cell`` with the control: both verdicts and
    every number compared."""
    from bench import harness

    result, checks = harness.run_cell(cell, seed, seconds, False,
                                      device=device, control=True)
    return {"seed": seed, "correct": result["correct"], "checks": checks,
            "control": result.get("control"),
            "reference_s": result["timing"]["reference_s"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    cell = harness.file_cell(args.workload, ROOT)
    rows = []
    for seed in args.seeds:
        rows.append(readings(cell, seed, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
