"""The program's own spans and counts (``repro_torch.trace``) over one run
of a cell, read as the per-layer metrics they feed.

    python3 bench/program_spans.py --workload <name> --seed <n> \
        --seconds <s> [--trace 0|1] [--out <file>]

The run is :func:`bench.harness.run_cell`, whole, with the program's
tracer recording throughout: set-up (``compile_network`` and the warm
jobs), the window, and with ``--trace 1`` the traced passes, whose
host-and-device profile then names each idle gap by the program's
innermost span (``event_matmul.bind:python``, ...).  The harness's
result line is printed with the readings of :data:`METRICS` under
``program_spans``.  Recording costs host time, so the line's end-to-end
numbers are not the benchmark's: a ``bench/run.py`` run of the same seed
on the same card gives what the tracer costs (compare the two
``timing.job_s_quartiles`` medians, each beside its ``host_probe_s``).

``run_cell`` runs ``warm_jobs`` jobs and then the window's jobs, each
job ``streams_per_job`` calls of ``run_batch``, one request of the
tracer each: set-up is the spans outside any request and the first
``warm_jobs x streams_per_job`` requests, the window the next ``jobs x
streams_per_job``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: The per-layer metrics read here; the ``event_matmul*`` spans and
#: counts exist only on CUDA.
METRICS = ("frontend.draw_s", "compute.pack_s", "network.neuron_ms_per_step",
           "compute.self_ms_per_step", "event_matmul.bind_ms_per_step",
           "event_matmul.launch_ms_per_step", "event_matmul2.live_tile_share")


def readings(rec, setup, window, steps: int) -> dict:
    """The :data:`METRICS` that find something in ``rec`` (set-up ones
    over the requests ``setup``, the rest over ``window``, whose requests
    simulated ``steps`` steps in all), and beside them the window's
    totals they split: ``compute_ms_per_step`` (the ``compute.forward``
    spans), ``run_batch_ms_per_step`` and ``window_packs`` (0 once set-up
    is done)."""
    def per_step(seconds):
        return 1e3 * seconds / steps if seconds > 0 and steps else None

    def total(name):
        return per_step(rec.total(name, requests=window))

    tiles = rec.count("event_matmul2.tiles", requests=window)
    values = {
        "frontend.draw_s": rec.total("frontend.draw", requests=setup),
        "compute.pack_s": rec.total("compute.pack", requests=setup),
        "network.neuron_ms_per_step": total("network.neuron"),
        "compute.self_ms_per_step": per_step(
            rec.self_seconds("compute.forward", requests=window)),
        "event_matmul.bind_ms_per_step": total("event_matmul.bind"),
        "event_matmul.launch_ms_per_step": total("event_matmul.launch"),
        "event_matmul2.live_tile_share": 100.0 * rec.count(
            "event_matmul2.live_tiles", requests=window) / tiles
        if tiles else None,
        "compute_ms_per_step": total("compute.forward"),
        "run_batch_ms_per_step": total("network.run_batch"),
        "window_packs": rec.count("compute.packs", requests=window),
    }
    return {name: v for name, v in values.items()
            if v or name == "window_packs"}


def run(cell, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: float | None = None):
    """``run_cell`` with the program's tracer recording: the result
    (with ``program_spans``), the checks and the record."""
    from bench import harness, traffic
    from repro_torch import trace as program_trace

    tr = traffic.with_defaults(cell.traffic)
    k = int(tr["streams_per_job"])
    with program_trace.recording() as rec:
        result, checks = harness.run_cell(cell, seed, seconds, trace,
                                          device=device, t_start=t_start)
    n_setup = k * int(tr["warm_jobs"])
    setup = {None, *range(n_setup)}
    window = range(n_setup, n_setup + k * result["timing"]["jobs"])
    result["program_spans"] = readings(rec, setup, window,
                                       int(tr["steps"]) * len(window))
    return result, checks, rec


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from bench import harness

    cell = harness.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    result, _, _ = run(cell, args.seed, args.seconds, bool(args.trace),
                       t_start=t_start)
    line = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
