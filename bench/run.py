"""Run one cell of the port's benchmark and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
Set-up (timed as ``setup_s``, from the start of this script) imports,
loads the kernel library from ``build/repro_torch`` (it compiles on a
checkout's first run), compiles the cell's network and runs its warm
jobs; the window then runs jobs for ``--seconds``; ``--trace 1`` adds the
per-layer metrics and a profiled window.  Every run ends with the check
against the plain reference: each number compared is printed beside its
limit as the last lines of standard error, and the result as one JSON
object on the last line of standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every compiler cache of the process at a fixed path in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from bench import harness

    cell = harness.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(cell, args.seed, args.seconds,
                                      bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the JAX package or JAX itself",
              file=sys.stderr)
        return 3
    print("timing " + " ".join(f"{k} {v!r}" for k, v in
                               result["timing"].items()), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
