"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell
asks for.  Prints the result as one JSON object on the last line of
standard output, and each compared number beside its limit as the last
lines of standard error.  Exits 2 without a result when CUDA or enough
cards are missing, 3 when JAX or the JAX package was loaded, 1 on any
other failure.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.lib import harness
    from portbench.lib.manifest import load_cell
    cell = load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          T_PROCESS)
    except harness.IsolationError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
