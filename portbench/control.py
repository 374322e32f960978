"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the run's pool of contexts and compares the
control (the plain reference one step below the configuration's
precision: one 32-bit signature lane, bfloat16 densities) in the
program's place with the sound reference, context by context.  It
prints one JSON line a seed: the numbers a run compares, the worst over
the pool, beside the cell's limits.  A run's own numbers (the sound
program's) are the lower readings; these are the upper ones.  The
benchmark's runs do not run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.data import contexts
    from portbench.lib import compare, harness
    from portbench.lib.manifest import load_cell
    cell = load_cell(ROOT, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        per_context = []
        for i in range(harness.POOL):
            table, values = contexts.make_context(cell.config, seed, i)
            want = harness.reference(cell, table, values, args.device)
            ctl = harness.reference(cell, table, values, args.device,
                                    control=True)
            per_context.append(compare.numbers(
                harness.control_leaves(ctl), want))
        nums = compare.combine(per_context)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control": nums,
            "limits": cell.limits,
            "fails": not compare.judge(nums, cell.limits),
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
