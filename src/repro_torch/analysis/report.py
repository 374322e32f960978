"""Render the dry run's tables from its JSONL files: the twin of
``repro.analysis.report``.

    PYTHONPATH=src python -m repro_torch.analysis.report \
        results/dryrun_torch.jsonl
"""
from __future__ import annotations

import json
import sys


def load(path: str) -> list:
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def fmt_row(r: dict) -> str:
    if r["status"] == "skip":
        return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"— skip: {r['reason'].split(':')[0]} |||||||")
    if r["status"] == "error":
        return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"ERROR {r['error'][:40]} |||||||")
    gb = r["device_bytes"] / 1e9
    return ("| {arch} | {shape} | {mesh} | {c:.4f} | {m:.4f} | {x:.4f} | "
            "{bound} | {useful:.3f} | {mfu:.2%} | {gb:.2f}{over} |").format(
        arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
        c=r["compute_s"], m=r["memory_s"], x=r["collective_s"],
        bound=r["bound"], useful=r["useful_ratio"], mfu=r["mfu"],
        gb=gb, over="" if r["fits"] else " ⚠")


HEADER = ("| arch | shape | mesh | compute s | memory s | collective s | "
          "bound | useful | roofline-MFU | GB/dev |\n"
          "|---|---|---|---|---|---|---|---|---|---|")


def roofline_table(rows: list, mesh: str = None) -> str:
    out = [HEADER]
    for r in rows:
        if mesh and r.get("mesh") != mesh:
            continue
        out.append(fmt_row(r))
    return "\n".join(out)


def dryrun_summary(rows: list) -> str:
    ok = [r for r in rows if r["status"] == "ok"]
    skip = [r for r in rows if r["status"] == "skip"]
    err = [r for r in rows if r["status"] == "error"]
    fit = [r for r in ok if r["fits"]]
    lines = [
        f"* cells: {len(rows)} total — {len(ok)} traced, "
        f"{len(skip)} documented skips, {len(err)} errors",
        f"* memory: {len(fit)}/{len(ok)} traced cells fit 80 GB/card "
        "(the traced peak of live storages)",
    ]
    if ok:
        slow = sorted(ok, key=lambda r: -r["trace_s"])[0]
        lines.append(
            f"* slowest trace: {slow['arch']}×{slow['shape']}×"
            f"{slow['mesh']} at {slow['trace_s']:.0f}s")
    by_bound = {}
    for r in ok:
        by_bound[r["bound"]] = by_bound.get(r["bound"], 0) + 1
    lines.append("* dominant terms: " + ", ".join(
        f"{k}: {v}" for k, v in sorted(by_bound.items())))
    return "\n".join(lines)


def main():
    path = (sys.argv[1] if len(sys.argv) > 1
            else "results/dryrun_torch.jsonl")
    rows = load(path)
    print(dryrun_summary(rows))
    for mesh in ("1pod", "2pod"):
        print(f"\n### {mesh}\n")
        print(roofline_table(rows, mesh))


if __name__ == "__main__":
    main()
