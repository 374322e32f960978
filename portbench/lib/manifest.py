"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration (its ``file``),
a traffic mix (``traffic/<traffic>.json``) and, through the metrics that
list it or list no cells, its metrics: each read by
``metrics/<metric>.py``.  The limits of its comparison are in
``limits/<cell>.json``.  Adding a cell, a mix or a metric adds files and
entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or the metric
    lists no cells and the cell reports the end-to-end metric it moves
    (an end-to-end metric without a list: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; ``KeyError`` for
    an unknown name."""
    manifest = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the manifest has "
                       f"{sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _load_json(root / configs[entry["config"]]["file"])
    traffic = _load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits = _load_json(BENCH_DIR / "limits" / f"{workload}.json")
    e2e = [m for m in manifest["end_to_end"]
           if _reports(m, workload, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in manifest["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, int(entry["chips"]), config, traffic,
                limits["limits"], e2e, per_layer)


def reader(metric: str) -> Callable:
    """The ``read(view)`` function of ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
