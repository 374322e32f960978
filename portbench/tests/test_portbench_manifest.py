"""``BENCHMARK.json`` against the rules its names, units and files keep,
and every file it names found where the harness looks."""
import json
import re
from pathlib import Path

import pytest

from portbench.lib import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    script = BENCH["command"][1]
    assert any(script.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text_fields():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end" and \
                        group != "per_layer":
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in BENCH[group]]
        assert len(group_names) == len(set(group_names))
    metric_names = [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_entries_have_just_their_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, allowed in keys.items():
        for entry in BENCH[group]:
            extra = set(entry) - allowed
            assert extra <= ({"workloads"} if "metric" in group
                             or group in ("end_to_end", "per_layer")
                             else set()), (entry["name"], extra)
            assert allowed <= set(entry), entry["name"]


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in SOURCES
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_its_metrics_move(cell):
    loaded = manifest.load_cell(ROOT, cell)
    e2e = [m["name"] for m in loaded.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert loaded.per_layer
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", []):
            assert m["moves"] in e2e, (m["name"], cell)
    for m in BENCH["end_to_end"]:
        for listed in m.get("workloads", []):
            assert listed in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist_and_are_found_by_name(cell):
    loaded = manifest.load_cell(ROOT, cell)
    for m in loaded.end_to_end + loaded.per_layer:
        assert callable(manifest.reader(m["name"]))
    assert loaded.limits and all(v >= 0 for v in loaded.limits.values())
    assert {"variant", "readback", "sample", "libraries"} \
        <= set(loaded.traffic)


def test_configs_files_and_reduced():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert c["source"].startswith("https://")


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            assert PATH.match(str(f.relative_to(ROOT))), f
