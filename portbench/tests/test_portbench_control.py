"""The comparison that decides ``correct`` fails what it must: the control
(the reference one step below the configuration's precision, put in the
program's place), and a run whose timed path is broken underneath.  The
harness runs here on the CPU at a small size, its look for a card
skipped; a sound run is correct."""
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

from portbench.data import contexts
from portbench.lib import compare, harness, manifest
from repro_torch.core import batch
from repro_torch.core import pipeline as P

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("bibsonomy.prime", "movielens-1m.noac", "movielens-1m.exact")
SEED = 2**31 + 77


def _cell(name):
    cell = manifest.load_cell(ROOT, name)
    cell.config = contexts.scaled(cell.config, 0.002)
    return cell


def _run(cell):
    """A run on the CPU.  The look for JAX in ``sys.modules`` is left out:
    a test worker that ran the JAX package's tests before holds it (the
    subprocess tests below look for it in a process of their own)."""
    with mock.patch.object(harness.isolation, "forbidden_modules",
                           lambda: []), \
            mock.patch.object(harness, "WARM_SECONDS", 0.0):
        return harness.run(cell, SEED, 0.15, False, time.perf_counter(),
                           device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(_cell(name))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "check"
    assert out["check"]["mismatched"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_every_number(name):
    cell = _cell(name)
    table, values = contexts.make_context(cell.config, SEED, 0)
    want = harness.reference(cell, table, values, "cpu")
    ctl = harness.reference(cell, table, values, "cpu", control=True)
    nums = compare.numbers(harness.control_leaves(ctl), want)
    assert not compare.judge(nums, cell.limits)
    for key, limit in cell.limits.items():
        assert nums[key] > limit, (key, nums[key])


def _stale(monkeypatch):
    """Every request returns the result of the call before it: the state
    handed back is never moved on to the request's own table (the
    window's first request already gets the last warm request's)."""
    call = P.PipelineMiner.__call__

    def stale(self, *args, **kw):
        prev = getattr(self, "_prev", None)
        self._prev = call(self, *args, **kw)
        return self._prev if prev is None else prev
    monkeypatch.setattr(P.PipelineMiner, "__call__", stale)


def _half(monkeypatch):
    """Half of the table left out: only its first half is mined."""
    mine = P.mine_tuples

    def half(tuples, *args, values=None, **kw):
        h = tuples.shape[0] // 2
        return mine(tuples[:h], *args,
                    values=None if values is None else values[:h], **kw)
    monkeypatch.setattr(P, "mine_tuples", half)


def _altered(monkeypatch):
    """One answer altered where it is produced: a row's keep flag."""
    mine = P.mine_tuples

    def altered(*args, **kw):
        res = mine(*args, **kw)
        res.keep[0] = ~res.keep[0]
        return res
    monkeypatch.setattr(P, "mine_tuples", altered)


def _exact_altered(monkeypatch):
    """One exact density altered where it is produced (by 1e-3)."""
    dense = batch.exact_density_dense

    def altered(*args, **kw):
        out = dense(*args, **kw)
        out[0] = out[0] * 1.001
        return out
    monkeypatch.setattr(batch, "exact_density_dense", altered)


def _delta_shifted(by):
    """The δ-window's bounds shifted where they are found: each row's
    window is [v - δ', v + δ'] with δ' = δ + ``by``."""
    def fault(monkeypatch):
        components = P.delta_components

        def shifted(sm, r_lo, r_hi, values, delta, *args, **kw):
            return components(sm, r_lo, r_hi, values, delta + by, *args,
                              **kw)
        monkeypatch.setattr(P, "delta_components", shifted)
    fault.__name__ = f"_delta_shifted_by_{by:+g}"
    return fault


FAULTS = [(c, f) for c in CELLS for f in (_stale, _half, _altered)] + [
    ("movielens-1m.exact", _exact_altered)] + [
    ("movielens-1m.noac", _delta_shifted(by)) for by in (-0.5, 1.0)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    cell = _cell(name)
    fault(monkeypatch)
    out = _run(cell)
    assert out["correct"] is False
    assert out["failed"] >= 1


def test_no_card_exits_without_a_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_needs_the_program(tmp_path):
    """From a directory that holds only the benchmark's own files."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.mining, portbench.reference.exact;"
            "import portbench.data.contexts, portbench.lib.compare;"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'});"
            "print(bad)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_harness_and_port_load_no_jax():
    code = ("import sys; sys.path[:0] = ['.', 'src'];"
            "import portbench.lib.harness as h, portbench.lib.trace;"
            "from portbench.lib import manifest, isolation;"
            "import repro_torch.core, repro_torch.kernels.ops;"
            "[manifest.reader(m) for m in ('mine_p95_ms', 'device_ms.sort',"
            " 'device_ms.density', 'device_idle_share.exact')];"
            "print(isolation.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_jax_package_in_the_process_refuses_the_run(monkeypatch):
    """A run whose process holds the JAX package once the window has
    closed raises, so ``run.py`` prints no result."""
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    with pytest.raises(harness.IsolationError, match="repro"):
        harness.run(_cell(CELLS[0]), SEED, 0.15, False,
                    time.perf_counter(), device="cpu")


def test_forbidden_names_compare_whole_top_level_names():
    from portbench.lib.isolation import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.core",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["repro.core.batch", "jax._src",
                              "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]
    assert np.array_equal(np.zeros(1), np.zeros(1))
