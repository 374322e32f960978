"""The port's training driver (``python -m repro_torch.launch.train``):
the twin of ``tests/test_drivers.py::test_train_driver_with_resume`` on
the CPU, a run that the JAX driver started and the port's driver
resumes (against the JAX driver resuming a copy of the same checkpoint
directory: the same rows within the bf16 tolerance of the JAX kernel
tests, 2e-2 on the loss, and the learning rates equal but for the
rounding of the cosine), and the refusals."""
import json
import shutil

import numpy as np
import pytest

from repro.launch import train as jax_train

from repro_torch.launch import train as train_mod

SMOKE = ["--arch", "h2o-danube-1.8b", "--smoke", "--global-batch", "2",
         "--seq", "32"]


def test_train_driver_with_resume(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    metrics = str(tmp_path / "m.json")
    args = SMOKE + ["--steps", "6", "--ckpt-dir", ckpt, "--ckpt-every",
                    "3", "--log-every", "2", "--metrics-out", metrics,
                    "--device", "cpu"]
    assert train_mod.main(args) == 0
    rows = json.load(open(metrics))
    assert [r["step"] for r in rows] == [2, 4, 6]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows)
    # resume two more steps from the checkpoint
    args2 = [a if a != "6" else "8" for a in args] + ["--resume", "auto"]
    assert train_mod.main(args2) == 0
    out = capsys.readouterr().out
    assert "resumed from step 6" in out
    assert [r["step"] for r in json.load(open(metrics))] == [8]


def test_a_run_the_jax_driver_started_resumes_in_the_port(tmp_path, capsys):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert jax_train.main(SMOKE + ["--steps", "3", "--ckpt-dir",
                                   str(jax_dir), "--ckpt-every", "3"]) == 0
    shutil.copytree(jax_dir, port_dir)
    resume = SMOKE + ["--steps", "6", "--resume", "auto", "--log-every", "1"]
    want_out, got_out = tmp_path / "want.json", tmp_path / "got.json"
    assert jax_train.main(resume + ["--ckpt-dir", str(jax_dir),
                                    "--metrics-out", str(want_out)]) == 0
    assert train_mod.main(resume + ["--ckpt-dir", str(port_dir),
                                    "--metrics-out", str(got_out),
                                    "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("resumed from step 3") == 2
    want, got = json.load(open(want_out)), json.load(open(got_out))
    assert [r["step"] for r in got] == [r["step"] for r in want] == [4, 5, 6]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=2e-2)
        assert np.isfinite(g["grad_norm"])
        lr_w, lr_g = np.float32(w["lr"]), np.float32(g["lr"])
        assert abs(lr_g - lr_w) <= np.spacing(lr_w) + 0.45 * 3e-3 \
            * np.spacing(np.float32(1)), (lr_g, lr_w)


def test_refusals():
    # two model shards need two ranks (torchrun)
    with pytest.raises(ValueError, match="torchrun"):
        train_mod.main(SMOKE + ["--steps", "1", "--model-shards", "2",
                                "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP A13d"):
        train_mod.main(["--arch", "zamba2-7b", "--smoke", "--steps", "1",
                        "--device", "cpu"])
