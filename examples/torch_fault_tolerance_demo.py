"""Fault-tolerance demo on the PyTorch port: supervised training that
survives a crash.  The twin of ``examples/fault_tolerance_demo.py``.

    PYTHONPATH=src python examples/torch_fault_tolerance_demo.py \
        [--device cpu]

Launches ``python -m repro_torch.launch.train`` under the port's
``Supervisor`` with an injected hard crash at step 30; a second
supervisor restarts the trainer without the crash flag, the trainer
resumes from the last atomic checkpoint (step 20 or later), and the run
completes.  The device defaults to ``cuda``; ``--device cpu`` trains on
the CPU.
"""
import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.train.fault_tolerance import Supervisor  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "ckpt")
        hb = os.path.join(d, "heartbeat")
        metrics = os.path.join(d, "metrics.json")
        base = [sys.executable, "-m", "repro_torch.launch.train",
                "--arch", "qwen3-0.6b", "--smoke", "--steps", "60",
                "--global-batch", "4", "--seq", "64",
                "--ckpt-dir", ckpt, "--ckpt-every", "20",
                "--resume", "auto", "--heartbeat", hb,
                "--log-every", "10", "--device", args.device]
        env = {"PYTHONPATH": os.path.join(ROOT, "src")}
        # first attempt crashes at step 30; the restart must resume >= 20
        sup = Supervisor(base + ["--crash-at", "30"], heartbeat=hb,
                         heartbeat_timeout=120, max_restarts=0, env=env)
        rc = sup.run()
        assert rc == 42, f"expected the injected crash (rc 42), got {rc}"
        print("\n-- supervisor restart (no crash flag) --\n")
        sup = Supervisor(base + ["--metrics-out", metrics], heartbeat=hb,
                         heartbeat_timeout=120, max_restarts=2, env=env)
        rc = sup.run()
        assert rc == 0, f"supervised run failed rc={rc}"
        rows = json.load(open(metrics))
        assert rows[0]["step"] > 20 and rows[-1]["step"] == 60, rows
    print("torch_fault_tolerance_demo: OK")


if __name__ == "__main__":
    main()
