"""End-to-end training on the PyTorch port: train a reduced-config LM on
the synthetic motif language, with checkpointing and resume.  The twin of
``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py \
        [--arch qwen3-0.6b] [--steps 200] [--device cpu]

Asserts that the loss decreases, then resumes from the last checkpoint
for 20 more steps (``repro_torch.launch.train``).  The device defaults to
``cuda``; ``--device cpu`` trains on the CPU.
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import train as T  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    common = ["--arch", args.arch, "--smoke",
              "--global-batch", str(args.global_batch),
              "--seq", str(args.seq), "--device", args.device]
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "ckpt")
        metrics = os.path.join(d, "metrics.json")
        rc = T.main(common + ["--steps", str(args.steps),
                              "--ckpt-dir", ckpt, "--ckpt-every", "50",
                              "--metrics-out", metrics, "--log-every", "20"])
        assert rc == 0
        rows = json.load(open(metrics))
        first, last = rows[0]["loss"], rows[-1]["loss"]
        print(f"\nloss: {first:.3f} -> {last:.3f}")
        assert last < first, "loss did not decrease"

        print("\n-- resume from checkpoint (+20 steps) --")
        rc = T.main(common + ["--steps", str(args.steps + 20),
                              "--ckpt-dir", ckpt, "--resume", "auto",
                              "--log-every", "10"])
        assert rc == 0
    print("torch_train_lm: OK")


if __name__ == "__main__":
    main()
