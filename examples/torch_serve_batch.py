"""Batched serving demo on the PyTorch port: ragged prompts through
prefill + decode.  The twin of ``examples/serve_batch.py``.

    PYTHONPATH=src python examples/torch_serve_batch.py \
        [--arch mixtral-8x7b] [--device cpu]

Uses the reduced config of the chosen family and the port's
``ServeEngine`` / ``decode_step`` (``repro_torch.launch.serve --smoke``).
The device defaults to ``cuda``; ``--device cpu`` runs the kernels'
plain versions.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import serve as S  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rc = S.main(["--arch", args.arch, "--smoke", "--batch", "4",
                 "--prompt-len", "24", "--new-tokens", "12",
                 "--max-len", "128", "--device", args.device])
    assert rc == 0
    print("torch_serve_batch: OK")


if __name__ == "__main__":
    main()
