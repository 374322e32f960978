"""The paper's technique on the PyTorch port: mine triclusters of MoE
routing decisions.  The twin of ``examples/mine_moe_routing.py``.

    PYTHONPATH=src python examples/torch_mine_moe_routing.py \
        [--arch mixtral-8x7b] [--device cpu]

Runs ``repro_torch.launch.mine_moe_routing``: a reduced-config MoE
forward over the synthetic motif corpus, its (token × expert × layer)
routing tensor, and the OAC triclusters mined from it.  The device
defaults to ``cuda``; ``--device cpu`` runs on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import mine_moe_routing as M  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b",
                    choices=["mixtral-8x7b", "granite-moe-3b-a800m"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--theta", type=float, default=0.2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rc = M.main(["--arch", args.arch, "--batch", str(args.batch),
                 "--seq", str(args.seq), "--theta", str(args.theta),
                 "--device", args.device])
    assert rc == 0
    print("torch_mine_moe_routing: OK")


if __name__ == "__main__":
    main()
