"""Quickstart on the PyTorch port: mine OAC triclusters from the
IMDB-like dataset.  The twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Builds the movies × tags × genres tricontext, runs the three-stage
pipeline (``BatchMiner``: on the card, its CUDA kernels), prints the top
patterns in the paper's §5.2 output format, and cross-checks the cluster
count against the pure-Python reference oracle.  The device defaults to
``cuda``; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import BatchMiner  # noqa: E402
from repro_torch.core import postprocess as PP  # noqa: E402
from repro_torch.core.reference import multimodal_clusters  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ctx = synthetic.imdb_like(seed=0)
    print(f"IMDB-like context: {ctx.sizes[0]} movies × {ctx.sizes[1]} tags"
          f" × {ctx.sizes[2]} genres, |I|={ctx.num_tuples}")

    miner = BatchMiner(ctx.sizes, theta=0.0, device=args.device)
    result = miner(ctx.tuples)
    n = int(result.is_unique.sum())
    print(f"three-stage pipeline: {n} unique triclusters (on "
          f"{miner.device})")

    # cross-check vs the dict-based reference (paper Alg. 2-7 semantics)
    _, unique, _, _ = multimodal_clusters(ctx)
    assert n == len(unique), (n, len(unique))
    print("reference check: OK (cluster count matches oracle)")

    clusters = miner.materialise(result, ctx.tuples)
    # rank by support (density × volume = triples covered), then density
    clusters.sort(key=lambda cd: (-cd[1] * np.prod(
        [len(c) for c in cd[0]]), -cd[1]))
    print("\ntop patterns (§5.2 format):")
    for comps, dens in clusters[:4]:
        print(PP.format_cluster(comps, names=ctx.names, density=dens))


if __name__ == "__main__":
    main()
