"""Warm in-core mining times of the PyTorch port on one CUDA card, for one
checkout: BibSonomy prime (T = 816,197) and the MovieLens-1M shape NOAC
(delta 1), as ``chip_smoke.py`` phases 3 and 4 mine them, 15 warm runs
each after a cold one, on the host clock with ``keep`` read back.

    python3 scripts/torch_incore_turns.py CHECKOUT

To compare two checkouts on one card, run it in turns (parent, change,
change, parent) in one session; times of different cards or sessions
are not comparable.
"""
import statistics
import sys
import time


def main(root: str) -> None:
    sys.path.insert(0, root + "/src")
    import torch
    from repro_torch.core import BatchMiner, NOACMiner
    from repro_torch.data import synthetic as S
    from repro_torch.kernels import build
    build.build_all()
    bib = S.bibsonomy_like()
    ml = S.movielens_like(n_tuples=1_000_209).deduplicated()
    for name, miner, args in (
            ("prime", BatchMiner(bib.sizes, device="cuda"), (bib.tuples,)),
            ("noac", NOACMiner(ml.sizes, delta=1.0, device="cuda"),
             (ml.tuples, ml.values))):
        miner(*args).keep.cpu()
        ts = []
        for _ in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            miner(*args).keep.cpu()
            ts.append((time.perf_counter() - t0) * 1e3)
        print(f"{root} {name}: min {min(ts):.3f} median "
              f"{statistics.median(ts):.3f} ms over 15 warm runs",
              flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
