"""The port's CUDA kernels against their plain PyTorch versions, and the
pipeline on the card against the CPU.  These need a CUDA card: they are
marked ``cuda`` and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import BatchMiner, NOACMiner
from repro_torch.core import radix as RX
from repro_torch.data import synthetic as S
from repro_torch.kernels import ops, ref
from repro_torch.kernels import radix_sort as KR
from repro_torch.kernels import segment_reduce as KS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _i32(a, dev):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32)).to(dev)


# sizes straddle the kernels' tiles (2048 and 4096 elements) and blocks
SIZES = [1, 31, 256, 2047, 2048, 2049, 4097, 70_001]


@pytest.mark.parametrize("t", SIZES)
def test_segment_reduce_kernel(cuda, t):
    rng = np.random.default_rng(t)
    w_lo = _i32(rng.integers(0, 2**32, t, dtype=np.uint64), cuda)
    w_hi = _i32(rng.integers(0, 2**32, t, dtype=np.uint64), cuda)
    first = torch.from_numpy(rng.random(t) < 0.5).to(cuda)
    got = KS.segment_reduce(w_lo, w_hi, first)
    want = ref.segment_reduce_ref(w_lo, w_hi, first)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("t", SIZES)
@pytest.mark.parametrize("live", [7, 31, 44, 64])
def test_radix_histogram_kernel(cuda, t, live):
    rng = np.random.default_rng(t + live)
    keys = rng.integers(0, 2**min(live, 63), t, dtype=np.uint64)
    words = ([_i32(keys >> np.uint64(32), cuda),
              _i32(keys & np.uint64(0xFFFFFFFF), cuda)] if live > 32
             else [_i32(keys, cuda)])
    plan = RX.plan_radix(live, t, RX.HIST_DIGIT_BITS)
    got = KR.radix_histogram(words, plan.shifts, plan.widths)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.radix_histogram_ref(words, plan.shifts,
                                                    plan.widths))


@pytest.mark.parametrize("t", SIZES)
@pytest.mark.parametrize("skew", [False, True])
def test_radix_rank_kernel(cuda, t, skew):
    rng = np.random.default_rng(t)
    dig = rng.integers(0, 256, t).astype(np.int32)
    if skew:
        dig[rng.random(t) < 0.9] = 7
    d = torch.from_numpy(dig).to(cuda)
    hist = torch.bincount(d, minlength=256).to(torch.int32)
    starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    got = KR.radix_rank(d, starts)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.radix_rank_ref(d, starts))


def test_pipeline_on_the_card_equals_the_cpu(cuda):
    ctx = S.imdb_like()
    ops.reset_launch_counts()
    got = BatchMiner(ctx.sizes, device="cuda")(ctx.tuples)
    assert min(ops.launch_counts().values()) > 0
    want = BatchMiner(ctx.sizes, device="cpu")(ctx.tuples)
    for f in got.__dataclass_fields__:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    mctx = S.movielens_like(n_tuples=5000, seed=2)
    got = NOACMiner(mctx.sizes, delta=1.0, device="cuda")(mctx.tuples,
                                                          mctx.values)
    want = NOACMiner(mctx.sizes, delta=1.0, device="cpu")(mctx.tuples,
                                                          mctx.values)
    for f in got.__dataclass_fields__:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
