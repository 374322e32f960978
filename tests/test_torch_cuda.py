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
from repro_torch.kernels import decode_attention as KD
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


# the segment sweep's runs (KS.ITEMS) and tiles (KS.TILE), +- 1, and the
# BibSonomy table
SEG_SIZES = [1, KS.ITEMS - 1, KS.ITEMS, KS.ITEMS + 1, KS.TILE - 1, KS.TILE,
             KS.TILE + 1, 2 * KS.TILE + 1, 33 * KS.TILE - 5, 816_197]


def _seg_inputs(t, dev, p_first=0.5, seed=None):
    rng = np.random.default_rng(t if seed is None else seed)
    return (_i32(rng.integers(0, 2**32, t, dtype=np.uint64), dev),
            _i32(rng.integers(0, 2**32, t, dtype=np.uint64), dev),
            torch.from_numpy(rng.random(t) < p_first).to(dev))


def _assert_exclusive(got, args):
    want = ref.segment_reduce_ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (w.shape[0] + 1,) and g.dtype == torch.int32
        assert int(g[0]) == 0 and torch.equal(g[1:], w)


@pytest.mark.parametrize("t", SEG_SIZES)
def test_segment_reduce_kernel_exclusive_at_tile_bounds(cuda, t):
    """The (T + 1) entry at the runs' and tiles' bounds: element 0 zero,
    then the plain inclusive sums, element T the total."""
    args = _seg_inputs(t, cuda)
    assert KS.plan(t, True) == KS.Plan("vector", -(-t // KS.TILE))
    _assert_exclusive(KS.segment_reduce_exclusive(*args), args)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("t", [1, KS.TILE + 1, 70_001])
def test_segment_reduce_kernel_views_off_16_bytes(cuda, t, offset):
    """Inputs that start off 16 bytes take the scalar-load path, which the
    C entry would refuse as a vector plan."""
    base = _seg_inputs(t + offset, cuda)
    args = tuple(x[offset:] for x in base)
    assert KS.plan(t, all(x.data_ptr() % 16 == 0 for x in args)).path == \
        "scalar"
    _assert_exclusive(KS.segment_reduce_exclusive(*args), args)
    got = KS.segment_reduce(*args)
    want = ref.segment_reduce_ref(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("p_first", [0.0, 1.0])
@pytest.mark.parametrize("t", [KS.TILE + 3, 816_197])
def test_segment_reduce_kernel_no_first_and_all_first(cuda, t, p_first):
    args = _seg_inputs(t, cuda, p_first)
    got = KS.segment_reduce_exclusive(*args)
    _assert_exclusive(got, args)
    assert int(got[2][-1]) == (t if p_first else 0)


def test_segment_reduce_kernel_wraparound_and_repeats(cuda):
    """0xFFFFFFFF weights wrap mod 2**32 across many tiles, and three calls
    give the same bits (the scratch is zeroed by every call's memset)."""
    t = 816_197
    ones = torch.full((t,), -1, dtype=torch.int32, device=cuda)
    all_first = torch.ones((t,), dtype=torch.bool, device=cuda)
    got = KS.segment_reduce_exclusive(ones, ones, all_first)
    want = np.concatenate([np.zeros(1, np.uint64),
                           np.cumsum(np.full(t, 0xFFFFFFFF, np.uint64))])
    np.testing.assert_array_equal(got[0].cpu().numpy().view(np.uint32),
                                  want.astype(np.uint32))
    args = _seg_inputs(t, cuda, seed=5)
    first = KS.segment_reduce_exclusive(*args)
    for _ in range(3):
        again = KS.segment_reduce_exclusive(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    _assert_exclusive(first, args)


def test_masked_prefix_on_the_card_runs_no_cat(cuda, monkeypatch):
    """``core.pipeline.masked_prefix`` takes the kernel's (T + 1) buffers
    as they are: no ``torch.cat`` runs, and they equal the plain path's."""
    from repro_torch.core import pipeline as P
    args = _seg_inputs(70_001, cuda, p_first=0.3)
    want = P.masked_prefix(*args, use_kernels=False)
    before = KS.segment_reduce.launches

    def no_cat(*a, **k):
        raise AssertionError("torch.cat ran in masked_prefix on the card")
    monkeypatch.setattr(torch, "cat", no_cat)
    got = P.masked_prefix(*args)
    monkeypatch.undo()
    assert KS.segment_reduce.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("vector", [True, False])
def test_segment_reduce_kernel_config(cuda, vector):
    """The built sweep's constants are the plan's, and each variant stays
    in registers (no local memory, no spills)."""
    cfg = KS.kernel_config(vector)
    assert (cfg["threads"], cfg["items"], cfg["tile"], cfg["lanes"],
            cfg["lookback"]) == (KS.THREADS, KS.ITEMS, KS.TILE, KS.LANES,
                                 KS.LOOKBACK)
    assert 0 < cfg["registers"] <= 255 and cfg["local_bytes"] == 0


def _hist_words(keys, nw, dev):
    if nw == 2:
        return [_i32(keys >> np.uint64(32), dev),
                _i32(keys & np.uint64(0xFFFFFFFF), dev)]
    return [_i32(keys & np.uint64(0xFFFFFFFF), dev)]


def _hist_check(words, shifts, widths):
    got = KR.radix_histogram(words, shifts, widths)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.radix_histogram_ref(words, shifts, widths))
    assert int(got.sum()) == words[0].shape[0] * len(shifts)


@pytest.mark.parametrize("t", [1, 3, 4, 5, 4097, 135_171, 816_197])
@pytest.mark.parametrize("nw", [1, 2])
def test_radix_histogram_kernel_all_keys_equal(cuda, t, nw):
    """Every key equal, the worst contention for the shared atomics, in
    every pass of 8-bit digits, with T mod 4 = 1, 3, 0."""
    keys = np.full(t, 0x0123456789ABCDEF, np.uint64)
    npass = 4 * nw
    _hist_check(_hist_words(keys, nw, cuda), [8 * p for p in range(npass)],
                [8] * npass)


@pytest.mark.parametrize("npass", range(1, 9))
@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("t", [7, 70_001])
def test_radix_histogram_kernel_passes_and_narrow_widths(cuda, npass, nw, t):
    """1-8 passes (1-4 on one word) of widths 1-8, skewed keys."""
    npass = min(npass, 4 * nw)
    rng = np.random.default_rng(npass * 10 + nw)
    keys = rng.integers(0, 2**63, t, dtype=np.uint64)
    keys[: t // 2] = keys[0]
    widths = [1 + (p * 3 + npass) % 8 for p in range(npass)]
    shifts, at = [], 0
    for w in widths:
        shifts.append(at)
        at += w
    _hist_check(_hist_words(keys, nw, cuda), shifts, widths)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("t", [5, 4099, 816_197])
@pytest.mark.parametrize("nw", [1, 2])
def test_radix_histogram_kernel_views_off_16_bytes(cuda, t, offset, nw):
    """Key words that start off 16 bytes take the scalar-load path, at
    T mod 4 = 1 and 3 too; an aligned hi with an unaligned lo as well."""
    rng = np.random.default_rng(t + offset)
    keys = rng.integers(0, 2**44, t + offset, dtype=np.uint64)
    base = _hist_words(keys, nw, cuda)
    words = [w[offset:] for w in base]
    if nw == 2:
        words[0] = words[0].clone()                 # aligned hi
    assert KR.hist_plan_for(words).path == "scalar"
    plan = RX.plan_radix(32 * nw, t, RX.HIST_DIGIT_BITS)
    _hist_check(words, plan.shifts, plan.widths)


@pytest.mark.parametrize("vector", [True, False])
@pytest.mark.parametrize("words", [1, 2])
def test_radix_histogram_kernel_config(cuda, vector, words):
    """The built sweep's constants are the plan's, and each variant stays
    in registers (no local memory, no spills)."""
    cfg = KR.hist_kernel_config(vector, words)
    assert (cfg["threads"], cfg["blocks_per_sm"], cfg["keys"],
            cfg["unroll"], cfg["copies"], cfg["max_pass"]) == (
        KR.HIST_THREADS, KR.HIST_BLOCKS_PER_SM, KR.HIST_KEYS,
        KR.HIST_UNROLL, KR.HIST_COPIES, 8)
    assert 0 < cfg["registers"] <= 65536 // (
        KR.HIST_THREADS * KR.HIST_BLOCKS_PER_SM)
    assert cfg["local_bytes"] == 0
    plan = KR.hist_plan(816_197, vector, KD.sm_count(cuda))
    assert plan.blocks == KD.sm_count(cuda) * KR.HIST_BLOCKS_PER_SM


# the rank sweep's tiles (KR.RANK_TILE elements): one and two tiles, +- 1,
# and the BibSonomy table
RANK_SIZES = SIZES + [KR.RANK_TILE + o for o in (-1, 0, 1)] + [
    2 * KR.RANK_TILE + o for o in (-1, 1)] + [816_197]


def _starts(d):
    hist = torch.bincount(d, minlength=256).to(torch.int32)
    return torch.cumsum(hist, 0, dtype=torch.int32) - hist


@pytest.mark.parametrize("t", RANK_SIZES)
@pytest.mark.parametrize("skew", [False, True])
def test_radix_rank_kernel(cuda, t, skew):
    """One launch, bit-equal to the plain ranks; ``skew``: 90% of the
    digits equal."""
    rng = np.random.default_rng(t)
    dig = rng.integers(0, 256, t).astype(np.int32)
    if skew:
        dig[rng.random(t) < 0.9] = 7
    d = torch.from_numpy(dig).to(cuda)
    starts = _starts(d)
    before = KR.radix_rank.launches
    got = KR.radix_rank(d, starts)
    torch.cuda.synchronize()
    assert KR.radix_rank.launches == before + 1
    assert torch.equal(got, ref.radix_rank_ref(d, starts))


@pytest.mark.parametrize("t", [1, KR.RANK_TILE + 1, 816_197])
@pytest.mark.parametrize("digit", [0, 255])
def test_radix_rank_kernel_all_digits_equal(cuda, t, digit):
    """Every tile publishes 0 for 255 digits and the whole count for one:
    the longest look-back chains land on one digit."""
    d = torch.full((t,), digit, dtype=torch.int32, device=cuda)
    starts = _starts(d)
    got = KR.radix_rank(d, starts)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.arange(t, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("t", [1, 2049, KR.RANK_TILE + 1,
                               2 * KR.RANK_TILE - 1, 70_001, 816_197])
@pytest.mark.parametrize("live,shift", [(31, 0), (31, 24), (44, 0),
                                        (44, 28), (44, 36), (64, 56)])
@pytest.mark.parametrize("with_perm", [False, True])
def test_radix_pass_kernel(cuda, t, live, shift, with_perm):
    """The fused pass (digit in the kernel, words and payload scattered to
    their ranks) equals its plain version bit for bit: one and two words,
    digits in the low word, straddling the two, in the high word; the
    payload given or the identity."""
    rng = np.random.default_rng(t + live + shift)
    keys = rng.integers(0, 2**min(live, 63), t, dtype=np.uint64)
    keys[: t // 4] = keys[0]                              # ties
    words = ([_i32(keys >> np.uint64(32), cuda),
              _i32(keys & np.uint64(0xFFFFFFFF), cuda)] if live > 32
             else [_i32(keys, cuda)])
    width = min(8, live - shift)
    d = RX.extract_digit(words, shift, width)
    starts = _starts(d)
    perm = (torch.from_numpy(rng.permutation(t).astype(np.int32)).to(cuda)
            if with_perm else None)
    before = KR.radix_rank.launches
    got_w, got_p = KR.radix_pass(words, perm, shift, width, starts)
    torch.cuda.synchronize()
    assert KR.radix_rank.launches == before + 1
    want_w, want_p = ref.radix_pass_ref(words, perm, shift, width, starts)
    assert torch.equal(got_p, want_p)
    assert len(got_w) == len(words)
    for g, w in zip(got_w, want_w):
        assert torch.equal(g, w)


def test_radix_sort_perm_on_the_card_is_the_stable_sort(cuda):
    """Full-size BibSonomy-shaped Stage-1 keys (44 bits, 2 words, 6
    passes) and random 64-bit Stage-3 signature pairs (8 passes) against
    ``torch.sort(stable=True)`` of the words' order key, with the sorted
    words out of the last pass; a truncated schedule against the CPU."""
    from repro_torch.core import keys as K
    ctx = S.bibsonomy_like()
    plan = K.plan_context_keys(ctx.sizes, with_values=False)[0]
    bib = plan.pack_device(torch.from_numpy(ctx.tuples).to(cuda))
    rng = np.random.default_rng(64)
    sig = [_i32(rng.integers(0, 2**32, ctx.num_tuples, dtype=np.uint64),
                cuda) for _ in range(2)]
    sig[0][: 1000] = sig[0][0]                           # ties in hi
    for words, live in ((bib, plan.total_bits), (sig, 64)):
        iota = torch.arange(words[0].shape[0], dtype=torch.int32,
                            device=cuda)
        before = KR.radix_rank.launches
        s_words, (perm,) = RX.sort_with_payload_radix(words, (iota,), live)
        torch.cuda.synchronize()
        assert KR.radix_rank.launches - before == -(-live // 8)
        want = torch.sort(K.word_key(words), stable=True).indices
        assert torch.equal(perm.long(), want)
        assert torch.equal(RX.radix_sort_perm(words, live), perm)
        for s_, w in zip(s_words, words):
            assert torch.equal(s_, w[want])
        for k in (1, 3):
            got = RX.radix_sort_perm(words, live, max_passes=k)
            cpu = RX.radix_sort_perm([w.cpu() for w in words], live,
                                     max_passes=k)
            assert torch.equal(got.cpu(), cpu)


def test_pipeline_on_the_card_equals_the_cpu(cuda):
    ctx = S.imdb_like()
    ops.reset_launch_counts()
    got = BatchMiner(ctx.sizes, device="cuda")(ctx.tuples)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ops.PATH_KERNELS["mining"]), counts
    assert all(n == 0 for k, n in counts.items()
               if k not in ops.PATH_KERNELS["mining"]), counts
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


FA_CASES = [  # b, hq, hkv, sq, skv, d, causal, window, q_offset
    (1, 4, 4, 128, 128, 64, True, None, None),
    (2, 8, 2, 128, 256, 64, True, None, None),
    (1, 4, 1, 64, 128, 128, True, None, None),
    (1, 2, 2, 200, 200, 32, True, None, None),
    (2, 6, 2, 96, 96, 16, True, None, None),
    (1, 2, 2, 256, 256, 64, False, 32, None),
    (1, 2, 2, 256, 256, 64, True, 128, None),
    (1, 2, 2, 256, 256, 64, False, None, None),
    (1, 4, 2, 64, 300, 128, True, 48, 236),
    (1, 3, 1, 130, 70, 32, False, None, -10),
    # Sq not a multiple of the 64-row query tile, at each head dim
    (1, 4, 2, 100, 100, 16, True, None, None),
    (2, 4, 4, 190, 300, 32, True, None, None),
    (1, 6, 2, 257, 257, 64, True, 100, None),
    (1, 4, 1, 65, 65, 128, False, None, None),
]


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, case, dtype):
    from repro_torch.kernels import flash_attention as KF
    b, hq, hkv, sq, skv, d, causal, window, q_offset = case
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype) for s in ((b, hq, sq, d), (b, hkv, skv, d),
                                          (b, hkv, skv, d)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = KF.flash_attention.launches
    got = KF.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert KF.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:   # P enters the tensor cores as bf16: the float64 gate
        assert ref.flash_bf16_gate(got, q, k, v, **kw) <= 1.0


def test_flash_attention_kernel_bf16_views_off_16_bytes(cuda):
    """The bf16 kernel copies 16-byte chunks: contiguous views that start
    one element past a 16-byte boundary are copied by the wrapper and give
    the aligned inputs' result."""
    from repro_torch.kernels import flash_attention as KF
    rng = np.random.default_rng(7)
    shapes = ((2, 6, 130, 64), (2, 2, 130, 64), (2, 2, 130, 64))
    flat = [torch.from_numpy(rng.standard_normal(int(np.prod(sh)) + 1)
                             .astype(np.float32)).to(cuda, torch.bfloat16)
            for sh in shapes]
    q, k, v = (f[1:].view(sh) for f, sh in zip(flat, shapes))
    assert all(x.data_ptr() % 16 and x.is_contiguous() for x in (q, k, v))
    got = KF.flash_attention(q, k, v)
    assert torch.equal(got, KF.flash_attention(q.clone(), k.clone(),
                                               v.clone()))
    assert ref.flash_bf16_gate(got, q, k, v) <= 1.0


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x7b"])
def test_routing_on_the_card_equals_the_cpu(cuda, arch):
    """fp32 smoke routing pass through the kernel: the same routes as the
    plain CPU run."""
    import copy
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.api import get_model
    from repro_torch.models.telemetry import collect_moe_routing
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              attn_impl="pallas")
    cpu = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    toks = TokenPipeline(cfg, 4, 64, seed=0).batch_at(0)["tokens"]
    ops.reset_launch_counts()
    got = collect_moe_routing(cfg, card, toks)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    np.testing.assert_array_equal(got, collect_moe_routing(cfg, cpu, toks))


SIG_SHAPES = [(8, 128), (16, 512), (256, 1024), (3, 77), (1, 1), (33, 15),
              (70, 6040), (9, 4099), (1000, 22),
              (5, 60_001)]    # above SMEM_COLS: r read from global memory


@pytest.mark.parametrize("t,e", SIG_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_signature_kernel(cuda, t, e, dtype):
    from repro_torch.kernels import signature as KSig
    rng = np.random.default_rng(t * e)
    mask = torch.from_numpy(rng.integers(0, 2, (t, e))).to(cuda, dtype)
    r = _i32(rng.integers(1, 2**32, e, dtype=np.uint64), cuda)
    before = KSig.signature.launches
    got = KSig.signature(mask, r)
    torch.cuda.synchronize()
    assert KSig.signature.launches == before + 1
    assert torch.equal(got, ref.signature_ref(mask, r))


def test_signature_kernel_wraparound_and_unaligned_rows(cuda):
    """uint32 wraparound, and rows that start off a 16-byte boundary (a
    slice of a wider mask keeps its row stride; a contiguous copy of an
    odd-width mask starts each row at t * E bytes)."""
    from repro_torch.kernels import signature as KSig
    rng = np.random.default_rng(1)
    e = 1001
    r_np = (2**32 - 1 - rng.integers(0, 8, e)).astype(np.uint64)
    r = _i32(r_np, cuda)
    mask = torch.ones((67, e), dtype=torch.bool, device=cuda)
    mask[5, ::3] = False
    got = KSig.signature(mask, r)
    want = (mask.cpu().numpy().astype(np.uint64) * r_np).sum(1) % 2**32
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  want.astype(np.uint32))
    assert torch.equal(got, ref.signature_ref(mask, r))
    sub = mask[:, 3:].contiguous()
    assert torch.equal(KSig.signature(sub, r[3:].contiguous()),
                       ref.signature_ref(sub, r[3:]))


def test_signature_kernel_past_int32_offsets(cuda):
    """T·E above 2**31: the row offsets are 64-bit."""
    from repro_torch.kernels import signature as KSig
    t, e = 262_200, 8192                    # 2,147,942,400 mask bytes
    if torch.cuda.mem_get_info()[0] < 12 * 2**30:
        pytest.skip("needs 12 GiB of free device memory")
    g = torch.Generator(device=cuda).manual_seed(0)
    mask = torch.randint(0, 2, (t, e), generator=g, device=cuda,
                         dtype=torch.uint8)
    r = torch.randint(-2**31, 2**31 - 1, (e,), generator=g, device=cuda,
                      dtype=torch.int32)
    got = KSig.signature(mask, r)
    assert t * e > 2**31
    assert torch.equal(got, ref.signature_ref(mask, r))
    assert torch.equal(got[-3:], ref.signature_ref(mask[-3:], r))


# The tensor-core kernel's edges (kernels/tricluster_density.Plan): M % 16
# != 0 (Y by byte loads) and M % 32 != 0, M < 32; G·B off the 128-column
# tile, B not dividing 128 and B above it (the b range wraps); T off the
# 128-row tile and T = 1; K loops of 1, 2, STAGES = 3 and STAGES + 1 = 4
# chunks of 128 bytes; two raster groups of t-tiles; the MovieLens width
# M = 3952.
TD_SHAPES = [(8, 16, 16, 8), (16, 8, 32, 128), (7, 5, 9, 3),
             (70, 4100, 3, 33), (65, 40, 33, 97), (250, 700, 22, 64),
             (1, 1, 1, 1), (6, 7, 8, 1000),
             (9, 50, 4, 40), (5, 48, 3, 20), (6, 20, 7, 10),
             (37, 70, 3, 130), (20, 33, 7, 129), (3, 40, 150, 17),
             (11, 64, 5, 1), (11, 128, 5, 300), (4, 200, 3, 9),
             (4, 320, 3, 9), (4, 512, 3, 9),
             (2, 16, 2, 2100), (60, 3952, 5, 3000)]


@pytest.mark.parametrize("g,m,b,t", TD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_tricluster_density_kernel(cuda, g, m, b, t, dtype):
    from repro_torch.kernels import tricluster_density as KTD
    rng = np.random.default_rng(g + m + b + t)
    tensor, x, y, z = (torch.from_numpy(rng.integers(0, 2, s)).to(cuda, dtype)
                       for s in ((g, m, b), (t, g), (t, m), (t, b)))
    before = KTD.tricluster_density.launches
    got = KTD.tricluster_density(tensor, x, y, z)
    torch.cuda.synchronize()
    assert KTD.tricluster_density.launches == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.tricluster_density_ref(tensor, x, y, z))


def test_tricluster_density_kernel_masks_off_16_bytes(cuda):
    """Masks whose base is off 16 bytes: rows sliced from row 1 (M % 16 !=
    0), and views into a flat buffer at an odd offset with M % 16 == 0;
    both take the byte-load path for Y."""
    from repro_torch.kernels import tricluster_density as KTD
    rng = np.random.default_rng(5)
    for g, m, b, t in ((9, 50, 4, 300), (13, 64, 6, 200)):
        tensor = torch.from_numpy(rng.integers(0, 2, (g, m, b))).to(
            cuda, torch.uint8)
        x, y, z = (torch.from_numpy(rng.integers(0, 2, (t + 1, n))).to(
            cuda, torch.uint8) for n in (g, m, b))
        flat = torch.from_numpy(rng.integers(0, 2, t * m + 3)).to(
            cuda, torch.uint8)
        views = ([y[1:]] if m % 16 else []) + [flat[3:].view(t, m)]
        for ym in views:
            assert ym.data_ptr() % 16 != 0 and ym.is_contiguous()
            args = (tensor, x[1:], ym, z[1:])
            assert torch.equal(KTD.tricluster_density(*args),
                               ref.tricluster_density_ref(*args))


def test_tricluster_density_kernel_all_ones_just_under_2_24(cuda):
    """G, M, B = 255, 256, 257, all ones: every numerator is exactly
    16,776,960 (just under 2**24)."""
    from repro_torch.kernels import tricluster_density as KTD
    g, m, b, t = 255, 256, 257, 3
    tensor = torch.ones((g, m, b), dtype=torch.bool, device=cuda)
    x, y, z = (torch.ones((t, n), dtype=torch.bool, device=cuda)
               for n in (g, m, b))
    got = KTD.tricluster_density(tensor, x, y, z)
    want = torch.full((t,), 16_776_960.0, device=cuda)
    assert torch.equal(got, want)
    assert torch.equal(got, ref.tricluster_density_ref(tensor, x, y, z))


def test_tricluster_density_kernel_repeats_bit_for_bit(cuda):
    """The 64-bit atomic sums give the same bits on every call."""
    from repro_torch.kernels import tricluster_density as KTD
    rng = np.random.default_rng(11)
    args = [torch.from_numpy(rng.integers(0, 2, s)).to(cuda, torch.bool)
            for s in ((300, 500, 7), (5000, 300), (5000, 500), (5000, 7))]
    first = KTD.tricluster_density(*args)
    for _ in range(3):
        assert torch.equal(KTD.tricluster_density(*args), first)
    assert torch.equal(first, ref.tricluster_density_ref(*args))


@pytest.mark.parametrize("aligned", [True, False])
def test_tricluster_density_kernel_config(cuda, aligned):
    """The built kernel's tile constants are the plan's, and two blocks of
    its shared memory fit an SM (228 KiB, 1 KiB reserved a block)."""
    from repro_torch.kernels import tricluster_density as KTD
    cfg = KTD.kernel_config(aligned)
    assert (cfg["tile_t"], cfg["tile_n"], cfg["k_chunk"], cfg["stages"],
            cfg["group_t"]) == (KTD.TILE_T, KTD.TILE_N, KTD.K_CHUNK,
                                KTD.STAGES, KTD.GROUP_T)
    assert 2 * (cfg["smem_bytes"] + 1024) <= 228 * 1024
    assert 0 < cfg["registers"] <= 255


def test_dense_path_on_the_card(cuda):
    """IMDB: the dense path launches both dense kernels and no mining
    kernel, the mining path neither dense kernel; the kernel signatures of
    the fibers mix to the pipeline's, and the exact densities through the
    kernel equal the plain version's and the CPU's."""
    from repro_torch.core import dense_tensor, exact_density_dense, fibers
    from repro_torch.core import pipeline as P
    ctx = S.imdb_like()
    miner = BatchMiner(ctx.sizes, device="cuda")
    ops.reset_launch_counts()
    res = miner(ctx.tuples)
    counts = ops.launch_counts()
    assert all(counts[k] == 0 for k in ops.PATH_KERNELS["dense"]), counts
    ops.reset_launch_counts()
    tup = torch.from_numpy(ctx.tuples).to(cuda)
    tens = dense_tensor(tup, ctx.sizes)
    masks = fibers(tens, tup)
    sig = P.mix_signatures(
        [ops.set_signature(m, r) for m, r in zip(masks, miner._lo)],
        [ops.set_signature(m, r) for m, r in zip(masks, miner._hi)])
    dens = exact_density_dense(tens, masks)
    counts = ops.launch_counts()
    assert counts["signature"] == 6 and counts["tricluster_density"] == 1
    assert all(counts[k] == 0 for k in ops.PATH_KERNELS["mining"]), counts
    assert torch.equal(sig[0], res.sig_lo) and torch.equal(sig[1], res.sig_hi)
    assert torch.equal(dens, exact_density_dense(tens, masks,
                                                 use_kernels=False))
    cpu = torch.from_numpy(ctx.tuples)
    ctens = dense_tensor(cpu, ctx.sizes)
    assert torch.equal(dens.cpu(), exact_density_dense(ctens,
                                                       fibers(ctens, cpu)))


DECODE_CASES = [  # b, hq, hkv, s, d, kv_len, window
    (2, 4, 2, 512, 64, 512, None),
    (1, 8, 8, 1024, 64, 700, None),
    (2, 4, 1, 512, 128, 512, 128),
    (1, 2, 2, 300, 32, 300, None),
    (2, 6, 2, 100, 16, 37, 8),
    (1, 32, 8, 200, 80, 200, 64),
    (4, 24, 8, 4096, 64, 2049, None),
    (1, 64, 1, 70, 128, 1, None),
    (33, 16, 8, 512, 64, 500, None),      # B·Hkv 264: one split
    (2, 32, 8, 2048, 80, 2000, 1500),     # D 80, split, window mid-tile
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "ring view"])
def test_decode_attention_kernel(cuda, case, dtype, layout):
    from repro_torch.kernels import decode_attention as KD
    b, hq, hkv, s, d, kv_len, window = case
    rng = np.random.default_rng(s + d + kv_len)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32)
                         ).to(cuda, dtype)
    if layout == "contiguous":
        k, v = (torch.from_numpy(rng.standard_normal((b, hkv, s, d))
                                 .astype(np.float32)).to(cuda, dtype)
                for _ in range(2))
    else:   # a (B, S, Hkv, D) cache read through a permuted view
        k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, d))
                                 .astype(np.float32)).to(cuda, dtype)
                .permute(0, 2, 1, 3) for _ in range(2))
    before = KD.decode_attention.launches
    got = KD.decode_attention(q, k, v, kv_len=kv_len, window=window)
    torch.cuda.synchronize()
    assert KD.decode_attention.launches == before + 1
    want = ref.decode_attention_ref(q, k, v, kv_len=kv_len, window=window)
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-2, 4e-3)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_lse(cuda, case, dtype):
    """``return_lse``: the fp32 log-sum-exp of the scaled scores beside O
    (written by the one-split kernel, or by the combine after a split),
    against the plain version; the same O as without it.  Both evaluate
    the scores in fp32 from the same inputs, so the lse is held to 2e-5
    (relative and absolute) in both dtypes."""
    b, hq, hkv, s, d, kv_len, window = case
    rng = np.random.default_rng(s + d + kv_len + 1)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32)
                         ).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, d))
                             .astype(np.float32)).to(cuda, dtype)
            .permute(0, 2, 1, 3) for _ in range(2))
    before = KD.decode_attention.launches
    o, lse = KD.decode_attention(q, k, v, kv_len=kv_len, window=window,
                                 return_lse=True)
    plain = KD.decode_attention(q, k, v, kv_len=kv_len, window=window)
    torch.cuda.synchronize()
    assert KD.decode_attention.launches == before + 2
    assert torch.equal(o, plain)
    wo, wl = ref.decode_attention_ref(q, k, v, kv_len=kv_len, window=window,
                                      return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq)
    torch.testing.assert_close(lse, wl, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_empty_block(cuda, dtype):
    """A block of a sharded ring with no filled slot (``kv_len`` 0):
    o = 0 and lse = -inf, as the plain version gives, with no launch."""
    q = torch.randn((4, 24, 64), device=cuda).to(dtype)
    k = torch.randn((4, 8, 128, 64), device=cuda).to(dtype)
    before = KD.decode_attention.launches
    o, lse = KD.decode_attention(q, k, k, kv_len=0, return_lse=True)
    assert KD.decode_attention.launches == before
    wo, wl = ref.decode_attention_ref(q, k, k, kv_len=0, return_lse=True)
    assert torch.equal(o, wo) and torch.equal(lse, wl)
    assert torch.isneginf(lse).all() and not o.any()
    with pytest.raises(ValueError, match="kv_len"):
        KD.decode_attention(q, k, k, kv_len=0)


@pytest.mark.parametrize("k_splits,offset", [(8, -1), (8, 1), (1, -1),
                                             (1, 1), (3, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_at_split_boundaries(cuda, k_splits, offset,
                                                     dtype):
    """kv_len = k·splitlen ± 1 over the serving shape's ring view, where
    splitlen is the key span of one split on this card (256 on an H100):
    the last split holds one key, or one tile falls one key short."""
    from repro_torch.kernels import decode_attention as KD
    b, hq, hkv, s, d = 4, 24, 8, 4096, 64
    _, per, _ = KD.split_plan(2049, None, b * hkv, KD.sm_count(cuda))
    kv_len = k_splits * per * KD.KEY_TILE + offset
    rng = np.random.default_rng(kv_len)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32)
                         ).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, d))
                             .astype(np.float32)).to(cuda, dtype)
            .permute(0, 2, 1, 3) for _ in range(2))
    got = KD.decode_attention(q, k, v, kv_len=kv_len)
    want = ref.decode_attention_ref(q, k, v, kv_len=kv_len)
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2 ** -7, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_unaligned_cache_view(cuda, dtype):
    """A cache view that starts one element past a 16-byte boundary takes
    the kernel's scalar copy path into the same ring, across splits."""
    from repro_torch.kernels import decode_attention as KD
    b, hq, hkv, s, d, kv_len = 4, 24, 8, 1024, 64, 1000
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32)
                         ).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal(b * s * hkv * d + 1)
                             .astype(np.float32)).to(cuda, dtype)[1:]
            .view(b, s, hkv, d).permute(0, 2, 1, 3) for _ in range(2))
    assert not KD._vec16(k, v)
    assert KD.split_plan(kv_len, None, b * hkv, KD.sm_count(cuda))[2] > 1
    got = KD.decode_attention(q, k, v, kv_len=kv_len)
    want = ref.decode_attention_ref(q, k, v, kv_len=kv_len)
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2 ** -7, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 128), (256, 512),
                                   (5, 96), (8184, 1536), (3, 8192),
                                   (7, 1025), (1000, 24, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel(cuda, shape, dtype, w_dtype):
    from repro_torch.kernels import rmsnorm as KN
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(cuda, dtype)
    w = (torch.from_numpy(rng.standard_normal(shape[-1:]).astype(np.float32))
         + 1.0).to(cuda, w_dtype)
    before = KN.rmsnorm.launches
    got = ops.rmsnorm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert KN.rmsnorm.launches == before + 1
    want = ref.rmsnorm_ref(x, w, 1e-5)
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-2, 4e-3)
    assert got.dtype == dtype and got.shape == shape
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("rows,d,dtype,offset,path", [
    (4, 1536, torch.bfloat16, 0, "vector"),      # a decode step's norm
    (8184, 1536, torch.bfloat16, 0, "vector"),   # a prefill norm
    (4, 1536, torch.float32, 0, "vector"),
    (8184, 1536, torch.float32, 0, "vector"),
    (7, 64, torch.float32, 0, "vector"),
    (5, 1535, torch.bfloat16, 0, "block"),
    (5, 1535, torch.float32, 0, "block"),
    (4, 1536, torch.bfloat16, 1, "block"),       # 2 bytes off 16
    (300, 512, torch.float32, 1, "warp"),        # 4 bytes off 16
    (3, 8192, torch.bfloat16, 0, "block"),
    (9, 100, torch.bfloat16, 0, "warp"),
])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_paths(cuda, rows, d, dtype, offset, path, w_dtype):
    """Each call takes the path ``rmsnorm.plan`` names (granite-moe's
    D 1536 the vector path; an odd D, a storage offset off 16 bytes and
    D 8192 the scalar kernels) and stays within the tolerances of
    :func:`test_rmsnorm_kernel`."""
    from repro_torch.kernels import rmsnorm as KN
    rng = np.random.default_rng(rows + d + offset)
    flat = torch.from_numpy(rng.standard_normal(rows * d + offset)
                            .astype(np.float32)).to(cuda, dtype)
    x = flat[offset:].view(rows, d)
    w = (torch.from_numpy(rng.standard_normal(d).astype(np.float32))
         + 1.0).to(cuda, w_dtype)
    assert KN.plan_for(x, w).path == path
    before = dict(KN.rmsnorm.path_launches)
    got = KN.rmsnorm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in KN.rmsnorm.path_launches.items()
            } == {k: int(k == path) for k in before}
    want = ref.rmsnorm_ref(x, w, 1e-5)
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-2, 4e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_rank_and_rmsnorm_kernel_config(cuda):
    """The built kernels' constants are the wrappers' (also checked when
    each library loads)."""
    from repro_torch.kernels import rmsnorm as KN
    assert KR.kernel_config() == {"tile": KR.RANK_TILE,
                                  "threads": KR.RANK_THREADS,
                                  "warps": KR.RANK_WARPS,
                                  "lookback": KR.LOOKBACK}
    cfg = KN.kernel_config()
    assert (cfg["threads"], cfg["vec_max_d"], cfg["lane_vectors"]) == (
        KN.THREADS, KN.VEC_MAX_D, KN.LANE_VECTORS)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-0.6b",
                                  "h2o-danube-1.8b", "mixtral-8x7b"])
def test_serving_on_the_card_equals_the_cpu(cuda, arch):
    """fp32 smoke serving with both kernel switches on.  The prefill, and
    each of 48 decode steps started on the card from a copy of the CPU's
    cache (the windowed rings wrap), give the CPU's logits and cache
    within the model-parity tolerance (rtol 2e-4, atol 2e-4 or 2e-5 of
    the largest logit: fp32 sums in another order on each side); the card
    launches both kernels at every layer; ``ServeEngine`` on the card
    generates the CPU's greedy tokens."""
    import copy
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import get_model
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              attn_impl="pallas", use_pallas=True)
    model = get_model(cfg)
    cpu = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (3, 40))

    def close(got, want):
        atol = max(2e-4, 2e-5 * float(want.float().abs().max()))
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=atol)

    ops.reset_launch_counts()
    cache_c, lc = model.prefill(cfg, card, {"tokens": toks}, 128)
    cache_h, lh = model.prefill(cfg, cpu, {"tokens": toks}, 128)
    close(lc, lh)
    for _ in range(48):
        t = rng.integers(1, cfg.vocab_size, 3)
        cache_c = {k: v.to(cuda) for k, v in cache_h.items()}
        cache_c, lc = model.decode_step(cfg, card, cache_c, t)
        cache_h, lh = model.decode_step(cfg, cpu, cache_h, t)
        close(lc, lh)
        for k in cache_h:
            close(cache_c[k], cache_h[k])
    counts = ops.launch_counts()
    assert counts["decode_attention"] == 48 * cfg.n_layers
    norms = cfg.n_layers * (2 + 2 * cfg.qk_norm) + 1
    assert counts["rmsnorm"] == 49 * norms
    prompts = [list(range(1, 30)), [5, 6, 7], list(range(9, 20))]
    got = ServeEngine(cfg, card, max_len=128).generate(prompts, 12)
    want = ServeEngine(cfg, cpu, max_len=128).generate(prompts, 12)
    assert got.tokens == want.tokens


# ---------------------------------------------------------------------------
# Out-of-core and streaming mining on the card
# ---------------------------------------------------------------------------

def _path_counts():
    counts = ops.launch_counts()
    return {k: counts[k] for k in ops.PATH_KERNELS["mining"]}


def _equal_leaves(a, b):
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert torch.equal(x.cpu(), y.cpu()), name


# odd budgets: single partial tiles of the segment sweep (1, 3), T mod 4
# != 0 windows for the histogram's scalar tail (1021, 2049), one window
# past the rank sweep's tile (4099) and a budget above T
WINDOW_CASES = [("random", 1), ("random", 3), ("random", 7),
                ("bibsonomy", 1021), ("bibsonomy", 2049),
                ("bibsonomy", 4099), ("bibsonomy", 1 << 20),
                ("movielens", 1021), ("movielens", 4099)]


def _window_ctx(name):
    if name == "random":
        return S.random_context((9, 7, 5), 300, seed=3), None
    if name == "bibsonomy":
        return S.bibsonomy_like(scale=0.01), None
    return S.movielens_like(n_tuples=6000, seed=2).deduplicated(), 1.0


@pytest.mark.parametrize("name,budget", WINDOW_CASES)
def test_windowed_on_the_card_equals_the_cpu(cuda, name, budget):
    """``mine_windowed`` through the kernels at odd budgets gives the CPU
    (plain) result and the card's in-core result, with one
    ``segment_reduce`` launch per mode and window and one Stage-3 sort
    (a histogram and 8 fused passes) per window."""
    from repro_torch.core import memprobe as MP
    ctx, delta = _window_ctx(name)
    args = (ctx.tuples,) if delta is None else (ctx.tuples, ctx.values)
    make = (lambda d: BatchMiner(ctx.sizes, device=d)) if delta is None \
        else (lambda d: NOACMiner(ctx.sizes, delta=delta, device=d))
    card, cpu = make("cuda"), make("cpu")
    kw = {} if delta is None else {"values": ctx.values}
    probe = MP.MemProbe("cuda")
    ops.reset_launch_counts()
    got = card.mine_windowed(ctx.tuples, window_budget=budget, probe=probe,
                             **kw)
    windows = RX.plan_windows(ctx.num_tuples, budget).n_windows
    assert _path_counts() == {"segment_reduce": 3 * windows,
                              "radix_histogram": windows,
                              "radix_rank": 8 * windows}
    assert sorted(probe.stages) == ["stage1_scan", "stage2_mix",
                                    "stage3_sort"]
    _equal_leaves(got, cpu.mine_windowed(ctx.tuples, window_budget=budget,
                                         **kw))
    _equal_leaves(got, card(*args))
    ops.reset_launch_counts()
    _equal_leaves(card.mine_chunked(ctx.tuples, chunk_budget=budget, **kw),
                  got)
    assert _path_counts() == {"segment_reduce": 3, "radix_histogram": 1,
                              "radix_rank": 8}


@pytest.mark.parametrize("budget", [None, 3, 1021])
@pytest.mark.parametrize("variant", ["prime", "noac"])
def test_streaming_on_the_card_equals_the_cpu(cuda, variant, budget):
    """A stream of adds, upserts and deletes: every snapshot on the card
    (incremental, windowed and ``full_remine``) equals the CPU's."""
    from repro_torch.core import StreamingMiner
    ctx = S.random_context((9, 7, 5), 400, seed=8, values=True)
    ctx = ctx.deduplicated()
    kw = {} if variant == "prime" else {"delta": 50.0}
    card = StreamingMiner(ctx.sizes, window_budget=budget, device="cuda",
                          **kw)
    cpu = StreamingMiner(ctx.sizes, device="cpu", **kw)
    rng = np.random.default_rng(1)
    for lo in range(0, ctx.num_tuples, 97):
        for m in (card, cpu):
            m.add(ctx.tuples[lo:lo + 97], ctx.values[lo:lo + 97])
        ops.reset_launch_counts()
        got = card.snapshot()
        cap = len(got.keep)
        windows = RX.plan_windows(cap, budget).n_windows
        assert _path_counts() == {"segment_reduce": 3 * windows,
                                  "radix_histogram": windows,
                                  "radix_rank": 8 * windows}
        _equal_leaves(got, cpu.snapshot())
    pick = rng.choice(ctx.num_tuples, 20, replace=False)
    for m in (card, cpu):
        m.upsert(ctx.tuples[pick[:10]], ctx.values[pick[:10]] + 1.0)
        m.delete(ctx.tuples[pick[10:]])
    _equal_leaves(card.snapshot(), cpu.snapshot())
    _equal_leaves(card.snapshot(full_remine=True), cpu.snapshot())


@pytest.mark.parametrize("backend", ["streaming", "distributed"])
def test_service_on_the_card_equals_the_cpu(cuda, backend, monkeypatch):
    """``TriclusterService`` on the card against the same service on the
    CPU, write for write: versions, packed signatures, scores and ranked
    hits; its re-mine thread and ``stop()`` leave no work queued; and the
    hub's stage timers synchronise the card only when a hub is set."""
    from repro_torch.core import pipeline as P
    from repro_torch.obs import Obs
    from repro_torch.serve import TriclusterService
    ctx = S.random_context((9, 7, 5), 400, seed=8)
    kw = dict(backend=backend, refresh_interval=3600.0,
              dirty_threshold=10**9, obs=Obs.create())
    card = TriclusterService(ctx.sizes, device="cuda", **kw)
    cpu = TriclusterService(ctx.sizes, device="cpu", **kw)
    assert card.device.type == "cuda" and card.device.index is not None
    rng = np.random.default_rng(4)
    ents = np.arange(-1, 12)
    for lo in range(0, ctx.num_tuples, 100):
        for svc in (card, cpu):
            svc.add(ctx.tuples[lo:lo + 100])
        got, want = card.refresh(), cpu.refresh()
        assert (got.version, got.stream_version) == (want.version,
                                                    want.stream_version)
        np.testing.assert_array_equal(got.index.packed_sigs,
                                      want.index.packed_sigs)
        np.testing.assert_array_equal(got.querier.scores,
                                      want.querier.scores)
        for q in (lambda s: s.query(k=5).hits,
                  lambda s: s.query_batch(ents, mode=0, k=3).hits[1]):
            assert [(v.signature, sc) for v, sc in q(card)] == \
                [(v.signature, sc) for v, sc in q(cpu)]
    assert got.result.keep.is_cuda or backend == "distributed"
    pick = rng.choice(ctx.num_tuples, 30, replace=False)
    card.start()
    for svc in (card, cpu):
        svc.upsert(ctx.tuples[pick[:15]])
        svc.delete(ctx.tuples[pick[15:]])
    card._wake.set()
    np.testing.assert_array_equal(card.refresh().index.packed_sigs,
                                  cpu.refresh().index.packed_sigs)
    card.stop()
    assert card.stats()["mine_errors"] == 0
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: syncs.append(device))
    miner = BatchMiner(ctx.sizes, device="cuda")
    miner(ctx.tuples)
    assert syncs == []
    miner.obs = Obs.create()
    miner(ctx.tuples)
    assert len(syncs) == 1 and P.timer_sync is not None
    assert miner.obs.metrics.histogram(
        "pipeline_stage_ms", stage="mine_monolithic").count == 1


def test_memprobe_reads_the_allocator(cuda):
    from repro_torch.core import memprobe as MP
    from repro_torch.core import pipeline as P
    x = torch.empty(1 << 20, dtype=torch.int32, device=cuda)
    assert MP.device_bytes(cuda) == torch.cuda.memory_allocated(cuda)
    probe = MP.MemProbe(cuda)
    y = torch.empty(1 << 22, dtype=torch.int32, device=cuda)
    assert probe("held") >= y.numel() * 4
    res = BatchMiner((9, 7, 5), device="cuda")(
        S.random_context((9, 7, 5), 300, seed=3).tuples)
    assert MP.measure_result_bytes(res) == sum(
        getattr(res, f).numel() * getattr(res, f).element_size()
        for f in res.__dataclass_fields__)
    assert isinstance(res, P.PipelineResult)
    del x, y


# the owner stage of the distributed shuffle: receive buffers of P x
# capacity slots, about half of them invalid, at the rank and segment
# tiles +- 1; prime keys of 33 and exactly 64 bits (the flag has no room:
# a stable two-column sort, no radix launch) and a rank-coded NOAC key
OWNER_SIZES = [KR.RANK_TILE - 1, KR.RANK_TILE + 1, KS.TILE - 1,
               KS.TILE + 1, 70_001]
OWNER_PLANS = {"prime33": ((2**11, 2**11, 2**11), False, None),
               "prime64": ((2**22, 2**21, 2**21), False, None),
               "noac_rank": ((40, 30, 5), True, 9)}


@pytest.mark.parametrize("plan_name", sorted(OWNER_PLANS))
@pytest.mark.parametrize("t", OWNER_SIZES)
def test_owner_stage_on_the_card_equals_the_plain_versions(cuda, t,
                                                           plan_name):
    from repro_torch.core import distributed as D
    from repro_torch.core import keys as K
    sizes, with_values, slots = OWNER_PLANS[plan_name]
    rng = np.random.default_rng(t)
    rows = np.stack([rng.integers(0, min(s, 64), t) for s in sizes],
                    1).astype(np.int32)
    dom = np.arange(slots, dtype=np.float32) * 0.5 if slots else None
    vals = rng.choice(dom, t) if slots else None
    plan = K.plan_context_keys(sizes, with_values, slots)[1]
    valid = rng.random(t) < 0.5
    key = np.where(valid, plan.pack_host(rows, vals, dom), np.uint64(0))
    words = ([key >> np.uint64(32)] if plan.words == 2 else []) + [
        key & np.uint64(0xFFFFFFFF)]
    recv = torch.stack([_i32(w, cuda) for w in words], 1)
    rvalid = torch.from_numpy(valid).to(cuda)
    r_lo = _i32(rng.integers(1, 2**32, sizes[1], dtype=np.uint64), cuda)
    r_hi = _i32(rng.integers(1, 2**32, sizes[1], dtype=np.uint64), cuda)
    vdom = None if dom is None else torch.from_numpy(dom).to(cuda)
    delta = 0.5 if with_values else None
    args = (recv, rvalid, plan, r_lo, r_hi, delta)
    ops.reset_launch_counts()
    got = D._owner_stage_packed(*args, value_domain=vdom)
    bits = plan.total_bits + 1
    sorts = 0 if bits > 64 else 1
    assert _path_counts() == {"segment_reduce": 1,
                              "radix_histogram": sorts,
                              "radix_rank": sorts * -(-bits // 8)}
    plain = D._owner_stage_packed(*args, use_kernels=False,
                                  value_domain=vdom)
    cpu = D._owner_stage_packed(*(a.cpu() if isinstance(a, torch.Tensor)
                                  else a for a in args),
                                value_domain=None if vdom is None
                                else vdom.cpu())
    for g, p, c in zip(got, plain, cpu):
        assert torch.equal(g, p) and torch.equal(g.cpu(), c)


def test_nccl_group_of_one_rank_equals_in_core(cuda, tmp_path):
    """The distributed backend over an NCCL group of one rank, both
    strategies and variants, against the in-core miners on the card."""
    import datetime

    import torch.distributed as dist
    from repro_torch.core import DistributedMiner
    from repro_torch.core.distributed import LEAVES
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_local_mesh(device="cuda")
        assert dist.get_backend(mesh.group) == "nccl" and not mesh.staged
        ctx = S.bibsonomy_like(scale=0.01)
        mctx = S.movielens_like(n_tuples=5000, seed=2).deduplicated()
        for c, kw, args in ((ctx, {}, (ctx.tuples,)),
                            (mctx, {"delta": 1.0},
                             (mctx.tuples, mctx.values))):
            want = (NOACMiner if kw else BatchMiner)(
                c.sizes, device="cuda", **kw)(*args)
            for strategy in ("replicate", "shuffle"):
                got = DistributedMiner(c.sizes, mesh, strategy=strategy,
                                       **kw)(*args)
                assert int(got.overflow) == 0
                assert int(got.n_clusters) == int(want.is_unique.sum())
                for name in LEAVES[:8]:
                    assert torch.equal(getattr(got, name),
                                       getattr(want, name)), name
                    assert torch.equal(getattr(got.gather(), name),
                                       getattr(want, name)), name
    finally:
        dist.destroy_process_group()


def test_card_writer_publishes_the_cpu_writers_segment(cuda):
    """A writer mining on the card publishes, write for write, the same
    shared-memory segment as the same writer on the CPU (the readback
    leaves host numpy), and a replica of it answers as the writer."""
    import os
    from repro_torch.serve import ReplicaService, TriclusterService
    from repro_torch.serve.shm import ShmPublisher, ShmReplica
    ctx = S.random_context((9, 7, 5), 300, seed=12)
    kw = dict(refresh_interval=3600.0, dirty_threshold=10**9,
              scrub_interval=0.0)
    pubs = [ShmPublisher(f"tcard{d}{os.getpid()}") for d in ("g", "c")]
    svcs = [TriclusterService(ctx.sizes, device=d, publisher=p, **kw)
            for d, p in zip(("cuda", "cpu"), pubs)]
    reps = [ShmReplica(p.prefix) for p in pubs]
    replica = None
    try:
        for lo in (0, 150):
            for svc in svcs:
                svc.add(ctx.tuples[lo:lo + 150])
                svc.refresh()
            got, want = (r.current() for r in reps)
            assert got.manifest == want.manifest
            assert {k: v for k, v in got.meta.items()
                    if k not in ("published_wall", "epoch")} == \
                {k: v for k, v in want.meta.items()
                 if k not in ("published_wall", "epoch")}
            for k in want.arrays:
                np.testing.assert_array_equal(got.arrays[k], want.arrays[k])
        replica = ReplicaService(pubs[0].prefix, scrub_interval=0).start()
        ents = np.arange(9)
        assert [(v.signature, s) for v, s in replica.query(k=6).hits] == \
            [(v.signature, s) for v, s in svcs[0].query(k=6).hits]
        assert [[(v.signature, s) for v, s in h] for h in
                replica.query_batch(ents, mode=0, k=3).hits] == \
            [[(v.signature, s) for v, s in h] for h in
             svcs[0].query_batch(ents, mode=0, k=3).hits]
    finally:
        if replica is not None:
            replica.stop()
        for r in reps:
            r.close()
        for svc in svcs:
            svc.stop()
        for p in pubs:
            p.close()
