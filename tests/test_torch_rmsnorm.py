"""Parity of the port's ``kernels.ops.rmsnorm`` with the JAX package on
the CPU.  On CPU tensors the op runs its plain version
(``kernels.ref.rmsnorm_ref``); it is held against the JAX op — the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it — and
against the JAX reference, on the same inputs made from a numpy seed, at
every shape and dtype of ``tests/test_kernels.py``'s RMSNorm test and its
tolerances (fp32 2e-5, bf16 2e-2).  The CUDA kernel is held against the
plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here its wrapper's argument checks run."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as JC

from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as KN
from repro_torch.models import common as C

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, shape, dtype, w_dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1:]).astype(np.float32) + 1.0
    return ((jnp.asarray(x).astype(JDT[dtype]),
             jnp.asarray(w).astype(JDT[w_dtype])),
            (torch.from_numpy(x).to(TDT[dtype]),
             torch.from_numpy(w).to(TDT[w_dtype])))


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 128), (256, 512),
                                   (5, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_shapes(shape, dtype):
    (jx, jw), (x, w) = _inputs(sum(shape), shape, dtype)
    got = ops.rmsnorm(x, w)
    assert got.shape == shape and got.dtype == TDT[dtype]
    for want in (jops.rmsnorm(jx, jw), jref.rmsnorm_ref(jx, jw)):
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32),
                                   **TOL[dtype])
    assert torch.equal(got, ops.rmsnorm(x, w, use_kernels=False))


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6, 0.5])
def test_rmsnorm_eps_and_weight_dtype(eps, w_dtype):
    """The eps is passed through (``common.rmsnorm`` passes the model's
    ``norm_eps``; ``ops.rmsnorm`` defaults to 1e-6) and a bf16 weight is
    widened to fp32, as the JAX reference does."""
    (jx, jw), (x, w) = _inputs(7, (3, 5, 1536), "bfloat16", w_dtype)
    got = ops.rmsnorm(x, w, eps)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(jref.rmsnorm_ref(jx, jw, eps),
                                          np.float32), **TOL["bfloat16"])
    assert torch.equal(got, ref.rmsnorm_ref(x, w, eps))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_rmsnorm_through_the_op_equals_the_jax_model_rmsnorm(dtype):
    """``common.rmsnorm(use_pallas=True)`` on a CPU tensor is the op's
    plain version, and equals the JAX package's ``common.rmsnorm`` (and
    its own ``use_pallas=False`` path) on the CPU."""
    (jx, jw), (x, w) = _inputs(11, (2, 9, 4, 16), dtype)
    got = C.rmsnorm(x, w, 1e-5, use_pallas=True)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(JC.rmsnorm(jx, jw, 1e-5),
                                          np.float32), **TOL[dtype])
    assert torch.equal(got, C.rmsnorm(x, w, 1e-5))
    assert torch.equal(got, ops.rmsnorm(x, w, 1e-5))


def test_rmsnorm_kernel_refuses_what_it_does_not_take():
    x = torch.zeros(4, 64)
    w = torch.ones(64)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.rmsnorm(x, w, use_kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        KN.rmsnorm(x, w)
    with pytest.raises(ValueError, match="backward"):
        KN.rmsnorm(x.clone().requires_grad_(), w)
    with pytest.raises(ValueError, match=r"\(R, D\)"):
        KN.rmsnorm(torch.zeros(2, 4, 64), w)
    with pytest.raises(ValueError, match=r"\(R, D\)"):
        KN.rmsnorm(x, torch.ones(32))
    assert KN.rmsnorm.launches == 0


BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("d,dtype,aligned,want", [
    # granite-moe-3b-a800m's norms (D 1536), bf16 serving and fp32 checks
    (1536, BF16, True, KN.Plan("vector", 6)),
    (1536, FP32, True, KN.Plan("vector", 12)),
    # the smoke configs' widths
    (64, FP32, True, KN.Plan("vector", 1)),
    (96, BF16, True, KN.Plan("vector", 1)),
    (512, BF16, True, KN.Plan("vector", 2)),
    (1024, FP32, True, KN.Plan("vector", 8)),
    (1280, BF16, True, KN.Plan("vector", 6)),   # 5 vectors a lane: 6
    # odd widths, too wide, misaligned
    (1535, BF16, True, KN.Plan("block")),
    (1025, FP32, True, KN.Plan("block")),
    (7, FP32, True, KN.Plan("warp")),
    (100, BF16, True, KN.Plan("warp")),
    (8192, BF16, True, KN.Plan("block")),
    (2048, BF16, True, KN.Plan("block")),
    (1536, BF16, False, KN.Plan("block")),
    (512, FP32, False, KN.Plan("warp")),
])
def test_rmsnorm_plan(d, dtype, aligned, want):
    got = KN.plan(d, dtype, aligned)
    assert got == want
    if got.path == "vector":
        nvec = d * dtype.itemsize // KN.VEC_BYTES
        assert 32 * got.lane_vectors >= nvec
        smaller = [k for k in KN.LANE_VECTORS if k < got.lane_vectors]
        assert all(32 * k < nvec for k in smaller)


def test_rmsnorm_plan_of_tensors_sees_their_alignment():
    """A view whose storage offset breaks 16-byte alignment leaves the
    vector path, for x and for w."""
    for dtype in (BF16, FP32):
        x = torch.zeros(4 * 1536 + 1, dtype=dtype)
        w = torch.ones(1537, dtype=FP32)
        assert KN.plan_for(x[:-1].view(4, 1536), w[:-1]).path == "vector"
        assert KN.plan_for(x[1:].view(4, 1536), w[:-1]).path == "block"
        assert KN.plan_for(x[:-1].view(4, 1536), w[1:]).path == "block"


def test_rmsnorm_constants_match_the_kernel_source():
    """The plan's constants are the ones written in ``csrc/rmsnorm.cu``
    (on the card they are also read from the built kernel at load)."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "rmsnorm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (const("NT"), const("WARP_MAX_D"), const("VEC_MAX_D"),
            const("VEC_BYTES"), const("VEC_BLOCKS_PER_SM")) == (
        KN.THREADS, KN.WARP_MAX_D, KN.VEC_MAX_D, KN.VEC_BYTES,
        KN.VEC_BLOCKS_PER_SM)
    lanes = re.search(r"LANE_VECTORS\[\] = \{([^}]*)\}", src)[1]
    assert tuple(int(v) for v in lanes.split(",")) == KN.LANE_VECTORS
    for k in KN.LANE_VECTORS:
        assert f"case {k}: return launch_vec<T, W, {k}>" in src
