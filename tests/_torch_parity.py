"""Helpers shared by the parity tests of the PyTorch port
(``tests/test_torch_*.py``): numpy views of port tensors, the
leaf-by-leaf ``PipelineResult`` comparison, and seeded add / upsert /
delete streams."""
import dataclasses

import numpy as np
import torch


def u32(a) -> torch.Tensor:
    """Port int32 bit-pattern tensor (CPU) of a numpy/JAX uint32 array."""
    return torch.from_numpy(np.array(np.asarray(a, np.uint32)).view(np.int32))


def as_like(x: torch.Tensor, like) -> np.ndarray:
    """Port tensor as numpy, viewed as uint32 where ``like`` is uint32."""
    arr = x.detach().cpu().numpy()
    if np.asarray(like).dtype == np.uint32 and arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    return arr


def assert_same(got: torch.Tensor, want, what: str = "") -> None:
    """Bit-identical: same dtype (uint32 read through int32), same values."""
    want = np.asarray(want)
    arr = as_like(got, want)
    assert arr.dtype == want.dtype, (what, arr.dtype, want.dtype)
    np.testing.assert_array_equal(arr, want, err_msg=what)


def assert_results_identical(jax_res, torch_res) -> None:
    """Every ``PipelineResult`` leaf bit-identical (float leaves too: both
    packages compute volume and density with the same float32 ops)."""
    for f in dataclasses.fields(jax_res):
        assert_same(getattr(torch_res, f.name), getattr(jax_res, f.name),
                    f.name)


def gen_ops(rng, sizes, n_ops, valued, universe=28, max_chunk=7):
    """A seeded stream of (kind, rows, values) operations over a small
    universe of rows, so that upserts and deletes hit earlier rows."""
    rows_u = np.stack([rng.integers(0, s, universe) for s in sizes],
                      1).astype(np.int32)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["add", "add", "upsert", "delete"])
        m = int(rng.integers(1, max_chunk))
        rows = rows_u[rng.integers(0, universe, m)]
        vals = (rng.uniform(0.0, 100.0, m).astype(np.float32)
                if valued and kind != "delete" else None)
        ops.append((kind, rows, vals))
    return ops


def apply_op(target, op) -> None:
    """One operation on a ``RunStore`` or a ``StreamingMiner``."""
    kind, rows, vals = op
    if kind == "delete":
        target.delete(rows)
    else:
        getattr(target, kind)(rows, vals)
