"""Helpers shared by the parity tests of the PyTorch port
(``tests/test_torch_*.py``): numpy views of port tensors, and the
leaf-by-leaf ``PipelineResult`` comparison."""
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
