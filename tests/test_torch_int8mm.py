"""The int8 matmul's plain version (azoom_torch.kernels.int8_mm_kernel) is
exact: held to numpy's int64 product at small shapes, including the int8
extremes. On a CPU tensor the wrapper is the plain version. The CUDA kernel
itself is held against it on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from azoom_torch import kernels
from azoom_torch.kernels.int8_mm_kernel import (
    MICROBENCH_SHAPES,
    int8_mm,
    int8_mm_plain,
    supported_shape,
)


@pytest.mark.parametrize("shape", [(1, 1, 1), (37, 64, 5), (256, 576, 64), (128, 4608, 128)])
def test_plain_is_exact(shape):
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    x[0, :] = -128  # the extreme partial sums
    w[:, 0] = -128
    got = int8_mm_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ w.astype(np.int64))


def test_cpu_wrapper_is_the_plain_version():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-127, 128, (256, 128)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (128, 64)).astype(np.int8))
    before = dict(kernels.launches)
    assert torch.equal(int8_mm(x, w), int8_mm_plain(x, w))
    assert kernels.launches == before
    with pytest.raises(ValueError, match="inner dimensions"):
        int8_mm(x, w[:64])
    with pytest.raises(ValueError, match="int8"):
        int8_mm(x.to(torch.int16), w)


def test_microbenchmark_shapes_are_whole_tiles():
    assert len(MICROBENCH_SHAPES) == 9
    assert all(supported_shape(*s) for s in MICROBENCH_SHAPES)
    assert not supported_shape(128, 96, 128)   # K not a multiple of 64
    assert not supported_shape(128, 64, 64)    # 256 x 64 tiles need M % 256
    assert not supported_shape(100, 64, 128)
