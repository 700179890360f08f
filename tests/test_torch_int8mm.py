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
from azoom_torch.kernels import build
from azoom_torch.kernels.int8_mm_kernel import (
    MICROBENCH_SHAPES,
    int8_mm,
    int8_mm_plain,
    supported_shape,
    tile_n,
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
    assert supported_shape(128, 64, 64)        # the smallest tile: 128 x 64, one K chunk
    assert not supported_shape(64, 64, 64)     # tiles are 128 rows
    assert not supported_shape(100, 64, 128)
    assert not supported_shape(128, 64, 96) and not supported_shape(128, 0, 64)


@pytest.mark.parametrize("shape", list(MICROBENCH_SHAPES))
def test_output_tiles_of_the_microbenchmark_shapes(shape):
    """128 x tile_n tiles: the widest of 256, 128, 64 dividing N, and at
    (16384, 576, 64) one wave of 128 tiles for the card's 132 SMs."""
    M, K, N = shape
    bn = tile_n(N)
    assert bn == {512: 256, 256: 256, 128: 128, 64: 64}[N] and N % bn == 0 and M % 128 == 0
    # the ring of (128 + bn) x 128-byte stages, as csrc/int8_mm_kernel.cu sizes it
    stages = min(8, (232_448 - 1024 - 256) // ((128 + bn) * 128))
    assert stages >= 4 and 1024 + stages * (128 + bn) * 128 + 16 * stages <= 232_448
    if shape == (16384, 576, 64):
        assert (M // 128) * (N // bn) == 128


def _fake_csrc(tmp_path, monkeypatch, files):
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(build, "CSRC", tmp_path)


def test_build_hash_follows_the_headers(tmp_path, monkeypatch):
    """The library's name carries a hash of the source and of every local
    header it includes, directly or through another header; nvcc is not
    needed to see that."""
    files = {
        "k.cu": '#include "a.cuh"\n#include <cuda.h>\nint k;\n',
        "a.cuh": '#pragma once\n  #  include "b.cuh"\n',
        "b.cuh": "// b\n",
        "unused.cuh": "// not included\n",
    }
    _fake_csrc(tmp_path, monkeypatch, files)
    assert [p.name for p in build._sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    base = build._target("k")
    assert base == build._target("k") and base.name.startswith("k-") and base.suffix == ".so"
    for name in ("k.cu", "a.cuh", "b.cuh"):
        (tmp_path / name).write_text(files[name] + "// edited\n")
        assert build._target("k") != base, f"an edit of {name} must change the build hash"
        (tmp_path / name).write_text(files[name])
        assert build._target("k") == base
    (tmp_path / "unused.cuh").write_text("// edited\n")
    assert build._target("k") == base


@pytest.mark.parametrize("name,headers", [
    ("int8_mm_kernel", {"wgmma_s8.cuh"}),
    ("qconv_kernel", {"wgmma_s8.cuh", "qconv_common.cuh"}),
    ("qconv_mma_kernel", {"qconv_common.cuh"}),
    ("mvdr_kernel", set()),
])
def test_kernel_sources_name_their_headers(name, headers):
    assert name in build.KERNEL_SOURCES
    found = build._sources(name)
    assert found[0].name == f"{name}.cu" and {p.name for p in found[1:]} == headers
