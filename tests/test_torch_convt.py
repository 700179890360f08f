"""The port's (1, 2) ConvTranspose (kernels/convt_kernel.py) on the CPU: the
host-side plan of the CUDA kernel, and the plain version's summation order
at the three depths of the bundled net.

The kernel keeps one float32 FMA chain per output, in K order; so does the
plain version, and on this host's float32 product (MKL) that is bit for bit
what torch.matmul gives, the order of the reference's product.
"""

import re
from pathlib import Path

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from azoom_torch import kernels
from azoom_torch.kernels.convt_kernel import convt1x2, convt1x2_plain, plan
from azoom_torch.models.convert import load_conv_transpose
from azoom_torch.models.unet import ConvTranspose1x2

BATCH, F_ROWS = 128, 129
# The net's three upsamplings at T = 64 input frames: (K = Cin, Cout, frames).
NANO_CONVT = [(256, 128, 8), (128, 64, 16), (64, 64, 32)]
SOURCE = Path(__file__).resolve().parent.parent / "azoom_torch" / "csrc" / "convt_kernel.cu"


def _c_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE.name}"
    return int(m.group(1))


@pytest.mark.parametrize("k,cout,frames", NANO_CONVT)
def test_plan_of_the_nano_shapes(k, cout, frames):
    rows = BATCH * F_ROWS * frames  # a multiple of the 96-row tile at batch 128
    how = plan(rows, k, 2 * cout)
    assert (how["tile_m"], how["tile_n"], how["k_chunk"]) == (96, 128, 16)
    assert how["grid"] == (rows // 96, 2 * cout // 128)
    assert how["blocks"] == how["grid"][0] * how["grid"][1]
    assert how["chunks"] == k // 16
    assert how["smem"] <= 48 * 1024  # dynamic shared memory without an opt-in
    assert 3 * how["smem"] <= 228 * 1024  # three blocks share an SM


def test_plan_matches_the_kernel_source():
    """plan's tile and bytes restate the constants of csrc/convt_kernel.cu,
    whose entry point refuses a plan that disagrees."""
    how = plan(1000, 64, 128)
    tile_m, tile_n = _c_constant("kTileM"), _c_constant("kTileN")
    chunk, stages = _c_constant("kChunk"), _c_constant("kStages")
    assert (how["tile_m"], how["tile_n"], how["k_chunk"], how["stages"]) == (
        tile_m, tile_n, chunk, stages)
    assert how["smem"] == stages * chunk * ((tile_m + 4) + tile_n) * 4  # x^T padded, then W


@pytest.mark.parametrize("batch,f_rows,frames,k,n2", [
    (3, 129, 8, 256, 256), (3, 129, 32, 64, 128), (1, 5, 3, 36, 8), (2, 1, 1, 4, 4)])
def test_plan_covers_ragged_rows(batch, f_rows, frames, k, n2):
    rows = batch * f_rows * frames
    how = plan(rows, k, n2)
    (gm, gn), tm, tn = how["grid"], how["tile_m"], how["tile_n"]
    assert (gm - 1) * tm < rows <= gm * tm  # the last row tile may be partial, none is empty
    assert (gn - 1) * tn < n2 <= gn * tn
    assert (how["chunks"] - 1) * 16 < k <= how["chunks"] * 16  # the last chunk may be short


@pytest.mark.parametrize("rows,k,n2", [(0, 64, 128), (100, 0, 128), (100, 64, 0)])
def test_plan_refuses_what_the_kernel_does_not_take(rows, k, n2):
    """Only an empty product: the kernel takes any K and Cout."""
    with pytest.raises(ValueError, match="convt1x2"):
        plan(rows, k, n2)


# K and 2 * Cout of upsamplings in nets trained at other bases (K = 2 * Cout of the level
# below): not multiples of 4, the kernel's K and N edges masked
@pytest.mark.parametrize("rows,k,n2", [(100, 6, 256), (100, 130, 256), (100, 64, 130),
                                       (100, 10, 10), (7, 383, 382), (1, 1, 2)])
def test_plan_takes_any_k_and_cout(rows, k, n2):
    how = plan(rows, k, n2)
    (gm, gn), tm, tn = how["grid"], how["tile_m"], how["tile_n"]
    assert (gm - 1) * tm < rows <= gm * tm and (gn - 1) * tn < n2 <= gn * tn
    assert (how["chunks"] - 1) * 16 < k <= how["chunks"] * 16
    assert how["smem"] == plan(96, 16, 128)["smem"]  # one tile size for every width


@pytest.mark.parametrize("k,cout", [(40, 300), (383, 191), (7, 129)])
def test_plain_in_blocks_of_rows_is_the_chain_over_all_rows(k, cout):
    """On the CPU the plain version walks the chain on blocks of rows (2^18
    accumulators, here several blocks and a partial one); each output is the
    same float64-emulated FMA chain as over all rows at once, bit for bit,
    signed zeros included."""
    rng = np.random.default_rng(k + cout)
    x = rng.standard_normal((2, 33, 16, k)).astype(np.float32)
    x[0, 0, 0] = -0.0  # an output row of -0 products
    w = (0.05 * rng.standard_normal((k, 2 * cout))).astype(np.float32)
    b = np.zeros(cout, np.float32)
    got = convt1x2_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    x64, w64 = torch.from_numpy(x).reshape(-1, k).double(), torch.from_numpy(w).double()
    acc = torch.zeros((x64.shape[0], 2 * cout), dtype=torch.float64)
    for i in range(k):
        acc = (acc + x64[:, i:i + 1] * w64[i]).to(torch.float32).to(torch.float64)
    want = acc.to(torch.float32).reshape(2, 33, 32, cout) + torch.from_numpy(b)
    assert x64.shape[0] % (2**18 // (2 * cout)) and x64.shape[0] > 2**18 // (2 * cout)
    assert torch.equal(got, want) and torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("k,cout,frames", NANO_CONVT)
def test_plain_sums_in_order_at_the_nano_depths(k, cout, frames):
    """As test_torch_qconv.py::test_conv_transpose_plain_sums_in_order, at each
    depth of the net and a row count that no tile divides (5 x 43 x frames)."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(np.abs(rng.standard_normal((5, 43, frames, k))).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.standard_normal((k, 2 * cout))).astype(np.float32))
    got = convt1x2_plain(x, w, torch.zeros(cout))
    assert (5 * 43 * frames) % plan(5 * 43 * frames, k, 2 * cout)["tile_m"]
    assert torch.equal(got, torch.matmul(x, w).reshape(5, 43, 2 * frames, cout))


@pytest.mark.parametrize("k,cout,frames", NANO_CONVT)
def test_conv_transpose_matches_flax_at_the_nano_depths(k, cout, frames):
    rng = np.random.default_rng(k + 1)
    x = np.abs(rng.standard_normal((3, 5, frames, k))).astype(np.float32)
    up = nn.ConvTranspose(cout, (1, 2), strides=(1, 2))
    params = jax.tree_util.tree_map(np.array, up.init(jax.random.PRNGKey(k), x))["params"]
    params["bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    ref = np.asarray(up.apply({"params": params}, x))
    m = ConvTranspose1x2(k, cout)
    with torch.no_grad():
        load_conv_transpose(m, params)
    got = m(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 5, 2 * frames, cout)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, 3, 4, 36)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((36, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    before = dict(kernels.launches)
    assert torch.equal(convt1x2(x, w, b), convt1x2_plain(x, w, b))
    assert kernels.launches == before
