"""The export helpers of azoom_torch.models.quantize and the TPUFPU
``tfold`` / ``fattn`` serving forms on the CPU against azoom.

- quantize_variables, dequantize_variables, quantized_size_bytes,
  quantization_error, fold_batchnorm and save_quantized: bit for bit
  (numpy float32 in the reference's order); the reference's
  load_quantized reads the port's .npz, and the port serves it
  (convert.from_flax) with the same bits as the reference's own file.
- calibrate_act_scales against the reference's (jitted) calibration: both
  take the 99.9th percentile by linear interpolation. Given XLA's BatchNorm
  multipliers (its rsqrt, one ulp off in some channels; ROADMAP.md Queue C)
  the port's scales are within CALIB_ULPS float32 ulps of the reference's.
  With its own correctly rounded multipliers an int8 code can flip and move
  a deeper layer's percentile: held within CALIB_REL relative (the
  reference's own eager calibration moves further from its jitted one).
  ``-s`` prints both.
- TPUFPU(tfold=2, fattn=2), int8 with the reference's calibrated scales and
  float, against the reference's eager apply: float within 1e-5; int8
  within the int8 nets' bounds of tests/test_torch_models.py (mask max
  1e-2, mean 5e-4).
- load_bundled("tpufpu_nano", fold_bn=True) against the reference's
  load_bundled(..., quant=True, fold_bn=True) eager apply, at those bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.models import quantize as JQ
from azoom.models.pretrained import load_bundled as jax_load_bundled
from azoom.models.unet import TPUFPU as JaxTPUFPU
from azoom_torch.models import convert
from azoom_torch.models import quantize as Q
from azoom_torch.models.convert import from_flax
from azoom_torch.models.pretrained import load_bundled
from azoom_torch.models.unet import TPUFPU

CALIB_ULPS = 4
CALIB_REL = 1e-2
TINY = dict(base=16, fold=4, bneck=2, tfold=2, fattn=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """The reference's init of a tiny TPUFPU(tfold=2, fattn=2) with random
    BatchNorm statistics, two feature batches and its calibrated scales."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 65, 32, 4)).astype(np.float32)
    x2 = (rng.standard_normal((2, 65, 32, 4)) * 1.5).astype(np.float32)
    v = _np(jax.jit(JaxTPUFPU(**TINY).init)(jax.random.PRNGKey(0), x))
    stats = v["batch_stats"]  # running statistics away from the init's (0, 1)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), stats)
    for node in _bn_nodes(v["batch_stats"]):
        node["var"] = (0.5 + rng.random(node["var"].shape)).astype(np.float32)
    calibrated = _np(JQ.calibrate_act_scales(JaxTPUFPU(**TINY, quant=True), v, [x, x2]))
    return v, x, x2, calibrated


def _bn_nodes(tree):
    if "var" in tree:
        yield tree
        return
    for child in tree.values():
        yield from _bn_nodes(child)


def _leaves_equal(a, b) -> None:
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for p, q in zip(la, lb):
        p, q = np.asarray(p), np.asarray(q)
        assert p.dtype == q.dtype and p.shape == q.shape and np.array_equal(p, q)


def test_weight_quantization_matches_bit_for_bit(tiny):
    v = tiny[0]
    qv = Q.quantize_variables(v)
    _leaves_equal(qv, _np(JQ.quantize_variables(v)))
    _leaves_equal(Q.dequantize_variables(qv), _np(JQ.dequantize_variables(JQ.quantize_variables(v))))
    assert Q.quantized_size_bytes(qv) == JQ.quantized_size_bytes(JQ.quantize_variables(v))
    err, ref = Q.quantization_error(v, qv), JQ.quantization_error(v, JQ.quantize_variables(v))
    print(f"[quantize] size {Q.quantized_size_bytes(qv)} B, error {err!r} vs {ref!r}")
    assert err == ref and err < 1 / 127


def test_fold_batchnorm_matches_bit_for_bit():
    from azoom_torch.models.pretrained import ASSETS

    v = Q.load_quantized(ASSETS / "tpufpu_b64s4d2e2_phy_int8.npz")
    _leaves_equal(Q.fold_batchnorm(v), _np(JQ.fold_batchnorm(v)))


def test_save_quantized_round_trip(tiny, tmp_path):
    v = tiny[3]
    n_port = Q.save_quantized(tmp_path / "port.npz", v)
    n_ref = JQ.save_quantized(tmp_path / "ref.npz", v)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    print(f"[save_quantized] {n_port} B (reference {n_ref} B)")
    back = _np(JQ.load_quantized(tmp_path / "port.npz"))
    _leaves_equal(back, _np(JQ.load_quantized(tmp_path / "ref.npz")))
    _leaves_equal(Q.load_quantized(tmp_path / "port.npz"), back)
    x = torch.from_numpy(tiny[1])
    with torch.inference_mode():
        a = from_flax(TPUFPU, Q.load_quantized(tmp_path / "port.npz"), TINY, True)(x)
        b = from_flax(TPUFPU, Q.load_quantized(tmp_path / "ref.npz"), TINY, True)(x)
    assert torch.equal(a, b)


def _ulps(ref_tree, got_tree) -> list[int]:
    assert jax.tree_util.tree_structure(ref_tree) == jax.tree_util.tree_structure(got_tree)
    return [abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))
            for a, b in zip(jax.tree_util.tree_leaves(ref_tree), jax.tree_util.tree_leaves(got_tree))]


def test_calibrated_scales_match_reference(tiny, monkeypatch):
    v, x, x2, calibrated = tiny
    own = Q.calibrate_act_scales((TPUFPU, TINY), v, [x, x2], device="cpu")["quant_stats"]
    rel = max(abs(float(a) / float(b) - 1) for a, b in zip(
        jax.tree_util.tree_leaves(own), jax.tree_util.tree_leaves(calibrated["quant_stats"])))
    exact = convert.epilogue_params

    def with_xla_rsqrt(act_scale, w_scale, bias, bn=None):
        epi = exact(act_scale, w_scale, bias, bn)
        if bn is not None:
            gamma, _, _, var = bn
            rs = np.asarray(jax.lax.rsqrt(jnp.asarray(var.numpy()) + 1e-5))
            epi[3] = torch.from_numpy(np.array(rs)) * gamma
        return epi

    monkeypatch.setattr(convert, "epilogue_params", with_xla_rsqrt)
    xla = Q.calibrate_act_scales((TPUFPU, TINY), v, [x, x2], device="cpu")["quant_stats"]
    ulps = _ulps(calibrated["quant_stats"], xla)
    print(f"[calibrate] {len(ulps)} convs: with XLA's BatchNorm multipliers {ulps} ulps from the "
          f"reference; with the port's own, {rel:.2e} relative")
    assert max(ulps) <= CALIB_ULPS
    assert rel < CALIB_REL


def _mask_close(got, ref, what, max_bound, mean_bound) -> None:
    err = np.abs(got - ref)
    print(f"[serving] {what}: mask max={err.max():.3e} mean={err.mean():.3e} "
          f"(mask range {ref.min():.3f}..{ref.max():.3f})")
    assert ref.max() - ref.min() > 0.05  # not a constant mask
    assert got.shape == ref.shape
    assert float(err.max()) < max_bound and float(err.mean()) < mean_bound


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "float"])
def test_tfold_fattn_serving_matches_eager_apply(tiny, quant):
    _, x, _, calibrated = tiny
    ref = np.asarray(JaxTPUFPU(**TINY, quant=quant).apply(calibrated, jnp.asarray(x)))
    net = from_flax(TPUFPU, calibrated, TINY, quant)
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    if quant:
        _mask_close(got, ref, "int8 tfold 2, fattn 2", 1e-2, 5e-4)
    else:
        _mask_close(got, ref, "float tfold 2, fattn 2", 1e-5, 1e-5)


def test_fold_bn_bundled_nano_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 96, 16, 4)).astype(np.float32)
    jm, jv, _ = jax_load_bundled("tpufpu_nano", quant=True, fold_bn=True)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x)))
    net, kind = load_bundled("tpufpu_nano", device="cpu", fold_bn=True)
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert kind == "physics"
    _mask_close(got, ref, "int8 tpufpu_nano, BatchNorm folded", 1e-2, 5e-4)
