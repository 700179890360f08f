"""Training checkpoints served by the port (CPU): a reference orbax
directory read by ``azoom_torch.train.orbax`` without JAX, a port
checkpoint directory, and the ``--ckpt`` loader the batch and run CLIs share
(``azoom_torch.cli.checkpoint``), against azoom.train.loop and
azoom.cli.batch.

The orbax directory is the reference's own: ``CheckpointManager`` with
``StandardSave`` of a ``TrainState`` built by ``TrainState.create`` from the
bundled nano net's float variables (no init runs), at steps 3 and 5.
Tolerance: every leaf bit for bit; the step is the directory's name.

Served ``--int8`` (dynamic scales, one per chunk or scene): ``run inf``'s
masks within 2e-7 of the reference net's eager ``apply`` of each chunk
(with XLA's BatchNorm multipliers); ``batch`` rows, unrounded, equal at two
``--chunk-scenes``.
"""

import builtins

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from azoom.cli import batch as jax_batch
from azoom.config import DEFAULT as JAX_DEFAULT
from azoom.models.quantize import load_quantized as jax_load_quantized
from azoom.models.unet import TPUFPU as FlaxTPUFPU
from azoom.train import loop as jax_loop
from azoom_torch.cli import batch, run
from azoom_torch.cli.checkpoint import checkpoint_variables, load_checkpoint, twin
from azoom_torch.config import DEFAULT, PathsConfig
from azoom_torch.io.wav import write_wav
from azoom_torch.models.convert import from_flax
from azoom_torch.models.pretrained import ASSETS, _PORTED
from azoom_torch.models.unet import TPUFPU, FreqPreservingUNet, QConv
from azoom_torch.train import orbax as port_orbax
from azoom_torch.train.loop import create_state, save_checkpoint

NANO = ASSETS / "tpufpu_b64s4d2e2_phy_int8.npz"
NANO_KW = dict(base=64, fold=4, bneck=4, dec_div=2, enc_div=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xla_multipliers(monkeypatch):
    """The port's epilogue with XLA's BatchNorm multipliers, the one rounding
    the port does otherwise (tests/test_torch_models.py)."""
    from azoom_torch.models import convert

    exact = convert.epilogue_params

    def with_xla_rsqrt(act_scale, w_scale, bias, bn=None):
        epi = exact(act_scale, w_scale, bias, bn)
        if bn is not None:
            gamma, _, _, var = bn
            rs = np.asarray(jax.lax.rsqrt(jnp.asarray(var.numpy()) + 1e-5))
            epi[3] = torch.from_numpy(np.array(rs)) * gamma
        return epi

    monkeypatch.setattr(convert, "epilogue_params", with_xla_rsqrt)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), "/".join(k)


@pytest.fixture(scope="module")
def bundled():
    v = jax_load_quantized(NANO)
    return {k: v[k] for k in ("params", "batch_stats")}


def _state(variables):
    return jax_loop.TrainState.create(
        apply_fn=FlaxTPUFPU(**NANO_KW).apply,
        params=variables["params"], batch_stats=variables["batch_stats"],
        tx=optax.adam(1e-4))


@pytest.fixture(scope="module")
def orbax_dir(tmp_path_factory, bundled):
    import orbax.checkpoint as ocp

    d = tmp_path_factory.mktemp("orbax") / "ckpt"
    state = _state(bundled)
    mngr = ocp.CheckpointManager(d.absolute())
    for step in (3, 5):
        mngr.save(step, args=ocp.args.StandardSave(state))
    mngr.wait_until_finished()
    return d


def test_the_port_reads_the_latest_and_a_named_step(orbax_dir, bundled):
    net = twin("tpufpu_nano", "physics")
    assert port_orbax.orbax_steps(orbax_dir) == [3, 5]
    for step, want in ((None, 5), (3, 3)):
        got, at = port_orbax.read_orbax_variables(orbax_dir, net.variables(), step=step)
        assert at == want
        _assert_trees_equal(got, bundled)


def test_the_reference_restore_reads_the_same_directory(orbax_dir, bundled):
    state, step = jax_loop.restore_checkpoint(orbax_dir, _state(bundled))
    assert step == 5
    net = twin("tpufpu_nano", "physics")
    got, at = port_orbax.read_orbax_variables(orbax_dir, net.variables())
    assert at == step
    _assert_trees_equal(got, {"params": state.params, "batch_stats": state.batch_stats})


def test_a_wrong_model_raises_naming_the_leaf(orbax_dir):
    with pytest.raises(ValueError, match="batch_stats/ConvBNRelu_5/BatchNorm_0/mean: missing"):
        port_orbax.read_orbax_variables(orbax_dir, twin("deepfpu", "physics").variables())
    with pytest.raises(ValueError, match=r"batch_stats/\S+: \(\d+,\) in the checkpoint, "
                                         r"\(\d+,\) in the net"):
        port_orbax.read_orbax_variables(orbax_dir, twin("tpufpu_slim", "physics").variables())


def test_a_missing_tensorstore_raises_naming_it(orbax_dir, monkeypatch):
    real = builtins.__import__

    def no_tensorstore(name, *args, **kwargs):
        if name == "tensorstore":
            raise ImportError("No module named 'tensorstore'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorstore)
    with pytest.raises(ImportError, match="tensorstore"):
        port_orbax.read_orbax_variables(orbax_dir, twin("tpufpu_nano", "physics").variables())


@pytest.mark.parametrize("key,value", [("use_zarr3", True), ("use_ocdbt", False)])
def test_another_layout_is_refused_naming_its_key(orbax_dir, tmp_path, key, value):
    """Only the layout the reference's ``CheckpointManager`` writes (OCDBT,
    zarr) is read; a step whose ``_METADATA`` declares another is refused."""
    import json
    import shutil

    d = tmp_path / "ckpt"
    shutil.copytree(orbax_dir, d)
    meta_path = d / "5" / "default" / "_METADATA"
    meta = json.loads(meta_path.read_text())
    assert meta[key] is not value
    meta[key] = value
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=f"{key} is {value}"):
        port_orbax.read_orbax_variables(d, twin("tpufpu_nano", "physics").variables())


class _Args:
    model, int8, no_reverb, no_geo_adapt = "tpufpu_nano", False, True, False

    def __init__(self, ckpt):
        self.ckpt = str(ckpt)


@pytest.fixture(scope="module")
def reference_sweep_variables(orbax_dir, bundled):
    """What the reference batch CLI's ``_load_sweep_model`` serves from the
    orbax directory (its ``create_state`` init swapped for the same tree)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_loop, "create_state", lambda *a, **k: _state(bundled))
    try:
        model, variables, kind, geo = jax_batch._load_sweep_model(_Args(orbax_dir),
                                                                 JAX_DEFAULT)
    finally:
        mp.undo()
    assert kind == "physics" and geo is None
    assert model.base == _PORTED["tpufpu_nano"][2]["base"] == 64
    return variables


def test_the_reference_fpu_twin_is_the_ported_width():
    from azoom.models.unet import FreqPreservingUNet as FlaxFPU

    assert FlaxFPU().base == _PORTED["fpu"][2]["base"] == twin("fpu", "logmag_ipd").base


@pytest.mark.parametrize("kind", ["orbax", "port"])
def test_batch_ckpt_serves_the_reference_variables(kind, orbax_dir, bundled,
                                                   reference_sweep_variables, tmp_path, capsys):
    """``--ckpt`` on an orbax directory and on a port ``save_checkpoint``
    directory of the same weights gives the reference's variables, and the
    batch CLI serves exactly the net ``from_flax`` makes of them: int8 from
    the orbax directory (a training checkpoint: dynamic scales), float from
    the port's."""
    ckpt = orbax_dir
    if kind == "port":
        state = create_state(twin("tpufpu_nano", "physics"), 0, (1, 513, 64, 4), device="cpu")
        state.model.load_variables(bundled)
        state.step = 5
        save_checkpoint(tmp_path / "port", state)
        ckpt = tmp_path / "port"
    variables, step, _ = checkpoint_variables("tpufpu_nano", ckpt, "physics", "cpu")
    assert step == 5
    _assert_trees_equal(variables, reference_sweep_variables)
    for int8 in [kind == "orbax"]:
        args = batch.build_parser().parse_args(
            ["--model", "tpufpu_nano", "--ckpt", str(ckpt), "--beamformer", "mvdr"]
            + (["--int8"] if int8 else []))
        net, kind_, geo = batch._load_sweep_model(args, DEFAULT, "cpu")
        assert f"using checkpoint step 5 from {ckpt}" in capsys.readouterr().out
        ref = from_flax(TPUFPU, variables, {**NANO_KW, "n_freqs": 513}, int8, "cpu")
        assert kind_ == "physics" and geo is None
        sd, rd = net.state_dict(), ref.state_dict()
        assert sd.keys() == rd.keys() and all(bool((sd[k] == rd[k]).all()) for k in sd)
        convs = [m.act_scale for m in net.modules() if isinstance(m, QConv)]
        assert (len(convs) == 21 and all(s is None for s in convs)) if int8 else not convs


def test_an_npz_artifact_serves_its_static_scales():
    net, step = load_checkpoint("fpu", ASSETS / "fpu_b32_int8.npz", "logmag_ipd", True, "cpu")
    assert step is None and isinstance(net, FreqPreservingUNet)
    assert all(isinstance(m.act_scale, float) for m in net.modules() if isinstance(m, QConv))


def test_a_directory_of_neither_kind_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError, match="neither"):
        load_checkpoint("fpu", tmp_path, "logmag_ipd", False, "cpu")


def test_run_inf_serves_an_orbax_checkpoint_int8_as_the_reference(orbax_dir, bundled, tmp_path,
                                                                  monkeypatch):
    """``run inf --ckpt <orbax> --int8`` on a 3 s mixture whose last 1.5 s
    are 40 dB quieter: the masks its net gives the three 2 s chunks against
    the reference net's eager ``apply`` of each chunk's features alone, as
    the reference's ``learned_enhance_streaming`` applies it (``jax.vmap``
    in ``streaming_enhance``), so the quiet chunks are coded at their own
    resolution. Within 2e-7 once the port's epilogue carries XLA's
    BatchNorm multipliers, as tests/test_torch_models.py holds the bundled
    int8 nets."""
    from azoom_torch.cli import checkpoint

    name = "q"
    rng = np.random.default_rng(7)
    env = np.where(np.arange(48_000) < 16_000, 1.0, 1e-2).astype(np.float32)
    sim = PathsConfig(root=tmp_path).run_sim_dir(name)
    write_wav(sim / "mixture.wav", (0.1 * rng.standard_normal((48_000, 2)) * env[:, None]), 16_000)
    _xla_multipliers(monkeypatch)
    seen = []
    real = checkpoint.load_checkpoint

    def hooked(*args, **kwargs):
        net, step = real(*args, **kwargs)
        net.register_forward_hook(lambda m, inp, out: seen.append((inp[0].numpy(), out.numpy())))
        return net, step

    monkeypatch.setattr(checkpoint, "load_checkpoint", hooked)
    run.main(["inf", "--name", name, "--beamformer", "mvdr", "--model", "tpufpu_nano", "--int8",
              "--ckpt", str(orbax_dir), "--data-root", str(tmp_path), "--device", "cpu"])
    assert len(seen) == 1
    feats, masks = seen[0]
    assert feats.shape[0] == 2
    model = FlaxTPUFPU(quant=True, **NANO_KW)
    ref = np.concatenate([np.asarray(model.apply(bundled, jnp.asarray(f[None]))) for f in feats])
    err = np.abs(masks - ref).max(axis=(1, 2))
    print(f"[parity] run inf --ckpt orbax --int8: mask max per chunk {err}")  # pytest -s
    assert masks.shape == ref.shape and float(err.max()) <= 2e-7


def test_batch_int8_rows_do_not_depend_on_the_chunk_size(orbax_dir, tmp_path, monkeypatch):
    """``batch --ckpt <orbax> --int8``: each scene's dynamic scales are its
    own, so its unrounded metrics are the same in blocks of 1 and of 2."""
    from azoom_torch.eval import reports

    rows = {}
    monkeypatch.setattr(reports, "append_to_csv",
                        lambda path, run_id, m: rows.setdefault(path, []).append((run_id, m)))
    for chunk in (1, 2):
        batch.main(["--n", "2", "--beamformer", "mvdr", "--model", "tpufpu_nano", "--int8",
                    "--ckpt", str(orbax_dir), "--no-reverb", "--chunk-scenes", str(chunk),
                    "--duration", "0.5", "--no-pesq", "--device", "cpu",
                    "--data-root", str(tmp_path / f"chunk{chunk}")])
    one, two = (rows[tmp_path / f"chunk{c}" / "results" / "batch_metrics.csv"] for c in (1, 2))
    assert len(one) == 2 and one == two
