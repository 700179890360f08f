"""One train step of the port's trainable twins (azoom_torch.models.trainable)
on the CPU against azoom.train.loop.make_train_step.

Each net starts from the reference's own init (``create_state``, carried
across by ``load_variables``) and takes one step on the same numpy-seeded
batch (B = 2, 65 bins, 32 frames, tiny widths). Held, at the bounds below
(``-s`` prints each measured value):
- the loss within 1e-5 (absolute);
- each parameter's gradient (read from Adam's first moment, 0.1 g, on both
  sides) within
  GRAD_BOUND of that leaf's largest |gradient|: the port's convs are im2col
  and one float32 product, XLA's are direct convs, so sums round in another
  order. A conv bias before a training-mode BatchNorm has a zero gradient in
  exact arithmetic (the batch mean takes it out): both sides are rounding
  noise (~1e-9) there, so such leaves (the reference's below ZERO_GRAD of
  the net's largest gradient) are held to the port's being below it too;
- the BatchNorm running statistics within 1e-5 of each leaf's largest;
- the Adam update: on the first step it is ~lr sign(g), so where |g| <~ 1e-8
  (Adam's eps) either sign is noise; where |g| > 1e-6 it is held within
  1e-2 lr, and the sign flips below are counted and printed.
``variables()`` of each twin is the reference's tree, leaf for leaf. The
CRN, the BLSTM and the QCNN take the same step in
tests/test_torch_blstm_qcnn.py, which also holds eval-mode forwards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from azoom.models.unet import TPUFPU as JaxTPUFPU
from azoom.models.unet import DeepFPU as JaxDeepFPU
from azoom.models.unet import FreqPreservingUNet as JaxFPU
from azoom.train import loop as JL
from azoom_torch.models import trainable
from azoom_torch.train.loop import TrainState, make_train_step

LR = 1e-4
GRAD_BOUND = 5e-4  # measured: DeepFPU (27 convs) 1.4e-4, the others <= 1.1e-5
ZERO_GRAD = 1e-5  # of the net's largest gradient: a leaf that is zero but for rounding
SHAPE = (2, 65, 32)  # B, F, T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(channels: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE + (channels,)).astype(np.float32)
    y = (rng.random(SHAPE) > 0.6).astype(np.float32)
    return x, y


def flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def reference_step(jax_model, x, y) -> dict:
    """The reference's init (create_state's body, its init jitted: flax's
    eager init dispatches op by op and took ~25 s) and one make_train_step()
    step. The gradients are read from Adam's first moment after that step,
    mu = (1 - 0.9) g, on both sides: a separate jax.grad would compile the
    net's backward a second time."""
    v = jax.jit(jax_model.init)(jax.random.PRNGKey(3), jnp.zeros(x.shape, jnp.float32))
    st = JL.TrainState.create(apply_fn=jax_model.apply, params=v["params"],
                              batch_stats=v.get("batch_stats", {}), tx=optax.adam(LR))
    st2, loss = JL.make_train_step()(st, jnp.asarray(x), jnp.asarray(y))
    init = {"params": jax.tree_util.tree_map(np.asarray, st.params)}
    if st.batch_stats:
        init["batch_stats"] = jax.tree_util.tree_map(np.asarray, st.batch_stats)
    return {"init": init, "loss": float(loss), "grads": flat(st2.opt_state[0].mu),
            "params": flat(st2.params),
            "stats": flat(st2.batch_stats) if st.batch_stats else {}}


def port_step(net, ref: dict, x, y) -> dict:
    """The same from the port: the reference's init, one make_train_step()
    step; the gradients as Adam's first moment."""
    net.build(x.shape).load_variables(ref["init"]).train()
    tree = net.variables()  # the reference's tree, leaf for leaf
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref["init"])
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ref["init"])):
        assert np.array_equal(a, b)
    params = dict(net.named_parameters())
    state = TrainState(net, {k: torch.zeros_like(p) for k, p in params.items()},
                       {k: torch.zeros_like(p) for k, p in params.items()}, 0, LR)
    state, step_loss = make_train_step()(state, torch.from_numpy(x), torch.from_numpy(y))
    v = net.variables()
    return {"loss": float(step_loss),
            "grads": {k.replace(".", "/"): m.numpy() for k, m in state.mu.items()},
            "params": flat(v["params"]), "stats": flat(v.get("batch_stats", {}))}


def assert_step_matches(name: str, ref: dict, got: dict) -> None:
    dl = abs(ref["loss"] - got["loss"])
    print(f"[train step] {name}: loss {ref['loss']:.7f} vs {got['loss']:.7f} (|d| {dl:.2e})")
    assert dl < 1e-5
    assert set(ref["grads"]) == set(got["grads"]) == set(ref["params"])
    top = max(float(np.abs(g).max()) for g in ref["grads"].values())
    # a conv bias before a training-mode BatchNorm has a zero gradient in
    # exact arithmetic: both sides are rounding noise there
    zero = {k for k, g in ref["grads"].items() if np.abs(g).max() < ZERO_GRAD * top}
    worst_g = max(float(np.abs(got["grads"][k] - g).max() / np.abs(g).max())
                  for k, g in ref["grads"].items() if k not in zero)
    worst_zero = max((float(np.abs(got["grads"][k]).max()) / top for k in zero), default=0.0)
    init = flat(ref["init"]["params"])
    worst_u, flips, n_small, n = 0.0, 0, 0, 0
    for k, g in ref["grads"].items():
        u_ref, u_got = ref["params"][k] - init[k], got["params"][k] - init[k]
        big = np.abs(g) > 1e-7  # mu = 0.1 g: |g| > 1e-6
        if big.any():
            worst_u = max(worst_u, float(np.abs(u_ref - u_got)[big].max()) / LR)
        flips += int(np.sum(np.sign(u_ref) != np.sign(u_got)))
        n_small += int(np.sum(~big))
        n += g.size
    worst_s = max((float(np.abs(got["stats"][k] - s).max() / (np.abs(s).max() + 1e-30))
                   for k, s in ref["stats"].items()), default=0.0)
    print(f"[train step] {name}: gradient {worst_g:.2e} of the leaf max ({len(zero)} leaves zero "
          f"in exact arithmetic: port <= {worst_zero:.1e} of the net's max), update {worst_u:.2e} lr "
          f"where |g| > 1e-6, sign flips {flips} among {n_small} of {n} with |g| <= 1e-6, "
          f"BN statistics {worst_s:.2e}")
    assert worst_g < GRAD_BOUND
    assert worst_zero < ZERO_GRAD
    assert worst_u < 1e-2
    assert flips <= n_small
    assert set(ref["stats"]) == set(got["stats"])
    assert worst_s < 1e-5


NETS = {
    "fpu": (lambda: JaxFPU(base=4), lambda: trainable.FreqPreservingUNet(base=4), 2),
    "deepfpu": (lambda: JaxDeepFPU(base=2), lambda: trainable.DeepFPU(base=2), 4),
    "tpufpu_nano_layout": (
        lambda: JaxTPUFPU(base=8, fold=4, bneck=4, dec_div=2, enc_div=2),
        lambda: trainable.TPUFPU(base=8, fold=4, bneck=4, dec_div=2, enc_div=2), 4),
    "tpufpu_tfold2_fattn2": (
        lambda: JaxTPUFPU(base=8, fold=4, bneck=2, tfold=2, fattn=2),
        lambda: trainable.TPUFPU(base=8, fold=4, bneck=2, tfold=2, fattn=2), 4),
}


@pytest.mark.parametrize("name", list(NETS))
def test_one_train_step_matches_reference(name):
    make_ref, make_port, channels = NETS[name]
    x, y = batch(channels)
    ref = reference_step(make_ref(), x, y)
    assert_step_matches(name, ref, port_step(make_port(), ref, x, y))


def test_init_follows_flax_distributions():
    """The port's own init: lecun-normal truncated at 2 std (std sqrt(1 /
    fan_in)), zero biases, unit BatchNorm scales, orthogonal recurrent
    kernels; the same seed gives the same numbers."""
    g = torch.Generator().manual_seed(0)
    net = trainable.DeepFPU(base=8).init(g, (1, 65, 32, 4))
    k = net.ResBlock_3.Conv_0.kernel.detach().numpy()  # 3 x 3 x 128 -> 128
    std = np.sqrt(1.0 / (9 * 128))
    assert abs(k.std() / std - 1) < 0.02 and np.abs(k).max() <= 2 * std / 0.87962566103423978
    assert not net.ResBlock_3.Conv_0.bias.detach().any()
    assert bool((net.ResBlock_3.BatchNorm_0.scale == 1).all())
    crn = trainable.CRNMaskNet(base=4, hidden=16).init(torch.Generator().manual_seed(0),
                                                        (1, 65, 8, 2))
    wh = getattr(crn.OptimizedLSTMCell_0, "hf").kernel.detach()
    assert torch.allclose(wh @ wh.T, torch.eye(16), atol=1e-5)
    again = trainable.DeepFPU(base=8).init(torch.Generator().manual_seed(0), (1, 65, 32, 4))
    assert torch.equal(again.ResBlock_3.Conv_0.kernel, net.ResBlock_3.Conv_0.kernel)


@pytest.mark.parametrize("name", ["fpu", "fpu_reverb", "fpu_multigeo", "deepfpu", "tpufpu",
                                  "tpufpu_slim", "tpufpu_nano", "crn_causal"])
def test_from_bundled_carries_each_artifact_into_its_twin(name):
    """``from_bundled`` builds the twin that ``models.pretrained`` names for
    the artifact: its ``variables()`` are the artifact's float params and
    BatchNorm statistics as the reference's ``load_quantized`` reads them,
    leaf for leaf and bit for bit."""
    from azoom.models.quantize import load_quantized as jax_load_quantized
    from azoom_torch.models.pretrained import ASSETS, artifact_name

    net, kind = trainable.from_bundled(name, device="cpu")
    fname, want_kind = artifact_name(name)
    assert kind == want_kind and net.training
    ref = jax_load_quantized(str(ASSETS / fname))
    got = net.variables()
    for col in ("params", "batch_stats"):
        a, b = flat(got[col]), flat(ref[col])
        assert a.keys() == b.keys(), (col, sorted(a.keys() ^ b.keys())[:5])
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k], np.float32)), (col, k)


def test_from_bundled_runs_on_the_card_unless_told_otherwise():
    with pytest.raises(KeyError, match="unknown bundled model"):
        trainable.from_bundled("nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainable.from_bundled("tpufpu_nano")
