"""The port's training loop (azoom_torch.train) on the CPU.

Against azoom (``-s`` prints each measured value):
- mix_batch fed the reference's own source draws (anechoic, no jitter):
  the scenes within 1e-5; the features' 99.9th percentile within 1e-4 and
  their max within 2e-3 (the log magnitude and the phase of the quietest
  bins magnify the STFTs' different rounding: the port's is float64 inside,
  the reference's float32); labels (the oracle IBM) equal but for bins whose target and
  interference magnitudes tie within float32 rounding (at most 1e-4 of the
  bins);
- bce_loss, mask_accuracy and physics_residual (both feature kinds) within
  1e-6 of the reference's values;
- the distillation blend: fit(teacher_fn=...) trains on (1 - alpha) IBM +
  alpha teacher, and a constant-0.5 teacher at alpha 1 gives a first loss
  within 0.05 of ln 2, as the reference's test holds its own.
The port against itself:
- remat equals the plain step bit for bit (loss, parameters, Adam's
  moments, BatchNorm statistics folded in once);
- a mesh of two shards on one device runs them as one batch: bit for bit;
- two gloo processes on a global mesh of two (a shard each) against one
  process: global BatchNorm statistics and summed gradients, held at the
  one-step bounds of tests/test_torch_train_nets.py, both ranks equal;
- a resumed fit equals an uninterrupted one bit for bit, and the last 3
  checkpoints are kept;
- train.rounding, the card's yardstick against a float64 step, holds each
  leaf on its own (run here on the CPU at a tiny width).
"""

import copy
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.config import PipelineConfig as JaxConfig
from azoom.sim.signals import speech_like_batch as jax_speech_like_batch
from azoom.train import data as JD
from azoom.train import loop as JL
from azoom_torch.config import PipelineConfig
from azoom_torch.models import trainable
from azoom_torch.parallel.mesh import make_mesh
from azoom_torch.train import data as TD
from azoom_torch.train import loop as TL
from test_torch_train_nets import assert_step_matches, flat

REPO = Path(__file__).resolve().parent.parent
CFG, JCFG = PipelineConfig(mic_dist=0.04), JaxConfig(mic_dist=0.04)
N = 8_192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    """A port batch of 4 scenes (FPU's logmag_ipd features) on the CPU."""
    return TD.synth_batch(1, 4, CFG, n_samples=N, device="cpu")


def fresh_state(seed: int = 0, base: int = 2) -> TL.TrainState:
    return TL.create_state(trainable.FreqPreservingUNet(base=base), seed, (1, 513, 32, 2),
                           device="cpu")


def snapshot(state: TL.TrainState, loss) -> dict:
    v = state.model.variables()
    return {"loss": float(loss), "grads": {k.replace(".", "/"): m.numpy().copy()
                                           for k, m in state.mu.items()},
            "params": flat(v["params"]), "stats": flat(v["batch_stats"]),
            "nu": {k: m.numpy().copy() for k, m in state.nu.items()}}


def test_mix_batch_matches_reference_on_its_sources():
    sources = np.asarray(jax_speech_like_batch(jax.random.PRNGKey(4), 6, N, 16000)).reshape(2, 3, N)
    ref = JD.mix_batch(jax.random.PRNGKey(0), jnp.asarray(sources), JCFG, "logmag_ipd")
    ref_phy = JD.mix_batch(jax.random.PRNGKey(0), jnp.asarray(sources), JCFG, "physics")
    got = TD.mix_batch(0, sources, CFG, "logmag_ipd", device="cpu")
    got_phy = TD.mix_batch(0, sources, CFG, "physics", device="cpu")
    for key in ("mixture", "target_ref", "interference_ref"):
        err = float(np.abs(got[key].numpy() - np.asarray(ref[key])).max())
        print(f"[mix_batch] {key}: {err:.2e}")
        assert err < 1e-5
    for name, g, r in (("logmag_ipd", got, ref), ("physics", got_phy, ref_phy)):
        f, fr = g["features"].numpy(), np.asarray(r["features"])
        assert f.shape == fr.shape
        # the raw IPD can wrap by 2 pi where the angles straddle +-pi
        d = np.abs(f - fr)
        if name == "logmag_ipd":
            d[..., 1] = np.minimum(d[..., 1], np.abs(d[..., 1] - 2 * np.pi))
        lab = g["label"].numpy() != np.asarray(r["label"])
        print(f"[mix_batch] {name}: features {d.max():.2e} (99.9th percentile "
              f"{np.percentile(d, 99.9):.2e}); labels differ in {int(lab.sum())} of {lab.size} "
              f"bins")
        assert float(d.max()) < 2e-3 and float(np.percentile(d, 99.9)) < 1e-4
        assert lab.sum() <= 1e-4 * lab.size


def test_losses_and_residual_match_reference():
    rng = np.random.default_rng(3)
    pred = rng.random((2, 33, 16)).astype(np.float32)
    label = (rng.random((2, 33, 16)) > 0.5).astype(np.float32)
    feats = {"logmag_ipd": rng.standard_normal((2, 33, 16, 2)).astype(np.float32),
             "physics": rng.standard_normal((2, 33, 16, 4)).astype(np.float32)}
    t = torch.from_numpy
    pairs = [("bce", float(TL.bce_loss(t(pred), t(label))), float(JL.bce_loss(pred, label))),
             ("accuracy", float(TL.mask_accuracy(t(pred), t(label))),
              float(JL.mask_accuracy(pred, label)))]
    for kind, f in feats.items():
        pairs.append((f"physics_residual {kind}",
                      float(TL.physics_residual(t(f), t(pred), kind)),
                      float(JL.physics_residual(f, pred, kind))))
    for name, a, b in pairs:
        print(f"[loss] {name}: {a!r} vs {b!r}")
        assert abs(a - b) < 1e-6


def test_distillation_blend(monkeypatch):
    seen = []
    real = TL.make_train_step

    def spy(*a, **k):
        step = real(*a, **k)

        def wrapped(state, features, label):
            seen.append(label.clone())
            return step(state, features, label)
        return wrapped

    monkeypatch.setattr(TL, "make_train_step", spy)
    teacher = lambda f: torch.full(f.shape[:-1], 0.5)  # noqa: E731
    res = TL.fit(trainable.FreqPreservingUNet(base=2), CFG, n_steps=2, batch_size=2, n_samples=N,
                 teacher_fn=teacher, distill_alpha=0.25, log_every=1, log_fn=lambda s: None,
                 device="cpu")
    ibm = TD.synth_batch(0, 2, CFG, n_samples=N, step=0, device="cpu")["label"]
    assert torch.equal(seen[0], 0.75 * ibm + 0.25 * 0.5)
    assert res.steps_run == 2
    res = TL.fit(trainable.FreqPreservingUNet(base=2), CFG, n_steps=1, batch_size=2, n_samples=N,
                 teacher_fn=teacher, distill_alpha=1.0, log_every=1, log_fn=lambda s: None,
                 device="cpu")
    print(f"[distill] alpha 1, constant 0.5 teacher: loss {res.losses[0][1]:.4f} (ln 2 = 0.6931)")
    assert abs(res.losses[0][1] - float(np.log(2.0))) < 0.05


def test_remat_equals_plain_bit_for_bit(batch):
    a, b = fresh_state(), fresh_state()
    a, la = TL.make_train_step()(a, batch["features"], batch["label"])
    b, lb = TL.make_train_step(remat=True)(b, batch["features"], batch["label"])
    sa, sb = snapshot(a, la), snapshot(b, lb)
    assert sa["loss"] == sb["loss"]
    for part in ("grads", "params", "stats", "nu"):
        for k in sa[part]:
            assert np.array_equal(sa[part][k], sb[part][k]), (part, k)
    # folded in once: 0.99 * init + 0.01 * batch for the running var of the stem
    bn = b.model.DoubleConv_0.ConvBNRelu_0.BatchNorm_0
    assert bn.pending is None and not torch.equal(bn.var, torch.ones_like(bn.var))


def test_two_shards_of_one_device_are_one_batch(batch):
    a, b = fresh_state(), fresh_state()
    a, la = TL.make_train_step()(a, batch["features"], batch["label"])
    b, lb = TL.make_train_step(make_mesh(devices=["cpu", "cpu"]))(b, batch["features"],
                                                                    batch["label"])
    sa, sb = snapshot(a, la), snapshot(b, lb)
    assert sa["loss"] == sb["loss"]
    for k in sa["params"]:
        assert np.array_equal(sa["params"][k], sb["params"][k])


def test_collective_sums_every_round_in_group_order():
    """The shard groups' sum (train.loop._Collective): 12 threads, more than
    the cores, 200 rounds each under a short switch interval; every thread
    gets every round's sum, added in group order (the same bits each time)."""
    n, rounds = 12, 200
    coll = TL._Collective(n, torch.device("cpu"), False)
    vals = torch.randn(rounds, n, 3, generator=torch.Generator().manual_seed(0))
    expect = []
    for r in range(rounds):
        tot = vals[r, 0].clone()
        for k in range(1, n):
            tot = tot + vals[r, k]
        expect.append(tot)
    got = [[None] * rounds for _ in range(n)]

    def work(k):
        for r in range(rounds):
            got[k][r] = coll.sum_from(k, vals[r, k])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,), daemon=True) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for k in range(n):
        for r in range(rounds):
            assert torch.equal(got[k][r], expect[r]), (k, r)


_WORKER = r"""
import json, sys
sys.path.insert(0, "@REPO@")
import numpy as np, torch
torch.set_num_threads(1)
from azoom_torch.config import PipelineConfig
from azoom_torch.models import trainable
from azoom_torch.parallel.multihost import global_data_mesh, initialize
from azoom_torch.train import data as TD, loop as TL
initialize("@COORD@", 2, @PID@, device="cpu")
mesh = global_data_mesh()
b = TD.synth_batch(1, 4, PipelineConfig(mic_dist=0.04), n_samples=8192, device="cpu")
st = TL.create_state(trainable.FreqPreservingUNet(base=2), 0, (1, 513, 32, 2), device="cpu")
st, loss = TL.make_train_step(mesh)(st, b["features"], b["label"])
v = st.model.variables()
out = {"loss": np.float32(loss)}
out.update({"mu/" + k: m.numpy() for k, m in st.mu.items()})
def walk(prefix, node):
    for k, x in node.items():
        if isinstance(x, dict):
            walk(prefix + k + "/", x)
        else:
            out[prefix + k] = x
walk("params/", v["params"])
walk("stats/", v["batch_stats"])
np.savez("@OUT@", **out)
print(json.dumps({"rank": @PID@, "mesh": mesh.size, "owners": list(mesh.owners)}))
"""


def test_two_gloo_processes_take_one_global_step(batch, tmp_path):
    """Each process has a 120 s limit; a hung rendezvous fails the test."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER.replace("@REPO@", str(REPO))
         .replace("@COORD@", f"127.0.0.1:{port}").replace("@PID@", str(pid))
         .replace("@OUT@", str(tmp_path / f"rank{pid}.npz"))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rc={p.returncode}\n{err[-3000:]}"
        assert json.loads(out.strip().splitlines()[-1]) == {"rank": pid, "mesh": 2,
                                                            "owners": [0, 1]}
    ranks = [dict(np.load(tmp_path / f"rank{pid}.npz")) for pid in range(2)]
    for k in ranks[0]:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    one = fresh_state()
    init = {"params": one.model.variables()["params"]}
    one, loss = TL.make_train_step()(one, batch["features"], batch["label"])
    single = snapshot(one, loss)
    single["init"] = init
    r = ranks[0]
    sharded = {"loss": float(r["loss"]),
               "grads": {k[3:].replace(".", "/"): v for k, v in r.items() if k.startswith("mu/")},
               "params": {k[7:]: v for k, v in r.items() if k.startswith("params/")},
               "stats": {k[6:]: v for k, v in r.items() if k.startswith("stats/")}}
    assert_step_matches("two gloo shards against one process", single, sharded)


def test_resumed_fit_equals_uninterrupted(tmp_path):
    kw = dict(batch_size=1, n_samples=N, checkpoint_every=2, log_fn=lambda s: None, device="cpu")
    whole = TL.fit(trainable.FreqPreservingUNet(base=2), CFG, n_steps=5,
                   checkpoint_dir=tmp_path / "a", **kw)
    first = TL.fit(trainable.FreqPreservingUNet(base=2), CFG, n_steps=2,
                   checkpoint_dir=tmp_path / "b", **kw)
    assert first.steps_run == 2 and TL.latest_step(tmp_path / "b") == 2
    resumed = TL.fit(trainable.FreqPreservingUNet(base=2), CFG, n_steps=5,
                     checkpoint_dir=tmp_path / "b", **kw)
    assert resumed.steps_run == 3 and resumed.state.step == whole.state.step == 5
    a, b = snapshot(whole.state, 0.0), snapshot(resumed.state, 0.0)
    for part in ("grads", "params", "stats", "nu"):
        for k in a[part]:
            assert np.array_equal(a[part][k], b[part][k]), (part, k)
    assert sorted(p.name for p in (tmp_path / "a").glob("step_*.pt")) == [
        "step_000000002.pt", "step_000000004.pt", "step_000000005.pt"]
    restored, step = TL.restore_checkpoint(tmp_path / "a", TL.create_state(
        trainable.FreqPreservingUNet(base=2), 9, (1, 513, 32, 2), device="cpu"), step=4)
    assert step == 4 and restored.step == 4


def test_the_float64_yardstick_holds_each_leaf_on_its_own():
    """``train.rounding`` on the CPU at a tiny width (its card run on the CPU
    too): a float32 step lies within the bounds, and one wrong leaf, a bias
    or a BatchNorm statistic, is flagged on its own."""
    from azoom_torch.train import rounding

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 65, 16, 4)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 65, 16)) > 0.6).astype(np.float32))
    dist = rounding.step_distances(
        lambda: trainable.TPUFPU(base=16, fold=4, bneck=2), (1, 65, 16, 4), x, y, "cpu")
    print(f"[rounding] {rounding.summary(dist)}")
    assert dist["card"] == dist["cpu"] and not rounding.over_bound(dist)
    assert len(dist["card"]["grad"]) > 40 and len(dist["card"]["bn"]) > 40
    bias = next(k for k in dist["card"]["grad"] if k.endswith(".bias"))
    for kind, leaf, value in (("grad", bias, 2 * rounding.GRAD_BOUND),
                              ("bn", next(iter(dist["card"]["bn"])), 1e-4)):
        bad = copy.deepcopy(dist)
        bad["card"][kind][leaf] = value
        assert [(b[0], b[1], b[2]) for b in rounding.over_bound(bad)] == [(kind, "card", leaf)]
