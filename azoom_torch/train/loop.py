"""Training loop: BCE mask estimation with checkpoints and resume
(counterpart of azoom.train.loop).

The reference jits an optax step over a flax state; here the state is a
trainable twin (``models.trainable``, ``models.blstm``, ``models.qcnn``)
with Adam's moments and the step count (:class:`TrainState`), and one step
is a forward in training mode, ``torch.autograd.grad`` of the loss, the
BatchNorm running statistics folded in once (``layers.commit_batch_stats``)
and Adam in optax's order (:func:`_adam_update`).

  * ``remat`` reruns the forward in the backward
    (``torch.utils.checkpoint``, non-reentrant); the rerun leaves the same
    pending statistics, which are folded in once after the step.
  * ``mesh`` (``parallel.mesh``) is data parallelism with the reference's
    semantics: the batch is split over the mesh (``shard_ranges``), the
    BatchNorm statistics and the loss are taken over the GLOBAL batch (the
    per-channel sums are all-reduced over the shards in the forward and the
    backward; per-shard statistics would be another model), and the
    gradients are summed, each shard's loss weighted by its share of the
    rows. The shards of one device run as one batch; distinct devices run a
    thread each (``run_on_devices``); a mesh spanning processes
    (``multihost.global_data_mesh``) all-reduces across them with
    ``torch.distributed``. Each process passes the same global batch.
  * Checkpoints are the port's own: an atomic ``torch.save`` (a temporary
    file, then a rename) of the net's parameters and BatchNorm statistics,
    Adam's moments and the step, every ``checkpoint_every`` steps; the last
    3 are kept, as orbax keeps them. The batches of step s are a function of
    (seed, s) (``train.data``), so a resumed run equals an uninterrupted one.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import threading
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from azoom_torch.config import PipelineConfig, resolve_device
from azoom_torch.models.layers import commit_batch_stats, current_sync, sync_batch_stats
from azoom_torch.parallel.mesh import Mesh, _device, run_on_devices, shard_ranges
from azoom_torch.train.data import mix_batch, synth_batch

__all__ = [
    "TrainState", "FitResult", "create_state", "bce_loss", "physics_residual", "mask_accuracy",
    "make_train_step", "fit", "save_checkpoint", "restore_checkpoint",
    "latest_step",
]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults (eps_root 0)
_KEEP = 3  # checkpoints kept


@dataclasses.dataclass
class TrainState:
    """The net (its parameters and BatchNorm statistics), Adam's first and
    second moments per parameter name, the step count and the learning
    rate."""

    model: torch.nn.Module
    mu: dict
    nu: dict
    step: int = 0
    learning_rate: float = 1e-4
    replicas: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def variables(self) -> dict:
        """The flax-shaped variables of the net (``params``, ``batch_stats``)."""
        return self.model.variables()


@dataclasses.dataclass
class FitResult:
    state: TrainState
    losses: list
    steps_run: int


def _generator(g) -> torch.Generator:
    return g if isinstance(g, torch.Generator) else torch.Generator().manual_seed(int(g))


def create_state(model, generator, sample_shape, learning_rate: float = 1e-4,
                 device=None) -> TrainState:
    """Draw the net's init from ``generator`` (a CPU ``torch.Generator`` or a
    seed) at ``sample_shape`` (B, F, T, C), move it to ``device`` (CUDA
    unless it names another), and start Adam (1e-4)."""
    model.init(_generator(generator), sample_shape)
    model.to(resolve_device(device)).train()
    zeros = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    return TrainState(model, zeros, {k: v.clone() for k, v in zeros.items()}, 0,
                      float(learning_rate))


def bce_loss(pred: torch.Tensor, label: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Binary cross-entropy of sigmoid outputs (torch ``nn.BCELoss``'s
    semantics, clipped at ``eps``)."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -torch.mean(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))


def physics_residual(features: torch.Tensor, pred: torch.Tensor,
                     feature_kind: str = "logmag_ipd") -> torch.Tensor:
    """The physics-informed mask residual mean(mask * (1 - cos IPD)): zero
    on the broadside steering manifold the training scenes put the target
    on (cos IPD is channel 2 of 'physics', the cosine of channel 1 of
    'logmag_ipd')."""
    if feature_kind == "physics":
        one_minus_cos = 1.0 - features[..., 2]
    else:
        one_minus_cos = 1.0 - torch.cos(features[..., 1])
    return torch.mean(pred * one_minus_cos)


def mask_accuracy(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Binary mask accuracy at threshold 0.5."""
    return torch.mean(((pred > 0.5) == (label > 0.5)).to(torch.float32))


def _adam_update(state: TrainState, grads: dict) -> None:
    """optax.adam(lr) in its order, in float32: mu = 0.1 g + 0.9 mu, nu =
    0.001 g^2 + 0.999 nu, the bias corrections 1 - b^count, u = mu_hat /
    (sqrt(nu_hat) + 1e-8) (eps_root 0), then p += -lr u."""
    count = state.step + 1
    bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(count))
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            g = grads[name]
            mu = state.mu[name].mul_(_B1).add_((1.0 - _B1) * g)
            nu = state.nu[name].mul_(_B2).add_((1.0 - _B2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
            p.add_(-state.learning_rate * u)
    state.step = count


class _Collective:
    """Sums over the local shard groups of a step (one thread each) and, in
    a process group, over the processes. Parts are summed in group order on
    the first group's device, so every group gets the same bits."""

    def __init__(self, n_local: int, home: torch.device, across_processes: bool):
        self.n, self.home, self.procs = n_local, home, across_processes
        self.cv = threading.Condition()
        self.parts: list = [None] * n_local
        self.arrived, self.gen, self.result = 0, 0, None

    def _finish(self, tot: torch.Tensor) -> torch.Tensor:
        if self.procs:
            dist.all_reduce(tot)
        return tot

    def sum_from(self, k: int, x: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return self._finish(x.clone()).to(x.device)
        with self.cv:
            gen = self.gen
            self.parts[k] = x
            self.arrived += 1
            if self.arrived == self.n:
                tot = self.parts[0].to(self.home)
                for part in self.parts[1:]:
                    tot = tot + part.to(self.home)
                self.result = self._finish(tot)
                self.parts = [None] * self.n
                self.arrived, self.gen = 0, self.gen + 1
                self.cv.notify_all()
            else:
                while self.gen == gen:
                    self.cv.wait()
            res = self.result
        return res.to(x.device)


@dataclasses.dataclass
class _Member:
    """One shard group's view of the collective (``layers.sync_batch_stats``)."""

    coll: _Collective
    k: int
    row_ratio: float

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.coll.sum_from(self.k, x)


def _loss_and_grads(model, features, label, remat, physics_fn, weight: float = 1.0):
    params = [p for _, p in model.named_parameters()]
    if remat:
        # the rerun may run on the autograd engine's device thread: give it
        # this shard's collective too
        coll = current_sync()
        ctx = (lambda: (contextlib.nullcontext(), sync_batch_stats(coll))) if coll else None
        kw = {"context_fn": ctx} if ctx else {}
        pred = torch.utils.checkpoint.checkpoint(model, features, use_reentrant=False, **kw)
    else:
        pred = model(features)
    loss = bce_loss(pred, label)
    if physics_fn is not None:
        loss = loss + physics_fn(features, pred)
    if weight != 1.0:
        loss = loss * weight
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip((k for k, _ in model.named_parameters()), grads))


def _sync_replicas(state: TrainState, devices) -> None:
    """One copy of the net per other device, its weights and statistics set
    to the master's."""
    for d in devices:
        if d == _device(state.device):
            state.replicas[d] = state.model
            continue
        if d not in state.replicas:
            state.replicas[d] = copy.deepcopy(state.model).to(d)
        with torch.no_grad():
            for (_, dst), (_, src) in zip(state.replicas[d].state_dict().items(),
                                          state.model.state_dict().items()):
                dst.copy_(src)
        state.replicas[d].train()


def make_train_step(mesh: Mesh | None = None, remat: bool = False,
                    physics_fn: Callable | None = None) -> Callable:
    """The train step ``step(state, features, label) -> (state, loss)``
    (the state updated in place). ``remat`` reruns the forward in the
    backward; ``mesh`` splits the batch over its devices with global
    BatchNorm statistics (module docstring); ``physics_fn(features, pred)``
    adds a penalty to the BCE objective."""

    def step(state: TrainState, features, label):
        model = state.model.train()
        if mesh is None:
            dev = state.device
            loss, grads = _loss_and_grads(model, torch.as_tensor(features).to(dev),
                                          torch.as_tensor(label).to(dev), remat, physics_fn)
            commit_batch_stats(model)
            _adam_update(state, grads)
            return state, loss
        return _sharded_step(state, mesh, features, label, remat, physics_fn)

    return step


def _sharded_step(state, mesh, features, label, remat, physics_fn):
    features, label = torch.as_tensor(features), torch.as_tensor(label)
    B = features.shape[0]
    groups: dict = {}
    for i, r in enumerate(shard_ranges(B, mesh)):
        if mesh.is_local(i):
            groups.setdefault(_device(mesh.devices[i]), []).extend(r)
    devices = list(groups)
    _sync_replicas(state, devices)
    across = dist.is_initialized() and dist.get_world_size() > 1 and mesh.owners is not None
    coll = _Collective(len(devices), devices[0], across)

    def job(k: int, d: torch.device):
        rows = torch.tensor(groups[d])
        member = _Member(coll, k, B / len(rows))
        with sync_batch_stats(member):
            return _loss_and_grads(state.replicas[d], features[rows].to(d), label[rows].to(d),
                                   remat, physics_fn, len(rows) / B)

    parts = run_on_devices([(d, (lambda k=k, d=d: job(k, d))) for k, d in enumerate(devices)])
    home = state.device
    names = list(parts[0][1])
    loss = parts[0][0].to(home)
    grads = {n: parts[0][1][n].to(home) for n in names}
    for part_loss, part_grads in parts[1:]:  # in group order: the same bits every step
        loss = loss + part_loss.to(home)
        for n in names:
            grads[n] = grads[n] + part_grads[n].to(home)
    if across:
        buf = torch.cat([loss.reshape(1)] + [grads[n].reshape(-1) for n in names])
        dist.all_reduce(buf)
        loss, off = buf[0], 1
        for n in names:
            k = grads[n].numel()
            grads[n] = buf[off:off + k].reshape(grads[n].shape)
            off += k
    commit_batch_stats(state.model)
    for d in devices:
        for m in state.replicas[d].modules():
            if hasattr(m, "pending"):
                m.pending = None
    _adam_update(state, grads)
    return state, loss


# -- checkpoints --------------------------------------------------------------


def _ckpt_path(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step:09d}.pt"


def latest_step(checkpoint_dir) -> int | None:
    """The latest saved step under ``checkpoint_dir``, or None."""
    steps = sorted(int(p.stem[5:]) for p in Path(checkpoint_dir).glob("step_*.pt"))
    return steps[-1] if steps else None


def save_checkpoint(checkpoint_dir, state: TrainState, keep: int = _KEEP) -> Path:
    """Write the state atomically (a temporary file, then a rename) as
    ``step_<step>.pt`` and keep the last ``keep``."""
    ckpt_dir = Path(checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    blob = {
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "mu": {k: v.cpu() for k, v in state.mu.items()},
        "nu": {k: v.cpu() for k, v in state.nu.items()},
        "step": int(state.step),
        "learning_rate": float(state.learning_rate),
    }
    path = _ckpt_path(ckpt_dir, state.step)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, path)
    steps = sorted(int(p.stem[5:]) for p in ckpt_dir.glob("step_*.pt"))
    for s in steps[:-keep]:
        _ckpt_path(ckpt_dir, s).unlink(missing_ok=True)
    return path


def restore_checkpoint(checkpoint_dir, state_template: TrainState, step: int | None = None):
    """Restore a state saved by :func:`save_checkpoint` into
    ``state_template`` (its net built alike, on its device). Returns
    (state, step)."""
    step = latest_step(checkpoint_dir) if step is None else int(step)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    blob = torch.load(_ckpt_path(Path(checkpoint_dir), step), map_location="cpu",
                      weights_only=True)
    st = state_template
    with torch.no_grad():
        st.model.load_state_dict(blob["model"])
        for name in st.mu:
            st.mu[name].copy_(blob["mu"][name])
            st.nu[name].copy_(blob["nu"][name])
    st.step = int(blob["step"])
    st.learning_rate = float(blob["learning_rate"])
    return st, step


# -- fit ------------------------------------------------------------------------


def fit(
    model,
    cfg: PipelineConfig,
    n_steps: int = 1000,
    batch_size: int = 8,
    learning_rate: float = 1e-4,
    feature_kind: str = "logmag_ipd",
    n_samples: int = 32_000,
    reverb: bool = False,
    angle_jitter_deg: float = 0.0,
    interferer_kind: str = "speech",
    corpus_root: str | Path | None = None,
    init_variables: Any | None = None,
    seed: int = 0,
    checkpoint_dir: str | Path | None = None,
    checkpoint_every: int = 200,
    resume: bool = True,
    mesh: Mesh | None = None,
    remat: bool = False,
    log_every: int = 50,
    log_fn: Callable[[str], None] = print,
    teacher_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    distill_alpha: float = 0.5,
    pinn_weight: float = 0.0,
    native_loader: bool = False,
    device=None,
) -> FitResult:
    """Train a mask net (a trainable twin, built here) on on-the-fly scenes.

    The reference's arguments: ``corpus_root`` crops real recordings
    (``sim.datasets.LocalCorpus``; ``native_loader`` the C++ prefetch engine,
    ``sim.corpus_native.NativeCorpus``, which raises where it cannot be
    built) and mixes them with :func:`train.data.mix_batch`;
    ``interferer_kind`` picks the synthesized interferers; ``teacher_fn``
    (features -> mask) distils: the target is (1 - ``distill_alpha``) IBM +
    ``distill_alpha`` teacher; ``pinn_weight`` > 0 adds
    :func:`physics_residual`; ``init_variables`` (flax-shaped, e.g.
    ``models.trainable.from_bundled(...)[0].variables()``) warm-starts, and
    a checkpoint under ``checkpoint_dir`` takes precedence with ``resume``.
    The net and the batches live on ``device`` (CUDA unless it names
    another; with a mesh, its first local device holds the master copy)."""
    n_channels = {"logmag_ipd": 2, "physics": 4}[feature_kind]
    if mesh is not None:
        device = next(d for i, d in enumerate(mesh.devices) if mesh.is_local(i))
    dev = resolve_device(device)
    state = create_state(model, seed, (1, cfg.n_freqs, 16, n_channels), learning_rate, dev)
    if init_variables is not None:
        cur = state.model.variables()
        state.model.load_variables({"params": init_variables["params"],
                                    "batch_stats": init_variables.get(
                                        "batch_stats", cur.get("batch_stats", {}))})

    start = 0
    if checkpoint_dir is not None:
        checkpoint_dir = Path(checkpoint_dir).absolute()
        checkpoint_dir.mkdir(parents=True, exist_ok=True)
        if resume and latest_step(checkpoint_dir) is not None:
            state, start = restore_checkpoint(checkpoint_dir, state)
            log_fn(f"[TRAIN] resumed from step {start}")

    corpus = native = None
    if corpus_root is not None:
        if native_loader:
            from azoom_torch.sim.corpus_native import NativeCorpus

            native = NativeCorpus(corpus_root, cfg.fs, n_signals=3 * batch_size,
                                  n_samples=n_samples, seed=seed)
            log_fn(f"[TRAIN] native corpus loader: {len(native)} files under {corpus_root}")
        else:
            from azoom_torch.sim.datasets import LocalCorpus

            corpus = LocalCorpus(corpus_root, cfg.fs)
            if not len(corpus):
                raise FileNotFoundError(f"no wavs under {corpus_root}")
            log_fn(f"[TRAIN] corpus: {len(corpus)} files under {corpus_root}")

    physics_fn = None
    if pinn_weight > 0.0:
        physics_fn = lambda f, p: pinn_weight * physics_residual(f, p, feature_kind)  # noqa: E731
    train_step = make_train_step(mesh, remat=remat, physics_fn=physics_fn)
    losses = []
    try:
        for i in range(start, n_steps):
            if corpus is not None or native is not None:
                if native is not None:
                    sources = native.next_batch()
                else:
                    rng = np.random.default_rng(seed * 1_000_003 + i)
                    sources = corpus.sample_batch(rng, 3 * batch_size, n_samples)
                batch = mix_batch(seed, np.asarray(sources).reshape(batch_size, 3, n_samples),
                                  cfg, feature_kind, angle_jitter_deg, reverb=reverb, step=i,
                                  device=dev)
            else:
                batch = synth_batch(seed, batch_size, cfg, feature_kind, n_samples,
                                    angle_jitter_deg, reverb=reverb,
                                    interferer_kind=interferer_kind, step=i, device=dev)
            label = batch["label"]
            if teacher_fn is not None:
                with torch.no_grad():
                    label = (1.0 - distill_alpha) * label + distill_alpha * teacher_fn(
                        batch["features"])
            state, loss = train_step(state, batch["features"], label)
            if (i + 1) % log_every == 0 or i == start:
                losses.append((i + 1, float(loss)))
                log_fn(f"[TRAIN] step {i + 1}/{n_steps} bce={float(loss):.4f}")
            if checkpoint_dir is not None and ((i + 1) % checkpoint_every == 0 or i + 1 == n_steps):
                save_checkpoint(checkpoint_dir, state)
    finally:
        if native is not None:
            native.close()
    return FitResult(state=state, losses=losses, steps_run=n_steps - start)
