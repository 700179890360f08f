"""How far a float32 train step lies from the same step in float64, leaf by
leaf, on the card and on the CPU.

A float32 step is ill-conditioned: BatchNorm's fast variance over few
bottleneck frames, and ReLU and max-pool decisions near ties, turn rounding
into gradient differences of up to a few percent of a leaf. So the card's
float32 step is not held to the CPU's but both to the same step in float64
on the card (:func:`step_distances`): for each live parameter the relative
L2 distance of its gradient (Adam's first moment after the step, 0.1 g),
for each BatchNorm statistic that of its update (after the step minus
before), and the loss's absolute distance. :func:`over_bound` holds each
leaf on its own, so a fault confined to one small leaf shows:

- every gradient, on the card and on the CPU, within ``GRAD_BOUND`` of
  float64. The card is not held to a multiple of the CPU's distance here:
  the CPU's distance is bimodal (a run either makes the float64 step's
  near-tie decisions or not, and one other decision moves every leaf
  upstream of it by 1e-3 to 1e-2), so in some seeds it is ~1e-6 at every
  leaf while the card's is ~3e-3;
- every BatchNorm statistic's update and the loss on the card within
  ``CARD_FACTOR`` times the CPU's distance + ``FLOOR``: the forward is well
  conditioned, and the card's distance follows the CPU's.

The bounds come from the readings of

    python3 -m azoom_torch.train.rounding --seeds 0 1 2 3 4 5 6 7 --out FILE

on the card (per seed: the init and a batch of 2 scenes, for the nano net
at 64 frames and a narrow TPUFPU at 32), which prints each seed's largest
distances and card-to-CPU ratios and writes every distance to ``FILE`` as
JSON.
"""

from __future__ import annotations

import argparse
import json

import torch

from azoom_torch.config import PipelineConfig, resolve_device
from azoom_torch.models.trainable import TPUFPU
from azoom_torch.train.data import synth_batch
from azoom_torch.train.loop import create_state, make_train_step

__all__ = ["GRAD_BOUND", "CARD_FACTOR", "FLOOR", "CONFIGS", "step_distances", "over_bound",
           "summary"]

# 3 x the CPU's largest leaf distance over seeds 0-7 of both CONFIGS (1.20e-2;
# the card's largest 1.35e-2)
GRAD_BOUND = 3.6e-2
# the card / CPU ratio of a BatchNorm update reached 1.57 over those readings
CARD_FACTOR = 3.0
FLOOR = 1e-6

# name: (TPUFPU keywords, samples per scene, sample shape)
CONFIGS = {
    "nano": (dict(base=64, fold=4, bneck=4, dec_div=2, enc_div=2), 32_000, (1, 513, 64, 4)),
    "narrow": (dict(base=32, fold=4, bneck=4, dec_div=2, enc_div=2), 16_000, (1, 513, 32, 4)),
}


def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).norm() / ref.norm())


def step_distances(make_net, sample_shape, features, label, device, init_seed: int = 0) -> dict:
    """One step of ``make_net()`` from the init of ``init_seed`` on the CPU
    and on ``device`` in float32 and on ``device`` in float64. Returns
    ``{"cpu": d, "card": d}``, each ``d`` = ``{"loss": |loss - loss64|,
    "grad": {parameter: relative L2}, "bn": {statistic: relative L2}}`` from
    float64. Parameters whose float64 gradient is below 1e-5 of the net's
    largest (zero in exact arithmetic: a conv bias before a BatchNorm) are
    left out."""
    runs = {}
    for name, d, dtype in (("cpu", "cpu", torch.float32), ("card", device, torch.float32),
                           ("f64", device, torch.float64)):
        st = create_state(make_net(), init_seed, sample_shape, device=d)
        if dtype == torch.float64:
            st.model.double()
            st.mu = {k: v.double() for k, v in st.mu.items()}
            st.nu = {k: v.double() for k, v in st.nu.items()}
        before = {k: b.detach().cpu().double().clone() for k, b in st.model.named_buffers()}
        _, loss = make_train_step()(st, features.to(d), label.to(d))
        runs[name] = (float(loss), {k: m.cpu().double() for k, m in st.mu.items()},
                      {k: b.cpu().double() - before[k] for k, b in st.model.named_buffers()})
        del st
    loss64, mu64, bn64 = runs["f64"]
    top = max(float(m.abs().max()) for m in mu64.values())
    live = [k for k, m in mu64.items() if float(m.abs().max()) >= 1e-5 * top]
    moved = [k for k, b in bn64.items() if float(b.norm()) > 0]
    return {name: dict(loss=abs(runs[name][0] - loss64),
                       grad={k: _rel_l2(runs[name][1][k], mu64[k]) for k in live},
                       bn={k: _rel_l2(runs[name][2][k], bn64[k]) for k in moved})
            for name in ("cpu", "card")}


def over_bound(dist: dict) -> list:
    """The (kind, device, leaf, distance) readings beyond their bounds."""
    card, cpu = dist["card"], dist["cpu"]
    bad = [("grad", d, k, v) for d in ("card", "cpu") for k, v in dist[d]["grad"].items()
           if v > GRAD_BOUND]
    bad += [("bn", "card", k, v) for k, v in card["bn"].items()
            if v > CARD_FACTOR * cpu["bn"][k] + FLOOR]
    if card["loss"] > CARD_FACTOR * cpu["loss"] + FLOOR:
        bad.append(("loss", "card", "", card["loss"]))
    return bad


def summary(dist: dict) -> dict:
    """The largest gradient distance on each device, and the largest card /
    (CPU + FLOOR) ratio of the BatchNorm updates and of the loss."""
    card, cpu = dist["card"], dist["cpu"]
    return dict(grad_card=max(card["grad"].values()), grad_cpu=max(cpu["grad"].values()),
                bn_ratio=max(v / (cpu["bn"][k] + FLOOR) for k, v in card["bn"].items()),
                loss_ratio=card["loss"] / (cpu["loss"] + FLOOR))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--device", default=None, help="the card (default) or another device")
    ap.add_argument("--out", default=None, help="write every distance here as JSON")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = PipelineConfig(mic_dist=0.04)
    rows = []
    for name in args.configs:
        kw, n_samples, shape = CONFIGS[name]
        for seed in args.seeds:
            b = synth_batch(seed, 2, cfg, "physics", n_samples=n_samples, device="cpu")
            dist = step_distances(lambda: TPUFPU(**kw), shape, b["features"], b["label"], device,
                                  init_seed=seed)
            print(json.dumps(dict(config=name, seed=seed, **summary(dist),
                                  over_bound=len(over_bound(dist)))), flush=True)
            rows.append(dict(config=name, seed=seed, **dist))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
