"""Time the scene sweeps of this tree, and of earlier trees, on one NVIDIA GPU:

    python3 -m azoom_torch.parallel.sweep_timing [--against DIR[,DIR...]] [--runs N]

Each tree runs in a Python process of its own (its ``azoom_torch`` first on
the path), in turns: the earlier trees, this one twice, the earlier trees
again in reverse, so that a drift of the host shows as a difference between
a tree's two turns. A turn times, after one warm-up each, ``--runs`` calls
(default 7) of ``chip_smoke.py`` phase 23's two sweeps at 128 scenes of 2 s
(``oracle_sweep`` of randomized anechoic scenes with STOI; ``learned_sweep``
of ``RoomConfig()`` rooms with the int8 tpufpu_nano and hard-null) and of
their draw step alone (``sweep_scenes``), and of the room draw's power
reductions alone on its shapes (``room_powers``: the tree's
``sim.scene._row_power``, or the batched mean that came before it), the card
synchronised around each call. An earlier tree needs the
checkout's ``azoom/`` (the bundled nets) and ``cpp/`` (the RIR engine)
beside its ``azoom_torch/``; a symlink will do. Prints one line per turn and
writes the medians and every run to ``chiprun_out/sweep_timing.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

# The timed code, run in the turn's process: only calls that every tree
# since the sweeps were ported has.
_TURN = r"""
import json, sys, time
import torch
from azoom_torch.config import PipelineConfig, RoomConfig
from azoom_torch.models.pretrained import load_bundled
from azoom_torch.parallel.sweep import learned_sweep, oracle_sweep, sweep_scenes

runs, dev = int(sys.argv[1]), torch.device("cuda")
cfg, n, seed = PipelineConfig(mic_dist=0.04), 128, 23
model, _ = load_bundled("tpufpu_nano")
calls = {
    "oracle_sweep": lambda: oracle_sweep(seed, cfg, n_scenes=n, n_samples=32_000,
                                         with_stoi=True, randomize=True),
    "oracle_draw": lambda: sweep_scenes(seed, cfg, n, n_samples=32_000, randomize=True,
                                        device=dev),
    "learned_sweep": lambda: learned_sweep(seed, cfg, model, n_scenes=n, n_samples=32_000,
                                           room=RoomConfig(), beamformer="hard_null",
                                           feature_kind="physics"),
    "learned_draw": lambda: sweep_scenes(seed, cfg, n, n_samples=32_000, reverb=True,
                                         randomize=True, room=RoomConfig(), device=dev),
}
# the room sweep's power reductions alone (its target and interference at
# mic 0, then the noisy mixture), as the tree takes them
import azoom_torch.sim.scene as scene
power = getattr(scene, "_row_power", lambda x: torch.mean(x**2, dim=-1))
rows = [torch.randn(s, device=dev) for s in ((n, 32_000), (n, 32_000), (n, 2, 32_000))]
calls["room_powers"] = lambda: [power(x) for x in rows]
out = {}
for name, fn in calls.items():
    fn()
    ms = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out[name] = ms
print("SWEEP_TIMING " + json.dumps(out), flush=True)
"""


def _turn(tree: Path, runs: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", _TURN, str(runs)], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"sweep_timing: the turn in {tree} failed (rc {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("SWEEP_TIMING ")][-1]
    return json.loads(line.split(" ", 1)[1])


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_timing: no CUDA device", file=sys.stderr)
        return 2
    runs, earlier = 7, []
    if "--runs" in argv:
        runs = int(argv[argv.index("--runs") + 1])
    if "--against" in argv:
        earlier = [Path(p).resolve() for p in argv[argv.index("--against") + 1].split(",")]
    here = Path(__file__).resolve().parents[2]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    order = [*earlier, here, here, *reversed(earlier)]
    turns = []
    for tree in order:
        ms = _turn(tree, runs)
        turns.append({"tree": str(tree), "ms": ms})
        print(f"[sweep_timing] tree={tree} card='{card}' " + " ".join(
            f"{k}_median_ms={statistics.median(v):.2f}" for k, v in ms.items()), flush=True)
    medians = {}
    for tree in dict.fromkeys(order):
        runs_of = [t["ms"] for t in turns if t["tree"] == str(tree)]
        medians[str(tree)] = {k: statistics.median(x for r in runs_of for x in r[k])
                              for k in runs_of[0]}
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out", "sweep_timing.json").write_text(
        json.dumps({"card": card, "runs": runs, "medians": medians, "turns": turns}, indent=1))
    print(json.dumps({"ok": True, "card": card, "medians": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
