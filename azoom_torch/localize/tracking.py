"""DOA tracking over time (counterpart of azoom.localize.tracking): smooth
azimuth trajectories from noisy per-chunk angular spectra.

A moving talker or a panning camera needs a bearing per chunk, and the
per-chunk argmax of the IPD angle histogram zig-zags whenever an interferer
out-talks the target. The trackers impose temporal coherence:

- ``viterbi_track``: the MAP angle path through the (chunk x angle) trellis
  under a Gaussian angular-rate motion model (offline);
- ``causal_track``: forward-Viterbi filtering, the running score's argmax
  per chunk, with optional fixed-lag smoothing and a camera aiming prior;
- ``momentum_track``: the same trellis over (direction, angle) states, which
  keeps a talker's identity through a bearing crossing (offline or causal);
- ``track_two_sources``: the target's momentum track, then a second track on
  the spectra with the target's corridor removed;
- ``ema_track``: rate-gated peak picking with exponential smoothing.

Each accepts the camera's field of view centred on a scalar or on a (C,)
trajectory. Everything is plain PyTorch on the device of the histograms
(C, A) float32: the scan is a Python loop over chunks whose steps stay on
the device (nothing waits for the host until the caller reads the bearings).
The trellis step keeps the reference's operation order,
``(score[:, None] + trans).max(0) + emis`` with ``trans = -0.5 (diff /
sigma)^2`` in float32, and ties go to the first index, so the bearings come
out equal to the reference's, not merely close.
"""

from __future__ import annotations

import torch

__all__ = [
    "viterbi_track", "causal_track", "ema_track", "momentum_track", "track_two_sources",
    "transition", "viterbi_step",
]


def transition(angles: torch.Tensor, trans_sigma_deg: float) -> torch.Tensor:
    """Gaussian motion-model log-penalty (A_prev, A_next), float32."""
    diff = angles[:, None] - angles[None, :]
    return -0.5 * (diff / trans_sigma_deg) ** 2


def viterbi_step(score_prev: torch.Tensor, trans: torch.Tensor,
                 emis: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One max-plus trellis step: (score (A_next,) before re-zeroing, the
    best predecessor of each state (A_next,))."""
    best, bp = torch.max(score_prev[:, None] + trans, dim=0)
    return best + emis, bp


def _center(fov_center_deg, angles: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(fov_center_deg, dtype=torch.float32, device=angles.device)


def _emissions(angles, hists, fov_center_deg, fov_width_deg, floor) -> torch.Tensor:
    """Log-probability emissions (C, A): each chunk's histogram normalised
    to a distribution over angles plus ``floor``, -1e9 outside the field of
    view (centred on a scalar or a (C,) trajectory)."""
    hists = torch.clamp(hists, min=0.0)
    p = hists / (torch.sum(hists, dim=-1, keepdim=True) + 1e-20)
    emis = torch.log(p + floor)
    if fov_center_deg is not None:
        center = _center(fov_center_deg, angles)
        in_fov = torch.abs(angles - center[..., None]) <= fov_width_deg / 2.0
        emis = torch.where(in_fov, emis, -1e9)
    return torch.broadcast_to(emis, hists.shape)


def _aiming_prior(emis, angles, fov_center_deg, init_prior_sigma_deg) -> torch.Tensor:
    """Chunk 0's emissions plus a Gaussian prior around the camera axis
    (the field of view's first centre)."""
    if init_prior_sigma_deg is None or fov_center_deg is None:
        return emis
    center0 = _center(fov_center_deg, angles).reshape(-1)[0]
    emis = emis.clone()
    emis[0] += -0.5 * ((angles - center0) / init_prior_sigma_deg) ** 2
    return emis


def _forward(emis: torch.Tensor, trans: torch.Tensor) -> tuple[torch.Tensor, list]:
    """The forward pass: re-zeroed scores (C, S) and the backpointers of
    chunks 1 .. C-1, each (S,)."""
    score = emis[0] - torch.max(emis[0])
    scores, bps = [score], []
    for c in range(1, emis.shape[0]):
        score, bp = viterbi_step(score, trans, emis[c])
        score = score - torch.max(score)
        scores.append(score)
        bps.append(bp)
    return torch.stack(scores), bps


def _backtrack(last: torch.Tensor, bps: list) -> torch.Tensor:
    """The state path (C,) ending at ``last``: each backpointer maps a
    state at chunk c to its predecessor at c - 1."""
    idx = last.reshape(1)
    path = [idx]
    for bp in reversed(bps):
        idx = bp.index_select(0, idx)
        path.append(idx)
    return torch.cat(path[::-1])


def viterbi_track(
    angles: torch.Tensor,
    hists: torch.Tensor,
    trans_sigma_deg: float = 12.0,
    fov_center_deg=None,
    fov_width_deg: float = 180.0,
    floor: float = 1e-6,
) -> torch.Tensor:
    """MAP angle path through the chunk-time angular-spectrum trellis.

    angles (A,) degrees; hists (C, A) non-negative per-chunk spectra;
    ``trans_sigma_deg`` the Gaussian motion-model scale in degrees per
    chunk hop; ``fov_center_deg`` / ``fov_width_deg`` an optional camera
    field of view (centre scalar or (C,)); ``floor`` the emission floor.
    Returns (C,) bearings in degrees.
    """
    emis = _emissions(angles, hists, fov_center_deg, fov_width_deg, floor)
    scores, bps = _forward(emis, transition(angles, trans_sigma_deg))
    return angles[_backtrack(torch.argmax(scores[-1]), bps)]


def causal_track(
    angles: torch.Tensor,
    hists: torch.Tensor,
    trans_sigma_deg: float = 12.0,
    fov_center_deg=None,
    fov_width_deg: float = 180.0,
    floor: float = 1e-6,
    lag: int = 0,
    init_prior_sigma_deg: float | None = None,
) -> torch.Tensor:
    """Forward-Viterbi filtering: chunk c's bearing uses chunks <= c + lag.

    ``lag``: fixed-lag smoothing, the running argmax at chunk
    min(c + lag, C - 1) backtracked to chunk c. ``init_prior_sigma_deg``: a
    Gaussian aiming prior on chunk 0 around the field of view's first
    centre (needs ``fov_center_deg``). Returns (C,) bearings in degrees.
    """
    emis = _emissions(angles, hists, fov_center_deg, fov_width_deg, floor)
    emis = _aiming_prior(emis, angles, fov_center_deg, init_prior_sigma_deg)
    scores, bps = _forward(emis, transition(angles, trans_sigma_deg))
    if lag == 0:
        return angles[torch.argmax(scores, dim=-1)]
    C, A = scores.shape
    # bp_all[c] maps a state at chunk c to its predecessor (identity at c = 0,
    # never followed).
    bp_all = torch.stack([torch.arange(A, device=angles.device)] + bps)
    idx = torch.arange(C, device=angles.device)
    pos = torch.clamp(idx + lag, max=C - 1)
    state = torch.argmax(scores[pos], dim=-1)
    for _ in range(lag):
        move = pos > idx
        state = torch.where(move, bp_all[pos, state], state)
        pos = torch.where(move, pos - 1, pos)
    return angles[state]


def _momentum_transition(angles, trans_sigma_deg, rate_deg_per_chunk, switch_penalty):
    """(3A, 3A) log-transition over states (d, theta), d in {-1, 0, +1}:
    row d * A + a_prev, column d' * A + a_next."""
    A = angles.shape[0]
    dirs = torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float32, device=angles.device)
    step = angles[None, :] - angles[:, None]  # (A_prev, A_next)
    expected = dirs[:, None, None] * rate_deg_per_chunk
    step_cost = -0.5 * ((step[None] - expected) / trans_sigma_deg) ** 2  # (D', A_prev, A_next)
    switch = -switch_penalty * torch.abs(dirs[:, None] - dirs[None, :])  # (D, D')
    trans = switch[:, None, :, None] + step_cost[None].permute(0, 2, 1, 3)
    return trans.reshape(3 * A, 3 * A)


def momentum_track(
    angles: torch.Tensor,
    hists: torch.Tensor,
    trans_sigma_deg: float = 3.0,
    rate_deg_per_chunk: float = 6.0,
    switch_penalty: float = 12.0,
    fov_center_deg=None,
    fov_width_deg: float = 180.0,
    floor: float = 1e-6,
    causal: bool = False,
    init_prior_sigma_deg: float | None = None,
) -> torch.Tensor:
    """Viterbi tracking with a direction (momentum) state: direction d'
    predicts a step of d' * ``rate_deg_per_chunk``, and a change of
    direction costs ``switch_penalty`` per unit, so the MAP path carries a
    talker through a bearing crossing instead of swapping identities.
    ``causal`` runs the forward filter; ``init_prior_sigma_deg`` the aiming
    prior on chunk 0. Returns (C,) bearings in degrees."""
    emis = _emissions(angles, hists, fov_center_deg, fov_width_deg, floor)
    emis = _aiming_prior(emis, angles, fov_center_deg, init_prior_sigma_deg)
    A = angles.shape[0]
    trans = _momentum_transition(angles, trans_sigma_deg, rate_deg_per_chunk, switch_penalty)
    scores, bps = _forward(emis.repeat(1, 3), trans)  # emissions blind to direction
    if causal:
        return angles[torch.argmax(scores, dim=-1) % A]
    return angles[_backtrack(torch.argmax(scores[-1]), bps) % A]


def track_two_sources(
    angles: torch.Tensor,
    hists: torch.Tensor,
    trans_sigma_deg: float = 3.0,
    rate_deg_per_chunk: float = 6.0,
    switch_penalty: float = 12.0,
    fov_center_deg=None,
    fov_width_deg: float = 180.0,
    floor: float = 1e-6,
    causal: bool = False,
    init_prior_sigma_deg: float | None = None,
    exclusion_deg: float = 10.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The target's momentum track (with the field of view and the aiming
    prior), then the strongest other source's, tracked with no gate on the
    spectra with the target's +/- ``exclusion_deg`` corridor removed.
    Returns (target (C,), other (C,)) in degrees."""
    kw = dict(trans_sigma_deg=trans_sigma_deg, rate_deg_per_chunk=rate_deg_per_chunk,
              switch_penalty=switch_penalty, fov_width_deg=fov_width_deg, floor=floor,
              causal=causal)
    target = momentum_track(angles, hists, fov_center_deg=fov_center_deg,
                            init_prior_sigma_deg=init_prior_sigma_deg, **kw)
    keep = torch.abs(angles[None, :] - target[:, None]) > exclusion_deg
    residual = torch.where(keep, torch.clamp(hists, min=0.0), 0.0)
    return target, momentum_track(angles, residual, fov_center_deg=None, **kw)


def ema_track(
    angles: torch.Tensor,
    hists: torch.Tensor,
    rate_deg_per_chunk: float = 20.0,
    alpha: float = 0.6,
    fov_center_deg=None,
    fov_width_deg: float = 180.0,
    floor: float = 1e-6,
) -> torch.Tensor:
    """Causal point tracker: chunk 0 takes the (FOV-gated) peak; each later
    chunk the peak within +/- ``rate_deg_per_chunk`` of the previous
    estimate, blended as ``alpha * peak + (1 - alpha) * theta``. A wrong
    early lock is permanent. Returns (C,) bearings in degrees."""
    emis = _emissions(angles, hists, fov_center_deg, fov_width_deg, floor)
    theta = angles[torch.argmax(emis[0])]
    path = [theta]
    # The reference's compiled blend is one fused multiply-add,
    # fma(1 - alpha, theta, alpha * peak): the product is exact in float64,
    # so the float64 sum rounded to float32 gives the same bits.
    keep = float(torch.tensor(1.0 - alpha, dtype=torch.float32))
    for c in range(1, emis.shape[0]):
        gated = torch.where(torch.abs(angles - theta) <= rate_deg_per_chunk, emis[c], -1e9)
        moved = alpha * angles[torch.argmax(gated)]
        theta = (keep * theta.double() + moved.double()).float()
        path.append(theta)
    return torch.stack(path)
