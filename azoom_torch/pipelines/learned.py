"""Learned-mask enhancement, the serving path (counterpart of
azoom.pipelines.learned for ``beamformer="mvdr"`` and ``"hard_null"``):

    STFT -> steer-align -> features (logmag_ipd or physics) -> conv mask net
         -> (FOV covariance gate) -> masked MVDR + floored mask post-filter
            + high-pass, or hybrid hard-null + raw mask post-filter + 200 Hz
            mic-0 bypass -> (HRNR post-filter) -> iSTFT

Everything runs on the device of the mixture. On CUDA the mask net's 3x3
convs run on the int8 conv kernel and the beamformer on its fused kernel
(MVDR or hard-null), one launch for the whole batch, with one steering
vector shared or one per batch entry (the tracked pipeline steers each
chunk at its own bearing); on the CPU they take
their plain PyTorch versions. ``learned_enhance_streaming`` runs the 2 s /
50 % chunker with all chunks as one batch.
"""

from __future__ import annotations

import torch

from azoom_torch.beam.postfilter import harmonic_regeneration
from azoom_torch.config import PipelineConfig
from azoom_torch.dsp.delays import steer_rotate, steering_vector
from azoom_torch.dsp.stft import istft, rfft_freqs, stft
from azoom_torch.kernels.mvdr_kernel import masked_mvdr_fused
from azoom_torch.kernels.nullsteer_kernel import hard_null_fused
from azoom_torch.masks.features import logmag_ipd_features, physics_aware_features
from azoom_torch.masks.geometric import apply_fov_gate, fov_noise_gate
from azoom_torch.models.unet import pad_frames
from azoom_torch.stream.chunker import streaming_enhance

__all__ = ["predict_mask", "learned_enhance", "learned_enhance_streaming"]


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.buffers()).device


_FEATURES = {"logmag_ipd": logmag_ipd_features, "physics": physics_aware_features}


def predict_mask(
    model,
    Y: torch.Tensor,
    feature_kind: str = "logmag_ipd",
    pad_multiple: int = 16,
    ipd_scale=1.0,
    pair_mode: str = "mean",
) -> torch.Tensor:
    """STFT (..., M, F, T) -> target mask (..., F, T) via the mask net:
    features ('logmag_ipd' or 'physics', the kind the net was trained on),
    time padding to the U-Net's pool factor, cropping back."""
    if feature_kind not in _FEATURES:
        raise ValueError(f"feature_kind must be 'logmag_ipd' or 'physics', got {feature_kind!r}")
    feats = _FEATURES[feature_kind](Y, ipd_scale, pair_mode=pair_mode)
    unbatched = feats.ndim == 3
    if unbatched:
        feats = feats[None]
    lead = feats.shape[:-3]
    feats = feats.reshape((-1,) + tuple(feats.shape[-3:]))
    feats, t_orig = pad_frames(feats, pad_multiple)
    with torch.inference_mode():
        mask = model(feats.contiguous())[..., :t_orig].contiguous()
    mask = mask.reshape(lead + tuple(mask.shape[-2:]))
    return mask[0] if unbatched else mask


def learned_enhance(
    mixture: torch.Tensor,
    model,
    cfg: PipelineConfig,
    beamformer: str = "mvdr",
    feature_kind: str = "logmag_ipd",
    mask_floor: float = 0.05,
    length: int | None = None,
    fov_deg=None,
    steer_deg=None,
    train_mic_dist: float | None = None,
    n_nulls: int = 1,
    steer_align: bool = True,
    harmonic_regen: bool = False,
) -> torch.Tensor:
    """Whole-signal learned enhancement: (..., M, n) -> (..., n), float32.

    ``beamformer``: 'mvdr' (post-filter: the mask floored at ``mask_floor``,
    high-pass at cfg.hp_cutoff_hz) or 'hard_null' (the Final-generation
    hybrid: phase-normalised steering, raw un-floored mask post-filter,
    mic 0 passed through below 200 Hz). ``feature_kind`` must be the one
    the net was trained on (``load_bundled`` returns it). ``fov_deg`` gates the noise
    covariance of either by the camera's field of view around the look
    direction (masks.geometric.fov_noise_gate). ``n_nulls`` acts at M > 2
    only, which is not ported. ``harmonic_regen`` runs the HRNR stage-2
    post-filter (beam.postfilter) on the beamformer's unmasked output with
    the stage-1 gain: the floored mask for MVDR, the raw mask for hard-null.

    ``steer_deg`` overrides ``cfg.angle_target_deg``: a float, a 0-d tensor or
    one bearing per leading index of the mixture (a (C,) tensor for C
    chunks). ``steer_align`` rotates the STFT by the conjugate steering
    vector before the features, so the look direction appears broadside to
    the net (an exact no-op, and skipped, at a static 90 deg on a linear
    array).
    ``train_mic_dist`` enables geometry adaptation (phase features scaled
    by train_mic_dist / the first pair's spacing). The mixture and the
    model must be on the same device.
    """
    if beamformer in ("rmvb", "rtf", "wpd"):
        raise NotImplementedError(
            f"beamformer {beamformer!r} is not ported; it is queued "
            "(ROADMAP.md Queue A item 9)"
        )
    if beamformer not in ("mvdr", "hard_null"):
        raise ValueError(f"unknown beamformer {beamformer!r}")
    mixture = torch.as_tensor(mixture)
    if mixture.device != _model_device(model):
        raise ValueError(
            f"mixture is on {mixture.device} but the model is on {_model_device(model)}"
        )
    cfg = cfg.for_input(mixture)
    if cfg.n_mics != 2:
        raise NotImplementedError(
            "M > 2 beamforming needs azoom/beam/linalgmm.py, which is queued for a later slice"
        )
    dev = mixture.device
    n = mixture.shape[-1]
    length = n if length is None else length
    steer = cfg.angle_target_deg if steer_deg is None else steer_deg
    # Explicit geometry: IPD from the first pair only, adaptation by that
    # pair's spacing, and no broadside shortcut for steer-align.
    pair_mode = "mean"
    d_feat = cfg.mic_dist
    if cfg.mic_positions is not None:
        pair_mode = "first"
        p0 = cfg.mic_positions[0] + (0.0, 0.0)
        p1 = cfg.mic_positions[1] + (0.0, 0.0)
        d_feat = ((p0[0] - p1[0]) ** 2 + (p0[1] - p1[1]) ** 2) ** 0.5
    ipd_scale = 1.0 if train_mic_dist is None else train_mic_dist / d_feat
    geom = cfg.geometry()
    if geom is not None:
        geom = geom.to(dev)

    with torch.inference_mode():
        Y = stft(mixture, cfg.n_fft, cfg.hop)
        freqs = rfft_freqs(cfg.n_fft, cfg.fs, device=dev)
        Y_feat = Y
        if (isinstance(steer, (int, float)) and float(steer) == 90.0
                and cfg.mic_positions is None):
            steer_align = False
        if steer_align:
            Y_feat = steer_rotate(Y, steering_vector(freqs, steer, cfg.mic_dist, cfg.c,
                                                     cfg.n_mics, positions=geom))
        tgt_mask = predict_mask(model, Y_feat, feature_kind, ipd_scale=ipd_scale,
                                pair_mode=pair_mode)
        noise_mask = 1.0 - tgt_mask
        if fov_deg is not None:
            gate, protect, valid = fov_noise_gate(
                Y, steer, fov_deg, cfg.mic_dist, cfg.fs, cfg.c, positions=geom)
            noise_mask = apply_fov_gate(noise_mask, gate, protect, valid)
        # With harmonic_regen the beamformer applies no post-filter; the HRNR
        # stage takes its output and the stage-1 gain g1 instead.
        post = None if harmonic_regen else tgt_mask
        if beamformer == "mvdr":
            d = steering_vector(freqs, steer, cfg.mic_dist, cfg.c, cfg.n_mics, positions=geom)
            S = masked_mvdr_fused(
                Y, noise_mask, d, freqs, target_mask=post, sigma=cfg.sigma,
                hp_cutoff_hz=cfg.hp_cutoff_hz, mask_floor=mask_floor,
            )
        else:
            d = steering_vector(freqs, steer, cfg.mic_dist, cfg.c, cfg.n_mics,
                                normalize_phase=True, positions=geom)
            # The beamformer weights its interference covariance by 1 - its
            # mask argument, so the (gated) noise mask enters as 1 - noise
            # in float32, as in the reference; the post-filter is the raw mask.
            S = hard_null_fused(Y, 1.0 - noise_mask, d, freqs, post_mask=post)
        if harmonic_regen:
            # The stage-1 gain: the floored mask (MVDR), the raw mask (hard-null).
            g1 = tgt_mask
            if beamformer == "mvdr" and mask_floor > 0:
                g1 = torch.clamp(tgt_mask, min=mask_floor)
            S = harmonic_regeneration(S, g1, cfg.n_fft, cfg.hop, length=n)
        return istft(S, cfg.n_fft, cfg.hop, length=length)


def learned_enhance_streaming(
    mixture: torch.Tensor,
    model,
    cfg: PipelineConfig,
    beamformer: str = "mvdr",
    feature_kind: str = "logmag_ipd",
    train_mic_dist: float | None = None,
    n_nulls: int = 1,
    harmonic_regen: bool = False,
) -> torch.Tensor:
    """Chunked 2 s / 50 % overlap-add enhancement of audio of any length,
    (..., M, n) -> (..., n): every chunk of the recording goes through one
    batched :func:`learned_enhance` call."""

    def process(chunks):
        return learned_enhance(
            chunks, model, cfg, beamformer, feature_kind, train_mic_dist=train_mic_dist,
            n_nulls=n_nulls, harmonic_regen=harmonic_regen,
        )

    return streaming_enhance(mixture, process, cfg.win_size, cfg.win_size // 2)
