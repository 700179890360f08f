"""Learned-mask enhancement, the serving path (counterpart of
azoom.pipelines.learned for ``beamformer="mvdr"``, physics features):

    STFT -> steer-align -> physics features -> TPUFPU int8 mask net
         -> masked MVDR + floored mask post-filter + high-pass -> iSTFT

Everything runs on the device of the mixture. On CUDA the mask net's 3x3
convs run on the int8 conv kernel and the MVDR stage on the fused MVDR
kernel, one launch for the whole batch; on the CPU both take their plain
PyTorch versions.
"""

from __future__ import annotations

import torch

from azoom_torch.config import PipelineConfig
from azoom_torch.dsp.delays import steering_vector
from azoom_torch.dsp.stft import istft, rfft_freqs, stft
from azoom_torch.kernels.mvdr_kernel import masked_mvdr_fused
from azoom_torch.masks.features import physics_aware_features
from azoom_torch.models.unet import pad_frames

__all__ = ["predict_mask", "learned_enhance"]


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.buffers()).device


def predict_mask(
    model,
    Y: torch.Tensor,
    feature_kind: str = "physics",
    pad_multiple: int = 16,
    ipd_scale=1.0,
    pair_mode: str = "mean",
) -> torch.Tensor:
    """STFT (..., M, F, T) -> target mask (..., F, T) via the mask net:
    features, time padding to the U-Net's pool factor, cropping back."""
    if feature_kind != "physics":
        raise NotImplementedError(
            f"feature_kind {feature_kind!r} is not ported; logmag_ipd features "
            "come with the nets that use them (ROADMAP.md Queue A item 9)"
        )
    feats = physics_aware_features(Y, ipd_scale, pair_mode=pair_mode)
    unbatched = feats.ndim == 3
    if unbatched:
        feats = feats[None]
    lead = feats.shape[:-3]
    feats = feats.reshape((-1,) + tuple(feats.shape[-3:]))
    feats, t_orig = pad_frames(feats, pad_multiple)
    with torch.inference_mode():
        mask = model(feats.contiguous())[..., :t_orig]
    mask = mask.reshape(lead + tuple(mask.shape[-2:]))
    return mask[0] if unbatched else mask


def learned_enhance(
    mixture: torch.Tensor,
    model,
    cfg: PipelineConfig,
    beamformer: str = "mvdr",
    feature_kind: str = "physics",
    mask_floor: float = 0.05,
    length: int | None = None,
    fov_deg=None,
    steer_deg=None,
    train_mic_dist: float | None = None,
    steer_align: bool = True,
    harmonic_regen: bool = False,
) -> torch.Tensor:
    """Whole-signal learned enhancement: (..., M, n) -> (..., n), float32.

    ``steer_deg`` overrides ``cfg.angle_target_deg``. ``steer_align``
    rotates the STFT by the conjugate steering vector before the features,
    so the look direction appears broadside to the net (an exact no-op,
    and skipped, at a static 90 deg on a linear array).
    ``train_mic_dist`` enables geometry adaptation (phase features scaled
    by train_mic_dist / the first pair's spacing). The mixture and the
    model must be on the same device.
    """
    if beamformer != "mvdr":
        raise NotImplementedError(
            f"beamformer {beamformer!r} is not ported; the others are queued "
            "(ROADMAP.md Queue A item 9)"
        )
    if fov_deg is not None:
        raise NotImplementedError("fov_deg (the FOV covariance gate) is not ported yet")
    if harmonic_regen:
        raise NotImplementedError("harmonic_regen is not ported yet")
    mixture = torch.as_tensor(mixture)
    if mixture.device != _model_device(model):
        raise ValueError(
            f"mixture is on {mixture.device} but the model is on {_model_device(model)}"
        )
    cfg = cfg.for_input(mixture)
    if cfg.n_mics != 2:
        raise NotImplementedError(
            "M > 2 MVDR needs azoom/beam/linalgmm.py, which is queued for a later slice"
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
            d_al = steering_vector(freqs, steer, cfg.mic_dist, cfg.c, cfg.n_mics, positions=geom)
            # In complex128, rounded once: device-independent bits.
            rot = torch.conj(d_al).transpose(-1, -2)[..., None].to(torch.complex128)
            Y_feat = (Y.to(torch.complex128) * rot).to(torch.complex64)
        tgt_mask = predict_mask(model, Y_feat, feature_kind, ipd_scale=ipd_scale,
                                pair_mode=pair_mode)
        noise_mask = 1.0 - tgt_mask
        d = steering_vector(freqs, steer, cfg.mic_dist, cfg.c, cfg.n_mics, positions=geom)
        S = masked_mvdr_fused(
            Y, noise_mask, d, freqs, target_mask=tgt_mask, sigma=cfg.sigma,
            hp_cutoff_hz=cfg.hp_cutoff_hz, mask_floor=mask_floor,
        )
        return istft(S, cfg.n_fft, cfg.hop, length=length)
