"""azoom_torch.dsp: STFT, windows, array delays and steering, resampling and
the STFT parameter search (the names of azoom.dsp). ``stft`` here is the
function; its module stays importable as ``azoom_torch.dsp.stft``."""

from azoom_torch.dsp.delays import (
    far_field_delays,
    fractional_delay,
    mic_positions,
    steering_matrix,
    steering_vector,
)
from azoom_torch.dsp.params import choose_best_stft_params, stft_reconstruct_mse
from azoom_torch.dsp.resample import resample_fft, resample_poly
from azoom_torch.dsp.windows import hann
from azoom_torch.dsp.stft import istft, rfft_freqs, stft, stft_frame_count  # last: shadows the module

__all__ = [
    "far_field_delays",
    "fractional_delay",
    "mic_positions",
    "steering_matrix",
    "steering_vector",
    "istft",
    "rfft_freqs",
    "stft",
    "stft_frame_count",
    "hann",
    "choose_best_stft_params",
    "stft_reconstruct_mse",
    "resample_fft",
    "resample_poly",
]
