"""azoom_torch: the PyTorch/CUDA port of azoom, the two-microphone audio zoom.

The JAX package ``azoom`` is the reference; this package imports neither it
nor JAX. Module names follow ``azoom``'s so each counterpart is easy to
find. Every TPU kernel of the ported path has a hand-written CUDA kernel in
``azoom_torch/csrc`` (built with nvcc for sm_90a at first use) beside a
plain PyTorch version: a CUDA tensor launches the kernel, a CPU tensor takes
the plain version.

Ported so far (the learned serving path): config, dsp (windows, stft,
delays), beam (covariance, linalg2x2 solve, mvdr), masks.features
(physics features), models (quantize reader, unet TPUFPU, convert,
pretrained ``tpufpu_nano``), kernels (masked MVDR, int8 3x3 conv) and
pipelines.learned (``learned_enhance`` with the MVDR beamformer).
"""

from azoom_torch.config import DEFAULT, PipelineConfig
from azoom_torch.models.pretrained import load_bundled
from azoom_torch.pipelines.learned import learned_enhance, predict_mask

__all__ = ["DEFAULT", "PipelineConfig", "load_bundled", "learned_enhance", "predict_mask"]
