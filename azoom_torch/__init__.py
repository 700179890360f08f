"""azoom_torch: the PyTorch/CUDA port of azoom, the two-microphone audio zoom.

The JAX package ``azoom`` is the reference; this package imports neither it
nor JAX. Module names follow ``azoom``'s so each counterpart is easy to
find. Every TPU kernel of the ported path has a hand-written CUDA kernel in
``azoom_torch/csrc`` (built with nvcc for sm_90a at first use) beside a
plain PyTorch version: a CUDA tensor launches the kernel, a CPU tensor takes
the plain version.

Ported so far: config, dsp (windows, stft, delays), beam (covariance,
linalg2x2, mvdr with per-stream steering and loading, nullsteer at M = 2
with per-chunk steering, zoom, the HRNR postfilter), masks (physics
features, bin_doa, geometric incl. the FOV gate and the IPD-deviation mask,
oracle), localize (srp: SRP, GCC-PHAT, the IPD angle histogram; tracking:
the Viterbi, causal, momentum, two-source and EMA trackers), models (quantize reader, unet TPUFPU, convert, pretrained
``tpufpu_nano``), eval.projection, stream (chunker, ``AudioZoomServer``:
S live streams with mask reuse, an int16 wire and per-stream steer, zoom
and tracking), kernels (masked MVDR, int8 3x3 conv, upsampling, hard-null,
int8 matmul), pipelines (``learned_enhance`` with the MVDR or hard-null
beamformer, the FOV gate and the HRNR post-filter,
``learned_enhance_streaming``, ``autosteer_enhance``,
``tracked_autosteer_enhance``, ``oracle_enhance``, ``heuristic_enhance``)
and the ``AudioZoom`` facade at high latency.
"""

from azoom_torch.config import DEFAULT, PipelineConfig
from azoom_torch.models.pretrained import load_bundled
from azoom_torch.pipelines.learned import (
    learned_enhance,
    learned_enhance_streaming,
    predict_mask,
)
from azoom_torch.pipelines.autosteer import autosteer_enhance
from azoom_torch.pipelines.oracle import heuristic_enhance, oracle_enhance
from azoom_torch.stream.server import AudioZoomServer
from azoom_torch.zoom_api import AudioZoom

__all__ = [
    "DEFAULT", "PipelineConfig", "load_bundled", "learned_enhance",
    "learned_enhance_streaming", "predict_mask", "oracle_enhance", "heuristic_enhance",
    "autosteer_enhance", "AudioZoomServer", "AudioZoom",
]
