"""azoom_torch: the PyTorch/CUDA port of azoom, the audio zoom of a
two-microphone (or larger) array.

The JAX package ``azoom`` is the reference; this package imports neither it
nor JAX. Module names follow ``azoom``'s so each counterpart is easy to
find. Every TPU kernel of the ported path has a hand-written CUDA kernel in
``azoom_torch/csrc`` (built with nvcc for sm_90a at first use) beside a
plain PyTorch version: a CUDA tensor launches the kernel, a CPU tensor takes
the plain version.

Ported so far: config (with the GEN1 preset and RoomConfig), dsp (windows,
stft, delays with fractional_delay),
beam (covariance, linalg2x2, linalgmm, mvdr with per-stream steering and
loading at any M, nullsteer with per-chunk steering at M = 2 and the
M-mic LCMV above, zoom, the HRNR postfilter, gev, rmvb, rtf, wpd), wpe
(dereverb), masks (physics features, bin_doa and duet_masks, geometric
incl. the FOV gate and the IPD-deviation mask, oracle, postfilter), localize (srp: SRP, GCC-PHAT, the IPD angle histogram; tracking:
the Viterbi, causal, momentum, two-source and EMA trackers), models (quantize, unet with TPUFPU's tfold and fattn, crn, blstm,
qcnn, convert, pretrained), eval (projection, stoi, bss, pesq_native and pesq_bridge,
reports), io (wav), dsp.resample and dsp.params, utils (host, profiling,
flops), stream (chunker, native: the C++ stream engine under
``AudioZoom.push``, ``AudioZoomServer``: S live streams with mask reuse, an
int16 wire and per-stream steer, zoom and tracking), kernels (masked MVDR, int8 3x3 conv, upsampling, hard-null,
int8 matmul, the online MVDR at 2 and at 3 to 8 mics), pipelines
(``learned_enhance`` with the MVDR, hard-null, RMVB, RTF or WPD
beamformer, the FOV gate and the HRNR post-filter,
``learned_enhance_streaming``, ``autosteer_enhance``,
``tracked_autosteer_enhance``, ``oracle_enhance``, ``heuristic_enhance``)
and the ``AudioZoom`` facade at high and low latency, for any number of
mics (the 2-mic kernels serve M = 2, as the reference's Pallas kernels do),
sim (synthetic signals, far-field, moving-source and shoebox-room scenes,
the C++ RIR and corpus engines, local corpora; a ``torch.Generator`` where
the reference takes a JAX key), parallel (device meshes, the oracle and
learned batch sweeps sharded over them, the multi-process layer; the
server's ``mesh=`` and ``stream.chunker.streaming_enhance_sharded``),
training (``train``: on-the-fly batches and the train loop with
checkpoints; ``models.trainable``, ``models.blstm`` and ``models.qcnn``:
the nets in trainable form; ``models.quantize``: calibration and the int8
export) and cli (``python -m azoom_torch.cli.batch``, the vectorized batch
sweep; ``python -m azoom_torch.cli.train``). Each subpackage re-exports the
names of its ``azoom`` counterpart.
"""

from azoom_torch.config import DEFAULT, GEN1, PipelineConfig, RoomConfig
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

__version__ = "0.1.0"

__all__ = [
    "DEFAULT", "GEN1", "PipelineConfig", "RoomConfig", "load_bundled", "learned_enhance",
    "learned_enhance_streaming", "predict_mask", "oracle_enhance", "heuristic_enhance",
    "autosteer_enhance", "AudioZoomServer", "AudioZoom", "__version__",
]
