"""azoom_torch.models: the mask nets (serving forms in ``unet``, ``crn``,
``blstm``, ``qcnn``; trainable twins in ``trainable``), the conversion of a
flax variables tree (``convert``), the bundled artifacts (``pretrained``)
and quantization and export (``quantize``), with the names of azoom.models."""

from azoom_torch.models.blstm import BLSTMMaskNet
from azoom_torch.models.qcnn import QCNNMaskNet, QuaternionConv
from azoom_torch.models.quantize import (
    dequantize_variables,
    quantize_variables,
    quantized_size_bytes,
)
from azoom_torch.models.unet import DeepFPU, FreqPreservingUNet, pad_frames, time_pool_factor

__all__ = [
    "BLSTMMaskNet",
    "QCNNMaskNet",
    "QuaternionConv",
    "DeepFPU",
    "FreqPreservingUNet",
    "pad_frames",
    "time_pool_factor",
    "dequantize_variables",
    "quantize_variables",
    "quantized_size_bytes",
]
