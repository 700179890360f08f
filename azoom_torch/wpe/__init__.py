from azoom_torch.wpe.dereverb import wpe, wpe_dereverb

__all__ = ["wpe", "wpe_dereverb"]
