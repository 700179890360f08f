"""azoom_torch.io: WAV reading, writing and checking."""

from azoom_torch.io.wav import diagnose, read_wav, write_wav

__all__ = ["diagnose", "read_wav", "write_wav"]
