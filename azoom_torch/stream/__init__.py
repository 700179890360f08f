"""azoom_torch.stream: the 2 s chunker, the online MVDR, the low-latency
stream, the live server and the C++ stream engine, with the names of
azoom.stream."""

from azoom_torch.stream.chunker import chunk_signal, overlap_add_chunks, streaming_enhance
from azoom_torch.stream.online import online_enhance, online_masked_mvdr

__all__ = [
    "chunk_signal",
    "overlap_add_chunks",
    "streaming_enhance",
    "online_enhance",
    "online_masked_mvdr",
]
