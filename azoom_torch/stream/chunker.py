"""Sliding-window streaming runtime, chunked overlap-add (counterpart of
azoom.stream.chunker: ``chunk_signal``, ``overlap_add_chunks``,
``streaming_enhance``).

A 2 s window slides with a 50 % hop over audio of any length; each chunk
is processed on its own (its covariance is chunk-local) and the results are
overlap-added with a normalising window sum. As the reference vmaps its
chunk processor, the port hands all chunks to it at once as a leading
batch axis, so one call enhances the whole recording.
``streaming_enhance_sharded`` (chunks over a device mesh) is not ported.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["chunk_signal", "overlap_add_chunks", "streaming_enhance"]


def chunk_signal(x: torch.Tensor, win_size: int, hop: int) -> tuple[torch.Tensor, int]:
    """Frame x (..., n) into overlapping chunks (n_chunks, ..., win_size),
    the tail zero-padded to a whole number of hops. Returns (chunks, n)."""
    n = x.shape[-1]
    n_chunks = max(1, -(-(max(n - win_size, 0)) // hop) + 1)
    padded = (n_chunks - 1) * hop + win_size
    xp = torch.nn.functional.pad(x, (0, padded - n))
    chunks = xp.unfold(-1, win_size, hop)  # (..., n_chunks, win_size), a view
    return torch.movedim(chunks, -2, 0).contiguous(), n


def overlap_add_chunks(
    chunks: torch.Tensor, hop: int, length: int, window: torch.Tensor | None = None
) -> torch.Tensor:
    """Overlap-add chunks (n_chunks, ..., win_size) -> (..., length),
    normalised by the accumulated window sum (a rectangular window of ones
    unless ``window`` is given). Chunks are added in order, as the
    reference's scan adds them, so the float32 sums round alike."""
    n_chunks, *lead, win_size = chunks.shape
    if window is None:
        window = torch.ones((win_size,), dtype=chunks.dtype, device=chunks.device)
    out_len = (n_chunks - 1) * hop + win_size
    out = chunks.new_zeros((*lead, out_len))
    norm = chunks.new_zeros((out_len,))
    for k in range(n_chunks):
        s = k * hop
        out[..., s:s + win_size] += chunks[k] * window
        norm[s:s + win_size] += window
    out = out / torch.clamp(norm, min=1e-10)
    return out[..., :length]


def streaming_enhance(
    mixture: torch.Tensor,
    process_fn: Callable[[torch.Tensor], torch.Tensor],
    win_size: int = 32_000,
    hop: int = 16_000,
) -> torch.Tensor:
    """Enhance multichannel audio (..., M, n) chunk by chunk -> (..., n).

    ``process_fn`` maps a batch of chunks (n_chunks, ..., M, win_size) to
    (n_chunks, ..., win_size), e.g. a batched learned_enhance."""
    chunks, n = chunk_signal(mixture, win_size, hop)
    return overlap_add_chunks(process_fn(chunks), hop, n)
