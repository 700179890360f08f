"""Parity of the port's chunked overlap-add runtime (azoom_torch.stream.chunker)
with azoom.stream.chunker (CPU): framing, overlap-add and the chunked
driver, at lengths that leave a tail shorter than a hop, fill whole hops,
and fall short of one window. Chunks are added in the reference's order, so
the overlap-add is held to exact float32 equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.stream.chunker import chunk_signal as jax_chunk
from azoom.stream.chunker import overlap_add_chunks as jax_ola
from azoom.stream.chunker import streaming_enhance as jax_stream
from azoom_torch.stream.chunker import chunk_signal, overlap_add_chunks, streaming_enhance

WIN, HOP = 400, 200
LENGTHS = {
    "shorter_than_window": 300,
    "one_window": WIN,
    "whole_hops": WIN + 3 * HOP,
    "tail_shorter_than_hop": WIN + 3 * HOP + 57,
}


def _signal(n, seed=0):
    return np.random.default_rng(seed).standard_normal((2, n)).astype(np.float32)


@pytest.mark.parametrize("case", list(LENGTHS))
def test_chunk_and_overlap_add_match_jax(case):
    x = _signal(LENGTHS[case])
    chunks, n = chunk_signal(torch.from_numpy(x), WIN, HOP)
    jchunks, jn = jax_chunk(jnp.asarray(x), WIN, HOP)
    assert n == jn == x.shape[-1]
    np.testing.assert_array_equal(chunks.numpy(), np.asarray(jchunks))
    assert chunks.shape[1:] == (2, WIN)
    proc = (np.random.default_rng(1).standard_normal(chunks.shape[:1] + (WIN,))
            .astype(np.float32))
    win = np.hanning(WIN).astype(np.float32) + np.float32(0.1)
    for w in (None, win):
        got = overlap_add_chunks(torch.from_numpy(proc), HOP, n,
                                 None if w is None else torch.from_numpy(w)).numpy()
        ref = np.asarray(jax_ola(jnp.asarray(proc), HOP, n, None if w is None else jnp.asarray(w)))
        assert got.shape == (n,)
        np.testing.assert_array_equal(got, ref)


def test_streaming_enhance_matches_jax():
    x = _signal(LENGTHS["tail_shorter_than_hop"], seed=2)
    got = streaming_enhance(torch.from_numpy(x), lambda c: 0.5 * c[..., 0, :] - c[..., 1, :],
                            WIN, HOP).numpy()
    ref = np.asarray(jax_stream(jnp.asarray(x), lambda c: 0.5 * c[0] - c[1], WIN, HOP))
    np.testing.assert_array_equal(got, ref)
