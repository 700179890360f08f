"""The online MVDR's plain version above 8 mics against the JAX package
(CPU): ``kernels.online_mvdr_kernel.online_mvdr_plain`` at M = 12 against
azoom.stream.online.online_masked_mvdr on a numpy-seeded (12, 17, 48) STFT
from a fresh state, with a random steering vector and no target mask. The
card's M-general kernel is held against this plain version (phase 18 of
``chip_smoke.py``, ``tests/test_torch_cuda.py``), so this closes the chain
from the kernel to the reference at a mic count the kernel once refused.

Bounds, over the output's peak: frames 24-47 within 1e-4, as
tests/test_torch_lowlat.py holds the 2-mic case (float32 roundings through
the recursion and a 12 x 12 Cholesky a frame; measured ~1e-6). The first 2M
frames are the fresh state's rank-deficient stretch (R = the t frames' y y^H
plus a 1e-6 prime, rank t < 12 until frame 12), where float32 itself is off:
the reference in float32 lies up to 6.5e-4 from the same reference in
float64 and the port up to 1.5e-3 (measured on three seeds at T = 24,
the largest near frame 10); all 48 frames are held within 5e-3. The port
runs in one torch thread.
"""

import jax.numpy as jnp
import numpy as np
import torch

from azoom.stream.online import online_masked_mvdr as jax_online_mvdr
from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr_plain


def test_online_mvdr_plain_matches_jax_at_twelve_mics():
    M, F, T = 12, 17, 48
    rng = np.random.default_rng(12)
    Y = (rng.standard_normal((M, F, T)) + 1j * rng.standard_normal((M, F, T))).astype(np.complex64)
    m = rng.random((F, T), dtype=np.float32)
    d = (rng.standard_normal((F, M)) + 1j * rng.standard_normal((F, M))).astype(np.complex64)
    freqs = (np.arange(F) * 500.0).astype(np.float32)
    ref = np.asarray(jax_online_mvdr(jnp.asarray(Y), jnp.asarray(m), jnp.asarray(d),
                                     jnp.asarray(freqs)))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = online_mvdr_plain(torch.from_numpy(Y), torch.from_numpy(m), torch.from_numpy(d),
                                torch.from_numpy(freqs), *initial_state((), F, M)).numpy()
    finally:
        torch.set_num_threads(n)
    diff = np.abs(got - ref) / np.abs(ref).max()
    warm, err = float(diff[:, 2 * M:].max()), float(diff.max())
    print(f"[parity] online_mvdr_plain M={M}: rel={warm:.3e} after {2 * M} frames, "
          f"{err:.3e} overall")  # shown with pytest -s
    assert got.shape == ref.shape == (F, T) and warm <= 1e-4 and err <= 5e-3
    assert np.all(got[0] == 0)  # bin 0 (0 Hz) is below the 100 Hz cutoff
