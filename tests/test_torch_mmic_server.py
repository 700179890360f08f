"""AudioZoomServer at three and four mics, on the CPU against azoom's
server: the reference's 4-mic rectangle (tests/test_stream_server.py:70)
and a 3-mic linear array at 4 cm, the float fpu, two streams each with a
target at 90 deg and an interferer at 40 (tests/test_torch_mmic.py's
scenes and checks), a prime and two ticks.

Bound, the 2-mic server's (ROADMAP Queue C): waveform relative L2 <= 2e-2
and SIR within 0.05 dB per stream. Measured (``-s`` prints each): the
rectangle 2.6e-5 and 2.3e-5, the linear array 8.6e-7 and 1.1e-6; every SIR
within 0.003 dB. The reference server compiles its prime and tick programs
(~20 s each case on one core).
"""

import numpy as np
import pytest
import torch

from azoom.config import PipelineConfig as JaxConfig
from azoom.stream.server import AudioZoomServer as JaxServer
from azoom_torch import AudioZoomServer
from azoom_torch.config import PipelineConfig
from test_torch_mmic import LEARNED_BOUND, RECT, _check, configs, geometry_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LINEAR3 = ((0.04, 0.0), (0.0, 0.0), (-0.04, 0.0))  # the 3-mic linear array's mics at 4 cm


@pytest.mark.parametrize("array", ["rect4", "linear3"])
def test_server_matches_jax(array):
    """The reference's 4-mic rectangle server (tests/test_stream_server.py)
    and a 3-mic linear array: fpu float, two streams, a prime and two ticks."""
    if array == "rect4":
        jcfg = JaxConfig(mic_dist=0.04).with_geometry(RECT)
        cfg, positions = PipelineConfig(mic_dist=0.04).with_geometry(RECT), RECT
    else:
        (jcfg, cfg), positions = configs(3), LINEAR3
    n = cfg.win_size + 2 * (cfg.win_size // 2)
    scenes = [geometry_scene(positions, n, seed=20 + s) for s in range(2)]
    mixes = np.stack([s["mixture"] for s in scenes])
    ref_srv = JaxServer(2, cfg=jcfg, model="fpu", int8=False, use_pallas=False,
                        dsp_precision="exact")
    srv = AudioZoomServer(2, cfg=cfg, model="fpu", int8=False, dsp_precision="exact",
                          device="cpu")
    hop = cfg.win_size // 2
    blocks = [mixes[:, :, :cfg.win_size]] + [
        mixes[:, :, cfg.win_size + k * hop:cfg.win_size + (k + 1) * hop] for k in range(2)]
    ref = np.concatenate([ref_srv.push(b) for b in blocks], axis=1)
    got = np.concatenate([srv.push(b) for b in blocks], axis=1)
    assert got.shape == ref.shape == (2, 2 * hop)
    for s in range(2):
        _check(f"server {array} stream {s}", got[s], ref[s], scenes[s]["target_ref"][hop:],
               scenes[s]["interference_ref"][hop:], LEARNED_BOUND)
