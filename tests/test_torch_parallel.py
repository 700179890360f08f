"""The port's meshes, sharded sweeps, sharded streaming, the sharded server
and the multi-process layer (azoom_torch.parallel, stream.chunker,
stream.server) on the CPU.

Several devices are stood in for by one device named several times
(``make_mesh(devices=["cpu"] * k)``), the port's counterpart of the JAX
tests' eight virtual CPU devices, and several hosts by two ``gloo``
processes. Sharded results are held bit for bit to unsharded ones, which is
what they measure on the CPU (every scene, chunk and stream is computed
alone, and the CPU's FFTs and int8 convs give each batch entry the same
bits at any batch size); the trivial sharded streaming is held against the
JAX package's sharded streaming within 1e-6.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.parallel.mesh import make_mesh as jax_make_mesh
from azoom.stream.chunker import streaming_enhance_sharded as jax_streaming_sharded
from azoom_torch import AudioZoomServer, PipelineConfig, learned_enhance, load_bundled
from azoom_torch.parallel import (
    data_sharding, make_mesh, oracle_sweep, replicated, sharded_sweep,
)
from azoom_torch.parallel.mesh import Mesh, run_on_devices
from azoom_torch.parallel.multihost import global_data_mesh, host_shard, initialize, is_primary
from azoom_torch.parallel.sweep import learned_sweep
from azoom_torch.sim import make_scene, speech_like_batch
from azoom_torch.stream.chunker import streaming_enhance, streaming_enhance_sharded

REPO = Path(__file__).resolve().parent.parent
CFG = PipelineConfig(mic_dist=0.04)
SWEEP_KW = dict(n_samples=8_192, with_stoi=True, randomize=True, n_interferers=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpus(k: int) -> Mesh:
    return make_mesh(devices=["cpu"] * k)


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].shape == b[k].shape and torch.equal(a[k], b[k]), (
            k, float((a[k] - b[k]).abs().max()))


def test_mesh_and_shardings():
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"], axis_name="chunk")
    assert mesh.size == 3 and mesh.axis_names == ("chunk",) and mesh.axis_name == "chunk"
    assert make_mesh(2, devices=["cpu"] * 4).size == 2
    x = torch.arange(12.0).reshape(6, 2)
    parts = data_sharding(mesh, x)
    assert [p.shape for p in parts] == [(2, 2)] * 3 and torch.equal(torch.cat(parts), x)
    with pytest.raises(ValueError, match="divide"):
        data_sharding(mesh, x[:5])
    net, _ = load_bundled("tpufpu_nano", device="cpu")
    reps = replicated(mesh, net)
    assert list(reps) == [torch.device("cpu")] and reps[torch.device("cpu")] is net
    assert torch.equal(replicated(mesh, x)[torch.device("cpu")], x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_run_on_devices_keeps_order_and_raises_a_shards_error():
    assert run_on_devices([("cpu", lambda i=i: i * i) for i in range(4)]) == [0, 1, 4, 9]

    def boom():
        raise ZeroDivisionError("shard 2")

    with pytest.raises(ZeroDivisionError, match="shard 2"):
        run_on_devices([("cpu", lambda: 0), ("cpu", lambda: 1), ("cpu", boom)])


def test_run_on_devices_runs_each_distinct_device_in_a_thread_of_its_own():
    """Two distinct devices (the CPU and ``meta``, which no job touches)
    take the threaded path: each device's jobs run in turn in one thread
    that is not the caller's, the results come back in job order, and one
    device's error is raised only once the other device's jobs have ended."""
    import threading
    import time

    ran = []

    def job(d, i):
        def fn():
            time.sleep(0.01)
            ran.append((d, threading.get_ident()))
            return i
        return fn

    devs = ["cpu", "meta", "cpu", "meta"]
    assert run_on_devices([(d, job(d, i)) for i, d in enumerate(devs)]) == [0, 1, 2, 3]
    threads = {d: {t for dd, t in ran if dd == d} for d in ("cpu", "meta")}
    assert [len(t) for t in threads.values()] == [1, 1]
    assert threads["cpu"] != threads["meta"]
    assert threading.get_ident() not in threads["cpu"] | threads["meta"]

    def boom():
        raise ZeroDivisionError("meta shard")

    ran.clear()
    with pytest.raises(ZeroDivisionError, match="meta shard"):
        run_on_devices([("cpu", job("cpu", 0)), ("meta", boom), ("cpu", job("cpu", 2))])
    assert [d for d, _ in ran] == ["cpu", "cpu"]


def test_a_cpu_shard_beside_another_device_rounds_as_the_caller():
    """A CPU device's thread on the threaded path takes the caller's
    intra-op thread count (and with it MKL's fixed choice of threads), so
    its FFTs, which split work by that count, give the caller's bits."""
    n = torch.get_num_threads()
    x = torch.randn(3, 65_536, generator=torch.Generator().manual_seed(0))
    try:
        torch.set_num_threads(3)
        want = torch.fft.rfft(x)
        got = run_on_devices([("cpu", lambda: (torch.get_num_threads(), torch.fft.rfft(x))),
                              ("meta", lambda: 0)])
    finally:
        torch.set_num_threads(n)
    assert got[0][0] == 3 and torch.equal(got[0][1], want) and got[1] == 0


def test_launch_counts_add_up_across_threads():
    """The shards of a mesh launch from one thread per device: 16 threads
    adding 2,000 launches each, with the switch interval shortened, lose
    none."""
    import threading

    from azoom_torch import kernels

    before = kernels.launches["masked_mvdr"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels.count(kernels.launches, "masked_mvdr")
                                                    for _ in range(2_000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launches["masked_mvdr"] - before == 32_000


@pytest.fixture(scope="module")
def unsharded():
    return oracle_sweep(3, CFG, n_scenes=4, device="cpu", **SWEEP_KW)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sharded_sweep_equals_the_unsharded_sweep(unsharded, k):
    got = sharded_sweep(oracle_sweep, 3, _cpus(k), 4, CFG, **SWEEP_KW)
    _equal(got, unsharded)
    assert all(v.device.type == "cpu" for v in got.values())


def test_sharded_learned_sweep_equals_the_unsharded_sweep():
    net, fk = load_bundled("tpufpu_nano", device="cpu")
    kw = dict(n_samples=8_192, reverb=False, beamformer="hard_null", feature_kind=fk)
    _equal(sharded_sweep(learned_sweep, 1, _cpus(2), 2, CFG, net, **kw),
           learned_sweep(1, CFG, net, n_scenes=2, **kw))


def test_sharded_sweep_refuses_uneven_shards_and_raises_a_shards_error():
    with pytest.raises(ValueError, match="n_scenes=3 must divide over 2 devices"):
        sharded_sweep(oracle_sweep, 0, _cpus(2), 3, CFG, n_samples=2_000)

    def sweep(seed, n_scenes, scene_offset, device):
        if scene_offset:
            raise FloatingPointError(f"scenes from {scene_offset}")
        return {"m": torch.zeros(n_scenes)}

    with pytest.raises(FloatingPointError, match="scenes from 2"):
        sharded_sweep(sweep, 0, _cpus(2), 4)


def test_streaming_enhance_sharded_trivial_matches_the_port_and_jax(devices8):
    """Six chunks over a mesh of 4 (two padding chunks) and of 8 (the JAX
    test's mesh); the JAX package's sharded streaming on its 8 devices."""
    x = np.random.default_rng(1).standard_normal((2, 100_000)).astype(np.float32)

    def process(c):
        return c[:, 0] * 0.5 + c[:, 1] * 0.5

    xt = torch.from_numpy(x)
    ref = streaming_enhance(xt, process, 32_000, 16_000)
    jax_ref = np.asarray(jax_streaming_sharded(
        jnp.asarray(x), lambda c: c[0] * 0.5 + c[1] * 0.5,
        jax_make_mesh(devices=devices8, axis_name="chunk"), 32_000, 16_000))
    for k in (4, 8):
        got = streaming_enhance_sharded(xt, process, _cpus(k), 32_000, 16_000)
        assert got.shape == (100_000,) and torch.equal(got, ref)
        np.testing.assert_allclose(got.numpy(), jax_ref, atol=1e-6)


def test_streaming_enhance_sharded_learned_equals_unsharded():
    """Three 2 s chunks on two shards (one padding chunk); the process
    function takes the net's replica on its chunks' device."""
    net, fk = load_bundled("tpufpu_nano", device="cpu")
    src = speech_like_batch(torch.Generator().manual_seed(2), 3, 64_000, device="cpu")
    mix = make_scene(src[0], src[1:], 70.0, [20.0, 140.0], 0.04, 16_000)["mixture"]
    mesh = _cpus(2)
    reps = replicated(mesh, net)

    def process(chunks):
        return learned_enhance(chunks, reps[chunks.device], CFG, feature_kind=fk, steer_deg=70.0)

    got = streaming_enhance_sharded(mix, process, mesh)
    ref = streaming_enhance(mix, process)
    assert got.shape == (64_000,) and torch.equal(got, ref)


def _server_scenes(win, hop, n_ticks):
    n = win + n_ticks * hop
    src = speech_like_batch(torch.Generator().manual_seed(0), 12, n, device="cpu").reshape(4, 3, n)
    return np.stack([make_scene(src[i, 0], src[i, 1:], s, [s - 35.0, s + 40.0], 0.04,
                                16_000)["mixture"].numpy()
                     for i, s in enumerate((50.0, 80.0, 100.0, 130.0))])


def test_server_on_two_shards_equals_the_unsharded_server():
    """Four streams on ["cpu", "cpu"]: per-stream steer and zoom, tracking,
    mask reuse, the int16 wire, and slots 1 and 2 (one each side of the
    shard boundary) detached and attached again before the second tick.
    Output, bearings and bytes on the wire equal the unsharded server's."""
    cfg = PipelineConfig(mic_dist=0.04, win_size=16_384)  # frame-aligned: hop 8,192
    win, hop, n_ticks = cfg.win_size, cfg.win_size // 2, 3
    mixes = _server_scenes(win, hop, n_ticks)

    def serve(mesh):
        srv = AudioZoomServer(4, cfg=cfg, mask_reuse=True, wire="int16", track=True,
                              device="cpu", mesh=mesh)
        for s, steer in enumerate((50.0, 80.0, 100.0, 130.0)):
            srv.set_zoom(s, direction_deg=steer, zoom=0.25 * s)
        outs, bearings = [srv.push(mixes[:, :, :win])], [srv.bearings]
        for k in range(n_ticks):
            if k == 1:
                srv.detach(1)
                srv.detach(2)
                srv.attach(1, direction_deg=70.0, zoom=0.5)
                srv.attach(2, direction_deg=110.0)
            outs.append(srv.push(mixes[:, :, win + k * hop:win + (k + 1) * hop]))
            bearings.append(srv.bearings)
        return np.concatenate(outs, axis=1), bearings, dict(srv.bytes_moved)

    (a, ba, ma), (b, bb, mb) = serve(None), serve(_cpus(2))
    assert a.dtype == np.int16 and a.shape == (4, n_ticks * hop)
    diff = int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
    print(f"[parallel] server two shards vs one: max |diff| {diff} int16 codes")
    np.testing.assert_array_equal(b, a)
    for x, y in zip(bb, ba):
        np.testing.assert_array_equal(x, y)
    assert mb == ma


def test_multihost_helpers_without_a_group():
    initialize()  # no-op: one process
    assert is_primary()
    assert host_shard(5) == range(0, 5)
    if torch.cuda.is_available():
        assert global_data_mesh().size == torch.cuda.device_count()


_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, "@REPO@")
import torch.distributed as dist
from azoom_torch.config import PipelineConfig
from azoom_torch.parallel import oracle_sweep, sharded_sweep
from azoom_torch.parallel.multihost import global_data_mesh, host_shard, initialize, is_primary

initialize("@COORD@", num_processes=2, process_id=@PID@, device="cpu")
try:
    mesh = global_data_mesh()
    shard = host_shard(10)
    cfg = PipelineConfig(mic_dist=0.04)
    kw = dict(n_samples=8_192, with_stoi=True, randomize=True)
    res = sharded_sweep(oracle_sweep, 5, mesh, 4, cfg, **kw)
    ref = oracle_sweep(5, cfg, n_scenes=4, device="cpu", **kw)
    print(json.dumps(dict(
        rank=dist.get_rank(), backend=dist.get_backend(), mesh=mesh.size,
        owners=list(mesh.owners), primary=is_primary(), shard=[shard.start, shard.stop],
        equal=all(torch.equal(res[k], ref[k]) for k in ref), keys=sorted(res),
        shapes=[list(v.shape) for v in res.values()])), flush=True)
finally:
    dist.destroy_process_group()
"""


def test_two_gloo_processes_share_a_sweep():
    """Two processes on one global mesh of 2: each runs its 2 scenes, and
    both end with the single-process sweep's whole dict. Each process has a
    120 s limit; a hung rendezvous fails the test."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER.replace("@REPO@", str(REPO))
         .replace("@COORD@", f"127.0.0.1:{port}").replace("@PID@", str(pid))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    reports = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{err[-3000:]}"
        reports.append(json.loads(out.strip().splitlines()[-1]))
    for rank, r in enumerate(reports):
        assert r["rank"] == rank and r["backend"] == "gloo" and r["mesh"] == 2
        assert r["owners"] == [0, 1] and r["primary"] == (rank == 0)
        assert r["shard"] == ([0, 5] if rank == 0 else [5, 10])
        assert r["equal"] and r["shapes"] == [[4]] * 6, r
