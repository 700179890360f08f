"""Check and time the port's kernels alone, shape by shape, on one NVIDIA GPU:

    python3 -m azoom_torch.kernels.bench [int8_mm] [qconv] [convt] [hard_null] [mvdr]
                                         [online_mvdr] [float_conv] [fp32_peak] [--quick]
                                         [--against DIR] [--nets NET,...]
    python3 -m azoom_torch.kernels.bench clocks

``int8_mm``: each of the nine microbenchmark shapes held exactly against the
plain version, then timed beside ``torch._int_mm`` (whose column-major ``w``
is made outside the timing). ``ms`` is the time per call of a loop of
calls from Python, as ``chip_smoke.py`` takes it; ``device_ms`` replays the
same calls from a CUDA graph, which leaves out the host's time per call.

``qconv [--nets NET,...]``: each conv shape of a bundled net (default
tpufpu_nano; any conv net of models.pretrained, e.g. ``--nets
fpu,deepfpu,tpufpu``: the shapes are read from the net itself, on its plane of
129 folded rows for the TPUFPU nets and 513 bins for the others; NET@N takes
the net at N input frames, e.g. ``tpufpu_nano@48``, the server's reuse tick;
CINxCOUTxT one shape on 129 rows, e.g. ``512x512x64``) at batch 128, plain,
with a residual and (where the net has it) with the two-tensor concat input:
the route the plan picks (``kernel``: wgmma, split or mma), held bit for bit
(``torch.equal``) against the plain version and the ``mma.sync`` kernel (the
same kernel where the plan picks it), then both timed in turns (old, new, new,
old), beside a device-to-device copy of as many bytes as the conv must move
(``copy_ms``: what the card's memory gives a kernel that does nothing else),
``torch._int_mm`` on the conv's im2col'd int8 codes (``int_mm_ms``: the bare
GEMM, made outside the timing) and the bound (``bound_ms``: bytes over 3.35
TB/s or operations over 1,979 TOP/s, the larger).

``clocks [--nets NET,...]`` (alone): builds the ``wgmma`` conv with
``-DAZT_QCONV_CLOCKS`` and prints, per shape of the nets that runs on it
(either route), the cycles per tile that block 0's first consumer thread
spends waiting for a halo, in the products and in the epilogue, and that its
first producer thread spends waiting for a halo buffer and loading and
quantising (per tile: the split route makes a halo unit per part and slice,
less the part two slices share): which role bounds the kernel, where no
profiler reads stalls.

``convt``: the three upsamplings of the bundled net at batch 128 held
against the plain version (the count of elements that are not bit-equal to
it: the plain version rounds twice on rare ties), then timed as CUDA-graph
replays beside ``torch.addmm`` on the same operands and the float32 bound.

``hard_null``: B3 at (128, 2, 513, 64) held against its float64 plain
version (row relative error, outside a 1e-9 band around the cond
threshold) and timed as CUDA-graph replays beside its byte bound and a build of the same
kernel with ``-DAZT_HARD_NULL_FIXED_WEIGHTS``, whose closed form (eigenvector,
solve, cond gate) is replaced by the delay-and-sum weights: the closed
form's share of the time.

``mvdr`` (needs ``--against``): B1's shared-steering launch (one d, one
loading) at the server's tick, (128, 2, 513, 65), against an earlier tree's
kernel: the elements that differ and both times in turns. chip_smoke.py
phase 2 holds the shared and per-stream forms against the plain version.

``online_mvdr``: the recursive online MVDR (the low-latency beamformer) on one
stream of 513 bins at T = 1 (one hop), 8 and 16 (either side of the kernel's
switch from one thread per row to its chain-and-solver tiles), 64 and 1875 (a
60 s clip) and on 128 streams at 1875, with the floored target-mask gain: held
against the plain loop (relative error of the output and the state; the plain
loop only at T <= 64 with ``--quick``), then timed as CUDA-graph replays
beside the byte bound (Y, both masks and S once, the state read and written)
and the floor of the frame-to-frame chain (T dependent FMAs of 4 cycles at the
card's maximum SM clock); ``us_per_frame`` is the time over T. The plain check
starts from a state warmed on 32 frames: from a fresh one the first frames are
ill-posed (R = y y^H plus a 1e-6 prime). With ``--against DIR`` it also builds
DIR's ``online_mvdr_kernel.cu`` (the same C interface), counts the elements of
S and of the state that differ from it, and times both in turns.

``float_conv``: the float nets' 3x3 convs two ways, as ``models.unet.FConv``
runs them (im2col and one float32 matrix product) and as cuDNN's
``conv2d`` under a scoped ``allow_tf32=False``: each net's mask on the card
against the CPU's on 4 chunks of far-field scenes, and ms per batch-128
mask: why FConv is a matrix product.

``fp32_peak``: the float32 FMA rate of ``csrc/bench_fp32_peak.cu``, FMA
chains on registers with no memory traffic: what ``convt``'s rate is held
against beside the published 67 TFLOP/s.

``--against DIR``: DIR holds kernel sources of an earlier tree: for
``convt`` and ``hard_null`` the ``convt_kernel.cu`` and
``nullsteer_kernel.cu`` with the C interfaces they had when ``convt1x2`` took
no plan (``azt_convt1x2(x, W, bias, out, P, K, N2, Cout, stream)``) and B3
one shared d (``azt_hard_null(Y, tmask, post, d, freqs, cond_thr,
bypass_hz, S, B, F, T, stream)``); for
``mvdr`` the ``mvdr_kernel.cu`` with one shared d and an optional per-bin
sigma (``azt_masked_mvdr(Y, nmask, tmask, d, sigma_f, sigma, freqs,
hp_cutoff, mask_floor, S, B, F, T, stream)``). Each mode then builds it too,
counts the elements where the two kernels differ on the shared-d launch,
and times both in turns (earlier, current, current, earlier).

``--quick`` checks only (batch 8, or 3 for ``convt``, no timing): the first
run of a new build.
Prints the card's name and power limit (``nvidia-smi``; also beside every
row of the JSON file), then ptxas's registers and spills per kernel, and stops before any
launch if a kernel that rebalances registers between its warpgroups
(``setmaxnreg``) was not given the registers its block starts from (65,536
over its threads). Writes ``chiprun_out/kernel_bench.json``
(``clocks``: ``kernel_clocks.json``).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from azoom_torch.kernels import build
from azoom_torch.kernels.int8_mm_kernel import MICROBENCH_SHAPES, int8_mm, int8_mm_plain

BATCH, F_ROWS = 128, 129
# The net's three upsamplings: (K = Cin, Cout, input frames).
NANO_CONVT = ((256, 128, 8), (128, 64, 16), (64, 64, 32))
HBM_BYTES_PER_S, FP32_FLOPS_PER_S, FP64_FLOPS_PER_S = 3.35e12, 67e12, 34e12
INT8_OPS_PER_S = 1979e12


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters=20) -> float:
    """Time per call with the host taken out: ``iters`` calls captured into
    one CUDA graph and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=5, warmup=2) / iters


def ptxas_summary(info: dict) -> dict:
    """{kernel name: (registers, spill bytes)} from the build logs."""
    out = {}
    pat = re.compile(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
                     r"Used (\d+) registers", re.DOTALL)
    for src, v in info.items():
        for sym, spill, regs in pat.findall(v["log"]):
            short = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "", sym)
            out[f"{src}:{short[:40]}"] = (int(regs), int(spill))
    return out


def bench_int8_mm(dev, quick: bool) -> dict:
    rng = np.random.default_rng(0)
    rows = {}
    shapes = [(256, 576, 64), (128, 64, 64), (384, 4608, 512)] if quick else list(MICROBENCH_SHAPES)
    for M, K, N in shapes:
        x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(dev)
        got = int8_mm(x, w)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - int8_mm_plain(x, w)).abs().max())
        row = dict(max_abs_err=err)
        if not quick:
            w_cm = w.t().contiguous().t()
            row.update(ms=time_ms(lambda: int8_mm(x, w)),
                       device_ms=device_ms(lambda: int8_mm(x, w)),
                       int_mm_ms=time_ms(lambda: torch._int_mm(x, w_cm)),
                       int_mm_device_ms=device_ms(lambda: torch._int_mm(x, w_cm)),
                       bound_ms=max((M * K + K * N + 4 * M * N) / 3.35e12,
                                    2.0 * M * K * N / 1979e12) * 1e3)
        rows[str((M, K, N))] = row
        print(f"[int8_mm] {(M, K, N)} " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()),
            flush=True)
        if err:
            raise AssertionError(f"int8_mm {(M, K, N)}: max abs error {err}, not exact")
    return rows


def net_conv_shapes(net: str) -> tuple[int, dict]:
    """(plane rows, {(Cin, Cout, frames): (launches, variants the net runs)})
    of a bundled net's 3x3 convs at 64 input frames (``name@N``: at N); a
    variant is (with residual, concat input). ``CINxCOUTxT`` is that one
    shape on a plane of 129 rows, as no net runs it."""
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.models.unet import TPUFPU, conv_shapes

    if re.fullmatch(r"\d+x\d+x\d+", net):
        return F_ROWS, {tuple(int(v) for v in net.split("x")): (1, {(False, False)})}
    name, _, frames = net.partition("@")
    model, _ = load_bundled(name, device="cpu")
    shapes: dict = {}
    for cin, cout, t, res, cat in conv_shapes(model, int(frames or 64)):
        n, variants = shapes.get((cin, cout, t), (0, set()))
        shapes[(cin, cout, t)] = (n + 1, variants | {(res, cat)})
    return (F_ROWS if isinstance(model, TPUFPU) else 513), shapes


def bench_qconv(dev, quick: bool, nets=("tpufpu_nano",)) -> dict:
    from azoom_torch.kernels import qconv_kernel as qk

    rng = np.random.default_rng(1)
    batch = 8 if quick else BATCH
    rows = {}
    for net in nets:
        f_rows, shapes = net_conv_shapes(net)
        for (cin, cout, t), (launches, variants) in shapes.items():
            rows.update(_bench_conv_shape(qk, rng, dev, quick, net, batch, f_rows, cin, cout, t,
                                          launches, variants))
    return rows


def _bench_conv_shape(qk, rng, dev, quick, net, batch, f_rows, cin, cout, t, launches,
                      variants) -> dict:
    x = torch.from_numpy(np.abs(rng.standard_normal((batch, f_rows, t, cin)))
                         .astype(np.float32)).to(dev)
    act_scale = float(np.float32(3.3 / 127))
    w_q = qk.pack_weights(torch.from_numpy(
        rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8))).to(dev)
    epi = torch.from_numpy(np.stack([
        np.full(cout, 2e-4), 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout),
        1 + 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout),
    ]).astype(np.float32)).to(dev)
    res = torch.from_numpy(rng.standard_normal((batch, f_rows, t, cout))
                           .astype(np.float32)).to(dev)
    route = qk.plan(cin, cout, t)["kernel"]
    rows = {}
    for variant in ("plain", "res") + (("cat",) if any(c for _, c in variants) else ()):
        kw = dict(residual=res if variant == "res" else None)
        xin = x
        if variant == "cat":
            xin, kw["x2"] = x[..., :cin // 2].contiguous(), x[..., cin // 2:].contiguous()
        new = qk.qconv3x3(xin, w_q, epi, act_scale, **kw)
        old = qk.qconv3x3(xin, w_q, epi, act_scale, **kw, _kernel="mma")
        ref = qk.qconv3x3_plain(xin, w_q, epi, act_scale, **kw)
        torch.cuda.synchronize()
        rel = float((new - ref).abs().max()) / float(ref.abs().max())
        row = dict(net=net, rows=f_rows, kernel=route, launches=launches,
                   bit_equal=bool(torch.equal(new, old)),
                   not_bit_equal_to_plain=int((new != ref).sum()), rel_err_vs_plain=rel)
        if not quick:
            # a device-to-device copy that moves as many bytes as this conv must
            n_bytes = 4 * x.numel() + 4 * res.numel() * (2 if variant == "res" else 1)
            src = torch.empty(n_bytes // 8, dtype=torch.float32, device=dev)
            dst = torch.empty_like(src)
            row["copy_ms"] = time_ms(lambda: dst.copy_(src))
            del src, dst
            f_new = lambda: qk.qconv3x3(xin, w_q, epi, act_scale, **kw)  # noqa: E731
            f_old = lambda: qk.qconv3x3(xin, w_q, epi, act_scale, **kw, _kernel="mma")  # noqa: E731
            t_old, t_new = time_ms(f_old), time_ms(f_new)
            row.update(ms=min(t_new, time_ms(f_new)), mma_ms=min(t_old, time_ms(f_old)))
            if variant == "plain":
                row["int_mm_ms"] = int_mm_ms(x, w_q, act_scale)
            m = batch * f_rows * t
            row["bound_ms"] = max(
                (4 * m * cin + cout * 9 * cin + 4 * epi.numel()
                 + 4 * m * cout * (2 if variant == "res" else 1)) / HBM_BYTES_PER_S,
                2.0 * m * 9 * cin * cout / INT8_OPS_PER_S) * 1e3
        key = (net, cin, cout, t, variant)
        rows[str(key)] = row
        print(f"[qconv] {key} " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()),
            flush=True)
        if not row["bit_equal"]:
            diff = (new - old).abs()
            raise AssertionError(
                f"qconv {key}: differs from the mma.sync kernel at "
                f"{int((diff > 0).sum())} of {diff.numel()} outputs, max {float(diff.max()):.3e}")
        if row["not_bit_equal_to_plain"]:
            raise AssertionError(f"qconv {key}: {row['not_bit_equal_to_plain']} outputs differ "
                                 "from the plain version")
    return rows


def int_mm_ms(x, w_q, act_scale) -> float:
    """``torch._int_mm`` on a conv's im2col'd int8 codes (a stem's channels
    zero-extended, as the kernel takes them) and packed weights, both made
    outside the timing: the bare GEMM, not the same function."""
    from azoom_torch.kernels import qconv_kernel as qk

    batch, rows, t, cin = x.shape
    ck = qk.kernel_cin(cin)
    xq = torch.clamp(torch.round(x / act_scale), -127, 127).to(torch.int8)
    xq = torch.nn.functional.pad(xq, (0, ck - cin, 1, 1, 1, 1))
    cols = torch.stack([xq[:, dy:dy + rows, dx:dx + t] for dy in range(3) for dx in range(3)],
                       dim=3).reshape(batch * rows * t, 9 * ck)
    cols = torch.nn.functional.pad(cols, (0, qk.k_padded(cin) - 9 * ck)).contiguous()
    del xq
    w_t = w_q.t()
    return time_ms(lambda: torch._int_mm(cols, w_t))


def bench_clocks(dev, nets=("tpufpu_nano",)) -> dict:
    import ctypes

    from azoom_torch.kernels import qconv_kernel as qk

    qk.BUILD_DEFINES = ("AZT_QCONV_CLOCKS",)  # before the first launch loads the library
    read = build.load_library("qconv_kernel", qk.BUILD_DEFINES).azt_qconv3x3_clocks
    read.argtypes, read.restype = [ctypes.POINTER(ctypes.c_longlong)], ctypes.c_int
    names = ("wait_halo", "products", "epilogue", "wait_buffer", "load_quantise")
    rng = np.random.default_rng(2)
    rows = {}
    todo = [(f_rows, shape) for net in nets
            for f_rows, shapes in [net_conv_shapes(net)] for shape in shapes]
    for f_rows, (cin, cout, t) in dict.fromkeys(todo):
        how = qk.plan(cin, cout, t)
        if how["kernel"] == "mma":
            continue
        x = torch.from_numpy(np.abs(rng.standard_normal((BATCH, f_rows, t, cin)))
                             .astype(np.float32)).to(dev)
        w_q = qk.pack_weights(torch.from_numpy(
            rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8))).to(dev)
        epi = torch.ones((5, cout), dtype=torch.float32, device=dev)
        res = torch.from_numpy(rng.standard_normal((BATCH, f_rows, t, cout))
                               .astype(np.float32)).to(dev)
        for variant in ("plain", "res"):
            for _ in range(3):
                qk.qconv3x3(x, w_q, epi, 0.026, residual=res if variant == "res" else None)
            sums = (ctypes.c_longlong * 6)()
            build.check(read(sums), "qconv3x3 clocks")
            row = {n: round(sums[i] / sums[5]) for i, n in enumerate(names)}
            parts = how.get("n_parts", 1)  # a slice shares its first part with the one before
            row.update(tiles_of_block_0=int(sums[5]), m_tile=how["m_tile"], route=how["kernel"],
                       halo_units_per_tile=1 if parts == 1 else how["n_slices"] * (parts - 1) + 1,
                       weights="resident" if how["resident"] else f"ring of {how['stages']}")
            rows[str((cin, cout, t, variant))] = row
            print(f"[clocks] {(cin, cout, t, variant)} per tile: " + " ".join(
                f"{k}={v}" for k, v in row.items()), flush=True)
        del x, res
    return rows


def earlier_library(src_dir: Path, name: str) -> ctypes.CDLL:
    """``src_dir/<name>.cu`` built with the port's flags into
    ``_build/earlier/``: a kernel of an earlier tree, for comparison."""
    out = build.BUILD_DIR / "earlier" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(Path(src_dir) / f"{name}.cu")],
                   check=True, capture_output=True, timeout=600)
    return ctypes.CDLL(str(out))


def _in_turns(f_old, f_new) -> tuple[float, float]:
    """Device times of two calls taken in turns (old, new, new, old); the
    lower of each pair."""
    t_old, t_new = device_ms(f_old), device_ms(f_new)
    t_new = min(t_new, device_ms(f_new))
    return min(t_old, device_ms(f_old)), t_new


def bench_convt(dev, quick: bool, against: Path | None) -> dict:
    from azoom_torch.kernels.convt_kernel import convt1x2, convt1x2_plain

    old_fn = None
    if against is not None:
        old_fn = earlier_library(against, "convt_kernel").azt_convt1x2
        old_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        old_fn.restype = ctypes.c_int

    def earlier(x, w, b):
        out = torch.empty(x.shape[:2] + (2 * x.shape[2], b.shape[0]), dtype=torch.float32, device=dev)
        build.check(old_fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                           x.numel() // x.shape[-1], x.shape[-1], w.shape[1], b.shape[0],
                           torch.cuda.current_stream().cuda_stream), "earlier convt1x2")
        return out

    rng = np.random.default_rng(3)
    batch = 3 if quick else BATCH
    rows = {}
    for k, cout, t in NANO_CONVT:
        x = torch.from_numpy(np.abs(rng.standard_normal((batch, F_ROWS, t, k))).astype(np.float32)).to(dev)
        w = torch.from_numpy((0.05 * rng.standard_normal((k, 2 * cout))).astype(np.float32)).to(dev)
        b = torch.from_numpy((0.1 * rng.standard_normal(cout)).astype(np.float32)).to(dev)
        got, ref = convt1x2(x, w, b), convt1x2_plain(x, w, b)
        torch.cuda.synchronize()
        rel = float((got - ref).abs().max()) / float(ref.abs().max())
        row = dict(batch=batch, not_bit_equal_to_plain=int((got != ref).sum()), rel_err_vs_plain=rel)
        if old_fn is not None:
            row["not_bit_equal_to_earlier"] = int((got != earlier(x, w, b)).sum())
        if not quick:
            p = batch * F_ROWS * t
            x2, b2 = x.reshape(p, k), b.repeat(2)
            row.update(ms=device_ms(lambda: convt1x2(x, w, b)),
                       addmm_ms=device_ms(lambda: torch.addmm(b2, x2, w)),
                       bound_ms=max(4.0 * (p * k + 2 * k * cout + cout + 2 * p * cout) / HBM_BYTES_PER_S,
                                    2.0 * p * k * 2 * cout / FP32_FLOPS_PER_S) * 1e3)
            if old_fn is not None:
                row["earlier_ms"], row["ms"] = _in_turns(lambda: earlier(x, w, b),
                                                         lambda: convt1x2(x, w, b))
            row["tflops"] = 2.0 * p * k * 2 * cout / row["ms"] / 1e9
        rows[str((k, cout, t))] = row
        print(f"[convt] {(k, cout, t)} " + " ".join(
            f"{n}={v:.4g}" if isinstance(v, float) else f"{n}={v}" for n, v in row.items()), flush=True)
        if rel >= 1e-6 or row.get("not_bit_equal_to_earlier", 0):
            raise AssertionError(f"convt {(k, cout, t)}: {row}")
        del x, got, ref
    return rows


def bench_hard_null(dev, quick: bool, against: Path | None) -> dict:
    from azoom_torch.dsp.delays import steering_vector
    from azoom_torch.dsp.stft import rfft_freqs
    from azoom_torch.kernels import nullsteer_kernel as nk

    batch = 8 if quick else BATCH
    rng = np.random.default_rng(4)
    shape = (batch, 2, 513, 64)
    Y = 0.01 * torch.complex(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                               for _ in range(2))).to(dev)
    Y[:, 1] += 0.5 * Y[:, 0]  # correlated mics: anisotropic covariances
    tm = torch.from_numpy(rng.random((batch, 513, 64), dtype=np.float32)).to(dev)
    f = rfft_freqs(1024, 16000, device=dev)
    d = steering_vector(f, 60.0, 0.04, normalize_phase=True)
    args = (Y, tm, d, f)

    def call(fn, *d_bstride):
        """The wrapper's launch with another build's entry point: the
        current interface takes d's batch stride (0: shared), the earlier
        one does not."""
        S = torch.empty((batch, 513, 64), dtype=torch.complex64, device=dev)
        build.check(fn(Y.data_ptr(), tm.data_ptr(), tm.data_ptr(), d.data_ptr(), *d_bstride,
                       f.data_ptr(), 10.0, 200.0, S.data_ptr(), batch, 513, 64,
                       torch.cuda.current_stream().cuda_stream), "hard_null variant")
        return S

    got = nk.hard_null_fused(*args, post_mask=tm)
    ref = nk.hard_null_plain(*args, post_mask=tm)
    cond = nk.hard_null_cond(Y, tm, d)
    keep = (cond / 10.0 - 1).abs() > 1e-9
    err = ((got - ref).abs().norm(dim=-1) / ref.abs().norm(dim=-1).clamp(min=1e-30))[keep]
    row = dict(shape=shape, rows_on_das=int((cond > 10.0).sum()),
               row_rel_err_vs_plain=float(err.max()),
               not_bit_equal_to_plain=int((got != ref).sum()))
    old_fn = None
    if against is not None:
        old_fn = earlier_library(against, "nullsteer_kernel").azt_hard_null
        old_fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_double, ctypes.c_float, ctypes.c_void_p]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        old_fn.restype = ctypes.c_int
        row["not_bit_equal_to_earlier"] = int((got != call(old_fn)).sum())
    if not quick:
        fixed = nk.bind(build.load_library("nullsteer_kernel", ("AZT_HARD_NULL_FIXED_WEIGHTS",)))
        n_el = batch * 513 * 64
        row.update(ms=device_ms(lambda: nk.hard_null_fused(*args, post_mask=tm)),
                   fixed_weights_ms=device_ms(lambda: call(fixed, 0)),
                   bound_ms=max((n_el * (16 + 4 + 4 + 8) + 513 * 20) / HBM_BYTES_PER_S,
                                n_el * 24.0 / FP64_FLOPS_PER_S) * 1e3)
        if old_fn is not None:
            row["earlier_ms"], row["ms"] = _in_turns(
                lambda: call(old_fn), lambda: nk.hard_null_fused(*args, post_mask=tm))
    print("[hard_null] " + " ".join(
        f"{n}={v:.4g}" if isinstance(v, float) else f"{n}={v}" for n, v in row.items()), flush=True)
    if not row["row_rel_err_vs_plain"] <= 1e-5 or row.get("not_bit_equal_to_earlier", 0):
        raise AssertionError(f"hard_null: {row}")
    return {str(shape): row}


def bench_mvdr(dev, quick: bool, against: Path) -> dict:
    from azoom_torch.dsp.delays import steering_vector
    from azoom_torch.dsp.stft import rfft_freqs
    from azoom_torch.kernels.mvdr_kernel import masked_mvdr_fused

    batch, F, T = (8 if quick else BATCH), 513, 65
    rng = np.random.default_rng(5)
    shape = (batch, 2, F, T)
    Y = torch.complex(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                        for _ in range(2))).to(dev)
    nm = torch.from_numpy(rng.random((batch, F, T), dtype=np.float32)).to(dev)
    tm = 1.0 - nm
    f = rfft_freqs(1024, 16000, device=dev)
    d = steering_vector(f, 60.0, 0.04)
    old_fn = earlier_library(against, "mvdr_kernel").azt_masked_mvdr
    old_fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_float,
                                                ctypes.c_float, ctypes.c_void_p]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    old_fn.restype = ctypes.c_int

    def earlier():
        S = torch.empty((batch, F, T), dtype=torch.complex64, device=dev)
        build.check(old_fn(Y.data_ptr(), nm.data_ptr(), tm.data_ptr(), d.data_ptr(), None, 1e-7,
                           f.data_ptr(), 100.0, 0.05, S.data_ptr(), batch, F, T,
                           torch.cuda.current_stream().cuda_stream), "earlier masked_mvdr")
        return S

    def current():
        return masked_mvdr_fused(Y, nm, d, f, target_mask=tm, sigma=1e-7, hp_cutoff_hz=100.0,
                                 mask_floor=0.05)

    row = dict(shape=shape, not_bit_equal_to_earlier=int((current() != earlier()).sum()))
    if not quick:
        row["earlier_ms"], row["ms"] = _in_turns(earlier, current)
    print("[mvdr] " + " ".join(
        f"{n}={v:.4g}" if isinstance(v, float) else f"{n}={v}" for n, v in row.items()), flush=True)
    if row["not_bit_equal_to_earlier"]:
        raise AssertionError(f"mvdr: {row}")
    return {str(shape): row}


def bench_float_conv(dev) -> dict:
    from azoom_torch.dsp.stft import stft
    from azoom_torch.models import unet
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.pipelines.learned import predict_mask

    def cudnn_forward(self, x, residual=None, relu=True, x2=None):
        if x2 is not None:
            x = torch.cat([x, x2], dim=-1)
        cudnn = torch.backends.cudnn
        w = self.weight.reshape(3, 3, self.cin, self.cout).permute(3, 2, 0, 1)
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
        e = self.epi
        y = (y.permute(0, 2, 3, 1) + e[1] - e[2]) * e[3] + e[4]
        y = y if residual is None else residual + y
        return (torch.relu(y) if relu else y).contiguous()

    rng = np.random.default_rng(7)
    Y = stft(torch.from_numpy((0.1 * rng.standard_normal((4, 2, 32000))).astype(np.float32)))
    Y_big = Y.to(dev).repeat(BATCH // 4, 1, 1, 1)
    gemm_forward, rows = unet.FConv.forward, {}
    for name in ("tpufpu_nano", "fpu", "deepfpu", "tpufpu"):
        net_cpu, kind = load_bundled(name, quant=False, device="cpu")
        net = load_bundled(name, quant=False)[0]
        ref = predict_mask(net_cpu, Y, kind)
        for route, fwd in (("gemm", gemm_forward), ("cudnn", cudnn_forward)):
            unet.FConv.forward = fwd
            try:
                err = (predict_mask(net, Y.to(dev), kind).cpu() - ref).abs()
                ms = time_ms(lambda: predict_mask(net, Y_big, kind), iters=3, warmup=1)
            finally:
                unet.FConv.forward = gemm_forward
            rows[f"{name}/{route}"] = dict(mask_max_err=float(err.max()),
                                           mask_mean_err=float(err.mean()), ms_batch128=ms)
            print(f"[float_conv] {name} {route} mask_max_err={float(err.max()):.3e} "
                  f"mask_mean_err={float(err.mean()):.3e} ms_batch128={ms:.2f}", flush=True)
    return rows


def bench_online_mvdr(dev, quick: bool, against: Path | None) -> dict:
    from azoom_torch.dsp.delays import steering_vector
    from azoom_torch.dsp.stft import rfft_freqs
    from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr, online_mvdr_plain

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    F = 513
    freqs = rfft_freqs(1024, 16_000, device=dev)
    d = steering_vector(freqs, 60.0, 0.04)
    old_fn = None
    if against is not None:  # an earlier online_mvdr_kernel.cu of the same C interface
        old_fn = earlier_library(against, "online_mvdr_kernel").azt_online_mvdr
        old_fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_float] * 4
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        old_fn.restype = ctypes.c_int
    rows = {}
    for B, T in ((1, 1), (1, 8), (1, 16), (1, 64), (1, 1875), (128, 1875)):
        if quick and T > 64:
            continue
        lead = () if B == 1 else (B,)
        Y = torch.complex(torch.randn(lead + (2, F, T), generator=gen, device=dev),
                          torch.randn(lead + (2, F, T), generator=gen, device=dev))
        nm = torch.rand(lead + (F, T), generator=gen, device=dev)
        kw = dict(target_mask=1.0 - nm, sigma=1e-7, mask_floor=0.05)
        row = {}
        if B == 1:
            # from a state warmed on 32 frames: from a fresh one the first
            # frames are ill-posed (R = y y^H + a 1e-6 prime)
            warm = initial_state(lead, F, device=dev)
            online_mvdr_plain(torch.complex(*torch.randn((2, 2, F, 32), generator=gen, device=dev)),
                              torch.rand((F, 32), generator=gen, device=dev), d, freqs, *warm)
            st_k, st_p = [t.clone() for t in warm], [t.clone() for t in warm]
            got = online_mvdr(Y, nm, d, freqs, *st_k, **kw)
            ref = online_mvdr_plain(Y, nm, d, freqs, *st_p, **kw)
            row["rel_err"] = float((got - ref).abs().max() / ref.abs().max())
            row["state_rel_err"] = max(float((a - b).abs().max() / b.abs().max())
                                       for a, b in zip(st_k, st_p))
        st = initial_state(lead, F, device=dev)

        def current():
            return online_mvdr(Y, nm, d, freqs, *st, **kw)

        if old_fn is not None:
            st_old = initial_state(lead, F, device=dev)
            tm = kw["target_mask"]

            def earlier():
                S = torch.empty(lead + (F, T), dtype=torch.complex64, device=dev)
                build.check(old_fn(Y.data_ptr(), nm.data_ptr(), tm.data_ptr(), d.data_ptr(), 1e-7,
                                   freqs.data_ptr(), 100.0, 0.98, 1e-6, 0.05, st_old[0].data_ptr(),
                                   st_old[1].data_ptr(), S.data_ptr(), B, F, T,
                                   torch.cuda.current_stream().cuda_stream), "earlier online_mvdr")
                return S

            row["not_bit_equal_to_earlier"] = int((current() != earlier()).sum()) + sum(
                int((a != b).sum()) for a, b in zip(st, st_old))
        if not quick:
            if old_fn is not None:
                row["earlier_ms"], row["ms"] = _in_turns(earlier, current)
            else:
                row["ms"] = device_ms(current)
            nbytes = B * F * (T * (16 + 4 + 4 + 8) + 2 * (32 + 4)) + F * (16 + 4)
            row["bytes_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            row["chain_floor_ms"] = T * 4 / (mhz * 1e6) * 1e3
            row["us_per_frame"] = row["ms"] / T * 1e3
        rows[f"{B}x{T}"] = row
        print(f"[online_mvdr] streams={B} F={F} T={T} " + " ".join(
            f"{k}={v:.4g}" for k, v in row.items()) + f" max_sm_mhz={mhz:g}", flush=True)
    return rows


def bench_fp32_peak(dev) -> dict:
    fn = build.load_library("bench_fp32_peak").azt_fp32_peak
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks, iters = 8 * torch.cuda.get_device_properties(dev).multi_processor_count, 20_000
    out = torch.empty(blocks * 256, dtype=torch.float32, device=dev)
    ms = time_ms(lambda: build.check(fn(out.data_ptr(), blocks, iters, 0.5,
                                        torch.cuda.current_stream().cuda_stream), "fp32_peak"),
                 iters=3, warmup=1)
    row = dict(blocks=blocks, iters=iters, ms=ms, tflops=2.0 * 72 * iters * blocks * 256 / ms / 1e9)
    print("[fp32_peak] " + " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                                    for k, v in row.items()), flush=True)
    return row


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernels.bench: no CUDA device", file=sys.stderr)
        return 2
    quick = "--quick" in argv
    nets = ("tpufpu_nano",)
    if "--nets" in argv:
        i = argv.index("--nets")
        nets = tuple(argv[i + 1].split(","))
        argv = argv[:i] + argv[i + 2:]
    against = None
    if "--against" in argv:
        i = argv.index("--against")
        against = Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    which = [a for a in argv if not a.startswith("--")] or ["int8_mm", "qconv"]
    if "mvdr" in which and against is None:
        print("kernels.bench: mvdr needs --against DIR (chip_smoke.py phase 2 holds B1 "
              "against its plain version)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    info = build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[build] {({k: round(v['seconds'], 2) for k, v in info.items()})} card='{card}'")
    regs = ptxas_summary(info)
    for name, (r, spill) in regs.items():
        print(f"[ptxas] {name} registers={r} spill_bytes={spill}")
    for name, v in info.items():
        if "setmaxnreg" in v["log"]:
            print(f"[ptxas] {name}: " + "; ".join(
                ln for ln in v["log"].splitlines() if "setmaxnreg" in ln))
    # a block's registers at launch: 65,536 over its 384 or (qconv at Cout <= 128) 512 threads
    want = {"int8_mm_kernelILi": (168,), "qconv_wgmma": (168, 128)}
    bad = [n for n, (r, _) in regs.items() for key, w in want.items() if key in n and r not in w]
    if bad:
        print(f"kernels.bench: {bad} do not start from {want} registers; not launching",
              file=sys.stderr)
        return 3
    out = {"card": card, "ptxas": regs}
    if "clocks" in which:
        if which != ["clocks"]:
            print("kernels.bench: clocks runs alone (it loads another build of the conv)",
                  file=sys.stderr)
            return 2
        out["qconv_clocks"] = bench_clocks(dev, nets)
    if "int8_mm" in which:
        out["int8_mm"] = bench_int8_mm(dev, quick)
    if "qconv" in which:
        out["qconv"] = bench_qconv(dev, quick, nets)
    if "convt" in which:
        out["convt"] = bench_convt(dev, quick, against)
    if "hard_null" in which:
        out["hard_null"] = bench_hard_null(dev, quick, against)
    if "mvdr" in which:
        out["mvdr"] = bench_mvdr(dev, quick, against)
    if "online_mvdr" in which:
        out["online_mvdr"] = bench_online_mvdr(dev, quick, against)
    if "float_conv" in which:
        out["float_conv"] = bench_float_conv(dev)
    if "fp32_peak" in which:
        out["fp32_peak"] = bench_fp32_peak(dev)
    for rows in out.values():  # the card beside every time
        if isinstance(rows, dict):
            for row in rows.values():
                if isinstance(row, dict):
                    row["card"] = card
    Path("chiprun_out").mkdir(exist_ok=True)
    name = "kernel_clocks.json" if "clocks" in which else "kernel_bench.json"
    Path("chiprun_out", name).write_text(json.dumps(out, indent=1))
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
