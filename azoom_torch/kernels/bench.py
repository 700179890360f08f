"""Check and time the port's int8 tensor-core kernels alone, shape by shape,
on one NVIDIA GPU:

    python3 -m azoom_torch.kernels.bench [int8_mm] [qconv] [--quick]
    python3 -m azoom_torch.kernels.bench clocks

``int8_mm``: each of the nine microbenchmark shapes held exactly against the
plain version, then timed beside ``torch._int_mm`` (whose column-major ``w``
is made outside the timing). ``ms`` is the time per call of a loop of
calls from Python, as ``chip_smoke.py`` takes it; ``device_ms`` replays the
same calls from a CUDA graph, which leaves out the host's time per call.

``qconv``: each conv shape of the bundled tpufpu_nano net at batch 128, plain,
with a residual and (where the net has it) with the two-tensor concat input:
the ``wgmma`` kernel held bit for bit (``torch.equal``) against the
``mma.sync`` kernel it replaced and within 1e-5 relative of the plain
version, then both timed in turns (old, new, new, old), beside a
device-to-device copy of as many bytes as the conv must move (``copy_ms``:
what the card's memory gives a kernel that does nothing else).

``clocks`` (alone): builds the ``wgmma`` conv with ``-DAZT_QCONV_CLOCKS`` and
prints, per shape, the cycles per tile that block 0's first consumer thread
spends waiting for a halo, in the products and in the epilogue, and that its
first producer thread spends waiting for a halo buffer and loading and
quantising: which role bounds the kernel, where no profiler reads stalls.

``--quick`` checks only (batch 8, no timing): the first run of a new build.
Prints ptxas's registers and spills per kernel first and stops before any
launch if a kernel that rebalances registers between its warpgroups
(``setmaxnreg``) was not given the registers its block starts from (65,536
over its threads). Writes ``chiprun_out/kernel_bench.json``
(``clocks``: ``kernel_clocks.json``).
"""

from __future__ import annotations

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
# (Cin, Cout, frames, launches in the net, the net also runs it on a concat input)
NANO_SHAPES = (
    (16, 64, 64, 1, False), (64, 64, 64, 2, False), (64, 64, 32, 5, False),
    (64, 128, 16, 1, False), (128, 128, 16, 4, False), (128, 256, 8, 1, False),
    (256, 256, 8, 4, False), (256, 128, 16, 1, True), (128, 64, 32, 1, True),
    (128, 64, 64, 1, True),
)


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


def bench_qconv(dev, quick: bool) -> dict:
    from azoom_torch.kernels import qconv_kernel as qk

    rng = np.random.default_rng(1)
    batch = 8 if quick else BATCH
    rows = {}
    for cin, cout, t, launches, has_cat in NANO_SHAPES:
        x = torch.from_numpy(np.abs(rng.standard_normal((batch, F_ROWS, t, cin)))
                             .astype(np.float32)).to(dev)
        act_scale = float(np.float32(3.3 / 127))
        w_q = qk.pack_weights(torch.from_numpy(
            rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8))).to(dev)
        epi = torch.from_numpy(np.stack([
            np.full(cout, 2e-4), 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout),
            1 + 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout),
        ]).astype(np.float32)).to(dev)
        res = torch.from_numpy(rng.standard_normal((batch, F_ROWS, t, cout))
                               .astype(np.float32)).to(dev)
        route = qk.plan(cin, cout, t)["kernel"]
        for variant in ("plain", "res") + (("cat",) if has_cat else ()):
            kw = dict(residual=res if variant == "res" else None)
            xin = x
            if variant == "cat":
                xin, kw["x2"] = x[..., :cin // 2].contiguous(), x[..., cin // 2:].contiguous()
            new = qk.qconv3x3(xin, w_q, epi, act_scale, **kw)
            old = qk.qconv3x3(xin, w_q, epi, act_scale, **kw, _kernel="mma")
            ref = qk.qconv3x3_plain(xin, w_q, epi, act_scale, **kw)
            torch.cuda.synchronize()
            rel = float((new - ref).abs().max()) / float(ref.abs().max())
            row = dict(kernel=route, launches=launches, bit_equal=bool(torch.equal(new, old)),
                       rel_err_vs_plain=rel)
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
            rows[str((cin, cout, t, variant))] = row
            print(f"[qconv] {(cin, cout, t, variant)} " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()),
                flush=True)
            if not row["bit_equal"]:
                diff = (new - old).abs()
                raise AssertionError(
                    f"qconv {(cin, cout, t, variant)}: differs from the mma.sync kernel at "
                    f"{int((diff > 0).sum())} of {diff.numel()} outputs, max {float(diff.max()):.3e}")
            if rel >= 1e-5:
                raise AssertionError(f"qconv {(cin, cout, t, variant)}: relative error {rel:.3e}")
        del x, res
    return rows


def bench_clocks(dev) -> dict:
    import ctypes

    from azoom_torch.kernels import qconv_kernel as qk

    qk.BUILD_DEFINES = ("AZT_QCONV_CLOCKS",)  # before the first launch loads the library
    read = build.load_library("qconv_kernel", qk.BUILD_DEFINES).azt_qconv3x3_clocks
    read.argtypes, read.restype = [ctypes.POINTER(ctypes.c_longlong)], ctypes.c_int
    names = ("wait_halo", "products", "epilogue", "wait_buffer", "load_quantise")
    rng = np.random.default_rng(2)
    rows = {}
    for cin, cout, t, _, _ in NANO_SHAPES:
        how = qk.plan(cin, cout, t)
        if how["kernel"] != "wgmma":
            continue
        x = torch.from_numpy(np.abs(rng.standard_normal((BATCH, F_ROWS, t, cin)))
                             .astype(np.float32)).to(dev)
        w_q = qk.pack_weights(torch.from_numpy(
            rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8))).to(dev)
        epi = torch.ones((5, cout), dtype=torch.float32, device=dev)
        res = torch.from_numpy(rng.standard_normal((BATCH, F_ROWS, t, cout))
                               .astype(np.float32)).to(dev)
        for variant in ("plain", "res"):
            for _ in range(3):
                qk.qconv3x3(x, w_q, epi, 0.026, residual=res if variant == "res" else None)
            sums = (ctypes.c_longlong * 6)()
            build.check(read(sums), "qconv3x3 clocks")
            row = {n: round(sums[i] / sums[5]) for i, n in enumerate(names)}
            row.update(tiles_of_block_0=int(sums[5]), m_tile=how["m_tile"],
                       weights="resident" if how["resident"] else f"ring of {how['stages']}")
            rows[str((cin, cout, t, variant))] = row
            print(f"[clocks] {(cin, cout, t, variant)} per tile: " + " ".join(
                f"{k}={v}" for k, v in row.items()), flush=True)
        del x, res
    return rows


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernels.bench: no CUDA device", file=sys.stderr)
        return 2
    quick = "--quick" in argv
    which = [a for a in argv if not a.startswith("--")] or ["int8_mm", "qconv"]
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
        out["qconv_clocks"] = bench_clocks(dev)
    if "int8_mm" in which:
        out["int8_mm"] = bench_int8_mm(dev, quick)
    if "qconv" in which:
        out["qconv"] = bench_qconv(dev, quick)
    Path("chiprun_out").mkdir(exist_ok=True)
    name = "kernel_clocks.json" if "clocks" in which else "kernel_bench.json"
    Path("chiprun_out", name).write_text(json.dumps(out, indent=1))
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
