"""What holds the port's redesigned kernels back, measured on the card.

    PYTHONPATH=src python -m repro_torch.kernels.probe      # needs a CUDA card

1. Calibration (``csrc/probe.cu``): the card's fp32 FFMA rate and its
   special-function units' ex2 rate on independent chains, and
   ``gossip_mix_dense_kernel``'s 8 x 4 FMA pattern (operands from shared
   memory) at 13 and 32 warps an SM.
2. Ablations: ``gossip_mix_dense_kernel`` on the full graph (n = 100, the
   CNN's N) and ``ssm_scan_ring_kernel`` at the Jamba prefill shape (2 lanes
   a channel), each rebuilt from its source with one part cut out -- the
   loads of the next tile or run, the y stores, the exponentials -- and
   timed beside the kernel itself. A cut kernel computes nothing useful;
   only its time is read.

Times are CUDA events, median of 50 launches with the L2 cache flushed
before each; each line names the card and its power limit. A build
directory under ``build/repro_torch/probe`` holds the cut kernels.
"""
from __future__ import annotations

import ctypes
import re
import subprocess

import numpy as np
import torch

from repro_torch.kernels import build

PROBE_DIR = build.BUILD_DIR / "probe"

# (source, variant) -> (text to cut, what replaces it)
CUTS = {
    ("gossip_mix", "no X loads"): [("      issue(lj, lkpi, (s + 1) % kDenseStages);\n", "")],
    ("ssm_scan", "no dt/x/B/C loads"): [("    issue(r + kStages - 1);\n",
                                         "    async_copy::commit();\n")],
    ("ssm_scan", "no y stores"): [("    if (r > 0) store_y(r - 1);\n", "")],
    ("ssm_scan", "no loads, no y stores"): [
        ("    issue(r + kStages - 1);\n", "    async_copy::commit();\n"),
        ("    if (r > 0) store_y(r - 1);\n", "")],
    ("ssm_scan", "no exponentials"): [
        ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(r) : "f"(v));\n',
         "  r = fmaf(v, 0.01f, 0.99f);\n")],
}


def _cut_library(name, variant):
    """nvcc the source with the variant's cuts into PROBE_DIR; the path."""
    text = (build.CSRC / f"{name}.cu").read_text()
    for old, new in CUTS[(name, variant)]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}.cu no longer has the code the {variant!r} cut removes")
        text = text.replace(old, new)
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    tag = re.sub(r"[^a-z0-9]+", "_", variant)   # nvcc splits its arguments at commas
    src = PROBE_DIR / f"{name}_{tag}.cu"
    src.write_text(text)
    lib = src.with_suffix(".so")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([build._nvcc(), *flags, "-I", str(build.CSRC), "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {variant!r} cut of {name}.cu:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _time_ms(fn, flush, iters=50):
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def calibrate():
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = build.load("probe")
    for fn in (lib.probe_ffma_run, lib.probe_ex2_run):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
    lib.probe_outer_run.argtypes = [ctypes.c_int] + lib.probe_ffma_run.argtypes
    out = torch.empty(sms * 8 * 256, device="cuda")
    rows = {}

    def rate(launch, ops):
        launch(5)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            if launch(200) != 0:
                raise RuntimeError("a probe kernel failed to launch")
        e1.record()
        torch.cuda.synchronize()
        return ops / (e0.elapsed_time(e1) / 5 * 1e-3)

    blocks, threads = sms * 8, 256
    rows["ffma TFLOP/s"] = rate(
        lambda it: lib.probe_ffma_run(out.data_ptr(), blocks, threads, it * 100, _stream()),
        2 * 32 * blocks * threads * 200 * 100) / 1e12
    rows["ex2 a clock an SM at 1.98 GHz"] = rate(
        lambda it: lib.probe_ex2_run(out.data_ptr(), blocks, threads, it * 100, _stream()),
        16 * blocks * threads * 200 * 100) / (sms * 1.98e9)
    for cols in (4, 8):
        for per_sm, threads in ((2, 208), (4, 256)):
            warps = per_sm * threads // 32
            rows[f"8x{cols} FMA pattern, {warps} warps an SM, TFLOP/s"] = rate(
                lambda it: lib.probe_outer_run(cols, out.data_ptr(), sms * per_sm, threads, it,
                                               _stream()),
                2 * sms * per_sm * threads * 200 * 64 * 8 * cols) / 1e12
    return rows


def ablate():
    from repro_torch.core import topology
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import ssm_scan as sk

    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    rows = {}
    plan = topology.FullTopology().build(100)
    idx, w = torch.from_numpy(plan.idx).cuda(), torch.from_numpy(plan.weight).cuda()
    x = torch.randn((100, 1_663_370), device="cuda")
    out = torch.empty_like(x)

    def mix(lib):
        fn = lib.gossip_mix_dense_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_void_p]
        return lambda: fn(x.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), 100,
                          x.shape[1], idx.shape[1], _stream())

    rows["gossip_mix dense, full graph n=100 N=1663370: the kernel"] = _time_ms(
        mix(gm._lib()), flush)
    rows["gossip_mix dense: no X loads"] = _time_ms(
        mix(_cut_library("gossip_mix", "no X loads")), flush)

    g = torch.Generator(device="cuda").manual_seed(7)
    B, T, D, N = 4, 2048, 8192, 16
    dt = torch.rand((B, T, D), generator=g, device="cuda") * 0.1 + 1e-3
    Bm, Cm = (torch.randn((B, T, N), generator=g, device="cuda") for _ in range(2))
    xs = torch.randn((B, T, D), generator=g, device="cuda")
    A = -torch.rand((D, N), generator=g, device="cuda") * 16 - 0.5
    h0 = torch.zeros((B, D, N), device="cuda")
    y, h = torch.empty_like(xs), torch.empty_like(h0)
    strides = (ctypes.c_longlong * 8)(*(s for t in (dt, xs, Bm, Cm) for s in t.stride()[:2]))

    def scan(lib):
        fn = lib.ssm_scan_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
        return lambda: fn(dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), xs.data_ptr(),
                          A.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(), B, T, D, N,
                          strides, sk.PREFILL_LANES, _stream())

    rows[f"ssm_scan prefill B=4 T=2048 D=8192 N=16, {sk.PREFILL_LANES} lanes: the kernel"] = \
        _time_ms(scan(sk._lib()), flush)
    for name, variant in CUTS:
        if name == "ssm_scan":
            rows[f"ssm_scan: {variant}"] = _time_ms(scan(_cut_library(name, variant)), flush)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe: this needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    for what, rows in (("calibration", calibrate()), ("ablations, ms", ablate())):
        print(f"== {what}")
        for k, v in rows.items():
            print(f"  {k}: {v:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
