"""The Mamba-1 selective scan:
``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t``, ``y_t = h_t . C_t``.

Replaces ``repro/kernels/ssm_scan.py::ssm_scan`` (the Pallas
``_ssm_kernel``). On a CUDA tensor the work goes to the hand-written kernel
in ``csrc/ssm_scan.cu`` (see the source note): each channel's N states are
split across L neighbouring lanes of a warp, and a block's next 16 time
steps of dt, x, B and C stream into shared memory through a ``cp.async``
ring while it scans the current 16. :func:`launch_plan` picks L. On a CPU
tensor it goes to :func:`ssm_scan_ref`, the plain version beside it, a loop
over time. The tensor's device decides; a CUDA tensor launches the kernel
or raises, with no fallback.

Shapes: dt, x (B, T, D); Bm, Cm (B, T, N); A (D, N); h0 (B, D, N). Returns
y (B, T, D) in x's dtype and the final state (B, D, N) in fp32. The kernel
takes dt, x, Bm, Cm in one dtype, fp32 or bf16, with A and h0 in fp32, N up
to 16, and views whose last axis is contiguous (time slices and column
slices come in without a copy).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.grad_guard import refuse_grad

MAX_STATE = 16   # csrc/ssm_scan.cu's kMaxN
LANES = (1, 2, 4)   # lanes a channel the kernel splits the states across
# The lanes a channel the wrapper launches, prefill (T > 1) and decode
# (T = 1): the fastest of LANES at the Jamba shapes in chip_smoke.py phase 4
# (PERF.md §6, row 7).
PREFILL_LANES = 2
DECODE_LANES = 2

_NO_GRAD = ("No differentiable entry point exists yet: the scan's backward comes with "
            "Jamba training, ROADMAP Queue 1 item 4.")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("ssm_scan")
    args = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.ssm_scan_f32, lib.ssm_scan_bf16):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssm_scan_ref(dt, Bm, Cm, x, A, h0):
    """Plain version: the sequential scan in fp32 (the reference's
    ``ssm_scan_ref``)."""
    dtf, Bf, Cf, xf, Af = dt.float(), Bm.float(), Cm.float(), x.float(), A.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        dA = torch.exp(dtf[:, t, :, None] * Af[None])
        h = dA * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)
    return y.to(x.dtype), h


def _check(dt, Bm, Cm, x, A, h0):
    if dt.ndim != 3 or Bm.ndim != 3 or A.ndim != 2:
        raise ValueError(
            f"ssm_scan needs dt, x (B, T, D), Bm, Cm (B, T, N), A (D, N), h0 (B, D, N); "
            f"got dt {tuple(dt.shape)}, Bm {tuple(Bm.shape)}, A {tuple(A.shape)}"
        )
    B, T, D = dt.shape
    N = A.shape[1]
    want = {"x": (x, (B, T, D)), "Bm": (Bm, (B, T, N)), "Cm": (Cm, (B, T, N)),
            "A": (A, (D, N)), "h0": (h0, (B, D, N))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan: {name} is {tuple(t.shape)}, want {shape}")
    if len({t.device for t in (dt, Bm, Cm, x, A, h0)}) != 1:
        raise ValueError("ssm_scan needs all of dt, Bm, Cm, x, A, h0 on one device")


def launch_plan(T: int) -> int:
    """Lanes a channel for a scan of T steps. Every N up to ``MAX_STATE`` is
    padded to 4, 8 or 16 states, which each of ``LANES`` splits evenly, so
    the plan reads T only, on any device, before any build."""
    return DECODE_LANES if T == 1 else PREFILL_LANES


def ssm_scan(dt, Bm, Cm, x, A, h0):
    """Selective scan over T from the state ``h0``: (y, h_T).

    ``ssm_scan.launches`` counts kernel launches; ``ssm_scan.lane_launches``
    splits them by lanes a channel (CPU calls and empty inputs launch
    nothing and count nothing, and neither does a
    call under a CUDA stream capture, which only records the launch)."""
    _check(dt, Bm, Cm, x, A, h0)
    if dt.device.type == "cpu":
        return ssm_scan_ref(dt, Bm, Cm, x, A, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cpu or cuda, not {dt.device}")
    refuse_grad("ssm_scan", (dt, Bm, Cm, x, A, h0), _NO_GRAD)
    dtype = x.dtype
    if dtype not in (torch.float32, torch.bfloat16) or not (dt.dtype == Bm.dtype == Cm.dtype
                                                              == dtype):
        raise TypeError(
            "the CUDA ssm_scan takes dt, Bm, Cm, x in one dtype, float32 or bfloat16; got "
            f"{dt.dtype}, {Bm.dtype}, {Cm.dtype}, {x.dtype}"
        )
    if A.dtype != torch.float32 or h0.dtype != torch.float32:
        raise TypeError(f"A and h0 must be float32, got {A.dtype} and {h0.dtype}")
    B, T, D = dt.shape
    N = A.shape[1]
    if N > MAX_STATE:
        raise ValueError(f"the CUDA ssm_scan takes d_state up to {MAX_STATE}, got {N}")
    if B > 65535:
        raise ValueError(f"the CUDA ssm_scan takes up to 65535 batch rows, got {B}")
    if any(t.stride(-1) != 1 for t in (dt, Bm, Cm, x)) or not (A.is_contiguous()
                                                               and h0.is_contiguous()):
        raise ValueError("ssm_scan needs dt, Bm, Cm, x with a contiguous last axis "
                         "and contiguous A and h0")
    return _launch(dt, Bm, Cm, x, A, h0, launch_plan(T))


def _launch(dt, Bm, Cm, x, A, h0, lanes):
    """One launch with ``lanes`` lanes a channel on CUDA tensors that
    :func:`ssm_scan` has checked. Module-private: ``chip_smoke.py`` holds and
    times every lane count through it."""
    if lanes not in LANES:
        raise ValueError(f"ssm_scan has no launch with {lanes} lanes a channel")
    B, T, D = dt.shape
    N = A.shape[1]
    y = torch.empty((B, T, D), dtype=x.dtype, device=x.device)
    h_out = torch.empty((B, D, N), dtype=torch.float32, device=x.device)
    if B * T * D * N == 0:
        h_out.copy_(h0)
        return y, h_out
    strides = (ctypes.c_longlong * 8)(*(s for t in (dt, x, Bm, Cm) for s in t.stride()[:2]))
    lib = _lib()
    fn = lib.ssm_scan_f32 if x.dtype == torch.float32 else lib.ssm_scan_bf16
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(), A.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), B, T, D, N, strides, lanes, stream)
    if rc != 0:
        msg = lib.ssm_scan_error_string(rc).decode()
        raise RuntimeError(f"ssm_scan kernel launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
        ssm_scan.launches += 1
        ssm_scan.lane_launches[lanes] += 1
    return y, h_out


ssm_scan.launches = 0
ssm_scan.lane_launches = dict.fromkeys(LANES, 0)
