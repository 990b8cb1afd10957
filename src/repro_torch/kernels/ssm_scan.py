"""The Mamba-1 selective scan:
``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t``, ``y_t = h_t . C_t``,
and its backward.

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
slices come in without a copy). With ``checkpoints=True`` it also returns
the state entering every run of ``CHECKPOINT_EVERY`` steps, (B, S, D, N)
fp32 with S = ceil(T / 16): what the backward rebuilds each run from.

:func:`ssm_scan_bwd` is the backward (training, fp32): from the cotangents
of y and h_T, the gradients of dt, Bm, Cm, x, A and h0, through
``ssm_scan_bwd_kernel`` (each channel walks its runs back from their
checkpoints) on a CUDA tensor and :func:`ssm_scan_bwd_ref`, an explicit
reverse-time loop, on a CPU tensor. It ports no Pallas kernel: the reference
differentiates a plain ``lax.scan``. The differentiable entry point of both
is ``ops.mamba_ssm_scan_train`` (the autograd.Function ``ops.SSMScan``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.grad_guard import refuse_grad

MAX_STATE = 16   # csrc/ssm_scan.cu's kMaxN
CHECKPOINT_EVERY = 16   # csrc/ssm_scan.cu's kTT: a checkpoint every run of 16 steps
BWD_CHANNELS = 64       # csrc/ssm_scan.cu's kBCh: channels a block of the backward
LANES = (1, 2, 4)   # lanes a channel the kernel splits the states across
# The lanes a channel the wrapper launches, prefill (T > 1) and decode
# (T = 1): the fastest of LANES at the Jamba shapes in chip_smoke.py phase 4
# (PERF.md §6, row 7).
PREFILL_LANES = 2
DECODE_LANES = 2

_NO_GRAD = ("Its differentiable entry point is ops.mamba_ssm_scan_train (the "
            "autograd.Function ops.SSMScan).")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("ssm_scan")
    args = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.ssm_scan_f32, lib.ssm_scan_bf16):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.ssm_scan_bwd_f32.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
    lib.ssm_scan_bwd_f32.restype = ctypes.c_int
    lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssm_scan_ref(dt, Bm, Cm, x, A, h0, *, checkpoints=False):
    """Plain version: the sequential scan in fp32 (the reference's
    ``ssm_scan_ref``); with ``checkpoints``, also the state entering every
    run of ``CHECKPOINT_EVERY`` steps, (B, S, D, N)."""
    dtf, Bf, Cf, xf, Af = dt.float(), Bm.float(), Cm.float(), x.float(), A.float()
    h = h0.float()
    ys, cks = [], []
    for t in range(dt.shape[1]):
        if t % CHECKPOINT_EVERY == 0:
            cks.append(h)
        dA = torch.exp(dtf[:, t, :, None] * Af[None])
        h = dA * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)
    if not checkpoints:
        return y.to(x.dtype), h
    ck = torch.stack(cks, dim=1) if cks else h.new_zeros((h.shape[0], 0) + h.shape[1:])
    return y.to(x.dtype), h, ck


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


def n_checkpoints(T: int) -> int:
    """Checkpoints of a scan of T steps: one a run of ``CHECKPOINT_EVERY``."""
    return -(-T // CHECKPOINT_EVERY)


def ssm_scan(dt, Bm, Cm, x, A, h0, *, checkpoints=False):
    """Selective scan over T from the state ``h0``: (y, h_T), and with
    ``checkpoints`` the (B, S, D, N) fp32 states entering each run of 16
    steps (what :func:`ssm_scan_bwd` reads), written by the same launch.

    ``ssm_scan.launches`` counts kernel launches; ``ssm_scan.lane_launches``
    splits them by lanes a channel (CPU calls and empty inputs launch
    nothing and count nothing, and neither does a
    call under a CUDA stream capture, which only records the launch)."""
    _check(dt, Bm, Cm, x, A, h0)
    if dt.device.type == "cpu":
        return ssm_scan_ref(dt, Bm, Cm, x, A, h0, checkpoints=checkpoints)
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
    ck = (torch.empty((B, n_checkpoints(T), D, N), dtype=torch.float32, device=x.device)
          if checkpoints else None)
    y, h_out = _launch(dt, Bm, Cm, x, A, h0, launch_plan(T), ck)
    return (y, h_out, ck) if checkpoints else (y, h_out)


def _launch(dt, Bm, Cm, x, A, h0, lanes, ck=None):
    """One launch with ``lanes`` lanes a channel on CUDA tensors that
    :func:`ssm_scan` has checked, writing the checkpoints into ``ck`` when
    given. Module-private: ``chip_smoke.py`` holds and times every lane
    count through it."""
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
            h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), None if ck is None else ck.data_ptr(),
            B, T, D, N, strides, lanes, stream)
    if rc != 0:
        msg = lib.ssm_scan_error_string(rc).decode()
        raise RuntimeError(f"ssm_scan kernel launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
        ssm_scan.launches += 1
        ssm_scan.lane_launches[lanes] += 1
    return y, h_out


ssm_scan.launches = 0
ssm_scan.lane_launches = dict.fromkeys(LANES, 0)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

ALL_GRADS = (True,) * 6   # dt, Bm, Cm, x, A, h0


def ssm_scan_bwd_ref(dt, Bm, Cm, x, A, h0, gy, g_hT=None, needs=ALL_GRADS):
    """Plain version of the backward, an explicit fp32 reverse-time loop:
    the states h_{-1} = h0 .. h_{T-1} recomputed forward, then, from T - 1
    down to 0, ``G_t = gy_t c_t + a_{t+1} G_{t+1}`` (``G_{T-1}`` starts from
    ``g_hT``, zeros for None) and each input's gradient from it. Returns
    (g_dt, g_Bm, g_Cm, g_x, g_A, g_h0) in fp32, None where ``needs`` is
    False."""
    dtf, Bf, Cf, xf, Af, gyf = (t.float() for t in (dt, Bm, Cm, x, A, gy))
    B, T, D = dt.shape
    need_dt, need_B, need_C, need_x, need_A, need_h0 = needs
    hs = [h0.float()]
    for t in range(T):
        a = torch.exp(dtf[:, t, :, None] * Af)
        hs.append(a * hs[-1] + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])
    R = torch.zeros_like(hs[0]) if g_hT is None else g_hT.float()
    g_dt = torch.empty_like(dtf) if need_dt else None
    g_x = torch.empty_like(xf) if need_x else None
    g_B = torch.empty_like(Bf) if need_B else None
    g_C = torch.empty_like(Cf) if need_C else None
    g_A = torch.zeros_like(Af) if need_A else None
    for t in reversed(range(T)):
        a = torch.exp(dtf[:, t, :, None] * Af)
        G = gyf[:, t, :, None] * Cf[:, t, None, :] + R
        if need_C:
            g_C[:, t] = torch.einsum("bd,bdn->bn", gyf[:, t], hs[t + 1])
        if need_B:
            g_B[:, t] = torch.einsum("bd,bdn->bn", dtf[:, t] * xf[:, t], G)
        g_u = torch.einsum("bdn,bn->bd", G, Bf[:, t])
        da = G * hs[t] * a
        if need_dt:
            g_dt[:, t] = g_u * xf[:, t] + (da * Af).sum(-1)
        if need_x:
            g_x[:, t] = g_u * dtf[:, t]
        if need_A:
            g_A += (da * dtf[:, t, :, None]).sum(0)
        R = a * G
    return g_dt, g_B, g_C, g_x, g_A, (R if need_h0 else None)


def ssm_scan_bwd(dt, Bm, Cm, x, A, h0, gy, g_hT=None, *, checkpoints=None, needs=ALL_GRADS):
    """The scan's backward: from the cotangents ``gy`` (B, T, D) of y and
    ``g_hT`` (B, D, N) of h_T (None: zeros), (g_dt, g_Bm, g_Cm, g_x, g_A,
    g_h0), each a fresh contiguous fp32 tensor, None where ``needs`` (six
    flags in that order) is False: those are not computed.

    On a CUDA tensor the kernel reads ``checkpoints``, the forward's
    (``ssm_scan(..., checkpoints=True)``), in place of h0; all inputs fp32.
    On a CPU tensor it is :func:`ssm_scan_bwd_ref`, which recomputes the
    states from h0 and reads no checkpoints. ``ssm_scan_bwd.launches``
    counts launches (the scan and its reduction, one launch), as
    ``ssm_scan.launches`` does."""
    _check(dt, Bm, Cm, x, A, h0)
    B, T, D = dt.shape
    N = A.shape[1]
    if tuple(gy.shape) != (B, T, D) or (g_hT is not None and tuple(g_hT.shape) != (B, D, N)):
        raise ValueError(f"ssm_scan_bwd: gy {tuple(gy.shape)} and g_hT "
                         f"{None if g_hT is None else tuple(g_hT.shape)}, want {(B, T, D)} "
                         f"and {(B, D, N)}")
    if len(needs) != 6:
        raise ValueError(f"needs takes six flags (dt, Bm, Cm, x, A, h0), got {needs}")
    cotangents = (gy,) + (() if g_hT is None else (g_hT,))
    if any(t.device != dt.device for t in cotangents):
        raise ValueError("ssm_scan_bwd needs gy and g_hT on the inputs' device")
    if dt.device.type == "cpu":
        return ssm_scan_bwd_ref(dt, Bm, Cm, x, A, h0, gy, g_hT, needs)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd runs on cpu or cuda, not {dt.device}")
    tensors = (dt, Bm, Cm, x, A, h0) + cotangents
    refuse_grad("ssm_scan_bwd", tensors, _NO_GRAD)
    if checkpoints is None:
        raise ValueError("the CUDA ssm_scan_bwd reads the forward's checkpoints: pass those "
                         "of ssm_scan(..., checkpoints=True)")
    if any(t.dtype != torch.float32 for t in tensors + (checkpoints,)):
        raise TypeError("the CUDA ssm_scan_bwd takes float32 inputs, cotangents and checkpoints; "
                        f"got {[str(t.dtype) for t in tensors + (checkpoints,)]}")
    if N > MAX_STATE:
        raise ValueError(f"the CUDA ssm_scan_bwd takes d_state up to {MAX_STATE}, got {N}")
    if B > 65535:
        raise ValueError(f"the CUDA ssm_scan_bwd takes up to 65535 batch rows, got {B}")
    if tuple(checkpoints.shape) != (B, n_checkpoints(T), D, N) or checkpoints.device != dt.device:
        raise ValueError(f"ssm_scan_bwd: checkpoints {tuple(checkpoints.shape)} on "
                         f"{checkpoints.device}, want {(B, n_checkpoints(T), D, N)} on {dt.device}")
    if any(t.stride(-1) != 1 for t in (dt, Bm, Cm, x, gy)) or not (
            A.is_contiguous() and checkpoints.is_contiguous()
            and (g_hT is None or g_hT.is_contiguous())):
        raise ValueError("ssm_scan_bwd needs dt, Bm, Cm, x, gy with a contiguous last axis "
                         "and contiguous A, g_hT and checkpoints")
    dev = dt.device

    def out(flag, shape):
        return torch.empty(shape, dtype=torch.float32, device=dev) if flag else None

    need_dt, need_B, need_C, need_x, need_A, need_h0 = needs
    g_dt, g_x = out(need_dt, (B, T, D)), out(need_x, (B, T, D))
    g_B, g_C = out(need_B, (B, T, N)), out(need_C, (B, T, N))
    g_A, g_h0 = out(need_A, (D, N)), out(need_h0, (B, D, N))
    if B * T * D * N == 0:
        for g in (g_dt, g_x, g_B, g_C, g_A, g_h0):
            if g is not None:
                g.zero_()
        if g_h0 is not None and g_hT is not None:
            g_h0.copy_(g_hT)   # T = 0: h_T is h0
        return g_dt, g_B, g_C, g_x, g_A, g_h0
    nblk = -(-D // BWD_CHANNELS)
    part_B, part_C = out(need_B, (B, T, nblk, N)), out(need_C, (B, T, nblk, N))
    gA_part = out(need_A, (B, D, N))
    strides = (ctypes.c_longlong * 10)(*(s for t in (dt, x, Bm, Cm, gy) for s in t.stride()[:2]))
    lib = _lib()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    rc = lib.ssm_scan_bwd_f32(
        dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(), A.data_ptr(),
        checkpoints.data_ptr(), gy.data_ptr(), ptr(g_hT), ptr(g_dt), ptr(g_x), ptr(g_B),
        ptr(g_C), ptr(g_A), ptr(g_h0), ptr(part_B), ptr(part_C), ptr(gA_part), B, T, D, N,
        strides, n_sms, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.ssm_scan_error_string(rc).decode()
        raise RuntimeError(f"ssm_scan_bwd kernel launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():
        ssm_scan_bwd.launches += 1
    return g_dt, g_B, g_C, g_x, g_A, g_h0


ssm_scan_bwd.launches = 0
