"""Forward flash attention: online-softmax attention that never holds the
(Sq, Sk) score matrix whole.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
``_flash_kernel``). On a CUDA tensor the work goes to the hand-written
kernel in ``csrc/flash_attention.cu`` (see its note for the design and the
bound). On a CPU tensor it goes to :func:`flash_attention_ref`, the plain
version: ``models.attention_core.blocked_attention``, the same tiled
online softmax. The tensor's device decides; a CUDA tensor launches the
kernel or raises, with no fallback.

Two layouts, as the reference has them:

- (BH, S, D) q, k, v: the reference kernel's single-head layout;
- (B, Sq, H, D) q with (B, Sk, K, D) k and v, H a multiple of K: the model
  layout of ``ops.mha_flash``. Query head h reads KV head h // (H // K) in
  place (the reference repeats the KV heads first).

Masks: causal with positions from 0 (prefill and training; there is no
query offset), a sliding ``window`` (0 = none), and keys past Sk. Scores,
statistics and the accumulator are fp32; the output takes q's dtype.
``return_lse`` adds each query row's fp32 log-sum-exp, which the training
backward (``ops.FlashAttention``) rebuilds the probabilities from; prefill
does not ask for it, and the kernel then writes none. On the card the
wrapper refuses inputs that require grad (``grad_guard``): training reaches
it through ``ops.FlashAttention``.

Two kernels, chosen by :func:`_route` from the dtype, D and alignment:

- ``"mma"``, ``flash_fwd_mma_kernel``: bf16 q, k, v with D in
  ``MMA_HEAD_DIMS`` (64, 128, 192, 256), every row on a 16-byte boundary (each
  ``data_ptr`` a multiple of 16 bytes, the (batch, sequence, head) strides
  multiples of 8 elements). Both products on the tensor cores, P split
  into bf16 hi and lo so that the result keeps the fp32 P's precision.
  Every prefill and training forward of the archs the port serves and
  trains takes it: D = 192 is MLA's prefill (DeepSeek's qk_nope 128 +
  qk_rope 64, V zero-padded to 192).
- ``"scalar"``, ``flash_fwd_kernel``: everything else, fp32 at any D up to
  256 (the fp32 card-vs-CPU checks need it: no bf16 or TF32 tensor-core
  path meets their 1e-5), bf16 at other D or on unaligned views.

A route that fails to build or launch raises; neither falls back to the
other. ``flash_attention.launches`` counts the launches of both kernels,
``flash_attention.tc_launches`` those of the tensor-core one.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.grad_guard import refuse_grad
from repro_torch.models.attention_core import blocked_attention

MAX_HEAD_DIM = 256   # csrc/flash_attention.cu's kMaxD
MMA_HEAD_DIMS = (64, 128, 192, 256)   # the tensor-core kernel's head dims
BLOCK = 128          # the reference kernel's default block_q and block_k
_NO_GRAD = ("Its differentiable entry point is ops.mha_flash_train (the autograd.Function "
            "ops.FlashAttention).")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("flash_attention")
    args = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.flash_attention_f32, lib.flash_attention_bf16, lib.flash_attention_bf16_mma):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
    lib.flash_attention_mma_smem_bytes.argtypes = [ctypes.c_int]
    lib.flash_attention_mma_smem_bytes.restype = ctypes.c_longlong
    for fn in (lib.flash_attention_mma_threads, lib.flash_attention_mma_blocks_per_sm):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_ref(q, k, v, *, causal=True, window=0, return_lse=False):
    """Plain version in the model layout: the tiled online softmax of
    ``blocked_attention`` with the reference kernel's 128 x 128 tiles."""
    return blocked_attention(q, k, v, causal=causal, window=window,
                             q_chunk=BLOCK, k_chunk=BLOCK, return_lse=return_lse)


def _model_layout(q, k, v):
    if q.ndim == 3 and k.ndim == 3 and v.ndim == 3:
        return q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), True
    if q.ndim == 4 and k.ndim == 4 and v.ndim == 4:
        return q, k, v, False
    raise ValueError(
        "flash_attention takes q, k, v all (BH, S, D) or all (B, S, heads, D); "
        f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
    )


def _check(q, k, v):
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"k and v must be (B, Sk, K, D) = (B={B}, Sk, K, D={D}); got k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {k.shape[2]}")
    if k.shape[1] < 1:
        raise ValueError("flash_attention needs at least one key")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"q, k, v must share one dtype, float32 or bfloat16; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def _route(q, k, v) -> str:
    """``"mma"`` when the tensor-core kernel takes q, k, v (model layout,
    4-D): bf16, D in ``MMA_HEAD_DIMS``, and every row on a 16-byte boundary,
    so that each thread's 16-byte ``cp.async`` copies whole aligned chunks:
    each ``data_ptr`` a multiple of 16 bytes and each (batch, sequence, head)
    stride a multiple of 8 elements. ``"scalar"`` for everything else. It
    reads dtypes, shapes, strides and pointers only, on any device."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in MMA_HEAD_DIMS:
        return "scalar"
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            return "scalar"
    return "mma"


def flash_attention(q, k, v, *, causal=True, window=0, return_lse=False):
    """Attention of q over k, v in either layout above; the output has q's
    shape and dtype. With ``return_lse`` also the fp32 log-sum-exp of each
    query row's scaled scores, (B, Sq, H) (or (BH, Sq) in the single-head
    layout), which the training backward needs.

    ``flash_attention.launches`` counts kernel launches, of either route;
    ``flash_attention.tc_launches`` those of the tensor-core route (CPU
    calls and empty outputs launch nothing and count nothing, and neither does a
    call under a CUDA stream capture, which only records the launch)."""
    q4, k4, v4, single = _model_layout(q, k, v)
    _check(q4, k4, v4)

    def result(out, lse):
        if single:
            out = out.squeeze(2)
            lse = None if lse is None else lse.squeeze(2)
        return (out, lse) if return_lse else out

    if q.device.type == "cpu":
        res = flash_attention_ref(q4, k4, v4, causal=causal, window=window,
                                  return_lse=return_lse)
        return result(*res) if return_lse else result(res, None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    refuse_grad("flash_attention", (q, k, v), _NO_GRAD)
    B, Sq, H, D = q4.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA flash_attention takes head_dim up to {MAX_HEAD_DIM}, got {D}")
    if B * H > 65535:
        raise ValueError(f"the CUDA flash_attention takes B * H up to 65535, got {B * H}")
    if any(t.stride(-1) != 1 for t in (q4, k4, v4)):
        raise ValueError("flash_attention needs q, k, v with a contiguous last axis")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return result(*_launch(q4, k4, v4, causal, window, return_lse, _route(q4, k4, v4)))


def _launch(q4, k4, v4, causal, window, return_lse, route):
    """One launch of ``route``'s kernel on model-layout CUDA tensors that
    :func:`flash_attention` has checked; (out, lse or None). Module-private:
    ``chip_smoke.py`` times the scalar route through it at shapes the
    tensor-core route takes."""
    if route not in ("mma", "scalar") or (route == "mma" and _route(q4, k4, v4) != "mma"):
        raise ValueError(f"route {route!r} does not take these inputs")
    B, Sq, H, D = q4.shape
    out = torch.empty((B, Sq, H, D), dtype=q4.dtype, device=q4.device)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q4.device) if return_lse else None
    if Sq == 0:
        return out, lse
    strides = (ctypes.c_longlong * 12)(*(s for t in (q4, k4, v4, out) for s in t.stride()[:3]))
    lib = _lib()
    if route == "mma":
        fn = lib.flash_attention_bf16_mma
    else:
        fn = lib.flash_attention_f32 if q4.dtype == torch.float32 else lib.flash_attention_bf16
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    rc = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, k4.shape[2],
            Sq, k4.shape[1], D, strides, int(bool(causal)), int(window), stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention {route} kernel launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
        flash_attention.launches += 1
        if route == "mma":
            flash_attention.tc_launches += 1
    return out, lse


flash_attention.launches = 0
flash_attention.tc_launches = 0


def smem_bytes(head_dim: int, dtype: torch.dtype, route: str = "scalar") -> int:
    """Dynamic shared memory one block of ``route``'s kernel takes."""
    if route == "mma":
        return int(_lib().flash_attention_mma_smem_bytes(head_dim))
    return int(_lib().flash_attention_smem_bytes(head_dim, 2 if dtype == torch.bfloat16 else 4))


def mma_occupancy(head_dim: int) -> dict:
    """The tensor-core kernel at ``head_dim``: threads and dynamic shared
    memory a block, and the blocks an SM holds (CUDA's occupancy query)."""
    lib = _lib()
    blocks = int(lib.flash_attention_mma_blocks_per_sm(head_dim))
    if blocks < 0:
        raise RuntimeError(f"occupancy query failed: "
                           f"{lib.flash_attention_error_string(-blocks).decode()}")
    return {"threads": int(lib.flash_attention_mma_threads(head_dim)),
            "smem_bytes": int(lib.flash_attention_mma_smem_bytes(head_dim)),
            "blocks_per_sm": blocks}
