"""The CUDA flash_attention's route choice and the tensor-core route's
numerics, on the CPU.

The tensor-core kernel (``csrc/flash_attention.cu::flash_fwd_mma_kernel``)
runs only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``). What
is tested here: which inputs :func:`_route` sends to it (it reads dtypes,
shapes, strides and pointers only), that its arithmetic -- fp32 scores of
bf16 q and k on its key tiles, an fp32 online softmax in exp2, P split into
bf16 hi and lo for two bf16 products into one fp32 accumulator, one
rounding to bf16 -- meets the card's bf16 allowance against the reference's
Pallas kernel (interpret mode), and that the build's library digest follows
the headers a source includes."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def _views(view, dtype, D, B=2, S=24, H=4, K=2):
    """q, k, v in the model layout as a caller hands them over."""
    if view == "contiguous":
        return (torch.zeros((B, S, n, D), dtype=dtype) for n in (H, K, K))
    if view == "fused":   # column slices of one fused QKV projection
        qkv = torch.zeros((B, S, (H + 2 * K) * D), dtype=dtype)
        return (qkv[..., a * D:b * D].view(B, S, b - a, D)
                for a, b in ((0, H), (H, H + K), (H + K, H + 2 * K)))
    if view == "offset":   # q starts one element into its storage
        flat = torch.zeros(B * S * H * D + 1, dtype=dtype)
        q = flat[1:].view(B, S, H, D)
        return q, torch.zeros((B, S, K, D), dtype=dtype), torch.zeros((B, S, K, D), dtype=dtype)
    if view == "row_pitch":   # rows 4 elements apart beyond their heads
        buf = torch.zeros((B, S, H * D + 4), dtype=dtype)
        q = buf[..., :H * D].view(B, S, H, D)
        return q, torch.zeros((B, S, K, D), dtype=dtype), torch.zeros((B, S, K, D), dtype=dtype)
    if view == "single_head":   # the reference kernel's (BH, S, D) layout
        q, k, v, _ = fa._model_layout(*(torch.zeros((B * H, S, D), dtype=dtype)
                                        for _ in range(3)))
        return q, k, v
    raise ValueError(view)


@pytest.mark.parametrize("view", ["contiguous", "fused", "offset", "row_pitch", "single_head"])
@pytest.mark.parametrize("D", [37, 64, 96, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_takes_aligned_bf16_at_the_tensor_core_head_dims(view, D, dtype):
    q, k, v = _views(view, dtype, D)
    aligned = view in ("contiguous", "fused", "single_head")
    want = "mma" if dtype == torch.bfloat16 and D in (64, 128, 192, 256) and aligned else "scalar"
    assert fa._route(q, k, v) == want


def test_route_refuses_unaligned_inputs_before_any_build():
    """The private launcher checks the route before it loads the library, so
    a wrong route raises here, where there is no nvcc."""
    q, k, v = _views("offset", torch.bfloat16, 64)
    with pytest.raises(ValueError, match="does not take"):
        fa._launch(q, k, v, True, 0, False, "mma")
    with pytest.raises(ValueError, match="does not take"):
        fa._launch(*_views("contiguous", torch.bfloat16, 64), True, 0, False, "wgmma")


# ---------------------------------------------------------------------------
# the tensor-core route's numerics, emulated
# ---------------------------------------------------------------------------

def _emulate_mma(q, k, v, *, causal, window, split=True):
    """flash_fwd_mma_kernel's arithmetic in plain torch: (B, S, H, D) bf16
    q over (B, S, K, D) bf16 k, v, key tiles of 64 (32 at D = 192 and 256). Scores
    are fp32 sums of exact bf16 products, scaled by scale * log2(e) and
    masked with -1e30; m, l and the accumulator are fp32; P goes into the
    product as bf16 hi + bf16 lo (``split``) or rounded once to bf16; the
    output is rounded once."""
    B, Sq, H, D = q.shape
    block_k = 32 if D > 128 else 64
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().permute(0, 2, 1, 3)                                   # (B, H, Sq, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)     # (B, H, Sk, D)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    scale_log2 = torch.tensor(1.4426950408889634 / np.sqrt(D), dtype=torch.float32)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, D))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, Sk))[None, :]
        s = (qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)) * scale_log2
        ok = torch.ones((Sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= qpos >= kpos
        if window:
            ok &= (qpos - kpos) < window
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0:k0 + block_k]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + block_k]
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).bfloat16()


def _allowance_share(out, ref32, v):
    """The card's bf16 allowance (chip_smoke.py's close_to_fp32): one bf16
    ulp of the fp32 result plus 1e-5 * max|v|; the worst share of it."""
    ulp = torch.exp2(torch.floor(torch.log2(ref32.abs().clamp_min(2.0 ** -126))) - 7)
    tol = 1e-5 * float(v.float().abs().max())
    return float(((out.float() - ref32).abs() / (ulp + tol)).max())


def _bf16_case(rng, B, S, H, K, D):
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, K, D)).astype(np.float32) for _ in range(2))
    return tuple(torch.from_numpy(a).bfloat16() for a in (q, k, v))


def _reference32(q, k, v, causal, window):
    """The reference's Pallas kernel in interpret mode, in fp32 on the same
    bf16 values."""
    out = ref_ops.mha_flash(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                            causal=causal, window=window, interpret=True)
    return torch.from_numpy(np.array(out, np.float32))


@pytest.mark.parametrize("mask", ["causal", "full", "window"])
@pytest.mark.parametrize("S,D", [(37, 64), (130, 128), (257, 64), (257, 192), (257, 256)])
def test_split_p_numerics_meet_the_bf16_allowance(rng, S, D, mask):
    q, k, v = _bf16_case(rng, 2, S, 4, 2, D)
    causal, window = mask != "full", 100 if mask == "window" else 0
    ref32 = _reference32(q, k, v, causal, window)
    out = _emulate_mma(q, k, v, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert _allowance_share(out, ref32, v) <= 1.0


def test_p_rounded_once_misses_the_allowance(rng):
    """Why the kernel splits P: the textbook choice, P rounded once to bf16
    for the PV product, misses the same allowance on the same kind of
    inputs, and the split meets it."""
    q, k, v = _bf16_case(rng, 2, 257, 4, 2, 256)
    ref32 = _reference32(q, k, v, False, 0)
    assert _allowance_share(_emulate_mma(q, k, v, causal=False, window=0), ref32, v) <= 1.0
    assert _allowance_share(_emulate_mma(q, k, v, causal=False, window=0, split=False),
                            ref32, v) > 2.0


# ---------------------------------------------------------------------------
# the build's digest
# ---------------------------------------------------------------------------

def _tree(tmp_path):
    (tmp_path / "a.cu").write_text('#include <stdint.h>\n#include "h.cuh"\nint f();\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n  #  include "h2.cuh"\n')
    (tmp_path / "h2.cuh").write_text("#pragma once\n")
    (tmp_path / "other.cuh").write_text("#pragma once\n")
    return tmp_path / "a.cu"


def test_digest_follows_every_included_header(tmp_path):
    src = _tree(tmp_path)
    assert build.included_headers(src) == [tmp_path / "h.cuh", tmp_path / "h2.cuh"]
    before = build.source_digest(src)
    (tmp_path / "other.cuh").write_text("#pragma once\nint g();\n")
    assert build.source_digest(src) == before          # not included
    (tmp_path / "h2.cuh").write_text("#pragma once\nint h();\n")
    after = build.source_digest(src)
    assert after != before                              # included through h.cuh
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "h2.cuh"\n// edited\n')
    assert build.source_digest(src) != after


def test_flash_attention_digest_covers_the_shared_mma_header():
    # the tensor-core flash and CE kernels share the mma header, the dense
    # gossip route, the scan and the quantize stream route the cp.async one;
    # the others include none
    for name in ("flash_attention", "ce_loss"):
        assert build.included_headers(build.CSRC / f"{name}.cu") == [
            build.CSRC / "mma_bf16.cuh"]
    for name in ("gossip_mix", "ssm_scan", "quantized_agg"):
        assert build.included_headers(build.CSRC / f"{name}.cu") == [
            build.CSRC / "async_copy.cuh"]
    for name in ("fedavg_agg", "sparse_agg"):
        assert build.included_headers(build.CSRC / f"{name}.cu") == []
