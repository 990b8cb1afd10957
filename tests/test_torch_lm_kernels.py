"""repro_torch's LM kernels' plain versions held against the reference's
Pallas kernels (interpret mode) and oracles, on the same numpy inputs.

On the CPU the wrappers take their plain versions because the tensors lie
on the CPU; the hand-written kernels are held against these plain versions
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``). Tolerances are
the reference's own (``tests/test_kernels.py``): 1e-5 in fp32, 3e-2 for bf16
inputs."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as ref_ssm_scan  # noqa: E402
from repro.models import attention_core as ref_core  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.models import attention_core as core  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,D,bq,bk,causal,window", [
    (16, 8, 8, 8, True, 0),
    (37, 16, 8, 8, True, 0),
    (24, 8, 8, 16, False, 0),
    (33, 8, 16, 8, True, 9),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference_kernel(rng, S, D, bq, bk, causal, window,
                                                       dtype):
    q, k, v = (rng.normal(size=(2, S, D)).astype(np.float32) for _ in range(3))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want_kernel = ref_flash(*(jnp.asarray(a).astype(jd) for a in (q, k, v)), causal=causal,
                            window=window, block_q=bq, block_k=bk, interpret=True)
    want_oracle = ref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                          window=window)
    got = flash_attention(*(_t(a).to(td) for a in (q, k, v)), causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == td
    atol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want_oracle), atol=atol)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want_kernel.astype(jnp.float32)), atol=atol)


@pytest.mark.parametrize("H,K", [(4, 2), (4, 1), (4, 4)])
def test_mha_flash_gqa_matches_naive_attention(rng, H, K):
    B, S, D = 2, 16, 8
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, K, D)).astype(np.float32) for _ in range(2))
    want = ref_core.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    want_ops = ref_ops.mha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=8,
                                 block_k=8, interpret=True)
    got = ops.mha_flash(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ops), atol=1e-5)


@pytest.mark.parametrize("causal,window,q_offset,chunks", [
    (True, 0, 0, (8, 8)), (False, 0, 0, (16, 8)), (True, 5, 0, (8, 16)), (True, 0, 3, (8, 8)),
])
def test_blocked_and_naive_attention_match_reference(rng, causal, window, q_offset, chunks):
    B, Sq, Sk, H, K, D = 2, 21, 24, 4, 2, 8
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, K, D)).astype(np.float32) for _ in range(2))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = ref_core.blocked_attention(jq, jk, jv, **kw, q_chunk=chunks[0], k_chunk=chunks[1])
    got = core.blocked_attention(_t(q), _t(k), _t(v), **kw, q_chunk=chunks[0],
                                 k_chunk=chunks[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(core.naive_attention(_t(q), _t(k), _t(v), **kw).numpy(),
                               np.asarray(ref_core.naive_attention(jq, jk, jv, **kw)), atol=1e-5)


@pytest.mark.parametrize("valid", [1, 7, np.array([3, 12])])
def test_decode_attention_matches_reference(rng, valid):
    B, S, H, K, D = 2, 12, 4, 2, 8
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, K, D)).astype(np.float32) for _ in range(2))
    want = ref_core.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(valid))
    got = core.decode_attention(_t(q), _t(k), _t(v), torch.as_tensor(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_flash_attention_refuses_bad_inputs():
    q = torch.zeros((1, 4, 4, 8))
    with pytest.raises(ValueError, match="multiple of n_kv_heads"):
        flash_attention(q, torch.zeros((1, 4, 3, 8)), torch.zeros((1, 4, 3, 8)))
    with pytest.raises(ValueError, match="all \\(BH, S, D\\)"):
        flash_attention(q[0], q, q)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="k and v"):
        flash_attention(q, q[..., :4], q)


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

def _ssm_inputs(rng, B, T, D, N, h0_scale=0.0):
    dt = np.abs(rng.normal(size=(B, T, D))).astype(np.float32) * 0.1
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, N)).astype(np.float32)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    A = -np.abs(rng.normal(size=(D, N))).astype(np.float32)
    h0 = (rng.normal(size=(B, D, N)) * h0_scale).astype(np.float32)
    return dt, Bm, Cm, x, A, h0


@pytest.mark.parametrize("B,T,D,N,bd", [(1, 8, 4, 2, 4), (2, 24, 8, 4, 4), (1, 16, 16, 8, 8)])
def test_ssm_scan_plain_matches_reference_kernel(rng, B, T, D, N, bd):
    arrs = _ssm_inputs(rng, B, T, D, N)
    j = [jnp.asarray(a) for a in arrs]
    yk, hk = ref_ssm_scan(*j, block_d=bd, interpret=True)
    yr, hr = ref.ssm_scan_ref(*j)
    y, h = ssm_scan(*(_t(a) for a in arrs))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    for got, want in ((y, yk), (y, yr), (h, hk), (h, hr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_ssm_scan_from_a_nonzero_state_and_one_step(rng):
    """Decode's call: T = 1 from the cached state."""
    arrs = _ssm_inputs(rng, 2, 1, 8, 4, h0_scale=1.0)
    yr, hr = ref.ssm_scan_ref(*(jnp.asarray(a) for a in arrs))
    y, h = ssm_scan(*(_t(a) for a in arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=1e-5)


@pytest.mark.parametrize("T,chunk", [(20, 8), (16, 8), (5, 8)])
def test_mamba_ssm_scan_chunked_matches_unchunked(rng, T, chunk):
    """ops.mamba_ssm_scan in chunks == in one piece (the state threads
    through), and == the reference's chunked scan."""
    arrs = _ssm_inputs(rng, 1, T, 4, 2, h0_scale=0.5)
    y1, h1 = ops.mamba_ssm_scan(*(_t(a) for a in arrs), chunk=chunk)
    y2, h2 = ops.mamba_ssm_scan(*(_t(a) for a in arrs))
    yr, hr = ref_ops.mamba_ssm_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                                    interpret=True)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-6)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=1e-6)
    np.testing.assert_allclose(y1.numpy(), np.asarray(yr), atol=1e-5)
    np.testing.assert_allclose(h1.numpy(), np.asarray(hr), atol=1e-5)


def test_ssm_scan_bf16_inputs_give_bf16_y_and_fp32_state(rng):
    arrs = _ssm_inputs(rng, 1, 12, 8, 4)
    j = [jnp.asarray(a) for a in arrs]
    j[3] = j[3].astype(jnp.bfloat16)
    yr, hr = ref.ssm_scan_ref(*j)
    t = [_t(a) for a in arrs]
    t[3] = t[3].bfloat16()
    y, h = ssm_scan(*t)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yr.astype(jnp.float32)), atol=3e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=1e-5)


def test_ssm_scan_refuses_bad_shapes():
    x = torch.zeros((1, 4, 8))
    A, h0, bc = torch.zeros((8, 4)), torch.zeros((1, 8, 4)), torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="want"):
        ssm_scan(x, bc, bc, x, A[:4], h0)
    with pytest.raises(ValueError, match="want"):
        ssm_scan(x, bc, bc, x, A, h0[:, :4])
    with pytest.raises(ValueError, match="ssm_scan needs"):
        ssm_scan(x[0], bc, bc, x, A, h0)
