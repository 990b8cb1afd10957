"""The CUDA fused_cross_entropy's route choice, the CE gradient's
probabilities (``ce_probs``) and the backward built on them, on the CPU.

The tensor-core kernels (``csrc/ce_loss.cu``: ``ce_fwd_mma_kernel``,
``ce_probs_mma_kernel``) run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``). What is tested here: which inputs :func:`_route` sends
to them (it reads dtypes, shapes, strides and pointers only); the split
plan at their 256-column vocab tile; ``ce_probs_ref`` against the
reference's cotangent of the logits (``jax.vjp`` of the cast in
``(h @ w).astype(f32)``, under the softmax cotangent of the CE); the bf16
gradient of ``ops.ce_loss_mean`` against ``jax.grad`` of
``chunked_cross_entropy`` in bf16 and against an fp64 oracle; and the fp32
backward bit for bit against the plain backward it replaced."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.kernels import ce_loss as ce  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def _views(view, dtype, T=24, d=64, V=296):
    """(hidden, head) as a caller hands them over."""
    hidden = torch.zeros((T, d), dtype=dtype)
    if view == "tied":            # the (V, d) table viewed as (d, V): Gemma-2B's head
        return hidden, torch.zeros((V, d), dtype=dtype).T
    if view == "contiguous":      # a (d, V) head, V a multiple of 8
        return hidden, torch.zeros((d, V), dtype=dtype)
    if view == "sliced":          # the first V - 3 columns of a (d, V + 8) head
        return hidden, torch.zeros((d, V + 8), dtype=dtype)[:, :V - 3]
    if view == "hidden_slice":    # hidden as a column slice of a (T, 2d) buffer
        return torch.zeros((T, 2 * d), dtype=dtype)[:, :d], torch.zeros((V, d), dtype=dtype).T
    if view == "d12":             # d not a multiple of 8
        return torch.zeros((T, 12), dtype=dtype), torch.zeros((V, 12), dtype=dtype).T
    if view == "offset":          # hidden one element into its storage
        return (torch.zeros(T * d + 1, dtype=dtype)[1:].view(T, d),
                torch.zeros((V, d), dtype=dtype).T)
    if view == "head_offset":     # the head one element into its storage
        return hidden, torch.zeros(V * d + 1, dtype=dtype)[1:].view(V, d).T
    if view == "pitch":           # a contiguous (d, V + 1) head: rows V + 1 apart
        return hidden, torch.zeros((d, V + 1), dtype=dtype)
    if view == "hidden_pitch":    # hidden rows d + 4 apart
        return torch.zeros((T, d + 4), dtype=dtype)[:, :d], torch.zeros((d, V), dtype=dtype)
    if view == "strided_head":    # every other column: no unit stride
        return hidden, torch.zeros((d, 2 * V), dtype=dtype)[:, ::2]
    raise ValueError(view)


ALIGNED = ("tied", "contiguous", "sliced", "hidden_slice")


@pytest.mark.parametrize("view", ALIGNED + ("d12", "offset", "head_offset", "pitch",
                                            "hidden_pitch", "strided_head"))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_takes_aligned_bf16(view, dtype):
    hidden, head = _views(view, dtype)
    want = "mma" if dtype == torch.bfloat16 and view in ALIGNED else "scalar"
    assert ce._route(hidden, head) == want


def test_launch_refuses_a_route_that_does_not_take_the_inputs_before_any_build():
    """The private launcher checks the route before it loads the library, so
    a wrong route raises here, where there is no nvcc."""
    labels = torch.zeros(24, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not take"):
        ce._launch(*_views("offset", torch.bfloat16), labels, "mma")
    with pytest.raises(ValueError, match="does not take"):
        ce._launch(*_views("tied", torch.float32), labels, "mma")
    with pytest.raises(ValueError, match="does not take"):
        ce._launch(*_views("tied", torch.bfloat16), labels, "wgmma")


@pytest.mark.parametrize("T,V,slots", [(4096, 256_000, 132), (8192, 256_000, 132),
                                       (1024, 256_000, 132), (1, 256_000, 132),
                                       (37, 1000, 132), (4096, 1, 132), (300, 2049, 264)])
def test_split_plan_at_the_tensor_core_tile(T, V, slots):
    """At the tensor-core kernel's 256-column vocab tile (one block an SM):
    every split has vocab tiles and together they cover the vocab; the plan
    takes within 1% of the fewest (waves x tiles a split) of any split
    count."""
    n_tt, n_vt = -(-T // ce.TILE), -(-V // ce.MMA_TILE_V)
    splits, per = ce.split_plan(T, V, slots, ce.MMA_TILE_V)
    assert splits * per >= n_vt > (splits - 1) * per

    def steps(s, p):
        return -(-(n_tt * s) // slots) * p

    best = min(steps(-(-n_vt // -(-n_vt // w)), -(-n_vt // w)) for w in range(1, n_vt + 1))
    assert steps(splits, per) <= 1.01 * best


# ---------------------------------------------------------------------------
# ce_probs: the logits' cotangent
# ---------------------------------------------------------------------------

def _case(rng, T, d, V, scale=0.3, out_of_range=True):
    hidden = rng.normal(size=(T, d)).astype(np.float32)
    table = (rng.normal(size=(V, d)) * scale).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    labels[0], labels[-1] = 0, V - 1
    if out_of_range and T > 3:
        labels[1], labels[2] = -1, V
    g = (rng.uniform(0.5, 1.5, T) / T).astype(np.float32)
    return hidden, table, labels, g


def _ref_cotangent(h, w, labels, g):
    """The reference's cotangent of the logits as its matmul receives it:
    the softmax cotangent of sum_t g_t (logsumexp - gold) at the fp32
    logits, through ``jax.vjp`` of the cast in ``(h @ w).astype(f32)``
    (which brings it back to the matmul's dtype)."""
    logits, cast_vjp = jax.vjp(lambda x: x.astype(jnp.float32), h @ w)

    def ce_sum(lg):
        gold = jnp.take_along_axis(lg, jnp.asarray(labels)[:, None], axis=-1)[:, 0]
        return jnp.sum(jnp.asarray(g) * (jax.nn.logsumexp(lg, axis=-1) - gold))

    (ct,) = cast_vjp(jax.grad(ce_sum)(logits))
    return np.asarray(ct.astype(jnp.float32))


@pytest.mark.parametrize("T,V", [(1, 1), (13, 40), (37, 300), (24, 4100)])
@pytest.mark.parametrize("tied", [False, True])
def test_ce_probs_ref_matches_the_reference_cotangent_in_fp32(rng, T, V, tied):
    """fp32: the same function, so within 1e-6 of |g| (exp and logsumexp in
    other orders); the head is a (d, V) tensor or the view of a table."""
    hidden, table, labels, g = _case(rng, T, 16, V, out_of_range=False)
    want = _ref_cotangent(jnp.asarray(hidden), jnp.asarray(table.T), labels, g)
    head = _t(table).T if tied else _t(table.T)
    lbl = torch.from_numpy(labels)
    _, lse = ce.fused_cross_entropy_ref(_t(hidden), head, lbl)
    got = ce.ce_probs_ref(_t(hidden), head, lbl, lse, torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (T, V)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * float(g.max()))
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(ce.ce_probs(_t(hidden), head, lbl, lse, torch.from_numpy(g)), got)


# bf16: the reference rounds the logits to bf16 before its cast to fp32
# (at most 2^-8 of |logit|), ours are the exact fp32 sums of the bf16
# products; each side rounds the cotangent to bf16 once. So the allowance at
# an element is one bf16 ulp of the reference's value, plus |g| p times the
# logit rounding in the element's own logit and in lse, 2^-8 (|S| + max |S|).
# Measured on these cases (seed 0): at most 0.48 of it.
def _bf16_allowance(want, p, s, g):
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    logit = 2.0 ** -8 * (np.abs(s) + np.abs(s).max(axis=-1, keepdims=True))
    return ulp + np.abs(g)[:, None] * p * logit


@pytest.mark.parametrize("T,V", [(13, 40), (37, 300), (24, 4100)])
@pytest.mark.parametrize("tied", [False, True])
def test_ce_probs_ref_matches_the_reference_cotangent_in_bf16(rng, T, V, tied):
    hidden, table, labels, g = _case(rng, T, 32, V, out_of_range=False)
    h_j = jnp.asarray(hidden).astype(jnp.bfloat16)
    w_j = jnp.asarray(table.T).astype(jnp.bfloat16)
    want = _ref_cotangent(h_j, w_j, labels, g)
    h_t = _t(hidden, torch.bfloat16)
    head = _t(table, torch.bfloat16).T if tied else _t(table.T, torch.bfloat16)
    lbl = torch.from_numpy(labels)
    _, lse = ce.fused_cross_entropy_ref(h_t, head, lbl)
    got = ce.ce_probs_ref(h_t, head, lbl, lse, torch.from_numpy(g))
    assert got.dtype == torch.bfloat16 and got.shape == (T, V)
    s = (h_t.double() @ head.double()).numpy()
    p = np.exp(s - lse.double().numpy()[:, None])
    err = np.abs(got.float().numpy() - want)
    assert (err <= _bf16_allowance(want, p, s, g)).all(), float(
        (err / _bf16_allowance(want, p, s, g)).max())


def test_ce_probs_checks_its_inputs_on_the_cpu():
    hidden, head = _views("tied", torch.bfloat16)
    labels = torch.zeros(24, dtype=torch.int32)
    lse, g = torch.zeros(24), torch.ones(24)
    with pytest.raises(ValueError, match="lse"):
        ce.ce_probs(hidden, head, labels, lse.bfloat16(), g)
    with pytest.raises(ValueError, match="g as"):
        ce.ce_probs(hidden, head, labels, lse, g[:23])
    with pytest.raises(TypeError, match="int32"):
        ce.ce_probs(hidden, head, labels.long(), lse, g)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

def _plain_backward_before_ce_probs():
    """ops.FusedCrossEntropy's backward as it was before ce_probs (the head
    widened to fp32, fp32 logits and softmax a chunk at a time, the two
    products in fp32): ``chip_smoke.old_plain_ce_backward``, which also
    times the new backward against it on the card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.old_plain_ce_backward


@pytest.mark.parametrize("T,d,V,chunk", [(26, 16, 40, 8), (26, 16, 40, 0), (300, 64, 5000, 128),
                                         (77, 32, 4100, 0), (1, 8, 1, 0)])
@pytest.mark.parametrize("tied", [False, True])
def test_fp32_backward_equals_the_plain_backward_it_replaced(rng, T, d, V, chunk, tied):
    """In fp32 the products stay fp32 and ce_probs_ref tiles the vocab as
    the forward's plain version does: the numbers are the old backward's,
    bit for bit, labels outside [0, V) included."""
    hidden, table, labels, g = _case(rng, T, d, V)
    h = _t(hidden)
    head = _t(table).T if tied else _t(table.T)
    lbl = torch.from_numpy(labels)
    _, lse = ce.fused_cross_entropy_ref(h, head, lbl)
    gt = torch.from_numpy(g)
    got = ops.ce_backward(h, head, lbl, lse, gt, chunk)
    want = _plain_backward_before_ce_probs()(h, head, lbl, lse, gt, chunk or T)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _oracle_grads(h, w, labels):
    """fp64 gradients of the mean CE at the bf16 values (as float arrays)."""
    B, S, d = h.shape
    hh, ww = h.astype(np.float64).reshape(-1, d), w.astype(np.float64)
    lg = hh @ ww
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    p[np.arange(len(p)), labels.reshape(-1)] -= 1
    p /= len(p)
    return (p @ ww.T).reshape(B, S, d), hh.T @ p


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _bf16_grads(rng, B, S, d, V, chunk, scale):
    """(ours, the reference's, the fp64 oracle's) (dhidden, dhead) of the
    mean CE in bf16, each as fp64 arrays; dhead as (d, V)."""
    hidden = rng.normal(size=(B, S, d)).astype(np.float32)
    table = (rng.normal(size=(V, d)) * scale).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    h_j = jnp.asarray(hidden).astype(jnp.bfloat16)
    w_j = jnp.asarray(table.T).astype(jnp.bfloat16)
    ref = jax.grad(lambda h, w: ref_tf.chunked_cross_entropy(h, w, jnp.asarray(labels), chunk),
                   argnums=(0, 1))(h_j, w_j)
    ref = tuple(np.asarray(x.astype(jnp.float32), np.float64) for x in ref)
    h_b = np.array(h_j.astype(jnp.float32))
    w_b = np.array(w_j.astype(jnp.float32))
    h_t = torch.from_numpy(h_b).to(torch.bfloat16).requires_grad_()
    tab = torch.from_numpy(np.ascontiguousarray(w_b.T)).to(torch.bfloat16).requires_grad_()
    loss = ops.ce_loss_mean(h_t, tab.T, torch.from_numpy(labels), chunk=chunk)
    loss.backward()
    assert h_t.grad.dtype == tab.grad.dtype == torch.bfloat16
    ours = (h_t.grad.double().numpy(), tab.grad.double().numpy().T)
    return ours, ref, _oracle_grads(h_b, w_b, labels)


# Measured (seed 0): 2.1e-3 to 3.6e-3 of each gradient's norm apart, at
# logits of std 1.7 (d = 32, head scale 0.3): both sides round the
# cotangent and the result to bf16, and the reference its logits too.
BF16_GRAD_RTOL = 5e-3


@pytest.mark.parametrize("chunk", [0, 8])
def test_bf16_gradient_matches_jax_grad_of_chunked_cross_entropy(rng, chunk):
    ours, ref, _ = _bf16_grads(rng, 2, 24, 32, 300, chunk, 0.3)
    for got, want in zip(ours, ref):
        assert _rel(got, want) <= BF16_GRAD_RTOL


@pytest.mark.parametrize("d,V,scale", [(32, 300, 0.3), (64, 3000, 1.0)])
def test_bf16_gradient_is_no_farther_from_fp64_than_the_reference(rng, d, V, scale):
    """Against fp64 gradients at the same bf16 values, the port's bf16
    gradient is no farther off than the reference's own. At logits of std
    1.7 and 8 (these cases) the reference's bf16 logits cost it 1.1-1.4x and
    3.7-3.9x the port's error (measured, seed 0); where logits are far below 1 both sit at the floor of
    rounding the cotangent and the result to bf16, within noise of each
    other."""
    ours, ref, oracle = _bf16_grads(rng, 2, 24, d, V, 8, scale)
    for got, theirs, want in zip(ours, ref, oracle):
        assert _rel(got, want) <= _rel(theirs, want)
