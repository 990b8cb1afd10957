"""repro_torch's fedavg_aggregate (its plain CPU version) and tree adapters
held against the reference's Pallas kernel in interpret mode.

Inputs are made with numpy and handed to both packages; JAX stays on the
CPU. The CUDA kernel itself is checked on the card (tests/test_torch_gpu.py
and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.fedavg_agg import fedavg_aggregate as ref_aggregate  # noqa: E402
from repro.models.paper import mnist_2nn as ref_2nn, mnist_cnn as ref_cnn  # noqa: E402
from repro.utils import tree as ref_tree  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fedavg_agg import (  # noqa: E402
    fedavg_aggregate,
    fedavg_aggregate_ref,
)
from repro_torch.utils.tree import (  # noqa: E402
    tree_map,
    tree_paths,
    tree_ravel,
    tree_ravel_stacked,
    tree_unravel,
)

torch.set_num_threads(1)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(rng, K, N, dtype, ghosts=0):
    """(K, N) rows and (K,) normalized weights; the last ``ghosts`` rows get
    weight 0 and large values, which must not leak into the sum."""
    x = rng.normal(size=(K, N)).astype(np.float32)
    w = rng.uniform(0.1, 5.0, K).astype(np.float32)
    if ghosts:
        x[-ghosts:] = 1e4
        w[-ghosts:] = 0.0
    w = (w / w.sum()).astype(np.float32)
    jx = jnp.asarray(x).astype(_JNP[dtype])
    tx = torch.from_numpy(x).to(_TORCH[dtype])
    return jx, tx, w


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("K", [1, 2, 17])
@pytest.mark.parametrize("N", [33, 1000, 4097])       # ragged against any block
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_aggregate_matches_reference(rng, K, N, dtype):
    jx, tx, w = _inputs(rng, K, N, dtype)
    want = ref_aggregate(jx, jnp.asarray(w), interpret=True)
    got = fedavg_aggregate(tx, torch.from_numpy(w))
    assert got.dtype == _TORCH[dtype] and got.shape == (N,)
    want32 = _as_np(want)
    # fp32: both accumulate in fp32 over K rows (1e-6). bf16: both
    # accumulate in fp32 and round once at the store, so they may differ by
    # one bf16 ulp where the fp32 sums straddle a rounding boundary.
    atol = 1e-6 if dtype == "float32" else float(np.abs(want32).max()) * 2 ** -8 + 1e-6
    np.testing.assert_allclose(_as_np(got), want32, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_aggregate_zero_weight_ghosts(rng, dtype):
    jx, tx, w = _inputs(rng, 17, 1000, dtype, ghosts=4)
    want = _as_np(ref_aggregate(jx, jnp.asarray(w), interpret=True))
    got = fedavg_aggregate(tx, torch.from_numpy(w))
    real = fedavg_aggregate(tx[:13].contiguous(), torch.from_numpy(w[:13]))
    atol = 1e-6 if dtype == "float32" else float(np.abs(want).max()) * 2 ** -8 + 1e-6
    np.testing.assert_allclose(_as_np(got), want, atol=atol, rtol=0)
    np.testing.assert_array_equal(_as_np(got), _as_np(real))


def test_fedavg_aggregate_rejects_unnormalized_weights(rng):
    x = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="pre-normalized"):
        fedavg_aggregate(x, torch.tensor([1.0, 2.0, 3.0]))
    # the reference refuses the same input
    with pytest.raises(ValueError, match="pre-normalized"):
        ref_aggregate(jnp.asarray(x.numpy()), jnp.asarray([1.0, 2.0, 3.0]),
                      interpret=True)


@pytest.mark.parametrize("stacked,weights,exc", [
    (np.zeros((3, 8), np.float64), np.full(3, 1 / 3, np.float32), TypeError),
    (np.zeros((3, 8), np.float32), np.full(3, 1 / 3, np.float64), TypeError),
    (np.zeros((3, 8), np.float32), np.full(2, 0.5, np.float32), ValueError),
    (np.zeros((8,), np.float32), np.full(1, 1.0, np.float32), ValueError),
    (np.zeros((0, 8), np.float32), np.zeros(0, np.float32), ValueError),
])
def test_fedavg_aggregate_refuses_bad_inputs(stacked, weights, exc):
    with pytest.raises(exc):
        fedavg_aggregate(torch.from_numpy(stacked), torch.from_numpy(weights))


def test_fedavg_aggregate_cpu_launches_no_kernel(rng):
    _, tx, w = _inputs(rng, 3, 64, "float32")
    before = fedavg_aggregate.launches
    fedavg_aggregate(tx, torch.from_numpy(w))
    assert fedavg_aggregate.launches == before


def test_accum_dtype_exposed_fp32_beats_bf16(rng):
    """The plain version keeps the reference's accum_dtype option: bf16
    accumulation over many clients degrades against the fp32 default."""
    K, N = 64, 256
    x = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).bfloat16()
    w = torch.full((K,), 1.0 / K)
    exact = x.double().mean(0).numpy()
    err32 = np.abs(_as_np(fedavg_aggregate(x, w)) - exact).max()
    err16 = np.abs(_as_np(fedavg_aggregate(x, w, accum_dtype=torch.bfloat16)) - exact).max()
    assert err32 < err16
    # the reference shows the same ordering on the same input
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jw = jnp.asarray(w.numpy())
    r32 = np.abs(_as_np(ref_aggregate(jx, jw, interpret=True)) - exact).max()
    r16 = np.abs(_as_np(ref_aggregate(jx, jw, interpret=True,
                                      accum_dtype=jnp.bfloat16)) - exact).max()
    assert r32 <= r16
    np.testing.assert_allclose(err32, r32, atol=2 ** -8)


def test_fedavg_aggregate_ref_is_the_cpu_path(rng):
    _, tx, w = _inputs(rng, 5, 300, "float32")
    tw = torch.from_numpy(w)
    np.testing.assert_array_equal(fedavg_aggregate(tx, tw).numpy(),
                                  fedavg_aggregate_ref(tx, tw).numpy())


# ---------------------------------------------------------------------------
# tree adapters
# ---------------------------------------------------------------------------

def _stacked_numpy(model, K, seed=0):
    trees = [model.init(jax.random.PRNGKey(seed + k)) for k in range(K)]
    return jax.tree.map(lambda *ls: np.stack([np.asarray(l) for l in ls]), *trees)


_MODELS = {
    "2nn": lambda: ref_2nn(n_classes=5, d_in=20),
    "cnn": lambda: ref_cnn(),
}


@pytest.mark.parametrize("name", ["2nn", "cnn"])
@pytest.mark.parametrize("bf16_leaf", [False, True])
def test_tree_fedavg_aggregate_matches_reference(rng, name, bf16_leaf):
    stacked = _stacked_numpy(_MODELS[name](), K=3)
    counts = np.asarray([7.0, 19.0, 4.0], np.float32)       # RAW counts
    jtree = jax.tree.map(jnp.asarray, stacked)
    ttree = tree_map(torch.from_numpy, stacked)
    if bf16_leaf:  # mixed storage: one bf16 leaf round-trips its dtype
        jtree["out"]["w"] = jtree["out"]["w"].astype(jnp.bfloat16)
        ttree["out"]["w"] = ttree["out"]["w"].bfloat16()
    want = ref_ops.tree_fedavg_aggregate(jtree, jnp.asarray(counts), interpret=True)
    got = ops.tree_fedavg_aggregate(ttree, counts)
    assert tree_paths(got) == tree_paths(want)
    for path in tree_paths(want):
        g, r = got, want
        for k in path:
            g, r = g[k], r[k]
        assert str(g.dtype).split(".")[-1] == str(r.dtype)
        atol = 1e-6 if r.dtype == jnp.float32 else 2 ** -8
        np.testing.assert_allclose(_as_np(g), _as_np(r), atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["2nn", "cnn"])
def test_tree_ravel_stacked_order_and_bytes_match_reference(name):
    stacked = _stacked_numpy(_MODELS[name](), K=2)
    want_flat, want_spec = ref_tree.tree_ravel_stacked(
        jax.tree.map(jnp.asarray, stacked))
    flat, spec = tree_ravel_stacked(tree_map(torch.from_numpy, stacked))
    # jax.tree order: keys sorted at every level, not insertion order
    want_paths = [tuple(k.key for k in p)
                  for p, _ in jax.tree_util.tree_flatten_with_path(stacked)[0]]
    assert list(spec.paths) == want_paths
    assert spec.shapes == want_spec.shapes and spec.sizes == want_spec.sizes
    assert flat.numpy().tobytes() == np.asarray(want_flat).tobytes()
    # and each row unravels to the client's own tree
    row = tree_unravel(spec, flat[1])
    for path in spec.paths:
        a, b = row, stacked
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a.numpy(), b[1])


def test_tree_ravel_matches_reference():
    params = jax.tree.map(np.array, ref_cnn().init(jax.random.PRNGKey(3)))
    want, _ = ref_tree.tree_ravel(jax.tree.map(jnp.asarray, params))
    flat, spec = tree_ravel(tree_map(torch.from_numpy, params))
    assert flat.numpy().tobytes() == np.asarray(want).tobytes()
    assert spec.total_size == 1_663_370
    back = tree_unravel(spec, flat)
    assert tree_paths(back) == list(spec.paths)


def test_tree_ravel_stacked_refuses_empty_tree():
    with pytest.raises(ValueError, match="at least one leaf"):
        tree_ravel_stacked({})
