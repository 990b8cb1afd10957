"""The top-k aggregate's routes and the fused kernel's work split, on the CPU.

The fused kernel (``csrc/sparse_agg.cu::sparse_agg_fused_kernel``) runs only
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``). What is tested
here: what :func:`_route` sends to it (it reads shapes, dtypes and alignment
only, before any build), that the private launcher refuses a route before
any build, and the kernel's work split emulated in numpy -- each block zeroes
a stripe of ``ceil(n / 4 / grid)`` float4s (block 0 also the ``n % 4``
floats past the last one), and each thread walks the items (row, group of
4 pairs) ``tid, tid + T, tid + 2T, ...`` (T the grid's threads) kUnroll at
a time, carrying the row from item to item by subtraction -- and the sum it
computes, each term ``w[c] * float(vals[c, j])`` in fp32 added in the walk's
order, against the reference's Pallas kernel (interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.sparse_agg import sparse_aggregate as ref_sparse  # noqa: E402
from repro_torch.kernels import sparse_agg as sp  # noqa: E402

MAIN_N = (199_210, 1_663_370)   # the 2NN's and the CNN's parameters
TOPK = 0.05                     # specs/mnist_2nn_noniid_topk.json
THREADS, UNROLL = 256, 8        # csrc/sparse_agg.cu's kFusedThreads, kUnroll


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build or load the library fails the test."""
    def refuse():
        raise AssertionError("the route reached the build")
    monkeypatch.setattr(sp, "_lib", refuse)


def _pairs(K, k, dtype=torch.float32, off_idx=0, off_vals=0):
    """Uninitialized (K, k) idx and vals, each a contiguous view ``off_*``
    elements past an aligned base."""
    idx = torch.empty(K * k + off_idx, dtype=torch.int32)[off_idx:].view(K, k)
    vals = torch.empty(K * k + off_vals, dtype=dtype)[off_vals:].view(K, k)
    return idx, vals


def _route(idx, vals, n, off_out=0):
    out = torch.empty(n + off_out)[off_out:]
    return sp._route(idx, vals, out, K=idx.shape[0], k=idx.shape[1])


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", MAIN_N)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_specs_shapes_take_the_fused_route(no_build, n, dtype):
    k = int(n * TOPK)
    assert k % 4 == 0
    idx, vals = _pairs(10, k, dtype)
    assert _route(idx, vals, n) == "fused"


@pytest.mark.parametrize("k", [1, 2, 3, 5, 25, 250, 9961])
def test_k_not_a_multiple_of_4_takes_the_scatter_route(no_build, k):
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, 10, 17):
            idx, vals = _pairs(K, k, dtype)
            assert _route(idx, vals, 1000) == "scatter"


@pytest.mark.parametrize("what,dtype,off_idx,off_vals,off_out", [
    ("idx", torch.float32, 1, 0, 0),
    ("fp32 vals", torch.float32, 0, 1, 0),
    ("bf16 vals", torch.bfloat16, 0, 1, 0),
    ("bf16 vals 4 bytes off", torch.bfloat16, 0, 2, 0),
    ("out", torch.float32, 0, 0, 1),
])
def test_a_misaligned_view_takes_the_scatter_route(no_build, what, dtype, off_idx, off_vals,
                                                   off_out):
    idx, vals = _pairs(10, 9960, dtype, off_idx, off_vals)
    assert _route(idx, vals, 199_210, off_out) == "scatter", what


def test_bf16_values_need_only_8_byte_alignment(no_build):
    idx, vals = _pairs(10, 9960, torch.bfloat16, off_vals=4)   # 8 bytes past 16
    assert vals.data_ptr() % 16 == 8
    assert _route(idx, vals, 199_210) == "fused"


def test_the_route_is_total_and_fused_rows_are_whole_loads(no_build):
    """Every input the wrapper takes gets one of the two routes; a call the
    fused route takes has every row start on a 16-byte load of indices and
    a 4-value load of values, and an aligned output."""
    seen = set()
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, 3, 10):
            for k in (1, 2, 3, 4, 5, 8, 12, 30, 9960):
                for off_idx in (0, 1, 2, 3, 4):
                    for off_vals in (0, 1, 2, 3, 4):
                        for off_out in (0, 1, 4):
                            idx, vals = _pairs(K, k, dtype, off_idx, off_vals)
                            route = _route(idx, vals, 64, off_out)
                            assert route in sp.ROUTES
                            seen.add(route)
                            if route == "fused":
                                rows = [c * k for c in range(K)]
                                assert all((idx.data_ptr() + 4 * r) % 16 == 0 for r in rows)
                                vb = 4 * vals.element_size()
                                assert all((vals.data_ptr() + r * vals.element_size()) % vb == 0
                                           for r in rows)
                                assert off_out % 4 == 0
    assert seen == set(sp.ROUTES)


def test_private_launcher_refuses_unknown_and_inapplicable_routes(no_build):
    idx, vals = _pairs(3, 5)
    w = torch.full((3,), 1 / 3)
    out = torch.empty(64)
    with pytest.raises(ValueError, match="no route 'tma'"):
        sp._launch(idx, vals, w, out, "tma")
    with pytest.raises(ValueError, match="fused route does not take"):
        sp._launch(idx, vals, w, out, "fused")
    idx, vals = _pairs(3, 8, off_idx=1)
    with pytest.raises(ValueError, match="fused route does not take"):
        sp._launch(idx, vals, w, out, "fused")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_call_takes_the_plain_version_and_counts_nothing(no_build, dtype):
    idx, vals, w = _case(np.random.default_rng(3), 4, 8, 100, dtype)
    before = (sp.sparse_aggregate.launches, sp.sparse_aggregate.fused_launches)
    got = sp.sparse_aggregate(idx, vals, w, 100)
    assert torch.equal(got, sp.sparse_aggregate_ref(idx, vals, w, 100))
    assert (sp.sparse_aggregate.launches, sp.sparse_aggregate.fused_launches) == before


# ---------------------------------------------------------------------------
# the fused kernel's work split, emulated
# ---------------------------------------------------------------------------

def _stripes(n, grid):
    """How many times the zero phase writes each of the n floats."""
    n4 = n >> 2
    stripe = (n4 + grid - 1) // grid          # fused_geom's stripe
    hits = np.zeros(n, np.int64)
    for b in range(grid):
        z0, z1 = b * stripe, min(b * stripe + stripe, n4)
        # thread t stores float4s z0 + t, z0 + t + THREADS, ...: together [z0, z1)
        i = (z0 + np.arange(THREADS)[:, None] + THREADS * np.arange(
            max(z1 - z0, 0) // THREADS + 1)[None, :]).ravel()
        i = i[i < z1]
        np.add.at(hits, (4 * i[:, None] + np.arange(4)).ravel(), 1)
    hits[4 * n4: n] += 1                      # block 0, threads < n % 4
    return hits


def _walk(K, k, grid):
    """The scatter phase's visits, every thread in step: a list of (tid,
    visit number, row, group) arrays in the order the kernel issues them
    (kUnroll items, then their REDs)."""
    groups, step = k >> 2, grid * THREADS
    tid = np.arange(step, dtype=np.int64)
    c = np.zeros(step, np.int64)
    g = tid.copy()

    def settle():                             # settle(): subtract, never divide
        while True:
            m = (c < K) & (g >= groups)
            if not m.any():
                return
            g[m] -= groups
            c[m] += 1

    settle()
    visits, j = [], np.zeros(step, np.int64)
    while (c < K).any():                      # while (c < K), each thread in step
        for _ in range(UNROLL):
            has = c < K
            visits.append((tid[has], j[has], c[has].copy(), g[has].copy()))
            j[has] += 1
            g += step
            settle()
    return visits


@pytest.mark.parametrize("grid", [1, 7, 1056])
@pytest.mark.parametrize("k,n", [(4, 83), (9960, 199_210), (83_168, 1_663_370)])
@pytest.mark.parametrize("K", [1, 10, 17])
def test_fused_work_split_covers_everything_once(K, k, n, grid):
    groups = k >> 2
    assert np.array_equal(_stripes(n, grid), np.ones(n, np.int64))
    visits = _walk(K, k, grid)
    tid, j, c, g = (np.concatenate(a) for a in zip(*visits))
    t = tid + j * grid * THREADS               # the item's place in row-major order
    # every (row, group of 4 pairs) exactly once
    assert np.array_equal(np.sort(t), np.arange(K * groups))
    # the division-free row and group are the divisions'
    assert np.array_equal(c, t // groups) and np.array_equal(g, t % groups)
    # and the row of each of the item's pairs is the pair's flat index // k
    pairs = 4 * t[:, None] + np.arange(4)
    assert np.array_equal(np.broadcast_to(c[:, None], pairs.shape), pairs // k)


# ---------------------------------------------------------------------------
# the fused kernel's sum, emulated, against the reference's Pallas kernel
# ---------------------------------------------------------------------------

def _bf16(x):
    """fp32 -> the nearest bf16 (round to nearest even), as fp32."""
    b = x.astype(np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def _case(rng, K, k, n, dtype, *, ghosts=0, duplicates=False, out_of_range=0):
    """(idx, vals, w) torch tensors: per-client distinct indices (with
    replacement where ``duplicates``), ``out_of_range`` indices >= n in row
    0, ghosts' values 1e4 at weight 0."""
    if duplicates:
        idx = rng.integers(0, n, (K, k))
    else:
        idx = np.stack([rng.permutation(n)[:k] for _ in range(K)])
    idx = idx.astype(np.int32)
    idx[0, :out_of_range] = n + np.arange(out_of_range)
    vals = rng.normal(size=(K, k)).astype(np.float32)
    w = rng.uniform(0.1, 5.0, K).astype(np.float32)
    if ghosts:
        vals[K - ghosts:] = 1e4
        w[K - ghosts:] = 0.0
    w /= w.sum()
    if dtype == torch.bfloat16:
        vals = _bf16(vals)
    return (torch.from_numpy(idx), torch.from_numpy(vals).to(dtype), torch.from_numpy(w))


def _emulate(idx, vals, w, n, grid):
    """sparse_agg_fused_kernel's output: zeros, then each term w[c] *
    vals[c, j] in fp32 added in fp32 in the walk's order, indices outside
    [0, n) dropped."""
    K, k = idx.shape
    out = np.full(n, np.nan, np.float32)
    out[_stripes(n, grid) == 1] = 0.0
    for _, _, c, g in _walk(K, k, grid):
        for q in range(4):
            col = 4 * g + q
            i = idx[c, col]
            term = (w[c] * vals[c, col]).astype(np.float32)
            keep = (i >= 0) & (i < n)
            np.add.at(out, i[keep], term[keep])
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,k,n,ghosts,duplicates,out_of_range", [
    (1, 4, 83, 0, False, 0),
    (10, 48, 1000, 0, False, 0),
    (10, 48, 1000, 3, False, 0),
    (17, 64, 500, 4, True, 0),
    (10, 48, 1000, 2, True, 5),
])
def test_fused_sum_matches_the_reference_kernel(dtype, K, k, n, ghosts, duplicates,
                                                out_of_range):
    """1e-6 of the largest term, as the card holds the kernel against the
    plain version; the reference runs its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(K * 1000 + k + ghosts + out_of_range + duplicates)
    idx, vals, w = _case(rng, K, k, n, dtype, ghosts=ghosts, duplicates=duplicates,
                         out_of_range=out_of_range)
    v32 = vals.float().numpy()
    got = _emulate(idx.numpy(), v32, w.numpy(), n, grid=2)
    want = np.asarray(ref_sparse(jnp.asarray(idx.numpy()), jnp.asarray(v32),
                                 jnp.asarray(w.numpy()), n, interpret=True))
    plain = sp.sparse_aggregate_ref(idx, vals, w, n).numpy()
    tol = 1e-6 * float(np.abs(v32[: K - ghosts]).max())
    assert got.shape == (n,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, plain, rtol=0, atol=tol)


def test_fused_sum_drops_negative_indices_as_the_plain_version_does():
    """The reference's ``.at[]`` wraps a negative index to n - 1; the port's
    kernels and plain version drop it, as every index outside [0, n)."""
    rng = np.random.default_rng(11)
    idx, vals, w = _case(rng, 3, 8, 40, torch.float32)
    idx[0, :2] = torch.tensor([-1, -7], dtype=torch.int32)
    got = _emulate(idx.numpy(), vals.numpy(), w.numpy(), 40, grid=1)
    plain = sp.sparse_aggregate_ref(idx, vals, w, 40).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6 * float(vals.abs().max()))
