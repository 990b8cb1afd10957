"""The CUDA gossip_mix's route choice and the dense route's numerics, on the
CPU.

The dense kernel (``csrc/gossip_mix.cu::gossip_mix_dense_kernel``) runs only
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``). What is tested
here: which plans :func:`_route` sends to it (it reads shapes only, before
any build), and that its arithmetic -- W built from the padded slots, each
row's slots added in slot order, then ``W @ X`` as fp32 sums over the nodes
in the kernel's K-panel order -- equals the reference's one-hot matrix and
meets 1e-5 against the reference's Pallas kernel (interpret mode)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.gossip_mix import gossip_mix as ref_mix  # noqa: E402
from repro.kernels.gossip_mix import gossip_mix_ref as ref_mix_oracle  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.kernels import gossip_mix as gm  # noqa: E402

PANEL = 128   # csrc/gossip_mix.cu's kDensePanel: nodes of a K panel and an M chunk


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


KINDS = {"ring": topology.RingTopology(degree=2),
         "smallworld": topology.SmallWorldTopology(degree=4, rewire=0.2, seed=0),
         "full": topology.FullTopology()}
MIN_NODES = {"ring": 3, "smallworld": 5, "full": 1, "padded": 3}   # the ring pads


@functools.cache
def _topology_plan(kind, n):
    return KINDS[kind].build(n)


def _plan(kind, n, seed=0):
    """(idx, weight) of a topology's plan, or of a plan with duplicate ids,
    ids outside [0, n), or dead padded slots; every row sums to 1."""
    if kind in KINDS:
        p = _topology_plan(kind, n)
        return p.idx, p.weight
    r = np.random.default_rng(seed)
    if kind == "padded":
        idx, w = _plan("ring", n)
        idx = np.concatenate([idx, np.tile(np.arange(n, dtype=np.int32)[:, None], (1, 3))], 1)
        return idx, np.concatenate([w, np.zeros((n, 3), np.float32)], 1)
    idx = r.integers(0, n, (n, 6)).astype(np.int32)
    if kind == "duplicates":
        idx[:, 1] = idx[:, 0]
    else:   # out of range: -1, n and a large id on every row
        idx[:, :3] = np.array([-1, n, 10 * n + 3], np.int32)
    w = r.uniform(0.1, 1.0, idx.shape)
    return idx, (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build or load the library fails the test."""
    def refuse():
        raise AssertionError("the route reached the build")
    monkeypatch.setattr(gm, "_lib", refuse)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,n", [(k, n) for k in ("ring", "smallworld", "full")
                                    for n in (2, 3, 17, 100, 1024) if n >= MIN_NODES[k]])
def test_route_sends_the_full_graph_dense_and_sparse_plans_to_gather(no_build, kind, n):
    idx, w = _plan(kind, n)
    route = gm._route(torch.zeros((n, 7)), torch.from_numpy(idx), torch.from_numpy(w))
    D = idx.shape[1]
    assert route == ("dense" if D * gm.DENSE_NODES_PER_SLOT >= n else "gather")
    if kind == "full":
        assert route == "dense"
    if n == 100 and kind in ("ring", "smallworld"):
        assert route == "gather"


@pytest.mark.parametrize("view", ["contiguous", "misaligned", "meta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 33, 199_210])
def test_route_reads_the_plan_shape_only(no_build, view, dtype, N):
    """Neither the dtype, N, nor a view one element off alignment moves the
    route: both kernels take every input the wrapper takes."""
    n = 100
    if view == "misaligned":
        x = torch.zeros(n * N + 1, dtype=dtype)[1:].view(n, N)
    else:
        x = torch.zeros((n, N), dtype=dtype, device="meta" if view == "meta" else "cpu")
    for kind, want in (("ring", "gather"), ("smallworld", "gather"), ("full", "dense")):
        idx, w = _plan(kind, n)
        assert gm._route(x, torch.from_numpy(idx), torch.from_numpy(w)) == want


def test_route_is_total_over_what_the_wrapper_takes(no_build):
    """Every (n, D) the wrapper takes goes to one route, dense exactly from
    the crossover on."""
    for n in (1, 2, 5, 64, 100, 127, 128, 129, 500, gm.MAX_NODES):
        x = torch.zeros((n, 1), device="meta")
        routes = [gm._route(x, torch.zeros((n, D), dtype=torch.int32, device="meta"), None)
                  for D in range(1, n + 4)]
        assert set(routes) <= {"gather", "dense"}
        first = routes.index("dense")
        assert all(r == "gather" for r in routes[:first])
        assert all(r == "dense" for r in routes[first:])
        assert first + 1 == -(-n // gm.DENSE_NODES_PER_SLOT)   # the least D with 5 D >= n


def test_private_launcher_refuses_an_unknown_route_before_any_build(no_build):
    idx, w = _plan("ring", 4)
    with pytest.raises(ValueError, match="no route"):
        gm._launch(torch.zeros((4, 8)), torch.from_numpy(idx), torch.from_numpy(w), "sparse")


def test_cpu_call_takes_the_plain_version_and_counts_nothing(no_build):
    idx, w = _plan("full", 17)
    before = (gm.gossip_mix.launches, gm.gossip_mix.dense_launches)
    out = gm.gossip_mix(torch.ones((17, 5)), torch.from_numpy(idx), torch.from_numpy(w))
    torch.testing.assert_close(out, torch.ones((17, 5)), rtol=0, atol=1e-6)
    assert (gm.gossip_mix.launches, gm.gossip_mix.dense_launches) == before


# ---------------------------------------------------------------------------
# the dense route's arithmetic, emulated
# ---------------------------------------------------------------------------

def _dense_w(idx, w, n):
    """W as the dense kernel builds it: the thread of row i walks its slots
    in order and adds w[i, s] in fp32 at column idx[i, s] when that id lies
    in the K panel being built (ids outside [0, n) lie in none). A row's
    entries do not depend on how the panels cut the node axis, so the
    panels are built here one after another into one matrix."""
    W = np.zeros((n, n), np.float32)
    rows = np.arange(n)
    for k0 in range(0, n, PANEL):
        for s in range(idx.shape[1]):
            j = idx[:, s]
            hit = (j >= k0) & (j < min(k0 + PANEL, n))
            W[rows[hit], j[hit]] = W[rows[hit], j[hit]] + w[hit, s]
    return W


def _dense_mix(W, x):
    """W @ X as the dense kernel sums it: one fp32 accumulator an output,
    the nodes k in increasing order, K panel after K panel (an output tile's
    accumulators carry across its panels)."""
    acc = torch.zeros((W.shape[0], x.shape[1]), dtype=torch.float32)
    Wt, xt = torch.from_numpy(W), x.float()
    for k in range(W.shape[0]):
        acc += Wt[:, k:k + 1] * xt[k]
    return acc.to(x.dtype)


@pytest.mark.parametrize("kind", ["ring", "smallworld", "full", "duplicates", "out_of_range",
                                  "padded"])
@pytest.mark.parametrize("n", [17, 100, 130])
def test_dense_w_in_slot_order_is_the_reference_one_hot_matrix(kind, n):
    """W @ I through the reference's dense oracle is its one-hot W exactly."""
    idx, w = _plan(kind, n, seed=n)
    W = _dense_w(idx, w, n)
    W_ref = np.asarray(ref_mix_oracle(jnp.eye(n, dtype=jnp.float32), jnp.asarray(idx),
                                      jnp.asarray(w)))
    np.testing.assert_allclose(W, W_ref, rtol=0, atol=2.0 ** -24)
    if kind in ("ring", "smallworld", "full"):
        np.testing.assert_array_equal(W, _plan_dense(kind, n))


def _plan_dense(kind, n):
    return _topology_plan(kind, n).dense()


def test_dense_w_at_the_largest_plan_the_kernel_takes():
    """The full graph at MAX_NODES: 8 x 8 panels of 128 nodes."""
    n = gm.MAX_NODES
    idx, w = _plan("full", n)
    np.testing.assert_array_equal(_dense_w(idx, w, n), _plan_dense("full", n))


@pytest.mark.parametrize("kind,n,N", [
    (k, n, N) for k in ("full", "ring", "duplicates", "out_of_range", "padded")
    for n, N in ((2, 33), (17, 4097), (100, 1000), (130, 257)) if n >= MIN_NODES.get(k, 1)])
def test_dense_route_sums_match_the_reference_kernel(rng, kind, n, N):
    idx, w = _plan(kind, n, seed=N)
    x = rng.normal(size=(n, N)).astype(np.float32)
    out = _dense_mix(_dense_w(idx, w, n), torch.from_numpy(x))
    want = ref_mix(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # and the port's plain version, which the card holds the kernel against
    plain = gm.gossip_mix_ref(torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=0, atol=1e-5)


def test_dense_route_sums_in_bf16_storage_round_once(rng):
    """bf16 X: fp32 sums of the bf16 values, one rounding at the store."""
    n, N = 100, 515
    idx, w = _plan("full", n)
    x = torch.from_numpy(rng.normal(size=(n, N)).astype(np.float32)).bfloat16()
    out = _dense_mix(_dense_w(idx, w, n), x)
    want = ref_mix(jnp.asarray(x.float().numpy()), jnp.asarray(idx), jnp.asarray(w),
                   interpret=True)
    assert out.dtype == torch.bfloat16
    ref32 = torch.from_numpy(np.array(want))
    ulp = torch.exp2(torch.floor(torch.log2(ref32.abs().clamp_min(2.0 ** -126))) - 7)
    assert bool(((out.float() - ref32).abs() <= ulp + 1e-5).all())


def test_dense_route_at_the_largest_plan_against_fp64():
    """MAX_NODES nodes, full graph: the k-ordered fp32 sums against W @ X in
    fp64 (2 n roundings of max|x| a side at most)."""
    n, N = gm.MAX_NODES, 33
    idx, w = _plan("full", n)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(n, N)).astype(np.float32))
    out = _dense_mix(_dense_w(idx, w, n), x)
    want = torch.from_numpy(_plan_dense("full", n)).double() @ x.double()
    assert float((out.double() - want).abs().max()) <= 2 * n * 2.0 ** -24 * float(x.abs().max())
