"""repro_torch's CUDA kernels against their plain versions, on the card.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test here is marked ``gpu`` and skips, with a reason, where there is
no card: whether there is one is decided inside the ``cuda`` fixture, never
at import. The file imports no ``jax``, so it runs where only PyTorch is
installed; the reference comparisons live in the other ``test_torch_*``
files."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fedavg_agg import (  # noqa: E402
    fedavg_aggregate,
    fedavg_aggregate_ref,
)
from repro_torch.kernels.gossip_mix import gossip_mix, gossip_mix_ref  # noqa: E402
from repro_torch.kernels.quantized_agg import (  # noqa: E402
    STREAM_MAX_K,
    _launch,
    _out,
    _route,
    dequantize_ref,
    packed_quantized_aggregate,
    packed_quantized_aggregate_ref,
    quantized_aggregate,
    quantized_aggregate_ref,
)
from repro_torch.kernels import sparse_agg  # noqa: E402
from repro_torch.kernels.sparse_agg import (  # noqa: E402
    sparse_aggregate,
    sparse_aggregate_ref,
)
from repro_torch.utils.bitpack import words_per_chunk  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(cuda, K, N, dtype, seed=0, ghosts=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(K, N)).astype(np.float32)
    w = r.uniform(0.1, 5.0, K).astype(np.float32)
    if ghosts:
        x[-ghosts:] = 1e4
        w[-ghosts:] = 0.0
    w /= w.sum()
    return (torch.from_numpy(x).to(cuda, dtype),
            torch.from_numpy(w).to(cuda))


@pytest.mark.parametrize("K", [1, 2, 10, 17])
@pytest.mark.parametrize("N", [1, 1000, 4097, 199_210])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, K, N, dtype):
    x, w = _case(cuda, K, N, dtype, seed=K * N)
    before = fedavg_aggregate.launches
    out = fedavg_aggregate(x, w)
    torch.cuda.synchronize()
    assert fedavg_aggregate.launches == before + 1
    assert out.dtype == dtype and out.shape == (N,) and out.device.type == "cuda"
    ref32 = fedavg_aggregate_ref(x.float(), w)
    # fp32 sums over K rows in another order (fma): 1e-6 of the input scale
    sum_tol = 1e-6 * float(x.float().abs().max())
    if dtype == torch.float32:
        assert float((out - ref32).abs().max()) <= sum_tol
    else:
        # plus one rounding at the store: one bf16 ulp of the fp32 sum
        ulp = torch.exp2(torch.floor(torch.log2(ref32.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((out.float() - ref32).abs() <= ulp + sum_tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_zero_weight_ghosts_and_misaligned_rows(cuda, dtype):
    x, w = _case(cuda, 17, 4097, dtype, ghosts=4)
    real = fedavg_aggregate(x[:13].contiguous(), w[:13].contiguous())
    assert torch.equal(fedavg_aggregate(x, w), real)
    # a contiguous view one element off 16-byte alignment takes the scalar path
    base = torch.empty(17 * 4097 + 1, device=cuda, dtype=dtype)
    shifted = base[1:].view(17, 4097)
    shifted.copy_(x)
    assert torch.equal(fedavg_aggregate(shifted, w), fedavg_aggregate(x, w))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, w = _case(cuda, 3, 64, torch.float32)
    before = fedavg_aggregate.launches
    with pytest.raises(TypeError):
        fedavg_aggregate(x.double(), w)
    with pytest.raises(TypeError):
        fedavg_aggregate(x.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        fedavg_aggregate(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="weights on"):
        fedavg_aggregate(x, w.cpu())
    with pytest.raises(ValueError, match="float32 only"):
        fedavg_aggregate(x, w, accum_dtype=torch.bfloat16)
    assert fedavg_aggregate.launches == before


def test_round_on_card_matches_round_on_cpu(cuda):
    from repro_torch.core.engine import RoundEngine, RoundState, RoundBatch
    from repro_torch.core.engine import build_simulation_round_step
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.data.synthetic import make_image_classification
    from repro_torch.models import paper
    from repro_torch.utils.tree import tree_map, tree_ravel

    train, _, _ = make_image_classification(36, 1, seed=0)
    clients = [(train.x[a:b], train.y[a:b]) for a, b in ((0, 12), (12, 21), (21, 36))]
    model = paper.mnist_cnn(device=cuda)
    eng = RoundEngine(model.loss, model.init(0), clients,
                      FedAvgConfig(C=0.67, E=1, B=4, lr=0.05, seed=0), device=cuda)
    batch, mask, w = eng.materialize_round_batch(np.asarray([0, 2]), generator_seed=5)
    step = build_simulation_round_step(model.loss)
    start = tree_ravel(tree_map(lambda p: p.cpu().double(), eng.params))[0]
    before = fedavg_aggregate.launches
    # fp32 both sides, sums in other orders: one step's update agrees in L2
    # to 1e-4; over the whole round SGD amplifies the difference (1e-2).
    for n_steps, rtol in ((1, 1e-4), (mask.shape[1], 1e-2)):
        b = tuple(x[:, :n_steps].contiguous() for x in batch)
        msk = mask[:, :n_steps].contiguous()
        got, gm = step(RoundState(eng.params, ()), RoundBatch(b, msk, w, lr=0.05))
        want, wm = step(RoundState(tree_map(lambda p: p.cpu(), eng.params), ()),
                        RoundBatch(tuple(x.cpu() for x in b), msk.cpu(), w, lr=0.05))
        d_card, d_cpu = (tree_ravel(tree_map(lambda p: p.cpu().double(), t))[0] - start
                         for t in (got.params, want.params))
        assert float((d_card - d_cpu).norm()) <= rtol * float(d_cpu.norm())
        assert abs(float(gm["loss"]) - float(wm["loss"])) <= 1e-4 * abs(float(wm["loss"]))
        if n_steps == 1 and rtol > 1e-4:
            d_64, d_64_card = (_star_round_fp64(model.loss, eng.params, b, msk, w, eng.cfg.lr,
                                                dev) - start for dev in ("cpu", cuda))
            for d in (d_card, d_cpu):
                assert float((d - d_64).norm()) <= rtol * float(d_64.norm())
            assert float((d_64_card - d_64).norm()) <= PAPER_FP64_RTOL * float(d_64.norm())
            with torch.backends.cudnn.flags(enabled=False):
                plain, _ = step(RoundState(eng.params, ()), RoundBatch(b, msk, w, lr=eng.cfg.lr))
            d_plain = tree_ravel(tree_map(lambda p: p.cpu().double(), plain.params))[0] - start
            assert float((d_plain - d_64).norm()) <= 1e-4 * float(d_64.norm())
    assert fedavg_aggregate.launches == before + 2
    eng.run(2)
    assert fedavg_aggregate.launches == before + 4


# ---------------------------------------------------------------------------
# the wire kernels: quantized_aggregate, its packed twin, sparse_aggregate
# ---------------------------------------------------------------------------

def _weights(cuda, K, ghosts=0, seed=0):
    w = np.random.default_rng(seed).uniform(0.1, 5.0, K).astype(np.float32)
    if ghosts:
        w[-ghosts:] = 0.0
    return torch.from_numpy(w / w.sum()).to(cuda)


def _ranges(cuda, K, C, seed=0):
    r = np.random.default_rng(seed)
    lo = r.normal(size=(K, C)).astype(np.float32)
    scale = r.uniform(0.0, 2.0, (K, C)).astype(np.float32)
    scale[r.uniform(size=scale.shape) < 0.2] = 0.0          # constant chunks
    return torch.from_numpy(lo).to(cuda), torch.from_numpy(scale).to(cuda)


def _both_routes(wrapper, payload, lo, scale, w, ref, tol, *, bits, chunk, levels):
    """The wrapper on the route ``_route`` picks (one launch, and one stream
    launch where it is the stream route); where that is the stream route,
    each route forced through ``_launch`` too. Every output within ``tol``
    of ``ref``, and the two forced outputs equal."""
    kw = dict(bits=bits, chunk=chunk, levels=levels)
    route = _route(payload, _out(payload, lo, chunk), chunk=chunk, bits=bits,
                   K=payload.shape[0])
    before = (wrapper.launches, wrapper.stream_launches)
    if payload.dtype == torch.int32:
        out = wrapper(payload, lo, scale, w, **kw)
    else:
        out = wrapper(payload, lo, scale, w, chunk=chunk, levels=levels)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.stream_launches) == (
        before[0] + 1, before[1] + (route == "stream"))
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= tol
    if route == "stream":
        got = {r: _launch(payload, lo, scale, w, _out(payload, lo, chunk), route=r, **kw)
               for r in ("general", "stream")}
        torch.cuda.synchronize()
        for r in got:
            assert float((got[r] - ref).abs().max()) <= tol, r
        # the same fma chain in the same k order, on exact decodes
        assert torch.equal(got["general"], got["stream"])
        assert wrapper.stream_launches == before[1] + 2
    return route


@pytest.mark.parametrize("K", [1, 2, 10, 17, 33])
@pytest.mark.parametrize("N,chunk", [(1000, 512), (4097, 16), (100, 30), (199_210, 512)])
@pytest.mark.parametrize("code_dtype", [torch.uint8, torch.uint16])
def test_quantized_kernel_matches_plain_version(cuda, K, N, chunk, code_dtype):
    C = -(-N // chunk)
    levels = 255 if code_dtype == torch.uint8 else 65535
    r = np.random.default_rng(K * N)
    codes = torch.from_numpy(r.integers(0, levels + 1, (K, C * chunk)).astype(np.int32))
    codes = codes.to(code_dtype).to(cuda)
    lo, scale = _ranges(cuda, K, C, seed=K)
    w = _weights(cuda, K, ghosts=K // 4)
    ref = quantized_aggregate_ref(codes, lo, scale, w, chunk=chunk, levels=levels)
    # fp32 sums over K rows in another order (fma): 1e-6 of the largest term
    term = float(dequantize_ref(codes, lo, scale, chunk=chunk, levels=levels).abs().max())
    route = _both_routes(quantized_aggregate, codes, lo, scale, w, ref, 1e-6 * term,
                         bits=8 * codes.element_size(), chunk=chunk, levels=levels)
    assert route == ("stream" if chunk == 512 and K <= STREAM_MAX_K else "general")


@pytest.mark.parametrize("bits", range(1, 16))
@pytest.mark.parametrize("K,N,chunk", [(1, 1000, 512), (17, 250, 30), (10, 199_210, 512),
                                       (33, 1000, 512)])
def test_packed_kernel_matches_plain_version(cuda, bits, K, N, chunk):
    C = -(-N // chunk)
    g = torch.Generator(device=cuda).manual_seed(bits * K)
    words = torch.randint(-2**31, 2**31, (K, C * words_per_chunk(chunk, bits)),
                          generator=g, dtype=torch.int32, device=cuda)
    lo, scale = _ranges(cuda, K, C, seed=bits)
    w = _weights(cuda, K)
    kw = dict(bits=bits, chunk=chunk, levels=2**bits - 1)
    ref = packed_quantized_aggregate_ref(words, lo, scale, w, **kw)
    term = float((lo.abs() + scale.abs()).max())
    route = _both_routes(packed_quantized_aggregate, words, lo, scale, w, ref, 1e-6 * term, **kw)
    assert route == ("stream" if bits in (1, 2, 4) and chunk == 512 and K <= STREAM_MAX_K
                     else "general")


def _sparse_both_routes(idx, vals, w, n):
    """The wrapper on the route ``_route`` picks (one launch, and one fused
    launch where it is the fused route); where that is the fused route, each
    route forced through ``_launch`` too. Every output within 1e-6 of the
    largest term of the plain version (atomic adds in a run-dependent
    order)."""
    K, k = idx.shape
    route = sparse_agg._route(idx, vals, torch.empty(n, device=idx.device), K=K, k=k)
    before = (sparse_aggregate.launches, sparse_aggregate.fused_launches)
    outs = {route: sparse_aggregate(idx, vals, w, n)}
    torch.cuda.synchronize()
    assert (sparse_aggregate.launches, sparse_aggregate.fused_launches) == (
        before[0] + 1, before[1] + (route == "fused"))
    if route == "fused":
        for r in sparse_agg.ROUTES:
            outs[f"forced {r}"] = sparse_agg._launch(idx, vals, w,
                                                     torch.empty(n, device=idx.device), r)
        torch.cuda.synchronize()
        assert sparse_aggregate.fused_launches == before[1] + 2
    ref = sparse_aggregate_ref(idx, vals, w, n)
    for r, out in outs.items():
        assert out.shape == (n,) and out.dtype == torch.float32
        assert float((out - ref).abs().max()) <= 1e-6 * float(vals.float().abs().max()), r
    return route


@pytest.mark.parametrize("K", [1, 2, 10, 17])
@pytest.mark.parametrize("n", [37, 513, 199_210])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_kernel_matches_plain_version(cuda, K, n, dtype):
    k = max(n // 20, 1)
    g = torch.Generator(device=cuda).manual_seed(K * n)
    idx = torch.stack([torch.randperm(n, generator=g, device=cuda)[:k] for _ in range(K)])
    idx = idx.to(torch.int32).contiguous()
    vals = torch.randn((K, k), generator=g, device=cuda).to(dtype)
    w = _weights(cuda, K, ghosts=K // 4)
    route = _sparse_both_routes(idx, vals, w, n)
    assert route == ("fused" if k % 4 == 0 else "scatter")


@pytest.mark.parametrize("misaligned", ["idx", "vals", None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_misaligned_views_take_the_scatter_route(cuda, misaligned, dtype):
    K, n, k = 10, 199_210, 9960
    r = np.random.default_rng(5)
    idx = torch.from_numpy(np.stack([r.permutation(n)[:k] for _ in range(K)]).astype(np.int32))
    vals = torch.from_numpy(r.normal(size=(K, k)).astype(np.float32)).to(dtype)

    def on_card(t, offset):   # a contiguous copy, offset elements past an aligned base
        base = torch.empty(t.numel() + offset, dtype=t.dtype, device=cuda)
        return base[offset:].view(t.shape).copy_(t)

    idx_d = on_card(idx, int(misaligned == "idx"))
    vals_d = on_card(vals, int(misaligned == "vals"))
    route = _sparse_both_routes(idx_d, vals_d, _weights(cuda, K), n)
    assert route == ("scatter" if misaligned else "fused")


def test_sparse_fused_launch_replays_under_stream_capture(cuda):
    """A CUDA graph captures the fused route's cooperative launch, and a
    replay recomputes the aggregate from the inputs' current values. The
    capture only records the launch, so the wrapper counts none."""
    K, n, k = 10, 199_210, 9960
    g = torch.Generator(device=cuda).manual_seed(3)
    idx = torch.stack([torch.randperm(n, generator=g, device=cuda)[:k]
                       for _ in range(K)]).to(torch.int32)
    vals = torch.randn((K, k), generator=g, device=cuda)
    w = _weights(cuda, K)
    assert sparse_agg._route(idx, vals, torch.empty(n, device=cuda), K=K, k=k) == "fused"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sparse_aggregate(idx, vals, w, n)            # warm up: build and load off capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = sparse_aggregate.fused_launches
    with torch.cuda.graph(graph):
        out = sparse_aggregate(idx, vals, w, n)
    assert sparse_aggregate.fused_launches == before
    for scale in (1.0, -2.0):
        vals.mul_(scale)
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        err = float((out - sparse_aggregate_ref(idx, vals, w, n)).abs().max())
        assert err <= 1e-6 * float(vals.abs().max())


def test_sparse_kernel_duplicates_add_and_ghosts_are_inert(cuda):
    idx = torch.tensor([[2, 2, 5], [5, 7, 0]], dtype=torch.int32, device=cuda)
    vals = torch.tensor([[1.0, 3.0, -2.0], [1e4, 1e4, 1e4]], device=cuda)
    out = sparse_aggregate(idx, vals, torch.tensor([1.0, 0.0], device=cuda), 8)
    want = torch.zeros(8)
    want[2], want[5] = 4.0, -2.0
    assert torch.equal(out.cpu(), want)
    # indices outside [0, n) are dropped, not written
    bad = torch.tensor([[-1, 8, 3]], dtype=torch.int32, device=cuda)
    out = sparse_aggregate(bad, torch.ones((1, 3), device=cuda),
                           torch.ones(1, device=cuda), 8)
    assert torch.equal(out.cpu(), torch.eye(8)[3])


def test_wire_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    codes = torch.zeros((2, 32), dtype=torch.uint8, device=cuda)
    lo, scale = _ranges(cuda, 2, 2)
    w = _weights(cuda, 2)
    words = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    idx = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    vals = torch.zeros((2, 3), device=cuda)
    before = (quantized_aggregate.launches, packed_quantized_aggregate.launches,
              sparse_aggregate.launches)
    q = dict(chunk=16, levels=255)
    p = dict(bits=4, chunk=16, levels=15)
    with pytest.raises(TypeError):
        quantized_aggregate(codes.int(), lo, scale, w, **q)
    with pytest.raises(ValueError, match="contiguous"):
        quantized_aggregate(codes.t().contiguous().t(), lo, scale, w, **q)
    with pytest.raises(ValueError, match="float32 only"):
        quantized_aggregate(codes, lo, scale, w, accum_dtype=torch.bfloat16, **q)
    with pytest.raises(ValueError, match="weights on"):
        quantized_aggregate(codes, lo, scale, w.cpu(), **q)
    with pytest.raises(TypeError):
        packed_quantized_aggregate(words.to(torch.uint8), lo, scale, w, **p)
    with pytest.raises(ValueError, match="bits in 1..15"):
        packed_quantized_aggregate(words, lo, scale, w, bits=16, chunk=16, levels=65535)
    with pytest.raises(ValueError, match="float32 only"):
        packed_quantized_aggregate(words, lo, scale, w, accum_dtype=torch.bfloat16, **p)
    with pytest.raises(TypeError):
        sparse_aggregate(idx.long(), vals, w, 8)
    with pytest.raises(ValueError, match="contiguous"):
        sparse_aggregate(idx, vals.t().contiguous().t(), w, 8)
    with pytest.raises(ValueError, match="float32 only"):
        sparse_aggregate(idx, vals, w, 8, accum_dtype=torch.bfloat16)
    assert (quantized_aggregate.launches, packed_quantized_aggregate.launches,
            sparse_aggregate.launches) == before


@pytest.mark.parametrize("codec_name,kernel", [
    ("q8", quantized_aggregate), ("q4", packed_quantized_aggregate),
    ("top", sparse_aggregate), ("lowrank", None),
])
def test_compressed_round_on_card(cuda, codec_name, kernel):
    from repro_torch.core import compression as comp
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.data.synthetic import make_image_classification
    from repro_torch.models import paper

    codec = {"q8": comp.quantize_codec(8), "q4": comp.quantize_codec(4),
             "top": comp.topk_codec(0.05), "lowrank": comp.lowrank_codec(8)}[codec_name]
    train, _, _ = make_image_classification(36, 1, seed=0)
    clients = [(train.x[a:b], train.y[a:b]) for a, b in ((0, 12), (12, 21), (21, 36))]
    model = paper.mnist_cnn(device=cuda)
    box = {}

    def encode(gen, flat):
        box["payloads"] = codec.encode(gen, flat)
        return box["payloads"]

    def aggregate(payloads, weights, n):
        box.update(out=codec.aggregate(payloads, weights, n), weights=weights, n=n)
        return box["out"]

    eng = RoundEngine(model.loss, model.init(0), clients,
                      FedAvgConfig(C=0.67, E=1, B=4, lr=0.05, seed=0),
                      codec=codec._replace(encode=encode, aggregate=aggregate), device=cuda)
    before = None if kernel is None else kernel.launches
    main_route = {"q8": "stream_launches", "q4": "stream_launches",
                  "top": "fused_launches"}.get(codec_name)
    main_before = main_route and getattr(kernel, main_route)
    hist = eng.run(2)
    torch.cuda.synchronize()
    assert all(np.isfinite(r.train_loss) for r in hist.records)
    if kernel is not None:
        assert kernel.launches == before + 2
    if main_route:   # every round on the codec kernels' stream route, top-k's fused one
        assert getattr(kernel, main_route) == main_before + 2
    # the last round's payloads aggregated again on the CPU, by the plain versions
    host = {k: v.cpu() for k, v in box["payloads"].items()}
    plain = comp.decode_aggregate(codec, host, torch.as_tensor(box["weights"]), box["n"])
    card = box["out"].cpu()
    if kernel is not None:
        term = float(codec.decode(host, box["n"]).abs().max())
        assert float((card - plain).abs().max()) <= 1e-6 * term
    else:   # two einsums of 16-term fp32 sums
        assert float((card - plain).norm()) <= 1e-5 * float(plain.norm())
    one = {k: v[0] for k, v in host.items()}
    assert comp.realized_device_bytes(one) == codec.wire_bytes(box["n"])


# ---------------------------------------------------------------------------
# the gossip lane: gossip_mix
# ---------------------------------------------------------------------------

def _plans(n):
    from repro_torch.core import topology as topo

    kinds = {"ring": topo.RingTopology(), "full": topo.FullTopology(),
             "smallworld": topo.SmallWorldTopology(degree=4, rewire=0.2, seed=0)}
    return {k: t.build(n) for k, t in kinds.items()
            if not (k == "ring" and n < 3 or k == "smallworld" and n < 5)}


def _mix_check(x, idx, w):
    """Kernel against the plain version: fp32 sums of D terms in another
    order (at most D roundings a side for weights summing to 1), plus one
    bf16 ulp at the store for bf16."""
    before = gossip_mix.launches
    out = gossip_mix(x, idx, w)
    torch.cuda.synchronize()
    assert gossip_mix.launches == before + 1
    assert out.dtype == x.dtype and out.shape == x.shape and out.device.type == "cuda"
    ref32 = gossip_mix_ref(x.float(), idx, w)
    tol = 2 * idx.shape[1] * 2.0 ** -24 * float(x.float().abs().max())
    if x.dtype == torch.float32:
        assert float((out - ref32).abs().max()) <= tol
    else:
        ulp = torch.exp2(torch.floor(torch.log2(ref32.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((out.float() - ref32).abs() <= ulp + tol).all())


@pytest.mark.parametrize("n", [2, 3, 17, 100])
@pytest.mark.parametrize("N", [1, 33, 4097, 199_210])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_kernel_matches_plain_version(cuda, n, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(n * N)
    x = torch.randn((n, N), generator=g, device=cuda).to(dtype)
    for plan in _plans(n).values():
        _mix_check(x, torch.from_numpy(plan.idx).to(cuda),
                   torch.from_numpy(plan.weight).to(cuda))


@pytest.mark.parametrize("kind", ["duplicates", "out_of_range", "padded", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_kernel_slot_semantics(cuda, kind, dtype):
    n, N = 17, 4097
    r = np.random.default_rng(0)
    plan = _plans(n)["ring"]
    idx, w = plan.idx, plan.weight
    if kind == "duplicates":
        idx = r.integers(0, n, (n, 6)).astype(np.int32)
        idx[:, 1] = idx[:, 0]
    elif kind == "out_of_range":
        idx = r.integers(0, n, (n, 6)).astype(np.int32)
        idx[:, :3] = np.array([-1, n, 10 * n], np.int32)
    elif kind == "padded":
        idx = np.concatenate([idx, np.tile(np.arange(n, dtype=np.int32)[:, None], (1, 3))], 1)
        w = np.concatenate([w, np.zeros((n, 3), np.float32)], 1)
    if kind in ("duplicates", "out_of_range"):
        w = r.uniform(0.1, 1.0, idx.shape)
        w = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    x = torch.from_numpy(r.normal(size=(n, N)).astype(np.float32)).to(cuda, dtype)
    if kind == "misaligned":   # a contiguous view one element off 16-byte alignment
        x = torch.empty(n * N + 1, device=cuda, dtype=dtype)[1:].view(n, N).copy_(x)
    idx_t, w_t = torch.from_numpy(idx).to(cuda), torch.from_numpy(w).to(cuda)
    _mix_check(x, idx_t, w_t)
    if kind == "padded":       # dead slots change nothing
        narrow = gossip_mix(x, torch.from_numpy(plan.idx).to(cuda),
                            torch.from_numpy(plan.weight).to(cuda))
        assert torch.equal(gossip_mix(x, idx_t, w_t), narrow)


def _routed_mix_check(x, idx, w, route=None):
    """_mix_check through ``route``'s kernel (forced by the private launcher),
    or the route ``_route`` picks; the dense launches counted."""
    from repro_torch.kernels.gossip_mix import _launch, _route

    taken = route or _route(x, idx, w)
    dense = gossip_mix.dense_launches
    if route is None:
        _mix_check(x, idx, w)
    else:
        before = gossip_mix.launches
        out = _launch(x, idx, w, route)
        torch.cuda.synchronize()
        assert gossip_mix.launches == before + 1
        ref32 = gossip_mix_ref(x.float(), idx, w)
        tol = 2 * idx.shape[1] * 2.0 ** -24 * float(x.float().abs().max())
        if x.dtype == torch.float32:
            assert float((out - ref32).abs().max()) <= tol
        else:
            ulp = torch.exp2(torch.floor(torch.log2(ref32.abs().clamp_min(2.0 ** -126))) - 7)
            assert bool(((out.float() - ref32).abs() <= ulp + tol).all())
    assert gossip_mix.dense_launches == dense + (taken == "dense")
    return taken


@pytest.mark.parametrize("n", [2, 17, 100, 1024])
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_dense_route_on_the_full_graph(cuda, n, misaligned, dtype):
    """The full graph takes the dense route at every n, and holds."""
    N = 4097
    plan = _plans(n)["full"]
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((n, N), generator=g, device=cuda).to(dtype)
    if misaligned:   # a contiguous view one element off 16-byte alignment
        x = torch.empty(n * N + 1, device=cuda, dtype=dtype)[1:].view(n, N).copy_(x)
    idx, w = torch.from_numpy(plan.idx).to(cuda), torch.from_numpy(plan.weight).to(cuda)
    assert _routed_mix_check(x, idx, w) == "dense"


@pytest.mark.parametrize("kind", ["ring", "smallworld", "full"])
@pytest.mark.parametrize("route", ["gather", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_both_routes_on_the_main_plans(cuda, kind, route, dtype):
    """Each route forced on the 100-node plans at the 2NN's N: either takes
    every plan."""
    plan = _plans(100)[kind]
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((100, 199_210), generator=g, device=cuda).to(dtype)
    idx, w = torch.from_numpy(plan.idx).to(cuda), torch.from_numpy(plan.weight).to(cuda)
    _routed_mix_check(x, idx, w, route)


def test_gossip_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.gossip_mix import MAX_NODES

    plan = _plans(4)["ring"]
    x = torch.randn((4, 64), device=cuda)
    idx, w = torch.from_numpy(plan.idx).to(cuda), torch.from_numpy(plan.weight).to(cuda)
    before = gossip_mix.launches
    with pytest.raises(ValueError, match="row-stochastic"):
        gossip_mix(x.cpu(), idx.cpu(), w.cpu() * 2)
    with pytest.raises(ValueError, match="n_nodes"):
        gossip_mix(x, idx[:3].contiguous(), w[:3].contiguous())
    with pytest.raises(TypeError):
        gossip_mix(x.half(), idx, w)
    with pytest.raises(TypeError):
        gossip_mix(x, idx.long(), w)
    with pytest.raises(ValueError, match="contiguous"):
        gossip_mix(x.t().contiguous().t(), idx, w)
    with pytest.raises(ValueError, match="float32 only"):
        gossip_mix(x, idx, w, accum_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="idx on"):
        gossip_mix(x, idx.cpu(), w)
    with pytest.raises(ValueError, match=f"at most {MAX_NODES}"):
        gossip_mix(torch.zeros((MAX_NODES + 1, 8), device=cuda),
                   torch.arange(MAX_NODES + 1, dtype=torch.int32, device=cuda)[:, None],
                   torch.ones((MAX_NODES + 1, 1), device=cuda))
    assert gossip_mix.launches == before


def test_gossip_round_on_card_matches_round_on_cpu(cuda):
    from repro_torch.core.engine import RoundEngine, build_gossip_round_step
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.data.synthetic import make_image_classification
    from repro_torch.models import paper
    from repro_torch.utils.tree import tree_map, tree_ravel

    train, _, _ = make_image_classification(60, 1, seed=0)
    clients = [(train.x[a:a + 12], train.y[a:a + 12]) for a in range(0, 60, 12)]
    model = paper.mnist_cnn(device=cuda)
    eng = RoundEngine(model.loss, model.init(0), clients,
                      FedAvgConfig(C=1.0, E=1, B=4, lr=0.05, seed=0), topology="ring",
                      device=cuda)
    batch, mask, w = eng.materialize_round_batch(np.arange(5), generator_seed=5)
    step = build_gossip_round_step(model.loss)
    start = tree_ravel(tree_map(lambda p: p.cpu().double(), eng.params))[0]
    before = gossip_mix.launches
    # fp32 both sides, sums in other orders: as the star round's check
    for n_steps, rtol in ((1, 1e-4), (mask.shape[1], 1e-2)):
        b = tuple(x[:, :n_steps].contiguous() for x in batch)
        msk = mask[:, :n_steps].contiguous()
        got, gm = step(eng.params, b, msk, w, eng._mix_idx, eng._mix_w, 0.05)
        want, wm = step(tree_map(lambda p: p.cpu(), eng.params), tuple(x.cpu() for x in b),
                        msk.cpu(), w, eng._mix_idx.cpu(), eng._mix_w.cpu(), 0.05)
        d_card, d_cpu = (tree_ravel(tree_map(lambda p: p.cpu().double(), t))[0] - start
                         for t in (got, want))
        assert float((d_card - d_cpu).norm()) <= rtol * float(d_cpu.norm())
        assert abs(float(gm["loss"]) - float(wm["loss"])) <= 1e-4 * abs(float(wm["loss"]))
        assert abs(float(gm["consensus"]) - float(wm["consensus"])) <= \
            rtol * float(wm["consensus"])
    assert gossip_mix.launches == before + 2
    hist = eng.run(2)
    assert gossip_mix.launches == before + 4
    assert all(r.consensus > 0 for r in hist.records)


# ---------------------------------------------------------------------------
# the LM substrate's kernels: flash_attention and ssm_scan
# ---------------------------------------------------------------------------

def _close_to_fp32(out, ref32, scale):
    """fp32 outputs within 1e-5 of the inputs' scale (sums over D and over
    the keys or steps in another order, exp2 in place of exp); bf16 outputs
    within one bf16 ulp of the fp32 result (both round it once) plus that."""
    tol = 1e-5 * scale
    if out.dtype == torch.float32:
        return float((out - ref32).abs().max()) <= tol
    ulp = torch.exp2(torch.floor(torch.log2(ref32.abs().clamp_min(2.0 ** -126))) - 7)
    return bool(((out.float() - ref32).abs() <= ulp + tol).all())


def _flash_case(cuda, B, Sq, Sk, H, K, D, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Sk, K, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Sk, K, D), generator=g, device=cuda).to(dtype)
    return q, k, v


def _flash_check(q, k, v, causal, window, route):
    """One launch, of ``route``'s kernel ("mma": the tensor-core one, which
    also moves ``tc_launches``; "scalar"), within the allowance."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    before, tc_before = flash_attention.launches, flash_attention.tc_launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.tc_launches == tc_before + (route == "mma")
    assert out.shape == q.shape and out.dtype == q.dtype
    ref32 = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
    assert _close_to_fp32(out, ref32, float(v.float().abs().max()))


@pytest.mark.parametrize("S", [1, 37, 2047])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("heads", [(32, 8), (8, 1)])
@pytest.mark.parametrize("mask", ["causal", "full", "window"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, S, D, heads, mask, dtype):
    H, K = heads
    q, k, v = _flash_case(cuda, 1, S, S, H, K, D, dtype, seed=S * D + H)
    _flash_check(q, k, v, causal=mask != "full", window=100 if mask == "window" else 0,
                 route="mma" if dtype == torch.bfloat16 else "scalar")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_layouts_and_views(cuda, dtype):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    # the reference kernel's (BH, S, D) layout, Sq != Sk, odd D
    q, k, v = (t[:, :, 0] for t in _flash_case(cuda, 6, 70, 70, 1, 1, 37, dtype, seed=1))
    for causal, window in ((True, 0), (False, 0), (True, 9), (False, 9)):
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref32 = flash_attention_ref(q.float()[:, :, None], k.float()[:, :, None],
                                    v.float()[:, :, None], causal=causal, window=window)
        assert out.shape == q.shape
        assert _close_to_fp32(out, ref32[:, :, 0], float(v.float().abs().max()))
    # q, k, v as column slices of one fused projection (strided, not contiguous)
    B, S, H, K, D = 2, 130, 4, 2, 64
    qkv = torch.randn((B, S, (H + 2 * K) * D), device=cuda).to(dtype)
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + K) * D].view(B, S, K, D)
    v = qkv[..., (H + K) * D:].view(B, S, K, D)
    assert not q.is_contiguous()
    # aligned views: bf16 takes the tensor-core route in place
    _flash_check(q, k, v, causal=True, window=0,
                 route="mma" if dtype == torch.bfloat16 else "scalar")


@pytest.mark.parametrize("shape", [(4, 2048, 32, 8, 128), (4, 2048, 8, 1, 256),
                                   (4, 2048, 16, 16, 192)],
                         ids=["jamba", "gemma-2b", "deepseek-v2-lite"])
def test_flash_kernel_at_the_prefill_shapes(cuda, shape):
    B, S, H, K, D = shape
    q, k, v = _flash_case(cuda, B, S, S, H, K, D, torch.bfloat16, seed=D)
    _flash_check(q, k, v, causal=True, window=0, route="mma")


@pytest.mark.parametrize("S", [1, 37, 130, 2047])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("mask", ["causal", "full", "window"])
def test_flash_tc_kernel_at_lengths_off_the_tile(cuda, S, D, mask):
    """bf16 on the tensor-core route at S not a multiple of its 32- or 64-key
    tiles or its 64-row query tiles, GQA 4/2."""
    q, k, v = _flash_case(cuda, 2, S, S, 4, 2, D, torch.bfloat16, seed=S + D)
    _flash_check(q, k, v, causal=mask != "full", window=100 if mask == "window" else 0,
                 route="mma")


@pytest.mark.parametrize("sq_sk", [(1, 4096), (37, 130), (130, 37), (2048, 4096)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("heads", [(16, 16), (32, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_non_causal_at_sq_ne_sk(cuda, sq_sk, D, heads, dtype):
    """Cross-attention's shapes: bidirectional, Sq queries over Sk != Sq
    keys (SeamlessM4T's decoder over 4,096 encoder frames), MHA and GQA,
    on both routes."""
    (Sq, Sk), (H, K) = sq_sk, heads
    q, k, v = _flash_case(cuda, 1, Sq, Sk, H, K, D, dtype, seed=Sq + Sk + D + H)
    _flash_check(q, k, v, causal=False, window=0,
                 route="mma" if dtype == torch.bfloat16 else "scalar")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_lse_non_causal_at_sq_ne_sk(cuda, dtype):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    for Sq, Sk in ((37, 130), (130, 37)):
        q, k, v = _flash_case(cuda, 2, Sq, Sk, 8, 2, 64, dtype, seed=Sq)
        out, lse = flash_attention(q, k, v, causal=False, return_lse=True)
        _, want = flash_attention_ref(q.float(), k.float(), v.float(), causal=False,
                                      return_lse=True)
        assert lse.shape == (2, Sq, 8)
        assert float((lse - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
        assert torch.equal(out, flash_attention(q, k, v, causal=False))


@pytest.mark.parametrize("mask", ["causal", "full", "window"])
def test_flash_scalar_route_takes_bf16_at_d96_and_unaligned_views(cuda, mask):
    causal, window = mask != "full", 100 if mask == "window" else 0
    # a head dim the tensor-core kernel does not take
    _flash_check(*_flash_case(cuda, 1, 130, 130, 4, 2, 96, torch.bfloat16, seed=96),
                 causal=causal, window=window, route="scalar")
    # q one element into its storage: rows off the 16-byte grid
    q, k, v = _flash_case(cuda, 1, 130, 130, 4, 2, 128, torch.bfloat16, seed=128)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    qu = flat[1:].view(q.shape)
    qu.copy_(q)
    assert qu.data_ptr() % 16
    _flash_check(qu, k, v, causal=causal, window=window, route="scalar")


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _flash_case(cuda, 1, 8, 8, 4, 2, 16, torch.float32, seed=0)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head_dim up to 256"):
        flash_attention(*_flash_case(cuda, 1, 8, 8, 1, 1, 264, torch.float32, seed=0))
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="multiple of n_kv_heads"):
        flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="k on"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous last axis"):
        flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3), v)
    with pytest.raises(ValueError, match="all \\(BH, S, D\\)"):
        flash_attention(q[0], k, v)
    assert flash_attention.launches == before


def _ssm_case(cuda, B, T, D, N, dtype, seed, h0_scale=0.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    dt = (torch.rand((B, T, D), generator=g, device=cuda) * 0.1 + 1e-3).to(dtype)
    Bm = torch.randn((B, T, N), generator=g, device=cuda).to(dtype)
    Cm = torch.randn((B, T, N), generator=g, device=cuda).to(dtype)
    x = torch.randn((B, T, D), generator=g, device=cuda).to(dtype)
    A = -torch.rand((D, N), generator=g, device=cuda) * 16 - 0.5
    h0 = torch.randn((B, D, N), generator=g, device=cuda) * h0_scale
    return dt, Bm, Cm, x, A, h0


def _ssm_check(dt, Bm, Cm, x, A, h0):
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref

    before = ssm_scan.launches
    y, h = ssm_scan(dt, Bm, Cm, x, A, h0)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    assert y.dtype == x.dtype and h.dtype == torch.float32
    y32, h32 = ssm_scan_ref(dt.float(), Bm.float(), Cm.float(), x.float(), A, h0)
    scale = max(1.0, float(y32.abs().max()), float(h32.abs().max()))
    assert _close_to_fp32(y, y32, scale)
    assert float((h - h32).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("B,T,D,N", [(1, 8, 4, 2), (2, 24, 8, 4), (1, 16, 16, 8),
                                     (2, 100, 200, 16), (3, 37, 129, 5), (1, 1, 8192, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_kernel_matches_plain_version(cuda, B, T, D, N, dtype):
    _ssm_check(*_ssm_case(cuda, B, T, D, N, dtype, seed=B * T * D * N, h0_scale=1.0))


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("B,T,D,N", [(2, 37, 129, 1), (2, 37, 129, 5), (2, 24, 72, 13),
                                     (2, 100, 200, 16), (3, 1, 129, 5), (4, 1, 8192, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_kernel_at_every_lane_count(cuda, lanes, B, T, D, N, dtype):
    """N = 1, 5, 13, 16, T off the 16-step run, a ragged D and T = 1, each
    with 1, 2 and 4 lanes a channel forced."""
    from repro_torch.kernels.ssm_scan import _launch, ssm_scan, ssm_scan_ref

    dt, Bm, Cm, x, A, h0 = _ssm_case(cuda, B, T, D, N, dtype, seed=B * T * D + N,
                                     h0_scale=1.0)
    before = dict(ssm_scan.lane_launches)
    y, h = _launch(dt, Bm, Cm, x, A, h0, lanes)
    torch.cuda.synchronize()
    before[lanes] += 1
    assert ssm_scan.lane_launches == before
    y32, h32 = ssm_scan_ref(dt.float(), Bm.float(), Cm.float(), x.float(), A, h0)
    scale = max(1.0, float(y32.abs().max()), float(h32.abs().max()))
    assert _close_to_fp32(y, y32, scale)
    assert float((h - h32).abs().max()) <= 1e-5 * scale


def test_ssm_launch_plan_on_the_jamba_shapes(cuda):
    """Prefill and decode take the launch plan's lanes."""
    from repro_torch.kernels.ssm_scan import launch_plan, ssm_scan

    for T in (2048, 1):
        args = _ssm_case(cuda, 4, T, 8192, 16, torch.float32, seed=T, h0_scale=1.0)
        before = dict(ssm_scan.lane_launches)
        _ssm_check(*args)
        before[launch_plan(T)] += 1
        assert ssm_scan.lane_launches == before


def test_ssm_kernel_on_views_and_in_chunks(cuda):
    from repro_torch.kernels.ops import mamba_ssm_scan
    from repro_torch.kernels.ssm_scan import ssm_scan

    dt, Bm, Cm, x, A, h0 = _ssm_case(cuda, 2, 50, 96, 16, torch.float32, seed=3)
    # B and C as column slices of one projection, as mamba_apply makes them
    dbc = torch.cat([torch.randn((2, 50, 6), device=cuda), Bm, Cm], dim=-1)
    Bv, Cv = dbc[..., 6:22], dbc[..., 22:]
    assert not Bv.is_contiguous()
    _ssm_check(dt, Bv, Cv, x, A, h0)
    before = ssm_scan.launches
    y1, h1 = mamba_ssm_scan(dt, Bv, Cv, x, A, h0, chunk=16)
    assert ssm_scan.launches == before + 4
    y2, h2 = ssm_scan(dt, Bm, Cm, x, A, h0)
    torch.cuda.synchronize()
    assert float((y1 - y2).abs().max()) <= 1e-6 * float(y2.abs().max())
    assert float((h1 - h2).abs().max()) <= 1e-6 * float(h2.abs().max())


def test_ssm_kernel_at_the_prefill_shape(cuda):
    _ssm_check(*_ssm_case(cuda, 4, 2048, 8192, 16, torch.float32, seed=0))


def test_ssm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.ssm_scan import ssm_scan

    dt, Bm, Cm, x, A, h0 = _ssm_case(cuda, 1, 4, 8, 4, torch.float32, seed=0)
    before = ssm_scan.launches
    with pytest.raises(ValueError, match="d_state up to 16"):
        big = _ssm_case(cuda, 1, 4, 8, 17, torch.float32, seed=0)
        ssm_scan(*big)
    with pytest.raises(TypeError):
        ssm_scan(dt, Bm, Cm, x.bfloat16(), A, h0)
    with pytest.raises(TypeError):
        ssm_scan(dt, Bm, Cm, x, A.bfloat16(), h0)
    with pytest.raises(ValueError, match="want"):
        ssm_scan(dt, Bm, Cm, x, A[:4], h0)
    with pytest.raises(ValueError, match="one device"):
        ssm_scan(dt, Bm, Cm, x, A.cpu(), h0)
    with pytest.raises(ValueError, match="contiguous last axis"):
        ssm_scan(dt.transpose(1, 2).contiguous().transpose(1, 2), Bm, Cm, x, A, h0)
    assert ssm_scan.launches == before


def _bwd_case(cuda, B, T, D, N, seed, views=False):
    """The scan's inputs with a nonzero h0, cotangents gy and g_hT; with
    ``views`` B and C are column slices of one projection, as mamba_apply
    passes them in fp32."""
    dt, Bm, Cm, x, A, h0 = _ssm_case(cuda, B, T, D, N, torch.float32, seed, h0_scale=1.0)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    gy = torch.randn((B, T, D), generator=g, device=cuda)
    gh = torch.randn((B, D, N), generator=g, device=cuda)
    if views:
        dbc = torch.cat([torch.randn((B, T, 6), device=cuda), Bm, Cm], dim=-1)
        Bm, Cm = dbc[..., 6:6 + N], dbc[..., 6 + N:]
    return (dt, Bm, Cm, x, A, h0), gy, gh


def _bwd_close(got, want):
    """Each gradient within 1e-5 of its largest magnitude (at least 1): fp32
    sums over states, channels and time in another order, exp2 for exp."""
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == torch.float32
            assert float((g - w).abs().max()) <= 1e-5 * max(1.0, float(w.abs().max()))


@pytest.mark.parametrize("B,T,D,N", [(1, 1, 24, 4), (2, 37, 24, 16), (2, 37, 200, 5),
                                     (1, 37, 8192, 16), (2, 2048, 8192, 16)])
def test_ssm_scan_bwd_kernel_matches_plain_version(cuda, B, T, D, N):
    """The forward's checkpoints (kernel vs plain), then the backward from
    them against ``ssm_scan_bwd_ref``: T = 1, T off the 16-step run, ragged
    D, padded N, the training shape."""
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd, ssm_scan_bwd_ref, ssm_scan_ref

    args, gy, gh = _bwd_case(cuda, B, T, D, N, seed=B + T + D + N)
    y, h, ck = ssm_scan(*args, checkpoints=True)
    y0, h0 = ssm_scan(*args)
    assert torch.equal(y, y0) and torch.equal(h, h0)   # checkpoints change nothing else
    _, _, ck32 = ssm_scan_ref(*args, checkpoints=True)
    assert float((ck - ck32).abs().max()) <= 1e-5 * max(1.0, float(ck32.abs().max()))
    before = ssm_scan_bwd.launches
    got = ssm_scan_bwd(*args, gy, gh, checkpoints=ck)
    torch.cuda.synchronize()
    assert ssm_scan_bwd.launches == before + 1
    _bwd_close(got, ssm_scan_bwd_ref(*args, gy, gh))


@pytest.mark.parametrize("needs", [(True,) * 6, (True, True, True, True, True, False),
                                   (False, False, True, False, True, False),
                                   (True, False, False, False, False, True)])
def test_ssm_scan_bwd_kernel_on_views_and_what_is_asked(cuda, needs):
    """B and C as column slices; only the gradients asked for are made,
    and g_hT None counts as zeros."""
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd, ssm_scan_bwd_ref

    args, gy, _ = _bwd_case(cuda, 2, 50, 96, 16, seed=3, views=True)
    assert not args[1].is_contiguous()
    _, _, ck = ssm_scan(*args, checkpoints=True)
    got = ssm_scan_bwd(*args, gy, None, checkpoints=ck, needs=needs)
    torch.cuda.synchronize()
    _bwd_close(got, ssm_scan_bwd_ref(*args, gy, None, needs))


def test_ssm_scan_function_on_the_card_matches_autograd_through_the_plain_scan(cuda):
    """``ops.mamba_ssm_scan_train`` with B and C sliced from one projection
    that requires grad, as in mamba_apply: one forward and one backward
    launch; y, h_T and every leaf's gradient against autograd through
    ``ssm_scan_ref``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd, ssm_scan_ref

    (dt, Bm, Cm, x, A, h0), gy, gh = _bwd_case(cuda, 2, 130, 96, 16, seed=5)
    dbc = torch.cat([torch.randn((2, 130, 6), device=cuda), Bm, Cm], dim=-1)

    def through(scan):
        leaves = [t.detach().clone().requires_grad_() for t in (dt, dbc, x, A, h0)]
        d, p, xx, a, h = leaves
        y, h_T = scan(d, p[..., 6:22], p[..., 22:], xx, a, h)
        torch.autograd.backward([y, h_T], [gy, gh])
        return [y.detach(), h_T.detach()] + [t.grad for t in leaves]

    n_fwd, n_bwd = ssm_scan.launches, ssm_scan_bwd.launches
    got = through(ops.mamba_ssm_scan_train)
    torch.cuda.synchronize()
    assert (ssm_scan.launches, ssm_scan_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    _bwd_close(got, through(ssm_scan_ref))


def test_ssm_scan_bwd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd

    args, gy, gh = _bwd_case(cuda, 1, 20, 8, 4, seed=0)
    _, _, ck = ssm_scan(*args, checkpoints=True)
    dt, Bm, Cm, x, A, h0 = args
    before = ssm_scan_bwd.launches
    with pytest.raises(ValueError, match="checkpoints"):
        ssm_scan_bwd(*args, gy, gh)
    with pytest.raises(ValueError, match="checkpoints"):
        ssm_scan_bwd(*args, gy, gh, checkpoints=ck[:, :1])
    with pytest.raises(TypeError):
        ssm_scan_bwd(dt, Bm, Cm, x.bfloat16(), A, h0, gy, gh, checkpoints=ck)
    with pytest.raises(TypeError):
        ssm_scan_bwd(*args, gy.bfloat16(), gh, checkpoints=ck)
    with pytest.raises(ValueError, match="d_state up to 16"):
        big, gyb, ghb = _bwd_case(cuda, 1, 20, 8, 17, seed=0)
        ssm_scan_bwd(*big, gyb, ghb, checkpoints=torch.zeros((1, 2, 8, 17), device=cuda))
    with pytest.raises(ValueError, match="want"):
        ssm_scan_bwd(*args, gy[:, :4], gh, checkpoints=ck)
    with pytest.raises(ValueError, match="device"):
        ssm_scan_bwd(*args, gy.cpu(), gh, checkpoints=ck)
    with pytest.raises(ValueError, match="contiguous last axis"):
        ssm_scan_bwd(*args, gy.transpose(1, 2).contiguous().transpose(1, 2), gh,
                     checkpoints=ck)
    with pytest.raises(ValueError, match="gradient would be dropped"):
        ssm_scan_bwd(*args, gy.clone().requires_grad_(), gh, checkpoints=ck)
    assert ssm_scan_bwd.launches == before


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "gemma-2b", "deepseek-v2-lite-16b",
                                  "deepseek-v3-671b", "qwen2-vl-7b", "xlstm-350m",
                                  "seamless-m4t-medium"])
def test_lm_serving_on_card_matches_cpu(cuda, arch):
    """Reduced config in fp32: prefill + 3 decode steps on the card against
    the CPU on the same params (kernels against plain versions, end to end;
    the reference's own consistency bound, 3e-4, on the logits). The vision
    stub takes ``serve.prompt_batch``'s prompt (embeds, 3-D positions) and zero
    embeds at S + t while decoding; the audio stub its 16 frames, and
    decodes on tokens: flash once a prefill for each encoder layer, decoder
    attention layer and cross-attention, never in decode; xLSTM none."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = reduced(get_config(arch))
    gpu, cpu = TransformerLM(cfg, device=cuda), TransformerLM(cfg, device="cpu")
    params = gpu.init(0)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    prompt = prompt_batch(cfg, 2, 40, np.random.default_rng(0))
    n_attn = (sum((s.mixer in ("attn", "mla")) + s.cross for s in gpu.plan)
              + len(gpu.enc_plan))
    n_mamba = sum(s.mixer == "mamba" for s in gpu.plan)
    f0, s0 = flash_attention.launches, ssm_scan.launches
    c_gpu, l_gpu = gpu.prefill(params, {k: v.to(cuda) for k, v in prompt.items()}, cache_len=44)
    c_cpu, l_cpu = cpu.prefill(params_cpu, prompt, cache_len=44)
    assert (flash_attention.launches - f0, ssm_scan.launches - s0) == (n_attn, n_mamba)
    for step in range(4):
        assert float((l_gpu.cpu() - l_cpu).abs().max()) <= 3e-4
        for a, b in zip(tree_leaves(c_gpu), tree_leaves(c_cpu)):
            assert float((a.cpu().double() - b.double()).abs().max()) <= 1e-4
        if step == 3:
            break
        if cfg.modality == "vision":
            batch = {"embeds": torch.zeros((2, 1, cfg.d_model)),
                     "positions": torch.full((2, 1, 3), 40 + step, dtype=torch.int32)}
        else:
            batch = {"tokens": torch.argmax(l_cpu[:, -1], dim=-1)[:, None],
                     "pos_offset": 40 + step}
        l_gpu, c_gpu = gpu.decode_step(
            params, {k: (v.to(cuda) if torch.is_tensor(v) else v) for k, v in batch.items()},
            c_gpu)
        l_cpu, c_cpu = cpu.decode_step(params_cpu, batch, c_cpu)
    assert flash_attention.launches - f0 == n_attn
    assert ssm_scan.launches - s0 == 4 * n_mamba


# ---------------------------------------------------------------------------
# the training path: fused_cross_entropy, the flash lse, the grad guard,
# gradients through the kernels
# ---------------------------------------------------------------------------

def _ce_case(cuda, T, d, V, dtype, tied, seed=0):
    r = np.random.default_rng(seed)
    hidden = torch.from_numpy(r.normal(size=(T, d)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy((r.normal(size=(V, d)) / np.sqrt(d)).astype(np.float32)).to(cuda, dtype)
    head = w.T if tied else w.T.contiguous()
    labels = torch.from_numpy(r.integers(0, V, T).astype(np.int32)).to(cuda)
    labels[0], labels[-1] = 0, V - 1
    return hidden, head, labels


def _ce_check(hidden, head, labels, route=None):
    """The kernel (``route`` None: the wrapper's choice; "scalar": forced
    through the private launcher) against the plain version."""
    from repro_torch.kernels.ce_loss import _launch, fused_cross_entropy, fused_cross_entropy_ref

    before = fused_cross_entropy.launches
    if route is None:
        loss, lse = fused_cross_entropy(hidden, head, labels)
    else:
        loss, lse = _launch(hidden, head, labels, route)
    torch.cuda.synchronize()
    assert fused_cross_entropy.launches == before + 1
    ref_loss, ref_lse = fused_cross_entropy_ref(hidden.float(), head.float(), labels)
    # the same function on the same values: fp32 sums in other orders
    tol = 1e-5 * max(1.0, float(ref_lse.abs().max()))
    assert float((loss - ref_loss).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= tol


@pytest.mark.parametrize("T", [1, 37, 4096])
@pytest.mark.parametrize("V", [1, 1000, 2049])
@pytest.mark.parametrize("d", [64, 2048])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_kernel_matches_plain_version(cuda, T, V, d, tied, dtype):
    _ce_check(*_ce_case(cuda, T, d, V, dtype, tied, seed=T + V + d))


@pytest.mark.parametrize("T", [37, 4096])
def test_ce_kernel_at_the_training_vocab(cuda, T):
    _ce_check(*_ce_case(cuda, T, 2048, 256_000, torch.bfloat16, True, seed=T))


def test_ce_kernel_one_label_for_every_token(cuda):
    hidden, head, labels = _ce_case(cuda, 37, 64, 1000, torch.float32, False)
    labels.fill_(500)
    _ce_check(hidden, head, labels)


def test_ce_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.ce_loss import fused_cross_entropy

    hidden, head, labels = _ce_case(cuda, 8, 16, 40, torch.float32, True)
    before = fused_cross_entropy.launches
    with pytest.raises(TypeError):
        fused_cross_entropy(hidden.bfloat16(), head, labels)
    with pytest.raises(TypeError):
        fused_cross_entropy(hidden.half(), head.half(), labels)
    with pytest.raises(TypeError, match="int32"):
        fused_cross_entropy(hidden, head, labels.long())
    with pytest.raises(ValueError, match="labels on cpu"):
        fused_cross_entropy(hidden, head, labels.cpu())
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_cross_entropy(hidden.to("meta"), head.to("meta"), labels.to("meta"))
    with pytest.raises(ValueError, match="tokens"):
        fused_cross_entropy(torch.empty((1, 16), device=cuda).expand(2**31, 16), head,
                            torch.zeros(1, dtype=torch.int32, device=cuda).expand(2**31))
    with pytest.raises(ValueError, match="contiguous last axis"):
        fused_cross_entropy(hidden.T.contiguous().T, head, labels)
    with pytest.raises(ValueError, match="ops.ce_loss_mean"):
        fused_cross_entropy(hidden.clone().requires_grad_(), head, labels)
    assert fused_cross_entropy.launches == before


def _ce_view(cuda, T, d, V, layout, seed=0):
    """bf16 inputs with the head as the tied view or as the first V columns
    of a (d, V') tensor, V' a multiple of 8 above V."""
    hidden, head, labels = _ce_case(cuda, T, d, V, torch.bfloat16, True, seed)
    if layout == "sliced":
        pitch = -(-V // 8) * 8 + 8
        full = torch.zeros((d, pitch), dtype=torch.bfloat16, device=cuda)
        full[:, :V] = head
        head = full[:, :V]
    return hidden, head, labels


@pytest.mark.parametrize("T", [1, 37, 4096])
@pytest.mark.parametrize("V", [1, 1000, 2049])
@pytest.mark.parametrize("d", [64, 2048])
@pytest.mark.parametrize("layout", ["tied", "sliced"])
def test_ce_both_routes_match_plain_version(cuda, T, V, d, layout):
    """bf16 on the tensor-core route (the wrapper's choice for these views)
    and forced onto the scalar route, each against the plain version."""
    from repro_torch.kernels.ce_loss import _route, fused_cross_entropy

    hidden, head, labels = _ce_view(cuda, T, d, V, layout, seed=T + V + d)
    assert _route(hidden, head) == "mma"
    tc = fused_cross_entropy.tc_launches
    _ce_check(hidden, head, labels)
    assert fused_cross_entropy.tc_launches == tc + 1
    _ce_check(hidden, head, labels, route="scalar")
    assert fused_cross_entropy.tc_launches == tc + 1


def test_ce_routes_of_fp32_and_unaligned_inputs(cuda):
    """fp32 and a bf16 hidden one element into its storage take the scalar
    kernel, and the counters show it; the tensor-core route forced on them
    raises and launches nothing."""
    from repro_torch.kernels.ce_loss import _launch, fused_cross_entropy

    hidden, head, labels = _ce_case(cuda, 37, 64, 1000, torch.float32, True)
    buf = torch.empty(37 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(37, 64)
    shifted.copy_(hidden)
    for h, w in ((hidden, head), (shifted, head.bfloat16())):
        n, tc = fused_cross_entropy.launches, fused_cross_entropy.tc_launches
        _ce_check(h, w, labels)
        assert (fused_cross_entropy.launches, fused_cross_entropy.tc_launches) == (n + 1, tc)
        with pytest.raises(ValueError, match="does not take"):
            _launch(h, w, labels, "mma")
        assert fused_cross_entropy.launches == n + 1


def _probs_check(hidden, head, labels, seed=0, route=None):
    """ce_probs on the card (``route`` None: the wrapper's choice; "scalar":
    forced through the private launcher) against ce_probs_ref on the inputs
    widened to fp32: rounding to the inputs' dtype (one bf16 ulp of the
    fp32 value, as both round once; an fp32 epsilon) plus
    |g| (1e-6 + p * 1e-5 * max(1, |lse|)): the exp's error, and the logits'
    fp32 sums in another order carried into p (the forward's allowance).
    Returns the route taken."""
    from repro_torch.kernels.ce_loss import (
        _launch_probs,
        ce_probs,
        ce_probs_ref,
        fused_cross_entropy_ref,
    )

    T, V = hidden.shape[0], head.shape[1]
    if T > 3:
        labels[1], labels[2] = -1, V
    r = np.random.default_rng(seed)
    g = torch.from_numpy((r.uniform(0.5, 1.5, T) / T).astype(np.float32)).to(hidden.device)
    h32, w32 = hidden.float(), head.float()
    _, lse = fused_cross_entropy_ref(h32, w32, labels)
    n, tc = ce_probs.launches, ce_probs.tc_launches
    if route is None:
        p = ce_probs(hidden, head, labels, lse, g)
    else:
        p = _launch_probs(hidden, head, labels, lse, g, route)
    torch.cuda.synchronize()
    assert ce_probs.launches == n + 1
    assert p.shape == (T, V) and p.dtype == hidden.dtype
    p_one = ce_probs_ref(h32, w32, labels, lse, torch.ones_like(g))
    p32 = p_one * g[:, None]
    hit = (labels >= 0) & (labels < V)
    p_one[torch.arange(T, device=hidden.device)[hit], labels[hit].long()] += 1.0
    if hidden.dtype == torch.bfloat16:
        mag = p32.abs().clamp_min(2.0 ** -126)
        rnd = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    else:
        rnd = p32.abs() * torch.finfo(torch.float32).eps
    tol = rnd + g[:, None] * (1e-6 + p_one * 1e-5 * max(1.0, float(lse.abs().max())))
    assert bool(((p.float() - p32).abs() <= tol).all())
    return "mma" if ce_probs.tc_launches == tc + 1 else "scalar"


@pytest.mark.parametrize("T", [1, 37, 300])
@pytest.mark.parametrize("V", [1, 1000, 2049])
@pytest.mark.parametrize("d", [64, 2048])
@pytest.mark.parametrize("layout", ["tied", "sliced"])
@pytest.mark.parametrize("route", ["mma", "scalar"])
def test_ce_probs_kernel_matches_plain_version(cuda, T, V, d, layout, route):
    """bf16 on the tensor-core route (the wrapper's choice for these views)
    and forced onto the scalar route."""
    forced = None if route == "mma" else route
    got = _probs_check(*_ce_view(cuda, T, d, V, layout, seed=T + V + d), seed=T, route=forced)
    assert got == route


@pytest.mark.parametrize("T", [1, 37, 300])
@pytest.mark.parametrize("V", [1, 1000, 2049])
@pytest.mark.parametrize("tied", [False, True])
def test_ce_probs_scalar_kernel_on_fp32(cuda, T, V, tied):
    """fp32 takes ce_probs_kernel, P in fp32."""
    assert _probs_check(*_ce_case(cuda, T, 64, V, torch.float32, tied, seed=T + V),
                        seed=T) == "scalar"


def test_ce_probs_kernel_at_the_training_chunk(cuda):
    """1,024 tokens (B = 2 x ce_chunk 512) of the tied 256,000-word head."""
    assert _probs_check(*_ce_view(cuda, 1024, 2048, 256_000, "tied", seed=1)) == "mma"


def test_ce_probs_routes_of_fp32_and_unaligned_inputs(cuda):
    """fp32, d = 12 and a bf16 hidden one element into its storage take the
    scalar kernel; the tensor-core route forced on them raises and launches
    nothing, and so do inputs the wrapper refuses."""
    from repro_torch.kernels.ce_loss import _launch_probs, ce_probs

    hidden, head, labels = _ce_view(cuda, 37, 64, 1000, "tied")
    buf = torch.empty(37 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(37, 64)
    shifted.copy_(hidden)
    d12 = _ce_case(cuda, 37, 12, 1000, torch.bfloat16, True, seed=3)
    for h, w, lbl in ((hidden.float(), head.float(), labels), (shifted, head, labels), d12):
        assert _probs_check(h, w, lbl.clone()) == "scalar"
        lse, g = torch.zeros(37, device=cuda), torch.ones(37, device=cuda)
        before = ce_probs.launches
        with pytest.raises(ValueError, match="does not take"):
            _launch_probs(h, w, lbl, lse, g, "mma")
        assert ce_probs.launches == before
    lse, g = torch.zeros(37, device=cuda), torch.ones(37, device=cuda)
    before = ce_probs.launches
    with pytest.raises(ValueError, match="does not take"):
        _launch_probs(hidden, head, labels, lse, g, "wgmma")
    with pytest.raises(ValueError, match="lse"):
        ce_probs(hidden, head, labels, lse.bfloat16(), g)
    with pytest.raises(ValueError, match="contiguous last axis"):
        ce_probs(hidden.T.contiguous().T, head, labels, lse, g)
    with pytest.raises(ValueError, match="ops.ce_loss_mean"):
        ce_probs(hidden.clone().requires_grad_(), head, labels, lse, g)
    assert ce_probs.launches == before


@pytest.mark.parametrize("chunk", [0, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ce_backward_on_card_matches_cpu(cuda, chunk, dtype):
    """ops.ce_loss_mean's gradients, card against CPU on the same values:
    the same P up to the exp's last bits, then fp32 sums in other orders,
    each gradient rounded to its dtype once: within 1e-3 of each gradient's
    norm. The card launches ce_probs once a chunk and the forward once, in
    bf16 on the tensor-core route, in fp32 on the scalar one."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ce_loss import ce_probs, fused_cross_entropy

    hidden, head, labels = _ce_view(cuda, 300, 64, 1000, "tied", seed=5)
    hidden, head = hidden.to(dtype), head.to(dtype)
    table = head.T.contiguous()
    tc_runs = int(dtype == torch.bfloat16)
    grads = {}
    for dev in (cuda, "cpu"):
        h = hidden.reshape(2, 150, 64).to(dev).clone().requires_grad_()
        t = table.to(dev).clone().requires_grad_()
        n, tc = ce_probs.launches, fused_cross_entropy.tc_launches
        probs_tc = ce_probs.tc_launches
        ops.ce_loss_mean(h, t.T, labels.reshape(2, 150).to(dev), chunk=chunk // 2).backward()
        if dev == cuda:
            n_chunks = -(-300 // (chunk or 300))
            assert ce_probs.launches - n == n_chunks
            assert ce_probs.tc_launches - probs_tc == n_chunks * tc_runs
            assert fused_cross_entropy.tc_launches == tc + tc_runs
        grads[str(dev)] = (h.grad.float().cpu(), t.grad.float().cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert float((got - want).norm() / want.norm()) <= 1e-3


@pytest.mark.parametrize("mask", ["causal", "full", "window"])
@pytest.mark.parametrize("shape", [(1, 37, 4, 2, 64), (2, 300, 8, 1, 256), (1, 2047, 32, 8, 128),
                                   (2, 2048, 8, 1, 256),    # Gemma-2B's training step
                                   (1, 2048, 16, 16, 192)])   # an MLA prefill (V2-Lite)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_lse_matches_plain_version(cuda, mask, shape, dtype):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    B, S, H, K, D = shape
    r = np.random.default_rng(S)
    q = torch.from_numpy(r.normal(size=(B, S, H, D)).astype(np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(r.normal(size=(B, S, K, D)).astype(np.float32)).to(cuda, dtype)
            for _ in range(2))
    causal, window = mask != "full", 100 if mask == "window" else 0
    tc_before = flash_attention.tc_launches
    out, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    assert flash_attention.tc_launches == tc_before + (dtype == torch.bfloat16)
    _, ref_lse = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                     window=window, return_lse=True)
    assert lse.shape == (B, S, H) and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention(q, k, v, causal=causal, window=window))
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * max(1.0, float(ref_lse.abs().max()))


@pytest.mark.parametrize("shape", [(2, 2048, 16, 16, 192), (2, 2048, 28, 4, 128)],
                         ids=["deepseek-v2-lite", "qwen2-vl"])
def test_flash_training_at_the_mla_and_gqa_shapes(cuda, shape):
    """FlashAttention at the training shapes of DeepSeek-V2-Lite (MLA at the
    qk head dim 192) and Qwen2-VL (GQA 28/4 at D = 128), bf16, causal: the
    forward ``ops.mha_flash_train`` runs, on the tensor-core route, within
    one bf16 ulp of the plain fp32 version with its lse within 1e-5; dq,
    dk, dv within 1e-3 rel L2 of the plain backward from the plain
    forward's output and lse."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.models.attention_core import flash_attention_bwd

    B, S, H, K, D = shape
    q, k, v = _flash_case(cuda, B, S, S, H, K, D, torch.bfloat16, seed=D + H)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(H),
                    device=cuda).to(q.dtype)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    ref32, ref_lse = flash_attention_ref(q.float(), k.float(), v.float(), causal=True,
                                         return_lse=True)
    assert _close_to_fp32(out, ref32, float(v.float().abs().max()))
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * max(1.0, float(ref_lse.abs().max()))
    del ref32, ref_lse
    n, tc = flash_attention.launches, flash_attention.tc_launches
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.mha_flash_train(*leaves, causal=True), leaves, g)
    assert flash_attention.launches == n + 1 and flash_attention.tc_launches == tc + 1
    plain_out, plain_lse = flash_attention_ref(q, k, v, causal=True, return_lse=True)
    want = flash_attention_bwd(q, k, v, plain_out, plain_lse, g, causal=True)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-3


@pytest.mark.parametrize("d,V", [(2048, 102_400), (3584, 152_064)],
                         ids=["deepseek-v2-lite", "qwen2-vl"])
def test_ce_at_the_mla_and_vision_heads(cuda, d, V):
    """The CE at the training steps of DeepSeek-V2-Lite and Qwen2-VL (T =
    4096 tokens, their untied (d, V) bf16 heads, contiguous): the forward and
    ``ce_probs`` over one backward chunk of 1,024 tokens on the tensor-core
    route, each against its plain version."""
    from repro_torch.kernels.ce_loss import _route, fused_cross_entropy

    gen = torch.Generator(device=cuda).manual_seed(d)
    hidden = torch.randn((4096, d), generator=gen, device=cuda).bfloat16()
    head = (torch.randn((d, V), generator=gen, device=cuda) / np.sqrt(d)).bfloat16()
    labels = torch.randint(0, V, (4096,), generator=gen, device=cuda, dtype=torch.int32)
    labels[0], labels[-1] = 0, V - 1
    assert _route(hidden, head) == "mma"
    tc = fused_cross_entropy.tc_launches
    _ce_check(hidden, head, labels)
    assert fused_cross_entropy.tc_launches == tc + 1
    assert _probs_check(hidden[:1024], head, labels[:1024].clone(), seed=d) == "mma"


def _guard_calls(cuda):
    from repro_torch.kernels.ce_loss import ce_probs, fused_cross_entropy
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_scan

    w = torch.tensor([0.25, 0.75], device=cuda)
    x = torch.randn((2, 512), device=cuda)
    lo, scale = torch.zeros((2, 1), device=cuda), torch.full((2, 1), 0.1, device=cuda)
    codes = torch.zeros((2, 512), dtype=torch.uint8, device=cuda)
    words = torch.zeros((2, words_per_chunk(512, 1)), dtype=torch.int32, device=cuda)
    idx = torch.tensor([[0, 3], [1, 3]], dtype=torch.int32, device=cuda)
    vals = torch.randn((2, 2), device=cuda)
    mix_idx = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32, device=cuda)
    mix_w = torch.full((2, 2), 0.5, device=cuda)
    q, kv = torch.randn((1, 8, 2, 16), device=cuda), torch.randn((1, 8, 1, 16), device=cuda)
    dt = torch.full((1, 4, 8), 0.05, device=cuda)
    bc = torch.randn((1, 4, 4), device=cuda)
    A, h0 = -torch.ones((8, 4), device=cuda), torch.zeros((1, 8, 4), device=cuda)
    hidden, head, labels = _ce_case(cuda, 8, 16, 40, torch.float32, True)
    return {
        "fedavg_aggregate": (fedavg_aggregate, lambda f: fedavg_aggregate(f(x), w)),
        "quantized_aggregate": (quantized_aggregate, lambda f: quantized_aggregate(
            codes, f(lo), scale, w, chunk=512, levels=255)),
        "packed_quantized_aggregate": (packed_quantized_aggregate,
                                       lambda f: packed_quantized_aggregate(
                                           words, f(lo), scale, w, bits=1, chunk=512, levels=1)),
        "sparse_aggregate": (sparse_aggregate, lambda f: sparse_aggregate(idx, f(vals), w, 4)),
        "gossip_mix": (gossip_mix, lambda f: gossip_mix(f(x), mix_idx, mix_w)),
        "flash_attention": (flash_attention, lambda f: flash_attention(f(q), kv, kv)),
        "ssm_scan": (ssm_scan, lambda f: ssm_scan(dt, bc, bc, f(dt), A, h0)),
        "fused_cross_entropy": (fused_cross_entropy,
                                lambda f: fused_cross_entropy(f(hidden), head, labels)),
        "ce_probs": (ce_probs, lambda f: ce_probs(f(hidden.bfloat16()), head.bfloat16(), labels,
                                                  torch.zeros(8, device=cuda),
                                                  torch.ones(8, device=cuda))),
    }


@pytest.mark.parametrize("name", ["fedavg_aggregate", "quantized_aggregate",
                                  "packed_quantized_aggregate", "sparse_aggregate", "gossip_mix",
                                  "flash_attention", "ssm_scan", "fused_cross_entropy",
                                  "ce_probs"])
def test_grad_guard_refuses_a_differentiable_input_and_launches_nothing(cuda, name):
    wrapper, call = _guard_calls(cuda)[name]
    rg = lambda t: t.clone().requires_grad_()   # noqa: E731
    before = wrapper.launches
    with pytest.raises(ValueError, match="gradient would be dropped"):
        call(rg)
    assert wrapper.launches == before
    with torch.no_grad():
        call(rg)
    assert wrapper.launches == before + 1


def test_training_gradients_on_card_match_cpu(cuda):
    """FusedCrossEntropy (tied head, chunked backward) and FlashAttention
    (GQA, window) in fp32: value and every gradient on the card against the
    same Functions on the CPU (kernels against plain versions)."""
    from repro_torch.kernels import ops

    r = np.random.default_rng(3)
    h = r.normal(size=(2, 37, 64)).astype(np.float32)
    table = (r.normal(size=(1000, 64)) / 8).astype(np.float32)
    labels = r.integers(0, 1000, (2, 37)).astype(np.int32)
    q = r.normal(size=(2, 130, 8, 32)).astype(np.float32)
    k, v = (r.normal(size=(2, 130, 2, 32)).astype(np.float32) for _ in range(2))
    g = r.normal(size=q.shape).astype(np.float32)
    got = {}
    for dev in (cuda, torch.device("cpu")):
        ht, tt = (torch.from_numpy(a).to(dev).requires_grad_() for a in (h, table))
        ce = ops.ce_loss_mean(ht, tt.T, torch.from_numpy(labels).to(dev), chunk=8)
        ce.backward()
        qt, kt, vt = (torch.from_numpy(a).to(dev).requires_grad_() for a in (q, k, v))
        out = ops.mha_flash_train(qt, kt, vt, window=50, q_chunk=64, k_chunk=64)
        out.backward(torch.from_numpy(g).to(dev))
        got[dev.type] = [t.detach().cpu() for t in (ce, ht.grad, tt.grad, out, qt.grad, kt.grad,
                                                     vt.grad)]
    for a, b in zip(got["cuda"], got["cpu"]):
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))


def test_training_round_on_card_matches_cpu(cuda):
    """One FedAvg round (G = 2, H = 2, SGD) of reduced Gemma-2B in fp32 on
    the card against the CPU from the same params and batches; the kernels
    launch G·H times (CE, flash per layer) and once a leaf (the average)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.core import local_sgd
    from repro_torch.kernels.ce_loss import fused_cross_entropy
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import sgd
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = reduced(get_config("gemma-2b"))
    start = TransformerLM(cfg, device="cpu").init(0)
    r = np.random.default_rng(4)
    batches = {k: torch.from_numpy(r.integers(0, cfg.vocab_size, (2, 2, 2, 24)).astype(np.int32))
               for k in ("tokens", "labels")}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = TransformerLM(cfg, device=dev)
        params_g = local_sgd.replicate_for_groups(tree_map(lambda t: t.to(dev), start), 2)
        opt = sgd(0.05)
        step = local_sgd.build_fedavg_round_step(model.train_loss, opt,
                                                 local_sgd.LocalSGDConfig(2, 2))
        c0, f0, a0 = fused_cross_entropy.launches, flash_attention.launches, \
            fedavg_aggregate.launches
        params_g, _, _, m = step(params_g, local_sgd.init_group_states(opt, params_g), None,
                                 tree_map(lambda t: t.to(dev), batches), torch.tensor([1.0, 3.0]))
        out[dev.type] = (float(m["loss"]), [p[0].cpu() - s for p, s in
                                            zip(tree_leaves(params_g), tree_leaves(start))],
                         (fused_cross_entropy.launches - c0, flash_attention.launches - f0,
                          fedavg_aggregate.launches - a0))
    (lg, ug, ng), (lc, uc, nc) = out["cuda"], out["cpu"]
    assert ng == (4, 4 * cfg.n_layers, len(uc)) and nc == (0, 0, 0)
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(ug, uc)) ** 0.5
    den = sum(float((b ** 2).sum()) for b in uc) ** 0.5
    assert num <= 1e-4 * den



def test_training_round_adamw_moments_on_card_match_cpu(cuda):
    """The same round with AdamW, the main path's local optimizer: the loss
    and both groups' moments mu and nu (linear and quadratic in the
    gradients) on the card within 1e-4 of the CPU's, in L2 over the tree."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.core import local_sgd
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import adamw
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = reduced(get_config("gemma-2b"))
    start = TransformerLM(cfg, device="cpu").init(0)
    r = np.random.default_rng(4)
    batches = {k: torch.from_numpy(r.integers(0, cfg.vocab_size, (2, 2, 2, 24)).astype(np.int32))
               for k in ("tokens", "labels")}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = TransformerLM(cfg, device=dev)
        params_g = local_sgd.replicate_for_groups(tree_map(lambda t: t.to(dev), start), 2)
        opt = adamw(1e-3)
        step = local_sgd.build_fedavg_round_step(model.train_loss, opt,
                                                 local_sgd.LocalSGDConfig(2, 2))
        _, inner, _, m = step(params_g, local_sgd.init_group_states(opt, params_g), None,
                              tree_map(lambda t: t.to(dev), batches), torch.tensor([1.0, 3.0]))
        out[dev.type] = (float(m["loss"]), [[t.cpu().double() for t in tree_leaves(x)]
                                            for x in (inner.mu, inner.nu)])
    (lg, mg), (lc, mc) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for got, want in zip(mg, mc):
        num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want)) ** 0.5
        den = sum(float((b ** 2).sum()) for b in want) ** 0.5
        assert num <= 1e-4 * den


def test_ce_split_plan_fills_its_waves(cuda):
    """The CE grid at the training shape, sized from the blocks the card
    holds at once, leaves under 5% of its waves' slots empty."""
    from repro_torch.kernels.ce_loss import TILE, _slots, split_plan

    slots = _slots(cuda, True)
    splits, _ = split_plan(4096, 256_000, slots)
    blocks = (4096 // TILE) * splits
    assert slots >= torch.cuda.get_device_properties(cuda).multi_processor_count
    assert blocks >= 0.95 * -(-blocks // slots) * slots


# ---------------------------------------------------------------------------
# checkpoints on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_restores_onto_the_card_bitwise(cuda, dtype, tmp_path):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint

    r = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(r.normal(size=(33, 7)).astype(np.float32)).to(cuda, dtype),
            "v": [torch.from_numpy(r.normal(size=(5,)).astype(np.float32)).to(cuda)]}
    save_checkpoint(tmp_path, tree, step=4, metadata={"round_idx": 4})
    like = {"w": torch.zeros(33, 7, dtype=dtype, device=cuda),
            "v": [torch.zeros(5, device=cuda)]}
    back, meta = restore_checkpoint(tmp_path, like)
    assert meta == {"round_idx": 4}
    for a, b in ((back["w"], tree["w"]), (back["v"][0], tree["v"][0])):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the superstep lane: one round captured as a CUDA graph, replayed once a round
# ---------------------------------------------------------------------------

# A captured round against an eager one from the same generator state: the
# 2NN plain and q8 rounds run no atomics and must be bitwise equal; top-k
# scatters with fp32 REDs and the CNN's cuDNN backward sums in its own order,
# so those are held to 1e-4 of the round's update in L2.
SUPERSTEP_UPDATE_RTOL = 1e-4
# superstep(20) against 20 x round() on top-k (``replays_vs_rounds``): both
# replay one captured round, but each replay's REDs add in their own order
# and the rounds of SGD after carry the ulps on. Each round's loss is held to
# TOPK_REPLAY_LOSS_RTOL of itself, the final params to TOPK_REPLAY_RTOL of the
# 21 rounds' update in L2. On an H100 five readings of replays_vs_rounds gave
# at most 4.4e-4 and 1.7e-2 (one within 1e-7 and 3e-7): about a tenth and a
# sixth of these limits.
TOPK_REPLAY_LOSS_RTOL = 5e-3
TOPK_REPLAY_RTOL = 1e-1
# The aggregation kernels a superstep lane can reach, by their own names, and
# the one each lane's wrapper launches on its main route.
AGG_KERNELS = ("fedavg_agg_kernel", "qagg_stream_kernel", "qagg_kernel", "packed_qagg_kernel",
               "sparse_agg_fused_kernel", "sparse_agg_kernel")
MAIN_ROUTE_KERNEL = {"fedavg_aggregate": "fedavg_agg_kernel",
                     "quantized_aggregate": "qagg_stream_kernel",
                     "sparse_aggregate": "sparse_agg_fused_kernel"}


def _kernel_records(fn):
    """``fn()`` under torch.profiler: its result and {aggregation kernel:
    records} among the device ops (a replay's launches are seen only here)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    records = {}
    for e in prof.events():
        m = re.match(r"(?:void\s+)?(?:\(anonymous namespace\)::)?(?:\w+::)*(\w+)", e.name)
        if e.device_type == DeviceType.CUDA and m and m.group(1) in AGG_KERNELS:
            records[m.group(1)] = records.get(m.group(1), 0) + 1
    return out, records


def _superstep_engine(cuda, lane, model_name="mnist_2nn", **kw):
    from repro_torch.core import compression as comp
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.core.strategies import FedAvgM
    from repro_torch.data.synthetic import make_image_classification
    from repro_torch.models import paper

    lane_kw = {"plain": {}, "fedavgm": {"strategy": FedAvgM(0.9)},
               "q8": {"codec": comp.quantize_codec(8)},
               "topk": {"codec": comp.topk_codec(0.05)}}[lane]
    n_clients, n_each = (20, 60) if model_name == "mnist_2nn" else (6, 20)
    train, _, _ = make_image_classification(n_clients * n_each, 1, seed=0)
    clients = [(train.x[i * n_each:(i + 1) * n_each], train.y[i * n_each:(i + 1) * n_each])
               for i in range(n_clients)]
    model = getattr(paper, model_name)(device=cuda)
    cfg = FedAvgConfig(C=0.5, E=1, B=10, lr=0.1, lr_decay=0.99, seed=3)
    kw = {"device_sampling": True, **kw}
    return RoundEngine(model.loss, model.init(0), clients, cfg, device=cuda, **lane_kw, **kw)


def _eager_round(eng):
    """One eager round of ``eng``'s lane on clones of its params, its next
    round's inputs drawn as ``round()`` draws them: (params, outer_state,
    metrics), each metric a (1,) tensor. Advances the engine's streams."""
    from repro_torch.core.graphs import run_eager
    from repro_torch.utils.tree import tree_map

    p, o, metrics = run_eager(eng._round_body, tree_map(torch.clone, eng.params),
                              tree_map(torch.clone, eng.outer_state), eng._chunk_inputs(1))
    return p, o, tuple(m[0] for m in metrics)


def _leaves(tree):
    from repro_torch.utils.tree import tree_leaves

    return [t.detach().cpu().double() for t in tree_leaves(tree)]


@pytest.mark.parametrize("model_name,lane,bitwise", [
    ("mnist_2nn", "plain", True), ("mnist_2nn", "q8", True),
    ("mnist_2nn", "topk", False), ("mnist_cnn", "plain", False),
])
def test_captured_round_equals_the_eager_round(cuda, model_name, lane, bitwise):
    eager = _superstep_engine(cuda, lane, model_name)
    start = _leaves(eager.params)
    p, _, (loss,) = _eager_round(eager)
    captured = _superstep_engine(cuda, lane, model_name)
    got = captured.round()["loss"]
    torch.cuda.synchronize()
    assert captured.num_compilations == 1 and captured._graph.graph is not None
    assert torch.equal(captured._gen.get_state(), eager._gen.get_state())
    a, b = _leaves(captured.params), _leaves(p)
    if bitwise:
        assert all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(got, loss)
    else:
        diff = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b)) ** 0.5
        update = sum(float(((y - s) ** 2).sum()) for y, s in zip(b, start)) ** 0.5
        assert diff <= SUPERSTEP_UPDATE_RTOL * update, (diff, update)
        assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))


def replays_vs_rounds(cuda, lane, kernel="fedavg_aggregate", route=None):
    """Two engines of ``lane`` built alike, each warmed up and captured by a
    first round; then ``a.run(20, rounds_per_step=20)`` under torch.profiler
    and 20 x ``b.round()``. Returns what the test holds: the wrapper's
    counters (``route`` the main route's) before and after, the profiler's
    aggregation-kernel records, both loss lists, the largest relative loss
    gap, the final params' gap relative to the 21 rounds' update, whether
    the params are bitwise equal, whether the generator states are. The
    readings behind ``TOPK_REPLAY_*`` come from it:
    ``PYTHONPATH=src:tests python -c "from test_torch_gpu import
    replays_vs_rounds as f; print([f('cuda', 'topk', 'sparse_aggregate')
    ['loss_rel'] for _ in range(5)])"``."""
    wrapper = {"fedavg_aggregate": fedavg_aggregate, "quantized_aggregate": quantized_aggregate,
               "sparse_aggregate": sparse_aggregate}[kernel]
    a, b = _superstep_engine(cuda, lane), _superstep_engine(cuda, lane)
    start = _leaves(a.params)
    a.run(1, rounds_per_step=1)               # warm-up and capture
    b.round()
    counted = (wrapper.launches, route and getattr(wrapper, route))
    h, records = _kernel_records(lambda: a.run(20, rounds_per_step=20))
    per_round = torch.stack([b.round()["loss"] for _ in range(20)]).cpu().tolist()
    torch.cuda.synchronize()
    got = [r.train_loss for r in h.records[1:]]
    pa, pb = _leaves(a.params), _leaves(b.params)
    diff = sum(float(((x - y) ** 2).sum()) for x, y in zip(pa, pb)) ** 0.5
    update = sum(float(((y - s) ** 2).sum()) for y, s in zip(pb, start)) ** 0.5
    return {"engines": (a, b), "counted": counted,
            "counted_after": (wrapper.launches, route and getattr(wrapper, route)),
            "records": records, "losses": got, "per_round": per_round,
            "loss_rel": max(abs(x - y) / abs(y) for x, y in zip(got, per_round)),
            "params_rel": diff / update,
            "params_equal": all(torch.equal(x, y) for x, y in zip(pa, pb)),
            "generators_equal": torch.equal(a._gen.get_state(), b._gen.get_state())}


@pytest.mark.parametrize("lane,kernel,route", [
    ("plain", "fedavg_aggregate", None), ("fedavgm", "fedavg_aggregate", None),
    ("q8", "quantized_aggregate", "stream_launches"),
    ("topk", "sparse_aggregate", "fused_launches"),
])
def test_superstep_is_one_graph_replayed_once_a_round(cuda, lane, kernel, route):
    """superstep(20) == 20 x round() bitwise on the plain, FedAvgM and q8
    lanes, and on top-k every round's loss and the final params within the
    ``TOPK_REPLAY_*`` tolerances; the generator states bitwise on every
    lane; one captured graph over two run calls and a ragged chunk. The
    replays run without the wrappers, whose counters (``route`` the main
    route's) do not move; the profiler's records hold the lane's main-route
    kernel once a replay and no other aggregation kernel."""
    res = replays_vs_rounds(cuda, lane, kernel, route)
    assert res["counted_after"] == res["counted"]
    assert res["records"] == {MAIN_ROUTE_KERNEL[kernel]: 20}
    if lane == "topk":
        assert res["loss_rel"] <= TOPK_REPLAY_LOSS_RTOL, res["loss_rel"]
        assert res["params_rel"] <= TOPK_REPLAY_RTOL, res["params_rel"]
    else:
        assert res["losses"] == res["per_round"] and res["params_equal"]
    assert res["generators_equal"]
    a, b = res["engines"]
    a.run(7, rounds_per_step=5)               # a chunk of 5 and a ragged 2
    assert a.num_compilations == b.num_compilations == 1 and a.round_idx == 28


def test_warm_superstep_makes_no_sync_under_the_transfer_guard(cuda):
    from repro_torch.analysis import retrace_guard, transfer_guard
    from repro_torch.core.strategies import FedAvg

    eng = _superstep_engine(cuda, "plain")
    eng.run(20, rounds_per_step=20)
    with transfer_guard():
        with retrace_guard(lambda: eng.num_compilations):
            hist = eng.run(20, rounds_per_step=20)
    assert len(hist.records) == 40 and all(np.isfinite(r.train_loss) for r in hist.records)

    class SyncingFedAvg(FedAvg):
        """FedAvg whose apply reads a value back: a sync inside the round."""

        def apply(self, opt_state, params, agg_delta):
            float(next(iter(agg_delta.values()))["w"].sum())
            return super().apply(opt_state, params, agg_delta)

    bad = _superstep_engine(cuda, "plain", strategy=SyncingFedAvg())
    with pytest.raises(RuntimeError, match="synchroniz"):
        with transfer_guard():
            bad.run(2, rounds_per_step=2)
    assert bad.round_idx == 0 and bad.num_compilations == 0


def test_superstep_resume_continues_bitwise_on_the_card(cuda, tmp_path):
    whole = _superstep_engine(cuda, "q8")
    whole.run(8, rounds_per_step=4)
    first = _superstep_engine(cuda, "q8")
    first.run(4, rounds_per_step=4)
    first.save(tmp_path)
    resumed = _superstep_engine(cuda, "q8")
    assert resumed.restore(tmp_path) == 4
    resumed.run(4, rounds_per_step=4)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(whole.params), _leaves(resumed.params)))
    assert [r.train_loss for r in whole.history.records] == \
        [r.train_loss for r in resumed.history.records]
    assert torch.equal(whole._gen.get_state(), resumed._gen.get_state())


# ---------------------------------------------------------------------------
# the paper's other models: CIFAR CNN, char-LSTM, word-LSTM
# ---------------------------------------------------------------------------

# A 1-step round card vs CPU in fp32, on the update in L2: the LSTMs sum in
# other orders only (the embedding's backward adds its rows with atomics);
# the CIFAR CNN's 64-channel 5x5 convolutions sum 1,600 products an output
# in cuDNN's order and a max-pool near-tie can route a gradient elsewhere
# (chip_smoke.py measured 2.0e-4 on an H100 at full width, the LSTMs
# 3.7e-7). Over the whole round SGD carries the gaps on (1e-2). A limit
# above 1e-4 is held to an fp64 witness too: both fp32 rounds within it of
# the CPU's fp64 round; the card's fp64 round within PAPER_FP64_RTOL of the
# CPU's (the same function; the loss's softmax stays fp32); the card's fp32
# round with cuDNN off within 1e-4 of it. chip_smoke.py measured the CIFAR
# round on an H100: the CPU's fp32 round 1.9e-6 from fp64, the card's
# 2.0e-4, the card's without cuDNN 1.9e-6, the card's fp64 round 3.7e-8.
PAPER_UPDATE_RTOL_1 = {"char_lstm": 1e-4, "cifar_cnn": 1e-3}
PAPER_FP64_RTOL = 1e-6


def _star_round_fp64(loss_fn, params, batch, mask, weights, lr, device):
    """The raveled global params after one star round in fp64 on
    ``device``: ClientUpdate, then the weighted mean of the deltas in plain
    torch (the kernel takes fp32 and bf16 only)."""
    from repro_torch.core.fedavg import client_update
    from repro_torch.utils.tree import tree_map, tree_ravel

    def f64(t):
        return t.detach().to(device).double() if t.is_floating_point() else t.to(device)

    p64 = tree_map(f64, params)
    trained, _ = client_update(loss_fn, p64, tuple(f64(x) for x in batch), f64(mask), lr)
    w = torch.as_tensor(weights).to(device).double()
    w = w / w.sum()
    new = tree_map(lambda c, p: p + torch.tensordot(w, c - p, dims=1), trained, p64)
    return tree_ravel(tree_map(lambda p: p.cpu(), new))[0]


def _paper_engine(cuda, name, device_sampling=False):
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.data import make_char_corpus, make_image_classification, windows_from_sequence
    from repro_torch.models import paper

    if name == "cifar_cnn":
        train, _, _ = make_image_classification(36, 1, image_shape=(24, 24, 3), seed=0)
        clients = [(train.x[a:b], train.y[a:b]) for a, b in ((0, 12), (12, 21), (21, 36))]
        model = paper.cifar_cnn(device=cuda)
        cfg = FedAvgConfig(C=0.67, E=1, B=4, lr=0.05, seed=0)
    else:
        roles, _, V = make_char_corpus(6, mean_chars_per_role=150, seed=0)
        clients = [windows_from_sequence(t, 10) for t in roles]
        model = paper.char_lstm(V, hidden=32, device=cuda)
        cfg = FedAvgConfig(C=0.5, E=1, B=4, lr=0.5, seed=3)
    eng = RoundEngine(model.loss, model.init(0), clients, cfg, device_sampling=device_sampling,
                      device=cuda)
    return eng, model


@pytest.mark.parametrize("name", ["char_lstm", "cifar_cnn"])
def test_paper_model_round_on_card_matches_round_on_cpu(cuda, name):
    from repro_torch.core.engine import RoundBatch, RoundState, build_simulation_round_step
    from repro_torch.utils.tree import tree_map, tree_ravel

    eng, model = _paper_engine(cuda, name)
    batch, mask, w = eng.materialize_round_batch(np.asarray([0, 2]), generator_seed=5)
    step = build_simulation_round_step(model.loss)
    start = tree_ravel(tree_map(lambda p: p.cpu().double(), eng.params))[0]
    before, card_rounds = fedavg_aggregate.launches, 2
    for n_steps, rtol in ((1, PAPER_UPDATE_RTOL_1[name]), (mask.shape[1], 1e-2)):
        b = tuple(x[:, :n_steps].contiguous() for x in batch)
        msk = mask[:, :n_steps].contiguous()
        got, gm = step(RoundState(eng.params, ()), RoundBatch(b, msk, w, lr=eng.cfg.lr))
        want, wm = step(RoundState(tree_map(lambda p: p.cpu(), eng.params), ()),
                        RoundBatch(tuple(x.cpu() for x in b), msk.cpu(), w, lr=eng.cfg.lr))
        d_card, d_cpu = (tree_ravel(tree_map(lambda p: p.cpu().double(), t))[0] - start
                         for t in (got.params, want.params))
        assert float((d_card - d_cpu).norm()) <= rtol * float(d_cpu.norm())
        assert abs(float(gm["loss"]) - float(wm["loss"])) <= 1e-4 * abs(float(wm["loss"]))
        if n_steps == 1 and rtol > 1e-4:
            d_64, d_64_card = (_star_round_fp64(model.loss, eng.params, b, msk, w, eng.cfg.lr,
                                                dev) - start for dev in ("cpu", cuda))
            for d in (d_card, d_cpu):
                assert float((d - d_64).norm()) <= rtol * float(d_64.norm())
            assert float((d_64_card - d_64).norm()) <= PAPER_FP64_RTOL * float(d_64.norm())
            with torch.backends.cudnn.flags(enabled=False):
                plain, _ = step(RoundState(eng.params, ()), RoundBatch(b, msk, w, lr=eng.cfg.lr))
            card_rounds += 1
            d_plain = tree_ravel(tree_map(lambda p: p.cpu().double(), plain.params))[0] - start
            assert float((d_plain - d_64).norm()) <= 1e-4 * float(d_64.norm())
    assert fedavg_aggregate.launches == before + card_rounds
    eng.run(2)
    assert fedavg_aggregate.launches == before + card_rounds + 2


def test_char_lstm_captured_round_equals_the_eager_round(cuda):
    """A reduced char-LSTM on the superstep lane: one captured round against
    one eager round from the same generator state, within
    SUPERSTEP_UPDATE_RTOL of the update (the embedding's backward adds with
    atomics); then a chunk of 4 replays, one graph."""
    eager, _ = _paper_engine(cuda, "char_lstm", device_sampling=True)
    start = _leaves(eager.params)
    p, _, (loss,) = _eager_round(eager)
    captured, _ = _paper_engine(cuda, "char_lstm", device_sampling=True)
    got = captured.round()["loss"]
    torch.cuda.synchronize()
    assert captured.num_compilations == 1 and captured._graph.graph is not None
    assert torch.equal(captured._gen.get_state(), eager._gen.get_state())
    a, b = _leaves(captured.params), _leaves(p)
    diff = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b)) ** 0.5
    update = sum(float(((y - s) ** 2).sum()) for y, s in zip(b, start)) ** 0.5
    assert diff <= SUPERSTEP_UPDATE_RTOL * update, (diff, update)
    assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))
    hist = captured.run(4, rounds_per_step=4)
    assert captured.num_compilations == 1 and all(np.isfinite(r.train_loss)
                                                  for r in hist.records)


def test_make_eval_fn_on_the_card_scores_lm_labels(cuda):
    """(n, T) labels with a padded tail: the card's loss and accuracy equal
    the CPU's within fp32 sums in other orders."""
    from repro_torch.core.simulation import make_eval_fn
    from repro_torch.models import paper
    from repro_torch.utils.tree import tree_map

    model = paper.char_lstm(20, hidden=16, device=cuda)
    params = model.init(1)
    r = np.random.default_rng(0)
    x, y = (r.integers(0, 20, (37, 9)).astype(np.int32) for _ in range(2))
    got = make_eval_fn(model.apply, x, y, batch_size=8, device=cuda)(params)
    want = make_eval_fn(model.apply, x, y, batch_size=8, device="cpu")(
        tree_map(lambda t: t.cpu(), params))
    assert got["loss"].device.type == "cuda"
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * float(want["loss"])
    assert abs(float(got["acc"]) - float(want["acc"])) <= 1.0 / (37 * 9)


# ---------------------------------------------------------------------------
# the buffered-async lane and the streamed pool on the card
# ---------------------------------------------------------------------------

def _host_engine(cuda, model_name="mnist_2nn", n_clients=20, n_each=60, **kw):
    """A host-sampled engine on the card (C = 0.5, E = 1, B = 10) over
    ``n_clients`` synthetic MNIST clients."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.data.synthetic import make_image_classification
    from repro_torch.models import paper

    train, _, _ = make_image_classification(n_clients * n_each, 1, seed=0)
    clients = [(train.x[i * n_each:(i + 1) * n_each], train.y[i * n_each:(i + 1) * n_each])
               for i in range(n_clients)]
    model = getattr(paper, model_name)(device=cuda)
    cfg = FedAvgConfig(C=0.5, E=1, B=10, lr=0.1, lr_decay=0.99, seed=3)
    return RoundEngine(model.loss, model.init(0), clients, cfg, device=cuda, **kw)


def test_degenerate_async_equals_the_sync_lane_on_the_card(cuda):
    """buffer_k == concurrency == m with zero latency: each apply launches
    ``fedavg_aggregate`` once, and the params equal the sync lane's bit for
    bit after every round; the numpy streams stay in step."""
    from repro_torch.core import AsyncConfig, LatencyModel

    sync = _host_engine(cuda)
    m = sync._m
    asy = _host_engine(cuda, async_config=AsyncConfig(buffer_k=m, concurrency=m),
                       latency=LatencyModel())
    for _ in range(3):
        sync.run(1)
        before = fedavg_aggregate.launches
        asy.run(1)
        assert fedavg_aggregate.launches == before + 1
        assert sync.rng.bit_generator.state == asy.rng.bit_generator.state
        assert all(torch.equal(a, b) for a, b in zip(_leaves(sync.params), _leaves(asy.params)))
    np.testing.assert_allclose([r.train_loss for r in asy.history.records],
                               [r.train_loss for r in sync.history.records], rtol=3e-7)


@pytest.mark.parametrize("model_name,lane", [("mnist_2nn", "plain"), ("mnist_2nn", "q8"),
                                             ("mnist_cnn", "plain")])
def test_streamed_pool_equals_the_device_pool_on_the_card(cuda, model_name, lane, tmp_path):
    """The staged rows are the device gather's bytes and the rest is the same
    round: params and losses bitwise (the CNN under ``cudnn.deterministic``,
    whose default backward is not); prefetch 0 the same again."""
    from repro_torch.core import compression as comp

    kw = {} if lane == "plain" else {"codec": comp.quantize_codec(8)}
    n = (20, 60) if model_name == "mnist_2nn" else (6, 20)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        dev = _host_engine(cuda, model_name, *n, pool="device", **kw)
        st = _host_engine(cuda, model_name, *n, pool="streamed", pool_dir=tmp_path / "a",
                          pool_shard_clients=7, **kw)
        off = _host_engine(cuda, model_name, *n, pool="streamed", pool_dir=tmp_path / "b",
                           prefetch=0, **kw)
        for e in (dev, st, off):
            e.run(3)
    finally:
        torch.backends.cudnn.deterministic = prev
    assert st.pool_kind == "streamed" and st._stager.slots is not None
    for other in (st, off):
        assert all(torch.equal(a, b) for a, b in zip(_leaves(dev.params), _leaves(other.params)))
        assert [r.train_loss for r in other.history.records] == \
            [r.train_loss for r in dev.history.records]


def test_streamed_and_async_loops_make_no_sync_under_the_transfer_guard(cuda, tmp_path):
    """Warm streamed rounds and async applies under ``transfer_guard()``:
    the staging steps and the loss reads are the sanctioned exchanges, and
    nothing else makes the host wait."""
    from repro_torch.analysis import transfer_guard
    from repro_torch.core import AsyncConfig, LatencyModel

    st = _host_engine(cuda, pool="streamed", pool_dir=tmp_path)
    asy = _host_engine(cuda, async_config=AsyncConfig(buffer_k=3),
                       latency=LatencyModel(kind="lognormal", sigma=1.5, dropout=0.1, seed=2))
    st.run(1)
    asy.run(1)
    with transfer_guard():
        hs = st.run(3)
        ha = asy.run(4)
    assert len(hs.records) == 4 and len(ha.records) == 5
    assert all(np.isfinite(r.train_loss) for r in hs.records + ha.records)


@pytest.mark.parametrize("kind", ["ring", "full"])
def test_captured_gossip_rounds_equal_the_eager_rounds(cuda, kind):
    """A 2NN gossip engine on 20 nodes: a chunk of 3 captured rounds against
    3 eager ``round()`` calls of a twin, replicas, losses, consensus and the
    generator bitwise; one graph; the wrappers counted the eager rounds and
    the capture's warm-up, on the route of the plan (the ring's 3 slots for
    20 nodes the gather route, the full graph the dense one)."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.data.synthetic import make_image_classification
    from repro_torch.models import paper

    train, _, _ = make_image_classification(20 * 30, 1, seed=0)
    clients = [(train.x[i * 30:(i + 1) * 30], train.y[i * 30:(i + 1) * 30]) for i in range(20)]
    model = paper.mnist_2nn(device=cuda)
    cfg = FedAvgConfig(C=1.0, E=1, B=10, lr=0.1, seed=3)
    a, b = (RoundEngine(model.loss, model.init(0), clients, cfg, topology=kind, device=cuda)
            for _ in range(2))
    before, dense = gossip_mix.launches, gossip_mix.dense_launches
    eager = [b.round() for _ in range(3)]
    h = a.run(3, eval_every=100, rounds_per_step=3)
    torch.cuda.synchronize()
    assert a.num_compilations == 1 and b.num_compilations == 0
    assert [r.train_loss for r in h.records] == [float(m["loss"]) for m in eager]
    assert [r.consensus for r in h.records] == [float(m["consensus"]) for m in eager]
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a.params), _leaves(b.params)))
    assert torch.equal(a._gen.get_state(), b._gen.get_state())
    assert gossip_mix.launches == before + 4
    assert gossip_mix.dense_launches == dense + (4 if kind == "full" else 0)


def test_lowrank_sketch_on_the_card_is_the_cpus(cuda):
    """The counter-based sketch from the same int64 seeds: the 32-bit words
    bitwise, the Gaussians (fp64 Box-Muller rounded to fp32) within 1e-6."""
    from repro_torch.core import compression as comp

    seeds = torch.randint(0, 2**62, (10,), generator=torch.Generator().manual_seed(5))
    assert torch.equal(comp.sketch_bits(seeds.to(cuda), 4000).cpu(),
                       comp.sketch_bits(seeds, 4000))
    a = comp.lowrank_sketch(seeds.to(cuda), 447, 8).cpu()
    assert float((a - comp.lowrank_sketch(seeds, 447, 8)).abs().max()) <= 1e-6


@pytest.mark.parametrize("lane", ["plain", "q8", "lowrank"])
def test_streamed_superstep_equals_the_device_superstep_on_the_card(cuda, lane, tmp_path):
    """The staged superstep on a small population: chunks of 3 (the last
    ragged) against the device pool's superstep, params, losses and both
    generators bitwise; the staging copies' slots are page-locked; a warm
    chunk makes no sync under ``transfer_guard()``."""
    from repro_torch.analysis import transfer_guard
    from repro_torch.core import compression as comp

    kw = {"plain": {}, "q8": {"codec": comp.quantize_codec(8)},
          "lowrank": {"codec": comp.lowrank_codec(8)}}[lane]
    dev = _host_engine(cuda, device_sampling=True, pool="device", **kw)
    st = _host_engine(cuda, device_sampling=True, pool="streamed", pool_dir=tmp_path,
                      pool_shard_clients=7, **kw)
    dev.run(7, rounds_per_step=3)
    st.run(7, rounds_per_step=3)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(dev.params), _leaves(st.params)))
    assert [r.train_loss for r in st.history.records] == \
        [r.train_loss for r in dev.history.records]
    assert st._stager.chunk_slots[0].host[0].is_pinned()
    with transfer_guard():
        st.run(3, rounds_per_step=3)
    dev.run(3, rounds_per_step=3)
    st._discard_prefetch()
    assert all(torch.equal(a, b) for a, b in zip(_leaves(dev.params), _leaves(st.params)))
    assert torch.equal(dev._ids_gen.get_state(), st._ids_gen.get_state())
    assert torch.equal(dev._gen.get_state(), st._gen.get_state())


def test_a_staged_cohort_is_not_overwritten_before_its_copy(cuda):
    """Three stages back to back through the two page-locked slots: the third
    refills the first slot only after its copy's event, so every staged
    cohort on the card equals its gather, read after all three."""
    from repro_torch.core.staging import CohortStager
    from repro_torch.data.pool import StreamedClientPool
    from repro_torch.data.synthetic import make_image_classification

    train, _, _ = make_image_classification(40 * 50, 1, seed=1)
    clients = [(train.x[i * 50:(i + 1) * 50], train.y[i * 50:(i + 1) * 50]) for i in range(40)]
    pool = StreamedClientPool.build(clients, 10, shard_clients=16)
    st = CohortStager(pool, 8, 5, cuda)
    cohorts = [np.arange(8) + 8 * k for k in range(3)]
    staged = []
    for ids in cohorts:
        mask = np.full((8, 5), float(ids[0]), np.float32)
        staged.append(st.ready(*st.stage(ids, pool.counts[ids], mask)))
    torch.cuda.synchronize()
    for ids, (x, y, n_real, mask) in zip(cohorts, staged):
        gx, gy = pool.gather(ids)
        assert x.device.type == "cuda" and x.cpu().numpy().tobytes() == gx.tobytes()
        assert y.cpu().numpy().tobytes() == gy.tobytes()
        assert n_real.cpu().tolist() == [50] * 8 and float(mask[0, 0]) == float(ids[0])
    assert st.slots[0].host[0].is_pinned() and st.slots[0].event.query()


# ---------------------------------------------------------------------------
# cohort sharding: the four kernels' partial-sum mode on every route, and
# sharded rounds over an NCCL world of one
# ---------------------------------------------------------------------------

# Raw example counts (the non-IID clients' 300-900 examples: sum >> 1), the
# same with two zero-weight ghost rows whose data is 1e4, and an all-zero
# vector (an all-ghost rank of m < D), whose sum must be exactly 0.
PARTIAL_WEIGHTS = ("raw", "ghosts", "zero")


def _partial_weights(cuda, kind, K, seed):
    w = np.random.default_rng(seed).integers(300, 900, K).astype(np.float32)
    if kind == "ghosts":
        w[-2:] = 0.0
    elif kind == "zero":
        w[:] = 0.0
    return torch.from_numpy(w).to(cuda)


def _partial_check(out, ref, w, scale, kind):
    """fp32 sums in another order: 1e-6 of the largest term; all zero exact."""
    if kind == "zero":
        assert torch.equal(out, torch.zeros_like(out))
    tol = 1e-6 * float(w.max()) * scale + 1e-30
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("kind", PARTIAL_WEIGHTS)
@pytest.mark.parametrize("N", [199_210, 1_663_370])
def test_fedavg_partial_sum_mode_matches_plain_version(cuda, kind, N):
    x = torch.randn((10, N), generator=torch.Generator(cuda).manual_seed(N), device=cuda)
    w = _partial_weights(cuda, kind, 10, N)
    if kind == "ghosts":
        x[-2:] = 1e4
    before = (fedavg_aggregate.launches, fedavg_aggregate.partial_launches)
    out = fedavg_aggregate(x, w, normalized=False)
    assert (fedavg_aggregate.launches, fedavg_aggregate.partial_launches) == \
        (before[0] + 1, before[1] + 1)
    _partial_check(out, fedavg_aggregate_ref(x, w), w, float(x[:8].abs().max()), kind)


@pytest.mark.parametrize("kind", PARTIAL_WEIGHTS)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("route", ["stream", "general"])
def test_quantized_partial_sum_mode_matches_plain_version(cuda, kind, bits, route):
    K, chunk, C = 10, 512, 390                       # the 2NN's 199,210 at chunk 512
    g = torch.Generator(cuda).manual_seed(bits)
    if bits == 8:
        payload = torch.randint(0, 256, (K, C * chunk), generator=g, device=cuda).to(torch.uint8)
    else:
        payload = torch.randint(-2**31, 2**31, (K, C * words_per_chunk(chunk, bits)),
                                generator=g, dtype=torch.int32, device=cuda)
    lo = torch.randn((K, C), generator=g, device=cuda)
    scale = torch.rand((K, C), generator=g, device=cuda) * 2
    if kind == "ghosts":
        lo[-2:] = 1e4
    w = _partial_weights(cuda, kind, K, bits)
    levels = 2**bits - 1
    wrapper = quantized_aggregate if bits == 8 else packed_quantized_aggregate
    before = wrapper.partial_launches
    out = _launch(payload, lo, scale, w, _out(payload, lo, chunk), bits=bits, chunk=chunk,
                  levels=levels, route=route, normalized=False)
    assert wrapper.partial_launches == before + 1
    ref = (quantized_aggregate_ref(payload, lo, scale, w, chunk=chunk, levels=levels)
           if bits == 8 else
           packed_quantized_aggregate_ref(payload, lo, scale, w, bits=bits, chunk=chunk,
                                          levels=levels))
    _partial_check(out, ref, w, float(lo[:8].abs().max() + scale[:8].max()), kind)


@pytest.mark.parametrize("kind", PARTIAL_WEIGHTS)
@pytest.mark.parametrize("route", ["fused", "scatter"])
def test_sparse_partial_sum_mode_matches_plain_version(cuda, kind, route):
    K, n = 10, 199_210
    k = n // 20
    g = torch.Generator(cuda).manual_seed(7)
    idx = torch.stack([torch.randperm(n, generator=g, device=cuda)[:k]
                       for _ in range(K)]).to(torch.int32)
    vals = torch.randn((K, k), generator=g, device=cuda)
    if kind == "ghosts":
        vals[-2:] = 1e4
    w = _partial_weights(cuda, kind, K, 7)
    before = sparse_aggregate.partial_launches
    out = sparse_agg._launch(idx, vals, w, torch.empty(n, device=cuda), route, normalized=False)
    assert sparse_aggregate.partial_launches == before + 1
    _partial_check(out, sparse_aggregate_ref(idx, vals, w, n), w,
                   float(vals[:8].abs().max()), kind)


@pytest.fixture(scope="module")
def nccl_mesh():
    """A client mesh over an NCCL world of one, started from a FileStore."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_client_mesh

    started = not dist.is_initialized()
    mesh = make_client_mesh(device="cuda")
    yield mesh
    if started:
        dist.destroy_process_group()


def _shard_engine(cuda, lane, *, device_sampling=False, mesh=None):
    """``_superstep_engine``'s 2NN population, config and lanes, host- or
    device-sampled, sharded over ``mesh`` or not."""
    return _superstep_engine(cuda, lane, device_sampling=device_sampling, mesh=mesh)


# sharded against unsharded on the card: the reference's tolerances
# (tests/test_engine_sharded.py:163-232) on the params and the losses
SHARD_TOL = {"plain": (1e-5, 1e-5), "fedavgm": (1e-5, 1e-5), "q8": (1e-3, 1e-4),
             "topk": (1e-3, 1e-4)}


def _max_param_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.parametrize("lane", sorted(SHARD_TOL))
@pytest.mark.parametrize("device_sampling", [False, True])
def test_nccl_world_of_one_equals_unsharded(cuda, nccl_mesh, lane, device_sampling):
    """A sharded engine over an NCCL world of one against the unsharded one:
    each round launches the lane's kernel once in partial-sum mode (eagerly
    on the host-sampled lane; the superstep's warm-up before its capture),
    and the runs agree within the reference's tolerances, bit for bit on the
    lanes without atomics."""
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate as fa

    kernel = {"q8": quantized_aggregate, "topk": sparse_aggregate}.get(lane, fa)
    base = _shard_engine(cuda, lane, device_sampling=device_sampling)
    shrd = _shard_engine(cuda, lane, device_sampling=device_sampling, mesh=nccl_mesh)
    rps = 4 if device_sampling else None
    hb = base.run(4, rounds_per_step=rps)
    before = kernel.partial_launches
    hs = shrd.run(4, rounds_per_step=rps)
    torch.cuda.synchronize()
    assert kernel.partial_launches - before == (1 if device_sampling else 4)
    param_tol, loss_tol = SHARD_TOL[lane]
    assert max(abs(a.train_loss - b.train_loss)
               for a, b in zip(hb.records, hs.records)) <= loss_tol
    assert _max_param_diff(base.params, shrd.params) <= param_tol
    if lane != "topk":   # a world of one is the unsharded round bit for bit (REDs aside)
        assert [r.train_loss for r in hb.records] == [r.train_loss for r in hs.records]
        assert _max_param_diff(base.params, shrd.params) == 0.0
    if device_sampling:
        assert shrd.num_compilations == 1


def test_sharded_superstep_replays_one_aggregation_and_one_all_reduce(cuda, nccl_mesh):
    """A captured sharded round holds the lane's kernel once a replay in the
    profiler's records; NCCL's all-reduce is recorded beside it at most
    once a replay (a world of one may reduce in place without a kernel)."""
    eng = _shard_engine(cuda, "plain", device_sampling=True, mesh=nccl_mesh)
    eng.run(2, rounds_per_step=2)
    _, records = _kernel_records(lambda: eng._superstep(4))
    assert records == {"fedavg_agg_kernel": 4}


@pytest.mark.parametrize("device_sampling", [False, True])
def test_sharded_loops_make_no_sync_under_the_transfer_guard(cuda, nccl_mesh, device_sampling):
    """The reference's "sharded" and "sharded-superstep" guard cases under
    NCCL: a warm sharded host round and a warm sharded chunk make no sync
    outside the sanctioned staging."""
    from repro_torch.analysis import retrace_guard, transfer_guard

    eng = _shard_engine(cuda, "q8", device_sampling=device_sampling, mesh=nccl_mesh)
    rps = 3 if device_sampling else None
    eng.run(3, rounds_per_step=rps)
    with transfer_guard():
        with retrace_guard(lambda: eng.num_compilations):
            hist = eng.run(3, rounds_per_step=rps)
    assert len(hist.records) == 6 and all(np.isfinite(r.train_loss) for r in hist.records)


def test_a_gloo_group_on_the_card_refuses_the_captured_round(cuda, nccl_mesh):
    """A gloo group's all-reduce copies through the host and cannot be
    captured: device sampling on the card refuses it; the host-sampled lane
    takes it."""
    import torch.distributed as dist

    gloo = dist.new_group(backend="gloo")

    class GlooMesh:
        mesh_dim_names, ndim = ("clients",), 1

        def get_group(self, axis):
            return gloo

        def size(self):
            return 1

        def get_local_rank(self, axis):
            return 0

    with pytest.raises(ValueError, match="gloo"):
        _shard_engine(cuda, "plain", device_sampling=True, mesh=GlooMesh())
    base = _shard_engine(cuda, "plain")
    shrd = _shard_engine(cuda, "plain", mesh=GlooMesh())
    base.run(2), shrd.run(2)
    assert _max_param_diff(base.params, shrd.params) <= 1e-5
