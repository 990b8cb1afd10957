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
from repro_torch.kernels.quantized_agg import (  # noqa: E402
    dequantize_ref,
    packed_quantized_aggregate,
    packed_quantized_aggregate_ref,
    quantized_aggregate,
    quantized_aggregate_ref,
)
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


@pytest.mark.parametrize("K", [1, 2, 10, 17])
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
    before = quantized_aggregate.launches
    out = quantized_aggregate(codes, lo, scale, w, chunk=chunk, levels=levels)
    torch.cuda.synchronize()
    assert quantized_aggregate.launches == before + 1
    assert out.shape == (C * chunk,) and out.dtype == torch.float32
    ref = quantized_aggregate_ref(codes, lo, scale, w, chunk=chunk, levels=levels)
    # fp32 sums over K rows in another order (fma): 1e-6 of the largest term
    term = float(dequantize_ref(codes, lo, scale, chunk=chunk, levels=levels).abs().max())
    assert float((out - ref).abs().max()) <= 1e-6 * term


@pytest.mark.parametrize("bits", range(1, 16))
@pytest.mark.parametrize("K,N,chunk", [(1, 1000, 512), (17, 250, 30), (10, 199_210, 512)])
def test_packed_kernel_matches_plain_version(cuda, bits, K, N, chunk):
    C = -(-N // chunk)
    g = torch.Generator(device=cuda).manual_seed(bits * K)
    words = torch.randint(-2**31, 2**31, (K, C * words_per_chunk(chunk, bits)),
                          generator=g, dtype=torch.int32, device=cuda)
    lo, scale = _ranges(cuda, K, C, seed=bits)
    w = _weights(cuda, K)
    kw = dict(bits=bits, chunk=chunk, levels=2**bits - 1)
    before = packed_quantized_aggregate.launches
    out = packed_quantized_aggregate(words, lo, scale, w, **kw)
    torch.cuda.synchronize()
    assert packed_quantized_aggregate.launches == before + 1
    ref = packed_quantized_aggregate_ref(words, lo, scale, w, **kw)
    term = float((lo.abs() + scale.abs()).max())
    assert out.shape == (C * chunk,)
    assert float((out - ref).abs().max()) <= 1e-6 * term


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
    before = sparse_aggregate.launches
    out = sparse_aggregate(idx, vals, w, n)
    torch.cuda.synchronize()
    assert sparse_aggregate.launches == before + 1
    ref = sparse_aggregate_ref(idx, vals, w, n)
    # atomic adds in a run-dependent order: within 1e-6 of the largest term
    assert float((out - ref).abs().max()) <= 1e-6 * float(vals.float().abs().max())


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

    def encode(seed, flat):
        box["payloads"] = codec.encode(seed, flat)
        return box["payloads"]

    def aggregate(payloads, weights, n):
        box.update(out=codec.aggregate(payloads, weights, n), weights=weights, n=n)
        return box["out"]

    eng = RoundEngine(model.loss, model.init(0), clients,
                      FedAvgConfig(C=0.67, E=1, B=4, lr=0.05, seed=0),
                      codec=codec._replace(encode=encode, aggregate=aggregate), device=cuda)
    before = None if kernel is None else kernel.launches
    hist = eng.run(2)
    torch.cuda.synchronize()
    assert all(np.isfinite(r.train_loss) for r in hist.records)
    if kernel is not None:
        assert kernel.launches == before + 2
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
