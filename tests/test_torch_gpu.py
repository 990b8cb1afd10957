"""repro_torch's CUDA kernel against its plain version, on the card.

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
