"""repro_torch's round step and RoundEngine held against the reference.

Exact checks inject the reference's own batches
(``RoundEngine.materialize_round_batch``) and its own ``init`` weights.
Whole runs draw their batch permutations from a torch generator, so they
are compared on rounds-to-target within a band, never bitwise."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FedAvgConfig as RefConfig  # noqa: E402
from repro.core import RoundEngine as RefEngine  # noqa: E402
from repro.core.engine import History as RefHistory  # noqa: E402
from repro.core.engine import RoundBatch as RefBatch  # noqa: E402
from repro.core.engine import RoundRecord as RefRecord  # noqa: E402
from repro.core.engine import RoundState as RefState  # noqa: E402
from repro.core.engine import build_simulation_round_step as ref_round_step  # noqa: E402
from repro.core.simulation import make_eval_fn as ref_make_eval_fn  # noqa: E402
from repro.core.strategies import FedAvg as RefFedAvg  # noqa: E402
from repro.core.strategies import resolve_strategy as ref_resolve_strategy  # noqa: E402
from repro.models import paper as ref_paper  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    History,
    RoundBatch,
    RoundEngine,
    RoundRecord,
    RoundState,
    build_simulation_round_step,
)
from repro_torch.core.fedavg import FedAvgConfig  # noqa: E402
from repro_torch.core.simulation import make_eval_fn  # noqa: E402
from repro_torch.core.strategies import FedAvg, resolve_strategy  # noqa: E402
from repro_torch.data.partition import partition_pathological_noniid  # noqa: E402
from repro_torch.data.synthetic import make_image_classification  # noqa: E402
from repro_torch.models import paper  # noqa: E402
from repro_torch.utils.tree import tree_paths  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _models(name):
    if name == "2nn":
        return (ref_paper.mnist_2nn(n_classes=5, d_in=20),
                paper.mnist_2nn(n_classes=5, d_in=20, device="cpu"))
    return ref_paper.mnist_cnn(), paper.mnist_cnn(device="cpu")


def _clients(name, sizes, seed=0):
    if name == "cnn":
        tr, _, _ = make_image_classification(sum(sizes), 1, seed=seed)
        cuts = np.cumsum(sizes)[:-1]
        return list(zip(np.split(tr.x, cuts), np.split(tr.y, cuts)))
    r = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        x = r.normal(size=(n, 20)).astype(np.float32)
        y = r.choice([i % 5, (i + 1) % 5], n).astype(np.int32)
        out.append((x, y))
    return out


# ---------------------------------------------------------------------------
# one round step on the reference's own batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,sizes,cfg", [
    ("2nn", [9, 24, 17, 40], dict(C=0.75, E=2, B=8, lr=0.2, seed=7)),
    # m=2 clients, B=4, 3 steps of which client 0's last is masked
    ("cnn", [8, 11, 6], dict(C=0.67, E=1, B=4, lr=0.05, seed=3)),
])
def test_round_step_matches_reference(name, sizes, cfg):
    ref_model, model = _models(name)
    clients = _clients(name, sizes)
    jp = ref_model.init(jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.array, jp), model, device="cpu")
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**cfg), interpret=True)
    ids, _, key, lr = ref._next_round_inputs()
    batch, mask, w = ref.materialize_round_batch(ids, key)
    assert (np.asarray(mask) == 0).any()     # a padded step is a no-op on both sides

    want, wm = ref_round_step(ref_model.loss, interpret=True, strategy=RefFedAvg())(
        RefState(jp), RefBatch(batch, mask, w, lr=lr))
    got, gm = build_simulation_round_step(model.loss, strategy=FedAvg())(
        RoundState(tp, outer_state=()),
        RoundBatch(tuple(torch.from_numpy(np.array(b)) for b in batch),
                   torch.from_numpy(np.array(mask)), torch.from_numpy(np.array(w)),
                   lr=float(lr)))
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]), rtol=1e-5, atol=1e-5)
    got_np = params_to_numpy(got.params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want.params)[0]:
        g = got_np
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, np.asarray(leaf), rtol=1e-5, atol=1e-5)
    assert got.outer_state == ()


# ---------------------------------------------------------------------------
# the engine's host stream and batch assembly
# ---------------------------------------------------------------------------

def test_cohort_ids_match_reference_for_five_rounds():
    clients = _clients("2nn", [12, 5, 30, 8, 19, 7, 22, 10, 9, 14])
    ref_model, model = _models("2nn")
    cfg = dict(C=0.3, E=1, B=4, lr=0.1, seed=11)
    ref = RefEngine(ref_model.loss, ref_model.init(jax.random.PRNGKey(0)), clients,
                    RefConfig(**cfg), interpret=True)
    eng = RoundEngine(model.loss, model.init(0), clients, FedAvgConfig(**cfg), device="cpu")
    for _ in range(5):
        want_ids = np.asarray(ref._next_round_inputs()[0])
        got_ids = eng._next_round_inputs()[0]
        np.testing.assert_array_equal(got_ids, want_ids)
    # round() consumes the stream exactly as _next_round_inputs does
    eng2 = RoundEngine(model.loss, model.init(0), clients, FedAvgConfig(**cfg), device="cpu")
    for _ in range(5):
        eng2.round()
    assert eng2.rng.bit_generator.state == ref.rng.bit_generator.state
    assert eng2.round_idx == 5


def test_batch_assembly_covers_each_real_row_once_per_epoch():
    # client k's rows hold k*1000 + row index, so every gathered value names its row
    sizes = [25, 40, 7]
    clients = [(np.arange(n, dtype=np.float32)[:, None] + 1000.0 * k,
                np.zeros(n, np.int32)) for k, n in enumerate(sizes)]
    cfg = dict(C=1.0, E=3, B=5, lr=0.1, seed=0)
    model = paper.mnist_2nn(n_classes=2, d_in=1, device="cpu")
    eng = RoundEngine(model.loss, model.init(0), clients, FedAvgConfig(**cfg), device="cpu")
    ref_model = ref_paper.mnist_2nn(n_classes=2, d_in=1)
    ref = RefEngine(ref_model.loss, ref_model.init(jax.random.PRNGKey(0)), clients,
                    RefConfig(**cfg), interpret=True)
    ids = np.asarray([2, 0, 1])
    (bx, by), mask, w = eng.materialize_round_batch(ids, generator_seed=123)
    _, rmask, rw = ref.materialize_round_batch(jnp.asarray(ids, jnp.int32),
                                               jax.random.PRNGKey(0))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    spe, B = eng.packed.max_real_steps_per_epoch, eng.packed.batch_size
    assert bx.shape == (3, 3 * spe, B, 1) and by.shape == (3, 3 * spe, B)
    for slot, k in enumerate(ids):
        n_k = sizes[k]
        active = int(mask[slot, :spe].sum())
        assert active == -(-n_k // B)
        for e in range(3):
            vals = bx[slot, e * spe: e * spe + active].reshape(-1).numpy()
            first = np.sort(vals[:n_k]) - 1000.0 * k
            np.testing.assert_array_equal(first, np.arange(n_k))   # each real row once
            assert set((vals[n_k:] - 1000.0 * k).tolist()) <= set(range(n_k))
    # the permutation is the generator's: same seed, same batches
    again = eng.materialize_round_batch(ids, generator_seed=123)[0][0]
    assert torch.equal(again, bx)


# ---------------------------------------------------------------------------
# whole runs: rounds-to-target within a band of the reference
# ---------------------------------------------------------------------------

def test_noniid_2nn_run_reaches_target_within_band_of_reference():
    """Same data, same init, same cohorts; only the batch permutations
    differ. Band: rounds-to-target within 25% (at least 2 rounds) and
    every evaluated accuracy within 0.05 of the reference's."""
    tr, te, _ = make_image_classification(1200, 400, seed=0)
    part = partition_pathological_noniid(tr.y, 20, seed=0)
    clients = [(tr.x[i], tr.y[i]) for i in part.client_indices]
    ref_model, model = ref_paper.mnist_2nn(), paper.mnist_2nn(device="cpu")
    jp = ref_model.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.array, jp), model, device="cpu")
    cfg = dict(C=0.2, E=2, B=10, lr=0.05, seed=0)
    target = 0.8
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**cfg),
                    eval_fn=ref_make_eval_fn(ref_model.apply, te.x, te.y), interpret=True)
    eng = RoundEngine(model.loss, tp, clients, FedAvgConfig(**cfg),
                      eval_fn=make_eval_fn(model.apply, te.x, te.y, device="cpu"),
                      device="cpu")
    want = ref.run(20, target_acc=target).rounds_to_target(target)
    got = eng.run(20, target_acc=target).rounds_to_target(target)
    assert want is not None and got is not None
    assert abs(got - want) <= max(2.0, 0.25 * want), (got, want)
    for a, b in zip(eng.history.accuracy_curve(), ref.history.accuracy_curve()):
        assert a[0] == b[0] and abs(a[1] - b[1]) <= 0.05, (a, b)
    assert all(np.isfinite(r.train_loss) and r.wall_s > 0 for r in eng.history.records)


def test_run_evaluates_final_round_and_validates_arguments():
    clients = _clients("2nn", [16, 24])
    _, model = _models("2nn")
    eng = RoundEngine(model.loss, model.init(0), clients,
                      FedAvgConfig(C=1.0, E=1, B=8, lr=0.1, seed=0),
                      eval_fn=lambda p: {"acc": 0.5, "loss": 1.0}, device="cpu")
    eng.run(2, eval_every=5)
    eng.run(2, eval_every=5)
    assert [r.test_acc for r in eng.history.records] == [None, 0.5, None, 0.5]
    with pytest.raises(ValueError, match="eval_every"):
        eng.run(1, eval_every=0)
    bare = RoundEngine(model.loss, model.init(0), clients,
                       FedAvgConfig(C=1.0, E=1, B=8, lr=0.1, seed=0), device="cpu")
    with pytest.raises(ValueError, match="eval_fn"):
        bare.run(1, target_acc=0.9)


def test_engine_keeps_a_private_copy_of_params():
    clients = _clients("2nn", [16, 24])
    _, model = _models("2nn")
    init = model.init(0)
    before = init["fc1"]["w"].clone()
    eng = RoundEngine(model.loss, init, clients,
                      FedAvgConfig(C=1.0, E=1, B=8, lr=0.1, seed=0), device="cpu")
    eng.round()
    assert torch.equal(init["fc1"]["w"], before)
    assert not torch.equal(eng.params["fc1"]["w"], before)
    assert tree_paths(eng.params) == tree_paths(init)


def test_round_engine_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    _, model = _models("2nn")
    with pytest.raises(RuntimeError, match="cuda"):
        RoundEngine(model.loss, model.init(0), _clients("2nn", [8, 8]), FedAvgConfig())


# ---------------------------------------------------------------------------
# strategies and history
# ---------------------------------------------------------------------------

def test_only_fedavg_is_ported():
    """Every strategy of the reference resolves now: each registry name to
    that strategy with its defaults, by the reference's identity string."""
    assert isinstance(resolve_strategy(None), FedAvg)
    assert isinstance(resolve_strategy("fedavg"), FedAvg)
    s = FedAvg()
    assert resolve_strategy(s) is s
    for name in ("fedsgd", "fedavgm", "fedasync"):
        got = resolve_strategy(name)
        assert got.kind == name and got.name == ref_resolve_strategy(name).name
    p = {"a": {"w": torch.ones(3)}}
    _, new = FedAvg().apply((), p, {"a": {"w": torch.full((3,), 0.5)}})
    assert torch.equal(new["a"]["w"], torch.full((3,), 1.5))


@pytest.mark.parametrize("curve", [
    [(1, 0.95)],                                   # first point already crosses
    [(1, 0.2), (2, 0.6), (3, 0.5), (4, 0.95)],     # interpolated, non-monotone
    [(2, 0.1), (4, 0.3)],                          # never crosses
    [(1, 0.5), (2, 0.9), (3, 0.9)],                # exact hit
])
def test_rounds_to_target_matches_reference(curve):
    got = History([RoundRecord(r, 0.0, test_acc=a) for r, a in curve])
    want = RefHistory([RefRecord(r, 0.0, test_acc=a) for r, a in curve])
    assert got.rounds_to_target(0.9) == want.rounds_to_target(0.9)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _imported_roots(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def _forbidden(source: str):
    return [(root, line) for root, line in _imported_roots(ast.parse(source))
            if root in ("jax", "jaxlib", "repro", "msgpack")]


def test_port_imports_no_jax_and_nothing_of_repro():
    """Nor msgpack: the card's machine has none (``checkpoint.msgpack_lite``)."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for root, line in _forbidden(f.read_text())]
    assert bad == []
    # the check itself catches every spelling, and tells repro_torch from repro
    probe = ("import jax\nimport jax.numpy as jnp\nfrom jax import lax\n"
             "import repro.core\nfrom repro.data import batching\nfrom repro import core\n"
             "import msgpack\nfrom msgpack import packb\n")
    assert [line for _, line in _forbidden(probe)] == [1, 2, 3, 4, 5, 6, 7, 8]
    assert _forbidden("import repro_torch\nfrom repro_torch.core import engine\n") == []
