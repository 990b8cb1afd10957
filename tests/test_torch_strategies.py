"""repro_torch's server strategies held against the reference's.

The strategies' arithmetic is compared on the same numpy trees; whole rounds
on the reference's own injected batches (``RoundEngine.materialize_round_batch``)
and its own ``init`` weights, at the reference's 1e-5. Also the engine
repairs that came with them: a callable ``lr``, ``RoundRecord.sim_s`` and
``validate_cfg`` at construction."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FedAvgConfig as RefConfig  # noqa: E402
from repro.core import RoundEngine as RefEngine  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro.core.engine import RoundBatch as RefBatch  # noqa: E402
from repro.core.engine import RoundRecord as RefRecord  # noqa: E402
from repro.core.engine import RoundState as RefState  # noqa: E402
from repro.core.engine import build_simulation_round_step as ref_round_step  # noqa: E402
from repro.models import paper as ref_paper  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import strategies  # noqa: E402
from repro_torch.core.compression import quantize_codec  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    RoundBatch,
    RoundEngine,
    RoundRecord,
    RoundState,
    build_simulation_round_step,
)
from repro_torch.core.fedavg import FedAvgConfig  # noqa: E402
from repro_torch.core.strategies import (  # noqa: E402
    FedAsync,
    FedAvg,
    FedAvgM,
    FedSGD,
    resolve_strategy,
    strategy_from_json,
    strategy_to_json,
)
from repro_torch.models import paper  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)


def _clients(sizes, seed=1234):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(n, 16)).astype(np.float32),
             r.integers(0, 5, n).astype(np.int32)) for n in sizes]


def _models():
    return (ref_paper.mnist_2nn(n_classes=5, d_in=16),
            paper.mnist_2nn(n_classes=5, d_in=16, device="cpu"))


def _ref_twin(s):
    """The reference's strategy of the same kind and hyper-parameters."""
    return ref_strategies.STRATEGIES[s.kind](**dataclasses.asdict(s))


def _tree(seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return {"fc1": {"b": r.normal(size=(7,)).astype(dtype),
                    "w": r.normal(size=(5, 7)).astype(dtype)},
            "out": {"w": r.normal(size=(7, 3)).astype(dtype)}}


def _close(port_tree, ref_tree, atol):
    """Leaves in jax.tree order on both sides, compared in fp64."""
    got = [t.detach().double().numpy() for t in tree_leaves(port_tree)]
    want = [np.asarray(x, np.float64) for x in jax.tree.leaves(ref_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------------------------------
# the strategies' arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("momentum,server_lr", [(0.9, 1.0), (0.5, 0.7), (0.0, 1.0)])
def test_fedavgm_apply_matches_reference_over_three_steps(momentum, server_lr):
    port, ref = FedAvgM(momentum, server_lr), ref_strategies.FedAvgM(momentum, server_lr)
    p0 = _tree(0)
    tp = {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()} for k, v in p0.items()}
    jp = jax.tree.map(jnp.asarray, p0)
    tv, jv = port.init_state(tp), ref.init_state(jp)
    assert all(v.dtype == torch.float32 and not v.any() for v in tree_leaves(tv))
    for step in range(3):
        d = _tree(10 + step)
        tv, tp = port.apply(tv, tp, {k: {n: torch.from_numpy(a) for n, a in v.items()}
                                     for k, v in d.items()})
        jv, jp = ref.apply(jv, jp, jax.tree.map(jnp.asarray, d))
        _close(tp, jp, 1e-6)
        _close(tv, jv, 1e-6)


def test_fedavgm_keeps_an_fp32_velocity_and_the_params_dtypes():
    p = {"a": torch.ones(4, dtype=torch.bfloat16), "b": torch.ones(2)}
    s = FedAvgM()
    v = s.init_state(p)
    assert v["a"].dtype == torch.float32 and v["b"].dtype == torch.float32
    v, new = s.apply(v, p, {"a": torch.full((4,), 0.25), "b": torch.full((2,), 0.5)})
    assert new["a"].dtype == torch.bfloat16 and new["b"].dtype == torch.float32
    assert torch.equal(v["a"], torch.full((4,), 0.25))


@pytest.mark.parametrize("exp", [0.0, 0.5, 1.0, 2.0])
def test_fedasync_staleness_scale_matches_reference(exp):
    s = np.random.default_rng(0).integers(0, 40, 64).astype(np.float32)
    got = FedAsync(staleness_exp=exp).staleness_scale(torch.from_numpy(s)).numpy()
    want = np.asarray(ref_strategies.FedAsync(staleness_exp=exp).staleness_scale(jnp.asarray(s)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    ones = FedAvg().staleness_scale(torch.from_numpy(s))
    assert torch.equal(ones, torch.ones(64))


def test_fedasync_apply_matches_reference():
    p0, d = _tree(0), _tree(1)
    tp = {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()} for k, v in p0.items()}
    st, new = FedAsync(server_lr=0.3).apply((), tp, {k: {n: torch.from_numpy(a) for n, a in v.items()}
                                                    for k, v in d.items()})
    _, want = ref_strategies.FedAsync(server_lr=0.3).apply(
        (), jax.tree.map(jnp.asarray, p0), jax.tree.map(jnp.asarray, d))
    assert st == ()
    _close(new, want, 1e-6)


# ---------------------------------------------------------------------------
# the registry, the wire form and the checkpoint identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [FedAvg(), FedSGD(), FedAvgM(), FedAvgM(0.37, 2.0), FedAsync(),
                               FedAsync(0.25, 0.5)], ids=lambda s: s.name)
def test_strategy_json_and_name_match_reference(s):
    ref = _ref_twin(s)
    assert strategy_to_json(s) == ref_strategies.strategy_to_json(ref)
    assert s.name == ref.name
    back = strategy_from_json(strategy_to_json(s))
    assert back == s and type(back) is type(s)
    assert strategy_from_json(ref_strategies.strategy_to_json(ref)) == s


def test_resolve_strategy_matches_reference_registry():
    assert sorted(strategies.STRATEGIES) == sorted(ref_strategies.STRATEGIES)
    for kind in strategies.STRATEGIES:
        assert resolve_strategy(kind).name == ref_strategies.resolve_strategy(kind).name
    assert resolve_strategy("fedavgm").name == '{"kind": "fedavgm", "momentum": 0.9, "server_lr": 1.0}'
    assert resolve_strategy(None) == FedAvg()
    s = FedAvgM(0.1)
    assert resolve_strategy(s) is s
    with pytest.raises(ValueError, match="unknown server strategy"):
        resolve_strategy("fedyogi")
    with pytest.raises(ValueError, match="unknown server strategy"):
        strategy_from_json({"kind": "fedyogi"})
    with pytest.raises(TypeError):
        resolve_strategy(42)
    with pytest.raises(dataclasses.FrozenInstanceError):
        FedAvgM().momentum = 0.0


# ---------------------------------------------------------------------------
# the strategies in the engine
# ---------------------------------------------------------------------------

def _engine(strategy=None, codec=None, cfg=None, **kw):
    _, model = _models()
    cfg = cfg or FedAvgConfig(C=0.5, E=2, B=8, lr=0.1, seed=0)
    return RoundEngine(model.loss, model.init(0), _clients([16, 8, 24, 16]), cfg,
                       strategy=strategy, codec=codec, device="cpu", **kw)


@pytest.mark.parametrize("lane", ["plain", "q8"])
def test_fedavgm_zero_momentum_is_fedavg_bit_for_bit(lane):
    """The mirror of tests/test_strategies.py: momentum 0, server_lr 1 is
    FedAvg's step exactly, round for round, on the plain and codec lanes."""
    codec = quantize_codec(8, chunk=256) if lane == "q8" else None
    a = _engine(FedAvg(), codec)
    b = _engine(FedAvgM(momentum=0.0, server_lr=1.0), codec)
    for _ in range(4):
        assert float(a.round()["loss"]) == float(b.round()["loss"])
    assert _equal(a.params, b.params)
    assert not _equal(a.params, _engine().params)


@pytest.mark.parametrize("E,B", [(5, None), (1, 10), (5, 10)])
def test_fedsgd_vetoes_a_non_fedsgd_config(E, B):
    cfg = FedAvgConfig(C=0.5, E=E, B=B, lr=0.5, seed=0)
    with pytest.raises(ValueError, match="FedSGD strategy requires"):
        _engine(FedSGD(), cfg=cfg)
    ref_model = _models()[0]
    with pytest.raises(ValueError, match="FedSGD strategy requires"):
        RefEngine(ref_model.loss, ref_model.init(jax.random.PRNGKey(0)), _clients([16, 8]),
                  RefConfig(C=0.5, E=E, B=B, lr=0.5), interpret=True,
                  strategy=ref_strategies.FedSGD())


def test_fedsgd_runs_at_its_config_and_validate_cfg_runs_before_init_state():
    eng = _engine(FedSGD(), cfg=FedAvgConfig(C=0.5, E=1, B=None, lr=0.5, seed=0))
    assert np.isfinite(float(eng.round()["loss"]))

    @dataclasses.dataclass(frozen=True)
    class Vetoing(FedAvgM):
        def validate_cfg(self, cfg):
            raise ValueError("veto")

        def init_state(self, params):
            raise AssertionError("init_state ran before validate_cfg")

    with pytest.raises(ValueError, match="veto"):
        _engine(Vetoing())


def _ref_and_port(strategy, cfg):
    ref_model, model = _models()
    jp = ref_model.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.array, jp), model, device="cpu")
    clients = _clients([16, 8, 24, 16, 12])
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**cfg), interpret=True,
                    strategy=_ref_twin(strategy))
    return ref, ref_model, model, jp, tp


@pytest.mark.parametrize("strategy,cfg", [
    (FedAvgM(0.9), dict(C=0.6, E=2, B=8, lr=0.1, seed=5)),
    (FedAvgM(0.5, server_lr=0.7), dict(C=0.6, E=1, B=4, lr=0.2, seed=2)),
    (FedSGD(), dict(C=0.6, E=1, B=None, lr=0.5, seed=1)),
    (FedAsync(server_lr=0.6), dict(C=0.4, E=1, B=8, lr=0.1, seed=4)),
], ids=lambda v: getattr(v, "kind", ""))
def test_strategy_rounds_match_reference_on_injected_batches(strategy, cfg):
    """Three chained rounds on the reference's batches: params and the
    server state (FedAvgM's velocity) within the reference's 1e-5."""
    ref, ref_model, model, jp, tp = _ref_and_port(strategy, cfg)
    rstep = ref_round_step(ref_model.loss, interpret=True, strategy=_ref_twin(strategy))
    pstep = build_simulation_round_step(model.loss, strategy=strategy)
    rstate = RefState(jp, outer_state=_ref_twin(strategy).init_state(jp))
    pstate = RoundState(tp, outer_state=strategy.init_state(tp))
    for _ in range(3):
        ids, _, key, lr = ref._next_round_inputs()
        batch, mask, w = ref.materialize_round_batch(ids, key)
        rstate, rm = rstep(rstate, RefBatch(batch, mask, w, lr=lr))
        pstate, pm = pstep(pstate, RoundBatch(
            tuple(torch.from_numpy(np.array(b)) for b in batch),
            torch.from_numpy(np.array(mask)), torch.from_numpy(np.array(w)), lr=float(lr)))
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=1e-5, atol=1e-5)
        _close(pstate.params, rstate.params, 1e-5)
        _close(pstate.outer_state, rstate.outer_state, 1e-5)
    assert len(tree_leaves(pstate.outer_state)) == (6 if strategy.kind == "fedavgm" else 0)


def test_gossip_lane_takes_only_identity_strategies():
    _, model = _models()
    cfg = FedAvgConfig(C=1.0, E=1, B=None, lr=0.1, seed=0)
    for s in (FedAvgM(), FedAsync()):
        with pytest.raises(ValueError, match=r"Use FedAvg/FedSGD \(identity\)"):
            RoundEngine(model.loss, model.init(0), _clients([8, 8, 8]), cfg, strategy=s,
                        topology="ring", device="cpu")
    eng = RoundEngine(model.loss, model.init(0), _clients([8, 8, 8]), cfg, strategy=FedSGD(),
                      topology="ring", device="cpu")
    assert np.isfinite(float(eng.round()["loss"]))


# ---------------------------------------------------------------------------
# engine repairs: callable lr, RoundRecord.sim_s
# ---------------------------------------------------------------------------

def test_callable_lr_is_the_whole_schedule_as_in_the_reference():
    def sched(r):
        return 0.1 * 0.5**r

    ref_model, model = _models()
    clients = _clients([16, 8, 24, 16])
    for decay in (1.0, 0.9):
        eng = RoundEngine(model.loss, model.init(0), clients,
                          FedAvgConfig(C=0.5, E=1, B=8, lr=sched, lr_decay=decay, seed=0),
                          device="cpu")
        ref = RefEngine(ref_model.loss, ref_model.init(jax.random.PRNGKey(0)), clients,
                        RefConfig(C=0.5, E=1, B=8, lr=sched, lr_decay=decay, seed=0),
                        interpret=True)
        assert [eng.lr_at(r) for r in range(5)] == [ref.lr_at(r) for r in range(5)]
        assert [eng.lr_at(r) for r in range(5)] == [sched(r) for r in range(5)]
    hist = eng.run(2)
    assert all(np.isfinite(r.train_loss) for r in hist.records)
    scalar = _engine(cfg=FedAvgConfig(C=0.5, E=1, B=8, lr=0.2, lr_decay=0.5, seed=0))
    assert [scalar.lr_at(r) for r in range(3)] == [0.2, 0.1, 0.05]


def test_round_record_fields_are_the_reference_fields_in_order():
    names = [f.name for f in dataclasses.fields(RoundRecord)]
    assert names == [f.name for f in dataclasses.fields(RefRecord)]
    assert names.index("sim_s") == names.index("consensus") - 1
    ref = dataclasses.asdict(RefRecord(3, 0.5, test_acc=0.9, wall_s=1.0, sim_s=2.5))
    assert RoundRecord(**ref) == RoundRecord(3, 0.5, test_acc=0.9, wall_s=1.0, sim_s=2.5)
    eng = _engine()
    assert [r.sim_s for r in eng.run(2).records] == [0.0, 0.0]
