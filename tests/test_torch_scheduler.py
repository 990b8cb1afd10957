"""repro_torch's round schedules (``core.scheduler``) held against repro's.

The schedules are host numpy: for the same population, config, strategy and
latency model, the port's and the reference's engines dispatch the same
cohorts, keep the same simulated clock (``RoundRecord.sim_s``, float for
float) and leave their numpy streams in the same state after every
``run()``, on the buffered-async lane and the straggler-simulated sync
lane, dropouts and all-dropped rounds included. The split phases are held
against the reference's on the same inputs (the apply phase on the same
buffer, the client phase on the reference's own batches); the degenerate
async schedule equals the port's sync lane bit for bit in params."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AsyncConfig as RefAsyncConfig  # noqa: E402
from repro.core import FedAvgConfig as RefConfig  # noqa: E402
from repro.core import LatencyModel as RefLatency  # noqa: E402
from repro.core import RoundEngine as RefEngine  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro.core.engine import History as RefHistory  # noqa: E402
from repro.core.engine import RoundRecord as RefRecord  # noqa: E402
from repro.core.engine import _engine_apply_buffer as ref_apply_buffer  # noqa: E402
from repro.models import paper as ref_paper  # noqa: E402
from repro.specs import PAPER_SPECS as REF_SPECS  # noqa: E402
from repro.utils.tree import tree_ravel_stacked as ref_ravel_stacked  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AsyncConfig,
    FedAvgConfig,
    History,
    LatencyModel,
    RoundEngine,
    RoundRecord,
    RoundScheduler,
    quantize_codec,
)
from repro_torch.core.strategies import FedAsync, FedAvg  # noqa: E402
from repro_torch.models import paper  # noqa: E402
from repro_torch.specs import get_spec  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_ravel_stacked, tree_map  # noqa: E402

torch.set_num_threads(1)

SIZES = (7, 64, 13, 40, 25, 9, 31, 18, 55, 12, 23, 17)
CFG = dict(C=0.4, E=2, B=10, lr=0.1, seed=3)


def _clients(sizes=SIZES, d=20, classes=5, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        x = r.normal(size=(n, d)).astype(np.float32)
        y = r.choice([i % classes, (i + 1) % classes], n).astype(np.int32)
        out.append((x, y))
    return out


@pytest.fixture(scope="module")
def setting():
    ref_model = ref_paper.mnist_2nn(n_classes=5, d_in=20)
    model = paper.mnist_2nn(n_classes=5, d_in=20, device="cpu")
    jp = ref_model.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.array, jp), model, device="cpu")
    return ref_model, model, jp, tp, _clients()


def _ref_twin(s):
    return ref_strategies.STRATEGIES[s.kind](**dataclasses.asdict(s))


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _engines(setting, *, strategy=FedAvg(), latency=None, acfg=None, cfg=CFG):
    """The reference's and the port's engines on the same population,
    config, strategy and latency model, each recording the cohort ids of
    every dispatch (async) or every round (sync). The schedule reads no
    number the device computes, so the reference's executables are replaced
    by stand-ins of the right shapes (its schedule code runs as it is, with
    no compile for each dispatch width); the port's run for real. The
    phases themselves are held against the reference's below."""
    ref_model, model, jp, tp, clients = setting
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**cfg), interpret=True,
                    strategy=_ref_twin(strategy),
                    latency=None if latency is None else RefLatency(**dataclasses.asdict(latency)),
                    async_config=None if acfg is None else RefAsyncConfig(**dataclasses.asdict(acfg)))
    eng = RoundEngine(model.loss, tp, clients, FedAvgConfig(**cfg), strategy=strategy,
                      latency=latency, async_config=acfg, device="cpu")
    ref_ids, port_ids = [], []
    if acfg is not None:
        port_phase = eng._client_phase

        def port_spy(ids, seed, lr):
            port_ids.append(np.asarray(ids).tolist())
            return port_phase(ids, seed, lr)

        _async_stand_ins(ref, jp, ref_ids)
        eng._client_phase = port_spy
    else:
        ref_draw, port_draw = ref._next_round_inputs, eng._next_round_inputs

        def ref_spy():
            out = ref_draw()
            ref_ids.append(np.asarray(out[0]).tolist())
            return out

        ref._round_jit = lambda params, outer, *a: (params, outer, jnp.float32(0.0))

        def port_spy():
            out = port_draw()
            port_ids.append(np.asarray(out[0]).tolist())
            return out

        ref._next_round_inputs, eng._next_round_inputs = ref_spy, port_spy
    return ref, eng, ref_ids, port_ids


def _async_stand_ins(ref, jp, ids_out):
    """Stand-ins for a reference async engine's two executables: the client
    phase records its cohort's ids in ``ids_out`` and returns zeros of the
    (width, N), (width,), (width,) shapes; the apply returns the state."""
    n_params = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jp))

    def client_phase(params, px, py, counts, spe, ids, valid, key, lr):
        ids_out.append(np.asarray(ids).tolist())
        width = ids.shape[0]
        return jnp.zeros((width, n_params)), jnp.zeros(width), jnp.ones(width)

    ref._client_phase_jit = client_phase
    ref._apply_jit = lambda params, outer, *a: (params, outer, jnp.float32(0.0))


SCHEDULES = {
    # name: (strategy, latency, async config, applies or rounds per run() call)
    "async_fedasync_dropout": (
        FedAsync(staleness_exp=0.5),
        LatencyModel(kind="lognormal", mean_s=1.0, sigma=1.5, hetero=0.5, dropout=0.3, seed=7),
        AsyncConfig(buffer_k=2, concurrency=6), (5, 3)),
    "async_heavy_dropout": (
        FedAvg(), LatencyModel(kind="exponential", mean_s=1.0, dropout=0.6, seed=1),
        AsyncConfig(buffer_k=3, concurrency=6), (4, 2)),
    "async_k1_stale": (
        FedAsync(staleness_exp=0.5), LatencyModel(kind="lognormal", sigma=1.5, seed=4),
        AsyncConfig(buffer_k=1, concurrency=6), (6, 3)),
    "async_deadline": (
        FedAvg(), LatencyModel(kind="exponential", mean_s=2.0, deadline_s=1.5, seed=11),
        AsyncConfig(buffer_k=2), (4, 2)),
    "sync_latency": (
        FedAvg(), LatencyModel(kind="exponential", mean_s=2.0, hetero=0.3, dropout=0.2, seed=9),
        None, (3, 2)),
    "sync_all_dropped": (
        FedAvg(), LatencyModel(kind="exponential", mean_s=5.0, deadline_s=1e-9, seed=2),
        None, (2, 1)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_the_reference(setting, name):
    """Per-record round and sim_s exactly, every dispatch's cohort ids, and
    the numpy stream after each ``run()``: the schedule is host numpy, so
    the device and the batch generator play no part in it."""
    strategy, latency, acfg, runs = SCHEDULES[name]
    ref, eng, ref_ids, port_ids = _engines(setting, strategy=strategy, latency=latency,
                                           acfg=acfg)
    for n in runs:
        h_ref, h = ref.run(n), eng.run(n)
        assert eng.rng.bit_generator.state == ref.rng.bit_generator.state
        assert [r.round for r in h.records] == [r.round for r in h_ref.records]
        assert [r.sim_s for r in h.records] == [r.sim_s for r in h_ref.records]
        assert port_ids == ref_ids
    assert eng.round_idx == ref.round_idx == sum(runs)
    losses = [r.train_loss for r in h.records]
    if name == "sync_all_dropped":
        assert all(np.isnan(v) for v in losses)
        assert all(0 < r.sim_s <= 1e-9 for r in h.records)
        assert _equal(eng.params, setting[3])        # nothing was ever applied
    else:
        assert all(np.isfinite(v) for v in losses)
        assert all(r.sim_s >= 0 for r in h.records)
    if acfg is not None:
        assert len(port_ids) > 1                   # refills went out


def test_async_run_is_deterministic(setting):
    _, model, _, tp, clients = setting
    lat = LatencyModel(kind="lognormal", mean_s=1.0, sigma=1.5, hetero=0.5, dropout=0.3, seed=7)

    def go():
        eng = RoundEngine(model.loss, tp, clients, FedAvgConfig(**CFG),
                          strategy=FedAsync(staleness_exp=0.5),
                          async_config=AsyncConfig(buffer_k=2, concurrency=6), latency=lat,
                          device="cpu")
        return eng, eng.run(6)

    (e1, h1), (e2, h2) = go(), go()
    assert [dataclasses.asdict(r) | {"wall_s": 0.0} for r in h1.records] == \
        [dataclasses.asdict(r) | {"wall_s": 0.0} for r in h2.records]
    assert _equal(e1.params, e2.params)


# ---------------------------------------------------------------------------
# the split phases against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ghosts", [0, 2])
@pytest.mark.parametrize("strategy", [FedAvg(), FedAsync(staleness_exp=0.5, server_lr=0.9)],
                         ids=lambda s: s.kind)
def test_apply_phase_matches_the_reference(setting, strategy, ghosts):
    """``_apply_buffer`` against ``repro``'s ``_engine_apply_buffer`` on the
    same (flat, per_loss, w, stale): the new params and the loss within
    1e-6. Ghost rows (w = 0, zero deltas) pad a forced partial apply."""
    ref_model, model, jp, tp, clients = setting
    K = 5
    r = np.random.default_rng(42)
    dummy = jax.tree.map(lambda p: jnp.zeros((1,) + p.shape, jnp.float32), jp)
    _, spec = ref_ravel_stacked(dummy)
    N = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jp))
    flat = (r.normal(size=(K, N)) * 0.01).astype(np.float32)
    per_loss = r.uniform(0.1, 2.0, K).astype(np.float32)
    w = r.integers(5, 60, K).astype(np.float32)
    stale = r.integers(0, 4, K).astype(np.float32)
    if ghosts:
        flat[-ghosts:] = 0.0
        per_loss[-ghosts:] = w[-ghosts:] = stale[-ghosts:] = 0.0
    want_p, _, want_loss = ref_apply_buffer(
        _ref_twin(strategy), spec, jp, _ref_twin(strategy).init_state(jp), jnp.asarray(flat),
        jnp.asarray(per_loss), jnp.asarray(w), jnp.asarray(stale), interpret=True,
        accum_dtype=jnp.float32)
    eng = RoundEngine(model.loss, tp, clients, FedAvgConfig(**CFG), strategy=strategy,
                      device="cpu")
    _, eng._delta_spec = tree_ravel_stacked(tree_map(lambda p: p.float()[None], eng.params))
    loss = eng._apply_buffer(torch.from_numpy(flat), torch.from_numpy(per_loss),
                             torch.from_numpy(w), torch.from_numpy(stale))
    got = [t.double().numpy() for t in tree_leaves(eng.params)]
    want = [np.asarray(x, np.float64) for x in jax.tree.leaves(want_p)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)


def test_client_phase_matches_the_reference(setting):
    """``_client_phase`` on the reference's own batches (the port draws its
    permutations from a torch generator, so exact checks inject them)
    against the reference's client phase executable: the raveled deltas
    within 1e-5, the per-client losses and the raw weights."""
    ref_model, model, jp, tp, clients = setting
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**CFG), interpret=True,
                    async_config=RefAsyncConfig(buffer_k=5))
    eng = RoundEngine(model.loss, tp, clients, FedAvgConfig(**CFG), device="cpu")
    ids = np.array([3, 0, 8, 11, 5])
    key = jax.random.PRNGKey(17)
    want_flat, want_loss, want_w = ref._client_phase_jit(
        jp, ref._x, ref._y, ref._counts, ref._spe, jnp.asarray(ids, jnp.int32),
        jnp.ones(len(ids), jnp.float32), key, jnp.float32(0.1))
    (bx, by), mask, w = ref.materialize_round_batch(ids, key)
    injected = ((torch.from_numpy(np.array(bx)), torch.from_numpy(np.array(by)).long()),
                torch.from_numpy(np.array(mask)), torch.from_numpy(np.array(w)))
    eng.materialize_round_batch = lambda i, s: injected
    flat, per_loss, got_w = eng._client_phase(ids, 0, 0.1)
    assert flat.shape == want_flat.shape and flat.dtype == torch.float32
    np.testing.assert_allclose(flat.numpy(), np.asarray(want_flat), rtol=0, atol=1e-5)
    np.testing.assert_allclose(per_loss.numpy(), np.asarray(want_loss), rtol=1e-5)
    assert got_w.device.type == "cpu"
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert _equal(eng.params, tp)                  # the client phase changes nothing


# ---------------------------------------------------------------------------
# the degenerate schedule is the sync lane
# ---------------------------------------------------------------------------

def test_degenerate_async_is_the_sync_lane_bit_for_bit(setting):
    """buffer_k == concurrency == m and zero latency: params bitwise after
    every round, losses within 3e-7 (the weights normalized on the host
    instead of the device), the numpy streams in step across repeated
    ``run(1)`` calls and within one ``run(4)``."""
    _, model, _, tp, clients = setting
    cfg = FedAvgConfig(**CFG)
    snaps = {"sync": [], "async": []}

    def snap(key):
        def ev(p):
            snaps[key].append([t.clone() for t in tree_leaves(p)])
            return {"acc": torch.tensor(0.0), "loss": torch.tensor(0.0)}
        return ev

    sync = RoundEngine(model.loss, tp, clients, cfg, eval_fn=snap("sync"), device="cpu")
    m = sync._m
    asy = RoundEngine(model.loss, tp, clients, cfg, eval_fn=snap("async"),
                      async_config=AsyncConfig(buffer_k=m, concurrency=m),
                      latency=LatencyModel(kind="zero"), device="cpu")
    for _ in range(3):
        sync.run(1)
        asy.run(1)
        assert sync.rng.bit_generator.state == asy.rng.bit_generator.state
        assert _equal(sync.params, asy.params)
    sync.run(4)
    asy.run(4)
    assert sync.rng.bit_generator.state == asy.rng.bit_generator.state
    assert len(snaps["sync"]) == len(snaps["async"]) == 7
    for a, b in zip(snaps["sync"], snaps["async"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    l1 = [r.train_loss for r in sync.history.records]
    l2 = [r.train_loss for r in asy.history.records]
    np.testing.assert_allclose(l1, l2, rtol=3e-7)
    assert [r.round for r in sync.history.records] == [r.round for r in asy.history.records]
    assert [r.sim_s for r in asy.history.records] == [0.0] * 7


def test_zero_latency_sync_lane_is_the_plain_lane(setting):
    _, model, _, tp, clients = setting
    cfg = FedAvgConfig(**CFG)
    plain = RoundEngine(model.loss, tp, clients, cfg, device="cpu")
    zero = RoundEngine(model.loss, tp, clients, cfg, latency=LatencyModel(), device="cpu")
    other = RoundEngine(model.loss, tp, clients, cfg, device="cpu",
                        latency=LatencyModel(kind="lognormal", sigma=2.0, seed=123))
    for e in (plain, zero, other):
        e.run(3)
    assert _equal(plain.params, zero.params)
    assert [r.train_loss for r in plain.history.records] == \
        [r.train_loss for r in zero.history.records]
    # the latency stream never perturbs the cohort stream
    assert plain.rng.bit_generator.state == zero.rng.bit_generator.state == \
        other.rng.bit_generator.state


def test_staleness_reaches_the_apply(setting):
    """With K < m and a real spread of latencies, some buffered updates were
    computed on older params: the apply phase sees nonzero staleness, on the
    host."""
    _, model, _, tp, clients = setting
    eng = RoundEngine(model.loss, tp, clients, FedAvgConfig(**CFG),
                      strategy=FedAsync(staleness_exp=0.5),
                      async_config=AsyncConfig(buffer_k=1, concurrency=6),
                      latency=LatencyModel(kind="lognormal", sigma=1.5, seed=4), device="cpu")
    seen = []
    apply = eng._apply_buffer

    def spy(flat, per_loss, w, stale):
        assert w.device.type == "cpu" and stale.device.type == "cpu"
        seen.append(stale.clone())
        return apply(flat, per_loss, w, stale)

    eng._apply_buffer = spy
    eng.run(8)
    assert len(seen) == 8 and any(float(s.max()) > 0 for s in seen)


def test_fedasync_checkpoint_round_trip(setting, tmp_path):
    _, model, _, tp, clients = setting

    def mk():
        return RoundEngine(model.loss, tp, clients, FedAvgConfig(**CFG),
                           strategy=FedAsync(staleness_exp=0.5, server_lr=0.9),
                           async_config=AsyncConfig(buffer_k=2, concurrency=5),
                           latency=LatencyModel(kind="exponential", mean_s=1.0, dropout=0.1,
                                                seed=5), device="cpu")

    a = mk()
    a.run(4)
    a.save(tmp_path / "ck")
    b = mk()
    assert b.restore(tmp_path / "ck") == 4
    assert _equal(a.params, b.params)
    assert b.rng.bit_generator.state == a.rng.bit_generator.state
    assert [dataclasses.asdict(r) for r in b.history.records] == \
        [dataclasses.asdict(r) for r in a.history.records]


def test_sim_time_to_target_matches_the_reference():
    recs = [(1, 0.5, 0.20, 2.0), (2, 0.6, None, 1.5), (3, 0.7, 0.55, 3.0), (4, 0.4, 0.8, 0.5)]
    got = History([RoundRecord(round=r, train_loss=lo, test_acc=a, sim_s=s)
                   for r, lo, a, s in recs])
    want = RefHistory([RefRecord(round=r, train_loss=lo, test_acc=a, sim_s=s)
                       for r, lo, a, s in recs])
    for target in (0.1, 0.3, 0.55, 0.7, 0.9):
        assert got.sim_time_to_target(target) == want.sim_time_to_target(target)


# ---------------------------------------------------------------------------
# validation and refusals
# ---------------------------------------------------------------------------

def test_async_config_validation():
    with pytest.raises(ValueError, match="buffer_k"):
        AsyncConfig(buffer_k=0)
    with pytest.raises(ValueError, match="never fill"):
        AsyncConfig(buffer_k=5, concurrency=3)
    assert AsyncConfig(buffer_k=3) == AsyncConfig(3, None)


@pytest.mark.parametrize("case", ["codec", "device_sampling", "rounds_per_step", "topology",
                                  "latency_superstep"])
def test_incompatible_lanes_are_refused_before_any_state(setting, case):
    _, model, _, tp, _ = setting
    acfg = AsyncConfig(buffer_k=2)
    kw, match = {
        "codec": (dict(codec=quantize_codec(8), async_config=acfg), "async_config"),
        "device_sampling": (dict(device_sampling=True, async_config=acfg), "async_config"),
        "rounds_per_step": (dict(rounds_per_step=5, async_config=acfg), "rounds_per_step"),
        "topology": (dict(topology="ring", latency=LatencyModel()), "topology"),
        "latency_superstep": (dict(device_sampling=True, latency=LatencyModel()),
                              "numpy-stream"),
    }[case]
    # an empty population would make packing raise: the refusal comes first
    with pytest.raises(ValueError, match=match):
        RoundEngine(model.loss, tp, [], FedAvgConfig(**CFG), device="cpu", **kw)


def test_run_refuses_what_the_schedule_cannot_take(setting):
    _, model, _, tp, clients = setting
    eng = RoundEngine(model.loss, tp, clients, FedAvgConfig(**CFG),
                      async_config=AsyncConfig(buffer_k=2, concurrency=99), device="cpu")
    with pytest.raises(ValueError, match="concurrency"):
        eng.run(1)
    with pytest.raises(ValueError, match="rounds_per_step"):
        eng.run(2, rounds_per_step=2)
    eng.codec = quantize_codec(8)                  # mutated after construction
    with pytest.raises(ValueError, match="codec"):
        RoundScheduler(eng)


@pytest.mark.parametrize("name", ["mnist_2nn_noniid_async", "mnist_2nn_noniid_fedasync"])
def test_async_spec_runs_the_reference_schedule_through_from_spec(setting, name):
    """Both async specs at a CPU size (the 2NN on 20 features, 12 clients,
    C = 0.4) through ``from_spec``: their FedBuff K = 3 and straggler model,
    the same schedule as the reference's ``from_spec`` engine."""
    ref_model, model, jp, tp, clients = setting
    spec = get_spec(name)
    fed = dataclasses.replace(spec.fedavg, C=0.4, E=1)
    small = dataclasses.replace(spec, fedavg=fed)
    ref_small = dataclasses.replace(REF_SPECS[name], fedavg=RefConfig(**dataclasses.asdict(fed)))
    eng = RoundEngine.from_spec(small, clients, loss_fn=model.loss, init_params=tp, device="cpu")
    ref = RefEngine.from_spec(ref_small, clients, loss_fn=ref_model.loss, init_params=jp)
    ref_ids = []
    _async_stand_ins(ref, jp, ref_ids)
    assert eng.async_config == AsyncConfig(buffer_k=3) and eng.latency == spec.async_spec.latency
    assert eng.strategy == spec.strategy
    h, h_ref = eng.run(4), ref.run(4)
    assert [r.sim_s for r in h.records] == [r.sim_s for r in h_ref.records]
    assert eng.rng.bit_generator.state == ref.rng.bit_generator.state
    assert all(np.isfinite(r.train_loss) for r in h.records)
    assert params_to_numpy(eng.params).keys() == jax.tree.map(np.asarray, jp).keys()
