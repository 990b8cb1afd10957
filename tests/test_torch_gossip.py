"""repro_torch's gossip lane held against the reference.

The mixing plans are compared byte for byte; ``gossip_mix`` on CPU tensors
(its plain version) against the reference's Pallas kernel in interpret mode
and its dense oracle; one gossip round on the reference's own batches
against ``_engine_gossip_round`` (through ``RoundEngine.round`` of a
reference gossip engine). Whole runs draw their batch permutations from a
torch generator, so they are compared within a band, never bitwise. Within
the port the gossip superstep (``run(n, rounds_per_step=R)``, the
reference's ``_run_gossip``) equals R eager ``round()`` calls bit for bit,
and a checkpoint resumes bit for bit. The CUDA kernel itself is checked on
the card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FedAvgConfig as RefConfig  # noqa: E402
from repro.core import RoundEngine as RefEngine  # noqa: E402
from repro.core import topology as ref_topology  # noqa: E402
from repro.core.simulation import make_eval_fn as ref_make_eval_fn  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.gossip_mix import gossip_mix as ref_mix  # noqa: E402
from repro.kernels.gossip_mix import gossip_mix_ref as ref_mix_oracle  # noqa: E402
from repro.models import paper as ref_paper  # noqa: E402
from repro_torch.checkpoint import peek_metadata  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy, replicas_from_numpy  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.core.compression import quantize_codec  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    RoundBatch,
    RoundEngine,
    RoundRecord,
    RoundState,
    build_gossip_round_step,
    build_simulation_round_step,
)
from repro_torch.core.fedavg import FedAvgConfig  # noqa: E402
from repro_torch.core.simulation import make_eval_fn  # noqa: E402
from repro_torch.core.strategies import FedAvg, ServerStrategy  # noqa: E402
from repro_torch.data.partition import partition_pathological_noniid  # noqa: E402
from repro_torch.data.synthetic import make_image_classification  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix, gossip_mix_ref  # noqa: E402
from repro_torch.models import paper  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

KINDS = sorted(topology.TOPOLOGIES)


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


def _np_tree_close(got, want, atol):
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(leaf, np.float32),
                                   rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# mixing plans
# ---------------------------------------------------------------------------

def _build_both(ref_topo, port_topo, n):
    """(reference plan or its error, port plan or its error)."""
    out = []
    for topo in (ref_topo, port_topo):
        try:
            out.append(topo.build(n))
        except ValueError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [2, 3, 5, 6, 8, 10, 17, 100])
def test_plans_byte_identical_to_reference(kind, n):
    """Every kind at n in {2, 3, 5, 8, 17, 100}; the tori of 2, 3, 5 and 17
    nodes are 1 x n, those of 6, 8 and 10 nodes are 2 x n."""
    want, got = _build_both(ref_topology.TOPOLOGIES[kind](), topology.TOPOLOGIES[kind](), n)
    if isinstance(want, ValueError):          # e.g. a ring of degree 2 on 2 nodes
        assert isinstance(got, ValueError) and str(got) == str(want)
        return
    for a, b in ((got.idx, want.idx), (got.weight, want.weight), (got.dense(), want.dense())):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(topology.TOPOLOGIES[kind]().degrees(n),
                                  ref_topology.TOPOLOGIES[kind]().degrees(n))
    # Metropolis-Hastings rows are stochastic and symmetric: doubly stochastic
    W = got.dense().astype(np.float64)
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(W, W.T, atol=1e-7)


def test_torus_degenerate_shapes_match_reference():
    for n, shape in ((2, (1, 2)), (17, (1, 17)), (6, (2, 3)), (10, (2, 5)), (100, (10, 10))):
        assert topology.TorusTopology.shape(n) == ref_topology.TorusTopology.shape(n) == shape


@pytest.mark.parametrize("ctor", [
    lambda m: m.RingTopology(degree=4),
    lambda m: m.SmallWorldTopology(degree=4, rewire=0.2, seed=0),   # the smallworld spec's
    lambda m: m.SmallWorldTopology(degree=6, rewire=0.5, seed=3),
    lambda m: m.RandomTopology(p=0.1, seed=5),
    lambda m: m.RingTopology(degree=3),                             # refused by both
    lambda m: m.SmallWorldTopology(rewire=1.5),                     # refused by both
])
@pytest.mark.parametrize("n", [9, 100])
def test_plans_with_hyper_parameters_byte_identical(ctor, n):
    want, got = _build_both(ctor(ref_topology), ctor(topology), n)
    if isinstance(want, ValueError):
        assert isinstance(got, ValueError) and str(got) == str(want)
        return
    assert got.idx.tobytes() == want.idx.tobytes()
    assert got.weight.tobytes() == want.weight.tobytes()


def test_registry_and_json_helpers_match_reference():
    assert sorted(topology.TOPOLOGIES) == sorted(ref_topology.TOPOLOGIES)
    for kind in KINDS:
        t, r = topology.resolve_topology(kind), ref_topology.resolve_topology(kind)
        assert topology.topology_to_json(t) == ref_topology.topology_to_json(r)
        assert t.name == r.name
        assert topology.topology_from_json(topology.topology_to_json(t)) == t
    sw = {"kind": "smallworld", "degree": 4, "rewire": 0.2, "seed": 0}
    assert topology.topology_from_json(sw).name == ref_topology.topology_from_json(sw).name
    inst = topology.RingTopology(degree=4)
    assert topology.resolve_topology(inst) is inst
    with pytest.raises(ValueError, match="unknown topology"):
        topology.resolve_topology("star")
    with pytest.raises(ValueError, match="unknown topology"):
        topology.topology_from_json({"kind": "star"})
    with pytest.raises(TypeError, match="registry name or a Topology"):
        topology.resolve_topology(3)


# ---------------------------------------------------------------------------
# gossip_mix: the plain version against the reference kernel
# ---------------------------------------------------------------------------

def _mix_both(x, idx, w, dtype):
    """(port on CPU tensors, reference kernel in interpret mode, reference
    dense oracle), each as fp32 numpy."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = gossip_mix(torch.from_numpy(x).to(dtype), torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == dtype and got.shape == x.shape
    jx = jnp.asarray(x).astype(jdt)
    want = ref_mix(jx, jnp.asarray(idx), jnp.asarray(w), interpret=True)
    oracle = ref_mix_oracle(jx, jnp.asarray(idx), jnp.asarray(w))
    return (got.float().numpy(), np.asarray(want, np.float32), np.asarray(oracle, np.float32))


def _atol(want, dtype):
    # fp32: the reference's 1e-5. bf16: both accumulate in fp32 and round
    # once at the store, so they may differ by one bf16 ulp more.
    return 1e-5 if dtype == torch.float32 else float(np.abs(want).max()) * 2 ** -8 + 1e-5


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,N", [(3, 16), (8, 37), (17, 130), (100, 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_mix_matches_reference(rng, kind, n, N, dtype):
    plan = topology.TOPOLOGIES[kind]().build(n) if not (kind == "smallworld" and n < 5) \
        else topology.RingTopology().build(n)
    x = rng.normal(size=(n, N)).astype(np.float32)
    before = gossip_mix.launches
    got, want, oracle = _mix_both(x, plan.idx, plan.weight, dtype)
    assert gossip_mix.launches == before          # a CPU call launches nothing
    np.testing.assert_allclose(got, want, rtol=0, atol=_atol(want, dtype))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=_atol(oracle, dtype))


@pytest.mark.parametrize("case", ["duplicates", "out_of_range", "padded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_mix_slot_semantics_match_reference(rng, case, dtype):
    n, N = 5, 33
    x = rng.normal(size=(n, N)).astype(np.float32)
    if case == "duplicates":      # multigraph edges: their weights add
        idx = np.array([[1, 1, 0], [0, 2, 2], [3, 3, 3], [4, 0, 4], [1, 2, 3]], np.int32)
        w = np.array([[.25, .25, .5], [.3, .3, .4], [.5, .25, .25], [.4, .2, .4],
                      [.2, .3, .5]], np.float32)
    elif case == "out_of_range":  # ids outside [0, n) contribute 0
        idx = np.array([[0, 1, n], [-1, 1, 2], [2, 3, 99], [3, 4, -7], [4, 0, 1]], np.int32)
        w = np.array([[.4, .4, .2], [.1, .5, .4], [.5, .3, .2], [.6, .2, .2],
                      [.5, .25, .25]], np.float32)
    else:                         # a ring plan widened with two dead slots per row
        plan = topology.RingTopology().build(n)
        idx = np.concatenate([plan.idx, np.tile(np.arange(n, dtype=np.int32)[:, None], (1, 2))], 1)
        w = np.concatenate([plan.weight, np.zeros((n, 2), np.float32)], 1)
    got, want, oracle = _mix_both(x, idx, w, dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=_atol(want, dtype))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=_atol(oracle, dtype))
    if case == "padded" and dtype == torch.float32:
        plan = topology.RingTopology().build(n)
        narrow = gossip_mix(torch.from_numpy(x), torch.from_numpy(plan.idx),
                            torch.from_numpy(plan.weight))
        np.testing.assert_array_equal(got, narrow.numpy())
    if case == "out_of_range" and dtype == torch.float32:
        W = np.zeros((n, n), np.float64)
        for i in range(n):
            for j, ws in zip(idx[i], w[i]):
                if 0 <= j < n:
                    W[i, j] += ws
        np.testing.assert_allclose(got, W @ x, rtol=0, atol=1e-5)


def test_gossip_mix_keeps_the_node_mean_and_the_accum_option(rng):
    x = rng.normal(size=(9, 33)).astype(np.float32)
    for kind in KINDS:
        plan = topology.TOPOLOGIES[kind]().build(9)
        out = gossip_mix(torch.from_numpy(x), torch.from_numpy(plan.idx),
                         torch.from_numpy(plan.weight))
        np.testing.assert_allclose(out.numpy().mean(0), x.mean(0), atol=1e-5)
    # the plain version keeps the reference's accum_dtype option
    plan = topology.FullTopology().build(9)
    args = (torch.from_numpy(x).bfloat16(), torch.from_numpy(plan.idx),
            torch.from_numpy(plan.weight))
    lo = gossip_mix(*args, accum_dtype=torch.bfloat16)
    assert lo.dtype == torch.bfloat16
    np.testing.assert_allclose(lo.float().numpy(), gossip_mix(*args).float().numpy(), atol=0.05)
    assert torch.equal(gossip_mix(*args), gossip_mix_ref(*args))


_RING4 = topology.RingTopology().build(4)


def _args(x=None, idx=None, w=None):
    return (np.zeros((4, 8), np.float32) if x is None else x,
            _RING4.idx if idx is None else idx, _RING4.weight if w is None else w)


@pytest.mark.parametrize("args,exc,match", [
    (_args(w=np.full((4, 3), 0.5, np.float32)), ValueError, "row-stochastic"),
    (_args(idx=np.zeros((3, 3), np.int32), w=np.full((3, 3), 1 / 3, np.float32)),
     ValueError, "n_nodes"),
    (_args(x=np.zeros((4, 8), np.float64)), TypeError, "float32 or bfloat16"),
    (_args(idx=np.zeros((4, 3), np.int64)), TypeError, "int32"),
    (_args(w=np.full((4, 3), 1 / 3, np.float64)), TypeError, "float32"),
    (_args(idx=np.zeros((4, 0), np.int32), w=np.zeros((4, 0), np.float32)),
     ValueError, "one slot"),
])
def test_gossip_mix_refuses_bad_inputs(args, exc, match):
    with pytest.raises(exc, match=match):
        gossip_mix(*(torch.from_numpy(a) for a in args))
    if match == "row-stochastic":     # the reference refuses these rows the same way
        with pytest.raises(ValueError, match="row-stochastic"):
            ref_mix(*(jnp.asarray(a) for a in args), interpret=True)


@pytest.mark.parametrize("name", ["2nn", "cnn"])
def test_tree_gossip_mix_matches_reference(rng, name):
    ref_model, model = _models(name)
    n = 4
    one = jax.tree.map(np.array, ref_model.init(jax.random.PRNGKey(1)))
    stacked = jax.tree.map(
        lambda a: (a[None] + rng.normal(size=(n,) + a.shape)).astype(np.float32), one)
    plan = topology.RingTopology().build(n)
    want = ref_ops.tree_gossip_mix(jax.tree.map(jnp.asarray, stacked), jnp.asarray(plan.idx),
                                   jnp.asarray(plan.weight), interpret=True)
    got = ops.tree_gossip_mix(replicas_from_numpy(stacked, model, device="cpu"),
                              torch.from_numpy(plan.idx), torch.from_numpy(plan.weight))
    _np_tree_close(params_to_numpy(got), jax.tree.map(np.asarray, want), atol=1e-5)


# ---------------------------------------------------------------------------
# one gossip round on the reference's own batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,sizes,cfg,warm", [
    ("2nn", [9, 24, 17, 40, 12], dict(C=1.0, E=2, B=8, lr=0.2, seed=7), False),
    # from the reference's replicas after one round, carried across
    ("2nn", [9, 24, 17, 40, 12], dict(C=1.0, E=2, B=8, lr=0.2, seed=7), True),
    # 3 nodes, B=4, 3 steps of which node 2's last is masked
    ("cnn", [8, 11, 6], dict(C=1.0, E=1, B=4, lr=0.05, seed=3), False),
])
def test_gossip_round_matches_reference(name, sizes, cfg, warm):
    ref_model, model = _models(name)
    clients = _clients(name, sizes)
    ref = RefEngine(ref_model.loss, ref_model.init(jax.random.PRNGKey(2)), clients,
                    RefConfig(**cfg), topology="ring", interpret=True)
    if warm:
        ref.round()
    # the data key the reference's next round() splits off, and its batches
    k_data, _ = jax.random.split(ref.sample_key)
    K = len(clients)
    batch, mask, w = ref.materialize_round_batch(jnp.arange(K), k_data)
    assert (np.asarray(mask) == 0).any()     # a padded step is a no-op on both sides
    start = jax.tree.map(np.array, ref.params)
    lr = ref.lr_at(ref.round_idx)
    want_m = ref.round()
    want = jax.tree.map(np.array, ref.params)

    got, got_m = build_gossip_round_step(model.loss)(
        replicas_from_numpy(start, model, device="cpu"),
        tuple(torch.from_numpy(np.array(b)) for b in batch),
        torch.from_numpy(np.array(mask)), torch.from_numpy(np.array(w)),
        torch.from_numpy(ref.plan.idx), torch.from_numpy(ref.plan.weight), float(lr))
    _np_tree_close(params_to_numpy(got), want, atol=1e-5)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got_m["consensus"]), float(want_m["consensus"]),
                               rtol=1e-5, atol=1e-5)
    assert float(want_m["consensus"]) > 0           # a ring does not agree in one mix


def test_gossip_engine_builds_the_reference_plan_and_replicas():
    ref_model, model = _models("2nn")
    clients = _clients("2nn", [9, 24, 17, 40, 12])
    jp = ref_model.init(jax.random.PRNGKey(2))
    cfg = dict(C=1.0, E=1, B=8, lr=0.1, seed=0)
    topo = dict(kind="smallworld", degree=2, rewire=0.5, seed=1)
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**cfg),
                    topology=ref_topology.topology_from_json(topo), interpret=True)
    eng = RoundEngine(model.loss, params_from_numpy(jax.tree.map(np.array, jp), model,
                                                    device="cpu"),
                      clients, FedAvgConfig(**cfg), topology=topology.topology_from_json(topo),
                      device="cpu")
    assert eng.plan.idx.tobytes() == ref.plan.idx.tobytes()
    assert eng.plan.weight.tobytes() == ref.plan.weight.tobytes()
    assert eng._mix_idx.dtype == torch.int32 and eng._mix_w.dtype == torch.float32
    _np_tree_close(params_to_numpy(eng.params), jax.tree.map(np.array, ref.params), atol=0)
    # an fp32 mean of 5 equal rows, summed in another order
    _np_tree_close(params_to_numpy(eng.consensus_params()),
                   jax.tree.map(np.array, ref.consensus_params()), atol=1e-7)


# ---------------------------------------------------------------------------
# the anchor: the full graph is centralized FedAvg
# ---------------------------------------------------------------------------

def test_full_topology_matches_fedavg_round_for_round():
    """Equal shards, so the full graph's uniform 1/n weights are FedAvg's
    n_k/n; node k trains client k on the batches a star round over
    ids = arange(K) assembles from the same uniforms: the engine's device
    stream, replayed here from a generator seeded alike (as the reference's
    test replays its key chain). The tolerances are the reference's own
    anchor test's (``tests/test_engine_gossip.py``): the mix and the server
    average sum 8 fp32 terms in other orders."""
    r = np.random.default_rng(0)
    clients = [(r.normal(size=(16, 20)).astype(np.float32),
                r.integers(0, 5, size=16).astype(np.int32)) for _ in range(8)]
    _, model = _models("2nn")
    params = model.init(0)
    cfg = FedAvgConfig(C=1.0, E=2, B=8, lr=0.1, seed=3)
    eng = RoundEngine(model.loss, params, clients, cfg, topology="full", device="cpu")
    star = build_simulation_round_step(model.loss, strategy=FedAvg())
    gen = torch.Generator().manual_seed(cfg.seed)
    state = RoundState(params, outer_state=())
    for rnd in range(3):
        m = eng.round()
        batch, mask, w = eng.assemble_round_batch(torch.arange(8), eng._batch_uniforms(8, gen))
        state, star_m = star(state, RoundBatch(batch, mask, w, lr=eng.lr_at(rnd)))
        got = params_to_numpy(eng.consensus_params())
        for a, b in zip(tree_leaves(got), tree_leaves(params_to_numpy(state.params))):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
        np.testing.assert_allclose(float(m["consensus"]), 0.0, atol=1e-5)
        np.testing.assert_allclose(float(m["loss"]), float(star_m["loss"]), atol=1e-5)
    assert torch.equal(eng._gen.get_state(), gen.get_state())
    # the gossip lane draws nothing from the numpy stream any more
    assert eng.rng.bit_generator.state == np.random.default_rng(cfg.seed).bit_generator.state


# ---------------------------------------------------------------------------
# refusals, records, evaluation
# ---------------------------------------------------------------------------

class _Momentum(ServerStrategy):
    kind = "fedavgm"


@pytest.mark.parametrize("kw,cfg,match", [
    (dict(codec=quantize_codec(8)), {}, "incompatible with codec="),
    (dict(strategy=_Momentum()), {}, "'fedavgm' server strategy"),
    ({}, dict(C=0.5), "cfg.C == 1.0"),
    (dict(topology="torus3d"), {}, "unknown topology"),
    (dict(topology=topology.RingTopology(degree=4)), {}, "needs n_nodes > degree"),
])
def test_gossip_engine_refuses_what_the_reference_refuses(kw, cfg, match):
    _, model = _models("2nn")
    kw = {"topology": "ring", **kw}
    with pytest.raises(ValueError, match=match):
        RoundEngine(model.loss, model.init(0), _clients("2nn", [8, 8, 8, 8]),
                    FedAvgConfig(**{"C": 1.0, "E": 1, "B": 8, **cfg}), device="cpu", **kw)


def test_gossip_engine_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    _, model = _models("2nn")
    with pytest.raises(RuntimeError, match="cuda"):
        RoundEngine(model.loss, model.init(0), _clients("2nn", [8, 8, 8]),
                    FedAvgConfig(C=1.0), topology="ring")


def test_consensus_is_recorded_and_eval_sees_the_node_mean():
    seen = []

    def eval_fn(p):
        seen.append(p["fc1"]["w"].ndim)
        return {"acc": 0.5, "loss": 1.0}

    _, model = _models("2nn")
    clients = _clients("2nn", [8, 16, 8, 24, 8])
    cfg = FedAvgConfig(C=1.0, E=1, B=8, lr=0.1, seed=0)
    eng = RoundEngine(model.loss, model.init(0), clients, cfg, eval_fn=eval_fn,
                      topology="ring", device="cpu")
    assert eng.params["fc1"]["w"].shape == (5, 20, 200)
    hist = eng.run(3, eval_every=2)
    cons = [r.consensus for r in hist.records]
    assert all(isinstance(c, float) and c > 0 for c in cons)
    assert seen == [2, 2]            # rounds 2 and 3 (the last), on unstacked params
    assert [r.test_acc for r in hist.records] == [None, 0.5, 0.5]
    mean = eng.consensus_params()
    for a, b in zip(tree_leaves(mean), tree_leaves(eng.params)):
        assert a.dtype == b.dtype and torch.equal(a, b.float().mean(0))
    # a star engine's consensus_params are its params, and it records no consensus
    star = RoundEngine(model.loss, model.init(0), clients, cfg, device="cpu")
    assert star.consensus_params() is star.params
    assert star.run(1).records[0].consensus is None
    assert RoundRecord(1, 0.0).consensus is None


def test_replicas_from_numpy_checks_the_node_axis():
    _, model = _models("2nn")
    one = params_to_numpy(model.init(0))
    stacked = {k: {kk: np.stack([v] * 3) for kk, v in d.items()} for k, d in one.items()}
    got = replicas_from_numpy(stacked, model, device="cpu")
    assert got["fc1"]["w"].shape == (3, 20, 200)
    stacked["out"]["b"] = stacked["out"]["b"][:2]
    with pytest.raises(ValueError, match="out/b: shape"):
        replicas_from_numpy(stacked, model, device="cpu")
    with pytest.raises(ValueError, match="leading axes"):
        replicas_from_numpy(one, model, device="cpu")


# ---------------------------------------------------------------------------
# a whole run: within a band of the reference
# ---------------------------------------------------------------------------

def test_noniid_2nn_ring_run_within_band_of_reference():
    """Same data, same init, same plan; only the batch permutations differ.
    Band: every evaluated accuracy within 0.05 of the reference's, and every
    round's consensus distance within 25% of the reference's."""
    tr, te, _ = make_image_classification(1200, 400, seed=0)
    part = partition_pathological_noniid(tr.y, 12, seed=0)
    clients = [(tr.x[i], tr.y[i]) for i in part.client_indices]
    ref_model, model = ref_paper.mnist_2nn(), paper.mnist_2nn(device="cpu")
    jp = ref_model.init(jax.random.PRNGKey(0))
    cfg = dict(C=1.0, E=1, B=10, lr=0.05, seed=0)
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**cfg), topology="ring",
                    eval_fn=ref_make_eval_fn(ref_model.apply, te.x, te.y), interpret=True)
    eng = RoundEngine(model.loss, params_from_numpy(jax.tree.map(np.array, jp), model,
                                                    device="cpu"),
                      clients, FedAvgConfig(**cfg), topology="ring",
                      eval_fn=make_eval_fn(model.apply, te.x, te.y, device="cpu"), device="cpu")
    want = ref.run(4).records
    got = eng.run(4).records
    for a, b in zip(got, want):
        assert abs(a.test_acc - b.test_acc) <= 0.05, (a, b)
        assert abs(a.consensus - b.consensus) <= 0.25 * b.consensus, (a, b)
    assert got[-1].test_acc > got[0].test_acc - 0.05


# ---------------------------------------------------------------------------
# the gossip superstep: chunks of R captured rounds (eager on the CPU)
# ---------------------------------------------------------------------------

def _gossip_engine(kind, eval_fn=None, seed=3, **kw):
    _, model = _models("2nn")
    cfg = FedAvgConfig(C=1.0, E=2, B=8, lr=0.1, lr_decay=0.97, seed=seed)
    return RoundEngine(model.loss, model.init(0), _clients("2nn", [9, 24, 17, 8, 14, 20]), cfg,
                       topology=kind, eval_fn=eval_fn, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["ring", "smallworld", "full"])
def test_gossip_superstep_matches_rounds_bitwise(kind):
    """run(6, rounds_per_step=4) (a chunk of 4 and a ragged 2) == 6 x
    ``round()``: replicas, losses, consensus distances and the device
    generator's state, bit for bit (the reference's
    ``tests/test_engine_gossip.py:94``)."""
    a, b = _gossip_engine(kind), _gossip_engine(kind)
    per_round = [b.round() for _ in range(6)]
    h = a.run(6, eval_every=100, rounds_per_step=4)
    assert [r.train_loss for r in h.records] == [float(m["loss"]) for m in per_round]
    assert [r.consensus for r in h.records] == [float(m["consensus"]) for m in per_round]
    assert [r.round for r in h.records] == list(range(1, 7))
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert torch.equal(a._gen.get_state(), b._gen.get_state())
    assert a.round_idx == b.round_idx == 6
    if kind == "full":
        assert max(r.consensus for r in h.records) < 1e-5


def test_gossip_round_programs_after_two_chunks():
    """One round program whatever R is: two chunks and a ragged one build
    one (the reference's ``test_gossip_compile_count``); eager rounds and
    the default R = 1 build none."""
    eng = _gossip_engine("ring")
    eng.run(2)                                 # R = 1: eager rounds
    eng.round()
    assert eng.num_compilations == 0
    eng.run(4, eval_every=100, rounds_per_step=2)
    assert eng.num_compilations == 1
    eng.run(3, eval_every=100, rounds_per_step=2)
    eng.round()
    assert eng.num_compilations == 1 and eng.round_idx == 11


def test_gossip_superstep_evaluates_consensus_params_at_chunk_boundaries():
    """Evaluation runs whenever a chunk crosses an eval point, on the
    node-mean model (the unstacked ``consensus_params()``), and every round
    records its consensus distance."""
    seen = []

    def eval_fn(p):
        seen.append((p["fc1"]["w"].ndim, p["fc1"]["w"].clone()))
        return {"acc": 0.5, "loss": 1.0}

    eng = _gossip_engine("ring", eval_fn=eval_fn)
    h = eng.run(9, eval_every=2, rounds_per_step=3)      # chunks end at 3, 6, 9
    assert [r.round for r in h.records if r.test_acc is not None] == [3, 6, 9]
    assert [nd for nd, _ in seen] == [2, 2, 2]
    assert torch.equal(seen[-1][1], eng.consensus_params()["fc1"]["w"])
    assert all(isinstance(r.consensus, float) and r.consensus > 0 for r in h.records)
    assert len({r.wall_s for r in h.records[:3]}) == 1


@pytest.mark.parametrize("R", [1, 2])
def test_gossip_resume_is_bitwise(R, tmp_path):
    """2 rounds + save + restore into a fresh engine + 2 == 4 rounds, bit
    for bit, on the eager loop and in chunks (the reference's
    ``tests/test_engine_gossip.py:154``): the checkpoint carries the device
    generator's state."""
    straight = _gossip_engine("ring")
    straight.run(4, eval_every=100, rounds_per_step=R)
    a = _gossip_engine("ring")
    a.run(2, eval_every=100, rounds_per_step=R)
    a.save(tmp_path)
    meta = peek_metadata(tmp_path)
    assert meta["topology"] == a.topology.name and meta["torch_generator_device"] == "cpu"
    assert "torch_generator_ids_state" not in meta      # no cohort draw
    b = _gossip_engine("ring")
    assert b.restore(tmp_path) == 2
    b.run(2, eval_every=100, rounds_per_step=R)
    for x, y in zip(tree_leaves(straight.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert [r.train_loss for r in straight.history.records] == \
        [r.train_loss for r in b.history.records]
    assert [r.consensus for r in b.history.records][:2] == \
        [r.consensus for r in a.history.records]
    assert torch.equal(straight._gen.get_state(), b._gen.get_state())


def test_gossip_engine_refuses_a_reference_gossip_checkpoint(tmp_path):
    """A reference gossip checkpoint carries a threefry ``sample_key`` and
    no torch generator state: the port refuses it before any state changes,
    with the device-sampling guard's words, rather than continue another
    stream."""
    ref_model, model = _models("2nn")
    clients = _clients("2nn", [9, 24, 17, 8, 14])
    jp = ref_model.init(jax.random.PRNGKey(2))
    cfg = dict(C=1.0, E=1, B=8, lr=0.1, seed=0)
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**cfg), topology="ring",
                    interpret=True)
    ref.run(1, eval_every=100)
    ref.save(tmp_path)
    eng = RoundEngine(model.loss, params_from_numpy(jax.tree.map(np.array, jp), model,
                                                    device="cpu"),
                      clients, FedAvgConfig(**cfg), topology="ring", device="cpu")
    before = [t.clone() for t in tree_leaves(eng.params)]
    gen = eng._gen.get_state().clone()
    with pytest.raises(ValueError, match="reference's gossip engine: it carries a threefry"):
        eng.restore(tmp_path)
    assert all(torch.equal(x, y) for x, y in zip(before, tree_leaves(eng.params)))
    assert torch.equal(gen, eng._gen.get_state()) and eng.round_idx == 0
