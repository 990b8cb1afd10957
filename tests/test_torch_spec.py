"""repro_torch.specs and RoundEngine.from_spec held against repro.specs.

Every ``specs/*.json`` loads in both packages to the same JSON string; the
port's registry is the files; each spec field the port has no lane for is
refused before any state is built, naming its ROADMAP item (a
``mesh_axes`` spec runs sharded); ``from_spec``
builds the engine that keyword construction builds, bit for bit; and the
partitions a spec names are byte-identical to the reference's."""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import partition as ref_partition  # noqa: E402
from repro.specs import PAPER_SPECS as REF_SPECS  # noqa: E402
from repro.specs import ExperimentSpec as RefSpec  # noqa: E402
from repro.specs import ModelSpec as RefModelSpec  # noqa: E402
from repro.specs import PartitionSpec as RefPartitionSpec  # noqa: E402
from repro_torch.core.compression import quantize_codec  # noqa: E402
from repro_torch.core.engine import RoundEngine  # noqa: E402
from repro_torch.core.fedavg import FedAvgConfig  # noqa: E402
from repro_torch.core.strategies import FedAvgM  # noqa: E402
from repro_torch.core.topology import RingTopology  # noqa: E402
from repro_torch.data import batching, partition, synthetic  # noqa: E402
from repro_torch.models import paper  # noqa: E402
from repro_torch.specs import (  # noqa: E402
    PAPER_SPECS,
    AsyncSpec,
    CodecSpec,
    ExecutionSpec,
    ExperimentSpec,
    ModelSpec,
    PartitionSpec,
    TopologySpec,
    get_spec,
    list_specs,
)
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

torch.set_num_threads(1)

SPEC_DIR = Path(__file__).resolve().parents[1] / "specs"
SPEC_FILES = sorted(p.stem for p in SPEC_DIR.glob("*.json"))
RUNNABLE = SPEC_FILES
SMALL_2NN = ModelSpec("mnist_2nn", {"n_classes": 5, "d_in": 20})


def _data(n=120, seed=0):
    r = np.random.default_rng(seed)
    return r.normal(size=(n, 20)).astype(np.float32), r.integers(0, 5, n).astype(np.int32)


def _clients(spec, n=120):
    x, y = _data(n)
    return [(x[i], y[i]) for i in spec.build_partition(y).client_indices]


def _char_clients(n_roles=8, unroll=10):
    """A small role-partitioned corpus, the ``natural`` partition's clients:
    one client of (n, unroll) windows a role."""
    train, _, _ = synthetic.make_char_corpus(n_roles, mean_chars_per_role=200, seed=0)
    return [batching.windows_from_sequence(t, unroll) for t in train]


def _small(spec, n_clients=5):
    """``spec`` at a CPU size: the 2NN on 20 features and 5 classes, a few
    clients; every other section as the spec has it."""
    return dataclasses.replace(
        spec, model=SMALL_2NN,
        partition=dataclasses.replace(spec.partition, n_clients=n_clients))


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the wire form and the registry
# ---------------------------------------------------------------------------

def test_the_spec_files_are_the_fifteen_presets():
    assert len(SPEC_FILES) == 15 and len(RUNNABLE) == 15
    assert set(SPEC_FILES) == set(PAPER_SPECS) == set(REF_SPECS) == set(list_specs())


@pytest.mark.parametrize("name", SPEC_FILES)
def test_spec_file_loads_to_the_reference_json(name):
    text = (SPEC_DIR / f"{name}.json").read_text()
    spec = ExperimentSpec.from_json(text)
    ref = RefSpec.from_json(text)
    assert spec.to_json() == ref.to_json()
    assert spec.to_json(indent=2) == ref.to_json(indent=2)
    assert spec.strategy.name == ref.strategy.name
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert PAPER_SPECS[name] == spec and get_spec(name) is PAPER_SPECS[name]
    assert PAPER_SPECS[name].to_json() == REF_SPECS[name].to_json()


def test_specs_refuse_unknown_kinds_and_callable_lr_and_are_frozen():
    with pytest.raises(KeyError):
        get_spec("mnist_3nn")
    with pytest.raises(ValueError, match="unknown model kind"):
        ModelSpec("mnist_3nn").build(device="cpu")
    with pytest.raises(ValueError, match="unknown partition kind"):
        PartitionSpec("zipf").build(n_examples=10)
    with pytest.raises(ValueError, match="unknown codec kind"):
        CodecSpec("zstd").build()
    with pytest.raises(ValueError, match="unknown topology"):
        TopologySpec("hypercube").build()
    bad = get_spec("mnist_2nn_iid").to_json().replace('"kind": "fedavg"', '"kind": "fedyogi"')
    with pytest.raises(ValueError, match="unknown server strategy"):
        ExperimentSpec.from_json(bad)
    with pytest.raises(ValueError, match="unknown latency kind"):
        AsyncSpec(latency=type(AsyncSpec().latency)(kind="uniform"))
    sched = dataclasses.replace(get_spec("mnist_2nn_iid"),
                                fedavg=FedAvgConfig(lr=lambda r: 0.1 / (1 + r)))
    with pytest.raises(ValueError, match="callable lr"):
        sched.to_json()
    for value, field in ((get_spec("mnist_2nn_iid"), "rounds"), (SMALL_2NN, "kind"),
                         (ExecutionSpec(), "pool"), (CodecSpec("topk"), "keep_frac")):
        with pytest.raises(dataclasses.FrozenInstanceError):
            setattr(value, field, None)


@pytest.mark.parametrize("kind", ["cifar_cnn", "char_lstm", "word_lstm"])
def test_paper_models_build_the_reference_tree(kind):
    """The three kinds ROADMAP item 10 held back now build: the port's tree
    has the reference's keys and shapes (a vocab that resolves at data
    time is a kwarg, as ``shakespeare_lstm``'s spec gives it)."""
    kwargs = {"vocab_size": 72, "hidden": 32} if kind == "char_lstm" else {}
    got = ModelSpec(kind, kwargs).build(device="cpu").init(0)
    want = RefModelSpec(kind, kwargs).build().init(jax.random.PRNGKey(0))
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    assert tree_paths(got) == paths
    assert [tuple(t.shape) for t in tree_leaves(got)] == [
        tuple(a.shape) for a in jax.tree.leaves(want)]


def test_model_spec_builds_the_ports_models():
    m = get_spec("mnist_cnn_iid").build_model(device="cpu")
    assert sum(p.numel() for p in tree_leaves(m.init(0))) == 1_663_370
    m = SMALL_2NN.build(device="cpu")
    assert m.init(0)["out"]["w"].shape == (200, 5)
    assert get_spec("mnist_2nn_noniid_q8").build_codec().name == "q8"
    assert get_spec("mnist_2nn_noniid_ring").topology.build() == RingTopology(degree=2)


# ---------------------------------------------------------------------------
# from_spec's refusals: before any state is built, each naming its item
# ---------------------------------------------------------------------------

def _refusals():
    base = get_spec("mnist_2nn_noniid")
    cases = {}
    async_q8 = dataclasses.replace(get_spec("mnist_2nn_noniid_async"),
                                   codec=CodecSpec("quantize"))
    ex = ExecutionSpec
    superstep = ex(device_sampling=True, rounds_per_step=5)
    cases.update({
        # the gossip superstep is rounds_per_step alone (it runs,
        # test_from_spec_runs_the_superstep_lanes); device_sampling beside a
        # topology is refused in the reference's words
        "superstep_gossip": (dataclasses.replace(
            get_spec("mnist_2nn_noniid_ring"), execution=superstep),
            "topology= is incompatible with device_sampling=True"),
        "codec_and_async": (async_q8, "sets both codec= and async_spec="),
        # a mesh_axes spec runs (test_mesh_axes_spec_runs_sharded_through_from_spec);
        # beside a topology it is refused as the reference refuses it
        "mesh": (dataclasses.replace(get_spec("mnist_2nn_noniid_ring"),
                                     execution=ex(mesh_axes="clients")),
                 "topology= is incompatible with mesh="),
        "accum_dtype": (dataclasses.replace(base, execution=ex(accum_dtype="bfloat16")),
                        "Queue 2"),
        "interpret": (dataclasses.replace(base, execution=ex(interpret=True)),
                      "no kernel interpreter"),
    })
    return cases


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_from_spec_refuses_before_building_state(case):
    spec, item = _refusals()[case]
    # an empty population makes pack_clients raise: the refusal must come first
    with pytest.raises(ValueError, match=item):
        RoundEngine.from_spec(spec, [], device="cpu")


@pytest.mark.parametrize("lane", ["gossip", "lowrank", "streamed"])
def test_from_spec_runs_the_superstep_lanes(lane):
    """The lanes ``from_spec`` once refused naming ROADMAP Queue 1 item 6: a
    gossip spec with ``execution.rounds_per_step``, ``mnist_2nn_noniid_lowrank``
    with ``device_sampling=True`` and a streamed spec with
    ``device_sampling=True``, each one chunk, equal to the engine built
    from keywords run in single rounds (the streamed one to the device
    pool's chunk)."""
    ex = ExecutionSpec
    if lane == "gossip":
        spec = dataclasses.replace(get_spec("mnist_2nn_noniid_ring"),
                                   execution=ex(rounds_per_step=3))
    elif lane == "lowrank":
        spec = dataclasses.replace(get_spec("mnist_2nn_noniid_lowrank"),
                                   execution=ex(device_sampling=True, rounds_per_step=3))
    else:
        spec = dataclasses.replace(get_spec("mnist_2nn_noniid"), execution=ex(
            pool="streamed", device_sampling=True, rounds_per_step=3, pool_shard_clients=2))
    spec = _small(ExperimentSpec.from_json(spec.to_json()))
    spec = dataclasses.replace(spec, fedavg=dataclasses.replace(spec.fedavg, E=1, B=8))
    clients = _clients(spec)
    model = paper.mnist_2nn(n_classes=5, d_in=20, device="cpu")
    params = model.init(7)
    eng = RoundEngine.from_spec(spec, clients, init_params=params, device="cpu")
    assert eng.default_rounds_per_step == 3
    assert (eng.topology is not None) == (lane == "gossip")
    assert eng.device_sampling == (lane != "gossip")
    assert eng.pool_kind == ("streamed" if lane == "streamed" else "device")
    h = eng.run(3)
    assert eng.num_compilations == 1 and len({r.wall_s for r in h.records}) == 1
    kw = dict(codec=spec.build_codec(), topology=spec.topology and spec.topology.build(),
              device_sampling=eng.device_sampling)
    twin = RoundEngine(model.loss, params, clients, spec.fedavg, device="cpu", pool="device",
                       **kw)
    losses = [float(twin.round()["loss"]) for _ in range(3)]
    assert [r.train_loss for r in h.records] == losses
    assert _equal(eng.params, twin.params)


def test_mesh_axes_spec_runs_sharded_through_from_spec():
    """``execution.mesh_axes`` (once refused, naming ROADMAP Queue 1 item 7)
    builds a client mesh over a world of one (gloo on the CPU, started from a
    ``FileStore``) and runs the same rounds as the spec without it."""
    import torch.distributed as dist

    spec = _small(get_spec("mnist_2nn_noniid"))
    clients = _clients(spec)
    params = paper.mnist_2nn(n_classes=5, d_in=20, device="cpu").init(7)
    started = not dist.is_initialized()
    try:
        sharded = RoundEngine.from_spec(
            dataclasses.replace(spec, execution=ExecutionSpec(mesh_axes="clients")), clients,
            init_params=params, device="cpu")
        assert sharded.mesh is not None and sharded.mesh.mesh_dim_names == ("clients",)
        assert dist.get_backend(sharded.mesh.get_group("clients")) == "gloo"
        base = RoundEngine.from_spec(spec, clients, init_params=params, device="cpu")
        h_s, h_b = sharded.run(2), base.run(2)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    np.testing.assert_allclose([r.train_loss for r in h_s.records],
                               [r.train_loss for r in h_b.records], rtol=0, atol=1e-5)
    for a, b in zip(tree_leaves(sharded.params), tree_leaves(base.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_natural_partition_refuses_with_the_reference_message():
    spec = get_spec("shakespeare_lstm")
    with pytest.raises(ValueError, match="defined by the dataset loader"):
        spec.build_partition(n_examples=100)
    with pytest.raises(ValueError, match="defined by the dataset loader"):
        REF_SPECS["shakespeare_lstm"].build_partition(n_examples=100)


@pytest.mark.parametrize("pool", ["auto", "device"])
def test_device_pools_go_through_the_pool_budget(pool, monkeypatch):
    """Under the budget both keep the population on the device; over it
    ``"auto"`` streams it from the host and ``"device"`` refuses, naming the
    streamed pool."""
    spec = dataclasses.replace(_small(get_spec("mnist_2nn_noniid")),
                               execution=ExecutionSpec(pool=pool))
    eng = RoundEngine.from_spec(spec, _clients(spec), device="cpu")
    assert eng.num_clients == 5 and eng.pool_kind == "device"
    monkeypatch.setenv("REPRO_DEVICE_POOL_BUDGET", "1000")
    if pool == "auto":
        eng = RoundEngine.from_spec(spec, _clients(spec), device="cpu")
        assert eng.pool_kind == "streamed" and eng.num_clients == 5
        return
    with pytest.raises(ValueError, match="exceeds device budget.*pool='streamed'"):
        RoundEngine.from_spec(spec, _clients(spec), device="cpu")


# ---------------------------------------------------------------------------
# from_spec builds what the keywords build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane", ["plain", "codec", "gossip", "fedavgm"])
def test_from_spec_matches_kwargs_bit_for_bit(lane):
    """The mirror of tests/test_spec.py's: the engine from a spec (through
    its JSON form) and the engine from keywords run the same rounds."""
    kw, spec_kw = {}, {}
    cfg = FedAvgConfig(C=0.4, E=2, B=8, lr=0.1, seed=3)
    if lane == "codec":
        kw["codec"] = quantize_codec(8, chunk=256)
        spec_kw["codec"] = CodecSpec("quantize", bits=8, chunk=256)
    elif lane == "gossip":
        cfg = dataclasses.replace(cfg, C=1.0)
        kw["topology"] = RingTopology(degree=2)
        spec_kw["topology"] = TopologySpec("ring", degree=2)
    elif lane == "fedavgm":
        kw["strategy"] = spec_kw["strategy"] = FedAvgM(momentum=0.8)
    spec = dataclasses.replace(_small(get_spec("mnist_2nn_noniid")), fedavg=cfg, **spec_kw)
    spec = ExperimentSpec.from_json(spec.to_json())
    clients = _clients(spec)
    model = paper.mnist_2nn(n_classes=5, d_in=20, device="cpu")
    params = model.init(7)
    by_spec = RoundEngine.from_spec(spec, clients, init_params=params, device="cpu")
    by_kw = RoundEngine(model.loss, params, clients, cfg, device="cpu", **kw)
    for _ in range(3):
        a, b = by_spec.round(), by_kw.round()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert _equal(by_spec.params, by_kw.params)
    assert _equal(by_spec.outer_state, by_kw.outer_state)
    assert by_spec.strategy == by_kw.strategy


def test_from_spec_defaults_build_the_model_from_the_spec_seed():
    spec = dataclasses.replace(_small(get_spec("mnist_2nn_iid")),
                               fedavg=FedAvgConfig(C=0.4, E=1, B=8, lr=0.1, seed=9))
    eng = RoundEngine.from_spec(spec, _clients(spec), device="cpu")
    want = paper.mnist_2nn(n_classes=5, d_in=20, device="cpu").init(9)
    assert _equal(eng.params, want)
    assert eng.device.type == "cpu"
    if not torch.cuda.is_available():           # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            RoundEngine.from_spec(spec, _clients(spec))


@pytest.mark.parametrize("name", RUNNABLE)
def test_runnable_spec_runs_through_from_spec(name):
    """Each runnable preset at a CPU size (the CNN specs keep the CNN): its
    partition built by the spec, two rounds of its lane."""
    spec = get_spec(name)
    n = 60 if spec.model.kind == "mnist_cnn" else 120
    if spec.partition.kind == "natural":
        # the data arrives federated: one client a role of the char corpus
        clients = _char_clients()
        spec = dataclasses.replace(
            spec, model=dataclasses.replace(spec.model, kwargs={"vocab_size": 72, "hidden": 16}),
            fedavg=dataclasses.replace(spec.fedavg, C=0.25, E=1))
    elif spec.model.kind == "mnist_cnn":
        spec = dataclasses.replace(spec, partition=dataclasses.replace(spec.partition,
                                                                       n_clients=3))
        r = np.random.default_rng(0)
        x, y = r.normal(size=(n, 28, 28, 1)).astype(np.float32), r.integers(0, 10, n)
        y = y.astype(np.int32)
        clients = [(x[i], y[i]) for i in spec.build_partition(y).client_indices]
        spec = dataclasses.replace(spec, fedavg=dataclasses.replace(spec.fedavg, E=1, B=20))
    else:
        spec = _small(spec)
        clients = _clients(spec, n)
    eng = RoundEngine.from_spec(spec, clients, device="cpu")
    hist = eng.run(2)
    assert len(hist.records) == 2 and all(np.isfinite(r.train_loss) for r in hist.records)
    assert eng.strategy == spec.strategy
    assert (eng.codec is None) == (spec.codec is None)
    assert (eng.topology is None) == (spec.topology is None)


def test_shakespeare_spec_runs_a_round_through_from_spec():
    """``shakespeare_lstm`` as the spec stands (the char-LSTM at hidden 128
    over its 72 characters, C=0.1 E=5 B=10 lr=1.47), its clients a small
    corpus's roles: one round, the loss finite, the cohort the spec's 10%."""
    spec = get_spec("shakespeare_lstm")
    clients = _char_clients(n_roles=20)
    eng = RoundEngine.from_spec(spec, clients, device="cpu")
    assert eng.num_clients == 20 and eng.packed.batch_size == 10
    assert tuple(eng.params["embed"].shape) == (72, 8)
    assert tuple(eng.params["lstm1"]["wh"].shape) == (128, 512)
    hist = eng.run(1)
    assert np.isfinite(hist.records[0].train_loss)
    assert eng.rng.bit_generator.state != np.random.default_rng(0).bit_generator.state


def test_superstep_spec_runs_its_chunks_through_from_spec():
    """``mnist_2nn_iid_superstep`` at a CPU size: the engine samples on the
    device, takes the spec's R = 20 as ``run``'s default, and 25 rounds run
    as a chunk of 20 and a ragged 5 from one round program, the same rounds
    as 25 calls of ``round()``."""
    spec = _small(get_spec("mnist_2nn_iid_superstep"))
    assert spec.execution.device_sampling and spec.execution.rounds_per_step == 20
    clients = _clients(spec)
    eng = RoundEngine.from_spec(spec, clients, device="cpu")
    twin = RoundEngine.from_spec(spec, clients, device="cpu")
    assert eng.device_sampling and eng.default_rounds_per_step == 20
    hist = eng.run(25)
    walls = [r.wall_s for r in hist.records]
    assert len(set(walls[:20])) == 1 and len(set(walls[20:])) == 1
    assert [r.train_loss for r in hist.records] == [float(twin.round()["loss"])
                                                    for _ in range(25)]
    assert _equal(eng.params, twin.params)
    assert eng.num_compilations == twin.num_compilations == 1


# ---------------------------------------------------------------------------
# the partitions a spec names
# ---------------------------------------------------------------------------

def _same_partition(got, want):
    assert got.num_clients == len(want.client_indices)
    for a, b in zip(got.client_indices, want.client_indices):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got.client(1).tobytes() == want.client(1).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_dirichlet_is_byte_identical(seed):
    y = np.random.default_rng(seed).integers(0, 10, 500).astype(np.int32)
    for alpha in (0.1, 0.5, 5.0):
        _same_partition(partition.partition_dirichlet(y, 40, alpha=alpha, seed=seed),
                        ref_partition.partition_dirichlet(y, 40, alpha=alpha, seed=seed))
    with pytest.raises(ValueError, match=">= 1 example per client"):
        partition.partition_dirichlet(y[:10], 40)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_unbalanced_is_byte_identical(seed):
    for sigma in (0.5, 1.0, 2.0):
        got = partition.partition_unbalanced(1000, 30, sigma=sigma, seed=seed)
        _same_partition(got, ref_partition.partition_unbalanced(1000, 30, sigma=sigma,
                                                                seed=seed))
        assert sum(got.client_sizes) == 1000


@pytest.mark.parametrize("kind", ["iid", "pathological_noniid", "unbalanced", "dirichlet"])
def test_partition_spec_build_matches_reference(kind):
    y = np.random.default_rng(4).integers(0, 10, 600).astype(np.int32)
    fields = dict(kind=kind, n_clients=20, shards_per_client=3, alpha=0.3, seed=5)
    _same_partition(PartitionSpec(**fields).build(y), RefPartitionSpec(**fields).build(y))
