"""repro_torch.checkpoint and RoundEngine.save/restore held against the
reference's checkpoints, in both directions.

The layout is the reference's: ``msgpack_lite`` writes the index byte for
byte as ``msgpack`` does (the test imports ``msgpack``; the port never
does), leaves are named by their jax paths, bf16 leaves travel as uint16.
A checkpoint written by either package resumes in the other: the next
round on the reference's injected batches matches at the reference's
1e-5, with the same cohort ids and the history restored."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import io as ref_io  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.core import FedAvgConfig as RefConfig  # noqa: E402
from repro.core import RoundEngine as RefEngine  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro.core.engine import RoundBatch as RefBatch  # noqa: E402
from repro.core.engine import RoundState as RefState  # noqa: E402
from repro.core.engine import build_simulation_round_step as ref_round_step  # noqa: E402
from repro.models import paper as ref_paper  # noqa: E402
from repro.models.transformer import TransformerLM as RefLM  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    latest_step,
    msgpack_lite,
    peek_metadata,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.compression import quantize_codec  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    RoundBatch,
    RoundEngine,
    RoundState,
    build_simulation_round_step,
)
from repro_torch.core.fedavg import FedAvgConfig  # noqa: E402
from repro_torch.core.strategies import FedAvg, FedAvgM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import paper  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

torch.set_num_threads(1)

CFG = dict(C=0.6, E=2, B=8, lr=0.1, seed=5)


def _clients(sizes=(16, 8, 24, 16, 12), seed=1234):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(n, 16)).astype(np.float32),
             r.integers(0, 5, n).astype(np.int32)) for n in sizes]


def _models():
    return (ref_paper.mnist_2nn(n_classes=5, d_in=16),
            paper.mnist_2nn(n_classes=5, d_in=16, device="cpu"))


def _ref_twin(s):
    return ref_strategies.STRATEGIES[s.kind](**dataclasses.asdict(s))


def _pair(strategy):
    """A reference engine and a port engine on the same clients, config,
    strategy and initial weights (the reference's ``init``)."""
    ref_model, model = _models()
    jp = ref_model.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.array, jp), model, device="cpu")
    clients = _clients()
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**CFG), interpret=True,
                    strategy=_ref_twin(strategy))
    eng = RoundEngine(model.loss, tp, clients, FedAvgConfig(**CFG), strategy=strategy,
                      device="cpu")
    return ref, eng, ref_model, model


def _close(port_tree, ref_tree, atol):
    got = [t.detach().double().numpy() for t in tree_leaves(port_tree)]
    want = [np.asarray(x, np.float64) for x in jax.tree.leaves(ref_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _next_round_both(ref, eng, ref_model, model, strategy):
    """The next round on both sides: the cohort ids each engine draws, then
    one step each on the reference's batches for those ids."""
    ids, _, key, lr = ref._next_round_inputs()
    got_ids, _, got_lr = eng._next_round_inputs()
    np.testing.assert_array_equal(got_ids, np.asarray(ids))
    assert np.float32(got_lr) == np.float32(lr)
    batch, mask, w = ref.materialize_round_batch(ids, key)
    rstate, rm = ref_round_step(ref_model.loss, interpret=True, strategy=_ref_twin(strategy))(
        RefState(ref.params, outer_state=ref.outer_state), RefBatch(batch, mask, w, lr=lr))
    pstate, pm = build_simulation_round_step(model.loss, strategy=strategy)(
        RoundState(eng.params, outer_state=eng.outer_state),
        RoundBatch(tuple(torch.from_numpy(np.array(b)) for b in batch),
                   torch.from_numpy(np.array(mask)), torch.from_numpy(np.array(w)),
                   lr=float(lr)))
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=1e-5, atol=1e-5)
    _close(pstate.params, rstate.params, 1e-5)
    _close(pstate.outer_state, rstate.outer_state, 1e-5)


# ---------------------------------------------------------------------------
# msgpack_lite is msgpack on the index
# ---------------------------------------------------------------------------

INT_EDGES = sorted({v for b in (1, 32, 33, 127, 128, 255, 256, 2**15, 2**16, 2**31, 2**32, 2**63)
                    for v in (b - 1, b, -b, -b - 1) if -(2**63) <= v < 2**64})


def _random_value(r, depth=0):
    kind = r.integers(0, 9 if depth < 3 else 6)
    if kind == 0:
        return [None, True, False][r.integers(0, 3)]
    if kind == 1:      # ints at every width boundary, both signs
        return INT_EDGES[r.integers(0, len(INT_EDGES))]
    if kind == 2:
        return float(r.normal() * 10.0 ** r.integers(-30, 30))
    if kind == 3:
        return "é" * int(r.choice([0, 5, 31, 32, 200, 255, 256, 70000]))
    if kind == 4:
        return [1.5, "x" * 40, -7][r.integers(0, 3)]
    if kind == 5:
        return float(r.choice([0.0, -0.0, np.inf, -np.inf, 1e-310]))
    n = int(r.choice([0, 3, 15, 16, 70]))
    if kind in (6, 7):
        return [_random_value(r, depth + 1) for _ in range(n)]
    return {f"k{i}": _random_value(r, depth + 1) for i in range(n)}


@pytest.mark.parametrize("seed", range(6))
def test_msgpack_lite_matches_msgpack_on_random_values(seed):
    r = np.random.default_rng(seed)
    for _ in range(20):
        v = _random_value(r)
        packed = msgpack.packb(v)
        assert msgpack_lite.packb(v) == packed
        assert msgpack_lite.unpackb(packed) == msgpack.unpackb(packed)
    tup = {"t": (1, 2, (3,)), "f": np.float64(0.5)}
    assert msgpack_lite.packb(tup) == msgpack.packb(tup)
    # formats the index never holds decode too: float32, bin 8/16/32
    for other in (msgpack.packb(1.5, use_single_float=True),
                  *(msgpack.packb(bytes(n)) for n in (0, 3, 255, 256, 70000))):
        assert msgpack_lite.unpackb(other) == msgpack.unpackb(other)
    for bad in ({1: "int key"}, 2**64, -(2**63) - 1, object(), b"bytes"):
        with pytest.raises((TypeError, OverflowError, ValueError)):
            msgpack_lite.unpackb(msgpack.packb(bad)) if isinstance(bad, dict) \
                else msgpack_lite.packb(bad)
    with pytest.raises(ValueError, match="ext"):
        msgpack_lite.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))


@pytest.mark.parametrize("strategy", [FedAvg(), FedAvgM(0.9)], ids=lambda s: s.kind)
def test_msgpack_lite_writes_the_reference_index_bytes(strategy, tmp_path):
    ref, eng, _, _ = _pair(strategy)
    ref.run(2)
    eng.run(2)
    d_ref = ref.save(tmp_path / "ref")
    d_port = eng.save(tmp_path / "port")
    raw = open(f"{d_ref}/index.msgpack", "rb").read()
    assert msgpack_lite.packb(msgpack.unpackb(raw)) == raw
    assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw)
    mine = open(f"{d_port}/index.msgpack", "rb").read()
    index = msgpack.unpackb(mine)
    assert msgpack.packb(index) == mine
    want = msgpack.unpackb(raw)
    assert [index[k] for k in ("step", "names", "shapes", "dtypes")] == \
        [want[k] for k in ("step", "names", "shapes", "dtypes")]
    assert sorted(index["metadata"]) == sorted(want["metadata"])
    assert index["metadata"]["sample_key"] == want["metadata"]["sample_key"] == [0, 5]
    assert index["metadata"]["strategy"] == want["metadata"]["strategy"] == strategy.name
    assert index["metadata"]["rng_state"] == want["metadata"]["rng_state"]


# ---------------------------------------------------------------------------
# checkpoint.io: trees, dtypes, structure
# ---------------------------------------------------------------------------

def _mixed_tree():
    r = np.random.default_rng(0)
    return {"b": {"w": torch.from_numpy(r.normal(size=(3, 5)).astype(np.float32))},
            "a": torch.from_numpy(r.normal(size=(7,)).astype(np.float32)).bfloat16(),
            "layers": [{"k": torch.arange(4, dtype=torch.int32)},
                       {"k": torch.ones(2, 2).bfloat16()}],
            "empty": ()}


def test_trees_round_trip_in_the_reference_layout(tmp_path):
    tree = _mixed_tree()
    save_checkpoint(tmp_path, tree, step=3, metadata={"x": 1})
    assert latest_step(tmp_path) == 3 and peek_metadata(tmp_path) == {"x": 1}
    like = {"b": {"w": torch.zeros(3, 5)}, "a": torch.zeros(7, dtype=torch.bfloat16),
            "layers": [{"k": torch.zeros(4, dtype=torch.int32)},
                       {"k": torch.zeros(2, 2, dtype=torch.bfloat16)}], "empty": ()}
    back, meta = restore_checkpoint(tmp_path, like)
    assert meta == {"x": 1} and back["empty"] == () and _equal(back, tree)
    assert [t.dtype for t in tree_leaves(back)] == [t.dtype for t in tree_leaves(tree)]
    index = msgpack.unpackb(open(tmp_path / "step_00000003" / "index.msgpack", "rb").read())
    assert index["names"] == ["a", "b/w", "layers/0/k", "layers/1/k"]
    assert index["dtypes"] == ["bfloat16", "float32", "int32", "bfloat16"]
    # the reference reads it as its own
    ref_like = {"a": jnp.zeros(7, jnp.bfloat16), "b": {"w": jnp.zeros((3, 5))},
                "empty": (), "layers": [{"k": jnp.zeros(4, jnp.int32)},
                                        {"k": jnp.zeros((2, 2), jnp.bfloat16)}]}
    got, _ = ref_io.restore_checkpoint(tmp_path, ref_like)
    for a, b in zip(jax.tree.leaves(got), tree_leaves(tree)):
        assert str(a.dtype) == str(b.dtype).split(".")[1]
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    # and the port reads the reference's
    ref_io.save_checkpoint(tmp_path / "r", got, step=1)
    back2, _ = restore_checkpoint(tmp_path / "r", like)
    assert _equal(back2, tree)


def test_restore_refuses_a_structure_or_shape_mismatch(tmp_path):
    save_checkpoint(tmp_path, {"a": torch.ones(3), "b": torch.ones(2)}, step=0)
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(tmp_path, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(tmp_path, {"a": torch.ones(3), "c": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, {"a": torch.ones(4), "b": torch.ones(2)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", {"a": torch.ones(3)})


# ---------------------------------------------------------------------------
# engines across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", [FedAvg(), FedAvgM(0.9)], ids=lambda s: s.kind)
def test_reference_checkpoint_resumes_in_the_port(strategy, tmp_path):
    ref, eng, ref_model, model = _pair(strategy)
    ref.run(2)
    ref.history.records[1].sim_s = 1.25          # a history with a simulated time
    ref.save(tmp_path)
    assert eng.restore(tmp_path) == 2 and eng.round_idx == 2
    _close(eng.params, ref.params, 0.0)
    _close(eng.outer_state, ref.outer_state, 0.0)
    assert [dataclasses.asdict(r) for r in eng.history.records] == \
        [dataclasses.asdict(r) for r in ref.history.records]
    assert eng.history.records[1].sim_s == 1.25
    assert eng.rng.bit_generator.state == ref.rng.bit_generator.state
    _next_round_both(ref, eng, ref_model, model, strategy)


@pytest.mark.parametrize("strategy", [FedAvg(), FedAvgM(0.9)], ids=lambda s: s.kind)
def test_port_checkpoint_resumes_in_the_reference(strategy, tmp_path):
    ref, eng, ref_model, model = _pair(strategy)
    eng.run(2)
    eng.save(tmp_path)
    assert ref.restore(tmp_path) == 2
    _close(eng.params, ref.params, 0.0)
    _close(eng.outer_state, ref.outer_state, 0.0)
    assert [dataclasses.asdict(r) for r in ref.history.records] == \
        [dataclasses.asdict(r) for r in eng.history.records]
    assert np.asarray(ref.sample_key).tolist() == \
        np.asarray(jax.random.PRNGKey(CFG["seed"])).tolist()
    _next_round_both(ref, eng, ref_model, model, strategy)


@pytest.mark.parametrize("lane", ["fedavg", "fedavgm", "q8", "ring", "superstep",
                                  "superstep_fedavgm", "superstep_streamed"])
def test_resume_in_the_port_is_bit_for_bit(lane, tmp_path):
    """4 rounds equal 2 rounds, save, restore into a fresh engine, 2 more;
    on the superstep and gossip lanes the device generator's stream
    continues too, and on the superstep lanes the ids generator's."""
    kw = {"fedavgm": dict(strategy=FedAvgM(0.9)), "q8": dict(codec=quantize_codec(8, 256)),
          "ring": dict(topology="ring"), "fedavg": {},
          "superstep": dict(device_sampling=True),
          "superstep_fedavgm": dict(device_sampling=True, strategy=FedAvgM(0.9)),
          "superstep_streamed": dict(device_sampling=True, pool="streamed")}[lane]
    cfg = FedAvgConfig(**{**CFG, "C": 1.0 if lane == "ring" else CFG["C"]})
    _, model = _models()

    def fresh():
        return RoundEngine(model.loss, model.init(0), _clients(), cfg, device="cpu",
                           eval_fn=lambda p: {"acc": 0.5, "loss": 1.0}, **kw)

    a, b = fresh(), fresh()
    a.run(4)
    b.run(2)
    b.save(tmp_path)
    c = fresh()
    assert c.restore(tmp_path) == 2
    c.run(2)
    assert _equal(a.params, c.params) and _equal(a.outer_state, c.outer_state)
    assert [dataclasses.asdict(r) | {"wall_s": 0} for r in a.history.records] == \
        [dataclasses.asdict(r) | {"wall_s": 0} for r in c.history.records]
    assert a.rng.bit_generator.state == c.rng.bit_generator.state
    if a.device_sampling or a.topology is not None:
        assert torch.equal(a._gen.get_state(), c._gen.get_state())
    else:
        assert a._gen is c._gen is None
    if a.device_sampling:
        assert torch.equal(a._ids_gen.get_state(), c._ids_gen.get_state())
    else:
        assert a._ids_gen is c._ids_gen is None


def test_a_device_sampling_checkpoint_carries_both_generators(tmp_path):
    """The device generator (batches, codec noise) and the host ids
    generator (cohorts) are both written and both restored; a checkpoint
    with the device stream alone (written before the ids had a generator of
    their own) is refused before any state changes."""
    _, model = _models()

    def fresh():
        return RoundEngine(model.loss, model.init(0), _clients(), FedAvgConfig(**CFG),
                           device_sampling=True, device="cpu")

    a = fresh()
    a.run(3, rounds_per_step=3)
    a.save(tmp_path / "both")
    meta = peek_metadata(tmp_path / "both")
    assert {"torch_generator_state", "torch_generator_ids_state"} <= set(meta)
    b = fresh()
    b.restore(tmp_path / "both")
    assert torch.equal(a._gen.get_state(), b._gen.get_state())
    assert torch.equal(a._ids_gen.get_state(), b._ids_gen.get_state())
    a.run(2, rounds_per_step=2)
    b.run(2, rounds_per_step=2)
    assert _equal(a.params, b.params)
    save_checkpoint(tmp_path / "old", {"params": a.params, "strategy_state": a.outer_state},
                    step=5, metadata={k: v for k, v in meta.items()
                                      if k != "torch_generator_ids_state"})
    c = fresh()
    before = _state(c)
    with pytest.raises(ValueError, match="predates the cohort ids' own generator"):
        c.restore(tmp_path / "old")
    _unchanged(c, before)


def _state(eng):
    return ([t.clone() for t in tree_leaves(eng.params)],
            [t.clone() for t in tree_leaves(eng.outer_state)], eng.round_idx,
            json.dumps(eng.rng.bit_generator.state), list(eng.history.records))


def _unchanged(eng, before):
    after = _state(eng)
    assert all(torch.equal(x, y) for x, y in zip(before[0], after[0]))
    assert all(torch.equal(x, y) for x, y in zip(before[1], after[1]))
    assert before[2:] == after[2:]


def test_restore_guards_refuse_before_any_state_changes(tmp_path):
    _, model = _models()

    def engine(strategy=None, topology=None, C=0.6, device_sampling=False):
        return RoundEngine(model.loss, model.init(0), _clients(),
                           FedAvgConfig(**{**CFG, "C": C}), strategy=strategy,
                           topology=topology, device_sampling=device_sampling, device="cpu")

    src = engine(FedAvgM(0.9))
    src.run(1)
    src.save(tmp_path / "fedavgm")
    for wrong in (None, FedAvgM(0.5)):
        eng = engine(wrong)
        before = _state(eng)
        with pytest.raises(ValueError, match="across server strategies"):
            eng.restore(tmp_path / "fedavgm")
        _unchanged(eng, before)

    ring = engine(topology="ring", C=1.0)
    ring.run(1)
    ring.save(tmp_path / "ring")
    for eng, ck in ((engine(), "ring"), (engine(topology="torus", C=1.0), "ring"),
                    (engine(topology="ring", C=1.0), "fedavgm")):
        before = _state(eng)
        with pytest.raises(ValueError, match="topology="):
            eng.restore(tmp_path / ck)
        _unchanged(eng, before)

    # a params-only checkpoint from before strategies (the reference's layout)
    plain = engine()
    plain.run(1)
    save_checkpoint(tmp_path / "old", plain.params, step=1, metadata={
        "round_idx": 1, "rng_state": json.dumps(plain.rng.bit_generator.state),
        "sample_key": [0, 5], "device_sampling": False})
    eng = engine(FedAvgM(0.9))
    before = _state(eng)
    with pytest.raises(ValueError, match="predates server strategies"):
        eng.restore(tmp_path / "old")
    _unchanged(eng, before)
    ok = engine()
    assert ok.restore(tmp_path / "old") == 1 and _equal(ok.params, plain.params)

    # a device-sampling checkpoint of the reference: a threefry key, which
    # neither a host-sampling engine nor the port's device stream can resume
    ref_model, _ = _models()
    ref = RefEngine(ref_model.loss, ref_model.init(jax.random.PRNGKey(3)), _clients(),
                    RefConfig(**CFG), interpret=True, strategy=_ref_twin(FedAvgM(0.9)),
                    device_sampling=True)
    ref.run(1, rounds_per_step=1)
    ref.save(tmp_path / "ref_device")
    for eng, match in ((engine(FedAvgM(0.9)), "device_sampling=True"),
                       (engine(FedAvgM(0.9), device_sampling=True), "threefry")):
        before = _state(eng)
        with pytest.raises(ValueError, match=match):
            eng.restore(tmp_path / "ref_device")
        _unchanged(eng, before)
    # the port's own device-sampling checkpoint resumes in a device-sampling engine
    dev = engine(FedAvgM(0.9), device_sampling=True)
    dev.run(1)
    dev.save(tmp_path / "port_device")
    ok = engine(FedAvgM(0.9), device_sampling=True)
    assert ok.restore(tmp_path / "port_device") == 1
    assert _equal(ok.params, dev.params) and _equal(ok.outer_state, dev.outer_state)
    assert torch.equal(ok._gen.get_state(), dev._gen.get_state())


def test_restore_pins_the_step(tmp_path):
    _, model = _models()
    eng = RoundEngine(model.loss, model.init(0), _clients(), FedAvgConfig(**CFG), device="cpu")
    eng.run(1)
    eng.save(tmp_path)
    first = [t.clone() for t in tree_leaves(eng.params)]
    eng.run(2)
    eng.save(tmp_path)
    fresh = RoundEngine(model.loss, model.init(0), _clients(), FedAvgConfig(**CFG), device="cpu")
    assert fresh.restore(tmp_path, step=1) == 1
    assert all(torch.equal(x, y) for x, y in zip(first, tree_leaves(fresh.params)))
    assert fresh.restore(tmp_path) == 3 and _equal(fresh.params, eng.params)
    with pytest.raises(FileNotFoundError):
        fresh.restore(tmp_path / "none")


# ---------------------------------------------------------------------------
# launch.train's checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ["fedavg", "fedsgd"])
def test_train_checkpoint_reads_back_in_the_reference(dtype, algo, tmp_path):
    argv = ["--arch", "gemma-2b", "--device", "cpu", "--rounds", "1", "--local-steps", "1",
            "--global-batch", "2", "--seq", "16", "--n-layers", "2", "--algo", algo,
            "--dtype", dtype, "--checkpoint-dir", str(tmp_path)]
    records, final = train.run(argv)
    assert len(records) == 1 and latest_step(tmp_path) == 1
    assert {t.dtype for t in tree_leaves(final)} == {getattr(torch, dtype)}
    cfg = dataclasses.replace(ref_reduced(ref_get_config("gemma-2b"), n_layers=2),
                              param_dtype=dtype, compute_dtype=dtype)
    like = RefLM(cfg).init(jax.random.PRNGKey(0))
    got, meta = ref_io.restore_checkpoint(tmp_path, like)
    assert meta == {"algo": algo, "arch": cfg.name}
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert ["/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in p) for p, _ in flat] \
        == ["/".join(map(str, p)) for p in tree_paths(final)]
    for (_, a), b in zip(flat, tree_leaves(final)):
        assert str(a.dtype) == dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    back, _ = restore_checkpoint(tmp_path, final)
    assert _equal(back, final)
