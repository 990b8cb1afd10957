"""repro_torch's streamed client pool held against repro's, and the streamed
engine against the device-pool engine.

The store: ``StreamedClientPool.gather`` returns the reference's gather and
``pack_clients``' rows byte for byte, across shards. The engine: for the
same seed, ``RoundEngine(pool="streamed")`` gives the params, strategy
state and history of ``pool="device"`` bit for bit on the plain, FedAvgM,
q8 and top-k lanes, because the staged rows are the device gather's bytes
and everything after them is the same round; prefetch 0 equals prefetch 1;
checkpoints resume across the two pools, a pending prefetch discarded. On
the superstep lane (``device_sampling=True``) the streamed pool stages a
whole chunk's cohorts at once and equals the device pool's superstep bit
for bit, a ragged last chunk and a checkpoint that discards a pending chunk
included (the reference's ``tests/test_engine_pool.py:129-149``,
``:202-230``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.batching import pack_clients as ref_pack_clients  # noqa: E402
from repro.data.pool import StreamedClientPool as RefStreamedPool  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AsyncConfig,
    FedAvgConfig,
    LatencyModel,
    RoundEngine,
    quantize_codec,
    topk_codec,
)
from repro_torch.core.staging import CohortStager  # noqa: E402
from repro_torch.core.strategies import FedAvgM  # noqa: E402
from repro_torch.data import DeviceClientPool, StreamedClientPool  # noqa: E402
from repro_torch.data.batching import pack_clients  # noqa: E402
from repro_torch.models import paper  # noqa: E402
from repro_torch.specs import ExecutionSpec, ExperimentSpec, ModelSpec, PartitionSpec  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

SIZES = [9, 24, 17, 8, 14]
CFG = dict(C=0.5, E=2, B=8, lr=0.2, lr_decay=0.99, seed=3)


def _clients(sizes=SIZES, d=12, classes=5, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, d)).astype(np.float32),
             rng.integers(0, classes, n).astype(np.int32)) for n in sizes]


@pytest.fixture(scope="module")
def setup():
    model = paper.mnist_2nn(n_classes=5, d_in=12, device="cpu")
    return model, model.init(1), _clients()


def _engine(setup, pool, cfg=None, **kw):
    model, params, clients = setup
    return RoundEngine(model.loss, params, clients, FedAvgConfig(**(cfg or CFG)), pool=pool,
                       device="cpu", **kw)


def _assert_same_run(a, b):
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.outer_state),
                    tree_leaves(b.params) + tree_leaves(b.outer_state)):
        assert torch.equal(x, y)
    assert [r.train_loss for r in a.history.records] == [r.train_loss for r in b.history.records]
    assert [r.round for r in a.history.records] == [r.round for r in b.history.records]


# ---------------------------------------------------------------------------
# the store against the reference's
# ---------------------------------------------------------------------------

def test_gather_is_the_reference_gather_and_the_packed_rows(tmp_path):
    clients = _clients([9, 24, 17, 8, 3, 30, 12])
    pool = StreamedClientPool.build(clients, 8, shard_clients=3, root=tmp_path / "port")
    ref = RefStreamedPool.build(clients, 8, shard_clients=3, root=str(tmp_path / "ref"))
    packed, ref_packed = pack_clients(clients, 8), ref_pack_clients(clients, 8)
    assert pool.num_shards == ref.num_shards == 3
    ids = np.array([5, 0, 6, 2, 2, 4])
    x, y = pool.gather(ids)
    rx, ry = ref.gather(ids)
    for got, want in ((x, rx), (y, ry), (x, packed.x[ids]), (y, packed.y[ids]),
                      (x, ref_packed.x[ids])):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for f in ("counts", "steps_per_epoch", "bucket_of"):
        assert getattr(pool.meta, f).tobytes() == getattr(ref.meta, f).tobytes()
    assert pool.meta.batch_size == ref.meta.batch_size
    assert pool.meta.bucket_sizes == ref.meta.bucket_sizes == packed.bucket_sizes
    assert pool.estimated_device_nbytes() == ref.estimated_device_nbytes() == packed.x.nbytes \
        + packed.y.nbytes
    assert pool.nbytes_on_disk() == ref.nbytes_on_disk()
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())
    dx, dy = DeviceClientPool.build(clients, 8).gather(ids)
    assert dx.tobytes() == x.tobytes() and dy.tobytes() == y.tobytes()
    # gather into a caller's buffers, as the stager does
    bx, by = np.zeros_like(x), np.zeros_like(y)
    pool.gather(ids, out=(bx, by))
    assert bx.tobytes() == x.tobytes() and by.tobytes() == y.tobytes()
    with pytest.raises(IndexError, match="out of range"):
        pool.gather([7])
    assert len(pool._files) == 6                 # x and y of the 3 shards, open
    pool.close()
    assert not pool._files and pool.gather(ids)[0].tobytes() == x.tobytes()


def test_from_generator_full_batch_and_round_trip():
    clients = _clients([9, 24, 17])
    pool = StreamedClientPool.from_generator((c for c in clients), None, shard_clients=2)
    ref = RefStreamedPool.from_generator((c for c in clients), None, shard_clients=2)
    x, _ = pool.gather(np.arange(3))
    assert x.tobytes() == pack_clients(clients, None).x.tobytes() == ref.gather(np.arange(3))[0] \
        .tobytes()
    assert pool.meta.max_steps_per_epoch == ref.meta.max_steps_per_epoch == 1
    for (cx, cy), (px, py) in zip(clients, pool.iter_clients()):
        assert cx.tobytes() == px.tobytes() and cy.tobytes() == py.tobytes()
    root = pool.root
    del pool                                        # a temporary root goes with its pool
    import gc
    import os
    gc.collect()
    assert not os.path.exists(root)
    with pytest.raises(ValueError, match="at least one client"):
        StreamedClientPool.from_generator(iter([]), 8)
    with pytest.raises(ValueError, match="consistently"):
        StreamedClientPool.build([clients[0], (clients[1][0], None)], 8)


def test_cohort_stager_on_the_cpu_hands_back_the_gather():
    clients = _clients()
    pool = StreamedClientPool.build(clients, 8, shard_clients=2)
    st = CohortStager(pool, 3, 6, torch.device("cpu"))
    ids = np.array([4, 1, 2])
    mask = np.ones((3, 6), np.float32)
    (x, y, n_real, m), event = st.stage(ids, pool.counts[ids], mask)
    assert event is None and st.ready((x, y, n_real, m), event)[0] is x
    gx, gy = pool.gather(ids)
    assert x.numpy().tobytes() == gx.tobytes() and y.numpy().tobytes() == gy.tobytes()
    assert n_real.tolist() == [14, 24, 17] and n_real.dtype == torch.int64
    assert st.nbytes == x.numel() * 4 + y.numel() * 4 + 3 * 8 + 3 * 6 * 4


# ---------------------------------------------------------------------------
# streamed == device, bit for bit
# ---------------------------------------------------------------------------

LANES = {
    "plain": {},
    "fedavgm": {"strategy": FedAvgM(momentum=0.9)},
    "q8": {"codec": quantize_codec(8, chunk=64)},
    "topk": {"codec": topk_codec(0.1)},
}


@pytest.mark.parametrize("lane", sorted(LANES))
def test_streamed_equals_device_bitwise(setup, lane):
    dev = _engine(setup, "device", **LANES[lane])
    st = _engine(setup, "streamed", pool_shard_clients=2, **LANES[lane])
    assert dev.pool_kind == "device" and st.pool_kind == "streamed"
    assert st._x is None and st.pool.num_shards == 3
    dev.run(5)
    st.run(5)
    _assert_same_run(dev, st)
    assert st._prefetched is not None and st._prefetched["for_round"] == 5


def test_prefetch_zero_equals_prefetch_one(setup):
    base = _engine(setup, "streamed")
    off = _engine(setup, "streamed", prefetch=0)
    base.run(4)
    off.run(4)
    assert off._prefetched is None
    _assert_same_run(base, off)
    # a round out of turn discards the prefetch and rewinds its draw
    base._prefetched["for_round"] = 99
    base.run(1)
    off.run(1)
    _assert_same_run(base, off)


def test_prebuilt_pool_without_client_data(setup):
    model, params, clients = setup
    pool = StreamedClientPool.build(clients, CFG["B"], shard_clients=2)
    st = RoundEngine(model.loss, params, None, FedAvgConfig(**CFG), pool=pool, device="cpu")
    assert st.pool is pool and st.num_clients == len(clients)
    dev = _engine(setup, "device")
    st.run(3)
    dev.run(3)
    _assert_same_run(dev, st)
    with pytest.raises(ValueError, match="client_data is None"):
        RoundEngine(model.loss, params, None, FedAvgConfig(**CFG), device="cpu")


def test_materialize_round_batch_is_the_same_on_both_pools(setup):
    dev, st = _engine(setup, "device"), _engine(setup, "streamed")
    ids = np.array([1, 4, 0])
    (bd, md, wd), (bs, ms, ws) = (e.materialize_round_batch(ids, 11) for e in (dev, st))
    assert all(torch.equal(a, b) for a, b in zip(bd + (md, wd), bs + (ms, ws)))
    m = st._m                                    # a round's cohort: the staged rows
    assert st.staged_bytes == m * st.packed.max_steps_per_epoch * 8 * (12 * 4 + 4) + m * 8 \
        + m * CFG["E"] * st.packed.max_real_steps_per_epoch * 4
    assert dev.staged_bytes == 0


# ---------------------------------------------------------------------------
# checkpoints across the two pools, the pending prefetch discarded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first,then", [("device", "streamed"), ("streamed", "device")])
def test_resume_across_pools_bitwise(setup, tmp_path, first, then):
    straight = _engine(setup, "device")
    straight.run(6)
    a = _engine(setup, first)
    a.run(3)
    a.save(tmp_path / "ck")
    b = _engine(setup, then)
    assert b.restore(tmp_path / "ck") == 3
    b.run(3)
    _assert_same_run(straight, b)


def test_checkpoint_discards_the_pending_prefetch(setup, tmp_path):
    straight = _engine(setup, "device")
    straight.run(6)
    st = _engine(setup, "streamed")
    st.run(3)
    ahead = st.rng.bit_generator.state
    assert st._prefetched is not None            # round 4's cohort is drawn and staged
    st.save(tmp_path / "ck")
    assert st._prefetched is None and st.rng.bit_generator.state != ahead
    d = _engine(setup, "device")
    d.restore(tmp_path / "ck")
    d.run(3)
    _assert_same_run(straight, d)
    st.run(3)                                    # the saver replays the discarded draw
    _assert_same_run(straight, st)
    st.restore(tmp_path / "ck")                  # a restore discards it too
    assert st._prefetched is None and st.round_idx == 3


# ---------------------------------------------------------------------------
# selection and refusals
# ---------------------------------------------------------------------------

def test_auto_selects_the_pool_by_budget(setup, monkeypatch):
    assert _engine(setup, "auto").pool_kind == "device"
    monkeypatch.setenv("REPRO_DEVICE_POOL_BUDGET", "64")
    eng = _engine(setup, "auto")
    assert eng.pool_kind == "streamed"
    dev_est = eng.pool.estimated_device_nbytes()
    assert dev_est > 64
    with pytest.raises(ValueError, match="pool='streamed'"):
        _engine(setup, "device")
    with pytest.raises(ValueError, match="latency/async"):
        _engine(setup, "auto", latency=LatencyModel(mean_s=1.0))
    # the superstep lane streams too: a chunk staged at once
    auto = _engine(setup, "auto", device_sampling=True)
    assert auto.pool_kind == "streamed"
    auto.run(3, rounds_per_step=3)
    monkeypatch.delenv("REPRO_DEVICE_POOL_BUDGET")
    dev = _engine(setup, "device", device_sampling=True)
    dev.run(3, rounds_per_step=3)
    _assert_same_run(dev, auto)
    monkeypatch.setenv("REPRO_DEVICE_POOL_BUDGET", "64")
    # a gossip engine trains every node every round: "auto" resolves to the
    # device pool there, so over the budget it raises as pool="device" does
    with pytest.raises(ValueError, match="budget"):
        _engine(setup, "auto", cfg=dict(CFG, C=1.0), topology="ring")


def test_streamed_refusals(setup):
    model, params, clients = setup
    assert _engine(setup, "streamed", device_sampling=True).device_sampling  # the staged superstep
    with pytest.raises(ValueError, match="latency/async"):
        _engine(setup, "streamed", latency=LatencyModel(mean_s=1.0))
    with pytest.raises(ValueError, match="latency/async"):
        _engine(setup, "streamed", async_config=AsyncConfig(buffer_k=2))
    with pytest.raises(ValueError, match="device pool"):
        _engine(setup, "streamed", cfg=dict(CFG, C=1.0), topology="ring")
    with pytest.raises(ValueError, match="pool must be"):
        _engine(setup, "banana")
    with pytest.raises(ValueError, match="prefetch"):
        _engine(setup, "streamed", prefetch=-1)
    pool = StreamedClientPool.build(clients, 4, shard_clients=2)
    with pytest.raises(ValueError, match="batch_size"):
        RoundEngine(model.loss, params, None, FedAvgConfig(**CFG), pool=pool, device="cpu")


def test_from_spec_streamed_pool(setup, tmp_path):
    model, params, clients = setup
    spec = ExperimentSpec(
        name="pool_test", model=ModelSpec("mnist_2nn", {"n_classes": 5, "d_in": 12}),
        partition=PartitionSpec("iid", n_clients=len(clients)), fedavg=FedAvgConfig(**CFG),
        execution=ExecutionSpec(pool="streamed", pool_shard_clients=2, prefetch=0))
    back = ExperimentSpec.from_json(spec.to_json())
    assert back == spec
    eng = RoundEngine.from_spec(back, clients, init_params=params, device="cpu")
    assert eng.pool_kind == "streamed" and eng.pool.num_shards == 3
    assert eng._prefetch_depth == 0
    dev = _engine(setup, "device")
    eng.run(3)
    dev.run(3)
    _assert_same_run(dev, eng)
    superstep = dataclasses.replace(spec, execution=ExecutionSpec(
        pool="streamed", device_sampling=True, rounds_per_step=5, pool_shard_clients=2))
    st = RoundEngine.from_spec(ExperimentSpec.from_json(superstep.to_json()), clients,
                               init_params=params, device="cpu")
    assert st.pool_kind == "streamed" and st.device_sampling
    assert st.default_rounds_per_step == 5
    dev = _engine(setup, "device", device_sampling=True)
    st.run(5)
    dev.run(5, rounds_per_step=5)
    _assert_same_run(dev, st)


# ---------------------------------------------------------------------------
# the staged superstep: streamed == device pool on the superstep lane
# ---------------------------------------------------------------------------

SUPERSTEP_LANES = {
    "plain": {},
    "q8": {"codec": quantize_codec(8, chunk=64)},
    "fedavgm": {"strategy": FedAvgM(0.9)},
}


@pytest.mark.parametrize("lane", sorted(SUPERSTEP_LANES))
def test_streamed_superstep_equals_the_device_superstep_bitwise(setup, lane):
    """Chunks of R = 3: the streamed engine draws each chunk's cohorts from
    the ids generator, stages their rows as one block and replays the round
    on them; params, strategy state, losses and both generators equal the
    device pool's superstep, bit for bit."""
    kw = dict(device_sampling=True, **SUPERSTEP_LANES[lane])
    dev, st = _engine(setup, "device", **kw), _engine(setup, "streamed", **kw)
    dev.run(6, rounds_per_step=3)
    st.run(6, rounds_per_step=3)
    _assert_same_run(dev, st)
    assert st._prefetched is not None and st._prefetched["r"] == 3   # the next chunk
    st._discard_prefetch()
    assert torch.equal(dev._gen.get_state(), st._gen.get_state())
    assert torch.equal(dev._ids_gen.get_state(), st._ids_gen.get_state())
    assert st.num_compilations == dev.num_compilations == 1


@pytest.mark.parametrize("prefetch", [1, 0])
def test_streamed_ragged_superstep_matches_device(setup, prefetch):
    """7 = 3 + 3 + 1: the last, ragged chunk discards the prefetched chunk
    of 3 and rewinds the ids generator exactly (the reference's
    ``test_streamed_ragged_superstep_matches_device``); ``round()`` then
    stages a chunk of 1."""
    dev = _engine(setup, "device", device_sampling=True)
    st = _engine(setup, "streamed", device_sampling=True, prefetch=prefetch)
    dev.run(7, rounds_per_step=3)
    st.run(7, rounds_per_step=3)
    _assert_same_run(dev, st)
    a, b = dev.round(), st.round()
    assert torch.equal(a["loss"], b["loss"])
    assert (st._prefetched is None) == (prefetch == 0)


def test_streamed_superstep_checkpoint_discards_the_pending_chunk(setup, tmp_path):
    """``save`` after a chunk drops the staged next chunk and rewinds the
    ids generator, so the checkpoint is the device pool's: a device engine
    restores it and runs on bitwise, and so does the saver (the reference's
    ``test_streamed_checkpoint_discards_pending_prefetch``); a streamed
    engine resumes a device-pool checkpoint."""
    straight = _engine(setup, "device", device_sampling=True)
    straight.run(6, rounds_per_step=3)
    st = _engine(setup, "streamed", device_sampling=True)
    st.run(3, rounds_per_step=3)
    ahead = st._ids_gen.get_state().clone()
    assert st._prefetched is not None
    st.save(tmp_path / "b")
    assert st._prefetched is None and not torch.equal(st._ids_gen.get_state(), ahead)
    d = _engine(setup, "device", device_sampling=True)
    assert d.restore(tmp_path / "b") == 3
    d.run(3, rounds_per_step=3)
    _assert_same_run(straight, d)
    st.run(3, rounds_per_step=3)
    _assert_same_run(straight, st)
    back = _engine(setup, "streamed", device_sampling=True)
    d2 = _engine(setup, "device", device_sampling=True)
    d2.run(3, rounds_per_step=3)
    d2.save(tmp_path / "a")
    assert back.restore(tmp_path / "a") == 3
    back.run(3, rounds_per_step=3)
    _assert_same_run(straight, back)


def test_a_chunk_is_staged_as_one_block(setup):
    """``CohortStager.stage_chunk`` on the CPU: an (r, m, n_pad, ...) block
    whose rounds are the cohorts' gathers; the engine's ``staged_bytes`` on
    the superstep lane is a round's rows and ids."""
    st = _engine(setup, "streamed", device_sampling=True)
    ids = np.asarray([[1, 4], [0, 2], [3, 1]])
    (xs, ys), event = st._stager.stage_chunk(ids)
    assert event is None and xs.shape[:2] == (3, 2) and ys.shape[:2] == (3, 2)
    for j, row in enumerate(ids):
        x, y = st.pool.gather(row)
        assert xs[j].numpy().tobytes() == x.tobytes() and ys[j].numpy().tobytes() == y.tobytes()
    n_pad = st.pool.n_pad
    assert st.staged_bytes == st._m * n_pad * (12 * 4 + 4) + 8 * st._m
    assert st._stager.pinned_nbytes == 0                 # nothing is pinned on the CPU
