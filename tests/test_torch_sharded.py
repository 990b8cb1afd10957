"""repro_torch's cohort sharding held against the reference (counterpart of
``tests/test_engine_sharded.py``).

The port's client mesh is a ``torch.distributed`` group; here it is gloo on
the CPU. A world of one (``HashStore``) runs the whole sharded code path in
this process: the four partial-sum adapters and the round step against the
reference's inside ``shard_map`` on the same numpy inputs, and every lane's
sharded engine against the unsharded one. A world of three processes over a
``FileStore`` splits the cohort for real, ghost slots and all-ghost ranks
included, in one spawn that runs every lane and the four kernels."""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.core import FedAvgConfig as RefConfig  # noqa: E402
from repro.core import RoundEngine as RefEngine  # noqa: E402
from repro.core.engine import RoundBatch as RefBatch  # noqa: E402
from repro.core.engine import RoundState as RefState  # noqa: E402
from repro.core.engine import build_simulation_round_step as ref_round_step  # noqa: E402
from repro.core.strategies import FedAvg as RefFedAvg  # noqa: E402
from repro.core.strategies import FedAvgM as RefFedAvgM  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.quantized_agg import dequantize_ref as ref_dequantize  # noqa: E402
from repro.kernels.quantized_agg import unpack_ref as ref_unpack  # noqa: E402
from repro.kernels.sparse_agg import densify_ref as ref_densify  # noqa: E402
from repro.launch.mesh import make_client_mesh as ref_client_mesh  # noqa: E402
from repro.models import paper as ref_paper  # noqa: E402
from repro.utils.tree import tree_weighted_mean  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.compression import (  # noqa: E402
    identity_codec,
    lowrank_codec,
    mask_codec,
    quantize_codec,
    topk_codec,
)
from repro_torch.core.engine import (  # noqa: E402
    RoundBatch,
    RoundEngine,
    RoundState,
    build_simulation_round_step,
)
from repro_torch.core.fedavg import CohortSlice, FedAvgConfig, shard_rows  # noqa: E402
from repro_torch.core.latency import LatencyModel  # noqa: E402
from repro_torch.core.scheduler import AsyncConfig  # noqa: E402
from repro_torch.core.strategies import FedAvg, FedAvgM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fedavg_agg import fedavg_aggregate  # noqa: E402
from repro_torch.kernels.quantized_agg import (  # noqa: E402
    packed_quantized_aggregate,
    quantized_aggregate,
)
from repro_torch.kernels.sparse_agg import sparse_aggregate  # noqa: E402
from repro_torch.launch.mesh import make_client_mesh  # noqa: E402
from repro_torch.models import paper  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_ravel  # noqa: E402

torch.set_num_threads(1)

CHUNK, BITS = 64, 4
SPLIT_WORLD = 3
SPLIT_DEADLINE_S = 240.0


@pytest.fixture(scope="module")
def mesh():
    """A gloo world of one in this process, and its client mesh."""
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield make_client_mesh(device="cpu")
    if started:
        dist.destroy_process_group()


def _group(mesh):
    return mesh.get_group("clients")


# ---------------------------------------------------------------------------
# the inputs of the four adapters, from one numpy seed
# ---------------------------------------------------------------------------

def _weights(rng, K):
    w = rng.uniform(0.5, 4.0, K).astype(np.float32)
    w[-1] = 0.0                              # a ghost row: vanishes from the mean
    return w


def _fedavg_inputs(rng, K):
    tree = {"w": rng.normal(size=(K, 33, 3)).astype(np.float32),
            "b": rng.normal(size=(K, 7)).astype(np.float32)}
    return tree, _weights(rng, K)


def _quant_inputs(rng, K, C=5):
    codes = rng.integers(0, 256, (K, C * CHUNK)).astype(np.uint8)
    words = rng.integers(0, 2**32, (K, C * CHUNK * BITS // 32), dtype=np.uint64).astype(np.uint32)
    lo = rng.normal(size=(K, C)).astype(np.float32)
    scale = rng.uniform(0.0, 2.0, (K, C)).astype(np.float32)
    return codes, words, lo, scale, _weights(rng, K)


def _sparse_inputs(rng, K, n=257, k=9):
    idx = np.stack([rng.choice(n, size=k, replace=False) for _ in range(K)]).astype(np.int32)
    vals = rng.normal(size=(K, k)).astype(np.float32)
    return idx, vals, _weights(rng, K), n


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_sharded(fn, *args):
    """``fn(*args)`` inside a ``shard_map`` over the reference's client mesh,
    every argument split along its client axis."""
    f = shard_map(fn, mesh=ref_client_mesh(), in_specs=tuple(P("clients") for _ in args),
                  out_specs=P(), check_vma=False)
    return f(*[jax.tree.map(jnp.asarray, a) for a in args])


# ---------------------------------------------------------------------------
# the partial-sum adapters, port against reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [3, 6])
def test_sharded_fedavg_aggregate_matches_reference(mesh, K):
    tree, w = _fedavg_inputs(np.random.default_rng(K), K)
    want = _ref_sharded(lambda t, ww: ref_ops.sharded_fedavg_aggregate(
        t, ww, axis_name="clients", interpret=True), tree, w)
    for kw in ({}, {"total": float(w.sum())}):
        got = ops.sharded_fedavg_aggregate({k: _t(v) for k, v in tree.items()}, _t(w),
                                           group=_group(mesh), **kw)
        for name in tree:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=1e-5)


@pytest.mark.parametrize("K", [3, 6])
def test_sharded_quantized_fedavg_aggregate_matches_reference(mesh, K):
    codes, _, lo, scale, w = _quant_inputs(np.random.default_rng(K), K)
    want = _ref_sharded(lambda c, l, s, ww: ref_ops.sharded_quantized_fedavg_aggregate(
        c, l, s, ww, chunk=CHUNK, levels=255, axis_name="clients", interpret=True),
        codes, lo, scale, w)
    got = ops.sharded_quantized_fedavg_aggregate(_t(codes), _t(lo), _t(scale), _t(w),
                                                 chunk=CHUNK, levels=255, group=_group(mesh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("K", [3, 6])
def test_sharded_packed_quantized_fedavg_aggregate_matches_reference(mesh, K):
    _, words, lo, scale, w = _quant_inputs(np.random.default_rng(K), K)
    levels = 2**BITS - 1
    want = _ref_sharded(lambda x, l, s, ww: ref_ops.sharded_packed_quantized_fedavg_aggregate(
        x, l, s, ww, bits=BITS, chunk=CHUNK, levels=levels, axis_name="clients",
        interpret=True), words, lo, scale, w)
    got = ops.sharded_packed_quantized_fedavg_aggregate(
        _t(words.view(np.int32)), _t(lo), _t(scale), _t(w), bits=BITS, chunk=CHUNK,
        levels=levels, group=_group(mesh), total=float(w.sum()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("K", [3, 6])
def test_sharded_sparse_fedavg_aggregate_matches_reference(mesh, K):
    idx, vals, w, n = _sparse_inputs(np.random.default_rng(K), K)
    want = _ref_sharded(lambda i, v, ww: ref_ops.sharded_sparse_fedavg_aggregate(
        i, v, ww, n, axis_name="clients", interpret=True), idx, vals, w)
    got = ops.sharded_sparse_fedavg_aggregate(_t(idx), _t(vals), _t(w), n, group=_group(mesh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_carry_rides_the_partial_sums_all_reduce(mesh):
    """``carry`` is summed in the same all-reduce and the mean is unchanged."""
    tree, w = _fedavg_inputs(np.random.default_rng(0), 4)
    stacked = {k: _t(v) for k, v in tree.items()}
    carry = torch.tensor([2.5, -1.0])
    plain = ops.sharded_fedavg_aggregate(stacked, _t(w), group=_group(mesh))
    got = ops.sharded_fedavg_aggregate(stacked, _t(w), group=_group(mesh), carry=carry)
    assert all(torch.equal(got[k], plain[k]) for k in tree)
    assert carry.tolist() == [2.5, -1.0]     # a world of one sums to itself


def test_partial_sum_mode_takes_raw_and_all_zero_weights():
    """``normalized=False`` skips the CPU sum==1 check and nothing else: raw
    counts give the plain weighted sum, an all-ghost shard exactly 0; the
    default still refuses weights that do not sum to 1."""
    rng = np.random.default_rng(1)
    codes, words, lo, scale, _ = _quant_inputs(rng, 3)
    idx, vals, _, n = _sparse_inputs(rng, 3)
    x = _t(rng.normal(size=(3, 40)).astype(np.float32))
    raw = torch.tensor([9.0, 24.0, 0.0])
    calls = {
        "fedavg_aggregate": lambda w, **kw: fedavg_aggregate(x, w, **kw),
        "quantized_aggregate": lambda w, **kw: quantized_aggregate(
            _t(codes), _t(lo), _t(scale), w, chunk=CHUNK, levels=255, **kw),
        "packed_quantized_aggregate": lambda w, **kw: packed_quantized_aggregate(
            _t(words.view(np.int32)), _t(lo), _t(scale), w, bits=BITS, chunk=CHUNK,
            levels=2**BITS - 1, **kw),
        "sparse_aggregate": lambda w, **kw: sparse_aggregate(_t(idx), _t(vals), w, n, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="pre-normalized"):
            call(raw)
        scaled = call(raw / raw.sum())
        torch.testing.assert_close(call(raw, normalized=False) / raw.sum(), scaled,
                                   rtol=1e-5, atol=1e-6, msg=name)
        zero = call(torch.zeros(3), normalized=False)
        assert torch.equal(zero, torch.zeros_like(zero)), name


@pytest.mark.parametrize("with_total", [False, True])
def test_sharded_masked_weighted_loss_matches_reference(mesh, with_total):
    """Sum-then-divide over the group (or, given the cohort's total, each
    rank's share), against the reference's ``axis_name`` branch."""
    from repro.core.fedavg import masked_weighted_loss as ref_loss
    from repro_torch.core.fedavg import masked_weighted_loss

    rng = np.random.default_rng(3)
    losses = rng.uniform(0.1, 3.0, (5, 7)).astype(np.float32)
    mask = (rng.uniform(size=(5, 7)) < 0.8).astype(np.float32)
    w = _weights(rng, 5)
    want = _ref_sharded(lambda l, m, ww: ref_loss(l, m, ww, axis_name="clients"),
                        losses, mask, w)
    got = masked_weighted_loss(_t(losses), _t(mask), _t(w), group=_group(mesh),
                               total=float(w.sum()) if with_total else None)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


def test_shard_rows_cuts_the_whole_cohorts_draw():
    full = torch.arange(10.0).reshape(5, 2)
    assert shard_rows(full, None) is full
    torch.testing.assert_close(shard_rows(full, CohortSlice(5, 2, 4)), full[2:4])
    # m = 5 padded to 6 over 3 ranks: the last rank holds slot 4 and a ghost
    torch.testing.assert_close(shard_rows(full, CohortSlice(5, 4, 6)),
                               torch.tensor([[8.0, 9.0], [0.0, 0.0]]))
    assert shard_rows(full, CohortSlice(1, 1, 2)).tolist() == [[0.0, 0.0]]   # all ghost


# ---------------------------------------------------------------------------
# one sharded round step on the reference's own batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["fedavg", "fedavgm"])
def test_sharded_round_step_matches_reference(mesh, strategy):
    sizes = [9, 24, 17, 40]
    r = np.random.default_rng(0)
    clients = [(r.normal(size=(n, 20)).astype(np.float32),
                r.choice([i % 5, (i + 1) % 5], n).astype(np.int32)) for i, n in enumerate(sizes)]
    ref_model = ref_paper.mnist_2nn(n_classes=5, d_in=20)
    model = paper.mnist_2nn(n_classes=5, d_in=20, device="cpu")
    jp = ref_model.init(jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.array, jp), model, device="cpu")
    ref_strategy, port_strategy = ((RefFedAvg(), FedAvg()) if strategy == "fedavg"
                                   else (RefFedAvgM(momentum=0.9), FedAvgM(0.9)))
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(C=0.75, E=2, B=8, lr=0.2, seed=7),
                    interpret=True)
    ids, _, key, lr = ref._next_round_inputs()
    batch, mask, w = ref.materialize_round_batch(ids, key)
    ref_outer = ref_strategy.init_state(jp)
    step = ref_round_step(ref_model.loss, interpret=True, axis_name="clients",
                          strategy=ref_strategy)
    want, wm = shard_map(
        lambda st, b, msk, ww: step(st, RefBatch(b, msk, ww, lr=lr)),
        mesh=ref_client_mesh(),
        in_specs=(P(), P("clients"), P("clients"), P("clients")),
        out_specs=(P(), P()), check_vma=False,
    )(RefState(jp, outer_state=ref_outer), batch, mask, w)
    got, gm = build_simulation_round_step(model.loss, strategy=port_strategy,
                                          group=_group(mesh))(
        RoundState(tp, outer_state=port_strategy.init_state(tp)),
        RoundBatch(tuple(_t(np.array(b)) for b in batch), _t(np.array(mask)),
                   _t(np.array(w)), lr=float(lr)))
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]), rtol=1e-5, atol=1e-5)
    got_np = params_to_numpy(got.params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want.params)[0]:
        g = got_np
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, np.asarray(leaf), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine: sharded against unsharded, in the port
# ---------------------------------------------------------------------------

def _clients(sizes, seed=0, d=12, classes=5):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(n, d)).astype(np.float32),
             r.integers(0, classes, n).astype(np.int32)) for n in sizes]


SIZES = [9, 24, 17, 40, 8, 33, 21, 14]
SPLIT_SIZES = [9, 24, 17, 40, 8, 33, 21, 14, 12, 19]     # m = 8 of 10 over 3 ranks

# lane -> (engine kwargs, rounds, param atol, loss atol): the reference's
# cases and tolerances (tests/test_engine_sharded.py:163-232), low-rank and a
# device-sampled (superstep) lane besides.
LANES = {
    "plain": ({}, 4, 1e-5, 1e-5),
    "q8": ({"codec": quantize_codec(8, chunk=256)}, 4, 1e-3, 1e-4),
    "q4": ({"codec": quantize_codec(4, chunk=256)}, 3, 2e-3, 1e-3),
    "topk": ({"codec": topk_codec(0.05)}, 3, 1e-3, 1e-4),
    "mask": ({"codec": mask_codec(0.25)}, 3, 1e-5, 1e-5),
    "identity": ({"codec": identity_codec()}, 3, 1e-5, 1e-5),
    "lowrank": ({"codec": lowrank_codec(4)}, 3, 1e-5, 1e-5),
    "fedavgm": ({"strategy": FedAvgM(0.9)}, 4, 1e-5, 1e-5),
    "superstep": ({"device_sampling": True}, 4, 1e-5, 1e-5),
}


def _engine(sizes=SIZES, C=0.75, **kw):
    model = paper.mnist_2nn(n_classes=5, d_in=12, device="cpu")
    return RoundEngine(model.loss, model.init(0), _clients(sizes),
                       FedAvgConfig(C=C, E=2, B=8, lr=0.2, seed=7), device="cpu", **kw)


def _run(eng, rounds):
    rps = 2 if eng.device_sampling else None
    hist = eng.run(rounds, rounds_per_step=rps)
    return ([r.train_loss for r in hist.records],
            tree_ravel(eng.params)[0].numpy().copy())


def _assert_close_runs(lane, got, want, param_atol, loss_atol):
    (gl, gp), (wl, wp) = got, want
    assert len(gl) == len(wl), lane
    np.testing.assert_allclose(gl, wl, rtol=0, atol=loss_atol, err_msg=lane)
    np.testing.assert_allclose(gp, wp, rtol=0, atol=param_atol, err_msg=lane)


@pytest.mark.parametrize("lane", sorted(LANES))
def test_sharded_engine_matches_unsharded(mesh, lane):
    """Within the reference's tolerances; and a world of one divides each
    weight by the cohort's total before its partial sum, as the unsharded
    round normalizes, so its runs are the unsharded ones bit for bit."""
    kw, rounds, param_atol, loss_atol = LANES[lane]
    base = _run(_engine(**kw), rounds)
    shrd = _engine(mesh=mesh, **kw)
    assert shrd._shards == 1 and shrd._slots == CohortSlice(6, 0, 6)
    got = _run(shrd, rounds)
    _assert_close_runs(lane, got, base, param_atol, loss_atol)
    assert got[0] == base[0] and np.array_equal(got[1], base[1]), lane


def test_sharded_engine_checkpoint_resume(mesh, tmp_path):
    """4 rounds == 2 + save + restore + 2, bitwise, and the checkpoint
    records the mesh's size."""
    straight = _engine(mesh=mesh)
    h_straight = straight.run(4)
    first = _engine(mesh=mesh)
    first.run(2)
    path = first.save(tmp_path)
    assert path.endswith("step_00000002")
    from repro_torch.checkpoint.io import peek_metadata

    assert peek_metadata(tmp_path)["mesh_shards"] == 1
    resumed = _engine(mesh=mesh)
    assert resumed.restore(tmp_path) == 2
    h = resumed.run(2)
    assert [r.train_loss for r in h.records] == [r.train_loss for r in h_straight.records]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params),
                                                 tree_leaves(straight.params)))


@pytest.mark.parametrize("kw,match", [
    ({"client_axis": "nope"}, "client_axis"),
    ({"topology": "ring"}, "topology= is incompatible with mesh="),
    ({"pool": "streamed"}, "pool='streamed' is incompatible with mesh="),
    ({"latency": LatencyModel(kind="exponential", mean_s=1.0)}, "incompatible with mesh="),
    ({"async_config": AsyncConfig(buffer_k=2)}, "incompatible with mesh="),
])
def test_sharded_engine_refuses_what_the_reference_refuses(mesh, kw, match):
    with pytest.raises(ValueError, match=match):
        _engine(mesh=mesh, **kw)


def test_make_client_mesh_refuses_a_partial_world(mesh):
    with pytest.raises(ValueError, match="whole world"):
        make_client_mesh(num_devices=2, device="cpu")
    assert make_client_mesh(axis="cohort", device="cpu").mesh_dim_names == ("cohort",)


# ---------------------------------------------------------------------------
# a real split: a gloo world of three processes
# ---------------------------------------------------------------------------

# lane -> (engine kwargs, C): m = 8 of 10 clients (9 slots, one ghost on the
# last rank) on every lane; m = 1 (two all-ghost ranks) on the plain lane.
SPLIT_LANES = {**{lane: (kw, 0.8) for lane, (kw, _, _, _) in LANES.items()},
               "plain_m1": ({}, 0.1)}
SPLIT_ROUNDS = 3


def _split_kernel_inputs():
    """The four kernels' global inputs: 9 rows, 3 a rank, the last a ghost."""
    rng = np.random.default_rng(42)
    return (_fedavg_inputs(rng, 9), _quant_inputs(rng, 9), _sparse_inputs(rng, 9))


def _split_worker(rank, world, store_path, out_dir):
    """One rank of the split: every lane sharded, a sharded resume, and the
    four adapters on this rank's rows; results to ``out_dir/rank<r>.npz``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_client_mesh(device="cpu")
        out = {}
        for lane, (kw, C) in SPLIT_LANES.items():
            eng = _engine(SPLIT_SIZES, C=C, mesh=mesh, **kw)
            out[f"{lane}/loss"], out[f"{lane}/params"] = _run(eng, SPLIT_ROUNDS)
            out[f"{lane}/slots"] = np.asarray(eng._slots[:3])
        first = _engine(SPLIT_SIZES, C=0.8, mesh=mesh)
        first.run(1)
        first.save(os.path.join(out_dir, "ckpt"))
        resumed = _engine(SPLIT_SIZES, C=0.8, mesh=mesh)
        resumed.restore(os.path.join(out_dir, "ckpt"))
        out["resume/loss"], out["resume/params"] = _run(resumed, SPLIT_ROUNDS - 1)
        group, sl = mesh.get_group("clients"), slice(3 * rank, 3 * rank + 3)
        (tree, w), (codes, words, lo, scale, qw), (idx, vals, sw, n) = _split_kernel_inputs()
        out["kernel/fedavg"] = tree_ravel(ops.sharded_fedavg_aggregate(
            {k: _t(v[sl]) for k, v in tree.items()}, _t(w[sl]), group=group))[0].numpy()
        out["kernel/q8"] = ops.sharded_quantized_fedavg_aggregate(
            _t(codes[sl]), _t(lo[sl]), _t(scale[sl]), _t(qw[sl]), chunk=CHUNK, levels=255,
            group=group).numpy()
        out["kernel/q4"] = ops.sharded_packed_quantized_fedavg_aggregate(
            _t(words[sl].view(np.int32)), _t(lo[sl]), _t(scale[sl]), _t(qw[sl]), bits=BITS,
            chunk=CHUNK, levels=2**BITS - 1, group=group).numpy()
        out["kernel/topk"] = ops.sharded_sparse_fedavg_aggregate(
            _t(idx[sl]), _t(vals[sl]), _t(sw[sl]), n, group=group).numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(fn, args, nprocs, deadline_s):
    """``fn(rank, *args)`` in ``nprocs`` spawned processes; a rank that
    raises, or a world that has not finished by the deadline, fails."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > end:
                raise AssertionError(f"the world of {nprocs} did not finish in {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def test_a_gloo_world_of_three_splits_every_lane_as_the_unsharded_engine(tmp_path):
    _spawn(_split_worker, (SPLIT_WORLD, str(tmp_path / "store"), str(tmp_path)),
           SPLIT_WORLD, SPLIT_DEADLINE_S)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(SPLIT_WORLD)]
    for key in ranks[0]:
        if not key.endswith("/slots"):
            for other in ranks[1:]:          # every rank holds the same result
                np.testing.assert_array_equal(other[key], ranks[0][key], err_msg=key)
    # the slots: m = 8 -> 9 over 3; m = 1 -> 3 over 3, ranks 1 and 2 all ghosts
    assert [r["plain/slots"].tolist() for r in ranks] == [[8, 0, 3], [8, 3, 6], [8, 6, 9]]
    assert [r["plain_m1/slots"].tolist() for r in ranks] == [[1, 0, 1], [1, 1, 2], [1, 2, 3]]
    got = ranks[0]
    for lane, (kw, C) in SPLIT_LANES.items():
        _, _, param_atol, loss_atol = LANES[lane.split("_")[0]]
        want = _run(_engine(SPLIT_SIZES, C=C, **kw), SPLIT_ROUNDS)
        _assert_close_runs(lane, (got[f"{lane}/loss"], got[f"{lane}/params"]), want,
                           param_atol, loss_atol)
    # a resume across the world equals the straight run bitwise
    np.testing.assert_array_equal(got["resume/loss"], got["plain/loss"])
    np.testing.assert_array_equal(got["resume/params"], got["plain/params"])
    # the four kernels' partial sums against the reference's unsharded mean
    (tree, w), (codes, words, lo, scale, qw), (idx, vals, sw, n) = _split_kernel_inputs()
    want = tree_weighted_mean({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(w))
    np.testing.assert_allclose(
        got["kernel/fedavg"],
        np.concatenate([np.asarray(want[k]).reshape(-1) for k in sorted(tree)]), atol=1e-5)
    dense = {
        "q8": ref_dequantize(jnp.asarray(codes), jnp.asarray(lo), jnp.asarray(scale),
                             chunk=CHUNK, levels=255),
        "q4": ref_dequantize(ref_unpack(jnp.asarray(words), bits=BITS, chunk=CHUNK),
                             jnp.asarray(lo), jnp.asarray(scale), chunk=CHUNK,
                             levels=2**BITS - 1),
        "topk": ref_densify(jnp.asarray(idx), jnp.asarray(vals), n),
    }
    for name, x in dense.items():
        ww = sw if name == "topk" else qw
        np.testing.assert_allclose(got[f"kernel/{name}"],
                                   np.asarray(tree_weighted_mean(x, jnp.asarray(ww))),
                                   atol=1e-5, err_msg=name)
