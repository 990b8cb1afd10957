"""repro_torch's superstep lane on the CPU (counterpart of
``tests/test_engine_superstep.py``).

``RoundEngine(device_sampling=True)`` draws each round's cohort from a host
generator of the ids' own and its batches and codec noise from one torch
generator on its device, and ``run(n, rounds_per_step=R)`` runs R rounds a
host sync. On the CPU the round body runs eagerly, so superstep(R) == R x
``round()`` holds bit for bit on every lane, the top-k and low-rank ones
included (the CPU scatter has no atomics).
Against the reference: the device batch assembly equals the host one on the
same ids and uniforms, and a small non-IID run reaches the reference
superstep run's rounds-to-target within the port's band. Cohorts are never
compared bitwise with the reference: Philox is not threefry."""
import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FedAvgConfig as RefConfig  # noqa: E402
from repro.core import RoundEngine as RefEngine  # noqa: E402
from repro.core.simulation import make_eval_fn as ref_make_eval_fn  # noqa: E402
from repro.models import paper as ref_paper  # noqa: E402
from repro_torch.checkpoint import peek_metadata, save_checkpoint  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.compression import (  # noqa: E402
    lowrank_codec,
    quantize_codec,
    topk_codec,
)
from repro_torch.core.engine import (  # noqa: E402
    IDS_SEED_SALT,
    RoundBatch,
    RoundEngine,
    RoundState,
)
from repro_torch.core.fedavg import (  # noqa: E402
    FedAvgConfig,
    client_update,
    sample_clients_device,
)
from repro_torch.core.simulation import make_eval_fn  # noqa: E402
from repro_torch.core.strategies import FedAvgM  # noqa: E402
from repro_torch.data.partition import partition_pathological_noniid  # noqa: E402
from repro_torch.data.synthetic import make_image_classification  # noqa: E402
from repro_torch.models import paper  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

SIZES = (9, 24, 17, 40, 8, 33)
CFG = dict(C=0.75, E=2, B=8, lr=0.2, lr_decay=0.98, seed=7)
LANES = {
    "plain": {},
    "fedavgm": {"strategy": FedAvgM(0.9)},
    "q8": {"codec": quantize_codec(8, chunk=256)},
    "topk": {"codec": topk_codec(0.1)},
    "lowrank": {"codec": lowrank_codec(4)},
}


def _clients(sizes=SIZES, d=12, classes=5, seed=0):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(n, d)).astype(np.float32),
             r.integers(0, classes, n).astype(np.int32)) for n in sizes]


def _engine(*, device_sampling=True, eval_fn=None, sizes=SIZES, cfg=None, **kw):
    model = paper.mnist_2nn(n_classes=5, d_in=12, device="cpu")
    return RoundEngine(model.loss, model.init(0), _clients(sizes),
                       FedAvgConfig(**(cfg or CFG)), eval_fn=eval_fn,
                       device_sampling=device_sampling, device="cpu", **kw)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _losses(history):
    return [r.train_loss for r in history.records]


def _const_eval(calls=None):
    def ev(params):
        if calls is not None:
            calls.append(1)
        return {"acc": torch.tensor(0.5), "loss": torch.tensor(1.0)}
    return ev


# ---------------------------------------------------------------------------
# the device batch assembly against the host one and the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(C=0.75, E=2, B=8), dict(C=0.5, E=3, B=5)],
                         ids=["E2B8", "E3B5"])
def test_device_assembly_equals_the_host_assembly(cfg):
    """Same ids, same uniforms: the device assembly (device counts and
    steps per epoch) gives the host assembly's batches, step mask and
    weights exactly, and its mask and weights are the reference's."""
    full = dict(CFG, **cfg)
    eng = _engine(cfg=full)
    ref_model = ref_paper.mnist_2nn(n_classes=5, d_in=12)
    ref = RefEngine(ref_model.loss, ref_model.init(jax.random.PRNGKey(0)), _clients(),
                    RefConfig(**{k: v for k, v in full.items()}), interpret=True)
    ids = np.asarray([4, 1, 3, 0][: round(full["C"] * len(SIZES))])
    seed = 1234
    want_batch, want_mask, want_w = eng.materialize_round_batch(ids, seed)
    gen = torch.Generator().manual_seed(seed)
    u = eng._batch_uniforms(len(ids), gen)
    batch, mask, w = eng.assemble_round_batch(torch.from_numpy(ids.astype(np.int64)), u)
    assert all(torch.equal(a, b) for a, b in zip(batch, want_batch))
    assert torch.equal(mask, want_mask) and torch.equal(w, want_w)
    assert w.dtype == torch.float32 and mask.dtype == torch.float32
    _, ref_mask, ref_w = ref.materialize_round_batch(ids, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref_w))


def test_round_draws_cohort_then_batches_then_codec_noise():
    """The cohort from the ids generator (a host generator seeded with
    ``seed ^ IDS_SEED_SALT``), then from the engine's generator the batch
    uniforms (m, E, n_pad) and the codec's noise. Replaying those draws by
    hand through the round step gives the engine's round bit for bit, and
    both pairs of generators end in the same states."""
    eng = _engine(codec=quantize_codec(8, chunk=256))
    model = paper.mnist_2nn(n_classes=5, d_in=12, device="cpu")
    gen = torch.Generator().manual_seed(CFG["seed"])
    ids_gen = torch.Generator().manual_seed(CFG["seed"] ^ IDS_SEED_SALT)
    m = round(CFG["C"] * len(SIZES))
    ids = sample_clients_device(ids_gen, len(SIZES), m)
    batch, mask, w = eng.assemble_round_batch(ids, eng._batch_uniforms(m, gen))
    lr = torch.tensor(CFG["lr"], dtype=torch.float32)
    state, metrics = eng._round_step(RoundState(model.init(0), ()),
                                     RoundBatch(batch, mask, w, lr=lr, gen=gen))
    got = eng.round()
    assert torch.equal(got["loss"], metrics["loss"])
    assert _equal(eng.params, state.params)
    assert torch.equal(eng._gen.get_state(), gen.get_state())
    assert torch.equal(eng._ids_gen.get_state(), ids_gen.get_state())


def test_a_chunk_draws_its_cohorts_on_the_host_before_its_rounds():
    """A chunk of R takes its R cohorts from the ids generator up front (the
    host knows them without a sync); the device generator then draws only
    the rounds' batches and noise, so drawing the ids ahead leaves the
    rounds unchanged (superstep == R x ``round()`` is the lanes' test) and
    the ids stream after a chunk is R draws of ``sample_clients_device``."""
    eng = _engine()
    m = eng._m
    ids_gen = torch.Generator().manual_seed(CFG["seed"] ^ IDS_SEED_SALT)
    want = torch.stack([sample_clients_device(ids_gen, len(SIZES), m) for _ in range(4)])
    seen = []
    body = eng._device_round

    def spy(params, outer, lr, ids, *rows):
        seen.append(ids.clone())
        return body(params, outer, lr, ids, *rows)

    eng._device_round = spy
    eng.run(4, rounds_per_step=4)
    assert torch.equal(torch.stack(seen), want)
    assert torch.equal(eng._ids_gen.get_state(), ids_gen.get_state())
    assert all(len(set(row.tolist())) == m for row in want)


def test_client_update_takes_lr_as_a_tensor_bit_for_bit():
    """A 0-d fp32 lr (the captured round's static buffer) gives a float
    lr's bits."""
    model = paper.mnist_2nn(n_classes=5, d_in=12, device="cpu")
    eng = _engine(device_sampling=False)
    batch, mask, _ = eng.materialize_round_batch(np.asarray([0, 3, 5]), 11)
    a, la = client_update(model.loss, model.init(0), batch, mask, 0.2)
    b, lb = client_update(model.loss, model.init(0), batch, mask,
                          torch.tensor(0.2, dtype=torch.float32))
    assert _equal(a, b) and torch.equal(la, lb)


def test_noniid_2nn_superstep_run_reaches_target_within_band_of_reference():
    """The plain lane's band (rounds-to-target within 25%, at least 2
    rounds): the reference's superstep runs (threefry cohorts, R = 5)
    against the port's (Philox cohorts, R = 5), same data and init. The
    cohorts are two streams, so a single seed's rounds-to-target moves by
    about 15% either way in either package (10.3-11.5 rounds for the
    reference over these seeds); the band holds the mean over cohort seeds
    0-3, each run in both packages."""
    tr, te, _ = make_image_classification(1200, 400, seed=0)
    part = partition_pathological_noniid(tr.y, 20, seed=0)
    clients = [(tr.x[i], tr.y[i]) for i in part.client_indices]
    ref_model, model = ref_paper.mnist_2nn(), paper.mnist_2nn(device="cpu")
    jp = ref_model.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.array, jp), model, device="cpu")
    ref_eval = ref_make_eval_fn(ref_model.apply, te.x, te.y)
    port_eval = make_eval_fn(model.apply, te.x, te.y, device="cpu")
    target = 0.8
    want, got = [], []
    for seed in range(4):
        cfg = dict(C=0.2, E=2, B=10, lr=0.05, seed=seed)
        ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**cfg), eval_fn=ref_eval,
                        interpret=True, device_sampling=True)
        eng = RoundEngine(model.loss, tp, clients, FedAvgConfig(**cfg), eval_fn=port_eval,
                          device_sampling=True, device="cpu")
        want.append(ref.run(20, target_acc=target, rounds_per_step=5).rounds_to_target(target))
        got.append(eng.run(20, target_acc=target, rounds_per_step=5).rounds_to_target(target))
        for h in (eng.history, ref.history):     # evaluated at chunk boundaries only
            assert [x for x, _ in h.accuracy_curve()] == list(range(5, 5 * len(
                h.accuracy_curve()) + 1, 5))
        assert eng.num_compilations == 1
    assert None not in want and None not in got, (want, got)
    mean_want, mean_got = float(np.mean(want)), float(np.mean(got))
    assert abs(mean_got - mean_want) <= max(2.0, 0.25 * mean_want), (got, want)


# ---------------------------------------------------------------------------
# superstep(R) == R x round(), every lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane", sorted(LANES))
def test_superstep_matches_per_round_bit_for_bit(lane):
    a, b = _engine(**LANES[lane]), _engine(**LANES[lane])
    h = a.run(6, rounds_per_step=3)
    per_round = [float(b.round()["loss"]) for _ in range(6)]
    assert _losses(h) == per_round
    assert _equal(a.params, b.params) and _equal(a.outer_state, b.outer_state)
    assert torch.equal(a._gen.get_state(), b._gen.get_state())
    assert a.round_idx == b.round_idx == 6


def test_sample_clients_device_distinct_and_uniform():
    """m distinct ids a draw; over many draws every client equally often
    (chi-square over the membership counts, df = K - 1: the 99.9th
    percentile of chi2(9) is ~27.9, so 40 is generous for a right sampler
    and far below a biased one's)."""
    K, m, draws = 10, 3, 4000
    gen = torch.Generator().manual_seed(123)
    ids = torch.stack([sample_clients_device(gen, K, m) for _ in range(draws)]).numpy()
    assert ids.shape == (draws, m) and ids.dtype == np.int64
    assert ((0 <= ids) & (ids < K)).all()
    assert all(len(set(row.tolist())) == m for row in ids)
    counts = np.bincount(ids.reshape(-1), minlength=K)
    expected = draws * m / K
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 40.0, (chi2, counts.tolist())


# ---------------------------------------------------------------------------
# checkpoints carry the device stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane", ["plain", "q8"])
def test_superstep_resume_reproduces_uninterrupted_run(lane, tmp_path):
    straight = _engine(**LANES[lane])
    h_straight = straight.run(6, rounds_per_step=3)
    interrupted = _engine(**LANES[lane])
    interrupted.run(3, rounds_per_step=3)
    interrupted.save(tmp_path)
    meta = peek_metadata(tmp_path)
    assert meta["device_sampling"] is True and meta["torch_generator_device"] == "cpu"
    resumed = _engine(**LANES[lane])
    assert resumed.restore(tmp_path) == 3
    h_resumed = resumed.run(3, rounds_per_step=3)
    assert _losses(h_resumed) == _losses(h_straight)
    assert _equal(resumed.params, straight.params)
    assert torch.equal(resumed._gen.get_state(), straight._gen.get_state())


def _state(eng):
    gen = None if eng._gen is None else eng._gen.get_state().clone()
    return ([t.clone() for t in tree_leaves(eng.params)], eng.round_idx,
            gen, json.dumps(eng.rng.bit_generator.state), list(eng.history.records))


def _unchanged(eng, before):
    after = _state(eng)
    assert all(torch.equal(x, y) for x, y in zip(before[0], after[0]))
    assert before[1] == after[1]
    assert (before[2] is after[2] is None) or torch.equal(before[2], after[2])
    assert before[3:] == after[3:]


def test_restore_refusals_leave_the_engine_unchanged(tmp_path):
    """A mode mismatch either way; a device-sampling checkpoint without a
    torch generator state (the reference's, whose threefry key Philox
    cannot continue); a generator state of another device type."""
    device_eng = _engine()
    device_eng.run(2, rounds_per_step=2)
    device_eng.save(tmp_path / "device")
    host_eng = _engine(device_sampling=False)
    host_eng.run(2)
    host_eng.save(tmp_path / "host")
    meta = peek_metadata(tmp_path / "device")
    tree = {"params": device_eng.params, "strategy_state": device_eng.outer_state}
    reference_like = {k: v for k, v in meta.items() if not k.startswith("torch_generator")}
    save_checkpoint(tmp_path / "reference", tree, step=2, metadata=reference_like)
    save_checkpoint(tmp_path / "cuda", tree, step=2,
                    metadata={**meta, "torch_generator_device": "cuda"})
    cases = [(_engine(device_sampling=False), "device", "device_sampling=True engine"),
             (_engine(), "host", "device_sampling=False engine"),
             (_engine(), "reference", "threefry"),
             (_engine(), "cuda", "a cuda generator's")]
    for eng, ck, match in cases:
        eng.run(1, rounds_per_step=1)
        before = _state(eng)
        with pytest.raises(ValueError, match=match):
            eng.restore(tmp_path / ck)
        _unchanged(eng, before)


# ---------------------------------------------------------------------------
# run() semantics
# ---------------------------------------------------------------------------

def test_superstep_eval_every_zero_raises_up_front():
    eng = _engine(eval_fn=_const_eval())
    with pytest.raises(ValueError, match="eval_every"):
        eng.run(4, eval_every=0, rounds_per_step=2)
    assert eng.round_idx == 0 and eng.num_compilations == 0


def test_superstep_compile_count():
    """One round program whatever R is: two run calls, a ragged last
    chunk and round() add none."""
    eng = _engine()
    assert eng.num_compilations == 0
    eng.run(8, rounds_per_step=4)
    assert eng.num_compilations == 1
    eng.run(5, rounds_per_step=4)        # chunks of 4 and a ragged 1
    eng.round()
    assert eng.num_compilations == 1 and eng.round_idx == 14
    assert _engine(device_sampling=False).num_compilations == 0


def test_superstep_auto_rounds_per_step():
    """None: chunks of eval_every with an eval_fn, else the whole run."""
    eng = _engine(eval_fn=_const_eval())
    h = eng.run(4, eval_every=2)
    assert [(r.round, r.test_acc is not None) for r in h.records] == [
        (1, False), (2, True), (3, False), (4, True)]
    assert len({r.wall_s for r in h.records[:2]}) == 1
    eng2 = _engine()
    h2 = eng2.run(5)
    assert len({r.wall_s for r in h2.records}) == 1 and eng2.round_idx == 5
    assert eng2._resolve_rounds_per_step(None, 5, 1) == 5
    eng3 = _engine(rounds_per_step=2)     # the spec's execution.rounds_per_step
    assert eng3._resolve_rounds_per_step(None, 9, 1) == 2


def test_superstep_eval_fires_when_chunk_crosses_eval_point():
    calls = []
    eng = _engine(eval_fn=_const_eval(calls))
    eng.run(9, eval_every=2, rounds_per_step=3)   # chunks end at 3, 6, 9
    assert len(calls) == 3
    assert [r.round for r in eng.history.records if r.test_acc is not None] == [3, 6, 9]


def test_superstep_target_overshoots_by_less_than_a_chunk():
    eng = _engine(eval_fn=_const_eval())
    h = eng.run(12, eval_every=1, target_acc=0.5, rounds_per_step=4)
    assert len(h.records) == 4 and h.records[-1].test_acc == 0.5


def test_superstep_requires_device_sampling():
    eng = _engine(device_sampling=False)
    with pytest.raises(ValueError, match="device_sampling"):
        eng.run(4, rounds_per_step=2)
    assert eng.round_idx == 0
    eng.run(1, rounds_per_step=1)       # R = 1 is the per-round loop
    assert eng.round_idx == 1


def test_superstep_wall_clock_amortized():
    eng = _engine()
    h = eng.run(4, rounds_per_step=4)
    walls = [r.wall_s for r in h.records]
    assert all(w > 0 for w in walls) and len(set(walls)) == 1


def test_a_dropped_engine_is_freed_without_the_cyclic_collector():
    """The engine and its round graph hold no cycle: dropping an engine frees
    it (and on a card its graph) at once, never later inside another
    engine's capture, where destroying a graph invalidates the capture."""
    import gc
    import weakref

    eng = _engine()
    eng.run(2, rounds_per_step=2)
    graph, engine = weakref.ref(eng._graph), weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert engine() is None and graph() is None
    finally:
        gc.enable()


def test_device_sampling_with_a_topology_is_refused_in_the_reference_words():
    """The gossip lane has no cohort draw to fuse: ``device_sampling=True``
    beside a topology is refused before any state is built (the reference's
    ``engine.py:400-405``); its superstep is ``run(n, rounds_per_step=R)``
    without it (``tests/test_torch_gossip.py``)."""
    with pytest.raises(ValueError, match="topology= is incompatible with "
                                         "device_sampling=True: the gossip lane runs every "
                                         "node every round"):
        _engine(topology="ring", cfg=dict(CFG, C=1.0))
    eng = _engine(device_sampling=False, topology="ring", cfg=dict(CFG, C=1.0))
    eng.run(4, rounds_per_step=2)
    assert eng.round_idx == 4 and eng.num_compilations == 1


def test_no_message_of_the_port_names_item_6():
    """The lanes once refused naming ROADMAP Queue 1 item 6 (the gossip
    superstep, low-rank under device sampling, the streamed superstep) all
    run: no module of the port names the item any more."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    named = [str(f.relative_to(root)) for f in sorted(root.rglob("*.py"))
             if "item 6" in f.read_text()]
    assert named == []


def test_host_lane_stream_is_untouched_by_the_device_generator():
    """A host-sampled engine never draws from a device generator: its
    rounds and numpy stream are those of an engine built before supersteps
    (the same ids and seeds from ``rng``), and it holds no device generator,
    graph or device counts at all."""
    eng = _engine(device_sampling=False)
    rng = np.random.default_rng(CFG["seed"])
    for _ in range(3):
        eng.round()
        rng.choice(len(SIZES), size=round(CFG["C"] * len(SIZES)), replace=False)
        rng.integers(2**31)
    assert eng.rng.bit_generator.state == rng.bit_generator.state
    assert eng._gen is None and eng._graph is None and eng.num_compilations == 0
    assert not hasattr(eng, "_counts") and not hasattr(eng, "_spe")
    assert dataclasses.asdict(eng.history) == {"records": []}
