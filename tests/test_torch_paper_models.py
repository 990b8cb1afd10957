"""The paper's CIFAR CNN, char-LSTM and word-LSTM, their data, the LM
evaluation, ``FederatedTrainer`` and the examples of repro_torch, held against
the reference on the same numpy inputs and the reference's own ``init``
weights (carried across by ``params_from_numpy``).

Tolerances: 1e-5 for fp32 forwards, losses and gradients (sums in other
orders; the port's LSTM adds the input projection of all steps in one
product before its recurrence); 1e-6 for the evaluation's means; the data
byte for byte. Whole runs are compared in a band: their batch permutations
come from different generators."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.func import grad_and_value  # noqa: E402

from repro.core import FedAvgConfig as RefConfig  # noqa: E402
from repro.core import FederatedTrainer as RefTrainer  # noqa: E402
from repro.core import RoundEngine as RefEngine  # noqa: E402
from repro.core import fedsgd_config as ref_fedsgd_config  # noqa: E402
from repro.core.engine import RoundBatch as RefBatch  # noqa: E402
from repro.core.engine import RoundState as RefState  # noqa: E402
from repro.core.engine import build_simulation_round_step as ref_round_step  # noqa: E402
from repro.core.simulation import build_round_batch_host as ref_build_round_batch_host  # noqa: E402
from repro.core.simulation import make_eval_fn as ref_make_eval_fn  # noqa: E402
from repro.core.strategies import FedAvg as RefFedAvg  # noqa: E402
from repro.data import batching as ref_batching  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.models import nn as ref_nn  # noqa: E402
from repro.models import paper as ref_paper  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AsyncConfig,
    FedAvgConfig,
    FederatedTrainer,
    LatencyModel,
    RoundBatch,
    RoundEngine,
    RoundState,
    build_round_batch_host,
    build_simulation_round_step,
    fedsgd_config,
    make_eval_fn,
)
from repro_torch.core.strategies import FedAvg  # noqa: E402
from repro_torch.data import batching, synthetic  # noqa: E402
from repro_torch.models import nn, paper  # noqa: E402
from repro_torch.specs import get_spec  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

MODELS = ["cifar_cnn", "char_lstm", "word_lstm"]
V_CHAR, V_WORD = 11, 50


def _models(name):
    """(reference model, port model) at a CPU size: the CIFAR CNN whole, the
    LSTMs at small vocabularies and widths."""
    if name == "cifar_cnn":
        return ref_paper.cifar_cnn(), paper.cifar_cnn(device="cpu")
    if name == "char_lstm":
        return (ref_paper.char_lstm(V_CHAR, hidden=16),
                paper.char_lstm(V_CHAR, hidden=16, device="cpu"))
    return (ref_paper.word_lstm(V_WORD, embed_dim=12, hidden=16),
            paper.word_lstm(V_WORD, embed_dim=12, hidden=16, device="cpu"))


def _carried(ref_model, model, seed=0):
    jp = ref_model.init(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.array, jp), model, device="cpu")


def _inputs(name, n, seed=0, T=7):
    """(x, y) numpy inputs: CIFAR-like crops, or (n, T) token windows."""
    if name == "cifar_cnn":
        tr, _, _ = synthetic.make_image_classification(n, 1, image_shape=(24, 24, 3), seed=seed)
        return tr.x, tr.y
    r = np.random.default_rng(seed)
    V = V_CHAR if name == "char_lstm" else V_WORD
    return (r.integers(0, V, (n, T)).astype(np.int32), r.integers(0, V, (n, T)).astype(np.int32))


def _assert_tree_close(got, want, tol):
    got_np = params_to_numpy(got)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got_np
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, np.asarray(leaf), rtol=tol, atol=tol,
                                   err_msg=str([k.key for k in path]))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_forward_and_loss_match_reference(name):
    """Same weights, same inputs: logits and loss at 1e-5, accuracy equal."""
    ref_model, model = _models(name)
    jp, tp = _carried(ref_model, model, seed=3)
    x, y = _inputs(name, 6, seed=1)
    ref_apply, ref_loss = jax.jit(ref_model.apply), jax.jit(ref_model.loss)
    want = np.asarray(ref_apply(jp, jnp.asarray(x)))
    got = model.apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    (wl, waux), (gl, gaux) = (ref_loss(jp, (jnp.asarray(x), jnp.asarray(y))),
                              model.loss(tp, (torch.from_numpy(x), torch.from_numpy(y))))
    np.testing.assert_allclose(float(gl), float(wl), atol=1e-5, rtol=1e-5)
    assert float(gaux["acc"]) == float(waux["acc"])


@pytest.mark.parametrize("name", MODELS)
def test_gradient_matches_reference(name):
    """One ``grad_and_value`` of each model's loss against ``jax.grad`` at
    1e-5 on every leaf (the embedding rows' scatter-add included)."""
    ref_model, model = _models(name)
    jp, tp = _carried(ref_model, model, seed=5)
    x, y = _inputs(name, 4, seed=2)
    ref_step = jax.jit(jax.value_and_grad(ref_model.loss, has_aux=True))
    (wl, _), wg = ref_step(jp, (jnp.asarray(x), jnp.asarray(y)))
    gg, (gl, _) = grad_and_value(model.loss, has_aux=True)(
        tp, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(gl), float(wl), atol=1e-5, rtol=1e-5)
    _assert_tree_close(gg, wg, 1e-5)


@pytest.mark.parametrize("d_in,d_hidden,B,T", [(3, 5, 2, 1), (8, 16, 3, 9), (16, 8, 1, 20)])
def test_lstm_apply_and_cell_match_reference(d_in, d_hidden, B, T):
    """The recurrence on the reference's weights at 1e-5 (the gate order,
    the forget bias of +1, the zero carry), and one cell step alone."""
    jp = ref_nn.lstm_init(jax.random.PRNGKey(d_in), d_in, d_hidden)
    jp = {**jp, "b": jax.random.normal(jax.random.PRNGKey(1), jp["b"].shape)}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(T).normal(size=(B, T, d_in)).astype(np.float32)
    ref_apply, ref_cell = jax.jit(ref_nn.lstm_apply), jax.jit(ref_nn.lstm_cell)
    want = np.asarray(ref_apply(jp, jnp.asarray(x)))
    got = nn.lstm_apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == (B, T, d_hidden)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    r = np.random.default_rng(0)
    h, c = (r.normal(size=(B, d_hidden)).astype(np.float32) for _ in range(2))
    (wh, wc), _ = ref_cell(jp, (jnp.asarray(h), jnp.asarray(c)), jnp.asarray(x[:, 0]))
    (gh, gc), out = nn.lstm_cell(tp, (torch.from_numpy(h), torch.from_numpy(c)),
                                 torch.from_numpy(x[:, 0]))
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-5, rtol=1e-5)
    assert out is gh


@pytest.mark.parametrize("kind,kwargs,count", [
    ("cifar_cnn", {}, 1_068_298),
    ("char_lstm", {"vocab_size": 72}, 796_672 + 265 * 72),
    ("char_lstm", {"vocab_size": 100}, 796_672 + 265 * 100),
    ("char_lstm", {"vocab_size": 72, "hidden": 128}, 211_592),
    ("word_lstm", {}, 4_359_120),
])
def test_parameter_counts(kind, kwargs, count):
    model = getattr(paper, kind)(**kwargs, device="cpu")
    assert sum(p.numel() for p in tree_leaves(model.init(0))) == count


def test_init_is_seeded_on_a_cpu_generator():
    """The same seed gives the same weights; the forget bias starts at 0
    (the +1 lives in the cell, as the reference's)."""
    a, b = (paper.char_lstm(V_CHAR, hidden=16, device="cpu").init(4) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert not torch.equal(a["lstm1"]["wx"], paper.char_lstm(V_CHAR, hidden=16,
                                                             device="cpu").init(5)["lstm1"]["wx"])
    assert float(a["lstm1"]["b"].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# the data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_char_corpus_is_byte_identical(seed):
    got = synthetic.make_char_corpus(15, mean_chars_per_role=150, seed=seed, n_styles=4)
    want = ref_synthetic.make_char_corpus(15, mean_chars_per_role=150, seed=seed, n_styles=4)
    assert got[2] == want[2] == synthetic.CHAR_VOCAB_SIZE == 72
    for a_list, b_list in ((got[0], want[0]), (got[1], want[1])):
        assert len(a_list) == len(b_list) == 15
        for a, b in zip(a_list, b_list):
            assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,unroll", [(201, 80), (50, 10), (11, 10), (3, 10), (1, 5)])
def test_windows_from_sequence_is_byte_identical(n, unroll):
    """Whole windows, a ragged tail dropped, and a short sequence tiled."""
    seq = np.random.default_rng(n).integers(0, 72, n).astype(np.int32)
    for a, b in zip(batching.windows_from_sequence(seq, unroll),
                    ref_batching.windows_from_sequence(seq, unroll)):
        assert a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("B,with_y", [(4, True), (None, True), (7, False), (50, True)])
def test_client_epoch_batches_is_byte_identical(B, with_y):
    r = np.random.default_rng(1)
    x = r.normal(size=(23, 5)).astype(np.float32)
    y = r.integers(0, 9, (23, 6)).astype(np.int32) if with_y else None
    got = batching.client_epoch_batches(x, y, B, 3, seed=9)
    want = ref_batching.client_epoch_batches(x, y, B, 3, seed=9)
    assert got[0].tobytes() == want[0].tobytes() and got[0].shape == want[0].shape
    assert (got[1] is None) == (want[1] is None)
    if with_y:
        assert got[1].tobytes() == want[1].tobytes()


@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_iterator_is_byte_identical(drop_last):
    x = np.arange(26, dtype=np.float32).reshape(13, 2)
    y = np.arange(13, dtype=np.int32)
    got = batching.batch_iterator(x, y, 4, seed=2, drop_last=drop_last)
    want = ref_batching.batch_iterator(x, y, 4, seed=2, drop_last=drop_last)
    for _ in range(9):                              # across passes
        (gx, gy), (wx, wy) = next(got), next(want)
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()


def test_build_round_batch_host_is_byte_identical():
    """The legacy host assembly, ragged client sizes and B = inf among them."""
    r = np.random.default_rng(0)
    clients = [(r.integers(0, 9, (n, 4)).astype(np.int32), r.integers(0, 9, (n, 4)).astype(np.int32))
               for n in (5, 12, 8)]
    for B in (3, None):
        cfg = dict(C=1.0, E=2, B=B, lr=0.1)
        got = build_round_batch_host(clients, [2, 0, 1], FedAvgConfig(**cfg),
                                     np.random.default_rng(4))
        want = ref_build_round_batch_host(clients, [2, 0, 1], RefConfig(**cfg),
                                          np.random.default_rng(4))
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# evaluation on labels with a sequence axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_test,T,batch_size", [(10, 5, 4), (10, 4, 4), (3, 6, 8), (8, 5, 4)])
def test_make_eval_fn_scores_lm_labels_as_the_reference(n_test, T, batch_size):
    """(n, T) labels, a padded tail (n_test not a multiple of the batch),
    and ``batch_size == T``, where a validity mask broadcast over the wrong
    axis would go unnoticed: loss and accuracy within 1e-6 of the
    reference's, both means over the n * T valid labels."""
    ref_model, model = _models("char_lstm")
    jp, tp = _carried(ref_model, model, seed=1)
    x, y = _inputs("char_lstm", n_test, seed=4, T=T)
    want = ref_make_eval_fn(ref_model.apply, x, y, batch_size=batch_size)(jp)
    got = make_eval_fn(model.apply, x, y, batch_size=batch_size, device="cpu")(tp)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got["acc"]), float(want["acc"]), rtol=1e-6, atol=1e-6)
    logits = model.apply(tp, torch.from_numpy(x))
    mean_ce = torch.nn.functional.cross_entropy(logits.reshape(-1, V_CHAR),
                                                torch.from_numpy(y).long().reshape(-1))
    np.testing.assert_allclose(float(got["loss"]), float(mean_ce), rtol=1e-6, atol=1e-6)


def test_make_eval_fn_scores_the_cifar_cnn_as_the_reference():
    ref_model, model = _models("cifar_cnn")
    jp, tp = _carried(ref_model, model, seed=2)
    x, y = _inputs("cifar_cnn", 13, seed=5)
    want = ref_make_eval_fn(ref_model.apply, x, y, batch_size=5)(jp)
    got = make_eval_fn(model.apply, x, y, batch_size=5, device="cpu")(tp)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6, atol=1e-6)
    assert float(got["acc"]) == pytest.approx(float(want["acc"]), abs=1e-7)


# ---------------------------------------------------------------------------
# one engine round on the reference's batches
# ---------------------------------------------------------------------------

def _lm_clients(name, sizes, T=6, seed=0):
    V = V_CHAR if name == "char_lstm" else V_WORD
    r = np.random.default_rng(seed)
    return [(r.integers(0, V, (n, T)).astype(np.int32), r.integers(0, V, (n, T)).astype(np.int32))
            for n in sizes]


@pytest.mark.parametrize("name,sizes,cfg", [
    ("char_lstm", [9, 4, 14, 6], dict(C=0.75, E=2, B=4, lr=0.5, seed=7)),
    ("word_lstm", [5, 11, 7], dict(C=0.67, E=1, B=3, lr=0.5, seed=3)),
    ("cifar_cnn", [6, 9, 4], dict(C=0.67, E=1, B=4, lr=0.05, seed=2)),
])
def test_round_step_matches_reference(name, sizes, cfg):
    """The vmapped ClientUpdate with a masked step, the fp32 deltas through
    the server average, on the reference's own round batch (y with a
    sequence axis for the LSTMs): loss and every parameter within 1e-5."""
    ref_model, model = _models(name)
    if name == "cifar_cnn":
        tr, _, _ = synthetic.make_image_classification(sum(sizes), 1, image_shape=(24, 24, 3))
        cuts = np.cumsum(sizes)[:-1]
        clients = list(zip(np.split(tr.x, cuts), np.split(tr.y, cuts)))
    else:
        clients = _lm_clients(name, sizes)
    jp, tp = _carried(ref_model, model, seed=2)
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**cfg), interpret=True)
    ids, _, key, lr = ref._next_round_inputs()
    batch, mask, w = ref.materialize_round_batch(ids, key)
    assert (np.asarray(mask) == 0).any()        # a padded step is a no-op on both sides
    want, wm = ref_round_step(ref_model.loss, interpret=True, strategy=RefFedAvg())(
        RefState(jp), RefBatch(batch, mask, w, lr=lr))
    got, gm = build_simulation_round_step(model.loss, strategy=FedAvg())(
        RoundState(tp, outer_state=()),
        RoundBatch(tuple(torch.from_numpy(np.array(b)) for b in batch),
                   torch.from_numpy(np.array(mask)), torch.from_numpy(np.array(w)),
                   lr=float(lr)))
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]), rtol=1e-5, atol=1e-5)
    _assert_tree_close(got.params, want.params, 1e-5)


def test_engine_packs_and_batches_sequence_labels():
    """(n, T) labels ride through the pack, the cohort gather and the
    per-(client, epoch) permutation with their rows: each batch's labels
    are its inputs' windows' labels."""
    clients = []
    for k, n in enumerate((7, 3, 12)):
        x = (np.arange(n * 4).reshape(n, 4) + 1000 * k).astype(np.int32)
        clients.append((x, x + 1))                  # labels: the inputs shifted by one
    model = paper.char_lstm(4000, embed_dim=2, hidden=2, device="cpu")
    eng = RoundEngine(model.loss, model.init(0), clients,
                      FedAvgConfig(C=1.0, E=2, B=5, lr=0.1, seed=0), device="cpu")
    (bx, by), mask, w = eng.materialize_round_batch(np.asarray([2, 0, 1]), generator_seed=3)
    assert bx.shape == by.shape == (3, 2 * 3, 5, 4)
    assert torch.equal(by, bx + 1)
    assert w.tolist() == [12.0, 7.0, 3.0]
    eng.round()                                     # and a round trains on them


@pytest.mark.parametrize("B", [5, None])
def test_engine_round_batch_agrees_with_the_host_assembly(B):
    """``build_round_batch_host``, the legacy numpy assembly, as an
    independent reference for ``materialize_round_batch`` on (n, T) labels:
    the same weights and real steps a client (E * ceil(n_k / B)), and in
    every epoch the same examples, each once, in another order; the rest
    of an epoch's rows (a ragged tail, B = inf's tiling) are the client's
    own; labels stay with their inputs."""
    clients = []
    for k, n in enumerate((7, 3, 12)):
        x = (np.arange(n * 4).reshape(n, 4) + 1000 * k).astype(np.int32)
        clients.append((x, x + 1))
    cfg = FedAvgConfig(C=1.0, E=2, B=B, lr=0.1, seed=0)
    model = paper.char_lstm(4000, embed_dim=2, hidden=2, device="cpu")
    eng = RoundEngine(model.loss, model.init(0), clients, cfg, device="cpu")
    ids = np.asarray([2, 0, 1])
    (bx, by), mask, w = eng.materialize_round_batch(ids, generator_seed=3)
    hx, hy, hmask, hw = build_round_batch_host(clients, ids, cfg, np.random.default_rng(3))
    assert w.tolist() == hw.tolist()
    assert mask.sum(dim=1).tolist() == hmask.sum(axis=1).tolist()
    assert torch.equal(by, bx + 1) and np.array_equal(hy[hmask == 1], hx[hmask == 1] + 1)

    def epochs(steps, n_epochs):
        rows = steps.reshape((n_epochs, -1) + steps.shape[2:])   # (E, s_k * B, T)
        return [(np.sort(e[: len(x_k)], axis=0), e[len(x_k):]) for e in rows]

    for i, k in enumerate(ids):
        x_k = clients[k][0]
        got = epochs(bx[i].numpy()[mask[i].numpy() == 1], cfg.E)
        want = epochs(hx[i][hmask[i] == 1], cfg.E)
        for (g_once, g_rest), (w_once, w_rest) in zip(got, want):
            assert np.array_equal(g_once, np.sort(x_k, axis=0))
            assert np.array_equal(g_once, w_once) and g_rest.shape[1:] == w_rest.shape[1:]
            assert np.isin(g_rest[:, 0], x_k[:, 0]).all() and np.isin(w_rest[:, 0], x_k[:, 0]).all()


# ---------------------------------------------------------------------------
# the trainer and the examples
# ---------------------------------------------------------------------------

def _roles(n_roles=12, unroll=10, mean=600):
    train, test, V = synthetic.make_char_corpus(n_roles, mean_chars_per_role=mean, seed=0)
    clients = [batching.windows_from_sequence(t, unroll) for t in train]
    tx, ty = zip(*(batching.windows_from_sequence(t, unroll) for t in test))
    return clients, np.concatenate(tx), np.concatenate(ty), V


def test_shakespeare_run_stays_in_a_band_of_the_reference():
    """A short Shakespeare run, 12 roles at unroll 10 and hidden 16 (the
    example's E=5, B=10, lr=10), through both packages' ``FederatedTrainer``
    from the same weights and cohorts: only the batch permutations differ.
    Every evaluated accuracy within 0.05 of the reference's, and both learn
    (round 4 at least 0.03 above round 1; measured: 0.018 -> 0.093 and
    0.095)."""
    clients, x_test, y_test, V = _roles()
    cfg = dict(C=0.5, E=5, B=10, lr=10.0, seed=0)
    ref_model, model = ref_paper.char_lstm(V, hidden=16), paper.char_lstm(V, hidden=16,
                                                                           device="cpu")
    jp, tp = _carried(ref_model, model)
    ref = RefTrainer(ref_model.loss, jp, clients, RefConfig(**cfg),
                     eval_fn=ref_make_eval_fn(ref_model.apply, x_test, y_test), interpret=True)
    tr = FederatedTrainer(model.loss, tp, clients, FedAvgConfig(**cfg),
                          eval_fn=make_eval_fn(model.apply, x_test, y_test, device="cpu"),
                          device="cpu")
    want = ref.run(4).accuracy_curve()
    got = tr.run(4).accuracy_curve()
    assert [r for r, _ in got] == [r for r, _ in want] == [1, 2, 3, 4]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= 0.05, (got, want)
    assert got[-1][1] >= got[0][1] + 0.03 and want[-1][1] >= want[0][1] + 0.03
    assert tr.round_idx == 4 and tr.num_clients == len(clients)


def test_trainer_is_the_engine_it_wraps():
    """Constructor and ``from_spec`` land on the same engine: the same
    rounds bit for bit as a bare ``RoundEngine``; params, history and lr
    are the engine's."""
    clients = _lm_clients("char_lstm", [6, 9, 4, 8])
    model = paper.char_lstm(V_CHAR, hidden=8, device="cpu")
    cfg = FedAvgConfig(C=0.5, E=1, B=3, lr=0.3, lr_decay=0.9, seed=1)
    tr = FederatedTrainer(model.loss, model.init(0), clients, cfg, device="cpu")
    eng = RoundEngine(model.loss, model.init(0), clients, cfg, device="cpu")
    spec = dataclasses.replace(
        get_spec("shakespeare_lstm"), fedavg=cfg,
        model=dataclasses.replace(get_spec("shakespeare_lstm").model,
                                  kwargs={"vocab_size": V_CHAR, "hidden": 8}))
    by_spec = FederatedTrainer.from_spec(spec, clients, init_params=model.init(0), device="cpu")
    tr.run(2), eng.run(2), by_spec.run(2)
    for other in (eng.params, by_spec.params):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.params), tree_leaves(other)))
    assert [r.train_loss for r in tr.history.records] == [
        r.train_loss for r in eng.history.records]
    assert tr.lr_at(2) == eng.lr_at(2) and tr.loss_fn is tr.engine.loss_fn
    tr.params = tree_map(torch.zeros_like, tr.params)
    assert float(tr.engine.params["out"]["w"].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="eval_fn"):
        tr.run(1, target_acc=0.5)


@pytest.mark.parametrize("kw,item", [
    # mesh= runs (test_trainer_runs_sharded_over_a_client_mesh); beside the
    # async schedule it is refused as the reference refuses it
    ({"mesh": object(), "async_config": AsyncConfig(buffer_k=2)}, "incompatible with mesh="),
    ({"interpret": True}, "no kernel interpreter"),
    ({"accum_dtype": torch.bfloat16}, "ROADMAP Queue 2"),
])
def test_trainer_refuses_what_the_port_has_no_lane_for(kw, item):
    """Before any state is built: an empty population would make the
    engine's packing raise, so the refusal must come first."""
    model = paper.char_lstm(V_CHAR, hidden=8, device="cpu")
    with pytest.raises(ValueError, match=item):
        FederatedTrainer(model.loss, model.init(0), [], FedAvgConfig(), device="cpu", **kw)
    if "mesh" in kw:
        with pytest.raises(ValueError, match=item):
            FederatedTrainer.from_spec(get_spec("mnist_2nn_noniid_async"), [], device="cpu",
                                       mesh=kw["mesh"])


def test_trainer_runs_sharded_over_a_client_mesh():
    """``FederatedTrainer(mesh=)`` (once refused, naming ROADMAP Queue 1 item
    7) reaches the engine: over a gloo world of one its rounds are the
    unsharded trainer's, and ``from_spec`` takes the mesh too."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_client_mesh

    clients = _lm_clients("char_lstm", [6, 9, 4, 8])
    model = paper.char_lstm(V_CHAR, hidden=8, device="cpu")
    cfg = FedAvgConfig(C=0.5, E=1, B=3, lr=0.3, seed=1)
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_client_mesh(device="cpu")
        tr = FederatedTrainer(model.loss, model.init(0), clients, cfg, mesh=mesh, device="cpu")
        base = FederatedTrainer(model.loss, model.init(0), clients, cfg, device="cpu")
        spec = dataclasses.replace(
            get_spec("shakespeare_lstm"), fedavg=cfg,
            model=dataclasses.replace(get_spec("shakespeare_lstm").model,
                                      kwargs={"vocab_size": V_CHAR, "hidden": 8}))
        by_spec = FederatedTrainer.from_spec(spec, clients, init_params=model.init(0),
                                             mesh=mesh, device="cpu")
        assert tr.engine.mesh is mesh and by_spec.engine.mesh is mesh
        tr.run(2), base.run(2), by_spec.run(2)
    finally:
        if started:
            dist.destroy_process_group()
    for other in (tr, by_spec):
        np.testing.assert_allclose([r.train_loss for r in other.history.records],
                                   [r.train_loss for r in base.history.records],
                                   rtol=0, atol=1e-5)
        for a, b in zip(tree_leaves(other.params), tree_leaves(base.params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("option", ["latency", "async_config"])
def test_trainer_passes_the_schedules_to_its_engine(option):
    """``latency=`` and ``async_config=`` reach the engine the trainer wraps:
    the trainer's run is the bare engine's, records' ``sim_s`` and all, and
    ``from_spec`` takes an async spec's fields the same way."""
    clients = _lm_clients("char_lstm", [6, 9, 4, 8])
    model = paper.char_lstm(V_CHAR, hidden=8, device="cpu")
    cfg = FedAvgConfig(C=0.5, E=1, B=3, lr=0.3, seed=1)
    lat = LatencyModel(kind="exponential", mean_s=1.0, dropout=0.2, seed=4)
    kw = {"latency": lat}
    if option == "async_config":
        kw["async_config"] = AsyncConfig(buffer_k=1, concurrency=2)
    tr = FederatedTrainer(model.loss, model.init(0), clients, cfg, device="cpu", **kw)
    eng = RoundEngine(model.loss, model.init(0), clients, cfg, device="cpu", **kw)
    assert tr.engine.latency == lat and tr.engine.async_config == kw.get("async_config")
    tr.run(3), eng.run(3)
    assert [(r.round, r.sim_s, r.train_loss) for r in tr.history.records] == [
        (r.round, r.sim_s, r.train_loss) for r in eng.history.records]
    assert all(r.sim_s > 0 for r in tr.history.records)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.params), tree_leaves(eng.params)))
    if option == "async_config":
        spec = get_spec("mnist_2nn_noniid_async")
        small = dataclasses.replace(spec, model=dataclasses.replace(
            spec.model, kwargs={"n_classes": 5, "d_in": 6}),
            fedavg=dataclasses.replace(spec.fedavg, C=0.5, E=1))
        r = np.random.default_rng(0)
        mnist = [(r.normal(size=(n, 6)).astype(np.float32), r.integers(0, 5, n).astype(np.int32))
                 for n in (12, 7, 20, 9, 15, 11)]
        by_spec = FederatedTrainer.from_spec(small, mnist, device="cpu")
        assert by_spec.engine.async_config == AsyncConfig(buffer_k=3)
        assert by_spec.engine.latency == spec.async_spec.latency
        assert len(by_spec.run(2).records) == 2


def test_fedsgd_config_is_the_reference_s():
    got, want = fedsgd_config(C=0.2, lr=0.3, seed=4), ref_fedsgd_config(C=0.2, lr=0.3, seed=4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.expected_updates_per_round(600, 10) == want.expected_updates_per_round(600, 10)
    cfg = dict(C=0.1, E=5, B=10)
    assert FedAvgConfig(**cfg).expected_updates_per_round(60_000, 100) == \
        RefConfig(**cfg).expected_updates_per_round(60_000, 100) == 300.0


def test_char_lstm_runs_the_superstep_lane_on_the_cpu():
    """``device_sampling=True``: the cohort, the batches of (n, T) windows
    and the step mask drawn and assembled on the device; run(4,
    rounds_per_step=2) is four ``round()``s of a twin engine, bit for bit."""
    clients = _lm_clients("char_lstm", [6, 9, 4, 8, 5], T=5)
    model = paper.char_lstm(V_CHAR, hidden=8, device="cpu")
    cfg = FedAvgConfig(C=0.4, E=2, B=3, lr=0.3, seed=2)
    eng, twin = (RoundEngine(model.loss, model.init(0), clients, cfg, device_sampling=True,
                             device="cpu") for _ in range(2))
    hist = eng.run(4, rounds_per_step=2)
    losses = [float(twin.round()["loss"]) for _ in range(4)]
    assert [r.train_loss for r in hist.records] == losses
    assert all(np.isfinite(losses))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(eng.params),
                                                 tree_leaves(twin.params)))
    assert eng.num_compilations == 1


def test_examples_run_on_the_cpu(capsys):
    """The three example programs through their ``main`` at a tiny size."""
    from repro_torch.examples import mnist_federated, quickstart, shakespeare_lstm

    hist = shakespeare_lstm.main(["--roles", "8", "--unroll", "10", "--hidden", "8",
                                  "--rounds", "1", "--E", "1", "--device", "cpu"])
    assert len(hist.records) == 1 and hist.records[0].test_acc is not None
    hist = mnist_federated.main(["--rounds", "1", "--n-train", "600", "--clients", "10",
                                 "--E", "1", "--device", "cpu"])
    assert len(hist.records) == 1
    assert mnist_federated.main(["--print-spec"]) is None
    assert '"kind": "mnist_2nn"' in capsys.readouterr().out
    hist = quickstart.main(["--rounds", "1", "--device", "cpu"])
    assert len(hist.records) == 1


@pytest.mark.parametrize("first", ["repro_torch.kernels.flash_attention",
                                   "repro_torch.kernels.fedavg_agg", "repro_torch.models.nn"])
def test_the_package_imports_in_any_order(first):
    """A fresh interpreter imports ``first`` before anything else of the
    port, then the exports: no import cycle closes (the models' exports are
    lazy for this)."""
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    code = (f"import {first}\nfrom repro_torch.models import char_lstm\n"
            "from repro_torch.core import FederatedTrainer\nimport repro_torch.data\n")
    res = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": str(src)},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
