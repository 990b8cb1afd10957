"""Training the last two archs: xLSTM-350M and SeamlessM4T-medium (the audio
stub's ``enc_embeds``) through the port's FedAvg round, held against the
reference's on the CPU; ``launch.train``'s audio batches; the CE's head
staged onto the tensor-core route's grid.

One FedAvg round (G = 2 groups of H = 2 local AdamW steps, unequal group
weights) of each reduced config through ``local_sgd.build_fedavg_round_step``
against the reference's, on the same numpy batches and the reference's
params: the loss within 1e-5, every replica leaf and AdamW's moments within
1e-4 (rel L2), the tolerances of
``tests/test_torch_train.py::test_fedavg_round_matches_the_reference``.
The mLSTM's input-gate bias ``bi`` is the one leaf held otherwise: the
block's output is invariant to one shift of every input gate, so its
gradient is fp32 rounding in both packages (about 1e-9), and AdamW's first
steps turn such a gradient into steps of about lr of either sign."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.core import local_sgd as ref_lsgd  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
import repro.optim as ref_optim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import local_sgd  # noqa: E402
from repro_torch.data.synthetic import make_word_corpus  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ce_loss import _route  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
LR = 1e-3
G, H = 2, 2
ARCHS = ("xlstm-350m", "seamless-m4t-medium")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _tree_close(got_tree, want_tree, rtol, *, gate_bias_steps=None):
    """Every leaf of ``got_tree`` within ``rtol`` (rel L2) of the reference's;
    an mLSTM ``bi`` leaf instead within ``gate_bias_steps`` x LR of it (the
    replicas) or, for the moments (``gate_bias_steps`` None), skipped with
    only its shape held."""
    got, want = tree_leaves(params_to_numpy(got_tree)), jax.tree.leaves(_np(want_tree))
    assert len(got) == len(want)
    for path, g, w in zip(tree_paths(got_tree), got, want):
        assert g.shape == w.shape, path
        if path[-1] == "bi":
            if gate_bias_steps is not None:
                assert np.abs(g - w).max() <= gate_bias_steps * LR, path
            continue
        assert _rel(g, w) <= rtol, (path, _rel(g, w))


def _round_batches(cfg, seed=3):
    """(H, G, 2, 12) tokens and labels; the audio arch's (H, G, 2, 9, d)
    frames after them."""
    r = np.random.default_rng(seed)
    shape = (H, G, 2, 12)
    b = {"tokens": r.integers(0, cfg.vocab_size, shape).astype(np.int32),
         "labels": r.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.modality == "audio":
        b["enc_embeds"] = r.normal(size=(H, G, 2, 9, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", ARCHS)
def test_fedavg_round_matches_the_reference(arch):
    """One round of the reduced config (xLSTM: an mLSTM and an sLSTM block;
    SeamlessM4T: 2 encoder and 2 decoder layers over 9 frames): the loss,
    every replica leaf after the broadcast and AdamW's step and moments."""
    ref_model = ref_tf.TransformerLM(ref_reduced(ref_get_config(arch)))
    model = tf.TransformerLM(reduced(get_config(arch)), device="cpu")
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    batches = _round_batches(model.cfg)
    weights = np.array([1.0, 3.0], np.float32)
    ref_inner, inner = ref_optim.adamw(LR), optim.adamw(LR)

    rp_g = ref_lsgd.replicate_for_groups(ref_params, G)
    rs_g = jax.vmap(ref_inner.init)(rp_g)
    step = jax.jit(ref_lsgd.build_fedavg_round_step(ref_model.train_loss, ref_inner,
                                                    ref_lsgd.LocalSGDConfig(G, H)))
    rp_g, rs_g, _, rm = step(rp_g, rs_g, None, jax.tree.map(jnp.asarray, batches),
                             jnp.asarray(weights))

    params_g = local_sgd.replicate_for_groups(
        params_from_numpy(_np(ref_params), model, device="cpu"), G)
    state_g = local_sgd.init_group_states(inner, params_g)
    round_step = local_sgd.build_fedavg_round_step(model.train_loss, inner,
                                                   local_sgd.LocalSGDConfig(G, H))
    params_g, state_g, _, m = round_step(params_g, state_g, None,
                                         tree_map(torch.from_numpy, batches),
                                         torch.from_numpy(weights))
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_TOL
    assert state_g.step.tolist() == np.asarray(rs_g.step).tolist() == [H] * G
    # bi: H AdamW steps of about lr each at most, in either package
    _tree_close(params_g, rp_g, GRAD_RTOL, gate_bias_steps=2 * H)
    _tree_close(state_g.mu, rs_g.mu, GRAD_RTOL)
    _tree_close(state_g.nu, rs_g.nu, GRAD_RTOL)


def _captured_run(monkeypatch, argv):
    """``train.run(argv)`` with every batch its FedAvg round step takes
    recorded: (records, batches)."""
    seen = []
    build = local_sgd.build_fedavg_round_step

    def recording(*a, **k):
        inner = build(*a, **k)

        def round_step(params_g, state_g, outer, batches, weights):
            seen.append(batches)
            return inner(params_g, state_g, outer, batches, weights)

        return round_step

    monkeypatch.setattr(local_sgd, "build_fedavg_round_step", recording)
    return train.run(argv)[0], seen


def test_train_seamless_draws_frames_after_the_tokens(monkeypatch):
    """``launch.train --arch seamless-m4t-medium --device cpu --remat`` (the
    reduced config): each round's batch carries ``enc_embeds`` of (H, G, B,
    min(S, 4096), d) in the compute dtype, normal draws from the same numpy
    generator right after the round's tokens and labels (which take one
    draw of start offsets into the corpus); every round's loss is finite."""
    S, B, seed = 24, 2, 5
    recs, seen = _captured_run(monkeypatch, [
        "--arch", "seamless-m4t-medium", "--device", "cpu", "--rounds", "2",
        "--local-steps", str(H), "--groups", str(G), "--global-batch", str(G * B),
        "--seq", str(S), "--seed", str(seed), "--remat"])
    assert len(recs) == len(seen) == 2 and all(np.isfinite(r["loss"]) for r in recs)
    cfg = reduced(get_config("seamless-m4t-medium"))
    train_set, _, _ = make_word_corpus(n_authors=64, vocab_size=cfg.vocab_size,
                                       mean_words_per_author=20_000, seed=seed)
    corpus = np.concatenate(train_set)
    rng = np.random.default_rng(seed)
    for batch in seen:
        starts = rng.integers(0, len(corpus) - S - 1, (H, G, B))
        frames = rng.normal(size=(H, G, B, min(S, train.ENC_FRAMES), cfg.d_model))
        assert set(batch) == {"tokens", "labels", "enc_embeds"}
        np.testing.assert_array_equal(batch["tokens"][1, 0, 1].numpy(),
                                      corpus[starts[1, 0, 1]:starts[1, 0, 1] + S])
        assert batch["enc_embeds"].dtype == torch.float32   # the reduced config's
        np.testing.assert_array_equal(batch["enc_embeds"].numpy(), frames.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_runs_each_arch_with_remat(arch):
    """``launch.train --arch ARCH --device cpu --remat`` in bf16 (``--dtype``):
    a FedAvg round and a FedSGD step, finite losses, no kernel launched on
    the CPU."""
    argv = ["--arch", arch, "--device", "cpu", "--rounds", "1", "--local-steps", "2",
            "--global-batch", "4", "--seq", "16", "--dtype", "bfloat16", "--remat"]
    for extra in ([], ["--algo", "fedsgd"]):
        recs = train.main(argv + extra)
        assert recs and all(np.isfinite(r["loss"]) for r in recs)
        assert all(v == 0 for r in recs for v in r["launches"].values())


def test_ce_head_of_seamless_is_staged_onto_the_tensor_core_route():
    """SeamlessM4T's untied (1024, 256,206) bf16 head (256,206 % 8 = 6) takes
    the CE's scalar route as it stands; ``ops.tensor_core_head`` stages it
    into a (1024, 256,208) buffer whose (1024, 256,206) view ``_route`` (it
    reads strides, dtypes and pointers only) sends to the tensor cores. On
    the meta device: nothing is allocated. xLSTM's (1024, 50,304) head and
    a tied view take the route as they stand, and are passed through."""
    d, V = 1024, 256_206
    hidden = torch.empty((4096, d), dtype=torch.bfloat16, device="meta")
    head = torch.empty((d, V), dtype=torch.bfloat16, device="meta")
    assert _route(hidden, head) == "scalar"
    staged = ops.tensor_core_head(hidden, head)
    assert staged.shape == (d, V) and staged.stride() == (-(-V // 8) * 8, 1)
    assert _route(hidden, staged) == "mma"
    for same in (torch.empty((d, 50_304), dtype=torch.bfloat16, device="meta"),
                 torch.empty((V, d), dtype=torch.bfloat16, device="meta").T,
                 head.float()):
        assert ops.tensor_core_head(hidden.to(same.dtype), same) is same


def test_staged_head_keeps_the_loss_and_its_gradients():
    """On a small bf16 case with V % 8 = 5: ``ce_loss_mean`` through the
    staged head gives the loss of the head as it stands and the same
    gradients, the head's on the (d, V) parameter itself."""
    r = np.random.default_rng(0)
    T, d, V = 12, 16, 37
    hidden = torch.from_numpy(r.normal(size=(2, T // 2, d)).astype(np.float32)).bfloat16()
    head = torch.from_numpy((r.normal(size=(d, V)) * 0.3).astype(np.float32)).bfloat16()
    labels = torch.from_numpy(r.integers(0, V, (2, T // 2)).astype(np.int32))
    assert _route(hidden.reshape(T, d), head) == "scalar"
    assert _route(hidden.reshape(T, d), ops.tensor_core_head(hidden.reshape(T, d), head)) == "mma"
    h, w = hidden.clone().requires_grad_(), head.clone().requires_grad_()
    loss = ops.ce_loss_mean(h, w, labels, chunk=3)
    gh, gw = torch.autograd.grad(loss, (h, w))
    want = tf.chunked_cross_entropy(hidden.float(), head.float(), labels, 0)
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    h32, w32 = hidden.float().requires_grad_(), head.float().requires_grad_()
    wh, ww = torch.autograd.grad(tf.chunked_cross_entropy(h32, w32, labels, 0), (h32, w32))
    assert gw.shape == (d, V) and gw.dtype == torch.bfloat16
    # one bf16 rounding of each gradient
    assert _rel(gh.float().numpy(), wh.numpy()) <= 2 ** -7
    assert _rel(gw.float().numpy(), ww.numpy()) <= 2 ** -7
