"""Training MLA + MoE (DeepSeek-V2-Lite, DeepSeek-V3) and the vision stub
(Qwen2-VL: ``embeds`` and M-RoPE ``positions``) through the port's FedAvg
round, held against the reference's on the CPU; ``launch.train``'s vision
batches; ``--full --n-layers`` on DeepSeek's layer plan.

One FedAvg round (G = 2 groups of H = 2 local AdamW steps, unequal group
weights) of each reduced config through ``local_sgd.build_fedavg_round_step``
against the reference's, on the same numpy batches and the reference's
params: the loss within 1e-5, every replica leaf and AdamW's moments within
1e-4 (rel L2), the tolerances of
``tests/test_torch_train.py::test_fedavg_round_matches_the_reference``.
The reduced DeepSeek configs train MLA (``wkv_a``, ``kv_norm``, ``wkv_b``;
V3 also its q-LoRA pair ``wq_a``, ``q_norm``, ``wq_b``) and the MoE (router
with the aux load-balance loss, routed and shared experts: V2-Lite's
softmax scoring, V3's sigmoid) after the leading dense layer; Qwen2-VL
trains its QKV biases under M-RoPE on positions whose three components
differ, from embeddings in the layout of the reference's
``make_batch_specs`` (its embedding table takes no gradient, in either
package). The key bias ``bk`` is the one replica leaf held otherwise: the
softmax over keys is invariant to one shift of every key, so ``bk``'s
gradient is what RoPE's turn leaves of it, and in the slow rotary channels
(which turn by 1e-6 rad a position and less) it falls to 1e-8-1e-9, where
the two packages' fp32 rounding (about 5e-10) is a tenth of it and AdamW's
eps (1e-8) sets the step: its steps part by a fraction of lr there (1.3%
rel L2 over the leaf after the round), its one-step gradient by 1.5e-6 and
its moments within 1e-4, held with the rest."""
import dataclasses

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
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
LR = 1e-3
G, H = 2, 2
ARCHS = ("deepseek-v2-lite-16b", "deepseek-v3-671b", "qwen2-vl-7b")
# leaves each arch's round must hold (a path component each), so that a
# renamed or dropped leaf cannot pass unseen
TRAINED = {"deepseek-v2-lite-16b": ("wkv_a", "kv_norm", "wkv_b", "wq", "router", "we_i",
                                    "shared"),
           "deepseek-v3-671b": ("wkv_a", "kv_norm", "wkv_b", "wq_a", "q_norm", "wq_b", "router",
                                "shared"),
           "qwen2-vl-7b": ("bq", "bk", "bv", "wq", "lm_head")}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _tree_close(got_tree, want_tree, rtol, *, key_bias_steps=None):
    """Every leaf of ``got_tree`` within ``rtol`` (rel L2) of the
    reference's; with ``key_bias_steps`` (the replicas) the key bias ``bk``
    instead within ``key_bias_steps`` x LR of it, element by element.
    Returns the paths, joined by '/'."""
    got, want = tree_leaves(params_to_numpy(got_tree)), jax.tree.leaves(_np(want_tree))
    paths = ["/".join(map(str, p)) for p in tree_paths(got_tree)]
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        assert g.shape == w.shape, path
        if key_bias_steps is not None and path.endswith("/bk"):
            assert np.abs(g - w).max() <= key_bias_steps * LR, path
            continue
        assert _rel(g, w) <= rtol, (path, _rel(g, w))
    return paths


def _round_batches(cfg, seed=3):
    """(H, G, 2, 12) labels; the token ids, or for the vision stub (H, G, 2,
    12, d) embeddings and (H, G, 2, 12, 3) positions (t, then h and w drawn
    apart from it, so that M-RoPE's three sections turn differently)."""
    r = np.random.default_rng(seed)
    shape = (H, G, 2, 12)
    b = {"labels": r.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.modality == "vision":
        b["embeds"] = r.normal(size=shape + (cfg.d_model,)).astype(np.float32)
        t = np.broadcast_to(np.arange(shape[-1]), shape)
        b["positions"] = np.stack([t, r.integers(0, 9, shape), r.integers(0, 9, shape)],
                                  axis=-1).astype(np.int32)
    else:
        b["tokens"] = r.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return b


@pytest.mark.parametrize("arch", ARCHS)
def test_fedavg_round_matches_the_reference(arch):
    """One round of the reduced config (DeepSeek: its dense layer, then an
    MLA + MoE layer; Qwen2-VL: 2 layers on stub embeddings): the loss (the
    CE plus the MoE's aux loss), every replica leaf after the broadcast and
    AdamW's step and moments."""
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
    # bk: H AdamW steps of about lr each at most, in either package
    paths = _tree_close(params_g, rp_g, GRAD_RTOL, key_bias_steps=2 * H)
    _tree_close(state_g.mu, rs_g.mu, GRAD_RTOL)
    _tree_close(state_g.nu, rs_g.nu, GRAD_RTOL)
    for name in TRAINED[arch]:
        assert any(name in p.split("/") for p in paths), name
    if model.cfg.moe is not None:
        assert [s.ffn for s in model.plan] == ["mlp", "moe"]
    if model.cfg.modality == "vision":
        # the stub never looks a token up: the table's moments stay zero
        table = np.asarray(params_to_numpy(state_g.nu)["embed"]["table"])
        assert not table.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_gradients_match_the_reference(arch):
    """``train_loss`` and every gradient leaf of one step on the reduced
    config, the reference's params and one group's batch, ``bk`` among them:
    the loss within 1e-5, each leaf within 1e-4 rel L2 (the vision stub's
    embedding table 0 in both packages)."""
    ref_model = ref_tf.TransformerLM(ref_reduced(ref_get_config(arch)))
    model = tf.TransformerLM(reduced(get_config(arch)), device="cpu")
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    batch = {k: v[0, 0] for k, v in _round_batches(model.cfg).items()}
    value_and_grad = jax.jit(jax.value_and_grad(ref_model.train_loss, has_aux=True))
    (ref_loss, _), ref_grads = value_and_grad(ref_params, jax.tree.map(jnp.asarray, batch))
    p = tree_map(lambda t: t.requires_grad_(),
                 params_from_numpy(_np(ref_params), model, device="cpu"))
    loss, _ = model.train_loss(p, tree_map(torch.from_numpy, batch))
    grads = torch.autograd.grad(loss, tree_leaves(p), materialize_grads=True)
    assert abs(float(loss.detach()) - float(ref_loss)) <= LOSS_TOL
    want = jax.tree.leaves(_np(ref_grads))
    assert len(grads) == len(want)
    for path, g, w in zip(tree_paths(p), grads, want):
        assert _rel(g.numpy(), w) <= GRAD_RTOL, (path, _rel(g.numpy(), w))


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


def test_train_vision_draws_embeds_after_the_offsets(monkeypatch):
    """``launch.train --arch qwen2-vl-7b --device cpu --remat`` (the reduced
    config): each round's batch is the reference's train layout, no tokens:
    ``embeds`` of (H, G, B, S, d) in the compute dtype, normal draws from the
    same numpy generator right after the round's start offsets into the
    corpus, ``positions`` (H, G, B, S, 3) int32 with every component t, and
    the corpus's next tokens as ``labels``; every round's loss is finite."""
    S, B, seed = 20, 2, 4
    recs, seen = _captured_run(monkeypatch, [
        "--arch", "qwen2-vl-7b", "--device", "cpu", "--rounds", "2", "--local-steps", str(H),
        "--groups", str(G), "--global-batch", str(G * B), "--seq", str(S), "--seed", str(seed),
        "--remat"])
    assert len(recs) == len(seen) == 2 and all(np.isfinite(r["loss"]) for r in recs)
    cfg = reduced(get_config("qwen2-vl-7b"))
    train_set, _, _ = make_word_corpus(n_authors=64, vocab_size=cfg.vocab_size,
                                       mean_words_per_author=20_000, seed=seed)
    corpus = np.concatenate(train_set)
    rng = np.random.default_rng(seed)
    for batch in seen:
        starts = rng.integers(0, len(corpus) - S - 1, (H, G, B))
        embeds = rng.normal(size=(H, G, B, S, cfg.d_model))
        assert set(batch) == {"labels", "embeds", "positions"}
        np.testing.assert_array_equal(batch["labels"][1, 0, 1].numpy(),
                                      corpus[starts[1, 0, 1] + 1:starts[1, 0, 1] + S + 1])
        assert batch["embeds"].dtype == torch.float32   # the reduced config's
        np.testing.assert_array_equal(batch["embeds"].numpy(), embeds.astype(np.float32))
        pos = batch["positions"]
        assert pos.dtype == torch.int32 and pos.shape == (H, G, B, S, 3)
        np.testing.assert_array_equal(pos.numpy(), np.broadcast_to(
            np.arange(S)[:, None], (H, G, B, S, 3)))


@pytest.mark.parametrize("arch,n_layers,dense", [("deepseek-v2-lite-16b", 4, 1),
                                                 ("deepseek-v3-671b", 4, 3),
                                                 ("qwen2-vl-7b", 8, 8)])
def test_full_n_layers_cuts_the_plan_at_full_width(arch, n_layers, dense):
    """``--full --n-layers L`` keeps the arch's widths and the first L
    layers of its plan: DeepSeek-V2-Lite's leading dense layer and then 3
    MoE layers at L = 4 (V3: its 3 dense layers and one MoE layer), MLA in
    every layer; Qwen2-VL 8 attention layers. Counted on the meta device,
    where nothing is allocated: V2-Lite's cut holds about 2.2 B params, the
    embedding and head 0.42 B of them, and each MoE layer about 0.585 B."""
    args = train._parser().parse_args(["--arch", arch, "--full", "--n-layers", str(n_layers),
                                       "--remat", "--state-dtype", "bfloat16"])
    cfg = train.train_config(args)
    whole = get_config(arch)
    assert cfg == dataclasses.replace(whole, n_layers=n_layers, remat=True)
    model = tf.TransformerLM(cfg, device="meta")
    ffn = [s.ffn for s in model.plan]
    assert ffn == ["mlp"] * dense + ["moe"] * (n_layers - dense)
    assert {s.mixer for s in model.plan} == {"mla" if whole.mla else "attn"}
    leaves = tree_leaves(model.param_shapes())
    assert all(t.device.type == "meta" for t in leaves)
    n_params = sum(t.numel() for t in leaves)
    assert n_params == cfg.n_params()
    if arch == "deepseek-v2-lite-16b":
        one_moe = (dataclasses.replace(cfg, n_layers=n_layers + 1).n_params() - n_params)
        assert 0.57e9 < one_moe < 0.60e9
        assert 2.1e9 < n_params < 2.3e9


@pytest.mark.parametrize("arch", ARCHS)
def test_train_runs_each_arch_with_remat(arch):
    """``launch.train --arch ARCH --device cpu --remat`` in bf16 (``--dtype``)
    with bf16 moments: a FedAvg round and a FedSGD step, finite losses, no
    kernel launched on the CPU."""
    argv = ["--arch", arch, "--device", "cpu", "--rounds", "1", "--local-steps", "2",
            "--global-batch", "4", "--seq", "16", "--dtype", "bfloat16", "--remat",
            "--state-dtype", "bfloat16"]
    for extra in ([], ["--algo", "fedsgd"]):
        recs = train.main(argv + extra)
        assert recs and all(np.isfinite(r["loss"]) for r in recs)
        assert all(v == 0 for r in recs for v in r["launches"].values())
