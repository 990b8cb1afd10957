"""repro_torch's training path held against the reference on the same numpy
inputs, in fp32 on the CPU (where every wrapper runs its plain version).

The fused CE's plain version against the Pallas kernel (interpret mode) and
its oracle; the gradients of ``FusedCrossEntropy`` and ``FlashAttention``
against ``jax.grad``/``jax.vjp`` of the reference's ``chunked_cross_entropy``
and ``blocked_attention``; ``train_loss`` and every gradient leaf on reduced
configs against ``jax.value_and_grad(model.train_loss)`` on the reference's
params; the optimizers and schedules against ``repro.optim``; one FedAvg
round (with and without an outer optimizer) and one FedSGD step against
``repro.core.local_sgd``; the word corpus; and the kernels' grad guard.

Tolerances: 1e-5 where one sum is taken in another order (a CE over a
vocab tile, one attention tile pair); for a whole model's loss 1e-5 and its
gradients 1e-4 in norm relative to each leaf's norm (fp32 sums in other
orders through two layers and back); optimizer states and updates 1e-6 of
their scale over 3 steps (the same fp32 operations in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.core import local_sgd as ref_lsgd  # noqa: E402
from repro.data.synthetic import make_word_corpus as ref_word_corpus  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.ce_loss import fused_cross_entropy as ref_fused_ce  # noqa: E402
from repro.models import attention_core as ref_core  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
import repro.optim as ref_optim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import latest_step, peek_metadata  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    opt_state_from_numpy,
    params_from_numpy,
    params_to_numpy,
    replicas_from_numpy,
)
from repro_torch.core import local_sgd  # noqa: E402
from repro_torch.core.engine import RoundBatch, RoundState  # noqa: E402
from repro_torch.data.synthetic import make_word_corpus  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ce_loss import fused_cross_entropy  # noqa: E402
from repro_torch.kernels.fedavg_agg import fedavg_aggregate  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix  # noqa: E402
from repro_torch.kernels.grad_guard import refuse_grad  # noqa: E402
from repro_torch.kernels.quantized_agg import (  # noqa: E402
    packed_quantized_aggregate,
    quantized_aggregate,
)
from repro_torch.kernels.sparse_agg import sparse_aggregate  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention_core as core  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _tree_close(got_tree, want_tree, rtol):
    got, want = tree_leaves(params_to_numpy(got_tree)), jax.tree.leaves(_np(want_tree))
    assert len(got) == len(want)
    for path, g, w in zip(tree_paths(got_tree), got, want):
        assert g.shape == w.shape, path
        assert _rel(g, w) <= rtol, (path, _rel(g, w))


# ---------------------------------------------------------------------------
# fused cross-entropy: the plain version and its gradient
# ---------------------------------------------------------------------------

def _ce_case(rng, T, d, V, same_label=False):
    hidden = rng.normal(size=(T, d)).astype(np.float32)
    table = (rng.normal(size=(V, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    labels[0] = 0
    labels[-1] = V - 1
    if same_label:
        labels[:] = V // 2
    return hidden, table, labels


@pytest.mark.parametrize("T,V", [(1, 1), (13, 50), (37, 129), (16, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [False, True])
def test_fused_ce_plain_matches_pallas_kernel_and_oracle(rng, T, V, dtype, tied):
    """Per-token loss and lse of the plain version against the Pallas kernel
    (interpret mode, ragged tiles) and ``ref.ce_loss_ref``; the head is a
    (d, V) array or the transposed view of a (V, d) table, read in place."""
    d = 16
    hidden, table, labels = _ce_case(rng, T, d, V, same_label=(T == 16))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    h_j, w_j = jnp.asarray(hidden).astype(jd), jnp.asarray(table.T).astype(jd)
    want = np.asarray(ref_fused_ce(h_j, w_j, jnp.asarray(labels), block_t=8, block_v=16,
                                   interpret=True))
    # the oracle takes bf16 logits in bf16: fed fp32 copies of the same values
    want_mean = float(ref.ce_loss_ref(h_j.astype(jnp.float32), w_j.astype(jnp.float32),
                                      jnp.asarray(labels)))
    h_t = _t(hidden).to(td)
    head = _t(table).to(td).T if tied else _t(table.T).to(td)
    assert V == 1 or head.is_contiguous() != tied
    loss, lse = fused_cross_entropy(h_t, head, torch.from_numpy(labels))
    logits = np.asarray(h_j.astype(jnp.float32) @ w_j.astype(jnp.float32), np.float64)
    want_lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    tol = 1e-5 * max(1.0, float(np.abs(want_lse).max()))
    assert loss.dtype == lse.dtype == torch.float32 and loss.shape == (T,)
    np.testing.assert_allclose(loss.numpy(), want, atol=tol)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=tol)
    assert abs(float(loss.mean()) - want_mean) <= tol


@pytest.mark.parametrize("T,V,slots", [(4096, 256_000, 132), (4096, 256_000, 396), (1, 256_000, 132),
                                       (37, 1000, 132), (4096, 1, 132), (300, 2049, 264)])
def test_ce_split_plan_leaves_no_split_empty_and_fills_its_waves(T, V, slots):
    """Every split has vocab tiles and together they cover the vocab; the
    plan takes within 1% of the fewest (waves x tiles a split) of any split
    count; at the training shape on one block an SM of 132 SMs the grid is
    8 whole waves (33 splits of 61 tiles)."""
    from repro_torch.kernels.ce_loss import TILE, split_plan

    n_tt, n_vt = -(-T // TILE), -(-V // TILE)
    splits, per = split_plan(T, V, slots)
    assert splits * per >= n_vt > (splits - 1) * per

    def steps(s, p):
        return -(-(n_tt * s) // slots) * p

    best = min(steps(-(-n_vt // -(-n_vt // w)), -(-n_vt // w)) for w in range(1, n_vt + 1))
    assert steps(splits, per) <= 1.01 * best
    if (T, V, slots) == (4096, 256_000, 132):
        assert (splits, per) == (33, 61) and n_tt * splits == 8 * slots


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("tied", [False, True])
def test_fused_ce_gradient_matches_jax_grad_of_chunked_cross_entropy(rng, chunk, tied):
    """``ops.ce_loss_mean`` (``FusedCrossEntropy``) value and gradients to
    hidden and head against ``jax.grad`` of the reference's
    ``chunked_cross_entropy``, at S = 13 (not a multiple of the chunk)."""
    B, S, d, V = 2, 13, 16, 40
    hidden = rng.normal(size=(B, S, d)).astype(np.float32)
    table = (rng.normal(size=(V, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)

    def ref_loss(h, w):
        return ref_tf.chunked_cross_entropy(h, w, jnp.asarray(labels), chunk)

    want, (dh, dw) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(table.T))
    h = _t(hidden).requires_grad_()
    tab = _t(table).requires_grad_()
    w = tab.T if tied else tab.T.contiguous().detach().requires_grad_()
    got = ops.ce_loss_mean(h, w, torch.from_numpy(labels), chunk=chunk)
    got.backward()
    dw_got = tab.grad.T if tied else w.grad
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(dh), atol=1e-6)
    np.testing.assert_allclose(dw_got.numpy(), np.asarray(dw), atol=1e-6)
    # the plain oracle beside train_loss computes the same function
    oracle = tf.chunked_cross_entropy(_t(hidden), _t(table.T), torch.from_numpy(labels), chunk)
    assert abs(float(oracle) - float(want)) <= 1e-6


# ---------------------------------------------------------------------------
# attention with a gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,K", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 9), (False, 0)])
def test_flash_attention_function_matches_jax_vjp_of_blocked_attention(rng, H, K, causal,
                                                                       window):
    """``FlashAttention``'s output and dq/dk/dv against ``jax.vjp`` of the
    reference's ``blocked_attention`` (its custom flash VJP), at a ragged
    S = 37 with 8 x 16 tiles: MHA, GQA and MQA; causal, windowed and full."""
    B, S, D = 2, 37, 8
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, K, D)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(B, S, H, D)).astype(np.float32)
    opts = dict(causal=causal, window=window, q_chunk=8, k_chunk=16)
    want, vjp = jax.vjp(lambda a, b, c: ref_core.blocked_attention(a, b, c, **opts),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq, dk, dv = vjp(jnp.asarray(g))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = ops.mha_flash_train(qt, kt, vt, **opts)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    for got, w in ((qt.grad, dq), (kt.grad, dk), (vt.grad, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5)


def test_blocked_attention_lse_matches_the_reference_forward(rng):
    """The (B, Sq, H) lse the training forward keeps: ``m + log(l)`` of the
    scaled scores, as ``_blocked_attention_fwd_impl`` returns it."""
    q = rng.normal(size=(2, 21, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 21, 2, 8)).astype(np.float32) for _ in range(2))
    _, want = ref_core._blocked_attention_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=5, q_offset=0,
        q_chunk=8, k_chunk=8)
    _, got = core.blocked_attention(_t(q), _t(k), _t(v), window=5, q_chunk=8, k_chunk=8,
                                    return_lse=True)
    _, got_kernel_path = flash_attention(_t(q), _t(k), _t(v), window=5, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_kernel_path.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# train_loss on reduced configs
# ---------------------------------------------------------------------------

TRAIN_MODELS = {"gemma": ("gemma-2b", {}), "gemma_ce8": ("gemma-2b", {"ce_chunk": 8}),
                "qwen2": ("qwen2-72b", {}), "minitron": ("minitron-8b", {})}


def _lm(name, **extra):
    arch, over = TRAIN_MODELS[name]
    ref_cfg = ref_reduced(ref_get_config(arch), **over, **extra)
    cfg = reduced(get_config(arch), **over, **extra)
    return ref_tf.TransformerLM(ref_cfg), tf.TransformerLM(cfg, device="cpu")


def _lm_batch(vocab, shape, seed):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, vocab, shape).astype(np.int32),
            "labels": r.integers(0, vocab, shape).astype(np.int32)}


@pytest.mark.parametrize("name", sorted(TRAIN_MODELS))
def test_train_loss_and_every_gradient_match_the_reference(name):
    ref_model, _ = _lm(name)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    batch = _lm_batch(ref_model.cfg.vocab_size, (2, 13), 1)
    value_and_grad = jax.jit(jax.value_and_grad(ref_model.train_loss, has_aux=True))
    (want, want_aux), want_g = value_and_grad(ref_params, jax.tree.map(jnp.asarray, batch))
    results = []
    for remat in (False, True):
        _, model = _lm(name, remat=remat)
        params = tree_map(lambda a: a.requires_grad_(),
                          params_from_numpy(_np(ref_params), model, device="cpu"))
        loss, aux = model.train_loss(params, tree_map(torch.from_numpy, batch))
        grads = torch.autograd.grad(loss, tree_leaves(params))
        assert abs(float(loss) - float(want)) <= LOSS_TOL
        assert abs(float(aux["ce"]) - float(want_aux["ce"])) <= LOSS_TOL
        paths = tree_paths(params)
        for path, g, w in zip(paths, grads, jax.tree.leaves(_np(want_g))):
            assert tuple(g.shape) == w.shape, path
            assert _rel(g.numpy(), w) <= GRAD_RTOL, (path, _rel(g.numpy(), w))
        results.append((float(loss), [g.clone() for g in grads]))
    # remat recomputes the same forward: equal loss, equal gradients
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)


def test_loss_takes_the_tuple_batch_of_core_fedavg():
    _, model = _lm("gemma")
    params = model.init(0)
    b = _lm_batch(model.cfg.vocab_size, (2, 9), 2)
    tokens, labels = torch.from_numpy(b["tokens"]), torch.from_numpy(b["labels"])
    a, _ = model.loss(params, (tokens, labels))
    c, _ = model.train_loss(params, {"tokens": tokens, "labels": labels})
    assert float(a) == float(c)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "b": [rng.normal(size=(3,)).astype(np.float32), rng.normal(size=(2, 2))
                  .astype(np.float32)]}


OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(0.1)),
    "momentum": (lambda m: m.momentum(0.1, beta=0.9)),
    "nesterov": (lambda m: m.momentum(0.1, beta=0.9, nesterov=True)),
    "adam": (lambda m: m.adam(1e-2)),
    "adamw": (lambda m: m.adamw(1e-2)),
    "adamw_bf16_state": (lambda m: m.adamw(1e-2, state_dtype=getattr(
        jnp if m is ref_optim else torch, "bfloat16"))),
    "adamw_warmup_cosine": (lambda m: m.adamw(m.warmup_cosine(1e-2, 2, 10))),
    "sgd_exponential": (lambda m: m.sgd(m.exponential_decay(0.1, 0.9, 2))),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_three_steps_match_the_reference(rng, name):
    params = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    ref_opt, opt = OPTIMIZERS[name](ref_optim), OPTIMIZERS[name](optim)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_opt.init(rp)
    tp = tree_map(_t, params)
    ts = opt.init(tp)
    for g in grads:
        ru, rs = ref_opt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        rp = ref_optim.optimizers.apply_updates(rp, ru)
        tu, ts = opt.update(tree_map(_t, g), ts, tp)
        tp = optim.apply_updates(tp, tu)
        for got, want in zip(tree_leaves(tu), jax.tree.leaves(ru)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(rp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert int(ts.step) == int(rs.step) == 3
    for field in ts._fields[1:]:
        for got, want in zip(tree_leaves(getattr(ts, field)), jax.tree.leaves(getattr(rs, field))):
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("exponential_decay", (0.3, 0.99, 3)),
    ("cosine_decay", (0.3, 7, 0.1)), ("warmup_cosine", (0.3, 3, 12)),
])
def test_schedules_match_the_reference(name, args):
    ref_fn, fn = getattr(ref_optim, name)(*args), getattr(optim, name)(*args)
    for step in range(15):
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), float(ref_fn(jnp.int32(step))), rtol=1e-6)


def test_clip_by_global_norm_matches_the_reference(rng):
    g = _opt_tree(rng)
    for max_norm in (0.5, 100.0):
        want = ref_optim.clip_by_global_norm(max_norm)(jax.tree.map(jnp.asarray, g))
        got = optim.clip_by_global_norm(max_norm)(tree_map(_t, g))
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ---------------------------------------------------------------------------
# FedAvg rounds and the FedSGD step
# ---------------------------------------------------------------------------

G, H = 2, 2


def _round_inputs(ref_model):
    cfg = ref_model.cfg
    b = _lm_batch(cfg.vocab_size, (H, G, 2, 12), 3)
    return b, np.array([1.0, 3.0], np.float32)


@pytest.mark.parametrize("outer", [False, True])
def test_fedavg_round_matches_the_reference(outer):
    """One round, G = 2 groups of H = 2 local AdamW steps on reduced
    Gemma-2B, unequal group weights: the loss, every replica leaf after the
    broadcast, the inner AdamW state (moments and step) and, with the
    DiLoCo-style outer Nesterov optimizer, its velocity."""
    ref_model, model = _lm("gemma")
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    batches, weights = _round_inputs(ref_model)
    ref_inner, inner = ref_optim.adamw(1e-3), optim.adamw(1e-3)
    mk_outer = lambda m: m.momentum(0.7, beta=0.9, nesterov=True)  # noqa: E731
    ref_outer, outer_opt = (mk_outer(ref_optim), mk_outer(optim)) if outer else (None, None)

    rp_g = ref_lsgd.replicate_for_groups(ref_params, G)
    rs_g = jax.vmap(ref_inner.init)(rp_g)
    ro = ref_outer.init(ref_params) if outer else None
    step = jax.jit(ref_lsgd.build_fedavg_round_step(
        ref_model.train_loss, ref_inner, ref_lsgd.LocalSGDConfig(G, H), outer_opt=ref_outer))
    rp_g, rs_g, ro, rm = step(rp_g, rs_g, ro, jax.tree.map(jnp.asarray, batches),
                              jnp.asarray(weights))

    params_g = local_sgd.replicate_for_groups(
        params_from_numpy(_np(ref_params), model, device="cpu"), G)
    state_g = local_sgd.init_group_states(inner, params_g)
    o = outer_opt.init(local_sgd.unreplicate(params_g)) if outer else None
    round_step = local_sgd.as_round_step(model.train_loss, inner, local_sgd.LocalSGDConfig(G, H),
                                         outer_opt=outer_opt)
    state, m = round_step(RoundState(params_g, outer_state=o, inner_state=state_g),
                          RoundBatch(tree_map(torch.from_numpy, batches), None,
                                     torch.from_numpy(weights)))
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_TOL
    _tree_close(state.params, rp_g, GRAD_RTOL)
    assert state.inner_state.step.tolist() == np.asarray(rs_g.step).tolist() == [H] * G
    _tree_close(state.inner_state.mu, rs_g.mu, GRAD_RTOL)
    _tree_close(state.inner_state.nu, rs_g.nu, GRAD_RTOL)
    if outer:
        # the velocity is the round's pseudo-gradient, the mean AdamW update: its
        # first steps scale each gradient element to about +-lr whatever its size,
        # so elements whose gradient is at rounding level may take either sign
        # in either package (measured 6.1e-4 of the norm here)
        _tree_close(state.outer_state.velocity, ro.velocity, 2e-3)


def test_fedavg_round_starts_from_a_reference_state():
    """``replicas_from_numpy`` and ``opt_state_from_numpy`` carry a
    reference round's (G, ...) replicas and AdamW state across, and the
    port's next round from there matches the reference's. (Not on Qwen2:
    its key bias has an analytically zero gradient, softmax being
    shift-invariant per query, and AdamW turns that rounding noise into
    steps of about lr in either package.)"""
    ref_model, model = _lm("minitron")
    ref_params = ref_model.init(jax.random.PRNGKey(1))
    batches, weights = _round_inputs(ref_model)
    ref_inner, inner = ref_optim.adamw(1e-3), optim.adamw(1e-3)
    cfg_r = ref_lsgd.LocalSGDConfig(G, H)
    step = jax.jit(ref_lsgd.build_fedavg_round_step(ref_model.train_loss, ref_inner, cfg_r))
    rp_g = ref_lsgd.replicate_for_groups(ref_params, G)
    rs_g = jax.vmap(ref_inner.init)(rp_g)
    jb = jax.tree.map(jnp.asarray, batches)
    rp_g, rs_g, _, _ = step(rp_g, rs_g, None, jb, jnp.asarray(weights))
    params_g = replicas_from_numpy(_np(rp_g), model, device="cpu")
    state_g = opt_state_from_numpy(_np(rs_g), optim.optimizers.AdamState, device="cpu")
    rp_g, rs_g, _, rm = step(rp_g, rs_g, None, jb, jnp.asarray(weights))
    round_step = local_sgd.build_fedavg_round_step(model.train_loss, inner,
                                                   local_sgd.LocalSGDConfig(G, H))
    params_g, state_g, _, m = round_step(params_g, state_g, None,
                                         tree_map(torch.from_numpy, batches),
                                         torch.from_numpy(weights))
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_TOL
    assert state_g.step.tolist() == [2 * H] * G
    _tree_close(params_g, rp_g, GRAD_RTOL)
    _tree_close(state_g.nu, rs_g.nu, GRAD_RTOL)


def test_fedsgd_step_matches_the_reference():
    ref_model, model = _lm("minitron")
    ref_params = ref_model.init(jax.random.PRNGKey(2))
    batch = _lm_batch(ref_model.cfg.vocab_size, (3, 11), 4)
    ref_opt, opt = ref_optim.adamw(1e-3), optim.adamw(1e-3)
    ref_step = jax.jit(ref_lsgd.build_fedsgd_train_step(ref_model.train_loss, ref_opt))
    rp, rs, rm = ref_step(ref_params, ref_opt.init(ref_params), jax.tree.map(jnp.asarray, batch))
    params = params_from_numpy(_np(ref_params), model, device="cpu")
    params, state, m = local_sgd.build_fedsgd_train_step(model.train_loss, opt)(
        params, opt.init(params), tree_map(torch.from_numpy, batch))
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_TOL
    assert abs(float(m["ce"]) - float(rm["ce"])) <= LOSS_TOL
    assert int(state.step) == 1
    _tree_close(params, rp, GRAD_RTOL)


def test_tree_weighted_mean_goes_leaf_by_leaf_through_the_aggregate(rng):
    """Raw counts normalized once; fp32 leaves equal the reference's mean to
    1e-6; a bf16 leaf is summed in fp32 and rounded once (the reference sums
    in bf16), so it is within one bf16 ulp of the fp32 mean."""
    from repro.utils.tree import tree_weighted_mean as ref_twm

    tree = {"a": rng.normal(size=(3, 4, 5)).astype(np.float32),
            "b": [rng.normal(size=(3, 7)).astype(np.float32)]}
    w = np.array([1.0, 2.0, 5.0], np.float32)
    want = ref_twm(jax.tree.map(jnp.asarray, tree), jnp.asarray(w))
    got = ops.tree_weighted_mean(tree_map(_t, tree), torch.from_numpy(w))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    bf = ops.tree_weighted_mean({"x": _t(tree["a"]).bfloat16()}, w)["x"]
    exact = np.tensordot(w / w.sum(), _t(tree["a"]).bfloat16().double().numpy(), axes=1)
    assert bf.dtype == torch.bfloat16
    assert np.all(np.abs(bf.float().numpy() - exact) <= np.abs(exact) * 2.0 ** -8 + 1e-7)
    # against the reference's bf16 sum (a bf16 rounding at every product and
    # add): within one bf16 ulp of the largest term, element by element
    x_bf = jnp.asarray(tree["a"]).astype(jnp.bfloat16)
    ref_bf = np.asarray(ref_twm({"x": x_bf}, jnp.asarray(w))["x"].astype(jnp.float32))
    largest = np.abs(np.asarray(x_bf.astype(jnp.float32))).max(axis=0)
    assert np.all(np.abs(bf.float().numpy() - ref_bf) <= largest * 2.0 ** -7)
    # two groups of equal weight, as ``launch.train`` averages them: halving
    # is exact and the one bf16 add rounds once, so the two agree bit for bit
    two = _t(tree["a"][:2]).bfloat16()
    ref_two = ref_twm({"x": x_bf[:2]}, jnp.ones(2))["x"].astype(jnp.float32)
    assert np.array_equal(ops.tree_weighted_mean({"x": two}, np.ones(2))["x"].float().numpy(),
                          np.asarray(ref_two))


# ---------------------------------------------------------------------------
# launch.train, the corpus, the grad guard
# ---------------------------------------------------------------------------

def test_train_main_runs_fedavg_and_fedsgd_on_the_cpu(tmp_path):
    argv = ["--arch", "gemma-2b", "--device", "cpu", "--rounds", "2", "--local-steps", "2",
            "--global-batch", "4", "--seq", "16", "--n-layers", "2"]
    recs = train.main(argv)
    assert [r["round"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["tokens"] == 2 * 2 * 2 * 16 for r in recs)
    assert all(set(r["launches"].values()) == {0} for r in recs)   # the CPU runs no kernel
    steps = train.main(argv + ["--algo", "fedsgd", "--rounds", "1"])
    assert [r["step"] for r in steps] == [1, 2]
    ck = tmp_path / "ck"                 # --checkpoint-dir writes the final params
    steps = train.main(argv + ["--algo", "fedsgd", "--rounds", "1", "--checkpoint-dir", str(ck)])
    assert [r["step"] for r in steps] == [1, 2] and latest_step(ck) == 1
    assert peek_metadata(ck) == {"algo": "fedsgd", "arch": "gemma-2b"}
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--arch", "gemma-2b"])


@pytest.mark.parametrize("vocab", [50, 1000])
def test_make_word_corpus_is_byte_identical(vocab):
    got = make_word_corpus(6, vocab_size=vocab, mean_words_per_author=200, seed=3)
    want = ref_word_corpus(6, vocab_size=vocab, mean_words_per_author=200, seed=3)
    assert got[2] == want[2]
    for part_got, part_want in zip(got[:2], want[:2]):
        assert len(part_got) == len(part_want)
        for a, b in zip(part_got, part_want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _guard_cases():
    """Each wrapper called on CPU tensors, one of which requires grad; the
    differentiable input is returned beside the output."""
    r = np.random.default_rng(0)
    w = torch.tensor([0.25, 0.75])
    x = _t(r.normal(size=(2, 40))).requires_grad_()
    lo = torch.zeros((2, 1)).requires_grad_()
    scale = torch.full((2, 1), 0.1)
    codes = torch.from_numpy(r.integers(0, 255, (2, 40)).astype(np.uint8))
    words = torch.from_numpy(r.integers(-2**31, 2**31, (2, 5)).astype(np.int32))
    vals = _t(r.normal(size=(2, 3))).requires_grad_()
    idx = torch.from_numpy(np.array([[0, 2, 5], [1, 2, 9]], np.int32))
    mix_idx = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    mix_w = torch.full((2, 2), 0.5)
    q = _t(r.normal(size=(1, 5, 2, 4))).requires_grad_()
    kv = _t(r.normal(size=(1, 5, 1, 4)))
    dt = _t(r.uniform(0.01, 0.1, (1, 4, 3))).requires_grad_()
    bc = _t(r.normal(size=(1, 4, 2)))
    A = -_t(r.uniform(0.5, 1, (3, 2)))
    hid = _t(r.normal(size=(3, 4))).requires_grad_()
    return {
        "fedavg_aggregate": (x, lambda: fedavg_aggregate(x, w)),
        "quantized_aggregate": (lo, lambda: quantized_aggregate(codes, lo, scale, w, chunk=40,
                                                                 levels=255)),
        "packed_quantized_aggregate": (lo, lambda: packed_quantized_aggregate(
            words, lo, scale, w, bits=4, chunk=40, levels=15)),
        "sparse_aggregate": (vals, lambda: sparse_aggregate(idx, vals, w, 10)),
        "gossip_mix": (x, lambda: gossip_mix(x, mix_idx, mix_w)),
        "flash_attention": (q, lambda: flash_attention(q, kv, kv)),
        "ssm_scan": (dt, lambda: ssm_scan(dt, bc, bc, dt, A, torch.zeros(1, 3, 2))[0]),
        "SSMScan": (dt, lambda: ops.mamba_ssm_scan_train(dt, bc, bc, dt, A,
                                                         torch.zeros(1, 3, 2))[0]),
        "fused_cross_entropy": (hid, lambda: fused_cross_entropy(
            hid, _t(r.normal(size=(4, 6))), torch.tensor([0, 5, 2], dtype=torch.int32))[0]),
    }


@pytest.mark.parametrize("name", sorted(_guard_cases()))
def test_grad_guard_is_inert_on_cpu_tensors(name):
    """On a CPU tensor every wrapper runs its plain version, which stays
    differentiable: the guard is for the card only."""
    leaf, call = _guard_cases()[name]
    out = call()
    assert out.requires_grad
    out.float().square().sum().backward()
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all()


def test_grad_guard_refuses_differentiable_inputs_under_grad_mode():
    x, y = torch.ones(2, requires_grad=True), torch.ones(2)
    with pytest.raises(ValueError, match="ops.ce_loss_mean"):
        refuse_grad("fused_cross_entropy", (y, x), "Its entry point is ops.ce_loss_mean.")
    refuse_grad("fused_cross_entropy", (y,), "")
    with torch.no_grad():
        refuse_grad("fused_cross_entropy", (x,), "")
    refuse_grad("fused_cross_entropy", (x.detach(),), "")


def test_transformer_forward_in_train_mode_has_a_gradient_to_attention():
    """mode="train" routes attention through ``FlashAttention``: the query
    projection gets a non-zero gradient (the fault the grad guard closes on
    the card, where a bare kernel launch would drop it)."""
    _, model = _lm("gemma")
    params = model.init(0)
    wq = params["layers"][0]["sub0"]["mixer"]["wq"].requires_grad_()
    b = _lm_batch(model.cfg.vocab_size, (1, 8), 5)
    loss, _ = model.train_loss(params, tree_map(torch.from_numpy, b))
    (g,) = torch.autograd.grad(loss, [wq])
    assert float(g.abs().max()) > 0
