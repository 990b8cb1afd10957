"""Jamba training held against the reference on the same numpy inputs, in
fp32 on the CPU (where the scan's wrappers run their plain versions).

``SSMScan`` (``ops.mamba_ssm_scan_train``): its forward and the gradients of
all six inputs against ``jax.vjp`` of the reference's ``ssm_scan_ref`` and of
the segmented scan that ``repro/models/ssm.py`` trains through (checkpointed
every 128 steps), at T = 37 and T = 130 (across a segment), with cotangents on
y and h_T and a nonzero h0; ``ssm_scan_bwd_ref`` against autograd through
``ssm_scan_ref``, each gradient asked for alone; the forward's checkpoints;
reduced Jamba's ``train_loss`` and every gradient leaf (attention, Mamba/MLP
and Mamba/MoE layers) against ``jax.value_and_grad``; one reduced Jamba FedAvg
round against ``repro.core.local_sgd``; and ``launch.train`` with ``--full
--n-layers`` and ``--state-dtype``.

Tolerances: the scan's outputs and gradients 1e-5 of each one's largest
magnitude (fp32 sums over states, channels and time in other orders); the
model as ``tests/test_torch_train.py`` holds the dense archs: loss 1e-5,
each gradient leaf 1e-4 of its norm, a round's replicas and moments 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.core import local_sgd as ref_lsgd  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
import repro.optim as ref_optim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import local_sgd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    CHECKPOINT_EVERY,
    ssm_scan,
    ssm_scan_bwd,
    ssm_scan_bwd_ref,
    ssm_scan_ref,
)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

SCAN_RTOL = 1e-5
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
ARCH = "jamba-v0.1-52b"
LAYERS = 5          # attn at layer 4; Mamba/MLP at 0, 2; Mamba/MoE at 1, 3
NAMES = ("dt", "Bm", "Cm", "x", "A", "h0")


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


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max(initial=0.0)
    assert err <= SCAN_RTOL * max(np.abs(want).max(initial=0.0), 1e-30), (what, err)


def _scan_case(B, T, D, N, seed):
    """dt, Bm, Cm, x, A, h0 and the cotangents gy, g_hT, as numpy fp32; A
    down to -16.5 as ``ssm_inputs`` on the card draws it."""
    r = np.random.default_rng(seed)
    f = lambda *shape: r.normal(size=shape).astype(np.float32)  # noqa: E731
    dt = r.uniform(1e-3, 0.1, (B, T, D)).astype(np.float32)
    A = -r.uniform(0.5, 16.5, (D, N)).astype(np.float32)
    return (dt, f(B, T, N), f(B, T, N), f(B, T, D), A, f(B, D, N)), (f(B, T, D), f(B, D, N))


def _segmented(dt, Bm, Cm, x, A, h0):
    """The reference's training scan: ``models/ssm.py``'s step through
    ``_segmented_scan`` (``jax.checkpoint`` every 128 steps)."""
    def step(h, inp):
        dt_t, b_t, c_t, x_t = inp
        h = jnp.exp(dt_t[..., None] * A[None]) * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
        return h, jnp.einsum("bdn,bn->bd", h, c_t)

    sw = lambda a: jnp.swapaxes(a, 0, 1)  # noqa: E731
    h, ys = ref_ssm._segmented_scan(step, h0, (sw(dt), sw(Bm), sw(Cm), sw(x)), segment=128)
    return sw(ys), h


# ---------------------------------------------------------------------------
# the scan's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [37, 130])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("reference", ["ssm_scan_ref", "segmented"])
def test_ssm_scan_function_matches_jax_vjp_of_the_reference_scan(T, N, reference):
    ins, (gy, gh) = _scan_case(2, T, 6, N, seed=T + N)
    fn = ref.ssm_scan_ref if reference == "ssm_scan_ref" else _segmented
    (want_y, want_h), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in ins))
    want_g = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    args = [_t(a).requires_grad_() for a in ins]
    y, h = ops.mamba_ssm_scan_train(*args)
    torch.autograd.backward([y, h], [_t(gy), _t(gh)])
    _close(y.detach().numpy(), want_y, "y")
    _close(h.detach().numpy(), want_h, "h_T")
    for name, a, w in zip(NAMES, args, want_g):
        assert a.grad.shape == a.shape and a.grad.dtype == torch.float32
        _close(a.grad.numpy(), w, name)


@pytest.mark.parametrize("ask", ["all", "dt", "Bm", "Cm", "x", "A", "h0", "no g_hT"])
def test_ssm_scan_bwd_ref_matches_autograd_through_ssm_scan_ref(ask):
    """Each gradient asked for alone is the one autograd gives, and no other
    is computed; with ``g_hT=None`` (training drops h_T) the cotangent is
    zeros."""
    ins, (gy, gh) = _scan_case(2, 21, 5, 3, seed=7)
    args = [_t(a).requires_grad_() for a in ins]
    y, h = ssm_scan_ref(*args)
    g_hT = None if ask == "no g_hT" else _t(gh)
    torch.autograd.backward([y] + ([h] if g_hT is not None else []),
                            [_t(gy)] + ([g_hT] if g_hT is not None else []))
    needs = tuple(ask in ("all", "no g_hT", n) for n in NAMES)
    got = ssm_scan_bwd_ref(*(a.detach() for a in args), _t(gy), g_hT, needs)
    for name, need, g, a in zip(NAMES, needs, got, args):
        if need:
            _close(g.numpy(), a.grad.numpy(), name)
        else:
            assert g is None, name
    # the wrapper takes the plain version on a CPU tensor, checkpoints or not
    wrapped = ssm_scan_bwd(*(a.detach() for a in args), _t(gy), g_hT, needs=needs)
    for g, w in zip(wrapped, got):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("T", [1, 16, 37])
def test_scan_checkpoints_are_the_states_entering_each_run(T):
    """``checkpoints=True`` returns (B, ceil(T / 16), D, N): the state before
    steps 0, 16, 32, ..., which is h0 and then the final state of each
    prefix; y and h_T as without it."""
    ins, _ = _scan_case(2, T, 5, 4, seed=T)
    args = [_t(a) for a in ins]
    y, h, ck = ssm_scan(*args, checkpoints=True)
    y0, h0 = ssm_scan(*args)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert tuple(ck.shape) == (2, -(-T // CHECKPOINT_EVERY), 5, 4)
    assert torch.equal(ck[:, 0], args[5])
    for s in range(1, ck.shape[1]):
        t = s * CHECKPOINT_EVERY
        _, h_t = ssm_scan_ref(*(a[:, :t] for a in args[:4]), args[4], args[5])
        assert torch.equal(ck[:, s], h_t)


# ---------------------------------------------------------------------------
# reduced Jamba: train_loss, its gradients, a FedAvg round
# ---------------------------------------------------------------------------

def _jamba(**extra):
    ref_cfg = ref_reduced(ref_get_config(ARCH), n_layers=LAYERS, **extra)
    cfg = reduced(get_config(ARCH), n_layers=LAYERS, **extra)
    return ref_tf.TransformerLM(ref_cfg), tf.TransformerLM(cfg, device="cpu")


def _batch(vocab, shape, seed):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, vocab, shape).astype(np.int32),
            "labels": r.integers(0, vocab, shape).astype(np.int32)}


def test_reduced_jamba_plan_has_every_layer_kind():
    _, model = _jamba()
    kinds = [(s.mixer, s.ffn) for s in model.plan]
    assert kinds == [("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
                     ("attn", "mlp")]


def test_reduced_jamba_train_loss_and_every_gradient_match_the_reference():
    """The loss (CE + MoE aux), its CE, and every gradient leaf, with and
    without remat; remat recomputes the same forward, so its loss and
    gradients are the same bits."""
    ref_model, _ = _jamba()
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    batch = _batch(ref_model.cfg.vocab_size, (2, 13), 1)
    value_and_grad = jax.jit(jax.value_and_grad(ref_model.train_loss, has_aux=True))
    (want, want_aux), want_g = value_and_grad(ref_params, jax.tree.map(jnp.asarray, batch))
    results = []
    for remat in (False, True):
        _, model = _jamba(remat=remat)
        params = tree_map(lambda a: a.requires_grad_(),
                          params_from_numpy(_np(ref_params), model, device="cpu"))
        loss, aux = model.train_loss(params, tree_map(torch.from_numpy, batch))
        grads = torch.autograd.grad(loss, tree_leaves(params))
        assert abs(float(loss.detach()) - float(want)) <= LOSS_TOL
        assert abs(float(aux["ce"].detach()) - float(want_aux["ce"])) <= LOSS_TOL
        assert float(aux["aux"].detach()) > 0   # the MoE layers' load-balance loss is in it
        for path, g, w in zip(tree_paths(params), grads, jax.tree.leaves(_np(want_g))):
            assert tuple(g.shape) == w.shape, path
            assert _rel(g.numpy(), w) <= GRAD_RTOL, (path, _rel(g.numpy(), w))
        results.append((float(loss.detach()), grads))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)


def _tree_close(got_tree, want_tree, rtol):
    got, want = tree_leaves(params_to_numpy(got_tree)), jax.tree.leaves(_np(want_tree))
    assert len(got) == len(want)
    for path, g, w in zip(tree_paths(got_tree), got, want):
        assert g.shape == w.shape, path
        assert _rel(g, w) <= rtol, (path, _rel(g, w))


def test_reduced_jamba_fedavg_round_matches_the_reference():
    """One round, G = 2 groups of H = 2 local AdamW steps, unequal group
    weights: the loss, every replica leaf after the average and AdamW's
    moments, the weights carried across by ``params_from_numpy``."""
    G, H = 2, 2
    ref_model, model = _jamba()
    ref_params = ref_model.init(jax.random.PRNGKey(3))
    batches = _batch(ref_model.cfg.vocab_size, (H, G, 2, 12), 4)
    weights = np.array([1.0, 3.0], np.float32)
    ref_inner, inner = ref_optim.adamw(1e-3), optim.adamw(1e-3)
    rp_g = ref_lsgd.replicate_for_groups(ref_params, G)
    rs_g = jax.vmap(ref_inner.init)(rp_g)
    step = jax.jit(ref_lsgd.build_fedavg_round_step(
        ref_model.train_loss, ref_inner, ref_lsgd.LocalSGDConfig(G, H)))
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
    _tree_close(params_g, rp_g, GRAD_RTOL)
    _tree_close(state_g.mu, rs_g.mu, GRAD_RTOL)
    _tree_close(state_g.nu, rs_g.nu, GRAD_RTOL)


# ---------------------------------------------------------------------------
# launch.train: --full --n-layers and --state-dtype
# ---------------------------------------------------------------------------

def test_train_full_with_n_layers_cuts_the_depth_and_state_dtype_sets_the_moments(monkeypatch):
    """``--full`` trains the arch's own config; with ``--n-layers L`` its
    widths cut to L layers, without it the whole depth. ``--state-dtype``
    is the stored dtype of AdamW's moments. The arch's own config stands in
    for a small one here (reduced Jamba, 8 layers), so the CPU can run it."""
    import repro_torch.configs as configs
    import repro_torch.optim as optim_pkg

    small = reduced(get_config(ARCH))
    monkeypatch.setattr(configs, "get_config", lambda arch: small)
    seen = []
    adamw = optim_pkg.adamw

    def recording_adamw(lr, **kw):
        seen.append(kw.get("state_dtype", torch.float32))
        return adamw(lr, **kw)

    monkeypatch.setattr(optim_pkg, "adamw", recording_adamw)
    argv = ["--arch", ARCH, "--full", "--device", "cpu", "--rounds", "1", "--local-steps", "1",
            "--global-batch", "2", "--seq", "8"]
    records, final = train.run(argv + ["--n-layers", "2", "--state-dtype", "bfloat16"])
    want = tf.TransformerLM(dataclasses.replace(small, n_layers=2), device="meta").param_shapes()
    assert [tuple(p.shape) for p in tree_leaves(final)] == [
        tuple(p.shape) for p in tree_leaves(want)]
    assert len(records) == 1 and np.isfinite(records[0]["loss"])
    assert seen == [torch.bfloat16]
    assert records[0]["launches"] == dict.fromkeys(
        ("fused_cross_entropy", "ce_probs", "flash_attention", "ssm_scan", "ssm_scan_bwd",
         "fedavg_aggregate"), 0)   # the CPU runs no kernel
    _, final = train.run(argv)
    want = tf.TransformerLM(small, device="meta").param_shapes()
    assert [tuple(p.shape) for p in tree_leaves(final)] == [
        tuple(p.shape) for p in tree_leaves(want)]
    assert seen == [torch.bfloat16, torch.float32]
