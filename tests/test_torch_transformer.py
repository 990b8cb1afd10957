"""repro_torch's LM substrate held against the reference on the same params.

Configs, plans, every layer of Jamba and Gemma, and ``TransformerLM.prefill``
/ ``decode_step`` on reduced Jamba (8 and 16 layers), reduced Gemma-2B and
the other archs the port serves (Gemma-7B, Qwen2 with its QKV bias,
Minitron), in fp32 on the CPU. The reference's params come from its own ``init`` and
cross as numpy arrays; its jitted prefill and decode are built once per
model and shared by the tests (module scope), so each compiles once.

Tolerances: 1e-5 for one layer (fp32 sums in another order); for the whole
model 1e-4 on logits and 3e-5 on cache leaves (the same, compounded over up
to 16 layers; measured about 2e-6 and 6e-6 on reduced Jamba), inside the
reference's own prefill+decode consistency bound of 3e-4."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    tree_leaves,
    tree_map,
    tree_paths,
    tree_ravel,
    tree_unravel,
)

LAYER_ATOL = 1e-5
LOGITS_ATOL = 1e-4
CACHE_ATOL = 3e-5
B, S, EXTRA = 2, 16, 4           # batch, prompt, cache slots past the prompt
DECODE_STEPS = 3
MODELS = {"jamba8": ("jamba-v0.1-52b", {}), "jamba16": ("jamba-v0.1-52b", {"n_layers": 16}),
          "gemma": ("gemma-2b", {}), "gemma7b": ("gemma-7b", {}),
          "qwen2": ("qwen2-72b", {}), "minitron": ("minitron-8b", {})}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(arch, **over):
    return ref_reduced(ref_get_config(arch), **over), reduced(get_config(arch), **over)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol)


# ---------------------------------------------------------------------------
# configs and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_configs_and_plans_equal_the_reference(arch):
    for ref_cfg, cfg in (_cfgs(arch),
                         (ref_get_config(arch), get_config(arch))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        plan, ref_plan = tf.layer_plan(cfg), ref_tf.layer_plan(ref_cfg)
        assert [dataclasses.asdict(s) for s in plan] == [dataclasses.asdict(s) for s in ref_plan]
        assert ([(tuple(map(dataclasses.asdict, g.specs)), g.repeats)
                 for g in tf.segment_plan(plan)]
                == [(tuple(map(dataclasses.asdict, g.specs)), g.repeats)
                    for g in ref_tf.segment_plan(ref_plan)])


def test_jamba_at_16_layers_stacks_two_repeats():
    segs = tf.segment_plan(tf.layer_plan(reduced(get_config("jamba-v0.1-52b"), n_layers=16)))
    assert [(len(g.specs), g.repeats) for g in segs] == [(8, 2)]
    segs = tf.segment_plan(tf.layer_plan(reduced(get_config("jamba-v0.1-52b"))))
    assert [(len(g.specs), g.repeats) for g in segs] == [(1, 1)] * 8


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "gemma-2b", "deepseek-v2-lite-16b",
                                  "deepseek-v3-671b", "qwen2-vl-7b", "xlstm-350m",
                                  "seamless-m4t-medium"])
def test_parameter_counts_equal_the_reference(arch):
    for ref_cfg, cfg in (_cfgs(arch), (ref_get_config(arch), get_config(arch))):
        assert cfg.n_params() == ref_cfg.n_params()
        assert cfg.n_active_params() == ref_cfg.n_active_params()
    assert get_config("jamba-v0.1-52b").n_params() > 5e10


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_unported_archs_and_entry_points_name_their_roadmap_item(arch):
    """No arch is left unported: the refusal table that named ROADMAP Queue 1
    item 4 is gone, and every one of the ten reference archs builds on the
    CPU, draws params whose tree is the one it states, and serves a prompt
    (``serve.prompt_batch``'s: tokens, the vision stub's embeds, the audio
    stub's frames) to finite logits. xLSTM and SeamlessM4T are held against
    the reference in tests/test_torch_xlstm.py and tests/test_torch_encdec.py,
    MLA and the vision stub in tests/test_torch_mla.py and
    tests/test_torch_vision.py, train_loss in tests/test_torch_train.py."""
    assert not hasattr(tf, "_NOT_PORTED")
    cfg = reduced(get_config(arch))
    model = tf.TransformerLM(cfg, device="cpu")
    params = model.init(0)
    assert tree_paths(params) == tree_paths(model.param_shapes())
    assert sum(leaf.numel() for leaf in tree_leaves(params)) == cfg.n_params()
    prompt = serve.prompt_batch(cfg, 1, 8, np.random.default_rng(0), frames=5)
    _, logits = model.prefill(params, prompt, cache_len=9)
    assert logits.shape == (1, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all())


def test_tree_order_over_lists_and_dicts_is_jax_tree_order():
    """Lists in index order, dict keys sorted, depth first: an LM tree's
    leaves (``layers/0/sub0/...``) ravel in the reference's order, and
    unravel back to lists and dicts."""
    tree = {"b": [np.zeros(2), {"d": np.ones(3), "c": np.full(1, 2.0)}], "a": np.zeros((2, 2))}
    want = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert tree_paths(tree) == want == [("a",), ("b", 0), ("b", 1, "c"), ("b", 1, "d")]
    flat, spec = tree_ravel(_torch(tree))
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)]))
    back = tree_unravel(spec, flat)
    assert isinstance(back["b"], list) and isinstance(back["b"][1], dict)
    assert tree_paths(back) == want


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = reduced(get_config("gemma-2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma-2b", "--tokens", "2"])


# ---------------------------------------------------------------------------
# layer by layer, same params
# ---------------------------------------------------------------------------

def test_rope_and_rmsnorm_match_reference(rng):
    x = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    pos = (np.arange(8)[None, :] + np.array([[0], [5]])).astype(np.int32)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), LAYER_ATOL)
    scale = rng.normal(size=(16,)).astype(np.float32)
    _close(layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-6),
           ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6), LAYER_ATOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlp_matches_reference(rng, act):
    p = _np(ref_layers.mlp_init(jax.random.PRNGKey(1), 32, 64, jnp.float32,
                                gated=act != "relu"))
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    _close(layers.mlp_apply(_torch(p), torch.from_numpy(x), act),
           ref_layers.mlp_apply(p, jnp.asarray(x), act), LAYER_ATOL)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "gemma-2b"])
def test_attention_prefill_and_decode_match_reference(rng, arch):
    ref_cfg, cfg = _cfgs(arch)
    p = _np(ref_layers.attention_init(jax.random.PRNGKey(2), ref_cfg, jnp.float32))
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    ref_cache = ref_layers.init_attn_cache(ref_cfg, B, S + EXTRA, jnp.float32)
    want, want_c, _ = ref_layers.attention_apply(p, ref_cfg, jnp.asarray(x),
                                                 positions=jnp.asarray(pos),
                                                 cache=ref_cache, mode="prefill")
    cache = layers.init_attn_cache(cfg, B, S + EXTRA, torch.float32, "cpu")
    got, got_c, _ = layers.attention_apply(_torch(p), cfg, torch.from_numpy(x),
                                           positions=torch.from_numpy(pos), cache=cache,
                                           mode="prefill")
    _close(got, want, LAYER_ATOL)
    for k in ("k", "v", "idx"):
        _close(got_c[k], want_c[k], LAYER_ATOL)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    pos1 = np.full((B, 1), S, np.int32)
    want, want_c, _ = ref_layers.attention_apply(p, ref_cfg, jnp.asarray(x1),
                                                 positions=jnp.asarray(pos1), cache=want_c,
                                                 mode="decode")
    got, got_c, _ = layers.attention_apply(_torch(p), cfg, torch.from_numpy(x1),
                                           positions=torch.from_numpy(pos1), cache=got_c,
                                           mode="decode")
    _close(got, want, LAYER_ATOL)
    for k in ("k", "v", "idx"):
        _close(got_c[k], want_c[k], LAYER_ATOL)


def test_moe_matches_reference_with_and_without_drops(rng):
    """Reduced Jamba's MoE (4 experts, top-2, token groups of 64): 128 tokens
    make two groups, and at the default capacity factor 1.25 some
    assignments drop; at 8.0 none do. The same tokens drop on both sides.
    A direction shared by every token biases the router toward the same
    experts, so the drops do not hang on chance."""
    ref_cfg, cfg = _cfgs("jamba-v0.1-52b")
    p = _np(ref_layers.moe_init(jax.random.PRNGKey(3), ref_cfg, jnp.float32))
    x = (rng.normal(size=(2, 64, cfg.d_model))
         + 2.0 * rng.normal(size=(cfg.d_model,))).astype(np.float32)
    outs = {}
    for cf in (1.25, 8.0):
        rc = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, capacity_factor=cf))
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        want, want_aux = ref_layers.moe_apply(p, rc, jnp.asarray(x))
        got, got_aux = layers.moe_apply(_torch(p), c, torch.from_numpy(x))
        _close(got, want, LAYER_ATOL)
        _close(got_aux, want_aux, LAYER_ATOL)
        outs[cf] = got
    assert float((outs[1.25] - outs[8.0]).abs().max()) > 1e-3   # drops happened


def test_moe_top_k_breaks_ties_toward_the_lower_index():
    scores = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = layers._top_k(scores, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores.numpy()), 2)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[0, 1], [1, 2]]
    _close(vals, want_v, 0)


def test_mamba_prefill_and_decode_match_reference(rng):
    ref_cfg, cfg = _cfgs("jamba-v0.1-52b")
    p = _np(ref_ssm.mamba_init(jax.random.PRNGKey(4), ref_cfg, jnp.float32))
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    want, want_c = ref_ssm.mamba_apply(p, ref_cfg, jnp.asarray(x), mode="prefill")
    got, got_c = ssm.mamba_apply(_torch(p), cfg, torch.from_numpy(x), mode="prefill")
    _close(got, want, LAYER_ATOL)
    for k in ("conv", "ssm"):
        _close(got_c[k], want_c[k], LAYER_ATOL)
    for t in range(2):
        x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        want, want_c = ref_ssm.mamba_apply(p, ref_cfg, jnp.asarray(x1), cache=want_c,
                                           mode="decode")
        got, got_c = ssm.mamba_apply(_torch(p), cfg, torch.from_numpy(x1), cache=got_c,
                                     mode="decode")
        _close(got, want, LAYER_ATOL)
        for k in ("conv", "ssm"):
            _close(got_c[k], want_c[k], LAYER_ATOL)


# ---------------------------------------------------------------------------
# the whole model, same params
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference model of ``name``, its fp32 params as numpy, and its
    jitted prefill (caches of S + EXTRA slots) and decode step."""
    arch, over = MODELS[name]
    ref_cfg, cfg = _cfgs(arch, **over)
    model = ref_tf.TransformerLM(ref_cfg)
    params = _np(model.init(jax.random.PRNGKey(0)))
    prefill = jax.jit(lambda p, b: model.prefill(p, b, cache_len=S + EXTRA))
    decode = jax.jit(model.decode_step)
    return cfg, params, prefill, decode


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _ref_greedy(name, params, tokens, n_tokens):
    """The reference's greedy serving loop; (B, n_tokens) ids, and the
    logits and caches after prefill and after each decode step."""
    _, _, prefill, decode = _reference(name)
    caches, logits = prefill(params, {"tokens": jnp.asarray(tokens)})
    steps = [(logits, caches)]
    tok = jnp.argmax(logits[:, -1], axis=-1)
    out = [tok]
    for t in range(n_tokens - 1):
        logits, caches = decode(params, {"tokens": tok[:, None], "pos_offset": S + t}, caches)
        steps.append((logits, caches))
        tok = jnp.argmax(logits[:, -1], axis=-1)
        out.append(tok)
    return np.stack([np.asarray(t) for t in out], axis=1), steps


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_and_decode_match_reference(name):
    """Prefill logits and every cache leaf (k, v, idx, conv, ssm), then each
    of 3 greedy decode steps, on the reference's own params."""
    cfg, ref_params, _, _ = _reference(name)
    model = tf.TransformerLM(cfg, device="cpu")
    params = params_from_numpy(ref_params, model, device="cpu")
    tokens = _tokens(cfg)
    ids, steps = _ref_greedy(name, ref_params, tokens, DECODE_STEPS + 1)
    caches, logits = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                   cache_len=S + EXTRA)
    for t, (want_logits, want_caches) in enumerate(steps):
        if t:
            batch = {"tokens": torch.from_numpy(ids[:, t - 1:t]), "pos_offset": S + t - 1}
            logits, caches = model.decode_step(params, batch, caches)
        _close(logits, want_logits, LOGITS_ATOL)
        want_leaves = jax.tree.leaves(want_caches)
        assert len(tree_leaves(caches)) == len(want_leaves)
        for path, got, want in zip(tree_paths(caches), tree_leaves(caches), want_leaves):
            assert tuple(got.shape) == want.shape, path
            _close(got, want, CACHE_ATOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_then_decode_equals_forward(name):
    """The reference's own invariant (tests/test_arch_smoke.py), inside the
    port: prefill of S - 1 tokens then one decode step gives the logits a
    forward over S tokens gives at the last position (no MoE drops)."""
    arch, over = MODELS[name]
    cfg = reduced(get_config(arch), **over)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = tf.TransformerLM(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.from_numpy(_tokens(cfg)[:, :12])
    hidden, _, _ = model.forward(params, {"tokens": tokens}, mode="train")
    full = (hidden[:, -1:] @ model._head(params)).float()
    caches, _ = model.prefill(params, {"tokens": tokens[:, :11]}, cache_len=12)
    logits, _ = model.decode_step(params, {"tokens": tokens[:, 11:], "pos_offset": 11}, caches)
    _close(logits, full, 3e-4)


def test_serve_main_samples_the_reference_greedy_ids(capsys):
    """``repro_torch.launch.serve`` on the CPU: its ids equal the reference's
    greedy decode on the port's own seed-0 params, carried across."""
    cfg = _reference("jamba8")[0]
    ids = serve.main(["--arch", "jamba-v0.1-52b", "--device", "cpu", "--batch", str(B),
                      "--prompt-len", str(S), "--tokens", str(DECODE_STEPS + 1)])
    assert "ms/token" in capsys.readouterr().out
    params = params_to_numpy(tf.TransformerLM(cfg, device="cpu").init(0))
    want, _ = _ref_greedy("jamba8", params, _tokens(cfg), DECODE_STEPS + 1)
    assert ids.shape == (B, DECODE_STEPS + 1)
    np.testing.assert_array_equal(ids, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_carries_an_lm_tree(dtype):
    """Keys, shapes and dtypes checked against the shapes the model states
    (no init); a JAX bf16 leaf crosses bit for bit."""
    cfg, ref_params, _, _ = _reference("jamba8")
    cfg = dataclasses.replace(cfg, param_dtype=dtype)
    model = tf.TransformerLM(cfg, device="cpu")
    want_dtypes = [leaf.dtype for leaf in tree_leaves(model.param_shapes())]
    tree = jax.tree.unflatten(
        jax.tree.structure(ref_params),
        [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)) if d == torch.bfloat16 else a
         for a, d in zip(jax.tree.leaves(ref_params), want_dtypes)])
    got = params_from_numpy(tree, model, device="cpu")
    for a, g in zip(jax.tree.leaves(tree), tree_leaves(got)):
        assert g.dtype == getattr(torch, a.dtype.name)
        if a.dtype.name == "bfloat16":
            assert np.array_equal(g.view(torch.int16).numpy(), a.view(np.int16))
        else:
            assert np.array_equal(g.numpy(), a)
    if dtype == "bfloat16":
        with pytest.raises(ValueError, match="dtype"):
            params_from_numpy(ref_params, model, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["final_norm"]["scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="final_norm/scale: shape"):
        params_from_numpy(bad, model, device="cpu")
