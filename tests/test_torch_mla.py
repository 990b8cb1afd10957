"""repro_torch's multi-head latent attention (DeepSeek V2/V3) held against
the reference on the same params, in fp32 on the CPU.

Reduced DeepSeek-V2-Lite (one ``wq``, softmax routing) and reduced
DeepSeek-V3 (the q-LoRA pair, sigmoid routing): ``mla_apply`` in train,
prefill and decode modes, its caches (``latent``, ``k_rope``, ``idx``)
and three decode steps; the whole ``TransformerLM`` forward, prefill and
three greedy decode steps; ``launch.serve.main``. The reference's params
come from its own ``init`` and cross through ``convert.params_from_numpy``.

Tolerance: 1e-5 everywhere (fp32 sums in other orders: the port forms
K_nope and V with one product against ``wkv_b`` where the reference takes
two einsums, and its prefill attention tiles by 128, the reference's by
64; measured at most 5.2e-6 on the reduced configs)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

ATOL = 1e-5
B, S, EXTRA = 2, 16, 4
DECODE_STEPS = 3
ARCHS = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(arch, **over):
    return ref_reduced(ref_get_config(arch), **over), reduced(get_config(arch), **over)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol)


def test_reduced_configs_take_both_query_forms():
    v2, v3 = (reduced(get_config(a)) for a in ARCHS)
    assert v2.mla.q_lora_rank == 0 and v2.moe.router_scoring == "softmax"
    assert v3.mla.q_lora_rank > 0 and v3.moe.router_scoring == "sigmoid"
    for cfg in (v2, v3):
        assert [s.mixer for s in tf.layer_plan(cfg)] == ["mla"] * cfg.n_layers


# ---------------------------------------------------------------------------
# the layer, same params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_mla_init_states_the_reference_tree(arch):
    ref_cfg, cfg = _cfgs(arch)
    want = _np(ref_layers.mla_init(jax.random.PRNGKey(1), ref_cfg, jnp.float32))
    got = layers.mla_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu", lead=(3,))
    assert tree_paths(got) == [tuple(getattr(k, "key", None) for k in path)
                               for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == (3,) + w.shape and g.dtype == torch.float32
    cache = layers.init_mla_cache(cfg, B, S, torch.float32, "cpu")
    ref_cache = ref_layers.init_mla_cache(ref_cfg, B, S, jnp.float32)
    assert sorted(cache) == sorted(ref_cache) == ["idx", "k_rope", "latent"]
    for k in cache:
        assert tuple(cache[k].shape) == ref_cache[k].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_train_mode_matches_reference(rng, arch):
    ref_cfg, cfg = _cfgs(arch)
    p = _np(ref_layers.mla_init(jax.random.PRNGKey(2), ref_cfg, jnp.float32))
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want, want_c, _ = ref_layers.mla_apply(p, ref_cfg, jnp.asarray(x),
                                           positions=jnp.asarray(pos), mode="train")
    got, got_c, _ = layers.mla_apply(_torch(p), cfg, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos), mode="train")
    assert want_c is None and got_c is None
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_prefill_caches_and_decode_steps_match_reference(rng, arch):
    """Prefill into caches of S + EXTRA slots (and with no cache), then three
    decode steps against them: each step's output and every cache leaf."""
    ref_cfg, cfg = _cfgs(arch)
    p = _np(ref_layers.mla_init(jax.random.PRNGKey(3), ref_cfg, jnp.float32))
    pt = _torch(p)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = (np.arange(S)[None, :] + np.zeros((B, 1), int)).astype(np.int32)
    want, want_c, _ = ref_layers.mla_apply(
        p, ref_cfg, jnp.asarray(x), positions=jnp.asarray(pos),
        cache=ref_layers.init_mla_cache(ref_cfg, B, S + EXTRA, jnp.float32), mode="prefill")
    got, got_c, _ = layers.mla_apply(
        pt, cfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
        cache=layers.init_mla_cache(cfg, B, S + EXTRA, torch.float32, "cpu"), mode="prefill")
    _close(got, want)
    bare, bare_c, _ = layers.mla_apply(pt, cfg, torch.from_numpy(x),
                                       positions=torch.from_numpy(pos), mode="prefill")
    _close(bare, got, 0)
    assert tuple(bare_c["latent"].shape) == (B, S, cfg.mla.kv_lora_rank)
    for t in range(DECODE_STEPS + 1):
        for k in ("latent", "k_rope", "idx"):
            assert tuple(got_c[k].shape) == want_c[k].shape
            _close(got_c[k], want_c[k])
        if t == DECODE_STEPS:
            break
        x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        pos1 = np.full((B, 1), S + t, np.int32)
        want, want_c, _ = ref_layers.mla_apply(p, ref_cfg, jnp.asarray(x1),
                                               positions=jnp.asarray(pos1), cache=want_c,
                                               mode="decode")
        kept = tree_map(lambda a: a.clone(), got_c)
        got, new_c, _ = layers.mla_apply(pt, cfg, torch.from_numpy(x1),
                                         positions=torch.from_numpy(pos1), cache=got_c,
                                         mode="decode")
        for a, b in zip(tree_leaves(got_c), tree_leaves(kept)):
            assert torch.equal(a, b)   # out of place: the caller's cache is unchanged
        got_c = new_c
        _close(got, want)


def test_mla_decode_refuses_more_than_one_token(rng):
    _, cfg = _cfgs(ARCHS[0])
    p = layers.mla_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    cache = layers.init_mla_cache(cfg, 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="one token"):
        layers.mla_apply(p, cfg, torch.zeros(1, 2, cfg.d_model),
                         positions=torch.zeros(1, 2, dtype=torch.int32), cache=cache,
                         mode="decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_prefill_attends_once_at_the_qk_head_dim(monkeypatch, arch):
    """Prefill calls ``ops.mha_flash`` once a layer on (B, S, H, nope + rope)
    q, k and v (V zero-padded), every head reading its own K; at the full
    width that is D = 192, which the tensor-core route takes in bf16."""
    _, cfg = _cfgs(arch)
    calls = []

    def spy(q, k, v, *, causal, window):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), causal))
        return fa.flash_attention_ref(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(layers, "mha_flash", spy)
    p = layers.mla_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    layers.mla_apply(p, cfg, torch.zeros(B, S, cfg.d_model),
                     positions=torch.zeros(B, S, dtype=torch.int32), mode="prefill")
    m = cfg.mla
    D = m.qk_nope_dim + m.qk_rope_dim
    assert calls == [((B, S, cfg.n_heads, D),) * 3 + (True,)]
    full = get_config(arch).mla
    D = full.qk_nope_dim + full.qk_rope_dim
    assert D == 192 and full.v_head_dim == 128
    q = torch.zeros((1, 8, get_config(arch).n_heads, D), dtype=torch.bfloat16)
    assert fa._route(q, q, q) == "mma"


# ---------------------------------------------------------------------------
# the whole model, same params
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference model of ``arch`` reduced, its fp32 params as numpy,
    its jitted prefill (caches of S + EXTRA slots), decode step and
    training forward."""
    ref_cfg, cfg = _cfgs(arch)
    model = ref_tf.TransformerLM(ref_cfg)
    params = _np(model.init(jax.random.PRNGKey(0)))
    prefill = jax.jit(lambda p, b: model.prefill(p, b, cache_len=S + EXTRA))
    forward = jax.jit(lambda p, b: model.forward(p, b, mode="train")[0])
    return cfg, params, prefill, jax.jit(model.decode_step), forward


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _ref_greedy(arch, params, tokens, n_tokens):
    _, _, prefill, decode, _ = _reference(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, ref_params, _, _, forward = _reference(arch)
    model = tf.TransformerLM(cfg, device="cpu")
    params = params_from_numpy(ref_params, model, device="cpu")
    tokens = _tokens(cfg)
    hidden, _, aux = model.forward(params, {"tokens": torch.from_numpy(tokens)}, mode="train")
    _close(hidden, forward(ref_params, {"tokens": jnp.asarray(tokens)}))
    assert float(aux) > 0   # the MoE layer's load-balance loss


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and every cache leaf (latent, k_rope, idx), then each
    of 3 greedy decode steps, on the reference's own params."""
    cfg, ref_params, _, _, _ = _reference(arch)
    model = tf.TransformerLM(cfg, device="cpu")
    params = params_from_numpy(ref_params, model, device="cpu")
    tokens = _tokens(cfg)
    ids, steps = _ref_greedy(arch, ref_params, tokens, DECODE_STEPS + 1)
    caches, logits = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                   cache_len=S + EXTRA)
    for t, (want_logits, want_caches) in enumerate(steps):
        if t:
            batch = {"tokens": torch.from_numpy(ids[:, t - 1:t]), "pos_offset": S + t - 1}
            logits, caches = model.decode_step(params, batch, caches)
        _close(logits, want_logits)
        want_leaves = jax.tree.leaves(want_caches)
        assert len(tree_leaves(caches)) == len(want_leaves)
        for path, got, want in zip(tree_paths(caches), tree_leaves(caches), want_leaves):
            assert tuple(got.shape) == want.shape, path
            _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_forward(arch):
    """The reference's invariant inside the port: prefill of S - 1 tokens
    then one decode step (the absorbed form) gives the logits a forward
    over S tokens (the naive up-projection) gives at the last position."""
    cfg = reduced(get_config(arch))
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
    """``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    --device cpu``: its ids equal the reference's greedy decode on the
    port's own seed-0 params, carried across."""
    arch = ARCHS[0]
    cfg = _reference(arch)[0]
    ids = serve.main(["--arch", arch, "--device", "cpu", "--batch", str(B),
                      "--prompt-len", str(S), "--tokens", str(DECODE_STEPS + 1)])
    assert "ms/token" in capsys.readouterr().out
    params = params_to_numpy(tf.TransformerLM(cfg, device="cpu").init(0))
    want, _ = _ref_greedy(arch, params, _tokens(cfg), DECODE_STEPS + 1)
    np.testing.assert_array_equal(ids, want)
