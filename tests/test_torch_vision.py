"""repro_torch's vision stub (Qwen2-VL) held against the reference on the
same params, in fp32 on the CPU.

M-RoPE (``apply_rope`` with ``mrope_sections``) on (B, S, 3) positions whose
three components differ, within 1e-6 (the same fp32 angles and products);
the attention layer with QKV bias under M-RoPE; the whole reduced
``TransformerLM`` forward, prefill and three decode steps on stub
embeddings, within 1e-5 (fp32 sums in other orders through two layers;
measured at most 2.9e-6); ``launch.serve.main`` on the vision stub. The
reference's params cross through ``convert.params_from_numpy``."""
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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

ARCH = "qwen2-vl-7b"
ROPE_ATOL = 1e-6
ATOL = 1e-5
B, S, EXTRA = 2, 16, 4
DECODE_STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(**over):
    return ref_reduced(ref_get_config(ARCH), **over), reduced(get_config(ARCH), **over)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol)


def _positions(rng, B, S):
    """(B, S, 3) int32: the temporal component t, the height and width
    components a patch grid's rows and columns, so all three differ."""
    t = np.broadcast_to(np.arange(S)[None], (B, S))
    h = rng.integers(0, 64, (B, S))
    w = rng.integers(0, 64, (B, S))
    return np.stack([t, h, w], axis=-1).astype(np.int32)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections,D", [((16, 24, 24), 128), ((16, 8, 8), 64), ((2, 1, 1), 8)])
def test_mrope_matches_reference_on_distinct_components(rng, sections, D):
    """The published sections (16, 24, 24) at head_dim 128, the reduced
    config's (16, 8, 8) at 64, and a tiny one; positions up to 3,000."""
    x = rng.normal(size=(B, S, 4, D)).astype(np.float32)
    pos = _positions(rng, B, S) * np.array([200, 1, 1], np.int32)
    assert (pos[..., 0] != pos[..., 1]).any() and (pos[..., 1] != pos[..., 2]).any()
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0,
                            mrope_sections=sections)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0,
                                 mrope_sections=sections)
    _close(got, want, ROPE_ATOL)


def test_mrope_on_equal_components_is_plain_rope(rng):
    """For text tokens all three components are equal, which gives standard
    RoPE back (the reference's docstring)."""
    x = torch.from_numpy(rng.normal(size=(B, S, 2, 64)).astype(np.float32))
    pos = torch.from_numpy((np.arange(S)[None] + np.array([[0], [7]])).astype(np.int32))
    got = layers.apply_rope(x, pos[..., None].expand(B, S, 3), 1e4, mrope_sections=(16, 8, 8))
    _close(got, layers.apply_rope(x, pos, 1e4), 0)


def test_mrope_refuses_positions_and_sections_that_do_not_fit():
    x = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match=r"\(B, S, 3\) positions"):
        layers.apply_rope(x, torch.zeros(1, 4, dtype=torch.int32), 1e4, mrope_sections=(4, 2, 2))
    with pytest.raises(ValueError, match="do not sum"):
        layers.apply_rope(x, torch.zeros(1, 4, 3, dtype=torch.int32), 1e4,
                          mrope_sections=(4, 2, 1))


def test_attention_with_mrope_and_qkv_bias_matches_reference(rng):
    """Qwen2-VL's attention layer (GQA 4/2 at the reduced size, QKV bias,
    M-RoPE): prefill into a cache, then one decode step."""
    ref_cfg, cfg = _cfgs()
    p = _np(ref_layers.attention_init(jax.random.PRNGKey(2), ref_cfg, jnp.float32))
    p = {k: (v + rng.normal(size=v.shape).astype(np.float32) if k.startswith("b") else v)
         for k, v in p.items()}   # nonzero biases
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = _positions(rng, B, S)
    want, want_c, _ = ref_layers.attention_apply(
        p, ref_cfg, jnp.asarray(x), positions=jnp.asarray(pos),
        cache=ref_layers.init_attn_cache(ref_cfg, B, S + EXTRA, jnp.float32), mode="prefill")
    got, got_c, _ = layers.attention_apply(
        _torch(p), cfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
        cache=layers.init_attn_cache(cfg, B, S + EXTRA, torch.float32, "cpu"), mode="prefill")
    _close(got, want)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    pos1 = np.full((B, 1, 3), S, np.int32)
    want, want_c, _ = ref_layers.attention_apply(p, ref_cfg, jnp.asarray(x1),
                                                 positions=jnp.asarray(pos1), cache=want_c,
                                                 mode="decode")
    got, got_c, _ = layers.attention_apply(_torch(p), cfg, torch.from_numpy(x1),
                                           positions=torch.from_numpy(pos1), cache=got_c,
                                           mode="decode")
    _close(got, want)
    for k in ("k", "v", "idx"):
        _close(got_c[k], want_c[k])


# ---------------------------------------------------------------------------
# the whole model on stub embeddings, same params
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference():
    ref_cfg, cfg = _cfgs()
    model = ref_tf.TransformerLM(ref_cfg)
    params = _np(model.init(jax.random.PRNGKey(0)))
    prefill = jax.jit(lambda p, b: model.prefill(p, b, cache_len=S + EXTRA))
    forward = jax.jit(lambda p, b: model.forward(p, b, mode="train")[0])
    return cfg, params, prefill, jax.jit(model.decode_step), forward


def _prompt(cfg):
    rng = np.random.default_rng(0)
    return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32), _positions(rng, B, S)


def test_vision_stub_builds_and_takes_embeddings():
    cfg = _reference()[0]
    assert cfg.modality == "vision" and cfg.mrope_sections == (16, 8, 8)
    model = tf.TransformerLM(cfg, device="cpu")
    emb, pos = _prompt(cfg)
    batch = {"embeds": torch.from_numpy(emb), "positions": torch.from_numpy(pos)}
    assert model._positions(batch, S) is batch["positions"]
    assert tuple(model._positions({"embeds": batch["embeds"]}, S, 3).shape) == (B, S)


def test_forward_on_embeds_matches_reference():
    cfg, ref_params, _, _, forward = _reference()
    model = tf.TransformerLM(cfg, device="cpu")
    params = params_from_numpy(ref_params, model, device="cpu")
    emb, pos = _prompt(cfg)
    hidden, _, _ = model.forward(params, {"embeds": torch.from_numpy(emb),
                                          "positions": torch.from_numpy(pos)}, mode="train")
    _close(hidden, forward(ref_params, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)}))


def test_prefill_and_decode_on_embeds_match_reference(rng):
    """Prefill on (B, S, d) embeds with (B, S, 3) positions: its logits and
    every cache leaf; then 3 decode steps on fresh embeds at position S + t,
    as the reference's serving loop feeds the stub."""
    cfg, ref_params, prefill, decode, _ = _reference()
    model = tf.TransformerLM(cfg, device="cpu")
    params = params_from_numpy(ref_params, model, device="cpu")
    emb, pos = _prompt(cfg)
    want_c, want = prefill(ref_params, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)})
    got_c, got = model.prefill(params, {"embeds": torch.from_numpy(emb),
                                        "positions": torch.from_numpy(pos)}, cache_len=S + EXTRA)
    for t in range(DECODE_STEPS + 1):
        _close(got, want)
        want_leaves = jax.tree.leaves(want_c)
        assert len(tree_leaves(got_c)) == len(want_leaves)
        for path, g, w in zip(tree_paths(got_c), tree_leaves(got_c), want_leaves):
            assert tuple(g.shape) == w.shape, path
            _close(g, w)
        if t == DECODE_STEPS:
            break
        e = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        p1 = np.full((B, 1, 3), S + t, np.int32)
        want, want_c = decode(ref_params, {"embeds": jnp.asarray(e), "positions": jnp.asarray(p1)},
                              want_c)
        got, got_c = model.decode_step(params, {"embeds": torch.from_numpy(e),
                                                "positions": torch.from_numpy(p1)}, got_c)


def test_serve_main_samples_the_reference_greedy_ids(capsys):
    """``python -m repro_torch.launch.serve --arch qwen2-vl-7b --device cpu``
    serves the stub as the reference's ``main`` does (normal embeds, 3-D
    positions, zero embeds at S + t while decoding): its ids equal that loop
    run by the reference on the port's seed-0 params, carried across."""
    cfg, _, prefill, decode, _ = _reference()
    ids = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", str(B),
                      "--prompt-len", str(S), "--tokens", str(DECODE_STEPS + 1)])
    out = capsys.readouterr().out
    assert "modality stub" in out and "ms/token" in out
    params = params_to_numpy(tf.TransformerLM(cfg, device="cpu").init(0))
    prompt = serve.prompt_batch(cfg, B, S, np.random.default_rng(0))
    caches, logits = prefill(params, {k: jnp.asarray(v.numpy()) for k, v in prompt.items()})
    want = [np.asarray(jnp.argmax(logits[:, -1], axis=-1))]
    for t in range(DECODE_STEPS):
        step = {"embeds": jnp.zeros((B, 1, cfg.d_model), jnp.float32),
                "positions": jnp.full((B, 1, 3), S + t, jnp.int32)}
        logits, caches = decode(params, step, caches)
        want.append(np.asarray(jnp.argmax(logits[:, -1], axis=-1)))
    np.testing.assert_array_equal(ids, np.stack(want, axis=1))
    assert (prompt["positions"][..., 0] == torch.arange(S)).all()
