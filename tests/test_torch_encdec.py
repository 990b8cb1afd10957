"""repro_torch's encoder-decoder (SeamlessM4T: the audio stub, the encoder,
cross-attention) held against the reference on the same params, in fp32 on
the CPU.

``cross_attention_apply`` in train, prefill and decode at Sq != M (its
cross cache, no memory in decode); ``_encode``; the whole reduced seamless
(2 encoder + 2 decoder layers over 16 frames) forward, prefill and three
decode steps with the cross caches' K/V; decode without ``enc_embeds``;
``launch.serve.main``; the tolerance of ``chip_smoke.py`` phase 29's bf16
invariant against the reference's own gap; ``train_loss`` and every
gradient (the encoder's and cross-attention's through
``ops.FlashAttention``, non-causal) against ``jax.value_and_grad``.

Tolerance: 1e-5 of the largest reference magnitude (fp32 sums in other
orders; measured at most 1.0e-6 on the reduced config)."""
import functools
import importlib.util
from pathlib import Path

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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

ARCH = "seamless-m4t-medium"
RTOL = 1e-5
LOSS_TOL = 1e-5     # tests/test_torch_train.py's, as for Jamba
GRAD_RTOL = 1e-4
B, S, EXTRA, FRAMES = 2, 16, 4, 16
DECODE_STEPS = 3
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(**over):
    return ref_reduced(ref_get_config(ARCH), **over), reduced(get_config(ARCH), **over)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(got, want, rtol=RTOL):
    assert np.shape(got) == np.shape(want)
    assert _rel(got, want) <= rtol, _rel(got, want)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# cross-attention, same params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S_, M", [(16, 24), (9, 5), (1, 37)])
def test_cross_attention_train_prefill_and_decode_match_reference(rng, S_, M):
    """At Sq != M: train and prefill from the memory, the prefill's cross
    cache (the projected memory K/V), then three decode steps that read it
    and take no memory, each leaving the cache as it was."""
    ref_cfg, cfg = _cfgs()
    p = _np(ref_layers.cross_attention_init(jax.random.PRNGKey(4), ref_cfg, jnp.float32))
    assert sorted(p) == ["wk", "wo", "wq", "wv"]
    pt = _torch(p)
    x = rng.normal(size=(B, S_, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(B, M, cfg.d_model)).astype(np.float32)
    for mode in ("train", "prefill"):
        want, want_c, _ = ref_layers.cross_attention_apply(p, ref_cfg, jnp.asarray(x),
                                                           jnp.asarray(mem), mode=mode)
        got, got_c, _ = layers.cross_attention_apply(pt, cfg, torch.from_numpy(x),
                                                     torch.from_numpy(mem), mode=mode)
        _close(got, want)
    assert sorted(got_c) == ["k", "v"]
    for k in ("k", "v"):
        assert tuple(got_c[k].shape) == (B, M, cfg.n_kv_heads, cfg.resolved_head_dim)
        _close(got_c[k], want_c[k])
    for _ in range(DECODE_STEPS):
        x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        want, want_c, _ = ref_layers.cross_attention_apply(p, ref_cfg, jnp.asarray(x1), None,
                                                           cache=want_c, mode="decode")
        got, new_c, _ = layers.cross_attention_apply(pt, cfg, torch.from_numpy(x1), None,
                                                     cache=got_c, mode="decode")
        assert new_c is got_c
        _close(got, want)


def test_cross_attention_prefill_attends_through_flash_non_causal(monkeypatch):
    """Prefill calls ``ops.mha_flash`` once, causal=False, on (B, S, H, D)
    queries over (B, M, K, D) memory keys; decode calls no flash kernel. At
    the full width D = 64 in bf16, which the tensor-core route takes."""
    _, cfg = _cfgs()
    calls = []

    def spy(q, k, v, *, causal, window=0):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return fa.flash_attention_ref(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(layers, "mha_flash", spy)
    p = layers.cross_attention_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    _, cache, _ = layers.cross_attention_apply(p, cfg, torch.zeros(B, 7, cfg.d_model),
                                               torch.zeros(B, 11, cfg.d_model), mode="prefill")
    layers.cross_attention_apply(p, cfg, torch.zeros(B, 1, cfg.d_model), None, cache=cache,
                                 mode="decode")
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    assert calls == [((B, 7, H, D), (B, 11, K, D), False)]
    full = get_config(ARCH)
    q = torch.zeros((1, 8, full.n_heads, full.resolved_head_dim), dtype=torch.bfloat16)
    assert full.resolved_head_dim == 64 and fa._route(q, q, q) == "mma"


def test_cross_attention_refuses_decode_without_a_cache():
    _, cfg = _cfgs()
    p = layers.cross_attention_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    with pytest.raises(ValueError, match="one token against a cache"):
        layers.cross_attention_apply(p, cfg, torch.zeros(1, 1, cfg.d_model),
                                     torch.zeros(1, 3, cfg.d_model), mode="decode")


# ---------------------------------------------------------------------------
# the whole reduced seamless, same params
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference():
    ref_cfg, cfg = _cfgs()
    model = ref_tf.TransformerLM(ref_cfg)
    params = _np(model.init(jax.random.PRNGKey(0)))
    prefill = jax.jit(lambda p, b: model.prefill(p, b, cache_len=S + EXTRA))
    forward = jax.jit(lambda p, b: model.forward(p, b, mode="train")[0])
    encode = jax.jit(model._encode)
    return cfg, params, prefill, jax.jit(model.decode_step), forward, encode


def _prompt(cfg, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "enc_embeds": r.normal(size=(B, FRAMES, cfg.d_model)).astype(np.float32)}


def _model():
    cfg, ref_params = _reference()[:2]
    model = tf.TransformerLM(cfg, device="cpu")
    return model, params_from_numpy(ref_params, model, device="cpu")


def test_encoder_decoder_plan_and_params():
    cfg, ref_params = _reference()[:2]
    model = tf.TransformerLM(cfg, device="cpu")
    assert cfg.modality == "audio" and cfg.encoder_layers == 2
    assert [(s.mixer, s.ffn, s.cross) for s in model.plan] == [("attn", "mlp", True)] * 2
    assert [(s.mixer, s.ffn, s.cross) for s in model.enc_plan] == [("attn", "mlp", False)] * 2
    assert sorted(model.param_shapes()["encoder"]) == ["final_norm", "layers"]
    sub = model.param_shapes()["layers"][0]["sub0"]
    assert {"cross", "cross_norm"} <= set(sub) and "bq" not in sub["cross"]
    full = tf.TransformerLM(get_config(ARCH), device="meta")
    assert (len(full.plan), len(full.enc_plan)) == (12, 12)
    params = params_from_numpy(ref_params, model, device="cpu")   # the encoder subtree crosses
    assert tree_paths(params) == tree_paths(ref_params)


def test_encode_matches_reference():
    cfg, ref_params, _, _, _, encode = _reference()
    model, params = _model()
    b = _prompt(cfg)
    got = model._encode(params, {"enc_embeds": torch.from_numpy(b["enc_embeds"])})
    _close(got, encode(ref_params, {"enc_embeds": jnp.asarray(b["enc_embeds"])}))


def test_forward_prefill_and_decode_match_reference():
    """The training forward; prefill (the encoder, then the decoder into
    caches of S + EXTRA slots and cross caches of FRAMES): its logits and
    every cache leaf, the cross caches' K/V among them; then three greedy
    decode steps on tokens alone."""
    cfg, ref_params, prefill, decode, forward, _ = _reference()
    model, params = _model()
    b = _prompt(cfg)
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    hidden, _, _ = model.forward(params, bt, mode="train")
    _close(hidden, forward(ref_params, jax.tree.map(jnp.asarray, b)))
    want_c, want = prefill(ref_params, jax.tree.map(jnp.asarray, b))
    got_c, got = model.prefill(params, bt, cache_len=S + EXTRA)
    cross = got_c[0]["sub0"]["cross"]
    assert tuple(cross["k"].shape) == (2, B, FRAMES, cfg.n_kv_heads, cfg.resolved_head_dim)
    for t in range(DECODE_STEPS + 1):
        _close(got, want)
        want_leaves = jax.tree.leaves(want_c)
        assert len(tree_leaves(got_c)) == len(want_leaves)
        for path, g, w in zip(tree_paths(got_c), tree_leaves(got_c), want_leaves):
            assert tuple(g.shape) == w.shape, path
            _close(g, w)
        if t == DECODE_STEPS:
            break
        tok = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None].astype(np.int32)
        want, want_c = decode(ref_params, {"tokens": jnp.asarray(tok), "pos_offset": S + t},
                              want_c)
        got, got_c = model.decode_step(params, {"tokens": torch.from_numpy(tok),
                                                "pos_offset": S + t}, got_c)


def test_decode_runs_no_encoder_and_prefill_plus_decode_equals_forward(monkeypatch):
    """Prefill of S - 1 tokens (with the frames) and one decode step that
    takes no ``enc_embeds``, and calls neither ``_encode`` nor a flash
    kernel, give the forward's last logits."""
    cfg = _reference()[0]
    model, params = _model()
    b = {k: torch.from_numpy(v) for k, v in _prompt(cfg, 1).items()}
    hidden, _, _ = model.forward(params, b, mode="train")
    full = (hidden[:, -1:] @ model._head(params)).float()
    caches, _ = model.prefill(params, {"tokens": b["tokens"][:, :-1],
                                       "enc_embeds": b["enc_embeds"]}, cache_len=S)

    def refuse(*args, **kw):
        raise AssertionError("decode reached the encoder or a flash kernel")

    monkeypatch.setattr(model, "_encode", refuse)
    monkeypatch.setattr(layers, "mha_flash", refuse)
    monkeypatch.setattr(layers, "mha_flash_train", refuse)
    logits, _ = model.decode_step(params, {"tokens": b["tokens"][:, -1:], "pos_offset": S - 1},
                                  caches)
    _close(logits, full)


def test_prompt_batch_draws_the_frames_after_the_tokens():
    cfg = _reference()[0]
    batch = serve.prompt_batch(cfg, B, S, np.random.default_rng(0))
    r = np.random.default_rng(0)
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    np.testing.assert_array_equal(batch["enc_embeds"].numpy(),
                                  r.normal(size=(B, 16, cfg.d_model)).astype(np.float32))
    assert tuple(serve.prompt_batch(cfg, B, S, r, frames=5)["enc_embeds"].shape) == (B, 5,
                                                                                    cfg.d_model)


def test_serve_main_samples_the_reference_greedy_ids(capsys):
    """``python -m repro_torch.launch.serve --arch seamless-m4t-medium
    --device cpu`` prints the reference's modality note and samples the ids
    the reference's greedy loop gives on the port's seed-0 params (16
    frames, decode on tokens)."""
    cfg, _, prefill, decode, _, _ = _reference()
    ids = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", str(B),
                      "--prompt-len", str(S), "--tokens", str(DECODE_STEPS + 1)])
    out = capsys.readouterr().out
    assert f"note: {ARCH} uses a modality stub; serving its text decoder" in out
    params = params_to_numpy(tf.TransformerLM(cfg, device="cpu").init(0))
    prompt = serve.prompt_batch(cfg, B, S, np.random.default_rng(0))
    caches, logits = prefill(params, {k: jnp.asarray(v.numpy()) for k, v in prompt.items()})
    want = [np.asarray(jnp.argmax(logits[:, -1], axis=-1))]
    for t in range(DECODE_STEPS):
        step = {"tokens": jnp.asarray(want[-1][:, None].astype(np.int32)), "pos_offset": S + t}
        logits, caches = decode(params, step, caches)
        want.append(np.asarray(jnp.argmax(logits[:, -1], axis=-1)))
    np.testing.assert_array_equal(ids, np.stack(want, axis=1))


# ---------------------------------------------------------------------------
# phase 29's bf16 invariant, and training on the CPU
# ---------------------------------------------------------------------------

def test_bf16_invariant_tolerance_covers_the_reference_gap():
    """12 encoder + 12 decoder layers at the reduced width in bf16, at phase
    29's invariant shape over INVARIANT_FRAMES frames: the reference's own
    prefill + decode against forward gap, over two seeds, is at most half
    of ``INVARIANT_RTOL`` (measured 0 and 0.54%); the port's on the same
    params within it."""
    smoke = _smoke()
    rtol, (Bi, Si), F = smoke.INVARIANT_RTOL, smoke.INVARIANT_SHAPE, smoke.INVARIANT_FRAMES
    ref_cfg, cfg = _cfgs(n_layers=12, encoder_layers=12, param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    ref_model, model = ref_tf.TransformerLM(ref_cfg), tf.TransformerLM(cfg, device="cpu")
    forward = jax.jit(lambda p, b: ref_model.forward(p, b, mode="train")[0])
    prefill = jax.jit(lambda p, b: ref_model.prefill(p, b, cache_len=Si)[0])
    decode = jax.jit(ref_model.decode_step)
    for seed in range(2):
        ref_params = ref_model.init(jax.random.PRNGKey(seed))
        r = np.random.default_rng(seed)
        tokens = r.integers(0, cfg.vocab_size, (Bi, Si)).astype(np.int32)
        frames = r.normal(size=(Bi, F, cfg.d_model)).astype(np.float32)
        hidden = forward(ref_params, {"tokens": jnp.asarray(tokens),
                                      "enc_embeds": jnp.asarray(frames)})
        full = (hidden[:, -1:] @ ref_model._head(ref_params)).astype(jnp.float32)
        caches = prefill(ref_params, {"tokens": jnp.asarray(tokens[:, :-1]),
                                      "enc_embeds": jnp.asarray(frames)})
        logits, _ = decode(ref_params, {"tokens": jnp.asarray(tokens[:, -1:]),
                                        "pos_offset": Si - 1}, caches)
        assert 2 * _rel(logits, full) <= rtol
        params = params_from_numpy(_np(ref_params), model, device="cpu")
        t, fr = torch.from_numpy(tokens), torch.from_numpy(frames)
        hidden, _, _ = model.forward(params, {"tokens": t, "enc_embeds": fr}, mode="train")
        full = (hidden[:, -1:] @ model._head(params)).float()
        caches, _ = model.prefill(params, {"tokens": t[:, :-1], "enc_embeds": fr}, cache_len=Si)
        logits, _ = model.decode_step(params, {"tokens": t[:, -1:], "pos_offset": Si - 1}, caches)
        assert _rel(logits, full) <= rtol


@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_and_every_gradient_match_the_reference(monkeypatch, remat):
    """``train_loss`` of the reduced seamless and its gradient on every leaf
    (the encoder's included) against ``jax.value_and_grad`` of the
    reference's; with grad on, the encoder's attention and cross-attention
    go through ``ops.FlashAttention`` with causal=False (4 of its 6
    calls), never through the forward-only ``mha_flash``."""
    ref_cfg, cfg = _cfgs()
    ref_model = ref_tf.TransformerLM(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    r = np.random.default_rng(1)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32),
             "labels": r.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32),
             "enc_embeds": r.normal(size=(2, 11, cfg.d_model)).astype(np.float32)}
    value_and_grad = jax.jit(jax.value_and_grad(ref_model.train_loss, has_aux=True))
    (want, _), want_g = value_and_grad(ref_params, jax.tree.map(jnp.asarray, batch))
    calls = []
    real = ops.FlashAttention.apply

    def counted(q, k, v, causal, *rest):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal, *rest)

    def refuse(*args, **kw):
        raise AssertionError("a differentiable input reached the forward-only mha_flash")

    monkeypatch.setattr(ops.FlashAttention, "apply", counted)
    monkeypatch.setattr(layers, "mha_flash", refuse)
    model = tf.TransformerLM(reduced(get_config(ARCH), remat=remat), device="cpu")
    params = tree_map(lambda a: a.requires_grad_(),
                      params_from_numpy(_np(ref_params), model, device="cpu"))
    loss, _ = model.train_loss(params, tree_map(torch.from_numpy, batch))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert abs(loss.item() - float(want)) <= LOSS_TOL
    for path, g, w in zip(tree_paths(params), grads, jax.tree.leaves(_np(want_g))):
        assert tuple(g.shape) == w.shape, path
        rel = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-12)
        assert rel <= GRAD_RTOL, (path, rel)
    forward_calls = calls[:6]   # remat recomputes the decoder's three a layer in the backward
    assert sorted(forward_calls) == sorted([(11, 11, False)] * 2 + [(13, 13, True)] * 2
                                           + [(13, 11, False)] * 2)
