"""The tolerances of MLA's prefill + decode == forward invariants, which
``chip_smoke.py`` phase 28 holds at full width on the card, derived from the
reference's own gaps on the CPU; and the capacity under which that phase's
invariants run MoE.

MLA's prefill runs the naive up-projection (in bf16 on the card, through
the flash kernel) and its decode the absorbed form in fp32, so the two
paths round at other places in every layer. The card holds one MLA layer in
bf16 (MLA_LAYER_RTOL) and the whole model in fp32 (MLA_FP32_INVARIANT_RTOL):
the reference's own gaps there, at the reduced width (and the whole
model's at the depth the card serves), must sit well inside them, and the
port's on the same params within them. The port's fp32 agreement with the
reference is held in ``tests/test_torch_mla.py``."""
import dataclasses
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
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(arch, **over):
    return ref_reduced(ref_get_config(arch), **over), reduced(get_config(arch), **over)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_one_layer_bf16_tolerance_covers_the_reference_gap(arch):
    """One MLA layer in bf16, unit-normal inputs, B = 1, S = 128: the last
    token of prefill (S - 1 tokens into a cache) + decode against the
    layer's output over all S tokens. The reference's gap on the reduced
    config, over four draws, is at most half of MLA_LAYER_RTOL (measured
    0.29-0.57%); the port's on the same params and inputs within it."""
    smoke = _smoke()
    rtol, (B, S) = smoke.MLA_LAYER_RTOL, smoke.MLA_INVARIANT_SHAPE
    ref_cfg, cfg = _cfgs(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    pos = np.arange(S)[None].astype(np.int32)
    for seed in range(4):
        p = ref_layers.mla_init(jax.random.PRNGKey(seed), ref_cfg, jnp.bfloat16)
        x = jnp.asarray(np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
                        .astype(np.float32)).astype(jnp.bfloat16)
        full, _, _ = ref_layers.mla_apply(p, ref_cfg, x, positions=jnp.asarray(pos), mode="train")
        cache = ref_layers.init_mla_cache(ref_cfg, B, S, jnp.bfloat16)
        _, cache, _ = ref_layers.mla_apply(p, ref_cfg, x[:, :-1], positions=jnp.asarray(pos[:, :-1]),
                                           cache=cache, mode="prefill")
        last, _, _ = ref_layers.mla_apply(p, ref_cfg, x[:, -1:], positions=jnp.asarray(pos[:, -1:]),
                                          cache=cache, mode="decode")
        want = np.asarray(full[:, -1:].astype(jnp.float32))
        assert 2 * _gap(np.asarray(last.astype(jnp.float32)), want) <= rtol
        pt = params_from_numpy(_np(p), _MlaLayer(cfg), device="cpu")
        xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
        post = torch.from_numpy(pos)
        full, _, _ = layers.mla_apply(pt, cfg, xt, positions=post, mode="prefill")
        cache = layers.init_mla_cache(cfg, B, S, torch.bfloat16, "cpu")
        _, cache, _ = layers.mla_apply(pt, cfg, xt[:, :-1], positions=post[:, :-1], cache=cache,
                                       mode="prefill")
        last, _, _ = layers.mla_apply(pt, cfg, xt[:, -1:], positions=post[:, -1:], cache=cache,
                                      mode="decode")
        assert _gap(last.float(), full[:, -1:].float()) <= rtol


class _MlaLayer:
    """The shapes ``convert.params_from_numpy`` checks one MLA layer's tree
    against."""

    def __init__(self, cfg):
        self.cfg = cfg

    def param_shapes(self):
        return layers.mla_init(None, self.cfg, getattr(torch, self.cfg.param_dtype), "meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_whole_model_tolerance_covers_the_reference_gap(arch):
    """The whole model in fp32 at the depth the card serves (V2-Lite's 27
    layers, V3's 4), B = 1, S = 128, MoE under ``chip_smoke.no_drop``: the
    reference's gap on the reduced width, over two seeds, is at most a tenth
    of MLA_FP32_INVARIANT_RTOL (measured 0.9-5.1e-6); the port's on the same
    params within it."""
    smoke = _smoke()
    rtol, (B, S) = smoke.MLA_FP32_INVARIANT_RTOL, smoke.MLA_INVARIANT_SHAPE
    depth = dict(smoke.MLA_VISION_SERVING)[arch] or get_config(arch).n_layers
    ref_cfg, cfg = (smoke.no_drop(c) for c in _cfgs(arch, n_layers=depth))
    ref_model, model = ref_tf.TransformerLM(ref_cfg), tf.TransformerLM(cfg, device="cpu")
    forward = jax.jit(lambda p, b: ref_model.forward(p, b, mode="train")[0])
    prefill = jax.jit(lambda p, b: ref_model.prefill(p, b, cache_len=S)[0])
    decode = jax.jit(ref_model.decode_step)
    for seed in range(2):
        ref_params = ref_model.init(jax.random.PRNGKey(seed))
        tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        hidden = forward(ref_params, {"tokens": jnp.asarray(tokens)})
        full = (hidden[:, -1:] @ ref_model._head(ref_params)).astype(jnp.float32)
        caches = prefill(ref_params, {"tokens": jnp.asarray(tokens[:, :-1])})
        logits, _ = decode(ref_params, {"tokens": jnp.asarray(tokens[:, -1:]), "pos_offset": S - 1},
                           caches)
        assert 10 * _gap(logits, full) <= rtol
        params = params_from_numpy(_np(ref_params), model, device="cpu")
        t = torch.from_numpy(tokens)
        hidden, _, _ = model.forward(params, {"tokens": t}, mode="train")
        full = (hidden[:, -1:] @ model._head(params)).float()
        caches, _ = model.prefill(params, {"tokens": t[:, :-1]}, cache_len=S)
        logits, _ = model.decode_step(params, {"tokens": t[:, -1:], "pos_offset": S - 1}, caches)
        assert _gap(logits, full) <= rtol


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b"])
def test_no_drop_capacity_holds_every_token_of_a_group(arch):
    """``chip_smoke.no_drop``: the capacity of a token group is the whole
    group, so no token drops even when every token of a group picks the same
    expert (at factor 8, V3's 256 experts top-8 held only a quarter of one);
    Jamba's stays the factor 8 it ran at."""
    cfg = _smoke().no_drop(get_config(arch))
    mo = cfg.moe
    for gs in (1, 2, 127, 128, 4096):
        assert int(np.ceil(gs * mo.topk / mo.n_experts * mo.capacity_factor)) >= gs
    if arch.startswith("jamba"):
        assert mo.capacity_factor == 8.0
