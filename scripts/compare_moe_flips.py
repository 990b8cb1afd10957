"""Whether the port flips DeepSeek-V2-Lite's MoE top-k experts between
prefill + decode and the forward more often than the reference, in bf16, at
full width cut in depth, on the CPU.

Both packages run the same params (the reference's ``init`` from
``--param-seed``, carried across by ``convert.params_from_numpy``) and the
same tokens. For each prompt seed, B = 1 prompt of S = ``--seq`` token ids:
the forward over S tokens against prefill of S - 1 and one decode step, at
the last position, as ``scripts/probe_moe_invariant.py`` reads the port on
the card. For each package and run: the gap (max |decode - forward| over max
|logit|), whether the argmax agrees, and at each MoE layer whether the last
token's top-k expert set differs between the two paths (a flip), beside the
forward's smallest top-k margin. At two MoE capacities: the config's 1.25,
where the forward's groups drop tokens, and E / k, where nothing drops, so
that only flips part the paths. The reference runs under ``jax.jit``; its
router rows come back through ordered ``jax.debug.callback``s. Needs JAX
and the port on one host (this is no part of the port):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/compare_moe_flips.py --n-layers 3 --seeds 1 2 3 4 --json out.json

``--reduced`` rehearses it on the reduced config (seconds). The last line
printed is one JSON object: a row a (package, capacity, seed), and the
flips summed by package and capacity.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from probe_moe_invariant import RouterSpy  # noqa: E402

ARCH = "deepseek-v2-lite-16b"


class RefRouterSpy:
    """Wraps the reference's ``transformer.moe_apply`` and records, at each
    MoE layer it runs, the last token's top-k expert set and its top-k margin
    (through an ordered ``jax.debug.callback``, so under ``jit`` and
    ``lax.scan`` the rows arrive in the order the layers ran)."""

    def __init__(self):
        from repro.models import transformer

        self.transformer = transformer
        self.orig = transformer.moe_apply
        self.rows = []
        transformer.moe_apply = self

    def _record(self, idx, vals, k):
        idx, vals = np.asarray(idx), np.asarray(vals)
        self.rows.append((sorted(idx[0, :k].tolist()), float(vals[0, k - 1] - vals[0, k])))

    def __call__(self, p, cfg, x, act="silu"):
        mo = cfg.moe
        logits = x.reshape(-1, x.shape[-1])[-1:].astype(jnp.float32) @ p["router"]
        scores = (jax.nn.sigmoid(logits) if mo.router_scoring == "sigmoid"
                  else jax.nn.softmax(logits, axis=-1))
        vals, idx = jax.lax.top_k(scores, mo.topk + 1)
        jax.debug.callback(lambda i, v: self._record(i, v, mo.topk), idx, vals, ordered=True)
        return self.orig(p, cfg, x, act)

    def take(self):
        jax.effects_barrier()
        rows, self.rows = self.rows, []
        return rows

    def close(self):
        self.transformer.moe_apply = self.orig


def ref_paths(model):
    """The reference's forward logits at the last position, and prefill of
    S - 1 + one decode step, each jitted once."""
    @jax.jit
    def forward(params, tokens):
        hidden, _, _ = model.forward(params, {"tokens": tokens}, mode="train")
        return (hidden[:, -1:] @ model._head(params)).astype(jnp.float32)

    @jax.jit
    def prefill_decode(params, tokens):
        S = tokens.shape[1]
        caches, _ = model.prefill(params, {"tokens": tokens[:, :-1]}, cache_len=S)
        logits, _ = model.decode_step(params, {"tokens": tokens[:, -1:], "pos_offset": S - 1},
                                      caches)
        return logits

    return forward, prefill_decode


def port_paths(model):
    def forward(params, tokens):
        hidden, _, _ = model.forward(params, {"tokens": tokens}, mode="train")
        return (hidden[:, -1:] @ model._head(params)).float()

    def prefill_decode(params, tokens):
        S = tokens.shape[1]
        caches, _ = model.prefill(params, {"tokens": tokens[:, :-1]}, cache_len=S)
        logits, _ = model.decode_step(params, {"tokens": tokens[:, -1:], "pos_offset": S - 1},
                                      caches)
        return logits.float()

    return forward, prefill_decode


def compare(forward, prefill_decode, params, tokens, spy, to_np):
    """(gap, argmax agrees, forward's router rows, decode's router rows)."""
    spy.take()
    full = to_np(forward(params, tokens))
    fwd = spy.take()
    dec_logits = to_np(prefill_decode(params, tokens))
    rows = spy.take()
    dec = rows[len(rows) - len(fwd):]          # the decode step's, after the prefill's
    gap = float(np.abs(dec_logits - full).max() / np.abs(full).max())
    return gap, bool((dec_logits.argmax(-1) == full.argmax(-1)).all()), fwd, dec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-layers", type=int, default=3,
                    help="the first L layers at full width: the dense layer and L - 1 MoE")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--param-seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=8, help="torch's CPU threads")
    ap.add_argument("--reduced", action="store_true", help="the reduced config, a rehearsal")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)

    from repro.configs import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models import transformer as ref_tf
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.transformer import TransformerLM

    torch.set_num_threads(args.threads)
    cut = dict(n_layers=args.n_layers)
    ref_cfg = dataclasses.replace(ref_get_config(ARCH), **cut)
    cfg = dataclasses.replace(get_config(ARCH), **cut)
    if args.reduced:
        bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
        ref_cfg, cfg = ref_reduced(ref_cfg, **cut, **bf16), reduced(cfg, **cut, **bf16)
    t0 = time.perf_counter()
    ref_params = ref_tf.TransformerLM(ref_cfg).init(jax.random.PRNGKey(args.param_seed))
    np_params = jax.tree.map(np.asarray, ref_params)
    params = params_from_numpy(np_params, TransformerLM(cfg, device="cpu"), device="cpu")
    del np_params
    n_params = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref_params))
    print(f"{ARCH} at d_model {cfg.d_model}, {cfg.n_layers} layers, {cfg.param_dtype}: "
          f"{n_params:,} params, the reference's from seed {args.param_seed}, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def with_capacity(c, cf):
        return dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=cf))

    # one spy a package for the whole run: the reference's jitted paths
    # call back into the spy they were traced with
    spies = {"reference": RefRouterSpy(), "port": RouterSpy()}
    rows = []
    for cf in (cfg.moe.capacity_factor, cfg.moe.n_experts / cfg.moe.topk):
        ref_fns = ref_paths(ref_tf.TransformerLM(with_capacity(ref_cfg, cf)))
        port_fns = port_paths(TransformerLM(with_capacity(cfg, cf), device="cpu"))
        for seed in args.seeds:
            tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, args.seq))
            tokens = tokens.astype(np.int32)
            for package, fns, p, tok, to_np in (
                    ("reference", ref_fns, ref_params, jnp.asarray(tokens),
                     lambda a: np.asarray(a, np.float32)),
                    ("port", port_fns, params, torch.from_numpy(tokens),
                     lambda a: a.detach().numpy())):
                t1 = time.perf_counter()
                with torch.no_grad():
                    gap, agree, fwd, dec = compare(*fns, p, tok, spies[package], to_np)
                flipped = [i for i, (a, b) in enumerate(zip(fwd, dec)) if a[0] != b[0]]
                row = {"package": package, "capacity_factor": cf, "seed": seed, "gap": gap,
                       "argmax_agree": agree, "moe_layers": len(fwd),
                       "flipped_layers": flipped,
                       "min_topk_margin": min(m for _, m in fwd),
                       "seconds": time.perf_counter() - t1}
                rows.append(row)
                print(f"  {package:9s} cf {cf:g} seed {seed}: gap {gap:.3%}, argmax agree "
                      f"{agree}; top-k sets differ at {len(flipped)} of {len(fwd)} MoE layers "
                      f"{flipped}; smallest top-k margin {row['min_topk_margin']:.2e} "
                      f"({row['seconds']:.1f} s)", flush=True)
    for spy in spies.values():
        spy.close()
    summary = {}
    for r in rows:
        key = f"{r['package']} cf {r['capacity_factor']:g}"
        s = summary.setdefault(key, {"flips": 0, "layer_runs": 0, "gaps": []})
        s["flips"] += len(r["flipped_layers"])
        s["layer_runs"] += r["moe_layers"]
        s["gaps"].append(r["gap"])
    for key, s in summary.items():
        print(f"{key}: {s['flips']} flips in {s['layer_runs']} (layer, prompt) pairs; gaps "
              + ", ".join(f"{g:.3%}" for g in s["gaps"]))
    out = {"arch": ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "seq": args.seq,
           "device": "cpu", "torch_threads": args.threads, "rows": rows, "summary": summary}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
