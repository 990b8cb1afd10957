"""Where the MoE archs' prefill + decode == forward gap comes from, in bf16 at
full width: capacity drops, and top-k experts that flip between the paths.

For each arch (DeepSeek-V2-Lite whole, DeepSeek-V3 at full width cut to 4
layers, as ``chip_smoke.py`` phase 28 serves them; weights from seed 0) and
each prompt seed, B = 1 prompt of S = 128 token ids: the forward over S
tokens against prefill of S - 1 and one decode step, at the last position,
at two MoE capacities: factor 8, and E / k, where a token group's capacity
is the whole group and nothing drops. For each run: the gap (max |decode -
forward| over max |logit|), whether the argmax agrees, and at each MoE
layer whether the last token's top-k expert set differs between the two
paths, with the forward's smallest top-k margin (the k-th score less the
(k+1)-th) over the MoE layers. V3 also at its 3 dense layers alone (the
same weights), where no router runs:

    PYTHONPATH=src python scripts/probe_moe_invariant.py --seeds 1 2 3 4 --json out.json

``--device cpu --reduced`` rehearses it on the reduced configs. The last
line printed is one JSON object: a row an (arch, capacity, seed).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

ARCHS = (("deepseek-v2-lite-16b", 0), ("deepseek-v3-671b", 4))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def with_capacity(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


class RouterSpy:
    """Wraps ``transformer.moe_apply`` and records, at each MoE layer, the
    last token's top-k expert set and its top-k margin."""

    def __init__(self):
        from repro_torch.models import layers
        from repro_torch.models import transformer

        self.transformer, self.layers = transformer, layers
        self.orig = transformer.moe_apply
        self.rows = []
        transformer.moe_apply = self

    def __call__(self, p, cfg, x, act="silu"):
        mo = cfg.moe
        logits = x.reshape(-1, x.shape[-1])[-1:].float() @ p["router"]
        scores = torch.sigmoid(logits) if mo.router_scoring == "sigmoid" else logits.softmax(-1)
        vals, idx = self.layers._top_k(scores, mo.topk + 1)
        self.rows.append((sorted(idx[0, :mo.topk].tolist()),
                          float(vals[0, mo.topk - 1] - vals[0, mo.topk])))
        return self.orig(p, cfg, x, act)

    def take(self):
        rows, self.rows = self.rows, []
        return rows

    def close(self):
        self.transformer.moe_apply = self.orig


def invariant(model, params, tokens, spy):
    """(gap, argmax agrees, forward's router rows, decode's router rows)."""
    S = tokens.shape[1]
    spy.take()
    hidden, _, _ = model.forward(params, {"tokens": tokens}, mode="train")
    full = (hidden[:, -1:] @ model._head(params)).float()
    fwd = spy.take()
    caches, _ = model.prefill(params, {"tokens": tokens[:, :-1]}, cache_len=S)
    spy.take()
    logits, _ = model.decode_step(params, {"tokens": tokens[:, -1:], "pos_offset": S - 1},
                                  caches)
    dec = spy.take()
    gap = float((logits - full).abs().max() / full.abs().max())
    return gap, bool((logits.argmax(-1) == full.argmax(-1)).all()), fwd, dec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs (2 layers, narrow), for a rehearsal")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.transformer import TransformerLM

    print(card_line() if args.device == "cuda" else f"device {args.device}")
    spy = RouterSpy()
    rows = []
    for arch, n_layers in ARCHS:
        cfg = get_config(arch)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        if args.reduced:
            cfg = reduced(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
        t0 = time.perf_counter()
        params = TransformerLM(cfg, device=args.device).init(0)
        for cf in (8.0, cfg.moe.n_experts / cfg.moe.topk):
            model = TransformerLM(with_capacity(cfg, cf), device=args.device)
            for seed in args.seeds:
                rng = np.random.default_rng(seed)
                tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, args.seq))
                                          .astype(np.int32)).to(args.device)
                gap, agree, fwd, dec = invariant(model, params, tokens, spy)
                flipped = [i for i, (a, b) in enumerate(zip(fwd, dec)) if a[0] != b[0]]
                row = {"arch": arch, "layers": cfg.n_layers, "capacity_factor": cf,
                       "seed": seed, "gap": gap, "argmax_agree": agree,
                       "moe_layers": len(fwd), "flipped_layers": flipped,
                       "min_topk_margin": min(m for _, m in fwd)}
                if arch == "deepseek-v3-671b" and not args.reduced:
                    dense = TransformerLM(dataclasses.replace(cfg, n_layers=3),
                                          device=args.device)
                    cut = {**params, "layers": params["layers"][:1]}   # the dense segment
                    row["gap_3_dense_layers"] = invariant(dense, cut, tokens, spy)[0]
                rows.append(row)
                print(f"  {arch} ({cfg.n_layers} layers) cf {cf:g} seed {seed}: gap "
                      f"{gap:.3%}, argmax agree {agree}; top-k sets differ at "
                      f"{len(flipped)} of {len(fwd)} MoE layers {flipped}; smallest "
                      f"top-k margin {row['min_topk_margin']:.2e}"
                      + (f"; 3 dense layers alone {row['gap_3_dense_layers']:.3%}"
                         if "gap_3_dense_layers" in row else ""), flush=True)
        print(f"  {arch}: {time.perf_counter() - t0:.1f} s")
        del params
        if args.device == "cuda":
            torch.cuda.empty_cache()
    spy.close()
    out = {"card": card_line() if args.device == "cuda" else None, "rows": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
