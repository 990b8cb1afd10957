"""Where xLSTM-350M's prefill + decode == forward gap comes from, in bf16, at
widths from the reduced config's up to the full one.

For each width d_model (xLSTM-350M's 24 blocks, pattern mmmsmmmm, 4 heads,
the published vocab of 50,304; weights drawn on the device from each seed)
and B = 2 prompts of S = 128 token ids from the same seed: the forward over
S tokens against prefill of S - 1 and one decode step, at the last
position, as ``chip_smoke.py`` phase 29 holds it. Each run prints the gap
(max |decode - forward| over max |logit|), whether the argmax agrees, and
the gap of the residual stream after every block (max |a - b| over max |b|
at the last position), so a trace shows where it grows. Three arithmetics:
bf16 as served; bf16 with cuBLAS's reduced-precision bf16 reductions off
(``allow_bf16_reduced_precision_reduction = False``); and fp32 (fresh fp32
weights from the same seed). In bf16 it also prints the bf16 forward's
rounding error (its last logits against an fp32 forward on the same
weights, widened), and, for the first sLSTM
block's input product ``x @ wx`` and its FFN's ``x @ wi``, how many bf16
results differ, and by how many ulps at most, between the product over S
tokens and over S - 1 (the first S - 1 rows) and between the product over
S tokens and the last token's alone (the decode step's B rows).

On a card each bf16 case runs a second time on the host's CPU, on the
same weights and tokens (copied from the device): the port's own gap where
no card arithmetic takes part. The first mLSTM and the first sLSTM block
at each width are held alone, as ``chip_smoke.py`` phase 29 holds them,
for each weight seed on the inputs of BLOCK_INPUTS:

    PYTHONPATH=src python scripts/probe_xlstm_invariant.py --widths 256 512 1024 --seeds 0 1 2 3 --json out.json

``--device cpu --widths 64 128 --seeds 0`` rehearses it. The last line
printed is one JSON object: a row a (width, arithmetic, seed) and a row a
(width, block, weight seed, input seed).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.utils.tree import tree_map

ARCH = "xlstm-350m"
B, S = 2, 128
BLOCK_INPUTS = (1, 2, 3)     # chip_smoke.XLSTM_BLOCK_SEEDS


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


class BlockSpy:
    """Wraps ``transformer._sublayer_apply`` and records each block's output
    residual stream at the last position."""

    def __init__(self):
        from repro_torch.models import transformer

        self.transformer = transformer
        self.orig = transformer._sublayer_apply
        self.rows = []
        transformer._sublayer_apply = self

    def __call__(self, p, spec, cfg, x, **kw):
        out = self.orig(p, spec, cfg, x, **kw)
        self.rows.append(out[0][:, -1].float())
        return out

    def take(self):
        rows, self.rows = self.rows, []
        return rows

    def close(self):
        self.transformer._sublayer_apply = self.orig


def gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def invariant(model, params, tokens, spy):
    """(gap, argmax agrees, the per-block gaps)."""
    hidden, _, _ = model.forward(params, {"tokens": tokens}, mode="train")
    full = (hidden[:, -1:] @ model._head(params)).float()
    blocks_fwd = spy.take()
    caches, _ = model.prefill(params, {"tokens": tokens[:, :-1]}, cache_len=S)
    spy.take()
    logits, _ = model.decode_step(params, {"tokens": tokens[:, -1:], "pos_offset": S - 1},
                                  caches)
    blocks_dec = spy.take()
    agree = bool((logits.argmax(-1) == full.argmax(-1)).all())
    return gap(logits, full), agree, [gap(a, b) for a, b in zip(blocks_dec, blocks_fwd)]


def last_logits(model, params, tokens):
    hidden, _, _ = model.forward(params, {"tokens": tokens}, mode="train")
    return (hidden[:, -1:] @ model._head(params)).float()


def rounding_error(model, params, tokens, spy):
    """The bf16 forward's last logits against an fp32 forward on the same
    weights (widened to fp32): the rounding error the bf16 model carries,
    over max |fp32 logit|."""
    cfg32 = dataclasses.replace(model.cfg, param_dtype="float32", compute_dtype="float32")
    model32 = type(model)(cfg32, device=model.device)
    bf16 = last_logits(model, params, tokens)
    fp32 = last_logits(model32, tree_map(lambda a: a.float(), params), tokens)
    spy.take()
    return gap(bf16, fp32)


def ulps_apart(a, b):
    """(share of differing elements, max difference in bf16 ulps of b)."""
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(2.0 ** -126))) - 7)
    return float((a != b).float().mean()), float(((a - b).abs() / ulp).max())


def row_count_bits(model, params, seed):
    """For the first sLSTM block's ``wx`` and its FFN's ``wi``, on unit-normal
    x: (share, max ulps) of ``(x @ w)[:, :S-1]`` against ``x[:, :S-1] @ w``
    (the forward's product against the shorter prefill's), and of
    ``(x @ w)[:, -1:]`` against ``x[:, -1:] @ w`` (the forward's last row
    against the decode step's product of B rows)."""
    seg = model.segments[0]
    j = [sp.mixer for sp in seg.specs].index("slstm")
    mixer = params["layers"][0][f"sub{j}"]["mixer"]
    g = torch.Generator(device=model.device).manual_seed(seed)
    x = torch.randn((B, S, model.cfg.d_model), generator=g, device=model.device).to(model.dtype)
    out = {}
    for name, w in (("wx", mixer["wx"][0]), ("ffn_wi", mixer["ffn"]["wi"][0])):
        whole = x @ w
        out[f"{name}_rows"] = ulps_apart(whole[:, :S - 1], x[:, :S - 1] @ w)
        out[f"{name}_last"] = ulps_apart(whole[:, -1:], x[:, -1:] @ w)
    return out


def block_gap(model, params, kind, seed):
    """The first ``kind`` block's last token of prefill (S - 1 tokens into a
    cache) + one decode step against its prefill over all S tokens, on
    unit-normal inputs from ``seed``: max |decode - prefill| over max |out|."""
    from repro_torch.models import xlstm

    seg = model.segments[0]
    j = [sp.mixer for sp in seg.specs].index(kind)
    p = tree_map(lambda a: a[0], params["layers"][0][f"sub{j}"]["mixer"])
    apply = getattr(xlstm, f"{kind}_apply")
    g = torch.Generator(device=model.device).manual_seed(seed)
    x = torch.randn((B, S, model.cfg.d_model), generator=g, device=model.device).to(model.dtype)
    full, _ = apply(p, model.cfg, x, mode="prefill")
    _, cache = apply(p, model.cfg, x[:, :-1], mode="prefill")
    last, _ = apply(p, model.cfg, x[:, -1:], cache=cache, mode="decode")
    return gap(last.float(), full[:, -1:].float())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", type=int, nargs="+", default=[256, 512, 1024])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    
    print(card_line())
    full = get_config(ARCH)
    spy = BlockSpy()
    rows, block_rows = [], []
    arithmetics = ("bf16", "bf16, no reduced-precision reductions", "fp32")
    try:
        for d in args.widths:
            for arith in arithmetics:
                dtype = "float32" if arith == "fp32" else "bfloat16"
                cfg = dataclasses.replace(full, d_model=d, param_dtype=dtype,
                                          compute_dtype=dtype)
                model = TransformerLM(cfg, device=args.device)
                reduced_ok = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
                    "no reduced" not in arith)
                try:
                    for seed in args.seeds:
                        params = model.init(seed)
                        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
                            0, cfg.vocab_size, (B, S)).astype(np.int32)).to(model.device)
                        t0 = time.perf_counter()
                        g, agree, blocks = invariant(model, params, tokens, spy)
                        rows.append({"d_model": d, "params": cfg.n_params(), "arith": arith,
                                     "seed": seed, "gap": g, "argmax_agree": agree,
                                     "block_gaps": blocks,
                                     "seconds": time.perf_counter() - t0})
                        print(f"d_model {d:5d} ({cfg.n_params():,} params) {arith:40s} seed {seed}: "
                              f"gap {g:.4%}, argmax agree {agree}; blocks "
                              + " ".join(f"{b:.1e}" for b in blocks), flush=True)
                        if arith == "bf16":
                            err = rounding_error(model, params, tokens, spy)
                            rows[-1].update(rounding_error=err)
                            print(f"    the bf16 forward against an fp32 forward on the same "
                                  f"weights: {err:.4%} of the largest logit; the gap is "
                                  f"{g / err:.3f} of it", flush=True)
                            bits = row_count_bits(model, params, seed)
                            rows[-1].update(product_bits=bits)
                            for name, what in (("rows", f"over {S} and {S - 1} tokens, the "
                                                        "shared rows"),
                                               ("last", f"the last token over {S} tokens "
                                                        f"and alone ({B} rows)")):
                                print(f"    the first sLSTM block's products, {what}: "
                                      + "; ".join(f"{w}: {bits[f'{w}_{name}'][0]:.2%} of "
                                                  f"the bf16 results differ, by at most "
                                                  f"{bits[f'{w}_{name}'][1]:.0f} ulps"
                                                  for w in ("wx", "ffn_wi")), flush=True)
                            if args.device != "cpu":
                                host = TransformerLM(cfg, device="cpu")
                                t0 = time.perf_counter()
                                hg, hagree, hblocks = invariant(
                                    host, tree_map(lambda a: a.cpu(), params), tokens.cpu(),
                                    spy)
                                rows[-1].update(host_gap=hg, host_argmax_agree=hagree,
                                                host_block_gaps=hblocks,
                                                host_seconds=time.perf_counter() - t0)
                                print(f"    on the host's CPU, same weights and tokens: gap "
                                      f"{hg:.4%}, argmax agree {hagree} "
                                      f"({time.perf_counter() - t0:.1f} s); blocks "
                                      + " ".join(f"{b:.1e}" for b in hblocks), flush=True)
                            for kind in ("mlstm", "slstm"):
                                for x_seed in BLOCK_INPUTS:
                                    bg = block_gap(model, params, kind, x_seed)
                                    block_rows.append({"d_model": d, "block": kind,
                                                       "seed": seed, "input_seed": x_seed,
                                                       "gap": bg})
                                    print(f"    one {kind} block, input seed {x_seed}: "
                                          f"gap {bg:.4%}", flush=True)
                        del params
                finally:
                    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced_ok
                del model
                if args.device != "cpu":
                    torch.cuda.empty_cache()
    finally:
        spy.close()
    for d in args.widths:
        for arith in arithmetics:
            gaps = [r["gap"] for r in rows if r["d_model"] == d and r["arith"] == arith]
            print(f"d_model {d:5d} {arith:40s}: gap max {max(gaps):.4%}, mean "
                  f"{float(np.mean(gaps)):.4%} over {len(gaps)} seeds")
        hosts = [r["host_gap"] for r in rows if r["d_model"] == d and "host_gap" in r]
        if hosts:
            print(f"d_model {d:5d} {'bf16 on the host CPU':40s}: gap max {max(hosts):.4%}, "
                  f"mean {float(np.mean(hosts)):.4%} over {len(hosts)} seeds")
        for kind in ("mlstm", "slstm"):
            gaps = [r["gap"] for r in block_rows if r["d_model"] == d and r["block"] == kind]
            if gaps:
                print(f"d_model {d:5d} one {kind} block, bf16: gap max {max(gaps):.4%}, "
                      f"mean {float(np.mean(gaps)):.4%} over {len(gaps)} (weight, input) seeds")
    out = {"card": card_line(), "rows": rows, "block_rows": block_rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
