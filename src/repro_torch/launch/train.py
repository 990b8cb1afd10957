"""Training entry point: FedAvg / local-SGD rounds of the LM substrate on one
device (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --device cpu \\
        --rounds 2 --local-steps 2 --global-batch 4 --seq 32

trains the arch's ``reduced()`` config (``--n-layers`` layers, 6 unless
given), as the reference's ``launch/train.py`` does; ``--full`` trains the
arch's own config instead (Gemma-2B, xLSTM-350M and SeamlessM4T-medium
whole on the card), and ``--full --n-layers L`` its own widths cut to the
first L layers of its plan (Jamba at L = 2 on one card; DeepSeek-V2-Lite at
L = 4, its leading dense layer and 3 MoE layers; Qwen2-VL-7B at L = 8). Without ``--arch``
it trains the reference's small demo LM. A FedAvg round is H local AdamW steps for each of
``--groups`` client groups, then their weighted average through
``fedavg_aggregate`` (see ``core/local_sgd.py``); ``--algo fedsgd`` takes
one AdamW step per batch instead. Weights come from ``--seed`` on the
device; tokens from ``make_word_corpus``, one shard per group. The audio
arch (SeamlessM4T) also takes ``enc_embeds``, (H, G, B, min(S, 4096), d)
normal frame embeddings in the compute dtype, drawn from the same numpy
generator after the tokens and labels: the train shape the reference's
``launch/steps.py`` gives it (``ENC_FRAMES = 4096``), since its own
``launch/train.py`` draws tokens only and cannot train that arch. The
vision arch (Qwen2-VL, its stub) takes, in place of the tokens, the batch
the reference's ``make_batch_specs`` lays out: ``embeds``, (H, G, B, S, d)
normal embeddings in the compute dtype, drawn from the same numpy
generator right after the round's start offsets into the corpus (whose
next tokens are the labels), and ``positions``, (H, G, B, S, 3) int32,
every component t, as ``serve.prompt_batch`` gives them.

The reference's mesh flags have no counterpart: the groups run one after
another on one device. ``--device`` defaults to ``cuda``: attention, the
cross-entropy and the group average then run the hand-written kernels.
``--dtype`` sets the model's parameter and compute dtype (by default the
config's own: float32 for a reduced config, bfloat16 for Gemma-2B's).
``--state-dtype`` sets the stored dtype of AdamW's moments (float32 by
default; bfloat16 halves them, the math staying fp32). ``--remat`` turns
on the config's ``remat`` (each layer under ``torch.utils.checkpoint``, as
SeamlessM4T's and Gemma-2B's configs set it; xLSTM's does not). The
reference's launcher has none of ``--full --n-layers``, ``--state-dtype``
and ``--remat``: each reaches an option the config or ``optim.adamw``
already has.
``--checkpoint-dir`` saves the final params (group 0's replica on the
FedAvg path) at ``step=--rounds`` with ``{"algo", "arch"}`` metadata, in
the reference's layout (``repro_torch.checkpoint``), as the reference does.
:func:`main` returns one record a round (FedSGD: a step) with its seconds,
tokens/s, loss, peak device memory and the kernels' launches in it;
:func:`run` returns those records and the final params.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

ENC_FRAMES = 4096   # the audio arch's encoder frames, as the reference's launch/steps.py


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="assigned arch id (reduced unless --full)")
    ap.add_argument("--full", action="store_true",
                    help="train the arch's own config, not its reduced() variant")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--algo", default="fedavg", choices=["fedavg", "fedsgd"])
    ap.add_argument("--outer", default="none", choices=["none", "nesterov"],
                    help="server optimizer on the pseudo-gradient (DiLoCo-style)")
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="layers: of the reduced config or the demo LM (6 unless given); "
                         "with --full, the arch's own widths cut to this depth")
    ap.add_argument("--groups", type=int, default=2, help="G: client groups")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="parameter and compute dtype (default: the config's own)")
    ap.add_argument("--state-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="stored dtype of AdamW's moments")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer's activations in the backward (cfg.remat)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def _counters():
    from repro_torch.kernels.ce_loss import ce_probs, fused_cross_entropy
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd

    return (fused_cross_entropy, ce_probs, flash_attention, ssm_scan, ssm_scan_bwd,
            fedavg_aggregate)


def _launches():
    return {f.__name__: f.launches for f in _counters()}


def main(argv=None):
    return run(argv)[0]


def train_config(args):
    """The model config the parsed flags name: the arch's reduced config,
    its own (``--full``, cut to ``--n-layers`` if given), or the demo LM;
    then ``--dtype`` and ``--remat``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig, reduced

    n_layers = 6 if args.n_layers is None else args.n_layers
    if args.arch and args.full:
        cfg = get_config(args.arch)
        if args.n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    elif args.arch:
        cfg = reduced(get_config(args.arch), n_layers=n_layers)
    else:
        cfg = ModelConfig(
            name="demo-lm", arch_type="dense", n_layers=n_layers,
            d_model=args.d_model, n_heads=4, n_kv_heads=2, head_dim=64,
            d_ff=4 * args.d_model, vocab_size=8192, scan_layers=True,
        )
    if args.dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.dtype, compute_dtype=args.dtype)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    return cfg


def run(argv=None):
    """Train as the flags say; returns (records, final params)."""
    args = _parser().parse_args(argv)

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core.local_sgd import (
        LocalSGDConfig,
        build_fedavg_round_step,
        build_fedsgd_train_step,
        init_group_states,
        replicate_for_groups,
        unreplicate,
    )
    from repro_torch.data.synthetic import make_word_corpus
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import adamw, momentum
    from repro_torch.utils.tree import tree_leaves

    cfg = train_config(args)
    model = TransformerLM(cfg, device=args.device)
    dev = model.device
    params = model.init(args.seed)
    G = args.groups
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    print(f"device {dev}, {G} client groups; model {cfg.name}: {n_params / 1e6:.1f}M params",
          flush=True)

    # data: synthetic word corpus, one shard per client group
    train, _, _ = make_word_corpus(
        n_authors=64, vocab_size=cfg.vocab_size, mean_words_per_author=20_000,
        seed=args.seed,
    )
    corpus = np.concatenate(train)
    H, S = args.local_steps, args.seq
    B_local = max(args.global_batch // G, 1)
    rng = np.random.default_rng(args.seed)

    def sample_round_batch():
        # (H, G, B_local, S) tokens + labels: each group reads its own shard;
        # the audio arch's (H, G, B_local, T, d) frames after them; the
        # vision arch's (H, G, B_local, S, d) embeddings in place of the
        # tokens, drawn after the same start offsets
        starts = rng.integers(0, len(corpus) - S - 1, (H, G, B_local))
        lab = np.stack([[[corpus[s + 1:s + S + 1] for s in row] for row in step]
                        for step in starts])
        batch = {"labels": torch.from_numpy(lab).to(dev)}
        if cfg.modality == "vision":
            embeds = rng.normal(size=(H, G, B_local, S, cfg.d_model))
            batch["embeds"] = torch.from_numpy(embeds.astype(np.float32)).to(
                dev, model.compute_dtype)
            pos = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None], (H, G, B_local, S, 3))
            batch["positions"] = torch.from_numpy(np.ascontiguousarray(pos)).to(dev)
            return batch
        tok = np.stack([[[corpus[s:s + S] for s in row] for row in step] for step in starts])
        batch["tokens"] = torch.from_numpy(tok).to(dev)
        if cfg.modality == "audio":
            frames = rng.normal(size=(H, G, B_local, min(S, ENC_FRAMES), cfg.d_model))
            batch["enc_embeds"] = torch.from_numpy(frames.astype(np.float32)).to(
                dev, model.compute_dtype)
        return batch

    def timed(fn, tokens):
        """Run ``fn`` and return its record: seconds to a synced device,
        tokens/s, the loss, peak device memory and the launches of each
        kernel counter inside it."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = _launches()
        t0 = time.perf_counter()
        loss = float(fn())                     # reading the loss syncs the device
        sec = time.perf_counter() - t0
        rec = {"seconds": sec, "tokens": tokens, "tokens_per_s": tokens / sec,
               "loss": loss,
               "peak_GiB": (torch.cuda.max_memory_allocated(dev) / 2**30
                            if dev.type == "cuda" else None),
               "launches": {k: v - before[k] for k, v in _launches().items()}}
        return rec

    inner = adamw(args.lr, state_dtype=getattr(torch, args.state_dtype))
    outer = momentum(0.7, beta=0.9, nesterov=True) if args.outer == "nesterov" else None
    records = []
    if args.algo == "fedavg":
        round_step = build_fedavg_round_step(
            model.train_loss, inner, LocalSGDConfig(G, H), outer_opt=outer)
        params_g = replicate_for_groups(params, G)
        del params
        opt_g = init_group_states(inner, params_g)
        outer_state = outer.init(unreplicate(params_g)) if outer else None
        weights = torch.ones(G)
        for r in range(args.rounds):
            batch = sample_round_batch()

            def one_round():
                nonlocal params_g, opt_g, outer_state
                params_g, opt_g, outer_state, m = round_step(
                    params_g, opt_g, outer_state, batch, weights)
                return m["loss"]

            rec = timed(one_round, H * G * B_local * S)
            rec["round"] = r + 1
            records.append(rec)
            _report(f"round {r + 1:3d}", rec)
        final = unreplicate(params_g)
    else:
        step_fn = build_fedsgd_train_step(model.train_loss, inner)
        opt_state = inner.init(params)
        for r in range(args.rounds * H):
            b = sample_round_batch()
            batch = {k: v[0].reshape(-1, *v.shape[3:]) for k, v in b.items()}

            def one_step():
                nonlocal params, opt_state
                params, opt_state, m = step_fn(params, opt_state, batch)
                return m["loss"]

            rec = timed(one_step, G * B_local * S)
            rec["step"] = r + 1
            records.append(rec)
            _report(f"step {r + 1:4d}", rec)
        final = params
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, final, step=args.rounds,
                        metadata={"algo": args.algo, "arch": cfg.name})
        print("checkpoint ->", args.checkpoint_dir, flush=True)
    return records, final


def _report(tag, rec):
    peak = "" if rec["peak_GiB"] is None else f"  peak {rec['peak_GiB']:.2f} GiB"
    launches = ", ".join(f"{k} {v}" for k, v in rec["launches"].items())
    print(f"{tag}  loss {rec['loss']:.4f}  {rec['seconds']:.3f} s  "
          f"{rec['tokens_per_s']:.0f} tokens/s{peak}  launches: {launches}", flush=True)


if __name__ == "__main__":
    main()
