"""Serving: batched prefill + greedy decode (counterpart of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --device cpu

serves the arch's ``reduced()`` config, as the reference's ``main`` does:
weights from seed 0, a random prompt from ``numpy.random.default_rng(0)``
(:func:`prompt_batch`: token ids, or for the vision stub (Qwen2-VL)
normal (B, S, d) embeddings with (B, S, 3) M-RoPE positions; the audio
stub (SeamlessM4T) adds 16 frames of normal (B, 16, d) encoder embeddings),
then ``--tokens`` greedy tokens (one from prefill, the rest from
``decode_step``). ``--device`` defaults to ``cuda``: prefill attention
(MLA's at the qk head dim, the encoder's and cross-attention's
bidirectional) and every Mamba scan then run the hand-written kernels; the
xLSTM blocks are plain torch, as the reference's are plain XLA. :func:`generate` is the loop itself, for callers that bring their
own model and params.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg, B, S, rng, frames=16):
    """The reference ``main``'s prompt as host tensors: (B, S) int32 token
    ids from ``rng``; for the vision stub, (B, S, d) fp32 embeddings drawn
    from ``rng`` and (B, S, 3) int32 positions, every component t; for the
    audio stub, the token ids and then (B, ``frames``, d) fp32 encoder
    embeddings drawn from ``rng`` (``enc_embeds``)."""
    if cfg.modality == "vision":
        embeds = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S)[None, :, None], (B, S, 3)).astype(np.int32)
        return {"embeds": torch.from_numpy(embeds), "positions": torch.from_numpy(pos)}
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                        .astype(np.int32))}
    if cfg.modality == "audio":
        batch["enc_embeds"] = torch.from_numpy(
            rng.normal(size=(B, frames, cfg.d_model)).astype(np.float32))
    return batch


def generate(model, params, prompt, n_tokens):
    """Greedy decode of ``n_tokens`` after ``prompt`` on the model's device:
    a (B, S) int tensor of token ids, or a batch dict (``{"tokens"}``; for
    the vision stub ``{"embeds": (B, S, d), "positions": (B, S, 3)}``; for
    the audio stub ``{"tokens", "enc_embeds": (B, T, d)}``). One prefill into
    caches of S + n_tokens slots (and the cross caches of T frames), then
    ``n_tokens - 1`` decode steps, which take tokens only (the audio stub's
    memory lives in its cross caches); the vision stub's steps take zero
    embeddings at positions S + t, as the reference's ``main`` does (a stub
    has no token to embed).
    Returns the (B, n_tokens) sampled ids (on the device) and the host
    seconds of prefill and of the decode steps, each ending on a
    synchronised device."""
    dev = model.device
    batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    x = batch["tokens"] if "tokens" in batch else batch["embeds"]
    B, S = x.shape[0], x.shape[1]
    vision = "tokens" not in batch
    _sync(dev)
    t0 = time.perf_counter()
    caches, logits = model.prefill(params, batch, cache_len=S + n_tokens)
    tok = torch.argmax(logits[:, -1], dim=-1)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for t in range(n_tokens - 1):
        if vision:
            step = {"embeds": torch.zeros((B, 1, model.cfg.d_model), device=dev),
                    "positions": torch.full((B, 1, 3), S + t, dtype=torch.int32, device=dev)}
        else:
            step = {"tokens": tok[:, None], "pos_offset": S + t}
        logits, caches = model.decode_step(params, step, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)
        out.append(tok)
    _sync(dev)
    return torch.stack(out, dim=1), prefill_s, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--force-host-devices", type=int, default=8,
                    help="accepted for the reference's command line; the port "
                         "serves on one device and ignores it")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.transformer import TransformerLM

    cfg = reduced(get_config(args.arch))
    if cfg.modality is not None:
        print(f"note: {args.arch} uses a modality stub; serving its text decoder")
    model = TransformerLM(cfg, device=args.device)
    params = model.init(0)
    B, S = args.batch, args.prompt_len
    prompt = prompt_batch(cfg, B, S, np.random.default_rng(0))
    prompt = {k: v.to(model.device) for k, v in prompt.items()}
    ids, prefill_s, decode_s = generate(model, params, prompt, args.tokens)
    print(f"prefill {B}x{S}: {prefill_s * 1e3:.0f} ms")
    print(f"decode: {decode_s / max(args.tokens - 1, 1) * 1e3:.1f} ms/token ({B} seqs)")
    ids = ids.cpu().numpy()
    print("sampled ids[0]:", [int(t) for t in ids[0]])
    return ids


if __name__ == "__main__":
    main()
