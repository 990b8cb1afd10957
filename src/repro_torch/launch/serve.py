"""Serving: batched prefill + greedy decode (counterpart of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --device cpu

serves the arch's ``reduced()`` config, as the reference's ``main`` does:
weights from seed 0, a random prompt from ``numpy.random.default_rng(0)``,
then ``--tokens`` greedy tokens (one from prefill, the rest from
``decode_step``). ``--device`` defaults to ``cuda``: prefill attention and
every Mamba scan then run the hand-written kernels. :func:`generate` is the
loop itself, for callers that bring their own model and params.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, tokens, n_tokens):
    """Greedy decode of ``n_tokens`` after the (B, S) int prompt ``tokens``
    on the model's device: one prefill into caches of S + n_tokens slots,
    then ``n_tokens - 1`` decode steps. Returns the (B, n_tokens) sampled
    ids (on the device) and the host seconds of prefill and of the decode
    steps, each ending on a synchronised device."""
    dev = model.device
    B, S = tokens.shape
    _sync(dev)
    t0 = time.perf_counter()
    caches, logits = model.prefill(params, {"tokens": tokens}, cache_len=S + n_tokens)
    tok = torch.argmax(logits[:, -1], dim=-1)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for t in range(n_tokens - 1):
        logits, caches = model.decode_step(
            params, {"tokens": tok[:, None], "pos_offset": S + t}, caches)
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
    model = TransformerLM(cfg, device=args.device)
    params = model.init(0)
    rng = np.random.default_rng(0)
    B, S = args.batch, args.prompt_len
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    ids, prefill_s, decode_s = generate(model, params, tokens.to(model.device), args.tokens)
    print(f"prefill {B}x{S}: {prefill_s * 1e3:.0f} ms")
    print(f"decode: {decode_s / max(args.tokens - 1, 1) * 1e3:.1f} ms/token ({B} seqs)")
    ids = ids.cpu().numpy()
    print("sampled ids[0]:", [int(t) for t in ids[0]])
    return ids


if __name__ == "__main__":
    main()
