"""Replay the plain MNIST CNN lane's first round (``chip_smoke.py`` phase 6)
many times, each from a fresh ``repro_torch`` engine, and count the rounds
whose train loss is not finite.

The round is the ``mnist_cnn_noniid`` spec's: 100 pathological non-IID
clients of synthetic MNIST (60,000 examples, seed 0), C = 0.1, E = 5,
B = 10, lr 0.1, params from seed 0. It imports ``repro_torch`` from
``PYTHONPATH``, so two checkouts are compared by running it under each:

    PYTHONPATH=src python scripts/probe_cnn_first_round.py --reps 20 --json a.json
    PYTHONPATH=../other/src python scripts/probe_cnn_first_round.py --reps 20 --json b.json

``--deterministic N`` replays the round N more times under
``torch.backends.cudnn.deterministic``. There every replay must give the
same loss and the same params bit for bit, so a copy that read a host
buffer before it was filled, or after it was refilled, shows as a spread.
The last line printed is one JSON object with the counts, the losses and
the params' digests.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def params_digest(params) -> str:
    from repro_torch.utils.tree import tree_leaves

    h = hashlib.sha1()
    for p in tree_leaves(params):
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def first_round(clients, cfg, device):
    """A fresh engine's first round: its loss and the params' digest."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.models import paper

    model = paper.mnist_cnn(device=device)
    eng = RoundEngine(model.loss, model.init(cfg.seed), clients, cfg, device=device)
    loss = float(eng.round()["loss"])
    return loss, params_digest(eng.params)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--deterministic", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-train", type=int, default=60_000)
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)

    import repro_torch
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.data.partition import partition_pathological_noniid
    from repro_torch.data.synthetic import make_image_classification

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads((ROOT / "specs" / "mnist_cnn_noniid.json").read_text())
    fed, part = spec["fedavg"], spec["partition"]
    train, _, _ = make_image_classification(args.n_train, 1_000, seed=0)
    split = partition_pathological_noniid(train.y, part["n_clients"],
                                          part["shards_per_client"], seed=part["seed"])
    clients = [(train.x[i], train.y[i]) for i in split.client_indices]
    cfg = FedAvgConfig(C=fed["C"], E=fed["E"], B=fed["B"], lr=fed["lr"],
                       lr_decay=fed["lr_decay"], seed=fed["seed"])
    print(f"repro_torch from {Path(repro_torch.__file__).parent}; card: {card_line()}")

    out = {"package": str(Path(repro_torch.__file__).parent), "card": card_line()}
    for mode, reps in (("default", args.reps), ("deterministic", args.deterministic)):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        losses, digests = [], []
        t0 = time.perf_counter()
        for _ in range(reps):
            loss, digest = first_round(clients, cfg, args.device)
            losses.append(loss)
            digests.append(digest)
        finite = [v for v in losses if math.isfinite(v)]
        res = {"reps": reps, "non_finite": reps - len(finite), "losses": losses,
               "distinct_digests": sorted(set(digests)),
               "seconds": time.perf_counter() - t0}
        if finite:
            res.update(min=min(finite), median=float(np.median(finite)), max=max(finite))
        out[mode] = res
        print(f"{mode}: {reps} first rounds, {res['non_finite']} non-finite, "
              f"{len(res['distinct_digests'])} distinct params, losses "
              + ", ".join(f"{v:.6f}" for v in losses) + f" ({res['seconds']:.1f} s)")
    line = json.dumps(out)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
