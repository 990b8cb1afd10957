"""Run the CNN ring (``chip_smoke.py`` phases 11 and 26) for a few eager
rounds at each of several learning rates, and count the nodes whose params
are not finite after each round.

The cell is the ``mnist_2nn_noniid_ring`` spec's sections with the MNIST
CNN: 100 pathological non-IID nodes of synthetic MNIST (60,000 examples,
seed 0), a ring of degree 2, C = 1.0, E = 5, B = 10, params from seed 0. The
spec's lr is 0.1; ``--lrs`` lists the rates to run. Each rate runs once with
cuDNN's default algorithms and once under
``torch.backends.cudnn.deterministic``, each from a fresh engine:

    PYTHONPATH=src python scripts/probe_cnn_ring.py --lrs 0.1 0.05 --rounds 3 --json out.json

``--device cpu --n-train 3000 --rounds 1`` rehearses it on the CPU. The
last line printed is one JSON object: a row a (mode, lr, round) with the
loss, the consensus distance, the non-finite nodes and the seconds.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def non_finite_nodes(stacked) -> int:
    """Nodes with any non-finite leaf in the (n_nodes, ...) replica stack."""
    from repro_torch.utils.tree import tree_leaves

    bad = None
    for p in tree_leaves(stacked):
        row = ~torch.isfinite(p.reshape(p.shape[0], -1)).all(dim=1)
        bad = row if bad is None else bad | row
    return int(bad.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lrs", type=float, nargs="+", default=[0.1, 0.05])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-train", type=int, default=60_000)
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)

    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.core.topology import topology_from_json
    from repro_torch.data.partition import partition_pathological_noniid
    from repro_torch.data.synthetic import make_image_classification
    from repro_torch.models import paper

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads((ROOT / "specs" / "mnist_2nn_noniid_ring.json").read_text())
    fed, part = spec["fedavg"], spec["partition"]
    train, _, _ = make_image_classification(args.n_train, 1_000, seed=0)
    split = partition_pathological_noniid(train.y, part["n_clients"],
                                          part["shards_per_client"], seed=part["seed"])
    clients = [(train.x[i], train.y[i]) for i in split.client_indices]
    topo = topology_from_json({k: v for k, v in spec["topology"].items() if v is not None})
    out = {"card": card_line(), "rows": []}
    print(f"card: {out['card']}")
    for mode in ("default", "deterministic"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        for lr in args.lrs:
            cfg = FedAvgConfig(C=fed["C"], E=fed["E"], B=fed["B"], lr=lr,
                               lr_decay=fed["lr_decay"], seed=fed["seed"])
            model = paper.mnist_cnn(device=args.device)
            eng = RoundEngine(model.loss, model.init(fed["seed"]), clients, cfg,
                              topology=topo, device=args.device)
            for r in range(args.rounds):
                t0 = time.perf_counter()
                m = eng.round()
                loss, cons = float(m["loss"]), float(m["consensus"])
                row = {"mode": mode, "lr": lr, "round": r + 1, "loss": loss,
                       "consensus": cons, "non_finite_nodes": non_finite_nodes(eng.params),
                       "seconds": time.perf_counter() - t0}
                out["rows"].append(row)
                print(f"{mode:13s} lr {lr:g} round {r + 1}: loss {loss:.6f} consensus "
                      f"{cons:.6f}, {row['non_finite_nodes']} of {eng.num_clients} nodes "
                      f"non-finite ({row['seconds']:.2f} s)", flush=True)
                if not math.isfinite(loss):
                    break
            del eng
    torch.backends.cudnn.deterministic = False
    line = json.dumps(out)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
