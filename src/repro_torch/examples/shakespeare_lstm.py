"""Character-LSTM federated training on the role-partitioned corpus: the
paper's unbalanced, naturally non-IID setting (1146 speaking roles; here
the synthetic Markov corpus with the same structure, scaled by ``--roles``).

Starts from the ``shakespeare_lstm`` preset of the ``specs/`` registry and
adapts it with ``dataclasses.replace``: the data is already federated (one
client per role, partition kind "natural"), so only the model and
optimizer knobs vary. The trainer is the compatibility ``FederatedTrainer``.

    PYTHONPATH=src python -m repro_torch.examples.shakespeare_lstm \
        --roles 60 --rounds 20 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core import FedAvgConfig, FederatedTrainer, FedSGD, make_eval_fn
from repro_torch.data import make_char_corpus, windows_from_sequence
from repro_torch.specs import ModelSpec, PartitionSpec, get_spec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--roles", type=int, default=60)
    ap.add_argument("--unroll", type=int, default=20)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--E", type=int, default=5)
    ap.add_argument("--B", type=int, default=10)
    ap.add_argument("--C", type=float, default=0.1)
    ap.add_argument("--lr", type=float, default=10.0)
    ap.add_argument("--fedsgd", action="store_true", help="run the baseline instead")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    train, test, V = make_char_corpus(args.roles, mean_chars_per_role=1500, seed=0)
    clients = [windows_from_sequence(t, args.unroll) for t in train]
    sizes = np.array([len(c[0]) for c in clients])
    print(f"{len(clients)} role-clients; windows/client min={sizes.min()} "
          f"median={int(np.median(sizes))} max={sizes.max()} (unbalanced)")
    tx, ty = zip(*(windows_from_sequence(t, args.unroll) for t in test))
    x_test, y_test = np.concatenate(tx)[:2000], np.concatenate(ty)[:2000]

    base = get_spec("shakespeare_lstm")
    spec = dataclasses.replace(
        base,
        model=ModelSpec("char_lstm", kwargs={"vocab_size": V, "hidden": args.hidden}),
        partition=PartitionSpec("natural", n_clients=len(clients)),
        fedavg=(
            FedAvgConfig(C=args.C, E=1, B=None, lr=20.0)
            if args.fedsgd
            else FedAvgConfig(C=args.C, E=args.E, B=args.B, lr=args.lr)
        ),
        strategy=FedSGD() if args.fedsgd else base.strategy,
        rounds=args.rounds,
    )
    model = spec.build_model(device=args.device)  # once: eval fn and trainer share it
    params = model.init(spec.fedavg.seed)
    ev = make_eval_fn(model.apply, x_test, y_test, batch_size=256, device=args.device)
    tr = FederatedTrainer.from_spec(spec, clients, eval_fn=ev, loss_fn=model.loss,
                                    init_params=params, device=args.device)
    return tr.run(args.rounds, eval_every=1, verbose=True)


if __name__ == "__main__":
    main()
