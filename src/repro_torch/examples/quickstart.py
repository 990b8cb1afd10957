"""Quickstart: FederatedAveraging from a declarative paper preset.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Experiments are values: pick a preset from the ``specs/`` registry, adapt
it with ``dataclasses.replace``, and hand it to ``RoundEngine.from_spec``.
The spec JSON-round-trips (``spec.to_json()``), so the exact run is
shareable as a file; see ``specs/README.md`` for the grid.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.core import RoundEngine, make_eval_fn
from repro_torch.data import make_image_classification
from repro_torch.kernels.fedavg_agg import fedavg_aggregate
from repro_torch.specs import PartitionSpec, get_spec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--target", type=float, default=0.80)
    args = ap.parse_args(argv)

    # 1. The paper's non-IID MNIST 2NN cell at quickstart size: 50 clients
    #    of ~2 classes each (pathological partition), C = 20% a round.
    base = get_spec("mnist_2nn_noniid")
    spec = dataclasses.replace(
        base,
        partition=PartitionSpec("pathological_noniid", n_clients=50, shards_per_client=2),
        fedavg=dataclasses.replace(base.fedavg, C=0.2, lr=0.05),
    )

    # 2. A federated dataset: the synthetic MNIST stand-in, split by the
    #    spec's own partition description.
    train, test, _ = make_image_classification(5000, 1000, seed=0, difficulty=1.5)
    fed = spec.build_partition(labels=train.y)
    clients = [(train.x[ix].reshape(len(ix), -1), train.y[ix]) for ix in fed.client_indices]

    # 3. Run rounds until the target accuracy. The spec names the model (the
    #    199,210-param 2NN); it is built once, for the eval fn and the
    #    engine, and from_spec packs all 50 clients onto the device once.
    model = spec.build_model(device=args.device)
    params = model.init(spec.fedavg.seed)
    ev = make_eval_fn(model.apply, test.x.reshape(len(test.x), -1), test.y,
                      device=args.device)
    engine = RoundEngine.from_spec(spec, clients, eval_fn=ev, loss_fn=model.loss,
                                   init_params=params, device=args.device)
    history = engine.run(args.rounds, eval_every=1, target_acc=args.target, verbose=True)
    print(f"rounds to {args.target:.0%}:", history.rounds_to_target(args.target))
    print("fedavg_aggregate launches:", fedavg_aggregate.launches)
    return history


if __name__ == "__main__":
    main()
