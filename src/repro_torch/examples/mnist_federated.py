"""Paper reproduction script: MNIST-style federated learning (Section 3).

    PYTHONPATH=src python -m repro_torch.examples.mnist_federated \
        --model 2nn --partition noniid --C 0.1 --E 5 --B 10 \
        --rounds 50 --target 0.90 [--device cpu]

Compares against FedSGD with ``--strategy fedsgd`` (which pins E=1,
B=inf). The CLI assembles a declarative ``ExperimentSpec`` (print it with
``--print-spec``, replay it with ``ExperimentSpec.from_json``) and builds
the engine through ``RoundEngine.from_spec``, on the synthetic MNIST
stand-in.
"""
from __future__ import annotations

import argparse

from repro_torch.core import (
    FedAvg,
    FedAvgConfig,
    FedAvgM,
    FedSGD,
    RoundEngine,
    identity_codec,
    make_eval_fn,
    wire_bytes,
)
from repro_torch.data import make_image_classification
from repro_torch.specs import CodecSpec, ExperimentSpec, ModelSpec, PartitionSpec


def build_spec(args) -> ExperimentSpec:
    B = None if args.B == "inf" else int(args.B)
    strategy = {
        "fedavg": FedAvg(),
        "fedsgd": FedSGD(),
        "fedavgm": FedAvgM(momentum=args.momentum),
    }[args.strategy]
    if args.strategy == "fedsgd":
        B, E = None, 1  # the preset's contract; FedSGD() enforces it
    else:
        E = args.E
    codec = {
        "none": None,
        "q8": CodecSpec("quantize", bits=8),
        "q4": CodecSpec("quantize", bits=4),
        "mask": CodecSpec("mask", keep_frac=0.1),
        "topk": CodecSpec("topk", keep_frac=0.05),
        "lowrank": CodecSpec("lowrank", rank=8),
    }[args.codec]
    return ExperimentSpec(
        name=f"mnist_{args.model}_{args.partition}_cli",
        model=ModelSpec("mnist_2nn" if args.model == "2nn" else "mnist_cnn"),
        partition=PartitionSpec(
            {"iid": "iid", "noniid": "pathological_noniid",
             "unbalanced": "unbalanced"}[args.partition],
            n_clients=args.clients, seed=args.seed,
        ),
        fedavg=FedAvgConfig(C=args.C, E=E, B=B, lr=args.lr, seed=args.seed),
        strategy=strategy,
        codec=codec,
        rounds=args.rounds,
        target_acc=args.target,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["2nn", "cnn"], default="2nn")
    ap.add_argument("--partition", choices=["iid", "noniid", "unbalanced"], default="iid")
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--C", type=float, default=0.1)
    ap.add_argument("--E", type=int, default=5)
    ap.add_argument("--B", default="10", help="minibatch size or 'inf'")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--target", type=float, default=0.90)
    ap.add_argument("--n-train", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--codec", choices=["none", "q8", "q4", "mask", "topk", "lowrank"],
                    default="none", help="client-upload compression")
    ap.add_argument("--strategy", choices=["fedavg", "fedsgd", "fedavgm"], default="fedavg",
                    help="server update rule; fedsgd pins E=1 B=inf")
    ap.add_argument("--momentum", type=float, default=0.9,
                    help="server momentum for --strategy fedavgm")
    ap.add_argument("--print-spec", action="store_true",
                    help="dump the assembled ExperimentSpec JSON and exit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = build_spec(args)
    if args.print_spec:
        print(spec.to_json(indent=2))
        return None

    train, test, _ = make_image_classification(
        args.n_train, args.n_train // 5, seed=5, difficulty=1.5
    )
    fed = spec.build_partition(labels=train.y)
    flatten = args.model == "2nn"
    clients = [
        (train.x[ix].reshape(len(ix), -1) if flatten else train.x[ix], train.y[ix])
        for ix in fed.client_indices
    ]
    # The model is built once: the eval fn and the engine share it.
    model = spec.build_model(device=args.device)
    params = model.init(spec.fedavg.seed)
    xt = test.x.reshape(len(test.x), -1) if flatten else test.x
    ev = make_eval_fn(model.apply, xt, test.y, device=args.device)
    tr = RoundEngine.from_spec(spec, clients, eval_fn=ev, loss_fn=model.loss,
                               init_params=params, device=args.device)
    hist = tr.run(args.rounds, eval_every=1, target_acc=args.target, verbose=True)
    r = hist.rounds_to_target(args.target)
    u = spec.fedavg.expected_updates_per_round(len(train.x), args.clients)
    print(f"\nu={u:.0f} updates/client/round; rounds to {args.target:.0%}: {r}")
    if tr.codec is not None:
        kb = wire_bytes(tr.codec, tr.params) / 1024
        dense_kb = wire_bytes(identity_codec(), tr.params) / 1024
        print(f"codec={tr.codec.name}: {kb:.1f} KB uploaded/client/round "
              f"(dense fp32: {dense_kb:.1f} KB)")
    if args.checkpoint_dir:
        # save records the strategy's state and identity and the cohort
        # stream, so the checkpoint resumes bit for bit, in either package.
        tr.save(args.checkpoint_dir)
        print("checkpoint saved to", args.checkpoint_dir)
    return hist


if __name__ == "__main__":
    main()
