"""The ``specs/`` registry: the paper presets as ExperimentSpec values
(counterpart of ``repro/specs/presets.py``; ``specs/*.json`` are their wire
form, and the tests hold both packages' registries equal to the files).

Hyper-parameters follow the paper (C=0.1, E=5, B=10 for MNIST FedAvg;
E=1, B=inf for FedSGD; lr 1.47 for the character LSTM). ``rounds`` /
``target_acc`` are CI-scale defaults for the synthetic stand-in datasets.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.fedavg import FedAvgConfig
from repro_torch.core.latency import LatencyModel
from repro_torch.core.strategies import FedAsync, FedAvgM, FedSGD
from repro_torch.data.synthetic import CHAR_VOCAB_SIZE
from repro_torch.specs.spec import (
    AsyncSpec,
    CodecSpec,
    ExecutionSpec,
    ExperimentSpec,
    ModelSpec,
    PartitionSpec,
    TopologySpec,
)

_MNIST_FEDAVG = FedAvgConfig(C=0.1, E=5, B=10, lr=0.1, seed=0)
_MNIST_FEDSGD = FedAvgConfig(C=0.1, E=1, B=None, lr=0.5, seed=0)


def _mnist(name: str, model: str, partition: str, **kw) -> ExperimentSpec:
    return ExperimentSpec(
        name=name,
        model=ModelSpec(model),
        partition=PartitionSpec(partition, n_clients=100),
        fedavg=kw.pop("fedavg", _MNIST_FEDAVG),
        rounds=kw.pop("rounds", 100),
        target_acc=kw.pop("target_acc", 0.9),
        **kw,
    )


PAPER_SPECS: Dict[str, ExperimentSpec] = {
    s.name: s
    for s in [
        # -- the paper's main MNIST grid (Table 1 / Figure 2) -------------
        _mnist("mnist_2nn_iid", "mnist_2nn", "iid"),
        _mnist("mnist_2nn_noniid", "mnist_2nn", "pathological_noniid"),
        _mnist("mnist_cnn_iid", "mnist_cnn", "iid"),
        _mnist("mnist_cnn_noniid", "mnist_cnn", "pathological_noniid"),
        # -- the FedSGD baseline, as a named strategy preset ---------------
        _mnist(
            "mnist_2nn_fedsgd", "mnist_2nn", "iid",
            fedavg=_MNIST_FEDSGD, strategy=FedSGD(), rounds=300,
        ),
        # -- the Shakespeare character LSTM (Section 3, LSTM column) ------
        ExperimentSpec(
            name="shakespeare_lstm",
            model=ModelSpec(
                "char_lstm",
                kwargs={"vocab_size": CHAR_VOCAB_SIZE, "hidden": 128},
            ),
            # One client per speaking role: the data arrives federated.
            partition=PartitionSpec("natural", n_clients=1146),
            fedavg=FedAvgConfig(C=0.1, E=5, B=10, lr=1.47, seed=0),
            rounds=40,
            target_acc=None,
        ),
        # -- post-paper scenario presets -----------------------------------
        _mnist(
            "mnist_2nn_noniid_q8", "mnist_2nn", "pathological_noniid",
            codec=CodecSpec("quantize", bits=8),
        ),
        # Sparse top-k uploads through the scatter-accumulate kernel
        # (keep_frac 0.05 ~ 160x fewer upload bytes than dense fp32).
        _mnist(
            "mnist_2nn_noniid_topk", "mnist_2nn", "pathological_noniid",
            codec=CodecSpec("topk", keep_frac=0.05),
        ),
        # Low-rank structured updates (Konečný et al. 1610.02527): the
        # sketch rank trades bytes against estimator variance.
        _mnist(
            "mnist_2nn_noniid_lowrank", "mnist_2nn", "pathological_noniid",
            codec=CodecSpec("lowrank", rank=8),
        ),
        _mnist(
            "mnist_2nn_noniid_fedavgm", "mnist_2nn", "pathological_noniid",
            strategy=FedAvgM(momentum=0.9),
        ),
        _mnist(
            "mnist_2nn_iid_superstep", "mnist_2nn", "iid",
            execution=ExecutionSpec(
                device_sampling=True, rounds_per_step=20
            ),
        ),
        # Buffered-async rounds under heavy-tail stragglers (FedBuff-style
        # K-of-m buffering, uniform weights): the server applies whenever
        # 3 of the 10-wide in-flight pool arrive; ~5% of sends drop.
        _mnist(
            "mnist_2nn_noniid_async", "mnist_2nn", "pathological_noniid",
            async_spec=AsyncSpec(
                buffer_k=3,
                latency=LatencyModel(
                    kind="lognormal", mean_s=1.0, sigma=1.5,
                    hetero=0.5, dropout=0.05,
                ),
            ),
        ),
        # Same schedule with FedAsync polynomial staleness discounting
        # (Xie et al. 1903.03934): stale updates are down-weighted by
        # (1 + s)^-0.5 before aggregation.
        _mnist(
            "mnist_2nn_noniid_fedasync", "mnist_2nn",
            "pathological_noniid",
            strategy=FedAsync(staleness_exp=0.5),
            async_spec=AsyncSpec(
                buffer_k=3,
                latency=LatencyModel(
                    kind="lognormal", mean_s=1.0, sigma=1.5,
                    hetero=0.5, dropout=0.05,
                ),
            ),
        ),
        # Decentralized gossip (docs/topology.md): no server — per-node
        # replicas mix with graph neighbors under Metropolis–Hastings
        # weights. C=1.0 (every node gossips every round); the ring is the
        # worst-case mixer / cheapest wire, the Watts–Strogatz small world
        # adds O(log n) shortcuts at degree 4.
        _mnist(
            "mnist_2nn_noniid_ring", "mnist_2nn", "pathological_noniid",
            fedavg=FedAvgConfig(C=1.0, E=5, B=10, lr=0.1, seed=0),
            topology=TopologySpec("ring", degree=2),
        ),
        _mnist(
            "mnist_2nn_noniid_smallworld", "mnist_2nn",
            "pathological_noniid",
            fedavg=FedAvgConfig(C=1.0, E=5, B=10, lr=0.1, seed=0),
            topology=TopologySpec("smallworld", degree=4, rewire=0.2,
                                  seed=0),
        ),
    ]
}


def get_spec(name: str) -> ExperimentSpec:
    if name not in PAPER_SPECS:
        raise KeyError(
            f"unknown experiment spec {name!r}; known: {list_specs()}"
        )
    return PAPER_SPECS[name]


def list_specs() -> List[str]:
    return sorted(PAPER_SPECS)
