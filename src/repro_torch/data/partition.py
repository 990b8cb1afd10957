"""Federated partitioners, copied from ``repro/data/partition.py``.

- ``partition_iid``: shuffle, split into K equal clients (paper: 100 x 600).
- ``partition_pathological_noniid``: sort by label, cut into 2K shards, give
  each client 2 shards — "most clients will only have examples of two digits".
- ``partition_dirichlet``: Dir(alpha) label skew.
- ``partition_unbalanced``: log-normal client sizes (paper footnote 4).

Byte-identical to the reference for the same seed (tested).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class FederatedDataset:
    """Per-client index lists over a backing array dataset."""

    client_indices: List[np.ndarray]

    @property
    def num_clients(self) -> int:
        return len(self.client_indices)

    @property
    def client_sizes(self) -> np.ndarray:
        return np.array([len(ix) for ix in self.client_indices])

    def client(self, k: int) -> np.ndarray:
        return self.client_indices[k]


def partition_iid(n_examples: int, n_clients: int, seed: int = 0) -> FederatedDataset:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_examples)
    return FederatedDataset(client_indices=list(np.array_split(perm, n_clients)))


def partition_pathological_noniid(
    labels: np.ndarray,
    n_clients: int,
    shards_per_client: int = 2,
    seed: int = 0,
) -> FederatedDataset:
    """Sort by label, ``n_clients * shards_per_client`` shards, each client
    takes ``shards_per_client`` of them."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    n_shards = n_clients * shards_per_client
    shards = np.array_split(order, n_shards)
    shard_ids = rng.permutation(n_shards)
    clients = []
    for k in range(n_clients):
        ids = shard_ids[k * shards_per_client : (k + 1) * shards_per_client]
        clients.append(np.concatenate([shards[i] for i in ids]))
    return FederatedDataset(client_indices=clients)


def partition_dirichlet(
    labels: np.ndarray, n_clients: int, alpha: float = 0.5, seed: int = 0
) -> FederatedDataset:
    """Dir(alpha) label-skew. Every client is guaranteed >= 1 example
    (requires n_examples >= n_clients): small alpha at small n / large K
    routinely draws near-zero proportions for some clients, and an empty
    client breaks every downstream consumer that divides by n_k or packs
    per-client pools (``pack_clients`` rejects zero-row clients). Empties
    are refilled by redistributing one example at a time from the currently
    largest client, which perturbs the drawn distribution the least."""
    if len(labels) < n_clients:
        raise ValueError(
            f"partition_dirichlet needs >= 1 example per client: "
            f"{len(labels)} examples < {n_clients} clients"
        )
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    clients: List[list] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for k, part in enumerate(np.split(idx, cuts)):
            clients[k].extend(part.tolist())
    for k in range(n_clients):
        while not clients[k]:
            donor = max(range(n_clients), key=lambda j: len(clients[j]))
            clients[k].append(clients[donor].pop())
    return FederatedDataset(
        client_indices=[np.array(sorted(c), dtype=np.int64) for c in clients]
    )


def partition_unbalanced(
    n_examples: int, n_clients: int, sigma: float = 1.0, seed: int = 0
) -> FederatedDataset:
    """IID draw but log-normal client sizes (heavily unbalanced)."""
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(0.0, sigma, n_clients)
    sizes = np.maximum((raw / raw.sum() * n_examples).astype(int), 1)
    # Fix rounding so sizes sum to n_examples.
    diff = n_examples - sizes.sum()
    sizes[np.argmax(sizes)] += diff
    perm = rng.permutation(n_examples)
    cuts = np.cumsum(sizes)[:-1]
    return FederatedDataset(client_indices=list(np.split(perm, cuts)))
