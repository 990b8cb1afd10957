"""The paper's two MNIST partitions, copied from ``repro/data/partition.py``.

- ``partition_iid``: shuffle, split into K equal clients (paper: 100 x 600).
- ``partition_pathological_noniid``: sort by label, cut into 2K shards, give
  each client 2 shards — "most clients will only have examples of two digits".

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
