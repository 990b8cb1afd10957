"""FederatedAveraging — Algorithm 1 (counterpart of ``repro/core/fedavg.py``).

- ``client_update``      ClientUpdate(k, w) for a whole cohort at once: E
                         epochs of masked minibatch SGD, batched over
                         clients with ``torch.func.vmap``; its core
                         ``client_update_stacked`` starts each client from
                         its own params (the gossip lane's replicas).
- ``server_aggregate``   w_{t+1} = sum_k (n_k / n) w^k_{t+1}.
- ``sample_clients``     S_t = random set of m = max(C*K, 1) clients, the
                         same numpy draw as the reference, so the same seed
                         picks the same cohort ids.
- ``sample_clients_device``  the same draw on the device from a
                         ``torch.Generator`` (the superstep lane).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.kernels.ops import tree_fedavg_aggregate
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class FedAvgConfig:
    """Paper hyper-parameters (Section 2).

    C: fraction of clients per round; the server samples m = max(C*K, 1).
    E: local epochs per round.
    B: local minibatch size; None means B = inf (full local batch).
    lr: client SGD learning rate.
    lr_decay: per-round multiplicative decay of ``lr``.
    """

    C: float = 0.1
    E: int = 1
    B: Optional[int] = 10
    lr: float = 0.1
    lr_decay: float = 1.0
    seed: int = 0

    def expected_updates_per_round(self, n: int, K: int) -> float:
        """u = E * n / (K * B), Table 2's ordering statistic."""
        b = self.B if self.B is not None else n / K
        return self.E * n / (K * b)


def sample_clients(rng: np.random.Generator, n_clients: int, C: float) -> np.ndarray:
    """S_t <- random set of m clients, m = max(C*K, 1)."""
    return rng.choice(n_clients, size=cohort_size(n_clients, C), replace=False)


def cohort_size(n_clients: int, C: float) -> int:
    """m = max(round(C * K), 1), as ``sample_clients`` draws it."""
    return max(int(round(C * n_clients)), 1)


def sample_clients_device(gen: torch.Generator, n_clients: int, m: int) -> torch.Tensor:
    """On-device S_t draw (the reference's ``fedavg.py:57``): m distinct
    client ids, uniform without replacement, as the argsort of
    ``n_clients`` uniforms from ``gen``, the first m kept; int64 on
    ``gen``'s device. No host value is read, so the draw can sit inside a
    captured CUDA graph. A different stream from :func:`sample_clients`:
    the same distribution, other realizations for the same seed."""
    u = torch.rand(n_clients, generator=gen, device=gen.device)
    return torch.argsort(u)[:m]


def client_update_stacked(loss_fn: Callable, stacked, batches, step_mask, lr):
    """ClientUpdate for the cohort, client k starting from row k of the
    (m, ...) ``stacked`` params (the gossip lane's per-node replicas).

    ``batches``: tuple of tensors with leading (m, n_steps, B, ...) axes;
    ``step_mask``: (m, n_steps) 0/1 float; ``lr`` a float or a 0-d fp32
    tensor on the params' device (the superstep lane's static buffer,
    which a captured graph reads on every replay where a float would be
    baked in as a constant); both give the same bits. Each step computes every
    client's gradient with one vmapped call and applies
    ``p - lr * mask * g``; a padded step (mask 0) still computes its
    gradient and leaves the client unchanged, as the reference's scan does.
    Returns the (m, ...) stacked client params and the (m, n_steps) losses.
    """
    m, n_steps = step_mask.shape
    step_grad = vmap(grad_and_value(loss_fn, has_aux=True))
    w = stacked
    losses = []
    for s in range(n_steps):
        grads, (loss, _) = step_grad(w, tuple(b[:, s] for b in batches))
        scale = lr * step_mask[:, s]
        w = tree_map(
            lambda p, g: p - scale.reshape((m,) + (1,) * (p.ndim - 1)) * g, w, grads
        )
        losses.append(loss)
    return w, torch.stack(losses, dim=1)


def client_update(loss_fn: Callable, params, batches, step_mask, lr):
    """ClientUpdate for the cohort with every client starting from the one
    ``params`` tree (the star lanes): ``client_update_stacked`` from ``params``
    repeated along a leading (m,) axis."""
    m = step_mask.shape[0]
    stacked = tree_map(lambda p: p.unsqueeze(0).expand((m,) + tuple(p.shape)).clone(), params)
    return client_update_stacked(loss_fn, stacked, batches, step_mask, lr)


def masked_weighted_loss(losses, step_mask, client_weights):
    """Round train-loss metric: mean loss over each client's REAL steps,
    weighted by client example count (the reference's unsharded branch)."""
    per_client = torch.sum(losses * step_mask, dim=1) / torch.clamp(
        torch.sum(step_mask, dim=1), min=1.0
    )
    w = client_weights / torch.sum(client_weights)
    return torch.sum(w * per_client)


def server_aggregate(stacked_params, client_weights):
    """w_{t+1} <- sum_k (n_k/n) w^k_{t+1} — Algorithm 1's server line.

    ``client_weights`` are RAW example counts n_k; they are normalized once,
    inside ``tree_fedavg_aggregate`` (on the host when they live there),
    whose kernel takes the normalized contract."""
    return tree_fedavg_aggregate(stacked_params, client_weights)
