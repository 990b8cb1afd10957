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
- ``sample_clients_device``  the same draw from a ``torch.Generator``
                         (the superstep lane's, from its ids generator).

Cohort sharding (``RoundEngine(mesh=)``): ``CohortSlice`` names a rank's
slots of a cohort padded with ghost clients, ``shard_rows`` cuts a rank's
rows out of a draw of the whole cohort's shape, and ``server_aggregate`` and
``masked_weighted_loss`` take ``group=`` for the partial-sum finish.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import grad_and_value, vmap

from repro_torch.kernels.ops import (
    sharded_fedavg_aggregate,
    total_tensor,
    tree_fedavg_aggregate,
)
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
    """The superstep lane's S_t draw (the reference's ``fedavg.py:57``): m
    distinct client ids, uniform without replacement, the first m of a
    ``torch.randperm`` of ``n_clients`` from ``gen``; int64 on ``gen``'s
    device. The engine draws from its ids generator on the host, which then
    knows a chunk's cohorts without a sync. A different stream from
    :func:`sample_clients`: the same distribution, other realizations for
    the same seed."""
    return torch.randperm(n_clients, generator=gen, device=gen.device)[:m]


class CohortSlice(NamedTuple):
    """A rank's share of a cohort-sharded round. The ``m`` real clients are
    padded with ghosts (weight 0) to a multiple of the group's size, and this
    rank holds global slots ``[lo, hi)``; slots ``>= m`` are ghosts.
    ``total`` is the whole cohort's weight total (a host float or a 0-d
    device tensor), which every rank knows because every rank drew the whole
    cohort; None leaves it to the all-reduce."""

    m: int
    lo: int
    hi: int
    total: Any = None


def shard_rows(full: torch.Tensor, cs: Optional[CohortSlice]) -> torch.Tensor:
    """This rank's rows of ``full``, a draw of the whole cohort's shape (m,
    ...): rows ``[lo, hi)``, a ghost slot's row zeros. ``None`` is the
    unsharded round: ``full`` as it is.

    Per-client randomness is drawn for the whole cohort on every rank and
    sliced here, never drawn at the padded or the local shape: on a card,
    Philox's value at an index depends on the launch's grid, which the
    tensor's size sets, so a larger draw is not the smaller one plus a tail
    (the reference keys each client's stream by its global slot instead)."""
    if cs is None:
        return full
    rows = full[cs.lo:min(cs.hi, cs.m)]
    ghosts = cs.hi - max(cs.lo, cs.m)
    if ghosts > 0:
        pad = torch.zeros((ghosts,) + tuple(full.shape[1:]), dtype=full.dtype,
                          device=full.device)
        rows = torch.cat([rows, pad])
    return rows


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


def _per_client_loss(losses, step_mask):
    return torch.sum(losses * step_mask, dim=1) / torch.clamp(
        torch.sum(step_mask, dim=1), min=1.0
    )


def loss_terms(losses, step_mask, client_weights, total=None) -> torch.Tensor:
    """This rank's share of the sharded loss before the all-reduce, with
    ``loss_k`` the mean over client k's real steps (ghosts carry w 0):
    ``[sum_k w_k * loss_k, sum_k w_k]``, or, given the whole cohort's
    weight ``total``, ``[sum_k (w_k / total) * loss_k]``, in the unsharded
    metric's order of operations. :func:`loss_of_terms` finishes either."""
    per_client = _per_client_loss(losses, step_mask)
    if total is not None:
        w = client_weights / total_tensor(total, client_weights.device)
        return torch.sum(w * per_client).reshape(1)
    return torch.stack([torch.sum(client_weights * per_client), torch.sum(client_weights)])


def loss_of_terms(terms: torch.Tensor) -> torch.Tensor:
    """The loss from all-reduced :func:`loss_terms`."""
    return terms[0] if terms.numel() == 1 else terms[0] / terms[1]


def masked_weighted_loss(losses, step_mask, client_weights, *, group=None, total=None):
    """Round train-loss metric: mean loss over each client's REAL steps,
    weighted by client example count. Unsharded (``group=None``) it keeps
    the reference's normalize-then-sum order; over a client ``group`` it is
    :func:`loss_terms` all-reduced, then one division (the reference's
    ``axis_name`` branch), or none given the whole cohort's ``total``."""
    if group is None:
        w = client_weights / torch.sum(client_weights)
        return torch.sum(w * _per_client_loss(losses, step_mask))
    terms = loss_terms(losses, step_mask, client_weights, total)
    dist.all_reduce(terms, op=dist.ReduceOp.SUM, group=group)
    return loss_of_terms(terms)


def server_aggregate(stacked_params, client_weights, *, group=None, total=None, carry=None):
    """w_{t+1} <- sum_k (n_k/n) w^k_{t+1} — Algorithm 1's server line.

    ``client_weights`` are RAW example counts n_k; they are normalized once,
    inside ``tree_fedavg_aggregate`` (on the host when they live there),
    whose kernel takes the normalized contract. Over a client ``group`` the
    stack is this rank's slice and the kernel runs in partial-sum mode,
    finished by one all-reduce (``ops.sharded_fedavg_aggregate``, which
    takes ``total`` and ``carry``)."""
    if group is None:
        return tree_fedavg_aggregate(stacked_params, client_weights)
    return sharded_fedavg_aggregate(stacked_params, client_weights, group=group,
                                    total=total, carry=carry)
