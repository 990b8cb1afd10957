"""RoundEngine: Algorithm 1 over a device-resident client pool (counterpart
of ``repro/core/engine.py``, its plain lane).

One round::

    host                                  device
    rng.choice -> cohort ids (m,)         gather rows        x[ids] -> (m, n_pad, ..)
    rng.integers -> generator seed        per-(client, epoch) sort keys -> permutation
    counts[ids] -> raw weights (m,)       batches            -> (m, E*spe, B, ..)
                                          vmapped ClientUpdate (masked SGD steps)
                                          fp32 deltas -> fedavg_aggregate (CUDA kernel)
                                          strategy.apply -> new global params

The cohort is drawn on the host with the reference's numpy stream, in the
reference's order (``rng.choice`` then ``rng.integers(2**31)``), so the
same seed gives the same cohort ids every round. The integer seeds a
``torch.Generator`` on the engine's device, which draws the batch
permutations: their keys are not the reference's bits (threefry and
Philox differ), so whole runs are compared by accuracy, never bitwise, and
exact checks inject the reference's batches through
``build_simulation_round_step``.

Weights come from the host counts, so normalizing them costs no device
sync; the loop's only per-round sync is the loss read in ``run``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fedavg import (
    FedAvgConfig,
    client_update,
    masked_weighted_loss,
    sample_clients,
    server_aggregate,
)
from repro_torch.core.strategies import ServerStrategy, resolve_strategy
from repro_torch.data.batching import pack_clients
from repro_torch.data.pool import device_pool_budget
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


class RoundState(NamedTuple):
    """Everything a round mutates: the global params and the strategy's
    server state (``outer_state``)."""

    params: Any
    outer_state: Any = None


class RoundBatch(NamedTuple):
    """One round's client data.

    data:           tuple of (m, n_steps, B, ...) tensors, ``(x, y)``.
    step_mask:      (m, n_steps) 0/1 float; padded steps are no-ops.
    client_weights: (m,) RAW example counts n_k, on the host or the device;
                    normalized once, inside ``server_aggregate``.
    lr:             client learning rate for this round.
    """

    data: Any
    step_mask: torch.Tensor
    client_weights: torch.Tensor
    lr: Any = None


def build_simulation_round_step(
    loss_fn: Callable,
    *,
    strategy: Optional[ServerStrategy] = None,
):
    """``round_step(state, batch) -> (state, {"loss": ...})``: the vmapped
    ClientUpdate, then the fp32 client deltas through ``server_aggregate``
    (the CUDA ``fedavg_aggregate`` on the card), then ``strategy.apply``.
    The reference's strategy path (``engine.py:153-217``)."""
    strategy = resolve_strategy(strategy)

    def round_step(state: RoundState, rb: RoundBatch):
        client_params, losses = client_update(
            loss_fn, state.params, rb.data, rb.step_mask, rb.lr
        )
        w = torch.as_tensor(rb.client_weights, dtype=torch.float32)
        loss = masked_weighted_loss(losses, rb.step_mask, w.to(losses.device))
        deltas = tree_map(lambda c, p: (c - p).float(), client_params, state.params)
        agg_delta = server_aggregate(deltas, w)
        outer, new_params = strategy.apply(state.outer_state, state.params, agg_delta)
        return state._replace(params=new_params, outer_state=outer), {"loss": loss}

    return round_step


@dataclasses.dataclass
class RoundRecord:
    round: int
    train_loss: float
    test_acc: Optional[float] = None
    test_loss: Optional[float] = None
    wall_s: float = 0.0


def _monotone_crossing(curve, target: float) -> Optional[float]:
    """First crossing of ``target`` on a best-so-far-monotone curve of
    (x, acc) points, linearly interpolated between evaluations; a first
    point that already crosses returns its own x."""
    if not curve:
        return None
    best = -np.inf
    mono = []
    for x, acc in curve:
        best = max(best, acc)
        mono.append((x, best))
    prev: Optional[Tuple[float, float]] = None
    for x, acc in mono:
        if acc >= target:
            if prev is None or acc == prev[1]:
                return float(x)
            prev_x, prev_a = prev
            frac = (target - prev_a) / (acc - prev_a)
            return float(prev_x + frac * (x - prev_x))
        prev = (x, acc)
    return None


@dataclasses.dataclass
class History:
    records: List[RoundRecord] = dataclasses.field(default_factory=list)

    def accuracy_curve(self) -> List[Tuple[int, float]]:
        return [(r.round, r.test_acc) for r in self.records if r.test_acc is not None]

    def rounds_to_target(self, target: float) -> Optional[float]:
        """Paper's metric: first crossing of ``target`` on the best-so-far
        accuracy curve, interpolated between evaluated rounds."""
        return _monotone_crossing(self.accuracy_curve(), target)


class RoundEngine:
    """Algorithm 1 over a packed client population.

    Construction packs ``client_data`` once (``data.batching.pack_clients``)
    and uploads it to ``device``; each ``round()`` draws a cohort on the
    host and runs gather -> permute -> ClientUpdate -> aggregate on the
    device. ``device`` defaults to ``"cuda"`` and raises without a card."""

    def __init__(
        self,
        loss_fn: Callable,
        init_params,
        client_data: Sequence[Tuple[np.ndarray, np.ndarray]],
        cfg: FedAvgConfig,
        eval_fn: Optional[Callable] = None,
        *,
        strategy=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        # A private copy: the caller's tensors are never updated.
        self.params = tree_map(
            lambda p: torch.as_tensor(p).to(self.device, copy=True), init_params
        )
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.rng = np.random.default_rng(cfg.seed)
        self.strategy = resolve_strategy(strategy)
        self.outer_state = self.strategy.init_state(self.params)
        self.round_idx = 0
        self.history = History()
        if any(y is None for _, y in client_data):
            raise ValueError("RoundEngine trains classifiers: every client needs labels")
        packed = pack_clients(client_data, cfg.B,
                              max_bytes=device_pool_budget(self.device))
        self._x = torch.from_numpy(packed.x).to(self.device)
        self._y = torch.from_numpy(packed.y).to(self.device)
        # Keep only the metadata: counts and steps stay on the host, where
        # the cohort is drawn.
        self.packed = packed._replace(x=None, y=None)
        self._round_step = build_simulation_round_step(loss_fn, strategy=self.strategy)

    @property
    def num_clients(self) -> int:
        return self.packed.num_clients

    def lr_at(self, rnd: int) -> float:
        """Client lr for round ``rnd``: ``cfg.lr`` decayed by ``cfg.lr_decay``
        per round."""
        return float(self.cfg.lr) * self.cfg.lr_decay**rnd

    def _next_round_inputs(self):
        """(cohort ids, generator seed, lr), drawn from the numpy stream in
        the reference's order: ``rng.choice``, then ``rng.integers``."""
        lr = self.lr_at(self.round_idx)
        ids = sample_clients(self.rng, self.num_clients, self.cfg.C)
        seed = int(self.rng.integers(2**31))
        return ids, seed, lr

    def materialize_round_batch(self, ids, generator_seed: int):
        """(batch, step_mask, weights) for cohort ``ids``, permutations drawn
        from a device generator seeded with ``generator_seed``.

        One draw order per (client, epoch): sorting by ``u + 2*(row >= n_k)``
        puts a uniform permutation of the client's n_k real rows first and
        the tiled padding rows after, so the active steps (ceil(n_k / B) per
        epoch) see every real example exactly once per epoch. Weights are
        the host float32 counts."""
        ids = np.asarray(ids)
        E = self.cfg.E
        spe = self.packed.max_real_steps_per_epoch
        B = self.packed.batch_size
        dev = self.device
        idx = torch.from_numpy(ids.astype(np.int64)).to(dev)
        xs = self._x.index_select(0, idx)                       # (m, n_pad, ...)
        m, n_pad = xs.shape[:2]
        counts = self.packed.counts[ids]
        n_real = torch.from_numpy(counts.astype(np.int64)).to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(generator_seed))
        u = torch.rand((m, E, n_pad), generator=gen, device=dev)
        is_pad = torch.arange(n_pad, device=dev) >= n_real[:, None, None]
        perm = torch.argsort(u + 2.0 * is_pad, dim=-1)[:, :, : spe * B]
        perm = perm.reshape(m, E * spe * B)
        rows = torch.arange(m, device=dev)[:, None]
        bx = xs[rows, perm].reshape((m, E * spe, B) + tuple(xs.shape[2:]))
        ys = self._y.index_select(0, idx)
        by = ys[rows, perm].reshape((m, E * spe, B) + tuple(ys.shape[2:]))
        spe_k = self.packed.steps_per_epoch[ids]
        mask = (np.arange(E * spe)[None, :] % spe < spe_k[:, None]).astype(np.float32)
        return (bx, by), torch.from_numpy(mask).to(dev), torch.from_numpy(counts.copy())

    def round(self) -> Dict[str, torch.Tensor]:
        """One synchronous round; returns {'loss': device scalar}."""
        ids, seed, lr = self._next_round_inputs()
        batch, mask, w = self.materialize_round_batch(ids, seed)
        state, metrics = self._round_step(
            RoundState(self.params, outer_state=self.outer_state),
            RoundBatch(batch, mask, w, lr=lr),
        )
        self.params, self.outer_state = state.params, state.outer_state
        self.round_idx += 1
        return metrics

    def run(
        self,
        n_rounds: int,
        eval_every: int = 1,
        target_acc: Optional[float] = None,
        verbose: bool = False,
    ) -> History:
        """Run ``n_rounds`` of Algorithm 1, evaluating every ``eval_every``
        rounds and after the last; stop early once ``target_acc`` is met.
        Each record's ``wall_s`` ends at the synced loss read."""
        if int(eval_every) < 1:
            raise ValueError(
                f"eval_every must be >= 1, got {eval_every} (use a large "
                "eval_every, not 0, to evaluate only at the end)"
            )
        if target_acc is not None and self.eval_fn is None:
            raise ValueError(
                "run(target_acc=...) needs an eval_fn to measure accuracy"
            )
        for i in range(n_rounds):
            t0 = time.perf_counter()
            metrics = self.round()
            loss = float(metrics["loss"])
            rec = RoundRecord(round=self.round_idx, train_loss=loss,
                              wall_s=time.perf_counter() - t0)
            self.history.records.append(rec)
            if self.eval_fn is not None and (
                self.round_idx % eval_every == 0 or i == n_rounds - 1
            ):
                ev = self.eval_fn(self.params)
                rec.test_acc = float(ev["acc"])
                rec.test_loss = float(ev.get("loss", np.nan))
                if verbose:
                    print(f"round {self.round_idx:5d} loss {rec.train_loss:.4f} "
                          f"test_acc {rec.test_acc:.4f}")
                if target_acc is not None and rec.test_acc >= target_acc:
                    break
        return self.history
