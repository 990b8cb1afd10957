"""The compatibility trainer and full-test-set evaluation (counterpart of
``repro/core/simulation.py``).

``FederatedTrainer`` keeps the reference's old trainer API (constructor,
``from_spec``, ``run``, ``params``, ``history``) over a ``RoundEngine``;
``build_round_batch_host`` is the legacy numpy round assembly, an
independent reference for the engine's batches. ``make_eval_fn`` scores
image classifiers and next-token LMs alike: labels may carry sequence axes,
and the loss and accuracy are means over every valid label.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import History, RoundEngine, RoundRecord  # noqa: F401
from repro_torch.core.fedavg import FedAvgConfig
from repro_torch.data.batching import client_epoch_batches
from repro_torch.utils.device import resolve_device


def build_round_batch_host(client_data, selected, cfg: FedAvgConfig, rng):
    """The legacy host round assembly (numpy): the E-epoch batch schedules
    of the ``selected`` clients (``client_epoch_batches``, each seeded by
    ``rng.integers(2**31)``), stacked and padded to a common step count
    with a 0/1 step mask; a smaller batch dim (B = inf) is tiled by
    within-client resampling. Returns (bx, by, mask, weights), weights the
    raw example counts."""
    stacks = []
    for k in selected:
        x_k, y_k = client_data[int(k)]
        bx, by = client_epoch_batches(
            x_k, y_k, cfg.B, cfg.E, seed=int(rng.integers(2**31))
        )
        stacks.append((bx, by))
    max_steps = max(s[0].shape[0] for s in stacks)
    max_b = max(s[0].shape[1] for s in stacks)
    m = len(stacks)
    bx0, by0 = stacks[0]
    bxs = np.zeros((m, max_steps, max_b) + bx0.shape[2:], bx0.dtype)
    bys = (
        np.zeros((m, max_steps, max_b) + by0.shape[2:], by0.dtype)
        if by0 is not None
        else None
    )
    mask = np.zeros((m, max_steps), np.float32)
    weights = np.zeros((m,), np.float32)
    for i, (bx, by) in enumerate(stacks):
        s, b = bx.shape[:2]
        reps = -(-max_b // b)
        bx_t = np.concatenate([bx] * reps, axis=1)[:, :max_b]
        bxs[i, :s] = bx_t
        if bys is not None:
            by_t = np.concatenate([by] * reps, axis=1)[:, :max_b]
            bys[i, :s] = by_t
        mask[i, :s] = 1.0
        weights[i] = len(client_data[int(selected[i])][0])
    return bxs, bys, mask, weights


def _refuse_unported(*, interpret=None, accum_dtype=torch.float32) -> None:
    """The engine options the port has no lane for, each refused, as
    ``RoundEngine.from_spec`` refuses the spec fields."""
    if interpret is not None:
        raise ValueError(f"interpret={interpret!r}: the port has no kernel interpreter; the "
                         "CPU path is chosen by device='cpu'")
    if accum_dtype != torch.float32:
        raise ValueError(f"accum_dtype={accum_dtype}: the port's aggregation kernels "
                         "accumulate in float32 only (a shared gap of ROADMAP Queue 2)")


class FederatedTrainer:
    """The old trainer API over a ``RoundEngine``: the reference's
    constructor and ``from_spec`` signatures plus ``device=``. Construction
    packs the population onto ``device`` once; ``run``, ``history`` and
    ``params`` are the engine's. ``latency=`` and ``async_config=`` reach the
    engine (straggler-simulated sync rounds, the buffered-async schedule);
    ``from_spec`` takes a spec's ``async_spec`` and execution fields through
    ``RoundEngine.from_spec``. ``mesh=`` and ``client_axis=`` shard each
    cohort across a client group (``launch.mesh.make_client_mesh``), as the
    engine's do. An option the port has no lane for is refused before any
    state is built."""

    def __init__(
        self,
        loss_fn: Callable,
        init_params,
        client_data: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]],
        cfg: FedAvgConfig,
        eval_fn: Optional[Callable] = None,
        codec=None,
        mesh=None,
        client_axis: str = "clients",
        device_sampling: bool = False,
        strategy=None,
        interpret: Optional[bool] = None,
        accum_dtype=torch.float32,
        latency=None,
        async_config=None,
        device="cuda",
    ):
        _refuse_unported(interpret=interpret, accum_dtype=accum_dtype)
        engine = RoundEngine(
            loss_fn, init_params, client_data, cfg, eval_fn, codec=codec,
            strategy=strategy, device_sampling=device_sampling, latency=latency,
            async_config=async_config, mesh=mesh, client_axis=client_axis, device=device,
        )
        self._wrap(engine, client_data)

    def _wrap(self, engine: RoundEngine, client_data) -> None:
        """Where both construction paths set the trainer's attributes."""
        self.engine = engine
        self.loss_fn = engine.loss_fn
        self.client_data = list(client_data)
        self.cfg = engine.cfg
        self.eval_fn = engine.eval_fn

    @classmethod
    def from_spec(
        cls,
        spec,
        client_data: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]],
        *,
        loss_fn: Optional[Callable] = None,
        init_params=None,
        eval_fn: Optional[Callable] = None,
        mesh=None,
        model_kwargs=None,
        device="cuda",
    ) -> "FederatedTrainer":
        """``RoundEngine.from_spec`` wrapped in the trainer API."""
        self = cls.__new__(cls)
        self._wrap(
            RoundEngine.from_spec(
                spec, client_data, loss_fn=loss_fn, init_params=init_params,
                eval_fn=eval_fn, model_kwargs=model_kwargs, mesh=mesh, device=device,
            ),
            client_data,
        )
        return self

    @property
    def params(self):
        return self.engine.params

    @params.setter
    def params(self, value):
        self.engine.params = value

    @property
    def history(self) -> History:
        return self.engine.history

    @property
    def round_idx(self) -> int:
        return self.engine.round_idx

    @property
    def num_clients(self) -> int:
        return self.engine.num_clients

    def lr_at(self, rnd: int) -> float:
        return self.engine.lr_at(rnd)

    def run(
        self,
        n_rounds: int,
        eval_every: int = 1,
        target_acc: Optional[float] = None,
        verbose: bool = False,
        rounds_per_step: Optional[int] = None,
    ) -> History:
        # The engine's guard, raised here too so that a caller holding only
        # the trainer sees it from the trainer: without an eval_fn the
        # accuracy target can never fire.
        if target_acc is not None and self.eval_fn is None:
            raise ValueError(
                "run(target_acc=...) needs an eval_fn to measure accuracy"
            )
        return self.engine.run(
            n_rounds, eval_every=eval_every, target_acc=target_acc,
            verbose=verbose, rounds_per_step=rounds_per_step,
        )


def make_eval_fn(apply_fn, x_test, y_test, batch_size: int = 512, device="cuda"):
    """``ev(params) -> {"loss", "acc"}`` over the whole test set, in fixed
    ``batch_size`` batches uploaded to ``device`` once, with the padded
    tail masked out exactly. ``apply_fn(params, x)`` gives logits
    (..., V); labels may carry sequence axes (an LM's (n, T)): each
    example's validity is broadcast over them, and both means are over the
    valid labels. Results are device scalars."""
    dev = resolve_device(device)
    n = len(x_test)
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    # Modular fill: x_test[:pad] under-fills when pad > n (tiny test sets);
    # the padded rows are masked out below, so content is irrelevant.
    fill = np.arange(pad) % n
    xp = np.concatenate([x_test, x_test[fill]]) if pad else x_test
    yp = np.concatenate([y_test, y_test[fill]]) if pad else y_test
    xb = torch.from_numpy(np.ascontiguousarray(
        xp.reshape((n_batches, batch_size) + x_test.shape[1:]))).to(dev)
    yb = torch.from_numpy(np.ascontiguousarray(
        yp.reshape((n_batches, batch_size) + y_test.shape[1:]))).to(dev).long()
    valid = np.ones(n_batches * batch_size, np.float32)
    if pad:
        valid[-pad:] = 0.0
    seq_axes = (1,) * (y_test.ndim - 1)
    vb = torch.from_numpy(valid.reshape((n_batches, batch_size) + seq_axes)).to(dev)
    total = float(n * int(np.prod(y_test.shape[1:], dtype=np.int64)))   # valid labels

    @torch.no_grad()
    def ev(params):
        ce_sum = torch.zeros((), device=dev)
        correct = torch.zeros((), device=dev)
        for b in range(n_batches):
            logits = apply_fn(params, xb[b]).float()
            y, v = yb[b], vb[b]
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, y.unsqueeze(-1)).squeeze(-1)
            ce_sum = ce_sum + torch.sum((logz - gold) * v)
            correct = correct + torch.sum((logits.argmax(dim=-1) == y).float() * v)
        return {"loss": ce_sum / total, "acc": correct / total}

    return ev
