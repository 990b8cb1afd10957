"""The server's update rule as a seam (counterpart of
``repro/core/strategies.py``).

FedAvg is the identity over the aggregated client delta
``Δ_t = Σ_k (n_k / n) (w_k - w_t)``: ``w_{t+1} = w_t + Δ_t``. FedSGD is the
same step with the paper's E=1, B=None client config enforced; FedAvgM adds
server momentum (an fp32 velocity tree); FedAsync discounts stale updates
for the buffered-async lane (``core.scheduler``) and on a synchronous
round is ``w <- w + server_lr * Δ``.

Strategies are frozen dataclasses: hyper-parameters are fields, ``kind`` is
the registry key, and ``name`` is the reference's serialized identity
string, which the checkpoint guard compares across both packages.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, ClassVar, Dict, Tuple, Union

import torch

from repro_torch.utils.tree import tree_map


class ServerStrategy:
    """Base class / protocol: ``init_state`` once, ``apply`` every round."""

    kind: ClassVar[str] = "base"

    def init_state(self, params) -> Any:
        """Server optimizer state; stateless strategies return ``()``."""
        return ()

    def apply(self, opt_state, params, agg_delta) -> Tuple[Any, Any]:
        """Consume the aggregated fp32 client delta and return
        ``(new_opt_state, new_params)``; params keep their dtypes."""
        raise NotImplementedError

    def validate_cfg(self, cfg) -> None:
        """Hook for strategies that constrain the client config (``FedSGD``
        pins E=1, B=None). Called at engine construction."""

    def staleness_scale(self, staleness: torch.Tensor) -> torch.Tensor:
        """Per-update multiplier of the raw example weight for the
        buffered-async lane, from the float tensor of server-version gaps.
        The base returns ones, which leave a weight exactly as it was."""
        return torch.ones_like(staleness)

    @property
    def name(self) -> str:
        """Canonical serialized form: the checkpoint guard compares this."""
        return json.dumps(strategy_to_json(self), sort_keys=True)


@dataclasses.dataclass(frozen=True)
class FedAvg(ServerStrategy):
    """The paper's server step: ``w <- w + Δ``. Stateless; the default."""

    kind: ClassVar[str] = "fedavg"

    def apply(self, opt_state, params, agg_delta):
        new_params = tree_map(lambda p, d: (p + d).to(p.dtype), params, agg_delta)
        return opt_state, new_params


@dataclasses.dataclass(frozen=True)
class FedSGD(FedAvg):
    """FedAvg's server step with the paper's FedSGD client config (E=1,
    B=None: the averaged delta is one full-batch gradient step) enforced at
    engine construction, so a spec that says fedsgd cannot run multi-epoch
    local SGD."""

    kind: ClassVar[str] = "fedsgd"

    def validate_cfg(self, cfg) -> None:
        if cfg.E != 1 or cfg.B is not None:
            raise ValueError(
                f"FedSGD strategy requires the paper's E=1, B=None (full "
                f"local batch) client config, got E={cfg.E}, B={cfg.B}: "
                "use E=1 and B=None, or switch the strategy to FedAvg()"
            )


@dataclasses.dataclass(frozen=True)
class FedAvgM(ServerStrategy):
    """Server momentum over the aggregated delta (Hsu et al. 2019):
    ``v <- momentum * v + Δ;  w <- w + server_lr * v``. The velocity is
    fp32 whatever the params' dtype; ``momentum=0, server_lr=1`` is FedAvg
    bit for bit (``0*v + Δ == Δ`` and ``1.0*v == v`` in IEEE arithmetic)."""

    momentum: float = 0.9
    server_lr: float = 1.0
    kind: ClassVar[str] = "fedavgm"

    def init_state(self, params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def apply(self, opt_state, params, agg_delta):
        v = tree_map(lambda v, d: self.momentum * v + d.float(), opt_state, agg_delta)
        new_params = tree_map(lambda p, vv: (p + self.server_lr * vv).to(p.dtype),
                              params, v)
        return v, new_params


@dataclasses.dataclass(frozen=True)
class FedAsync(ServerStrategy):
    """Staleness-discounted server step (Xie et al. 2019, polynomial): an
    update ``s`` server versions old is weighted by ``(1 + s)**-staleness_exp``
    before the buffer's mean, which is applied as ``w <- w + server_lr * Δ``.
    Stateless; at ``staleness_exp=0, server_lr=1`` it is FedAvg."""

    staleness_exp: float = 0.5
    server_lr: float = 1.0
    kind: ClassVar[str] = "fedasync"

    def staleness_scale(self, staleness: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(staleness, dtype=torch.float32)
        return torch.pow(1.0 + s, torch.tensor(-self.staleness_exp, dtype=torch.float32))

    def apply(self, opt_state, params, agg_delta):
        new_params = tree_map(lambda p, d: (p + self.server_lr * d).to(p.dtype),
                              params, agg_delta)
        return opt_state, new_params


STRATEGIES: Dict[str, type] = {
    FedAvg.kind: FedAvg,
    FedSGD.kind: FedSGD,
    FedAvgM.kind: FedAvgM,
    FedAsync.kind: FedAsync,
}


def strategy_to_json(strategy: ServerStrategy) -> Dict[str, Any]:
    """``{"kind": ..., **hyper_params}``: the ``ExperimentSpec`` wire form."""
    return {"kind": strategy.kind, **dataclasses.asdict(strategy)}


def strategy_from_json(d: Dict[str, Any]) -> ServerStrategy:
    d = dict(d)
    kind = d.pop("kind")
    if kind not in STRATEGIES:
        raise ValueError(f"unknown server strategy {kind!r}; known: {sorted(STRATEGIES)}")
    return STRATEGIES[kind](**d)


def resolve_strategy(strategy: Union[None, str, ServerStrategy]) -> ServerStrategy:
    """None -> FedAvg(); a registry name -> that strategy with its defaults;
    an instance passes through."""
    if strategy is None:
        return FedAvg()
    if isinstance(strategy, str):
        if strategy not in STRATEGIES:
            raise ValueError(
                f"unknown server strategy {strategy!r}; known: {sorted(STRATEGIES)}")
        return STRATEGIES[strategy]()
    if not isinstance(strategy, ServerStrategy):
        raise TypeError(
            "strategy must be None, a registry name, or a ServerStrategy, "
            f"got {type(strategy).__name__}")
    return strategy
