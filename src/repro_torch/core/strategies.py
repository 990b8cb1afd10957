"""The server's update rule as a seam (counterpart of
``repro/core/strategies.py``).

FedAvg is the identity over the aggregated client delta
``Δ_t = Σ_k (n_k / n) (w_k - w_t)``: ``w_{t+1} = w_t + Δ_t``. The port has
FedAvg only; FedSGD, FedAvgM and FedAsync wait in ROADMAP Queue 1
("strategies, spec loader, checkpoints").
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Tuple, Union

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


@dataclasses.dataclass(frozen=True)
class FedAvg(ServerStrategy):
    """The paper's server step: ``w <- w + Δ``. Stateless; the default."""

    kind: ClassVar[str] = "fedavg"

    def apply(self, opt_state, params, agg_delta):
        new_params = tree_map(lambda p, d: (p + d).to(p.dtype), params, agg_delta)
        return opt_state, new_params


def resolve_strategy(strategy: Union[None, str, ServerStrategy]) -> ServerStrategy:
    """None or "fedavg" -> FedAvg(); a ServerStrategy instance passes
    through. Any other name raises: the rest are not ported yet."""
    if strategy is None or strategy == FedAvg.kind:
        return FedAvg()
    if isinstance(strategy, ServerStrategy):
        return strategy
    raise ValueError(
        f"server strategy {strategy!r} is not ported to repro_torch yet: only "
        "'fedavg' is (FedSGD, FedAvgM and FedAsync wait in ROADMAP Queue 1: "
        "strategies, spec loader, checkpoints)"
    )
