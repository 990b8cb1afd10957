"""Client latency / dropout simulation model for the round scheduler (a
numpy-only copy of ``repro/core/latency.py``; ``core.scheduler`` draws
from it).

The paper's deployment setting is millions of unreliable phones, but a
synchronous simulation hides the cost structure that motivates FedAvg in
the first place: a round is as slow as its slowest client, and clients
drop out. ``LatencyModel`` is the reproducible stand-in — a frozen,
JSON-serializable description of per-client wall-clock behavior that
``core.scheduler.RoundScheduler`` samples from its OWN numpy stream
(``seed``), deliberately separate from the engine's client-sampling RNG so
that turning the simulation on or off never perturbs which cohorts are
drawn. That separation is what makes the sync lane's bit-for-bit guarantee
cheap to keep: a zero-latency model is exactly the current behavior.

Three pieces compose a draw:

- a base **distribution** (``kind``): ``"zero"`` (the degenerate model —
  every update arrives instantly, nobody drops late), ``"lognormal"``
  (heavy-tailed stragglers; ``sigma`` is the log-space spread and the
  distribution is mean-preserving, E[latency] = ``mean_s`` regardless of
  sigma), or ``"exponential"`` (memoryless with mean ``mean_s``).
- a per-client **speed factor** (``hetero``): each client k gets a fixed
  multiplier exp(N(0, hetero)) drawn once per population — slow phones
  stay slow across rounds, which is what makes over-selection/buffering
  pay off. ``hetero=0`` disables it.
- **failure**: each dispatched update independently drops with probability
  ``dropout`` (work lost, slot freed); with a ``deadline_s`` the server
  additionally abandons any update slower than the deadline. Both are
  observed by the scheduler as a zero-weight ghost — the same masking path
  ``pad_cohort`` uses for shard padding.

``draw`` returns the server-OBSERVED arrival time: ``min(latency,
deadline)`` — a straggler past the deadline still occupies its slot until
the deadline fires, and a dropout is reported at the time the failure is
known. All draws consume ``rng`` in dispatch order, so one seed fixes the
whole event schedule (the determinism contract tested in
tests/test_scheduler_async.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

KINDS = ("zero", "lognormal", "exponential")


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    kind: str = "zero"
    mean_s: float = 1.0
    sigma: float = 1.0
    hetero: float = 0.0
    dropout: float = 0.0
    deadline_s: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown latency kind {self.kind!r}; known: {KINDS}"
            )
        if self.mean_s < 0:
            raise ValueError(f"mean_s must be >= 0, got {self.mean_s}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(
                f"dropout must be in [0, 1), got {self.dropout}"
            )
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s}"
            )
        if self.hetero < 0:
            raise ValueError(f"hetero must be >= 0, got {self.hetero}")

    @property
    def is_zero(self) -> bool:
        """True iff this model cannot delay or drop anything — the
        degenerate schedule under which the scheduler must reproduce the
        synchronous lane bit-for-bit."""
        return self.kind == "zero" and self.dropout == 0.0

    def init_rng(self) -> np.random.Generator:
        """The per-run latency stream. Fresh per ``run()`` call so the
        event schedule is a pure function of (model, dispatch order)."""
        return np.random.default_rng(self.seed)

    def client_speed(self, num_clients: int) -> np.ndarray:
        """(K,) fixed per-client latency multipliers. Drawn from a
        DERIVED seed (not the draw stream), so the population's speed
        profile is identical however many rounds run before it is read."""
        if self.hetero == 0.0:
            return np.ones(num_clients)
        r = np.random.default_rng(self.seed + 1)
        return np.exp(r.normal(0.0, self.hetero, num_clients))

    def draw(
        self,
        rng: np.random.Generator,
        client_ids: np.ndarray,
        speed: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sample observed arrival times for one dispatch.

        Returns ``(t_obs, ok)``: ``t_obs`` float64 seconds after dispatch
        at which the server learns each update's fate, ``ok`` bool — False
        for dropouts and deadline misses (their compute is discarded
        through the zero-weight path). Consumes ``rng`` in a fixed order
        (latency draw, then the dropout draw iff dropout > 0) so identical
        seeds replay identical schedules.
        """
        n = len(client_ids)
        if self.kind == "zero":
            lat = np.zeros(n)
        elif self.kind == "lognormal":
            # exp(N(-sigma^2/2, sigma)) has mean 1: sigma widens the tail
            # without shifting the average, so sweeps over straggler
            # severity hold the mean round cost fixed.
            lat = self.mean_s * np.exp(
                rng.normal(-0.5 * self.sigma**2, self.sigma, n)
            )
        else:  # exponential
            lat = rng.exponential(self.mean_s, n)
        lat = lat * speed[np.asarray(client_ids, np.int64)]
        ok = np.ones(n, bool)
        if self.dropout > 0.0:
            ok &= rng.random(n) >= self.dropout
        if self.deadline_s is not None:
            ok &= lat <= self.deadline_s
            lat = np.minimum(lat, self.deadline_s)
        return lat, ok
