"""Communication graphs for the decentralized gossip lane (a copy of
``repro/core/topology.py``; the port keeps its own because importing the
reference module runs ``repro/core/__init__.py``, which imports JAX).

Algorithm 1 is a star: every round reduces through a central server. The
gossip lane replaces the star with a peer graph in which each node averages
only with its neighbours. A ``Topology`` names such a graph declaratively;
``build(n_nodes)`` materializes it as padded arrays of static shape:

    plan = RingTopology(degree=2).build(16)
    plan.idx     # (n_nodes, max_degree+1) int32 neighbour slots (self incl.)
    plan.weight  # (n_nodes, max_degree+1) fp32 mixing weights

The mixing step is ``x_i <- sum_s weight[i, s] * x[idx[i, s]]``, i.e.
``X <- W @ X`` for the sparse doubly-stochastic ``W = plan.dense()``
(``kernels/gossip_mix.py``). Weights are Metropolis-Hastings (Xiao & Boyd
2004):

    w_ij = 1 / (1 + max(deg_i, deg_j))   for an edge (i, j)
    w_ii = 1 - sum_{j != i} w_ij         (self weight completes the row)

MH weights are symmetric, so row-stochastic implies doubly stochastic: the
invariant that makes gossip averaging preserve the global mean and drive
consensus. Padded slots carry ``idx = i`` (a safe self-gather) and
``weight = 0``, so ragged degrees stay exact in one padded shape.

The builders are the reference's line for line, so the plans are
byte-identical to ``repro``'s (``tests/test_torch_gossip.py``). On the full
graph MH weights are exactly uniform ``1/n``: the bridge back to
centralized FedAvg that ``chip_smoke.py`` phase 12 pins on the card.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, ClassVar, Dict, List, NamedTuple, Set, Union

import numpy as np


class MixingPlan(NamedTuple):
    """Static padded arrays for one materialized topology.

    ``idx[i]`` lists node i's mixing slots (self included, sorted,
    padded with ``i``); ``weight[i]`` the matching MH weights (padded
    slots 0). Both are host numpy — the engine moves them on-device
    once at construction."""

    idx: np.ndarray      # (n_nodes, max_slots) int32
    weight: np.ndarray   # (n_nodes, max_slots) float32

    @property
    def n_nodes(self) -> int:
        return self.idx.shape[0]

    @property
    def max_slots(self) -> int:
        return self.idx.shape[1]

    def dense(self) -> np.ndarray:
        """The (n_nodes, n_nodes) mixing matrix W: the oracle for the
        kernel (``gossip_mix == W @ X``) and the invariant tests."""
        n = self.n_nodes
        W = np.zeros((n, n), np.float64)
        for i in range(n):
            # np.add.at, not fancy-index assignment: padded slots repeat
            # idx == i and must accumulate, not overwrite.
            np.add.at(W[i], self.idx[i], self.weight[i].astype(np.float64))
        return W.astype(np.float32)


class Topology:
    """Base class / protocol. Subclass as a frozen dataclass, set
    ``kind``, and implement ``neighbor_sets`` (self-loops excluded —
    the MH construction adds the self weight)."""

    kind: ClassVar[str] = "base"

    def neighbor_sets(self, n_nodes: int) -> List[Set[int]]:
        """Adjacency as per-node neighbor sets, symmetric, no self."""
        raise NotImplementedError

    def validate(self, n_nodes: int) -> None:
        """Reject degenerate (kind, n_nodes) combinations with a targeted
        error at engine construction."""
        if n_nodes < 2:
            raise ValueError(
                f"topology {self.kind!r} needs n_nodes >= 2, got {n_nodes}"
            )

    def build(self, n_nodes: int) -> MixingPlan:
        """Materialize static padded neighbor-index / MH-weight arrays."""
        self.validate(n_nodes)
        nbrs = self.neighbor_sets(n_nodes)
        for i, s in enumerate(nbrs):
            s.discard(i)  # belt and braces: MH handles self separately
        deg = np.array([len(s) for s in nbrs], np.int64)
        max_slots = int(deg.max()) + 1  # +1: the self slot
        idx = np.tile(np.arange(n_nodes, dtype=np.int32)[:, None],
                      (1, max_slots))
        weight = np.zeros((n_nodes, max_slots), np.float32)
        for i, s in enumerate(nbrs):
            slots = sorted(s | {i})
            w = np.empty(len(slots), np.float64)
            for k, j in enumerate(slots):
                if j != i:
                    w[k] = 1.0 / (1.0 + max(deg[i], deg[j]))
            self_k = slots.index(i)
            w[self_k] = 0.0
            w[self_k] = 1.0 - w.sum()
            idx[i, : len(slots)] = slots
            weight[i, : len(slots)] = w
        return MixingPlan(idx=idx, weight=weight)

    def degrees(self, n_nodes: int) -> np.ndarray:
        """Per-node neighbor counts (self excluded) — the wire-cost axis:
        one mixing round moves ``2 * deg_i`` parameter vectors through
        node i (send one copy per neighbor, receive one from each)."""
        sets = self.neighbor_sets(n_nodes)
        for i, s in enumerate(sets):
            s.discard(i)
        return np.array([len(s) for s in sets], np.int64)

    @property
    def name(self) -> str:
        """Canonical serialized form (the reference's checkpoint guard compares
        this)."""
        return json.dumps(topology_to_json(self), sort_keys=True)


@dataclasses.dataclass(frozen=True)
class RingTopology(Topology):
    """k-nearest-neighbor ring: node i links to ``degree/2`` nodes on each
    side (degree 2 = the classic cycle). The worst-case mixer — O(n^2)
    consensus time — and the cheapest wire: 2 neighbors regardless of n."""

    degree: int = 2
    kind: ClassVar[str] = "ring"

    def validate(self, n_nodes: int) -> None:
        super().validate(n_nodes)
        if self.degree < 2 or self.degree % 2:
            raise ValueError(
                f"ring degree must be even and >= 2, got {self.degree}"
            )
        if self.degree >= n_nodes:
            raise ValueError(
                f"ring degree {self.degree} needs n_nodes > degree, "
                f"got n_nodes={n_nodes}"
            )

    def neighbor_sets(self, n_nodes: int) -> List[Set[int]]:
        half = self.degree // 2
        return [
            {(i + d) % n_nodes for d in range(-half, half + 1) if d}
            for i in range(n_nodes)
        ]


@dataclasses.dataclass(frozen=True)
class TorusTopology(Topology):
    """2-D wraparound grid on the most-square ``rows x cols``
    factorization of ``n_nodes``. Degenerate factorizations are safe by
    construction: a 1 x n torus dedupes to a ring (up/down wrap to self
    and are discarded), a 2 x n one dedupes the doubled vertical edge."""

    kind: ClassVar[str] = "torus"

    @staticmethod
    def shape(n_nodes: int) -> tuple:
        rows = int(math.isqrt(n_nodes))
        while n_nodes % rows:
            rows -= 1
        return rows, n_nodes // rows

    def neighbor_sets(self, n_nodes: int) -> List[Set[int]]:
        rows, cols = self.shape(n_nodes)
        out: List[Set[int]] = []
        for i in range(n_nodes):
            r, c = divmod(i, cols)
            s = {
                ((r - 1) % rows) * cols + c,
                ((r + 1) % rows) * cols + c,
                r * cols + (c - 1) % cols,
                r * cols + (c + 1) % cols,
            }
            s.discard(i)
            out.append(s)
        return out


@dataclasses.dataclass(frozen=True)
class SmallWorldTopology(Topology):
    """Watts–Strogatz small world: a degree-k ring whose edges are each
    rewired to a uniform random non-neighbor with probability ``rewire``
    (seeded — the graph is part of the experiment identity). A few
    shortcuts collapse the ring's O(n) diameter to O(log n), which is the
    whole convergence story of the reference's ``benchmarks/gossip.py``."""

    degree: int = 4
    rewire: float = 0.1
    seed: int = 0
    kind: ClassVar[str] = "smallworld"

    def validate(self, n_nodes: int) -> None:
        super().validate(n_nodes)
        RingTopology(degree=self.degree).validate(n_nodes)
        if not 0.0 <= self.rewire <= 1.0:
            raise ValueError(
                f"smallworld rewire must be in [0, 1], got {self.rewire}"
            )

    def neighbor_sets(self, n_nodes: int) -> List[Set[int]]:
        nbrs = RingTopology(degree=self.degree).neighbor_sets(n_nodes)
        rng = np.random.default_rng(self.seed)
        half = self.degree // 2
        for k in range(1, half + 1):
            for i in range(n_nodes):
                j = (i + k) % n_nodes
                if rng.random() >= self.rewire:
                    continue
                cand = [t for t in range(n_nodes)
                        if t != i and t not in nbrs[i]]
                if not cand:
                    continue  # node already saturated; keep the edge
                t = int(rng.choice(cand))
                nbrs[i].discard(j)
                nbrs[j].discard(i)
                nbrs[i].add(t)
                nbrs[t].add(i)
        return nbrs


@dataclasses.dataclass(frozen=True)
class RandomTopology(Topology):
    """Seeded Erdős–Rényi G(n, p). Nodes the coin flips leave isolated
    are deterministically attached to their ring successor — an isolated
    node would never learn from anyone, and a zero-degree row breaks the
    MH construction."""

    p: float = 0.3
    seed: int = 0
    kind: ClassVar[str] = "random"

    def validate(self, n_nodes: int) -> None:
        super().validate(n_nodes)
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"random p must be in [0, 1], got {self.p}")

    def neighbor_sets(self, n_nodes: int) -> List[Set[int]]:
        rng = np.random.default_rng(self.seed)
        nbrs: List[Set[int]] = [set() for _ in range(n_nodes)]
        for i in range(n_nodes):
            for j in range(i + 1, n_nodes):
                if rng.random() < self.p:
                    nbrs[i].add(j)
                    nbrs[j].add(i)
        for i in range(n_nodes):
            if not nbrs[i]:
                j = (i + 1) % n_nodes
                nbrs[i].add(j)
                nbrs[j].add(i)
        return nbrs


@dataclasses.dataclass(frozen=True)
class FullTopology(Topology):
    """The complete graph. MH weights on K_n are exactly uniform ``1/n``
    (every degree is n-1, so w_ij = 1/n and the self weight completes to
    1/n too) — one mixing step IS the centralized FedAvg average over
    equal-sized shards, the equivalence ``tests/test_engine_gossip.py``
    pins."""

    kind: ClassVar[str] = "full"

    def neighbor_sets(self, n_nodes: int) -> List[Set[int]]:
        full = set(range(n_nodes))
        return [full - {i} for i in range(n_nodes)]


TOPOLOGIES: Dict[str, type] = {
    RingTopology.kind: RingTopology,
    TorusTopology.kind: TorusTopology,
    SmallWorldTopology.kind: SmallWorldTopology,
    RandomTopology.kind: RandomTopology,
    FullTopology.kind: FullTopology,
}


def topology_to_json(topology: Topology) -> Dict[str, Any]:
    """``{"kind": ..., **hyper_params}`` — the wire form of a spec's
    ``topology`` section."""
    return {"kind": topology.kind, **dataclasses.asdict(topology)}


def topology_from_json(d: Dict[str, Any]) -> Topology:
    d = dict(d)
    kind = d.pop("kind")
    if kind not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {kind!r}; known: {sorted(TOPOLOGIES)}"
        )
    return TOPOLOGIES[kind](**d)


def resolve_topology(topology: Union[None, str, Topology]) -> Topology:
    """A registry name -> that topology with defaults; an instance passes
    through; None is the caller's job (the engine treats None as "star
    lane, no gossip")."""
    if isinstance(topology, str):
        if topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {topology!r}; known: {sorted(TOPOLOGIES)}"
            )
        return TOPOLOGIES[topology]()
    if not isinstance(topology, Topology):
        raise TypeError(
            f"topology must be a registry name or a Topology, "
            f"got {type(topology).__name__}"
        )
    return topology
