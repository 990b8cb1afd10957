"""ExperimentSpec: the declarative, JSON-round-trippable front door
(counterpart of ``repro/specs/spec.py``).

One frozen value names one cell of the paper's grid: Algorithm 1's
(C, E, B), the model, the partition, and the post-paper axes (server
strategy, upload codec, gossip topology, async schedule, execution lane)::

    spec = get_spec("mnist_2nn_noniid_fedavgm")
    engine = RoundEngine.from_spec(spec, client_data, eval_fn=ev)
    spec == ExperimentSpec.from_json(spec.to_json())   # always

The JSON form is the reference's exactly (``to_json`` gives the same
string), so ``specs/*.json`` drive both packages. The ``build`` methods return the
port's objects: ``ModelSpec.build`` the port's models, ``CodecSpec.build``
its codecs, ``TopologySpec.build`` its topologies.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional

from repro_torch.core.fedavg import FedAvgConfig
from repro_torch.core.latency import LatencyModel
from repro_torch.core.strategies import (
    FedAvg,
    ServerStrategy,
    strategy_from_json,
    strategy_to_json,
)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A registered model family plus its construction kwargs
    (``repro_torch.models.paper``'s five); ``build`` overrides them, e.g.
    ``device=``, or a ``vocab_size`` that resolves only at data time."""

    kind: str
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, **overrides):
        from repro_torch.models import paper

        models = {"mnist_2nn": paper.mnist_2nn, "mnist_cnn": paper.mnist_cnn,
                  "cifar_cnn": paper.cifar_cnn, "char_lstm": paper.char_lstm,
                  "word_lstm": paper.word_lstm}
        if self.kind not in models:
            raise ValueError(
                f"unknown model kind {self.kind!r}; known: {sorted(models)}"
            )
        return models[self.kind](**{**dict(self.kwargs), **overrides})


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """How the training set splits into clients: ``iid`` |
    ``pathological_noniid`` (``shards_per_client`` label-sorted shards each)
    | ``unbalanced`` (log-normal sizes) | ``dirichlet`` (label skew at
    ``alpha``) | ``natural`` (the dataset arrives federated)."""

    kind: str = "iid"
    n_clients: int = 100
    shards_per_client: int = 2
    alpha: float = 0.5
    seed: int = 0

    def build(self, labels=None, n_examples: Optional[int] = None):
        """Realize the partition: label-driven kinds need ``labels``,
        size-driven kinds ``n_examples`` (inferred from ``labels``)."""
        from repro_torch.data import partition as P

        if labels is not None and n_examples is None:
            n_examples = len(labels)
        if self.kind == "iid":
            return P.partition_iid(n_examples, self.n_clients, seed=self.seed)
        if self.kind == "pathological_noniid":
            return P.partition_pathological_noniid(
                labels, self.n_clients, self.shards_per_client, seed=self.seed)
        if self.kind == "unbalanced":
            return P.partition_unbalanced(n_examples, self.n_clients, seed=self.seed)
        if self.kind == "dirichlet":
            return P.partition_dirichlet(labels, self.n_clients, alpha=self.alpha,
                                         seed=self.seed)
        if self.kind == "natural":
            raise ValueError(
                "'natural' partitions are defined by the dataset loader "
                "(one client per role/author); there is nothing to build"
            )
        raise ValueError(f"unknown partition kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Client-upload compression: ``identity`` | ``quantize`` (``bits``,
    ``chunk``) | ``mask`` / ``topk`` (``keep_frac``) | ``lowrank``
    (``rank``). ``None`` at the ExperimentSpec level is the plain lane."""

    kind: str
    bits: int = 8
    chunk: int = 512
    keep_frac: float = 0.1
    rank: int = 8

    def build(self):
        from repro_torch.core import compression as C

        if self.kind == "identity":
            return C.identity_codec()
        if self.kind == "quantize":
            return C.quantize_codec(self.bits, chunk=self.chunk)
        if self.kind == "mask":
            return C.mask_codec(self.keep_frac)
        if self.kind == "topk":
            return C.topk_codec(self.keep_frac)
        if self.kind == "lowrank":
            return C.lowrank_codec(self.rank)
        raise ValueError(f"unknown codec kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The gossip graph: ``ring`` (``degree``) | ``torus`` | ``smallworld``
    (``degree``, ``rewire``, ``seed``) | ``random`` (``p``, ``seed``) |
    ``full``. Only the fields that are set reach the topology's
    constructor, so a field foreign to the kind fails there."""

    kind: str
    degree: Optional[int] = None
    rewire: Optional[float] = None
    p: Optional[float] = None
    seed: Optional[int] = None

    def build(self):
        from repro_torch.core.topology import topology_from_json

        d: Dict[str, Any] = {"kind": self.kind}
        for f in ("degree", "rewire", "p", "seed"):
            v = getattr(self, f)
            if v is not None:
                d[f] = v
        return topology_from_json(d)


@dataclasses.dataclass(frozen=True)
class AsyncSpec:
    """The buffered-async axis: apply whenever ``buffer_k`` of
    ``concurrency`` in-flight updates arrive, under ``latency``
    (``RoundEngine.from_spec`` builds the ``AsyncConfig`` and the
    ``LatencyModel`` of ``core.scheduler`` from it)."""

    buffer_k: int = 4
    concurrency: Optional[int] = None
    latency: LatencyModel = LatencyModel()


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """How the experiment runs: the reference's execution lane fields
    (``mesh_axes`` for cohort sharding, ``device_sampling`` and
    ``rounds_per_step`` for the superstep lanes, gossip's included,
    ``pool``: ``"auto"``, ``"device"`` or ``"streamed"``, with
    ``pool_shard_clients`` and ``prefetch``). ``from_spec`` runs every
    lane; it refuses ``interpret`` (the port has no kernel interpreter) and
    an ``accum_dtype`` other than float32."""

    mesh_axes: Optional[str] = None
    device_sampling: bool = False
    rounds_per_step: Optional[int] = None
    interpret: Optional[bool] = None
    accum_dtype: str = "float32"
    pool: str = "auto"
    pool_shard_clients: int = 1024
    prefetch: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One cell of the paper grid, declaratively. See the module docstring."""

    name: str
    model: ModelSpec
    partition: PartitionSpec
    fedavg: FedAvgConfig
    strategy: ServerStrategy = FedAvg()
    codec: Optional[CodecSpec] = None
    # None = star lane; a TopologySpec switches to the gossip lane.
    topology: Optional[TopologySpec] = None
    execution: ExecutionSpec = ExecutionSpec()
    # None = synchronous rounds.
    async_spec: Optional[AsyncSpec] = None
    # Run-length defaults for scripts (run() arguments win).
    rounds: int = 100
    target_acc: Optional[float] = None

    def build_model(self, **overrides):
        return self.model.build(**overrides)

    def build_partition(self, labels=None, n_examples: Optional[int] = None):
        return self.partition.build(labels=labels, n_examples=n_examples)

    def build_codec(self):
        return self.codec.build() if self.codec is not None else None

    def build_strategy(self) -> ServerStrategy:
        return self.strategy

    def to_json(self, indent: Optional[int] = None) -> str:
        if callable(self.fedavg.lr):
            raise ValueError(
                "ExperimentSpec.to_json cannot serialize a callable lr "
                "schedule: use a scalar lr (+ lr_decay), or keep schedule "
                "specs in code"
            )

        def section(v):
            return dataclasses.asdict(v) if v is not None else None

        d = {
            "name": self.name,
            "model": dataclasses.asdict(self.model),
            "partition": dataclasses.asdict(self.partition),
            "fedavg": dataclasses.asdict(self.fedavg),
            "strategy": strategy_to_json(self.strategy),
            "codec": section(self.codec),
            "topology": section(self.topology),
            "execution": dataclasses.asdict(self.execution),
            "async_spec": section(self.async_spec),
            "rounds": self.rounds,
            "target_acc": self.target_acc,
        }
        return json.dumps(d, indent=indent, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ExperimentSpec":
        d = json.loads(s)
        aspec = None
        if d.get("async_spec"):
            a = dict(d["async_spec"])
            aspec = AsyncSpec(latency=LatencyModel(**a.pop("latency", {})), **a)
        return ExperimentSpec(
            name=d["name"],
            model=ModelSpec(**d["model"]),
            partition=PartitionSpec(**d["partition"]),
            fedavg=FedAvgConfig(**d["fedavg"]),
            strategy=strategy_from_json(d["strategy"]),
            codec=CodecSpec(**d["codec"]) if d.get("codec") else None,
            topology=TopologySpec(**d["topology"]) if d.get("topology") else None,
            execution=ExecutionSpec(**d.get("execution", {})),
            async_spec=aspec,
            rounds=int(d.get("rounds", 100)),
            target_acc=d.get("target_acc"),
        )
