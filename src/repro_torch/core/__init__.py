"""FedAvg's pieces, the round engine and its schedules, strategies,
topologies, codecs, the compatibility trainer and the losses (counterpart of
``repro/core``; its export list)."""
from repro_torch.core.fedavg import (
    FedAvgConfig,
    client_update,
    sample_clients,
    sample_clients_device,
    server_aggregate,
)
from repro_torch.core.engine import (
    History,
    RoundBatch,
    RoundEngine,
    RoundRecord,
    RoundState,
    build_simulation_round_step,
)
from repro_torch.core.strategies import (
    STRATEGIES,
    FedAsync,
    FedAvg,
    FedAvgM,
    FedSGD,
    ServerStrategy,
    resolve_strategy,
    strategy_from_json,
    strategy_to_json,
)
from repro_torch.core.topology import (
    TOPOLOGIES,
    FullTopology,
    MixingPlan,
    RandomTopology,
    RingTopology,
    SmallWorldTopology,
    Topology,
    TorusTopology,
    resolve_topology,
    topology_from_json,
    topology_to_json,
)
from repro_torch.core.latency import LatencyModel
from repro_torch.core.scheduler import AsyncConfig, RoundScheduler
from repro_torch.core.compression import (
    Codec,
    build_compressed_round_step,
    identity_codec,
    lowrank_codec,
    mask_codec,
    quantize_codec,
    realized_device_bytes,
    topk_codec,
    wire_bytes,
)
from repro_torch.core.simulation import (
    FederatedTrainer,
    build_round_batch_host,
    make_eval_fn,
)
from repro_torch.core.losses import (
    accuracy,
    classification_loss,
    lm_loss,
    softmax_cross_entropy,
)


def fedsgd_config(C: float = 0.1, lr: float = 0.1, **kw) -> FedAvgConfig:
    """FedSGD == FedAvg with E=1, B=inf (paper Section 2)."""
    return FedAvgConfig(C=C, E=1, B=None, lr=lr, **kw)
