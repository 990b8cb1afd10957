"""The declarative front door (counterpart of ``repro/specs``): the
``ExperimentSpec`` value, its JSON wire form (``specs/*.json``) and the
paper presets. ``RoundEngine.from_spec`` builds an engine from a spec."""
from repro_torch.specs.presets import PAPER_SPECS, get_spec, list_specs
from repro_torch.specs.spec import (
    AsyncSpec,
    CodecSpec,
    ExecutionSpec,
    ExperimentSpec,
    ModelSpec,
    PartitionSpec,
    TopologySpec,
)

__all__ = [
    "AsyncSpec", "CodecSpec", "ExecutionSpec", "ExperimentSpec", "ModelSpec",
    "PartitionSpec", "TopologySpec", "PAPER_SPECS", "get_spec", "list_specs",
]
