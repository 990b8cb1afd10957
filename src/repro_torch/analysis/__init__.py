"""Runtime guards over the round loop (counterpart of ``repro.analysis``'s
``guards``; its JAX linter is not ported)."""
from repro_torch.analysis.guards import (
    RetraceError,
    retrace_guard,
    sanctioned_staging,
    transfer_guard,
)

__all__ = ["RetraceError", "retrace_guard", "sanctioned_staging", "transfer_guard"]
