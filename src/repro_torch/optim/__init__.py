from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import constant, cosine_decay, exponential_decay, warmup_cosine

__all__ = ["Optimizer", "adam", "adamw", "apply_updates", "clip_by_global_norm", "momentum",
           "sgd", "constant", "cosine_decay", "exponential_decay", "warmup_cosine"]
