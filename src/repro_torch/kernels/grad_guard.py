"""The check every kernel wrapper makes before it launches.

A hand-written kernel writes into a ``torch.empty`` output through ctypes,
so autograd cannot see it: its output has no ``grad_fn``, and a gradient
that should flow back through it to its inputs would be dropped without a
word. So on a CUDA tensor a wrapper refuses, before it launches anything,
any input that requires grad while grad mode is on. The differentiable
entry points are ``torch.autograd.Function``s whose ``forward`` calls the
wrapper; grad mode is off inside ``forward``, so they pass.

On a CPU tensor the wrappers run their plain versions, which are
differentiable torch code; they do not call the guard there.
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, tensors, entry: str) -> None:
    """Raise ``ValueError`` when grad mode is on and any of ``tensors``
    requires grad; ``entry`` names the differentiable entry point, or the
    ROADMAP item where none exists yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"the CUDA {name} kernel has no autograd of its own, and an input requires "
            f"grad: its gradient would be dropped. {entry}"
        )


NOT_DIFFERENTIATED = (
    "No differentiable entry point exists: the server average and the gossip mix "
    "are not differentiated. Pass detached tensors, or call it under torch.no_grad()."
)
