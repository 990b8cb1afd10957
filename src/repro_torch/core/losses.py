"""Classification and next-token losses and accuracy (counterpart of
``repro/core/losses.py``)."""
from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all leading axes. ``labels`` are int class ids (int32
    from numpy; cast to int64 for ``gather``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.mean(logz - gold)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((logits.argmax(dim=-1) == labels).float())


def classification_loss(apply_fn):
    """loss(params, batch=(x, y)) -> (loss, aux) for image classifiers."""

    def loss(params, batch):
        x, y = batch
        logits = apply_fn(params, x)
        return softmax_cross_entropy(logits, y), {"acc": accuracy(logits, y)}

    return loss


def lm_loss(apply_fn):
    """loss(params, batch=(tokens, labels)) for next-token LMs:
    ``apply_fn(params, tokens)`` gives (B, T, V) logits, and the CE and the
    accuracy are means over every token, as ``classification_loss``'s are
    over every leading axis."""
    return classification_loss(apply_fn)
