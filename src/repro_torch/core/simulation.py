"""Full-test-set evaluation (counterpart of ``repro/core/simulation.py``'s
``make_eval_fn``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


def make_eval_fn(apply_fn, x_test, y_test, batch_size: int = 512, device="cuda"):
    """``ev(params) -> {"loss", "acc"}`` over the whole test set, in fixed
    ``batch_size`` batches uploaded to ``device`` once, with the padded
    tail masked out exactly. Results are device scalars."""
    dev = resolve_device(device)
    n = len(x_test)
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    # Modular fill: x_test[:pad] under-fills when pad > n (tiny test sets);
    # the padded rows are masked out below, so content is irrelevant.
    fill = np.arange(pad) % n
    xp = np.concatenate([x_test, x_test[fill]]) if pad else x_test
    yp = np.concatenate([y_test, y_test[fill]]) if pad else y_test
    xb = torch.from_numpy(np.ascontiguousarray(
        xp.reshape((n_batches, batch_size) + x_test.shape[1:]))).to(dev)
    yb = torch.from_numpy(np.ascontiguousarray(
        yp.reshape((n_batches, batch_size) + y_test.shape[1:]))).to(dev).long()
    valid = np.ones(n_batches * batch_size, np.float32)
    if pad:
        valid[-pad:] = 0.0
    vb = torch.from_numpy(valid.reshape(n_batches, batch_size)).to(dev)

    @torch.no_grad()
    def ev(params):
        ce_sum = torch.zeros((), device=dev)
        correct = torch.zeros((), device=dev)
        for b in range(n_batches):
            logits = apply_fn(params, xb[b]).float()
            y, v = yb[b], vb[b]
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, y.unsqueeze(-1)).squeeze(-1)
            ce_sum = ce_sum + torch.sum((logz - gold) * v)
            correct = correct + torch.sum((logits.argmax(dim=-1) == y).float() * v)
        total = float(n)
        return {"loss": ce_sum / total, "acc": correct / total}

    return ev
