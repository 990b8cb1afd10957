"""Optimizers over parameter trees (counterpart of ``repro/optim/optimizers.py``).

An ``Optimizer`` is an (init, update) pair, as the reference's:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The arithmetic is the reference's, in its order: math in fp32 where the
reference widens, moments stored in ``state_dtype``. The step is a 0-d
int32 tensor on the params' device, and learning rates from a schedule are
0-d fp32 tensors computed from it there, so bias correction and schedules
never make the host wait for the card.

One difference, for memory: ``adam`` writes the new moments into the
state's own tensors (in place) and returns a state holding those tensors,
where the reference returns new arrays. At Gemma-2B's size two fp32 moment
sets take 20 GB a replica; a second copy of them would not fit the card.
The caller keeps no use for the old moments.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _resolve_lr(lr, step):
    return lr(step) if callable(lr) else lr


def _times_lr(lr, x):
    """``lr * x`` with the reference's promotion: a Python float keeps x's
    dtype (a weak type in JAX), a 0-d fp32 tensor from a schedule takes the
    product to fp32 (JAX promotes bf16 x f32 to f32; torch would not)."""
    return lr * (x.float() if torch.is_tensor(lr) else x)


def _step0(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


class SGDState(NamedTuple):
    step: torch.Tensor


def sgd(learning_rate) -> Optimizer:
    def init(params):
        return SGDState(step=_step0(params))

    def update(grads, state, params=None):
        del params
        lr = _resolve_lr(learning_rate, state.step)
        updates = tree_map(lambda g: _times_lr(-lr, g), grads)
        return updates, SGDState(step=state.step + 1)

    return Optimizer(init, update)


class MomentumState(NamedTuple):
    step: torch.Tensor
    velocity: Any


def momentum(learning_rate, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return MomentumState(step=_step0(params), velocity=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        del params
        lr = _resolve_lr(learning_rate, state.step)
        vel = tree_map(lambda v, g: beta * v + g, state.velocity, grads)
        if nesterov:
            updates = tree_map(lambda v, g: _times_lr(-lr, beta * v + g), vel, grads)
        else:
            updates = tree_map(lambda v: _times_lr(-lr, v), vel)
        return updates, MomentumState(step=state.step + 1, velocity=vel)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def _moment_(buf, beta, term):
    """``beta * buf + term`` in fp32, stored into ``buf`` (its dtype) in
    place; returns the fp32 value (the unrounded one when ``buf`` is bf16,
    as the reference uses it before storing)."""
    if buf.dtype == torch.float32:
        return buf.mul_(beta).add_(term)
    val = buf.float().mul_(beta).add_(term)
    buf.copy_(val)
    return val


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
         state_dtype=torch.float32) -> Optimizer:
    """Adam; with weight_decay > 0 this is AdamW (decoupled decay).

    ``state_dtype`` is the stored moments' dtype (bf16 halves their memory;
    the math runs in fp32 either way)."""

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return AdamState(step=_step0(params), mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(grads, state, params=None):
        if weight_decay and params is None:
            raise ValueError("AdamW needs params for decoupled decay")
        step = state.step + 1
        lr = _resolve_lr(learning_rate, state.step)
        t = step.float()
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t

        def one(g, m, v, p):
            g32 = g.float()
            mu = _moment_(m, b1, g32 * (1 - b1))
            nu = _moment_(v, b2, g32.square().mul_(1 - b2))
            u = (mu / c1).mul_(-lr)                   # -lr * mu_hat
            u.div_((nu / c2).sqrt_().add_(eps))       # / (sqrt(nu_hat) + eps)
            if weight_decay:
                u.sub_(p.float() * (lr * weight_decay))
            return u

        updates = tree_map(one, grads, state.mu, state.nu,
                           params if params is not None else grads)
        return updates, AdamState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init, update)


def adamw(learning_rate, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          state_dtype=torch.float32) -> Optimizer:
    return adam(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                state_dtype=state_dtype)


def clip_by_global_norm(max_norm: float):
    """A gradient transform to apply before any ``update``: every leaf
    scaled by min(1, max_norm / (global L2 norm + 1e-9)), the norm in fp32
    on the device."""

    def clip(grads):
        norm = torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(grads)))
        scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
        return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)

    return clip
