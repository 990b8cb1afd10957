"""FedAvg rounds of the LM substrate (counterpart of ``repro/core/local_sgd.py``).

Each client group holds its own replica of the parameters as the leading
axis of every leaf, as in the reference:

    params leaves: (G, ...)   one replica per client group
    optimizer state leaves: (G, ...), the step (G,)

A round is Algorithm 1 at LM scale: every group takes H local optimizer
steps on its own batches, then the groups are weighted-averaged (the server
line, through ``fedavg_aggregate``, one launch per leaf) and the average is
written back into every replica. ``build_fedsgd_train_step`` is the
baseline: one model, one optimizer step per batch.

The reference maps G onto a mesh axis and ``vmap``s the groups. On one card
the groups run one after another, so one group's activations are alive at
a time: per group the step takes detached views of its replica, marks them
``requires_grad_``, takes ``torch.autograd.grad`` of the loss, and updates
the replica, and the optimizer state, in place, leaf by leaf. Each leaf's
gradient is released as soon as its update is written, so the gradients and
the fp32 updates of a 2.5B-parameter replica are never all alive at once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.engine import RoundBatch, RoundState
from repro_torch.kernels.ops import tree_weighted_mean
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    num_groups: int          # G: client groups participating
    local_steps: int         # H: local optimizer steps per round (paper's u)


def replicate_for_groups(params, num_groups: int):
    """Per-group replicas of the global params: leaf (...) -> (G, ...). A
    real copy (not a stride-0 view): each replica is written in place."""
    return tree_map(lambda x: x.unsqueeze(0).expand((num_groups,) + tuple(x.shape))
                    .contiguous(), params)


def unreplicate_at(params_g, gi: int):
    """Group ``gi``'s replica, as views."""
    return tree_map(lambda x: x[gi], params_g)


def unreplicate(params_g):
    """Group 0's replica, as views."""
    return unreplicate_at(params_g, 0)


def init_group_states(opt: Optimizer, params_g):
    """The reference's ``jax.vmap(opt.init)(params_g)``: the state of every
    group stacked on the leading axis, the step a (G,) int32 tensor. Built
    from the stacked params at once, so no second copy of the moments is
    ever made."""
    state = opt.init(params_g)
    G = tree_leaves(params_g)[0].shape[0]
    return state._replace(step=torch.zeros(G, dtype=torch.int32, device=state.step.device))


def _update_in_place(opt: Optimizer, leaves, grads, state):
    """``opt.update`` and ``apply_updates`` leaf by leaf, written into
    ``leaves`` and into ``state``'s tensors in place. The optimizers are
    leafwise but for their step, which every leaf's update reads alike.
    ``grads`` (a list) is emptied as it goes. Returns the new step."""
    fields = [f for f in state._fields if f != "step"]
    per_field = {f: tree_leaves(getattr(state, f)) for f in fields}
    step = state.step
    for i, leaf in enumerate(leaves):
        sub = state._replace(**{f: [per_field[f][i]] for f in fields})
        (u,), new = opt.update([grads[i]], sub, [leaf])
        grads[i] = None
        leaf.copy_(apply_updates(leaf, u))
        del u
        for f in fields:
            src, dst = getattr(new, f)[0], per_field[f][i]
            if src is not dst:
                dst.copy_(src)
        step = new.step
    return step


def _train_step_in_place(loss_fn, opt, params, state, batch):
    """One optimizer step on ``params`` (a tree of tensors, updated in
    place) and ``state``: (loss, aux, new step). The update runs inside the
    ``torch.profiler`` range ``optimizer_update``, so a trace shows what it
    costs. A leaf the loss does not reach (the vision stub's embedding
    table: its batches bring embeddings, no token ids) takes a zero
    gradient, as ``jax.grad`` gives it in the reference, and the optimizer
    steps it alike."""
    p = tree_map(lambda a: a.detach().requires_grad_(), params)
    leaves = tree_leaves(p)
    loss, aux = loss_fn(p, batch)
    grads = list(torch.autograd.grad(loss, leaves, materialize_grads=True))
    with torch.no_grad(), torch.profiler.record_function("optimizer_update"):
        step = _update_in_place(opt, leaves, grads, state)
    return loss.detach(), aux, step


def build_fedavg_round_step(
    loss_fn: Callable,
    inner_opt: Optimizer,
    cfg: LocalSGDConfig,
    outer_opt: Optional[Optimizer] = None,
):
    """Returns round_step(params_g, inner_state_g, outer_state, batches,
    group_weights) -> (params_g, inner_state_g, outer_state, metrics).

    ``batches``: tree with leaves (H, G, ...) — H local steps of per-group
    data. ``group_weights``: (G,) raw example counts n_k (normalized inside).
    ``params_g`` and ``inner_state_g`` are updated in place and returned."""

    def round_step(params_g, inner_state_g, outer_state, batches, group_weights):
        prev_global = (tree_map(lambda x: x[0].clone(), params_g)
                       if outer_opt is not None else None)
        losses = []
        for h in range(cfg.local_steps):
            per_group = []
            for gi in range(cfg.num_groups):
                state = tree_map(lambda a: a[gi], inner_state_g)
                loss, _, step = _train_step_in_place(
                    loss_fn, inner_opt, unreplicate_at(params_g, gi), state,
                    tree_map(lambda a: a[h, gi], batches))
                inner_state_g.step[gi] = step
                per_group.append(loss)
            losses.append(torch.stack(per_group).mean())
        with torch.no_grad():
            avg = tree_weighted_mean(params_g, group_weights)
            if outer_opt is not None:
                # pseudo-gradient Delta = w_t - avg; server update w_{t+1} = w_t + opt(Delta)
                delta = tree_map(lambda a, b: (b - a).float(), avg, prev_global)
                updates, outer_state = outer_opt.update(delta, outer_state, prev_global)
                new_global = apply_updates(prev_global, updates)
            else:
                new_global = avg
            for leaf, g in zip(tree_leaves(params_g), tree_leaves(new_global)):
                leaf.copy_(g.unsqueeze(0).expand_as(leaf))
        return params_g, inner_state_g, outer_state, {"loss": torch.stack(losses).mean()}

    return round_step


def as_round_step(
    loss_fn: Callable,
    inner_opt: Optimizer,
    cfg: LocalSGDConfig,
    outer_opt: Optional[Optimizer] = None,
):
    """The round through the engine's ``(state, batch) -> (state, metrics)``
    protocol: ``state.params`` carries the (G, ...) replicas,
    ``state.inner_state``/``state.outer_state`` the optimizer states;
    ``batch.data`` leaves are (H, G, ...), ``batch.client_weights`` the raw
    per-group counts (``batch.step_mask`` is unused: local steps are never
    padded here)."""
    step = build_fedavg_round_step(loss_fn, inner_opt, cfg, outer_opt=outer_opt)

    def round_step(state: RoundState, rb: RoundBatch):
        params_g, inner_g, outer, metrics = step(
            state.params, state.inner_state, state.outer_state, rb.data, rb.client_weights)
        return RoundState(params_g, outer_state=outer, inner_state=inner_g), metrics

    return round_step


def build_fedsgd_train_step(loss_fn: Callable, opt: Optimizer):
    """The baseline: one global model, one optimizer step per batch.
    ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    params and the state's tensors are updated in place and returned."""

    def train_step(params, opt_state, batch):
        loss, aux, step = _train_step_in_place(loss_fn, opt, params, opt_state, batch)
        metrics = {"loss": loss}
        metrics.update({k: v.detach() if torch.is_tensor(v) else v
                        for k, v in (aux or {}).items()})
        return params, opt_state._replace(step=step), metrics

    return train_step
