"""Carry parameter trees across between numpy (the reference's ``init``
output, a gossip engine's replica stack or an LM round's (G, ...) group
replicas, ``np.asarray``-ed) and the port's trees of tensors (nested dicts,
and for an LM the list of stacked segments under ``layers``); and an
optimizer state, per model or per group.

``np.asarray`` of a JAX bf16 array is an ``ml_dtypes.bfloat16`` array,
which ``torch.from_numpy`` refuses: it crosses as its uint16 bit pattern
and is viewed back as ``torch.bfloat16``, so no bit changes."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _model_leaves(model):
    """The tree of leaves the model states: ``param_shapes()`` where the
    model has it (an LM states its shapes on the ``meta`` device and
    allocates nothing), else its ``init``'s tree."""
    if hasattr(model, "param_shapes"):
        return model.param_shapes()
    return model.init(0)


def _checked(tree, model, lead, device):
    """``tree`` as tensors on ``device`` after checking its keys, and each
    leaf's dtype and shape (``lead`` + the model's), against the model's
    stated tree; a mismatch raises naming the leaf."""
    dev = resolve_device(device)
    want = _model_leaves(model)
    got_paths, want_paths = tree_paths(tree), tree_paths(want)
    if got_paths != want_paths:
        raise ValueError(
            f"parameter keys differ from the model's: got {got_paths}, "
            f"want {want_paths}"
        )
    out = tree_map(_tensor, tree)
    for path, a, w in zip(want_paths, tree_leaves(out), tree_leaves(want)):
        name = "/".join(map(str, path))
        if a.shape != lead + w.shape:
            raise ValueError(
                f"{name}: shape {tuple(a.shape)} != "
                f"{tuple(lead + w.shape)} (the model's with the leading axes {tuple(lead)})"
            )
        if a.dtype != w.dtype:
            raise ValueError(f"{name}: dtype {a.dtype} != model's {w.dtype}")
    return tree_map(lambda a: a.to(dev), out)


def params_from_numpy(tree, model, device="cuda"):
    """The port's params for ``model`` from a nested dict of numpy arrays.

    Keys, shapes and dtypes are checked against ``model.init``'s tree;
    a mismatch raises naming the leaf."""
    return _checked(tree, model, torch.Size(), device)


def replicas_from_numpy(tree, model, device="cuda"):
    """The port's (n_nodes, ...) replica stack from a reference gossip
    engine's, as a nested dict of numpy arrays: every leaf must be the
    model's leaf with one leading node axis, the same length everywhere.
    This starts the port's gossip lane from a reference state."""
    leaves = tree_leaves(tree)
    if not leaves or np.ndim(leaves[0]) < 1:
        raise ValueError("a replica stack needs leaves with a leading node axis")
    return _checked(tree, model, torch.Size([np.shape(leaves[0])[0]]), device)


def opt_state_from_numpy(state, state_type, device="cuda"):
    """The port's optimizer state of ``state_type`` (``optim.AdamState``,
    ``MomentumState`` or ``SGDState``) from a reference state whose fields,
    matched by name, are numpy arrays or trees of them: one model's state, or
    a per-group (G, ...) stack with a (G,) step, as the reference's
    ``jax.vmap(opt.init)`` and its FedAvg round carry it."""
    dev = resolve_device(device)
    return state_type(**{f: tree_map(lambda a: _tensor(a).to(dev), getattr(state, f))
                         for f in state_type._fields})


def params_to_numpy(params):
    """Tree of numpy arrays (host copies) from the port's params. numpy has
    no bf16, so bf16 leaves come out as float32, which holds them exactly."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(host, params)
