"""Carry parameter trees across between numpy (the reference's ``init``
output or a gossip engine's replica stack, ``np.asarray``-ed) and the
port's dicts of tensors."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths


def _checked(tree, model, lead, device):
    """``tree`` as tensors on ``device`` after checking its keys, and each
    leaf's dtype and shape (``lead`` + the model's), against ``model.init``'s
    tree; a mismatch raises naming the leaf."""
    dev = resolve_device(device)
    want = model.init(0)
    got_paths, want_paths = tree_paths(tree), tree_paths(want)
    if got_paths != want_paths:
        raise ValueError(
            f"parameter keys differ from the model's: got {got_paths}, "
            f"want {want_paths}"
        )
    out = tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)
    for path, a, w in zip(want_paths, tree_leaves(out), tree_leaves(want)):
        if a.shape != lead + w.shape:
            raise ValueError(
                f"{'/'.join(path)}: shape {tuple(a.shape)} != "
                f"{tuple(lead + w.shape)} (the model's with the leading axes {tuple(lead)})"
            )
        if a.dtype != w.dtype:
            raise ValueError(f"{'/'.join(path)}: dtype {a.dtype} != model's {w.dtype}")
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


def params_to_numpy(params):
    """Nested dict of numpy arrays (host copies) from the port's params."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
