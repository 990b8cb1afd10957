"""Ravel/unravel for parameter trees of nested dicts and lists.

Counterpart of ``repro/utils/tree.py``. Leaves are taken in ``jax.tree``
order — dict keys sorted at every level, lists in index order — and not in
insertion order, so a raveled vector here is the same vector the reference
ravels (for the CNN: ``conv1/b, conv1/w, conv2/b, conv2/w, fc/b, fc/w,
out/b, out/w``; for an LM: ``embed``, ``final_norm``, then ``layers/0``,
``layers/1``, ... each with its ``sub0``, ``sub1``, ...). A path is a
tuple of dict keys (str) and list indices (int).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch

Tree = Union[Dict[str, Any], List[Any]]


def _children(tree):
    """(key, child) pairs of a dict (sorted keys) or list (index order);
    None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_paths(tree: Tree, prefix: Tuple = ()) -> List[Tuple]:
    """Leaf paths in ``jax.tree`` order (sorted keys, list indices, depth
    first)."""
    out: List[Tuple] = []
    for k, v in _children(tree):
        if _children(v) is None:
            out.append(prefix + (k,))
        else:
            out.extend(tree_paths(v, prefix + (k,)))
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    out = []
    for path in tree_paths(tree):
        v = tree
        for k in path:
            v = v[k]
        out.append(v)
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over matching leaves of one or more trees of the same
    structure; returns a tree of that structure (lists stay lists, tuples
    and NamedTuples such as an optimizer's state keep their type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def _unflatten(paths, leaves) -> Tree:
    """The tree whose leaves sit at ``paths``: a level keyed by ints is a
    list, any other a dict."""
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    groups: Dict[Any, Tuple[list, list]] = {}
    for path, leaf in zip(paths, leaves):
        sub_paths, sub_leaves = groups.setdefault(path[0], ([], []))
        sub_paths.append(path[1:])
        sub_leaves.append(leaf)
    if all(isinstance(k, int) for k in groups):
        return [_unflatten(*groups[i]) for i in range(len(groups))]
    return {k: _unflatten(*g) for k, g in groups.items()}


class TreeSpec(NamedTuple):
    """Static recipe for rebuilding a tree from its raveled vector."""

    paths: Tuple[Tuple, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]

    @property
    def sizes(self) -> Tuple[int, ...]:
        out = []
        for s in self.shapes:
            n = 1
            for d in s:
                n *= d
            out.append(n)
        return tuple(out)

    @property
    def total_size(self) -> int:
        return sum(self.sizes)


def tree_ravel(tree: Tree):
    """(N,) vector of all leaves in ``jax.tree`` order, and its spec.
    Mixed leaf dtypes concatenate to their promotion."""
    paths = tuple(tree_paths(tree))
    leaves = tree_leaves(tree)
    spec = TreeSpec(paths, tuple(tuple(l.shape) for l in leaves),
                    tuple(l.dtype for l in leaves))
    return torch.cat([l.reshape(-1) for l in leaves]), spec


def tree_ravel_stacked(stacked: Tree):
    """(K, N) rows of a tree whose leaves carry a leading stack axis, and
    the spec of the UNSTACKED tree — the adapter between parameter trees
    and the (K, N) layout of ``fedavg_aggregate``."""
    paths = tuple(tree_paths(stacked))
    leaves = tree_leaves(stacked)
    if not leaves:
        raise ValueError(
            "tree_ravel_stacked needs at least one leaf: the stacked (K) "
            "axis is read from the leaves"
        )
    K = leaves[0].shape[0]
    spec = TreeSpec(paths, tuple(tuple(l.shape[1:]) for l in leaves),
                    tuple(l.dtype for l in leaves))
    return torch.cat([l.reshape(K, -1) for l in leaves], dim=1), spec


def tree_unravel(spec: TreeSpec, flat: torch.Tensor) -> Tree:
    """Inverse of ``tree_ravel``: each leaf is reshaped and cast back to
    its recorded dtype."""
    out, off = [], 0
    for shape, dtype, n in zip(spec.shapes, spec.dtypes, spec.sizes):
        out.append(flat[off:off + n].reshape(shape).to(dtype))
        off += n
    return _unflatten(spec.paths, out)


def tree_unravel_stacked(spec: TreeSpec, flat: torch.Tensor) -> Tree:
    """Inverse of ``tree_ravel_stacked``: (K, N) rows back to a tree whose
    leaves carry the leading K axis, each cast to its recorded dtype."""
    K = flat.shape[0]
    out, off = [], 0
    for shape, dtype, n in zip(spec.shapes, spec.dtypes, spec.sizes):
        out.append(flat[:, off:off + n].reshape((K,) + tuple(shape)).to(dtype))
        off += n
    return _unflatten(spec.paths, out)

