"""Ravel/unravel for nested-dict parameter trees.

Counterpart of ``repro/utils/tree.py``. Leaves are taken in ``jax.tree``
order — dict keys sorted at every level — and not in insertion order, so a
raveled vector here is the same vector the reference ravels (for the CNN:
``conv1/b, conv1/w, conv2/b, conv2/w, fc/b, fc/w, out/b, out/w``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

Tree = Dict[str, Any]


def tree_paths(tree: Tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """Leaf paths in ``jax.tree`` order (sorted keys, depth first)."""
    out: List[Tuple[str, ...]] = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tree_paths(v, prefix + (k,)))
        else:
            out.append(prefix + (k,))
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
    structure; returns a tree of that structure."""
    return {
        k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)))
        for k, v in tree.items()
    }


def _unflatten(paths, leaves) -> Tree:
    out: Tree = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


class TreeSpec(NamedTuple):
    """Static recipe for rebuilding a tree from its raveled vector."""

    paths: Tuple[Tuple[str, ...], ...]
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
