"""Checkpoints in the reference's layout (counterpart of
``repro/checkpoint/io.py``), so checkpoints move between the two packages
with no converter::

    <dir>/step_<N:08d>/
        index.msgpack   step, leaf names, shapes, dtypes, metadata
        arrays.npz      one entry per leaf, named by its path

A leaf's name is its path in ``jax.tree`` order (dict keys sorted, list
indices), joined by ``/``: ``params/fc1/b``, ``strategy_state/out/w``,
``layers/0/...``. numpy has no bfloat16, so a bf16 leaf is stored as its
``uint16`` bit pattern and recorded as ``"bfloat16"``, as the reference
stores it. The index is written with ``msgpack_lite``, byte for byte what
``msgpack.packb`` writes.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite
from repro_torch.utils.tree import tree_leaves, tree_paths


def _named(tree):
    """(name, leaf) pairs in ``jax.tree`` order."""
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in zip(tree_paths(tree), tree_leaves(tree))]


def _to_host(leaf):
    """(array as stored in the npz, its recorded dtype name)."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, recorded: str) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if recorded == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rebuild(tree_like, leaf_at, path=()):
    """``tree_like``'s structure (dict, list, tuple, NamedTuple, and empty
    nodes such as a stateless strategy's ``()``) with the leaf at each path
    taken from ``leaf_at``."""
    if isinstance(tree_like, dict):
        return {k: _rebuild(v, leaf_at, path + (k,)) for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        out = [_rebuild(v, leaf_at, path + (i,)) for i, v in enumerate(tree_like)]
        if isinstance(tree_like, list):
            return out
        return type(tree_like)(*out) if hasattr(tree_like, "_fields") else tuple(out)
    return leaf_at[path]


def _step_dir(ckpt_dir, step: Optional[int]) -> Path:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return Path(ckpt_dir) / f"step_{step:08d}"


def save_checkpoint(ckpt_dir, tree, *, step: int, metadata: Optional[dict] = None) -> str:
    """Write ``tree`` (nested dicts/lists of tensors) and ``metadata`` as
    checkpoint ``step``; returns the step's directory."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    named = [(name, _to_host(leaf)) for name, leaf in _named(tree)]
    np.savez(d / "arrays.npz", **{name: a for name, (a, _) in named})
    index = {
        "step": step,
        "names": [n for n, _ in named],
        "shapes": [list(a.shape) for _, (a, _) in named],
        "dtypes": [dt for _, (_, dt) in named],
        "metadata": metadata or {},
    }
    (d / "index.msgpack").write_bytes(msgpack_lite.packb(index))
    return str(d)


def restore_checkpoint(ckpt_dir, tree_like, *, step: Optional[int] = None):
    """``(tree, metadata)``: the checkpoint's leaves in the structure of
    ``tree_like``, each on that leaf's device in its dtype. The names and
    shapes must match ``tree_like``'s; a mismatch raises before anything is
    returned. ``step=None`` takes the latest."""
    d = _step_dir(ckpt_dir, step)
    index = msgpack_lite.unpackb((d / "index.msgpack").read_bytes())
    named = _named(tree_like)
    names = [n for n, _ in named]
    if names != index["names"]:
        raise ValueError(
            f"checkpoint tree structure mismatch: the checkpoint holds {index['names']}, "
            f"the tree has {names}"
        )
    host = []
    with np.load(d / "arrays.npz") as data:
        for (name, ref), recorded in zip(named, index["dtypes"]):
            t = _from_host(data[name], recorded)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {name}: shape {tuple(t.shape)}, the tree's "
                                 f"{tuple(ref.shape)}")
            host.append(t)
    leaf_at = {path: t.to(device=ref.device, dtype=ref.dtype)
               for path, t, (_, ref) in zip(tree_paths(tree_like), host, named)}
    return _rebuild(tree_like, leaf_at), index["metadata"]


def peek_metadata(ckpt_dir, *, step: Optional[int] = None) -> dict:
    """Only a checkpoint's metadata, no arrays: for guards that must be
    able to refuse before any state changes."""
    d = _step_dir(ckpt_dir, step)
    return msgpack_lite.unpackb((d / "index.msgpack").read_bytes())["metadata"]


def latest_step(ckpt_dir) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in base.glob("step_*") if p.is_dir())
    return steps[-1] if steps else None
