"""The client mesh of cohort sharding (counterpart of
``repro/launch/mesh.py::make_client_mesh``).

The reference's mesh is one axis over JAX devices, and ``shard_map`` runs a
round's m/D clients on each. Here the mesh is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a process
group: every rank is a process that builds the same ``RoundEngine(mesh=)``
and runs its slice of each cohort, and an ``all_reduce`` takes the place of
the ``psum``. The reference's production meshes and TPU roofline constants
have no counterpart here (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_client_mesh"]


def make_client_mesh(num_devices: Optional[int] = None, axis: str = "clients",
                     device: str = "cuda") -> DeviceMesh:
    """A 1-D client mesh named ``axis`` over the process group's world, for
    ``RoundEngine(mesh=...)``: NCCL on ``device="cuda"``, gloo on the CPU.

    With no process group up, this process starts a world of one from a
    ``FileStore`` in a fresh temporary directory (no TCP port), under the
    backend of ``device``; an NCCL world binds ``cuda:0``. With a group up
    (a launcher's, or ``init_process_group`` with its own store, rank and
    world size), the mesh spans its world, whose backend it keeps: a gloo
    world on CUDA tensors copies every all-reduce through host memory.
    ``num_devices`` must then be the world size (None takes it), since every
    rank of the world runs a slice of every cohort."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"make_client_mesh builds a 'cuda' or 'cpu' mesh, not {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_client_mesh(device='cuda') was asked for but "
                           "torch.cuda.is_available() is False; pass device='cpu'")
    if not dist.is_initialized():
        fd, path = tempfile.mkstemp(prefix="repro_torch_client_mesh_")
        os.close(fd)
        os.unlink(path)          # the FileStore makes it
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                 store=dist.FileStore(path, 1), rank=0, world_size=1)
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if n != world:
        raise ValueError(f"a client mesh spans the process group's whole world of {world} "
                         f"rank(s), got num_devices={num_devices}")
    return init_device_mesh(device, (n,), mesh_dim_names=(axis,))
