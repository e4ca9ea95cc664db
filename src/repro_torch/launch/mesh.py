"""Mesh construction over the ranks of a world.

The port of the JAX package's ``launch/mesh.py``.  ``make_production_mesh``
is the fixed entry point of a production run: 16x16 = 256 ranks (one
pod), 2x16x16 = 512 ranks multi-pod.  ``make_test_mesh`` is a small mesh
over however many ranks the world has.  Both build a ``DeviceMesh`` over
the first ranks of the world, in order, with the device type of the
world's backend (``parallel.collectives.mesh_device_type``), and raise
when the world is smaller than the mesh (a world that is not up counts as
one rank).

A tenant's mesh, placed by the hypervisor's topology mapper, is
``core.vmesh.allocate_tenant``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..parallel.collectives import mesh_device_type


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    return DeviceMesh(mesh_device_type(dist.get_backend()), ranks.tolist(),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if _world_size() < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, have "
                           f"{_world_size()}")
    return _make_mesh(shape, axes)


def make_test_mesh(shape: Tuple[int, ...] = (2, 4),
                   axes: Tuple[str, ...] = ("data", "model")) -> DeviceMesh:
    """Small mesh over however many ranks the world has."""
    n = int(np.prod(shape))
    if _world_size() < n:
        raise RuntimeError(f"need {n} ranks, have {_world_size()}")
    return _make_mesh(shape, axes)
