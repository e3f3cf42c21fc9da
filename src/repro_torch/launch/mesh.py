"""Device meshes over a ``torch.distributed`` world.

The reference builds XLA meshes of devices in one process; the port's
mesh is a ``DeviceMesh`` over the ranks of a process group that the caller
has already initialised (``torch.distributed.init_process_group`` with its
address, world size and rank).  Functions, not module-level constants, so
importing this module touches no process group.

Axis convention (``distributed/sharding.py``): ``pod`` the slow inter-pod
axis (data parallel only), ``data`` the data-parallel axis, ``model`` the
tensor / expert-parallel axis.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """The 16×16 (data, model) mesh, or 2×16×16 (pod, data, model); raises
    unless the world has exactly that many ranks."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if _world() != math.prod(shape):
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {math.prod(shape)} ranks; "
                           f"the world has {_world()}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(n_data: int | None = None, n_model: int = 1, *,
                   device: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the ranks there are (tests, local runs)."""
    n = _world()
    n_data = n_data if n_data is not None else n // n_model
    return init_device_mesh(device, (n_data, n_model), mesh_dim_names=("data", "model"))


def batch_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """The axes a global batch shards over (pod+data when present)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)
