"""Device meshes (``repro/launch/mesh.py``) as
``torch.distributed.device_mesh.DeviceMesh`` over the running world.

Kept as functions, never module-level meshes, so importing this module
touches no process group.  Nothing on a machine tells a program of its
cluster: the caller starts the world (``torch.distributed.
init_process_group`` with its address, world size and rank; the CPU
tests use one ``gloo`` process on a ``FileStore``).  A mesh covers the
first ranks of the world in row-major order.  ``device=None`` means the
card and raises without one; a CPU mesh is built only when the caller
asks for it (``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..kernels.common import DeviceLike, resolve_device


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
               device: DeviceLike):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed world: call "
                           "init_process_group before building a mesh")
    need, have = math.prod(shape), dist.get_world_size()
    if need > have:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {need} "
                         f"devices, have {have}")
    return DeviceMesh(device.type, torch.arange(need).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The grading mesh: 16x16 = 256 devices per pod; 2 pods = 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: DeviceLike = None):
    """Arbitrary mesh (tests use small meshes, e.g. (2, 4))."""
    return _make_mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, device: DeviceLike = None):
    """A (data, model) mesh over the running world."""
    return _make_mesh((data, model), ("data", "model"), device)
