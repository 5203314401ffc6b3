"""Production meshes (port of ``repro.launch.mesh``): functions, not
module state, so importing this module touches no device or process
group.

Single pod: (16, 16) = (data, model), 256 ranks. Multi pod: (2, 16, 16) =
(pod, data, model), 512 ranks; ``pod`` composes with ``data`` for data
parallelism, or is the pipeline axis. One rank per device, in an
initialized process group (see :mod:`repro_torch.parallel.dist`).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.parallel.dist import rank_device
from repro_torch.utils import DeviceLike


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """The (16, 16) or (2, 16, 16) mesh over the first 256 / 512 ranks, on
    ``device``'s type (default: the card; raises without one). Raises
    ``RuntimeError`` naming the ranks needed and present when the process
    group is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    kind = rank_device(device).type
    need = math.prod(shape)
    if _world() < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, have {_world()}: start one "
            f"rank per device on real pods (torchrun), or build it under a "
            f"fake process group")
    return DeviceMesh(kind, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_smoke_mesh(device: DeviceLike = None) -> DeviceMesh:
    """Every rank of the process group on a (world, 1) (data, model) grid,
    on ``device``'s type (default: the card; raises without one), so smoke
    runs take the same sharded code paths."""
    kind = rank_device(device).type
    if not dist.is_initialized():
        raise RuntimeError("make_smoke_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    return DeviceMesh(kind, torch.arange(_world()).reshape(_world(), 1),
                      mesh_dim_names=("data", "model"))
