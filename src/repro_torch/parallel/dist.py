"""The process-group layer of the port's multi-device paths.

The reference drives every device of a mesh from one controller
(``jax.sharding``). The port runs one process per device
(``torch.distributed``), PyTorch's idiom for the same thing: every rank runs
the same host program on the same inputs, computes its own block, and a
collective hands every rank the global result, as ``np.asarray`` of a
sharded ``jax.Array`` does.

The caller initializes the process group and picks its backend: NCCL for
CUDA groups, gloo for CPU groups and for ranks that share one card (NCCL
refuses two ranks on one device). Nothing here switches backends or
catches a collective's error. A multi-card run starts one process per
card, e.g. ``torchrun --nproc-per-node D script.py`` around
``torch.distributed.init_process_group("nccl")``.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch
import torch.distributed as dist

from repro_torch.utils import DeviceLike, resolve_device

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Axis(NamedTuple):
    """One mesh dimension as this rank sees it: its process group, this
    rank's coordinate along it and its size."""

    group: dist.ProcessGroup
    rank: int
    size: int


def axis(mesh, dim: Union[str, int]) -> Axis:
    """The group, rank and world of ``mesh``'s dimension ``dim`` (a
    ``DeviceMesh`` and one of its dimension names or indices)."""
    group = mesh.get_group(dim)
    return Axis(group, mesh.get_local_rank(dim), dist.get_world_size(group))


def rank_device(device: DeviceLike = None) -> torch.device:
    """The device this rank runs on: ``device`` when given, else card
    ``rank % device_count`` (rank 0 without a process group). Raises when
    no card is visible and the caller did not ask for the CPU."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def all_gather0(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all) concatenated along dim 0 in
    the group's rank order, on every rank."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def all_reduce(t: torch.Tensor, op: str, group: dist.ProcessGroup
               ) -> torch.Tensor:
    """The elementwise ``op`` ("sum" or "max") of every rank's ``t``, on
    every rank (a new tensor; ``t`` is left as it is)."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def broadcast(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The group's first rank's ``t`` on every rank: that rank returns
    ``t`` itself, the others a new tensor (their ``t`` is left as it
    is)."""
    buf = (t.contiguous() if dist.get_rank(group) == 0
           else torch.empty_like(t, memory_format=torch.contiguous_format))
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return buf


def ring_exchange(t: torch.Tensor, group: dist.ProcessGroup
                  ) -> torch.Tensor:
    """Send ``t`` to the next rank of the ring ``(i, i + 1 mod P)`` and
    return what the previous rank sent (``jax.lax.ppermute`` over that
    ring): one paired send and receive. gloo's send and receive read and
    write host memory, so with a gloo group a CUDA tensor goes over the
    wire through an explicit copy to the host and back to its device."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if size == 1:
        return t.clone()
    host = t.is_cuda and dist.get_backend(group) == "gloo"
    send = (t.cpu() if host else t).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (rank + 1) % size), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (rank - 1) % size), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(t.device) if host else recv
