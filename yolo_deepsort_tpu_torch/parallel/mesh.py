"""The stream mesh over ``torch.distributed`` (the port's counterpart of the
reference's one-axis ``jax.sharding.Mesh`` of ``make_stream_mesh``).

JAX shards one process's devices with ``Mesh`` and ``shard_map``; the port
runs one process (rank) per device instead, and each rank holds its
``S_loc = S_total / size`` streams: rank ``r``'s global stream indices are
``r * S_loc + arange(S_loc)``, what the reference's ``axis_index`` gives.

A mesh of one rank has no process group and its gathers are the identity.
A mesh of several ranks needs an initialized process group: NCCL when the
mesh's device is a CUDA card, gloo when it is the CPU. Every collective
takes ``mesh.group`` explicitly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """One axis of ``size`` ranks; this process is ``rank`` and computes on
    ``device``. ``group`` is None for a mesh of one rank."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device


def make_stream_mesh(n_devices: Optional[int] = None, axis: str = "stream",
                     device=None, group=None) -> StreamMesh:
    """The stream mesh of this process.

    * ``group`` given: the mesh is that group (``n_devices``, if given,
      must equal its size).
    * no ``group`` and ``n_devices == 1``: a mesh of one rank, with no
      group, whatever process group may be initialized.
    * no ``group``, ``n_devices`` None: the default process group if one is
      initialized, else a mesh of one rank.
    * more than one device and no initialized group: raises (there is no
      quiet fallback to one rank).

    ``device`` None means ``cuda:{local rank}`` (``LOCAL_RANK``, else the
    rank modulo the cards of the host; also for ``"cuda"`` without an
    index) and raises without a card; pass ``"cpu"`` for the CPU. A group
    must use NCCL on a card and gloo on the CPU. ``axis`` keeps the
    reference's signature: the mesh has one axis."""
    del axis
    if group is None and n_devices != 1 and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_stream_mesh({n_devices}): a mesh of more than one "
                "rank needs an initialized torch.distributed process group "
                "(one process per device)")
        rank, size = 0, 1
    else:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        if n_devices is not None and n_devices != size:
            raise ValueError(f"make_stream_mesh({n_devices}): the process "
                             f"group has {size} ranks")
    device = resolve_device(device)  # None: the card, raises without one
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    if group is not None:
        backend = dist.get_backend(group)
        if backend != _BACKEND.get(device.type):
            raise ValueError(f"a stream mesh on {device} takes a "
                             f"{_BACKEND.get(device.type)} process group, "
                             f"not {backend}")
    return StreamMesh(group=group, rank=rank, size=size, device=device)


def all_gather(mesh: StreamMesh, x: torch.Tensor,
               tiled: bool) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each), in rank order: concatenated
    on dim 0 with ``tiled`` (``jax.lax.all_gather(..., tiled=True)``),
    stacked on a new dim 0 without. One collective over ``mesh.group``;
    the identity on a mesh of one rank."""
    if mesh.group is None:
        return x if tiled else x[None]
    x = x.contiguous()
    out = torch.empty((mesh.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out if tiled else out.reshape(mesh.size, *x.shape)
