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

The training mesh (``TrainMesh``, the reference's ``Mesh(devices.reshape(dp,
mp), ("dp", "mp"))``) lays its ranks out in the same order: rank ``dp_rank
* mp + mp_rank``. Each axis has a group of its own, or None where it holds
one rank; its collectives are in ``parallel/collectives.py``.
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
    device = _rank_device(device, rank)
    _check_backend(group, device)
    return StreamMesh(group=group, rank=rank, size=size, device=device)


def _rank_device(device, rank: int) -> torch.device:
    """``device`` resolved; None or ``"cuda"`` without an index is this
    rank's card, ``cuda:{LOCAL_RANK}`` (else the rank modulo the host's
    cards), and raises without one."""
    device = resolve_device(device)  # None: the card, raises without one
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    return device


def _check_backend(group, device: torch.device) -> None:
    """A group on a card must be NCCL, one on the CPU gloo."""
    if group is None:
        return
    backend = dist.get_backend(group)
    if backend != _BACKEND.get(device.type):
        raise ValueError(f"a mesh on {device} takes a "
                         f"{_BACKEND.get(device.type)} process group, "
                         f"not {backend}")


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


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """The training mesh of this process: rank ``dp_rank * mp + mp_rank``
    of ``dp * mp``, computing on ``device``. ``dp_group`` joins the ranks
    of one mp index (other images, the same slice of the ReID head);
    ``mp_group`` the ranks of one dp index (the same images, the other
    slices). An axis of one rank has no group, unless it spans the whole
    process group: a one-rank job's axes are that group, so its
    collectives run for real."""

    dp_group: Optional[dist.ProcessGroup]
    mp_group: Optional[dist.ProcessGroup]
    dp_rank: int
    mp_rank: int
    dp: int
    mp: int
    device: torch.device


def make_train_mesh(dp: Optional[int] = None, mp: int = 1, device=None,
                    group=None) -> TrainMesh:
    """The ``dp`` x ``mp`` training mesh of this process.

    * ``group`` given: the mesh spans that group; ``dp * mp`` must equal
      its size (``dp`` None: its size over ``mp``).
    * no ``group`` and ``dp * mp == 1``: a mesh of one rank with no group,
      whatever process group may be initialized.
    * no ``group`` otherwise: the default process group if one is
      initialized; more than one rank with none raises (there is no quiet
      fallback to fewer ranks).

    ``device`` as in ``make_stream_mesh``: None is this rank's card and
    raises without one; a group must use NCCL on a card and gloo on the
    CPU."""
    if mp < 1 or (dp is not None and dp < 1):
        raise ValueError(f"make_train_mesh(dp={dp}, mp={mp}): axes hold at "
                         "least one rank")
    if group is None and dist.is_initialized() and (dp is None
                                                    or dp * mp > 1):
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    if dp is None:
        if world % mp:
            raise ValueError(f"make_train_mesh(mp={mp}): mp does not divide "
                             f"the {world} ranks")
        dp = world // mp
    if dp * mp != world:
        if group is None:
            raise ValueError(
                f"make_train_mesh({dp}, {mp}): a mesh of more than one rank "
                "needs an initialized torch.distributed process group (one "
                "process per device)")
        raise ValueError(f"make_train_mesh({dp}, {mp}): {dp * mp} ranks, but "
                         f"the process group has {world}")
    device = _rank_device(device, rank)
    _check_backend(group, device)
    dp_rank, mp_rank = divmod(rank, mp)
    dp_group = mp_group = None
    if group is not None:
        ranks = dist.get_process_group_ranks(group)  # global, in group order
        # new_group is a collective of the whole job: EVERY rank creates
        # EVERY subgroup, in the same order, the ones it is not in included.
        # A rank that skips one, or creates them in another order, deadlocks
        # gloo (and NCCL) at the next collective.
        if mp == world:
            mp_group = group
        elif mp > 1:
            for d in range(dp):
                g = dist.new_group([ranks[d * mp + m] for m in range(mp)])
                if d == dp_rank:
                    mp_group = g
        if dp == world:
            dp_group = group
        elif dp > 1:
            for m in range(mp):
                g = dist.new_group([ranks[d * mp + m] for d in range(dp)])
                if m == mp_rank:
                    dp_group = g
    return TrainMesh(dp_group=dp_group, mp_group=mp_group, dp_rank=dp_rank,
                     mp_rank=mp_rank, dp=dp, mp=mp, device=device)
