"""Meshes (counterpart of ``repro.launch.mesh``).

A :class:`Mesh` is ordered axis names -> sizes and, for a concrete mesh,
the devices it spans; an *abstract* mesh has no devices.  A *group* mesh
is 1-D over the ranks of a ``torch.distributed`` process group, one shard
a rank: it carries the group and this rank's device.  Nothing here starts
a process group or moves a tensor: a mesh says how the sharding layer
(``dist.sharding``) would lay arrays out over it, and a group mesh which
ranks the partitioned pipeline (``dist.graph_partition``) and the
expert-parallel MoE (``moe.ep``) run over.

The production meshes keep the reference's shapes, (16, 16) over
("data", "model") and (2, 16, 16) over ("pod", "data", "model"), so every
dry-run record compares cell by cell with the reference's.  They are
abstract: one process cannot hold 256 cards, where the reference forces
512 host devices instead.  The other constructors span the devices
present: the card by default (raising without one), or the CPU when asked.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import rank_device, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: Optional[tuple[torch.device, ...]] = None  # None: abstract
    # a group mesh: one rank a shard; ``devices`` is then this rank's alone
    group: Optional[dist.ProcessGroup] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} against {self.axis_sizes}")
        if self.group is not None:
            if len(self.axis_sizes) != 1 or self.devices is None or len(
                    self.devices) != 1:
                raise ValueError("a group mesh is 1-D and names this rank's "
                                 "device alone")
        elif self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a {self.axis_sizes} mesh needs {self.size} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``'s)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def _devices(device) -> list[torch.device]:
    """The devices present of ``device``'s kind (``None``: the card)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16x16 pod (2 pods: 2x16x16), abstract."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device=None) -> Mesh:
    """(1, 1) over ("data", "model") on one device: the card unless
    ``device`` says otherwise."""
    return Mesh(("data", "model"), (1, 1), (_devices(device)[0],))


def _group_mesh(axis: str, group, device) -> Mesh:
    """A 1-D mesh over the ranks of ``group`` (``"world"``: the default
    group), on this rank's device (:func:`rank_device`).  NCCL needs one
    card a rank: a group whose ranks share one raises."""
    dev = rank_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a group mesh needs a process group, and torch.distributed is "
            "not initialized: call torch.distributed.init_process_group("
            "backend, init_method=..., rank=..., world_size=..., "
            "timeout=...) first")
    if isinstance(group, str):
        if group != "world":
            raise ValueError(f"group must be a ProcessGroup or 'world', got "
                             f"{group!r}")
        group = dist.group.WORLD
    if dist.get_backend(group) == "nccl":
        _refuse_shared_card(group, dev)
    return Mesh((axis,), (dist.get_world_size(group),), (dev,), group)


def _refuse_shared_card(group, dev: torch.device) -> None:
    """Raise if another rank of ``group`` runs on this rank's card: NCCL
    refuses two ranks on one device ("invalid usage" at the first
    collective).  Each rank posts its card's UUID to the group's store and
    reads its peers'; no collective runs."""
    if dev.type != "cuda":
        raise ValueError(f"an NCCL group moves CUDA tensors; this rank's "
                         f"device is {dev}")
    store = dist.distributed_c10d._get_default_store()
    me = dist.get_rank()
    uuid = str(torch.cuda.get_device_properties(dev).uuid)
    store.set(f"repro_torch/card/{me}", uuid)
    peers = [r for r in dist.get_process_group_ranks(group) if r != me
             and store.get(f"repro_torch/card/{r}").decode() == uuid]
    if peers:
        raise RuntimeError(
            f"NCCL needs one card per rank: rank {me} shares "
            f"{torch.cuda.get_device_name(dev)} ({dev}, {uuid}) with ranks "
            f"{peers}; run ranks that share a card over gloo")


def make_iru_mesh(n_partitions: int = 4, device=None, *,
                  group=None) -> Mesh:
    """1-D ``("part",)`` mesh for the banked IRU engine's rows.

    Partitions shard over the ``part`` axis, so the axis size must divide
    ``n_partitions``; this picks the largest such device count present (on
    one card, the degenerate 1-device mesh).  With ``group`` (a process
    group, or ``"world"``) the axis spans its ranks instead, one block of
    partitions a rank (``moe.ep.moe_hash_ep``'s group mode).
    """
    if group is not None:
        mesh = _group_mesh("part", group, device)
        if n_partitions % mesh.size != 0:
            raise ValueError(
                f"make_iru_mesh: {mesh.size} ranks do not divide "
                f"{n_partitions} partitions")
        return mesh
    devices = _devices(device)
    d = max(k for k in range(1, min(n_partitions, len(devices)) + 1)
            if n_partitions % k == 0)
    return Mesh(("part",), (d,), tuple(devices[:d]))


def make_graph_mesh(n_parts: int, device=None, *, group=None) -> Mesh:
    """1-D ``("gpart",)`` mesh for the edge-partitioned frontier pipeline:
    one graph shard per device, so exactly ``n_parts`` devices are needed.

    The pipeline takes a group mesh, ``group`` a process group of
    ``n_parts`` ranks (or ``"world"``): one shard a rank, on this rank's
    ``device`` (default ``cuda:{LOCAL_RANK % device_count()}``).  Without a
    group it steps every shard on one device and takes no mesh; the
    device-list mesh here is the reference's shape only.
    """
    if group is not None:
        mesh = _group_mesh("gpart", group, device)
        if mesh.size != n_parts:
            raise ValueError(
                f"make_graph_mesh: need {n_parts} ranks for {n_parts} graph "
                f"shards, the group has {mesh.size}")
        return mesh
    devices = _devices(device)
    if len(devices) < n_parts:
        raise ValueError(
            f"make_graph_mesh: need {n_parts} devices for {n_parts} graph "
            f"shards, have {len(devices)}")
    return Mesh(("gpart",), (n_parts,), tuple(devices[:n_parts]))
