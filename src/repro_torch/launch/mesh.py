"""Meshes (counterpart of ``repro.launch.mesh``).

A :class:`Mesh` is ordered axis names -> sizes and, for a concrete mesh,
the devices it spans; an *abstract* mesh has no devices.  Nothing here
starts a process group or moves a tensor: the port runs one process, and a
mesh only says how the sharding layer (``dist.sharding``) would lay arrays
out over it.

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

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: Optional[tuple[torch.device, ...]] = None  # None: abstract

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} against {self.axis_sizes}")
        if self.devices is not None and len(self.devices) != self.size:
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


def make_iru_mesh(n_partitions: int = 4, device=None) -> Mesh:
    """1-D ``("part",)`` mesh for the banked IRU engine's rows.

    Partitions shard over the ``part`` axis, so the axis size must divide
    ``n_partitions``; this picks the largest such device count present (on
    one card, the degenerate 1-device mesh).
    """
    devices = _devices(device)
    d = max(k for k in range(1, min(n_partitions, len(devices)) + 1)
            if n_partitions % k == 0)
    return Mesh(("part",), (d,), tuple(devices[:d]))


def make_graph_mesh(n_parts: int, device=None) -> Mesh:
    """1-D ``("gpart",)`` mesh for the edge-partitioned frontier pipeline:
    one graph shard per device, so exactly ``n_parts`` devices are needed
    (the port's partitioned pipeline steps all shards on one device and
    takes no mesh)."""
    devices = _devices(device)
    if len(devices) < n_parts:
        raise ValueError(
            f"make_graph_mesh: need {n_parts} devices for {n_parts} graph "
            f"shards, have {len(devices)}")
    return Mesh(("gpart",), (n_parts,), tuple(devices[:n_parts]))
