"""The device mesh a sharded index spreads its slots over.

The index's one scale axis is its slots; it shards as data parallelism
over a 1-D mesh. Queries are replicated to every shard, each shard scans
its own block, and the shards' top-k lists merge on the first device
(see `lshrs_tpu_torch.parallel.sharded`), so the merge moves
``O(n_shards * k)`` values per query whatever the index size.

The mesh is a tuple of ``torch.device`` and an axis name: one process
holds every shard's tensors and drives them, as the reference's single
controller drives its ``jax.sharding.Mesh``. No process group is made.
A device may repeat: one card can stand in for several shards, as the
CPU does in the tests.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import NamedTuple, Optional

import torch

SHARD_AXIS = "shard"

# The CPU stands in for this many shard devices, as the reference's test
# host exposes 8 virtual CPU devices to JAX.
CPU_STANDIN_DEVICES = 8

__all__ = ["SHARD_AXIS", "Mesh", "available_devices", "make_mesh"]


class Mesh(NamedTuple):
    """A 1-D mesh: one device per shard, in shard order."""

    devices: tuple[torch.device, ...]
    axis_name: str = SHARD_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def available_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """The devices a mesh may take for ``device``'s kind: every CUDA card
    (``cuda:0`` .. ``cuda:n-1``), or ``CPU_STANDIN_DEVICES`` copies of the
    CPU. Restoring a sharded checkpoint reads it to decide whether the
    shards fit."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device] * CPU_STANDIN_DEVICES


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    devices: Optional[Sequence[str | torch.device]] = None,
    axis_name: str = SHARD_AXIS,
) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` (default: all) of
    ``devices`` (default: every CUDA card)."""
    if devices is None:
        devices = available_devices("cuda")
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"Requested {n_devices} devices but only {len(devices)} available"
            )
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices), axis_name)
