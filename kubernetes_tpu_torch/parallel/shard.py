"""The device mesh of the port's sharded drivers, and its collectives.

What `jax.sharding.Mesh` and `shard_map` give the JAX package's mesh
bodies (kubernetes_tpu/parallel/mesh.py), for the port's single
controller: one Python process drives every shard, and each shard's
tables are tensors on that shard's device.

- DeviceMesh: an ordered tuple of torch devices on the one axis "nodes".
  A device may repeat. torch has a single "cpu" device, so the CPU tests
  run a mesh of eight shards on it, as JAX's tests run eight virtual CPU
  devices; a host with one card runs a mesh of four shards on cuda:0,
  which still runs every shard's arithmetic apart (the offsets, K1 on
  each shard's slice, the cross-shard reductions, the row scatter's
  off-shard rows).
- The node-axis slice of shard s is [s * n_per_shard, (s + 1) *
  n_per_shard) (shard_slice).
- Exactly the three collectives the JAX bodies use, over a list of
  per-shard tensors: pmax, psum and tiled all_gather. Each reduces on the
  first shard's device and hands every shard its copy (`.to` of its
  device; no copy where the devices are the same, so the copies are
  read-only). On a host with several cards the small gathered vectors
  cross between them there.
- A replicated table lives once per distinct device (distinct_devices,
  first_shard_of), not once per shard: a fold of a replicated table runs
  once per distinct device, so a mesh that repeats a device does not
  count a commit twice.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

AXIS = "nodes"


class DeviceMesh:
    """The shards' devices, in shard order, on the axis "nodes"."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("DeviceMesh: no devices")
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = (AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> tuple:
        """The devices without repeats, in first-appearance order."""
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return tuple(out)

    def first_shard_of(self) -> tuple:
        """For each distinct device, the first shard placed on it: the
        shards that fold the replicated tables."""
        seen, out = set(), []
        for s, d in enumerate(self.devices):
            if d not in seen:
                seen.add(d)
                out.append(s)
        return tuple(out)

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"


def shard_slice(s: int, n_per_shard: int) -> slice:
    """The node-axis window of shard s."""
    return slice(s * n_per_shard, (s + 1) * n_per_shard)


def _spread(result: torch.Tensor, parts: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    return [result.to(p.device) for p in parts]


def pmax(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The element-wise maximum over the shards' tensors, to every shard
    (jax.lax.pmax)."""
    dev = parts[0].device
    return _spread(torch.stack([p.to(dev) for p in parts]).amax(dim=0),
                   parts)


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The element-wise sum over the shards' tensors, in their dtype, to
    every shard (jax.lax.psum)."""
    dev = parts[0].device
    return _spread(torch.stack([p.to(dev) for p in parts]).sum(
        dim=0, dtype=parts[0].dtype), parts)


def all_gather(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The shards' tensors concatenated along their first axis, in shard
    order, to every shard (jax.lax.all_gather(..., tiled=True))."""
    dev = parts[0].device
    return _spread(torch.cat([p.to(dev) for p in parts], dim=0), parts)
