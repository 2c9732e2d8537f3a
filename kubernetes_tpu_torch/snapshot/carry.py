"""Carry an encoded snapshot across packages and onto a device.

The port keeps its own ClusterSnapshot/PodBatch (snapshot/encode.py, a
copy of the JAX package's). These helpers let one encoding feed both
packages: a caller holding the JAX package's encoded snapshot passes its
fields as name -> numpy array and gets the port's dataclass back, with
every array copied so neither side can see the other's writes.

to_device places the arrays on a torch device with the port's dtype
rule: integer arrays (the uint32 bitsets included) widen to int64, bool
and float64 stay as they are. The placed tensors are fresh copies, so
the scan may update a carry in place without touching the snapshot.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from kubernetes_tpu_torch.snapshot.encode import ClusterSnapshot, PodBatch


def _copied(fields: dict) -> dict:
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in fields.items()}


def snapshot_from_arrays(fields: Dict[str, object]) -> ClusterSnapshot:
    """ClusterSnapshot from field name -> value (numpy arrays copied)."""
    return ClusterSnapshot(**_copied(fields))


def batch_from_arrays(fields: Dict[str, object]) -> PodBatch:
    """PodBatch from field name -> value (numpy arrays copied)."""
    return PodBatch(**_copied(fields))


def place(arr, device) -> torch.Tensor:
    """One host array -> a fresh tensor on `device` (ints as int64). On
    CUDA the copy goes through pinned memory and the host does not wait
    for it (a copy from pageable memory would wait for the card's queued
    work); it is ordered before later work on the current stream."""
    # a host array by contract: this is the upload, not a read of device
    # data (the fold's host counts reach here, wave._counts)
    a = np.asarray(arr)  # lint: allow[host-sync]
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    elif a.dtype.kind in "bf":
        a = a.copy()
    else:
        raise TypeError(f"cannot place an array of dtype {a.dtype}")
    host = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return host.to(device)
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


def to_device(obj, device, fields=None) -> Dict[str, torch.Tensor]:
    """The array fields of a ClusterSnapshot or PodBatch (all of them, or
    those named in `fields`) -> name -> tensor on `device`."""
    names = fields if fields is not None else [
        f.name for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), np.ndarray)
    ]
    return {f: place(getattr(obj, f), device) for f in names}
