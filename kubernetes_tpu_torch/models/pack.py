"""Single-transfer shipment of heterogeneous host arrays.

PyTorch counterpart of kubernetes_tpu/models/pack.py. A dict of numpy
arrays packs into ONE uint8 buffer (pack_arrays, a verbatim copy:
tests/test_torch_isolation.py FUNCTION_COPIES), which crosses to the
device in one copy and is cut back into its fields there (unpack):
every shipment of the wave driver (the node tables a wave places, a
resident table's changed rows, a run's pod row, a group's stacked pod
rows, the scan's pods) is one host-to-device transfer.

unpack applies the port's placement rule (snapshot/carry.place) to each
field: integers widen to int64 on the device, except a table the caller
names in `narrowed` (a parallel/quant.narrow copy at int8 or int16),
which keeps its narrow dtype; bool and float fields keep theirs. The
buffer ships at the host's own widths, so a narrowed table crosses at
its narrow width too.

Packer.ship on a CUDA device copies the packed bytes into a pinned host
tensor and makes one non_blocking copy from it: a copy from pageable
memory would be synchronous. The pinned tensor comes from PyTorch's
caching host allocator, which records the copy's stream and does not
hand the block out again until the copy has completed, so a staged
buffer is never overwritten under an in-flight copy. On the CPU nothing
is pinned or copied: the fields are views of the packed buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.trace.profile import phase_timer

I64 = torch.int64
#: numpy itemsize -> the signed torch dtype a segment is viewed as
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_FLOAT = {np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}


def pack_arrays(arrays: dict):
    """-> (layout tuple, uint8 host buffer): the single-buffer form of a
    dict of numpy arrays. The layout is hashable (a jit cache key); the
    buffer unpacks on device via _unpack(layout, buf) — usable directly
    inside jit/shard_map bodies (the mesh wave passes pod rows this way
    so a run costs one replicated transfer, not one per field)."""
    items = sorted(arrays.items())
    layout = []
    off = 0
    for name, a in items:
        a = np.asarray(a)
        # NB: ascontiguousarray promotes 0-d to (1,); keep the true
        # shape in the layout so scalars unpack as scalars
        shape = a.shape
        nb = a.nbytes
        layout.append((name, a.dtype.str, shape, off, nb))
        off += (nb + 7) & ~7  # 8-byte alignment for every bitcast
    buf = np.zeros(max(off, 1), np.uint8)
    for (name, _d, _s, o, nb), (_n, a) in zip(layout, items):
        if nb:
            buf[o:o + nb] = (
                np.ascontiguousarray(a).view(np.uint8).reshape(-1)
            )
    return tuple(layout), buf


def placed_dtype(dt: np.dtype, narrow: bool) -> torch.dtype:
    """The dtype a field of host dtype `dt` takes on the device."""
    if dt == np.bool_:
        return torch.bool
    if dt.kind == "f":
        return _FLOAT[dt]
    if dt.kind == "i" and narrow and dt.itemsize <= 2:
        return _SIGNED[dt.itemsize]
    return I64


def _field(seg: torch.Tensor, dt: np.dtype, shape, narrow: bool):
    """One packed segment (uint8, 8-byte aligned) -> its placed tensor."""
    if dt == np.bool_:
        return (seg != 0).reshape(shape)
    if dt.kind == "f":
        return seg.view(_FLOAT[dt]).reshape(shape)
    if dt.kind not in "iu":
        raise TypeError(f"cannot place an array of dtype {dt}")
    t = seg if dt == np.uint8 else seg.view(_SIGNED[dt.itemsize])
    t = t.reshape(shape)
    if dt.kind == "i" and (narrow and dt.itemsize <= 2
                           or dt.itemsize == 8):
        return t
    t = t.to(I64)
    if dt.kind == "u" and 1 < dt.itemsize < 8:
        # the bits were read as signed: back to the unsigned value
        t = t & ((1 << (8 * dt.itemsize)) - 1)
    return t


def unpack(layout, buf: torch.Tensor, narrowed=frozenset()) -> dict:
    """Device-side inverse of pack_arrays: -> {name: tensor on buf's
    device}, with the port's placement rule (see the module docstring;
    `narrowed` names the fields that keep an int8 or int16 dtype). A
    zero-size field is a fresh empty tensor; a 0-d field stays 0-d."""
    out = {}
    for name, dstr, shape, off, nb in layout:
        dt = np.dtype(dstr)
        narrow = name in narrowed
        if nb == 0:  # a zero-size axis: materialize the empty tensor
            out[name] = torch.zeros(shape, dtype=placed_dtype(dt, narrow),
                                    device=buf.device)
            continue
        out[name] = _field(buf[off:off + nb], dt, shape, narrow)
    return out


class Packer:
    """Ships dicts of numpy arrays to `device` in one transfer each.

    ``h2d_bytes`` counts every byte shipped (class-wide total plus a
    per-instance tally), as in the JAX package's Packer, so a bench can
    report the host-to-device bytes of a wave."""

    total_h2d_bytes = 0  # class-wide: all packers, process lifetime

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.h2d_bytes = 0

    def upload(self, buf: np.ndarray) -> torch.Tensor:
        """One packed host buffer -> a uint8 tensor on the device: one
        non_blocking copy from pinned memory on CUDA (enqueued on the
        current stream, so whatever reads it later on that stream is
        ordered after it), the buffer itself on the CPU."""
        self.h2d_bytes += buf.nbytes
        Packer.total_h2d_bytes += buf.nbytes
        host = torch.from_numpy(buf)
        if self.device.type != "cuda":
            return host
        pinned = torch.empty(host.shape, dtype=torch.uint8,
                             pin_memory=True)
        pinned.copy_(host)
        return pinned.to(self.device, non_blocking=True)

    def ship(self, arrays: dict, narrowed=frozenset()) -> dict:
        """-> {name: device tensor}, one host-to-device transfer total."""
        # the host<->device "transfer" phase of the wire-path breakdown:
        # every wave's shipping funnels through here
        with phase_timer("transfer"):
            layout, buf = pack_arrays(arrays)
            return unpack(layout, self.upload(buf), narrowed)
