"""The resident row scatter K8: the CUDA kernel's wrapper.

Replaces kubernetes_tpu/parallel/resident.py `_scatter_fn` (:167), the
shard_map program that scatters a node update's packed changed rows into
the mesh's resident node tables (a program that XLA fuses; no Pallas
source). Per shard s, with offset = s * n_per_shard: for every field and
every packed row i with offset <= idx[i] < offset + n_per_shard, the
resident row idx[i] - offset along the field's node axis becomes row i
of the field's rows (a bool field takes row != 0); off-shard rows and
-1 padding write nothing.

- scatter_shipment: the device-wide entry. On CUDA tensors it launches
  the kernel of csrc/resident_scatter.cu (built with nvcc for sm_90a on
  first use, see native/build.py) ONCE for every given shard on the
  buffer's device and every field of the shipment: the kernel routes
  each packed row to its shard (idx // n_per_shard) itself, and reads
  each destination from a DestTable on the device. It raises on what the
  kernel does not take; it never falls back. On CPU tensors, and only
  there, it runs scatter_rows_plain for each shard.
- scatter_rows: the one-shard case of scatter_shipment (shard offset //
  n_per_shard).
- launch_plan: the owning shards of a shipment grouped by device, one
  launch each (ResidentClusterState._scatter).
- DestTable: the destination pointers of one device's node-axis
  resident tensors (fields x the mesh's shards, 0 for shards elsewhere),
  resident on that device, with their host copy. Built when the
  tensors are placed; a launch checks the tensors it is given against
  the host copy and raises if one moved.
- scatter_rows_plain: the same update in torch for one shard:
  models/pack.unpack, then index_copy_ on each field's node axis after
  masking off-shard rows.
- LAUNCHES counts kernel launches (incremented only where the kernel is
  launched); LAUNCHES_BY_SHAPE counts them by (M, n_per_shard, fields,
  shards a launch).

The kernel reads the packed rows where they landed on the device (never
through unpack), widening each at its kind as models/pack._field and
snapshot/carry.place do: a signed row sign-extends, an unsigned one
(a uint32 bitset) zero-extends, a float keeps its bits, a bool is row
!= 0. On the main path the rows already ship at the placed dtypes
(ResidentClusterState._scatter converts them, as the JAX package does),
so there the kernel copies at one width; the widening serves the whole
of _scatter_fn's function, which takes any host width. Bound: bytes (the
owned rows read, the same elements written at the placed widths, and
__idx__), and in practice the launch itself. See the kernel source for
the design.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterable, List, NamedTuple, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.models.pack import placed_dtype, unpack

I64 = torch.int64

#: the most fields one launch takes (csrc/resident_scatter.cu MAX_FIELDS)
MAX_FIELDS = 96
#: the most shards a mesh may have for the kernel (csrc MAX_SHARDS): the
#: launch's shards ride as a bit set of MAX_SHARDS // 64 words
MAX_SHARDS = 256
#: element kinds of a code (csrc/resident_scatter.cu KIND_*)
KIND_SIGNED, KIND_UNSIGNED, KIND_FLOAT, KIND_BOOL = 0, 1, 2, 3

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: kernel launches by (M, n_per_shard, fields, shards a launch) since the
#: last reset
LAUNCHES_BY_SHAPE: dict = {}

_LIB = None


def _lib() -> ctypes.CDLL:
    """The built K8 library (built at first use), its C interface
    declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        fn = lib.resident_scatter_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                       ctypes.c_void_p]
        lib.resident_scatter_param_bytes.restype = ctypes.c_int
        lib.resident_scatter_param_bytes.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


def build() -> str:
    """Build the kernel library (unless built) -> its path. It is
    otherwise built at the first launch."""
    from kubernetes_tpu_torch.native.build import build_cuda

    return build_cuda("resident_scatter")


def param_bytes(n_fields: int) -> int:
    """The kernel parameter bytes of a launch of n_fields fields (the
    instance at 8, 32 or 96 fields that it takes)."""
    return int(_lib().resident_scatter_param_bytes(n_fields))


def _segments(layout) -> dict:
    """name -> (byte offset, numpy dtype, shape) of a pack_arrays layout."""
    return {name: (off, np.dtype(d), tuple(shape))
            for name, d, shape, off, _nb in layout}


def _src_code(dt: np.dtype) -> int:
    kind = {"i": KIND_SIGNED, "u": KIND_UNSIGNED, "f": KIND_FLOAT,
            "b": KIND_BOOL}[dt.kind]
    return dt.itemsize | kind << 8


def _dst_code(t: torch.Tensor) -> int:
    if t.dtype == torch.bool:
        kind = KIND_BOOL
    elif t.dtype.is_floating_point:
        kind = KIND_FLOAT
    else:
        kind = KIND_SIGNED
    return t.element_size() | kind << 8


def _axis_strides(shape, ax: int):
    """(outer, inner) element counts around the node axis."""
    return int(np.prod(shape[:ax], dtype=np.int64)), int(
        np.prod(shape[ax + 1:], dtype=np.int64))


def _lanes(row_bytes: int) -> int:
    """Threads a (row, field) pair for the widest row of a launch: one up
    to 16 bytes (a 16-byte chunk or two elements), 8 up to 64 (an element
    of up to 8 bytes a lane), else a warp."""
    return 1 if row_bytes <= 16 else 8 if row_bytes <= 64 else 32


def _checked(name: str, dt: np.dtype, shape, ax: int, dst: torch.Tensor,
             M: int, n_per_shard: int, narrow: bool) -> None:
    want = tuple(dst.shape[:ax]) + tuple(dst.shape[ax + 1:])
    if dst.shape[ax] != n_per_shard or tuple(shape) != (M,) + want \
            or not dst.is_contiguous() \
            or dst.dtype != placed_dtype(dt, narrow):
        raise ValueError(
            f"scatter_rows: field {name!r}: rows {dt} {tuple(shape)} do not "
            f"fit a contiguous {placed_dtype(dt, narrow)} resident tensor "
            f"with {n_per_shard} nodes on axis {ax}, got {dst.dtype} "
            f"{tuple(dst.shape)}")


def _indexed(device: torch.device) -> torch.device:
    """A CUDA device with its index (the current device's for "cuda"), as
    a tensor on it names it; any other device as it is."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Launch(NamedTuple):
    """One K8 launch of a shipment: a device and the owning shards on it
    (ids and their first global nodes, s * n_per_shard), in mesh order."""
    device: torch.device
    shards: tuple
    offsets: tuple


def launch_plan(devices: Sequence, owners: Iterable[int],
                n_per_shard: int) -> List[Launch]:
    """The owning shards of a shipment grouped by their device, one
    launch a device, in the order the devices first hold an owner.
    devices: the mesh's devices in shard order."""
    devices = [torch.device(d) for d in devices]
    groups: Dict[torch.device, list] = {}
    for s in sorted(set(int(s) for s in owners)):
        if not 0 <= s < len(devices):
            raise ValueError(f"launch_plan: shard {s} is outside a mesh of "
                             f"{len(devices)}")
        groups.setdefault(devices[s], []).append(s)
    return [Launch(d, tuple(ss), tuple(s * n_per_shard for s in ss))
            for d, ss in groups.items()]


class DestTable:
    """The destination pointers of one device's node-axis resident
    tensors: an int64 table of a row a field x n_shards columns, on the
    device, row `rows[f]` column s the data_ptr of field f's tensor of
    shard s (0 where shard s lies on another device), and its host copy
    `ptrs`. Built when the tensors are placed (a port-only host-to-device
    copy of rows x n_shards x 8 bytes, which the JAX package's byte
    counts have no counterpart of); the tensors are then updated in
    place, so it stays right until they are placed anew."""

    def __init__(self, device, n_shards: int,
                 fields: Dict[str, Dict[int, torch.Tensor]]):
        self.device = _indexed(torch.device(device))
        self.n_shards = int(n_shards)
        if not 1 <= self.n_shards <= MAX_SHARDS:
            raise ValueError(f"DestTable: {n_shards} shards (the kernel "
                             f"takes 1 to {MAX_SHARDS})")
        self.rows = {name: r for r, name in enumerate(fields)}
        self.ptrs = np.zeros((len(fields), self.n_shards), np.int64)
        for name, by_shard in fields.items():
            for s, t in by_shard.items():
                if t.device != self.device:
                    raise ValueError(f"DestTable: field {name!r} of shard "
                                     f"{s} lies on {t.device}, the table "
                                     f"on {self.device}")
                self.ptrs[self.rows[name], s] = t.data_ptr()
        self.table = torch.from_numpy(self.ptrs.reshape(-1).copy()).to(
            self.device)

    def check(self, names: Sequence[str], shard_ids: Sequence[int],
              shard_dests: Sequence[Sequence[torch.Tensor]]) -> None:
        """Raise unless every given tensor is the one the table points to
        (a field it lacks, a shard outside it or a tensor placed anew)."""
        for s, dests in zip(shard_ids, shard_dests):
            if not 0 <= s < self.n_shards:
                raise ValueError(f"scatter_shipment: shard {s} is outside "
                                 f"the table's {self.n_shards} shards")
            for name, dst in zip(names, dests):
                r = self.rows.get(name)
                if r is None:
                    raise ValueError(f"scatter_shipment: the destination "
                                     f"table has no field {name!r}")
                if dst.numel() and self.ptrs[r, s] != dst.data_ptr():
                    raise ValueError(f"scatter_shipment: field {name!r} of "
                                     f"shard {s} is not the tensor the "
                                     f"destination table points to")


def scatter_rows_plain(layout, buf: torch.Tensor, names: Sequence[str],
                       axes: Sequence[int], dests: Sequence[torch.Tensor],
                       n_per_shard: int, offset: int,
                       narrowed=frozenset()) -> None:
    """The row scatter in torch ops, in place: unpack the buffer, keep the
    rows this shard owns, index_copy_ them along each field's node axis."""
    rows = unpack(layout, buf, narrowed)
    idx = rows["__idx__"]
    local = idx - offset
    keep = torch.nonzero((idx >= 0) & (local >= 0)
                         & (local < n_per_shard)).flatten()
    at = local[keep]
    for name, ax, dst in zip(names, axes, dests):
        dst.movedim(ax, 0).index_copy_(0, at,
                                       rows[name][keep].to(dst.dtype))


class LaunchArgs(NamedTuple):
    """The scalars and descriptors of one K8 launch, as the C interface
    takes them (csrc/resident_scatter.cu resident_scatter_launch)."""
    idx_off: int
    M: int
    n_per_shard: int
    n_shards: int
    mask: tuple   # MAX_SHARDS // 64 words: bit s for shard s
    desc: tuple   # a field: (src_off, outer, inner, codes, table row)
    lanes: int


def launch_args(layout, buf, names, axes, shard_dests, shard_ids,
                n_per_shard: int, narrowed, table: DestTable) -> LaunchArgs:
    """Check a shipment against what the kernel takes and describe its
    launch (no device needed: the CPU tests re-enact the kernel on it)."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 \
            or not buf.is_contiguous():
        raise ValueError("scatter_rows: the buffer must be a contiguous "
                         "uint8 vector")
    seg = _segments(layout)
    idx_off, idx_dt, idx_shape = seg["__idx__"]
    if idx_dt != np.dtype(np.int64) or len(idx_shape) != 1:
        raise ValueError("scatter_rows: __idx__ must be an int64 vector")
    M = idx_shape[0]
    for dests in shard_dests:
        for name, ax, dst in zip(names, axes, dests):
            _off, dt, shape = seg[name]
            _checked(name, dt, shape, ax, dst, M, n_per_shard,
                     name in narrowed)
    desc, row_bytes = [], 0
    for name, ax, dst in zip(names, axes, shard_dests[0]):
        off, dt, _shape = seg[name]
        outer, inner = _axis_strides(tuple(dst.shape), ax)
        desc.append((int(off), outer, inner,
                     _src_code(dt) | _dst_code(dst) << 16, table.rows[name]))
        row_bytes = max(row_bytes, outer * inner
                        * max(dt.itemsize, dst.element_size()))
    mask = [0] * (MAX_SHARDS // 64)
    for s in shard_ids:
        mask[s >> 6] |= 1 << (s & 63)
    return LaunchArgs(int(idx_off), int(M), int(n_per_shard), table.n_shards,
                      tuple(mask), tuple(desc), _lanes(row_bytes))


def _launch(buf, table: DestTable, a: LaunchArgs, n_launch: int) -> None:
    """Launch the kernel once (n_launch shards) on buf's device."""
    global LAUNCHES
    flat = [v for d in a.desc for v in d]
    arr = (ctypes.c_longlong * max(len(flat), 1))(*flat)
    words = (ctypes.c_ulonglong * len(a.mask))(*a.mask)
    device = buf.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib().resident_scatter_launch(
            buf.data_ptr(), table.table.data_ptr(), a.idx_off, a.M,
            a.n_per_shard, a.n_shards, words, len(a.desc), arr, a.lanes,
            stream)
    if err != 0:
        raise RuntimeError(f"resident_scatter kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    key = (a.M, a.n_per_shard, len(a.desc), n_launch)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def scatter_shipment(layout, buf: torch.Tensor, names: Sequence[str],
                     axes: Sequence[int],
                     shard_dests: Sequence[Sequence[torch.Tensor]],
                     shard_ids: Sequence[int], n_per_shard: int,
                     narrowed=frozenset(), table: DestTable = None) -> None:
    """Scatter a packed row shipment (pack_arrays layout and its buffer on
    one device: __idx__ i64[M] global node ids, -1 padding, and each
    named field's rows with its node axis moved first) into the resident
    tensors of the shards `shard_ids` on that device, in place:
    shard_dests[i] holds shard shard_ids[i]'s tensor of each field, in
    `names` order. axes: each field's node axis in its tensor; shard s
    owns global nodes [s * n_per_shard, (s + 1) * n_per_shard); narrowed:
    the fields placed at a narrow int8/int16 dtype; table: the device's
    DestTable, whose shards are the mesh's (when None, one is built here
    for these tensors, over shards up to the largest id). CUDA tensors
    launch the kernel once; CPU tensors run the plain version shard by
    shard; any other device raises."""
    shard_ids = [int(s) for s in shard_ids]
    if len(shard_dests) != len(shard_ids) or not shard_ids:
        raise ValueError("scatter_shipment: one list of tensors for each "
                         "of at least one shard")
    if len(set(shard_ids)) != len(shard_ids):
        raise ValueError(f"scatter_shipment: a shard twice in {shard_ids}")
    if n_per_shard < 1:
        raise ValueError(f"scatter_shipment: {n_per_shard} nodes a shard")
    if len(names) > MAX_FIELDS:
        raise ValueError(f"scatter_rows: one launch takes at most "
                         f"{MAX_FIELDS} fields, got {len(names)}")
    n_shards = table.n_shards if table is not None else max(shard_ids) + 1
    for s in shard_ids:
        if not 0 <= s < n_shards:
            raise ValueError(f"scatter_shipment: shard {s} is outside a "
                             f"mesh of {n_shards}")
    device = buf.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"scatter_rows: no kernel for device {device}")
    for s, dests in zip(shard_ids, shard_dests):
        if len(dests) != len(names):
            raise ValueError(f"scatter_shipment: shard {s} has "
                             f"{len(dests)} tensors for {len(names)} "
                             f"fields")
        for name, dst in zip(names, dests):
            if dst.device != device:
                raise ValueError(f"scatter_rows: field {name!r} of shard "
                                 f"{s} lies on {dst.device}, the buffer "
                                 f"on {device}")
    if table is not None:
        if table.device != device:
            raise ValueError(f"scatter_shipment: the destination table "
                             f"lies on {table.device}, the shipment on "
                             f"{device}")
        table.check(names, shard_ids, shard_dests)
    if device.type == "cpu":
        for s, dests in zip(shard_ids, shard_dests):
            scatter_rows_plain(layout, buf, names, axes, dests, n_per_shard,
                               s * n_per_shard, narrowed)
        return
    if table is None:
        table = DestTable(device, n_shards, {
            name: {s: dests[i] for s, dests in zip(shard_ids, shard_dests)}
            for i, name in enumerate(names)})
    _launch(buf, table, launch_args(layout, buf, names, axes, shard_dests,
                                    shard_ids, n_per_shard, narrowed,
                                    table), len(shard_ids))


def scatter_rows(layout, buf: torch.Tensor, names: Sequence[str],
                 axes: Sequence[int], dests: Sequence[torch.Tensor],
                 n_per_shard: int, offset: int,
                 narrowed=frozenset()) -> None:
    """scatter_shipment for one shard, whose first global node is
    `offset` (a multiple of n_per_shard), into its tensors `dests`."""
    if n_per_shard < 1 or offset % n_per_shard:
        raise ValueError(f"scatter_rows: offset {offset} is not a shard's "
                         f"first node at {n_per_shard} nodes a shard")
    scatter_shipment(layout, buf, names, axes, [dests],
                     [offset // n_per_shard], n_per_shard, narrowed)
