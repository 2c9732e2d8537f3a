"""The resident row scatter K8: the CUDA kernel's wrapper.

Replaces kubernetes_tpu/parallel/resident.py `_scatter_fn` (:167), the
shard_map program that scatters a node update's packed changed rows into
the mesh's resident node tables (a program that XLA fuses; no Pallas
source). Per shard s, with offset = s * n_per_shard: for every field and
every packed row i with offset <= idx[i] < offset + n_per_shard, the
resident row idx[i] - offset along the field's node axis becomes row i
of the field's rows (a bool field takes row != 0); off-shard rows and
-1 padding write nothing.

- scatter_rows: the wrapper. On CUDA tensors it launches the kernel of
  csrc/resident_scatter.cu (built with nvcc for sm_90a on first use, see
  native/build.py) once for every field of the shipment, or raises; it
  never falls back. On CPU tensors, and only there, it runs
  scatter_rows_plain.
- scatter_rows_plain: the same update in torch: models/pack.unpack, then
  index_copy_ on each field's node axis after masking off-shard rows.
- LAUNCHES counts kernel launches (incremented only where the kernel is
  launched); LAUNCHES_BY_SHAPE counts them by (M, n_per_shard, fields).

The kernel reads the packed rows where they landed on the device (never
through unpack), widening each at its kind as models/pack._field and
snapshot/carry.place do: a signed row sign-extends, an unsigned one
(a uint32 bitset) zero-extends, a float keeps its bits, a bool is row
!= 0. On the main path the rows already ship at the placed dtypes
(ResidentClusterState._scatter converts them, as the JAX package does),
so there the kernel copies at one width; the widening serves the whole
of _scatter_fn's function, which takes any host width. Bound: bytes (the
shard's rows read, the same elements written at the placed widths, and
__idx__). See the kernel source for the design.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.models.pack import placed_dtype, unpack

I64 = torch.int64

#: the most fields one launch takes (csrc/resident_scatter.cu MAX_FIELDS)
MAX_FIELDS = 96
#: element kinds of a descriptor (csrc/resident_scatter.cu KIND_*)
KIND_SIGNED, KIND_UNSIGNED, KIND_FLOAT, KIND_BOOL = 0, 1, 2, 3

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: kernel launches by (M, n_per_shard, fields) since the last reset
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
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        _LIB = lib
    return _LIB


def build() -> str:
    """Build the kernel library (unless built) -> its path. It is
    otherwise built at the first launch."""
    from kubernetes_tpu_torch.native.build import build_cuda

    return build_cuda("resident_scatter")


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


def _launch(layout, buf, names, axes, dests, n_per_shard: int, offset: int,
            narrowed=frozenset()) -> None:
    """Launch the kernel once for every field."""
    global LAUNCHES
    device = buf.device
    if len(names) > MAX_FIELDS:
        raise ValueError(f"scatter_rows: one launch takes at most "
                         f"{MAX_FIELDS} fields, got {len(names)}")
    if buf.dtype != torch.uint8 or buf.dim() != 1 \
            or not buf.is_contiguous():
        raise ValueError("scatter_rows: the buffer must be a contiguous "
                         "uint8 vector")
    seg = _segments(layout)
    idx_off, idx_dt, idx_shape = seg["__idx__"]
    if idx_dt != np.dtype(np.int64) or len(idx_shape) != 1:
        raise ValueError("scatter_rows: __idx__ must be an int64 vector")
    M = idx_shape[0]
    desc = []
    for name, ax, dst in zip(names, axes, dests):
        off, dt, shape = seg[name]
        if dst.device != device:
            raise ValueError(f"scatter_rows: field {name!r} lies on "
                             f"{dst.device}, the buffer on {device}")
        _checked(name, dt, shape, ax, dst, M, n_per_shard,
                 name in narrowed)
        outer, inner = _axis_strides(tuple(dst.shape), ax)
        desc += [off, dst.data_ptr(), outer, inner, _src_code(dt),
                 _dst_code(dst)]
    arr = (ctypes.c_longlong * max(len(desc), 1))(*desc)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib().resident_scatter_launch(
            buf.data_ptr(), int(idx_off), int(M), int(n_per_shard),
            int(offset), len(names), arr, stream)
    if err != 0:
        raise RuntimeError(f"resident_scatter kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    key = (int(M), int(n_per_shard), len(names))
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def scatter_rows(layout, buf: torch.Tensor, names: Sequence[str],
                 axes: Sequence[int], dests: Sequence[torch.Tensor],
                 n_per_shard: int, offset: int,
                 narrowed=frozenset()) -> None:
    """Scatter a packed row shipment (pack_arrays layout and its buffer on
    the shard's device: __idx__ i64[M] global node ids, -1 padding, and
    each named field's rows with its node axis moved first) into one
    shard's resident tensors `dests`, in place. axes: each field's node
    axis in its resident tensor; offset: the shard's first global node;
    narrowed: the fields placed at a narrow int8/int16 dtype. CUDA
    tensors launch the kernel; CPU tensors run the plain version; any
    other device raises."""
    device = buf.device
    if device.type == "cpu":
        return scatter_rows_plain(layout, buf, names, axes, dests,
                                  n_per_shard, offset, narrowed)
    if device.type != "cuda":
        raise ValueError(f"scatter_rows: no kernel for device {device}")
    return _launch(layout, buf, names, axes, dests, n_per_shard, offset,
                   narrowed)
