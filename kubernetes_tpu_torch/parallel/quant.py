"""Quantized device placement for resident node tables.

PyTorch counterpart of kubernetes_tpu/parallel/quant.py. mode,
narrow_enabled, score_mode, narrow_dtype, narrow, ShadowGate and the
constants are verbatim copies (tests/test_torch_isolation.py
FUNCTION_COPIES); narrow_eq and narrow_matvec are torch functions with
the same contract. The JAX module's text follows.

The node-axis tables the device sweeps every wave ride full-width
int32/int64 even when their values are tiny vocab ids or multiplicity
counts. This module is the placement-time width audit: for each table
on the DECLARED narrow list it measures the value range and picks the
narrowest signed dtype that holds every entry, and the drivers place
THAT copy on device. Host mirrors always keep full width — narrowing
is a device-placement decision, never an encoder change — so the
diff/scatter machinery and the serial-oracle replay are untouched.

Vocab growth past a narrow range needs no special case: the chosen
dtype is part of the placement signature (resident._signature /
WaveScheduler's per-field cache key), so the first sync after an
out-of-range value lands rebuilds the table at the wider dtype.

Narrowing is LOSSLESS by construction under the default profile:
  * every narrowed table is consumed by equality compares, gathers /
    scatter indices, or 0/1-weighted contractions, and integer
    promotion of in-range values preserves all of them;
  * compare sites use narrow_eq below, which casts the SMALL (pod-side)
    comparand down to the table dtype with an explicit wide-side range
    guard — the big table is never upcast (that upcast is exactly the
    bandwidth the shrink exists to save, and the jaxpr auditor's dtype
    contract makes it a CI failure).

The bf16 j-table profile (KUBERNETES_TPU_QUANT=bf16) is a DECLARED
profile, not a default: probe score accumulation runs in bfloat16 with
an i32 final reduce. It is exact while the summed |weight|*10 score
bound stays <= 256 (bf16's exact-integer range); beyond that it may
round. ShadowGate keeps it honest: sampled waves re-run full-width and
any decision divergence increments a metric and trips a permanent
fallback to the full-width path.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

ENV = "KUBERNETES_TPU_QUANT"
SHADOW_ENV = "KUBERNETES_TPU_QUANT_SHADOW"

# node tables eligible for dtype shrink. label_kv/label_key/taint_mask
# are u32 BITSETS (already dense — a dtype change would change their
# semantics) and the alloc_*/req_* resource tables hold byte counts
# that genuinely need 64 bits; the narrow wins are the vocab-id and
# multiplicity tables below.
NARROWABLE = ("taint_count", "zone_id", "vz_zone", "vz_region")

_NARROW_STEPS = (np.int8, np.int16)


def mode() -> str:
    """'int' (default): narrow integer tables, bit-identical.
    'off': full-width everywhere. 'bf16': int narrowing plus the
    bfloat16 j-table accumulation profile (shadow-compared)."""
    m = os.environ.get(ENV, "").strip().lower()
    if m in ("", "1", "on", "int", "default"):
        return "int"
    if m in ("0", "off", "wide", "none"):
        return "off"
    if m in ("bf16", "bfloat16"):
        return "bf16"
    raise ValueError(f"{ENV}={m!r}: expected int|off|bf16")


def narrow_enabled(m: Optional[str] = None) -> bool:
    return (m if m is not None else mode()) != "off"


def score_mode(m: Optional[str] = None) -> str:
    """Probe j-table accumulator: 'i64' or 'bf16'."""
    return "bf16" if (m if m is not None else mode()) == "bf16" else "i64"


def narrow_dtype(name: str, arr: np.ndarray) -> np.dtype:
    """The placement-time width audit: narrowest signed dtype holding
    every value of this table (int8 -> int16 -> keep). Non-narrowable
    names and non-int32/int64 tables pass through unchanged."""
    if name not in NARROWABLE or arr.dtype.kind != "i" \
            or arr.dtype.itemsize <= 2:
        return arr.dtype
    if arr.size == 0:
        return np.dtype(np.int8)
    lo = int(arr.min())
    hi = int(arr.max())
    for dt in _NARROW_STEPS:
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return np.dtype(dt)
    return arr.dtype


def narrow(name: str, arr: np.ndarray, m: Optional[str] = None):
    """The array to PLACE on device: a narrow copy when the audit
    allows, the original otherwise. The caller keeps `arr` as its
    full-width host mirror either way."""
    if not narrow_enabled(m):
        return arr
    dt = narrow_dtype(name, arr)
    return arr.astype(dt) if dt != arr.dtype else arr


def narrow_eq(table, value):
    """Equality against a possibly-narrowed node table without
    upcasting it: the (small) comparand casts DOWN to the table dtype,
    guarded by a wide-side range check so out-of-vocab values can
    never alias into the narrow range. Exact for all inputs. `value`
    is a tensor (a 0-d pod scalar or a row) or a Python int."""
    import torch

    value = torch.as_tensor(value, device=table.device)
    if table.dtype == value.dtype:
        return table == value
    info = torch.iinfo(table.dtype)
    in_range = (value >= info.min) & (value <= info.max)
    return (table == value.to(table.dtype)) & in_range


def narrow_matvec(table, vec, out_dtype):
    """table[N, K] @ vec[K] without widening the table: the comparand
    vector casts down to the table dtype (callers guarantee its values
    fit, e.g. 0/1 toleration indicators), each product stays in the
    table dtype (exact for such values) and the sum accumulates in
    `out_dtype`. No widened copy of the [N, K] table is made; CUDA has
    no integer matmul, and integer sums are exact in any order, so this
    equals the wide product bit for bit."""
    return (table * vec.to(table.dtype)[None, :]).sum(dim=1,
                                                     dtype=out_dtype)


class ShadowGate:
    """bf16-profile validation: every `stride`-th wave re-runs at full
    width on a shadow driver and compares node selections. Divergence
    increments the metric and permanently falls the session back to
    the full-width path. stride <= 0 disables sampling."""

    def __init__(self, stride: Optional[int] = None):
        if stride is None:
            raw = os.environ.get(SHADOW_ENV, "16").strip()
            stride = int(raw) if raw else 0
        self.stride = stride
        self.waves = 0
        self.checked = 0
        self.divergence = 0
        self.fallen_back = False

    def should_check(self) -> bool:
        """Call once per wave; True when this wave should be shadowed
        (the first wave always is — a broken profile dies early)."""
        if self.fallen_back or self.stride <= 0:
            return False
        self.waves += 1
        return (self.waves - 1) % self.stride == 0

    def record(self, matched: bool) -> None:
        self.checked += 1
        if not matched:
            self.divergence += 1
            self.fallen_back = True

    def stats(self) -> dict:
        return {
            "waves": self.waves,
            "checked": self.checked,
            "divergence": self.divergence,
            "fallen_back": self.fallen_back,
        }
