"""Fixed-point resource quantities.

Reference surface: pkg/api/resource/quantity.go. The scheduler only ever
consumes quantities through two projections (see
plugin/pkg/scheduler/algorithm/predicates/predicates.go:355-374):

- ``Cpu().MilliValue()``  -> int64 milli-units, rounded up
- ``Memory().Value()``    -> int64 base units (bytes), rounded up

so Quantity here is an exact rational parsed from the canonical string
forms (decimal SI suffixes, binary suffixes, scientific notation) and
projected to int64 with ceiling semantics. All downstream tensor math is
int64 — the device never sees a Quantity.

Copy of kubernetes_tpu/api/resource.py: only the import package differs.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from fractions import Fraction

_BINARY_SUFFIXES = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}
_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
    r"(?:[eE](?P<exp>[+-]?[0-9]+))?"
    r"(?P<suffix>[numkMGTPE]|[KMGTPE]i|Ki)?$"
)


@dataclass(frozen=True)
class Quantity:
    """An exact, non-negative-or-negative rational resource amount."""

    value_frac: Fraction

    def value(self) -> int:
        """Base-unit int64 value, rounded away from zero (Quantity.Value).

        Memoized per instance: parse_quantity's string cache shares
        Quantity objects across the whole snapshot, so the Fraction
        ceil/floor runs once per distinct string, not once per node/pod
        (the encode hot path at 5k-node scale)."""
        v = self.__dict__.get("_value")
        if v is None:
            f = self.value_frac
            v = math.ceil(f) if f >= 0 else math.floor(f)
            object.__setattr__(self, "_value", v)
        return v

    def milli_value(self) -> int:
        """Milli-unit int64 value, rounded away from zero (Quantity.MilliValue)."""
        v = self.__dict__.get("_milli")
        if v is None:
            f = self.value_frac * 1000
            v = math.ceil(f) if f >= 0 else math.floor(f)
            object.__setattr__(self, "_milli", v)
        return v

    def is_zero(self) -> bool:
        return self.value_frac == 0

    def __add__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.value_frac + other.value_frac)

    def __str__(self) -> str:
        f = self.value_frac
        if f.denominator == 1:
            return str(f.numerator)
        m = f * 1000
        if m.denominator == 1:
            return f"{m.numerator}m"
        return f"{float(f):g}"


def parse_quantity(s) -> Quantity:
    """Parse a quantity string (or int) in the reference's canonical forms.

    Accepts plain integers/decimals, scientific notation, decimal SI
    suffixes (n u m k M G T P E) and binary suffixes (Ki Mi Gi Ti Pi Ei).

    Quantity strings in a cluster repeat enormously ("100m", "32Gi", ...),
    and parsing dominates the snapshot-encode hot path at 50k-pod scale,
    so string parses go through a cache (Quantity is frozen, sharing is
    safe). The native _kquantity extension (native/) accelerates the
    miss path when built.
    """
    if isinstance(s, Quantity):
        return s
    if isinstance(s, int):
        return Quantity(Fraction(s))
    if isinstance(s, float):
        return Quantity(Fraction(s).limit_denominator(10**9))
    return _parse_quantity_str(s.strip())


def _parse_quantity_str_cached(s: str) -> Quantity:
    if _kquantity is not None:
        # native fast path: returns (numerator, denominator) or None for
        # forms it does not handle (then the Python parser decides)
        nd = _kquantity.parse(s)
        if nd is not None:
            return Quantity(Fraction(nd[0], nd[1]))
    return _parse_quantity_py(s)


def _parse_quantity_py(s: str) -> Quantity:
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"unable to parse quantity {s!r}")
    num = Fraction(m.group("num"))
    if m.group("exp"):
        exp = int(m.group("exp"))
        num *= Fraction(10) ** exp
    suffix = m.group("suffix") or ""
    if suffix in _BINARY_SUFFIXES:
        num *= _BINARY_SUFFIXES[suffix]
    elif suffix in _DECIMAL_SUFFIXES:
        num *= _DECIMAL_SUFFIXES[suffix]
    else:
        raise ValueError(f"unknown quantity suffix {suffix!r} in {s!r}")
    if m.group("sign") == "-":
        num = -num
    return Quantity(num)


try:
    from kubernetes_tpu_torch.native import _kquantity  # type: ignore
except Exception:  # extension not built: pure-Python path
    _kquantity = None

import functools

_parse_quantity_str = functools.lru_cache(maxsize=8192)(_parse_quantity_str_cached)


ZERO = Quantity(Fraction(0))


def resource_list_cpu_milli(requests: dict) -> int:
    """requests['cpu'] as int64 milli, 0 when absent (ResourceList.Cpu())."""
    q = requests.get("cpu")
    return parse_quantity(q).milli_value() if q is not None else 0


def resource_list_memory(requests: dict) -> int:
    """requests['memory'] as int64 bytes, 0 when absent."""
    q = requests.get("memory")
    return parse_quantity(q).value() if q is not None else 0


def resource_list_gpu(requests: dict) -> int:
    """requests['alpha.kubernetes.io/nvidia-gpu'] as int64, 0 when absent."""
    q = requests.get("alpha.kubernetes.io/nvidia-gpu")
    return parse_quantity(q).value() if q is not None else 0
