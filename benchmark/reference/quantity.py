"""Kubernetes resource quantities ("100m", "4", "32Gi", "1e3") as exact
integers: CPU in millicores, everything else in whole units, each
rounded up as resource.Quantity's MilliValue and Value round."""

from __future__ import annotations

import math
import re
from fractions import Fraction

_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
           "Ei": 2**60}
_DECIMAL = {"n": Fraction(1, 10**9), "u": Fraction(1, 10**6),
            "m": Fraction(1, 1000), "": Fraction(1), "k": Fraction(10**3),
            "M": Fraction(10**6), "G": Fraction(10**9), "T": Fraction(10**12),
            "P": Fraction(10**15), "E": Fraction(10**18)}
_FORM = re.compile(r"^([+-]?[0-9]*\.?[0-9]+)(?:([eE][+-]?[0-9]+)|([A-Za-z]*))$")


def parse(text) -> Fraction:
    """A quantity string (or number) -> its exact value."""
    if isinstance(text, (int, float)):
        return Fraction(text)
    m = _FORM.match(str(text).strip())
    if not m:
        raise ValueError(f"not a quantity: {text!r}")
    number, exponent, suffix = m.groups()
    value = Fraction(number)
    if exponent:
        return value * Fraction(10) ** int(exponent[1:])
    if suffix in _BINARY:
        return value * _BINARY[suffix]
    if suffix in _DECIMAL:
        return value * _DECIMAL[suffix]
    raise ValueError(f"unknown quantity suffix in {text!r}")


def milli(text) -> int:
    """MilliValue: the value in thousandths, rounded up."""
    return math.ceil(parse(text) * 1000)


def units(text) -> int:
    """Value: the value in whole units, rounded up."""
    return math.ceil(parse(text))
