"""Label sets and selectors.

Reference surface: pkg/labels/selector.go (Requirement.Matches at :163-203,
operator set at :37-50) and pkg/labels/labels.go (Set.AsSelector). Semantics
reproduced exactly:

- In / = / ==      : key present AND value in set
- NotIn / !=       : key absent OR value not in set
- Exists           : key present
- DoesNotExist     : key absent
- Gt / Lt          : key present AND both values parse as float64 AND compare
- a selector matches iff ALL its requirements match (AND)
- the empty selector matches everything; `nothing()` matches nothing

These objects are host-side only; `snapshot.encode` compiles them to
fixed-width bitset programs for the device.

Copy of kubernetes_tpu/api/labels.py: only the import package differs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"

_OPS = (IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT)


def _parse_float(s: str) -> Optional[float]:
    try:
        return float(s)
    except (TypeError, ValueError):
        return None


@dataclass(frozen=True)
class Requirement:
    key: str
    operator: str
    values: frozenset = frozenset()

    def __post_init__(self):
        if self.operator not in _OPS:
            raise ValueError(f"unknown operator {self.operator!r}")

    def matches(self, labels: Dict[str, str]) -> bool:
        has = self.key in labels
        if self.operator == IN:
            return has and labels[self.key] in self.values
        if self.operator == NOT_IN:
            return (not has) or labels[self.key] not in self.values
        if self.operator == EXISTS:
            return has
        if self.operator == DOES_NOT_EXIST:
            return not has
        # Gt / Lt: float64 comparison; any parse failure or a values set not
        # of size exactly 1 means no match (selector.go:179-203).
        if not has:
            return False
        ls_value = _parse_float(labels[self.key])
        if ls_value is None or len(self.values) != 1:
            return False
        r_value = _parse_float(next(iter(self.values)))
        if r_value is None:
            return False
        if self.operator == GT:
            return ls_value > r_value
        return ls_value < r_value


@dataclass(frozen=True)
class Selector:
    """Conjunction of requirements. Empty requirements == match-all, unless
    `impossible` is set (labels.Nothing())."""

    requirements: tuple = ()
    impossible: bool = False

    def matches(self, labels: Dict[str, str]) -> bool:
        if self.impossible:
            return False
        return all(r.matches(labels) for r in self.requirements)

    def is_everything(self) -> bool:
        return not self.impossible and not self.requirements


def everything() -> Selector:
    return Selector(())


def nothing() -> Selector:
    return Selector((), impossible=True)


def selector_from_set(label_map: Optional[Dict[str, str]]) -> Selector:
    """labels.SelectorFromSet / Set.AsSelector: equality on each pair."""
    if not label_map:
        return everything()
    reqs = tuple(
        Requirement(k, IN, frozenset([v])) for k, v in sorted(label_map.items())
    )
    return Selector(reqs)


def new_requirement(key: str, operator: str, values: Iterable[str]) -> Requirement:
    return Requirement(key, operator, frozenset(values))


def selector(*reqs: Requirement) -> Selector:
    return Selector(tuple(reqs))


def parse(text: str) -> Selector:
    """Parse the query-string selector syntax (pkg/labels/selector.go
    Parse): comma-joined requirements of the forms `k=v`, `k==v`, `k!=v`,
    `k in (a,b)`, `k notin (a,b)`, `k` (Exists), `!k` (DoesNotExist)."""
    text = (text or "").strip()
    if not text:
        return everything()
    reqs: List[Requirement] = []
    # Split on commas that are not inside parentheses.
    parts: List[str] = []
    depth = 0
    cur = []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    for part in parts:
        part = part.strip()
        if not part:
            continue
        low = part.lower()
        if " notin " in low:
            idx = low.index(" notin ")
            key, vals = part[:idx].strip(), part[idx + 7 :].strip()
            reqs.append(
                Requirement(key, NOT_IN, frozenset(_parse_value_list(vals)))
            )
        elif " in " in low:
            idx = low.index(" in ")
            key, vals = part[:idx].strip(), part[idx + 4 :].strip()
            reqs.append(Requirement(key, IN, frozenset(_parse_value_list(vals))))
        elif "!=" in part:
            key, val = part.split("!=", 1)
            reqs.append(
                Requirement(key.strip(), NOT_IN, frozenset([val.strip()]))
            )
        elif "==" in part:
            key, val = part.split("==", 1)
            reqs.append(Requirement(key.strip(), IN, frozenset([val.strip()])))
        elif "=" in part:
            key, val = part.split("=", 1)
            reqs.append(Requirement(key.strip(), IN, frozenset([val.strip()])))
        elif part.startswith("!"):
            reqs.append(Requirement(part[1:].strip(), DOES_NOT_EXIST))
        else:
            reqs.append(Requirement(part, EXISTS))
    for r in reqs:
        _validate_parsed_key(r.key)
    return Selector(tuple(reqs))


def _validate_parsed_key(key: str) -> None:
    """Reject malformed clauses instead of silently producing a wrong
    selector (selector.go Parse returns an error; the apiserver maps the
    raised ValueError to a 400)."""
    if not key or any(ch in key for ch in "=!<>() "):
        raise ValueError(f"invalid label selector key {key!r}")


def _parse_value_list(text: str) -> List[str]:
    text = text.strip()
    if text.startswith("(") and text.endswith(")"):
        text = text[1:-1]
    return [v.strip() for v in text.split(",") if v.strip()]
