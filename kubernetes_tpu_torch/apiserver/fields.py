"""Field selectors (pkg/fields).

The scheduler's reflectors watch with field selectors like
`spec.nodeName==""` (unassigned pods) and `spec.unschedulable==false`
(factory.go:431-448). Fields are resolved against the wire (camelCase)
encoding of the object, so any field the codec emits is selectable;
absent paths resolve to "".

Copy of kubernetes_tpu/apiserver/fields.py: only the import package differs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.runtime.scheme import encode_value, to_snake


def _split_clauses(text: str) -> List[str]:
    """Split on commas OUTSIDE parentheses: the `in (a,b,c)` set form
    carries commas of its own."""
    out: List[str] = []
    depth = 0
    cur: List[str] = []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(depth - 1, 0)
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def parse_field_selector(text: str) -> List[Tuple[str, str, str]]:
    """-> [(path, op, value)] with op in {'=', '!=', 'in'}. Empty text
    -> []. The `in` form — `spec.nodeName in (n1,n2)` — is this
    framework's extension for interest-set watches (a hollow-fleet
    shard watching its whole node group on ONE stream); its value is
    the raw parenthesized list, compiled to a set lazily."""
    out: List[Tuple[str, str, str]] = []
    for part in _split_clauses(text or ""):
        part = part.strip()
        if not part:
            continue
        if " in " in part and part.endswith(")"):
            k, v = part.split(" in ", 1)
            v = v.strip()
            if not v.startswith("("):
                raise ValueError(f"invalid field selector clause {part!r}")
            out.append((k.strip(), "in", v))
        elif "!=" in part:
            k, v = part.split("!=", 1)
            out.append((k.strip(), "!=", v.strip()))
        elif "==" in part:
            k, v = part.split("==", 1)
            out.append((k.strip(), "=", v.strip()))
        elif "=" in part:
            k, v = part.split("=", 1)
            out.append((k.strip(), "=", v.strip()))
        else:
            raise ValueError(f"invalid field selector clause {part!r}")
    return out


def format_in_clause(path: str, values) -> str:
    """The wire text of one `in` clause (the fleet's shard selector)."""
    return f"{path} in ({','.join(values)})"


def _lookup(wire: Dict[str, Any], path: str) -> str:
    cur: Any = wire
    for seg in path.split("."):
        if not isinstance(cur, dict) or seg not in cur:
            return ""
        cur = cur[seg]
    if cur is None:
        return ""
    if isinstance(cur, bool):
        return "true" if cur else "false"
    return str(cur)


_MISSING = object()

# clause compile memo: (path, op, want) -> ((snake segs...), want value —
# a stripped string, or a frozenset for `in` clauses). A watch storm
# evaluates the same few clauses tens of thousands of times per second;
# splitting the path and to_snake'ing each segment per event was ~25%
# of the fan-out cost.
_COMPILED: Dict[Tuple[str, str, str], Tuple[Tuple[str, ...], Any]] = {}


def _strip_quotes(want: str) -> str:
    # strip optional quoting: spec.nodeName=="" arrives as value '""'
    if len(want) >= 2 and want[0] == want[-1] == '"':
        return want[1:-1]
    return want


def compile_in_values(want: str):
    """The frozenset of an `in` clause's raw '(a,b,c)' value text.
    Empty components are dropped: '()' is the empty set (matches
    NOTHING — naive splitting would yield {''}, which matches every
    unbound pod), and '(a,)' is {'a'}. Pinning the empty value is the
    equality form's job (`spec.nodeName=`)."""
    vals = (_strip_quotes(v.strip())
            for v in want.strip()[1:-1].split(","))
    return frozenset(s for s in vals if s)


def _compile_clause(path: str, want: str, op: str = "="):
    got = _COMPILED.get((path, op, want))
    if got is None:
        stripped = (
            compile_in_values(want) if op == "in" else _strip_quotes(want)
        )
        # keep both casings per segment: attributes are snake_case,
        # dict payloads keep the wire's camelCase verbatim
        got = (
            tuple((s, to_snake(s)) for s in path.split(".")),
            stripped,
        )
        if len(_COMPILED) < 4096:  # hostile selector variety can't pin RAM
            _COMPILED[(path, op, want)] = got
    return got


def _lookup_obj(obj: Any, path: str) -> str:
    """Resolve a wire-style camelCase dotted path directly against the
    dataclass graph — same result as encoding first, without paying a
    full-object encode per watch event."""
    segs, _ = _compile_clause(path, "")
    return _lookup_obj_segs(obj, segs)


def _lookup_obj_segs(obj: Any, segs) -> str:
    cur: Any = obj
    for wire_seg, attr in segs:
        if isinstance(cur, dict):
            cur = cur.get(wire_seg, _MISSING)
            if cur is _MISSING:
                return ""
        else:
            cur = getattr(cur, attr, _MISSING)
            if cur is _MISSING:
                return ""
        if cur is None:
            return ""
    if isinstance(cur, bool):
        return "true" if cur else "false"
    return str(cur)


def _matches(target: Any, clauses, lookup) -> bool:
    for path, op, want in clauses:
        got = lookup(target, path)
        # value compile through the memo (the `in` form would otherwise
        # rebuild its frozenset per item per list on the wire path)
        compiled = _compile_clause(path, want, op)[1]
        if op == "in":
            ok = got in compiled
        else:
            ok = got == compiled
            if op == "!=":
                ok = not ok
        if not ok:
            return False
    return True


def _matches_obj(obj: Any, clauses) -> bool:
    for path, op, want in clauses:
        segs, stripped = _compile_clause(path, want, op)
        got = _lookup_obj_segs(obj, segs)
        ok = (got in stripped) if op == "in" else got == stripped
        if op == "!=":
            ok = not ok
        if not ok:
            return False
    return True


def matches_fields(obj: Any, clauses: List[Tuple[str, str, str]]) -> bool:
    """Evaluate clauses directly against the dataclass graph — same
    semantics as the wire evaluator, without paying an encode."""
    if not clauses:
        return True
    return _matches_obj(obj, clauses)


def interest_values(clauses: List[Tuple[str, str, str]],
                    path: str) -> Optional[frozenset]:
    """The exact value set `path` is pinned to by `clauses`, or None
    when the clauses don't pin it (no clause on the path, or only
    negations). This is the watch fan-out's interest key: a watcher
    whose selector pins spec.nodeName to a known set can be indexed by
    those values and skipped entirely for every other node's events."""
    out: Optional[frozenset] = None
    for cpath, op, want in clauses:
        if cpath != path:
            continue
        if op == "=":
            vals = frozenset((_strip_quotes(want),))
        elif op == "in":
            vals = compile_in_values(want)
        else:
            continue  # '!=' excludes, it doesn't pin
        out = vals if out is None else (out & vals)
    return out


def lookup_field(obj: Any, path: str) -> str:
    """Public single-field resolver against the dataclass graph (the
    fan-out index keys events by it)."""
    return _lookup_obj(obj, path)


def matches_fields_wire(
    wire: Dict[str, Any], clauses: List[Tuple[str, str, str]]
) -> bool:
    """Evaluate clauses against an already-encoded wire dict (lets LIST
    encode each object exactly once)."""
    return _matches(wire, clauses, _lookup)
